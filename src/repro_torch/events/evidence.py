"""Evidence ring-buffer: a short frame clip around every emitted event.

An alert without footage is an assertion; an alert with the frames that
triggered it is evidence.  Each stream keeps a small ring of its most
recently *consumed* frames (pushed by the engine's staging phase, the
same host phase on every engine path, so clips are deterministic per
seed).  When the emitter fires an event it
cuts the ring into a clip — the frames leading up to and including the
triggering frame — and stamps the envelope with the clip length and a
content digest (deterministic per seed; the array itself rides the
envelope but never enters the event id or a trace).

The ring travels with the stream on rebind (``detach``/``adopt`` via the
emitter's event-state dict), so a clip cut right after a replica failure
still shows the frames processed on the failed origin.
"""
from __future__ import annotations

import hashlib
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np


class EvidenceRing:
    """Per-stream bounded ring of (frame ordinal, frame) pairs."""

    def __init__(self, cap: int = 4) -> None:
        if cap < 1:
            raise ValueError(f"evidence ring cap must be >= 1, got {cap}")
        self.cap = cap
        self.frames: Deque[Tuple[int, np.ndarray]] = deque(maxlen=cap)

    def push(self, index: int, frame: np.ndarray) -> None:
        # frames are engine-owned and never mutated after staging; the
        # ring holds references, not copies (cap bounds the memory)
        self.frames.append((index, frame))

    def clip(self, center: int) -> Tuple[List[int], Optional[np.ndarray]]:
        """Frames at ordinals <= ``center`` still in the ring, oldest
        first — the lead-up to (and including) the triggering frame."""
        picked = [(i, f) for i, f in self.frames if i <= center]
        if not picked:
            return [], None
        idxs = [i for i, _ in picked]
        return idxs, np.stack([f for _, f in picked])


def clip_digest(clip: Optional[np.ndarray]) -> str:
    """Content fingerprint of a clip (12 hex chars; "" for no clip)."""
    if clip is None:
        return ""
    return hashlib.sha256(
        np.ascontiguousarray(clip).tobytes()).hexdigest()[:12]
