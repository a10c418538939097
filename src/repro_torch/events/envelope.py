"""Typed event envelopes: the fleet's alert contract.

A detection is only a product once it leaves the engine as a *named,
deduplicatable* fact.  The envelope carries a deterministic idempotent
``event_id`` — the SHA-256 of ``(stream key, segment, frame index, event
type)`` — so the same logical detection always maps to the same id, no
matter which replica emitted it, how many times the at-least-once spool
re-sent it, or whether the stream was rebound mid-segment (the per-stream
frame ordinal travels with the stream's counters through
``detach_stream``/``adopt_stream``).  Receivers dedup on the id alone;
nothing about delivery order or retry count can forge a new identity.

Evidence (a short frame clip from the ring buffer) rides the envelope as
an opaque payload: it is *excluded* from the id and from trace
canonicalisation — two emissions of one logical event are the same event
even if one lost its clip to ring wraparound.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

# Event types — the alert taxonomy the paper's workloads produce.
HAZARD = "hazard"               # outer stream: danger flag
DISTRACTION = "distraction"     # inner stream: driver distraction flag
DEADLINE_MISS = "deadline_miss"  # ESD trimmed stale work to meet a deadline
TOKEN_DONE = "token_done"       # token request retired (LM completion)

EVENT_TYPES = (HAZARD, DISTRACTION, DEADLINE_MISS, TOKEN_DONE)


def event_id(key: str, segment: int, frame_index: int, etype: str) -> str:
    """Deterministic idempotent id: same logical event ⇒ same 16-hex id."""
    raw = f"{key}|{segment}|{frame_index}|{etype}"
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


@dataclass
class Event:
    """One emitted alert.  Identity lives in ``eid`` (see ``event_id``);
    everything else is payload — timestamps are clock-domain stamps for
    humans, never part of the dedup contract."""
    eid: str
    etype: str
    key: str                        # stream key ("v003/outer") or rid
    segment: int
    frame_index: int                # per-stream consumed-frame ordinal
    emit_s: float = 0.0             # emitting engine's clock (domain-local)
    payload: Dict[str, Any] = field(default_factory=dict)
    # evidence clip (set by the emitter when a ring is attached):
    clip_len: int = 0
    clip_digest: str = ""
    evidence: Optional[Any] = None  # (clip_len, H, W, 3) array, not hashed

    @property
    def vehicle(self) -> str:
        """Owner of the delivery path: the uplink the event rides."""
        return self.key.split("/", 1)[0]

    def describe(self) -> Tuple[str, str, int]:
        return (self.etype, self.key, self.frame_index)

    @classmethod
    def make(cls, key: str, etype: str, frame_index: int, *,
             segment: int = 0, emit_s: float = 0.0,
             **payload) -> "Event":
        if etype not in EVENT_TYPES:
            raise ValueError(f"unknown event type {etype!r}; "
                             f"known: {EVENT_TYPES}")
        return cls(eid=event_id(key, segment, frame_index, etype),
                   etype=etype, key=key, segment=segment,
                   frame_index=frame_index, emit_s=emit_s,
                   payload=dict(payload))
