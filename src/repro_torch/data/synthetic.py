"""Synthetic data sources.

``DashCamSource`` stands in for the paper's VIOFO A129 + BDD100K/DMD videos:
it produces deterministic (outer, inner) frame-array pairs at the configured
granularity/fps (the paper's paired-download protocol), with per-video seeds
so runs are reproducible and segments of the same video agree bit-exactly
across devices.

``frame_loop`` cycles one clip for long-lived simulated vehicles, and
``lm_batches`` is the training stream (tokens/labels/mask).  All are
numpy, bit-identical to the reference package's generators for the same
seed, so the port and the reference can be fed the same frames and
batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class VideoPair:
    index: int
    video_id: str
    outer: np.ndarray          # (frames, H, W, 3) uint8-ish float32 [0,1]
    inner: np.ndarray

    @property
    def frames(self) -> int:
        return self.outer.shape[0]


def synth_frames(seed: int, frames: int, res: int = 128,
                 moving_objects: int = 3) -> np.ndarray:
    """Deterministic 'dash-cam' clip: moving bright blobs over a gradient
    road scene.  Cheap to generate, non-trivial for the detector."""
    rng = np.random.default_rng(seed)
    H = W = res
    t = np.arange(frames, dtype=np.float32)
    yy = np.linspace(0, 1, H, dtype=np.float32)[None, :, None]
    xx = np.linspace(0, 1, W, dtype=np.float32)[None, None, :]
    base = 0.3 + 0.4 * yy + 0.05 * np.sin(8 * np.pi * xx)      # road gradient
    scene = np.broadcast_to(base, (frames, H, W)).copy()
    for _ in range(moving_objects):
        cy0, cx0 = rng.uniform(0.3, 0.9), rng.uniform(0.1, 0.9)
        vy, vx = rng.uniform(-0.2, 0.2, 2) / max(frames, 1)
        r = rng.uniform(0.04, 0.12)
        cy = (cy0 + vy * t)[:, None, None]                     # (F,1,1)
        cx = (cx0 + vx * t)[:, None, None]
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2                   # (F,H,W)
        scene = np.maximum(scene, np.where(d2 < r * r, 0.95, 0.0))
    out = np.stack([scene, scene * 0.9, scene * 0.8], axis=-1)
    return out.astype(np.float32)


class DashCamSource:
    """Paired outer/inner clip stream (the dash cam's two cameras)."""

    def __init__(self, granularity_s: float = 1.0, fps: int = 30,
                 res: int = 128, seed: int = 0) -> None:
        self.granularity_s = granularity_s
        self.fps = fps
        self.res = res
        self.seed = seed

    @property
    def frames_per_video(self) -> int:
        return int(self.granularity_s * self.fps)

    def pair(self, index: int) -> VideoPair:
        n = self.frames_per_video
        return VideoPair(
            index=index,
            video_id=f"v{index:04d}",
            outer=synth_frames(self.seed * 100_003 + 2 * index, n, self.res),
            inner=synth_frames(self.seed * 100_003 + 2 * index + 1, n,
                               self.res, moving_objects=1),
        )

    def stream(self, num_pairs: int) -> Iterator[VideoPair]:
        for i in range(num_pairs):
            yield self.pair(i)


def frame_loop(seed: int, res: int = 64, frames: int = 48,
               moving_objects: int = 2):
    """Deterministic endlessly-looped dash-cam clip for long-lived
    simulated vehicles (the fleet simulator): one :func:`synth_frames`
    clip, cycled by index.  Consecutive frames are *similar* (the blobs
    move a little), so a motion gate sees realistic near-duplicate
    structure instead of iid noise.  Returns ``at(i) -> (res, res, 3)``.
    """
    clip = synth_frames(seed, frames, res, moving_objects)

    def at(i: int) -> np.ndarray:
        return clip[i % frames]

    return at


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------


def lm_batches(batch: int, seq: int, vocab: int, seed: int = 0,
               steps: Optional[int] = None) -> Iterator[dict]:
    """Synthetic LM stream with learnable bigram structure.

    Tokens follow a seeded bigram chain over a Zipf marginal, so the
    conditional entropy is well below log(vocab): a model that learns
    reduces loss measurably within tens of steps.  The reference's
    generator, draw for draw: ``tokens``/``labels`` int32 (batch, seq),
    ``mask`` float32 ones.
    """
    rng = np.random.default_rng(seed)
    # Zipf marginal + low-rank bigram kernel
    marg = 1.0 / np.arange(1, vocab + 1) ** 1.1
    marg /= marg.sum()
    shift = rng.integers(1, vocab)
    i = 0
    while steps is None or i < steps:
        first = rng.choice(vocab, size=(batch, 1), p=marg)
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, :1] = first
        noise = rng.random((batch, seq))
        nxt = rng.choice(vocab, size=(batch, seq), p=marg)
        for t in range(seq):
            det = (toks[:, t] * 31 + shift) % vocab      # bigram rule
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, det, nxt[:, t])
        yield {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((batch, seq), np.float32),
        }
        i += 1
