"""Motion-gated frame admission (redundant-frame filtering).

Dash-cam streams are massively redundant — a car waiting at a light sends
near-identical frames for seconds.  This module is the redundant-frame
lever for the ``VisionServeEngine``: a block-SAD frame-difference gate,
batched across *all* streams of an engine, that rejects near-duplicate
frames before they ever occupy a batch slot.

  * :func:`block_sad` — frames are compared against each stream's
    last-admitted reference at a small gate resolution; the score is the
    *maximum block* mean-absolute-difference, so a pedestrian entering one
    corner of an otherwise static scene still trips the gate.  Edge blocks
    are pad-and-masked, so arbitrary gate resolutions work;
    ``use_kernels=True`` dispatches to the hand kernel in
    ``repro_torch.kernels.vision_ops`` (the engine's hot path fuses
    downscale+normalize+score via ``vision_ops.ingest_frame`` and feeds the
    scores straight into :meth:`MotionGate.decide`).
  * :class:`MotionGate` — per-engine state: one reference frame (on the
    device) and one adaptive threshold (on the host) per slot.  Device
    state is fixed-shape ``(slots, gate_res, gate_res, 3)`` with boolean
    masks; reference updates build a new tensor, so gated rows keep their
    old reference and a saved snapshot never changes under its owner.
  * Adaptive thresholds — per-stream AIMD on the observed skip fraction,
    steering every lane toward the ``target_skip`` band: a stream skipping
    above ``target_skip[1]`` has its threshold multiplicatively decayed
    (bounded below by ``thresh_floor``), and a stream admitting nothing but
    near-duplicates gets its threshold additively raised.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.early_stop import EWMA
from repro_torch.device import resolve_device
from repro_torch.kernels import vision_ops
from repro_torch.models.vision import downscale


def block_sad(ref: torch.Tensor, frames: torch.Tensor, block: int = 8, *,
              use_kernels: bool = False) -> torch.Tensor:
    """Per-stream motion score: max block mean-absolute-difference.

    ref/frames: (S, H, W, C); H, W need NOT divide ``block`` (edge blocks
    average their valid pixels only).  Returns (S,) float32 in [0, 1] for
    [0, 1]-ranged inputs.  ``use_kernels`` dispatches to the hand kernel.
    """
    if use_kernels:
        return vision_ops.block_sad(ref, frames, block=block)
    return vision_ops.block_sad_plain(ref, frames, block)


def gate_scores(refs: torch.Tensor, frames: torch.Tensor, *, gate_res: int,
                block: int, use_kernels: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate's device arithmetic on staged rows: normalize and
    downscale (S, H, W, 3) ``frames`` to the gate resolution, score each
    row against its reference.  Returns (gate frames (S, g, g, 3) fp32,
    scores (S,) fp32).  Rows are independent, so the fused fleet tick
    calls this on every replica's rows at once and gets each replica's
    :meth:`MotionGate.admit` scores."""
    if use_kernels:
        if frames.dtype not in (torch.uint8, torch.float32):
            # a bf16 tier's batch pool: the kernel reads uint8 or fp32,
            # and the cast is exact, as the plain path's normalize is
            frames = frames.to(torch.float32)
        small = vision_ops.downscale(frames, gate_res)
        return small, vision_ops.block_sad(refs, small, block=block)
    small = downscale(vision_ops.normalize_plain(frames), gate_res)
    return small, block_sad(refs, small, block)


@dataclass
class GateStats:
    offered: int = 0
    admitted: int = 0
    gated: int = 0

    @property
    def skip_fraction(self) -> float:
        return self.gated / self.offered if self.offered else 0.0


class MotionGate:
    """Batched near-duplicate filter for one engine's slot lanes."""

    def __init__(self, slots: int, gate_res: int = 32, block: int = 8,
                 init_thresh: float = 0.02,
                 target_skip: Tuple[float, float] = (0.05, 0.7),
                 step: float = 0.002, decay: float = 0.85,
                 window: int = 16, alpha: float = 0.2,
                 thresh_floor: float = 1e-3, thresh_ceil: float = 1.0,
                 use_kernels: bool = False, device=None) -> None:
        if not thresh_floor <= init_thresh <= thresh_ceil:
            raise ValueError(f"need thresh_floor <= init_thresh <= "
                             f"thresh_ceil, got {thresh_floor}, "
                             f"{init_thresh}, {thresh_ceil}")
        self.slots = slots
        self.gate_res = gate_res
        self.block = block
        self.target_skip = target_skip
        self.step = step
        self.decay = decay
        self.window = window
        self.thresh_floor = thresh_floor
        self.thresh_ceil = thresh_ceil
        self.init_thresh = init_thresh
        self.use_kernels = use_kernels
        self.device = resolve_device(device)
        self.refs = torch.zeros((slots, gate_res, gate_res, 3),
                                dtype=torch.float32, device=self.device)
        self.has_ref = np.zeros(slots, bool)
        self.thresh = np.full(slots, init_thresh, np.float32)
        self.skip_ewma = [EWMA(alpha=alpha) for _ in range(slots)]
        self._since_adapt = np.zeros(slots, np.int64)
        self.stats = GateStats()

    def reset(self, slot: int, init_thresh: Optional[float] = None) -> None:
        """Forget a lane's reference/threshold (stream churn re-uses lanes)."""
        self.has_ref[slot] = False
        self.thresh[slot] = (init_thresh if init_thresh is not None
                             else self.init_thresh)
        self.skip_ewma[slot] = EWMA(alpha=self.skip_ewma[slot].alpha)
        self._since_adapt[slot] = 0

    def save(self, slot: int) -> dict:
        """Snapshot a lane's gate state so it can follow its *stream* — a
        time-shared or preempted stream must keep its duplicate-detection
        reference and adapted threshold across re-binds.  The reference is
        cloned: ``refs[slot]`` alone would be a view that a later restore
        into this lane would overwrite."""
        return {"ref": self.refs[slot].clone(),
                "has_ref": bool(self.has_ref[slot]),
                "thresh": float(self.thresh[slot]),
                "skip_ewma": self.skip_ewma[slot],
                "since": int(self._since_adapt[slot])}

    def restore(self, slot: int, state: Optional[dict] = None) -> None:
        """Install a saved stream snapshot into a lane (None = fresh)."""
        if state is None:
            self.reset(slot)
            return
        self.refs[slot] = state["ref"]
        self.has_ref[slot] = state["has_ref"]
        self.thresh[slot] = state["thresh"]
        self.skip_ewma[slot] = state["skip_ewma"]
        self._since_adapt[slot] = state["since"]

    def admit(self, frames: torch.Tensor, active: np.ndarray) -> np.ndarray:
        """Gate one engine tick.

        frames: (slots, H, W, 3) staged batch (inactive rows ignored);
        active: (slots,) bool — lanes holding a fresh candidate frame.
        Returns (slots,) bool admit mask (subset of ``active``) and updates
        references, thresholds, and stats.
        """
        small, scores = gate_scores(self.refs, frames, gate_res=self.gate_res,
                                    block=self.block,
                                    use_kernels=self.use_kernels)
        admit = self.decide(scores.cpu().numpy(), active)
        mask = torch.as_tensor(admit, device=self.refs.device)
        self.refs = torch.where(mask[:, None, None, None], small, self.refs)
        return admit

    def decide(self, scores: np.ndarray, active: np.ndarray) -> np.ndarray:
        """Threshold the motion scores into an admit mask and run the AIMD
        controller + stats.  Does NOT refresh references — callers that own
        the gate-resolution frames (the engine's fused ``ingest_frame`` +
        ``scatter_admit`` path) commit them in the same device pass; the
        :meth:`admit` path commits them itself."""
        moving = scores > self.thresh
        # first frame of a stream always admits (no reference yet)
        admit = active & (moving | ~self.has_ref)
        return self.commit_decision(active, admit)

    def commit_decision(self, active: np.ndarray,
                        admit: np.ndarray) -> np.ndarray:
        """The host-state half of :meth:`decide` for a given admit mask:
        first-frame bookkeeping, the AIMD controller and stats."""
        admit = np.asarray(admit, bool)
        self.has_ref = self.has_ref | admit
        self._adapt(active, admit)
        n_act, n_adm = int(active.sum()), int(admit.sum())
        self.stats.offered += n_act
        self.stats.admitted += n_adm
        self.stats.gated += n_act - n_adm
        return admit

    def _adapt(self, active: np.ndarray, admit: np.ndarray) -> None:
        """AIMD threshold update on each lane's skip-fraction EWMA.

        Adjustments fire at most once per ``window`` frames (the counter
        resets after each correction) so the controller settles instead of
        compounding every frame, and the threshold is floored: a parked
        vehicle must not decay its threshold to zero and then admit every
        sensor-noise frame once the scene resumes."""
        lo, hi = self.target_skip
        for s in np.nonzero(active)[0]:
            skip = self.skip_ewma[s].update(0.0 if admit[s] else 1.0)
            self._since_adapt[s] += 1
            if self._since_adapt[s] < self.window:
                continue
            if skip > hi:
                self.thresh[s] = max(self.thresh[s] * self.decay,
                                     self.thresh_floor)
                self._since_adapt[s] = 0
            elif skip < lo:
                # admitting duplicates: raise, bounded by the ceiling (a
                # score can never exceed the frame value range, so an
                # unbounded threshold would gate everything forever)
                self.thresh[s] = min(self.thresh[s] + self.step,
                                     self.thresh_ceil)
                self._since_adapt[s] = 0

    def similar(self) -> "MotionGate":
        """A fresh gate with this gate's configuration (new lane state)."""
        return MotionGate(self.slots, gate_res=self.gate_res,
                          block=self.block, init_thresh=self.init_thresh,
                          target_skip=self.target_skip, step=self.step,
                          decay=self.decay, window=self.window,
                          alpha=self.skip_ewma[0].alpha,
                          thresh_floor=self.thresh_floor,
                          thresh_ceil=self.thresh_ceil,
                          use_kernels=self.use_kernels, device=self.device)
