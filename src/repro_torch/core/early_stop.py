"""Early stopping (ESD) — the paper's deadline/straggler-mitigation policy.

The early-stop divisor (ESD) gives every video a processing deadline
``video_length / ESD``; frames not analysed by the deadline are discarded
(the *skip rate*).  The paper sets ESD manually per device (§3.2.3); its §6
future-work sketches dynamic adjustment — implemented here as an AIMD
controller (beyond-paper feature, benchmarked in ``benchmarks/esd_sweep``).

Host/device split: the paper stops a video mid-analysis when a wall-clock
timer fires; here the budget is computed *before* dispatch from the EWMA
per-frame cost and applied as a fixed-shape frame mask
(:func:`budget_mask`) — same policy, control moved to the host loop, no
new kernel specialisations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class EarlyStopPolicy:
    """Static-ESD budget computation + skip accounting."""
    esd: float = 0.0                 # 0 or <=1 disables early stopping

    @property
    def enabled(self) -> bool:
        return self.esd > 1.0

    def deadline_ms(self, video_len_ms: float) -> Optional[float]:
        if not self.enabled:
            return None
        return video_len_ms / self.esd

    def frame_budget(self, video_len_ms: float, total_frames: int,
                     est_frame_cost_ms: float,
                     setup_ms: float = 0.0) -> int:
        """Frames affordable inside the deadline at the estimated cost.

        ``setup_ms`` is the per-file fixed cost (frame-extractor spin-up);
        it eats deadline without producing frames, which is why small
        granularities force high skip rates (paper §4.2.2).
        """
        if not self.enabled:
            return total_frames
        deadline = max(self.deadline_ms(video_len_ms) - setup_ms, 0.0)
        if est_frame_cost_ms <= 0:
            return total_frames
        return max(min(int(deadline // est_frame_cost_ms), total_frames), 0)


def budget_mask(total_frames: int, budget: torch.Tensor) -> torch.Tensor:
    """(total_frames,) float32 mask: 1.0 for frames inside the budget.

    ``budget`` is an integer tensor scalar on the device the mask is built
    on — the dispatched shape stays fixed while the *effective* work tracks
    the deadline.
    """
    budget = torch.as_tensor(budget)
    return (torch.arange(total_frames, device=budget.device)
            < budget).to(torch.float32)


@dataclass
class DynamicESD:
    """AIMD controller for the ESD value (paper §6 future work).

    Tracks an EWMA of turnaround (the paper judges near-real-time on the
    per-device *average*, Tables 4.2-4.7) and applies:

    - smoothed turnaround > video length        -> additive increase
    - smoothed turnaround < length - hysteresis -> multiplicative decrease

    Smoothing + multiplicative decrease answer the paper's stability
    question ("the ESD may fluctuate wildly"): one slow download moves the
    EWMA, not the ESD, and recovery decays geometrically (§6 bullet 2).
    ``esd_max`` answers bullet 3: the value saturates instead of running
    away when real-time is unreachable.
    """
    esd: float = 1.0
    step: float = 0.25               # additive increase per deadline miss
    decay: float = 0.93              # multiplicative decrease factor
    hysteresis_ms: float = 40.0
    esd_min: float = 1.0
    esd_max: float = 8.0
    alpha: float = 0.25              # turnaround EWMA smoothing
    misses: int = 0
    adjustments: list = field(default_factory=list)
    _ewma: Optional[float] = None

    def update(self, turnaround_ms: float, video_len_ms: float) -> float:
        self._ewma = turnaround_ms if self._ewma is None else (
            self.alpha * turnaround_ms + (1 - self.alpha) * self._ewma)
        if self._ewma > video_len_ms:
            self.esd = min(self.esd + self.step, self.esd_max)
            self.misses += 1
        elif self._ewma < video_len_ms - self.hysteresis_ms:
            self.esd = max(self.esd * self.decay, self.esd_min)
        self.adjustments.append(self.esd)
        return self.esd

    def policy(self) -> EarlyStopPolicy:
        return EarlyStopPolicy(esd=self.esd if self.esd > 1.0 else 0.0)


@dataclass
class EWMA:
    """Exponentially-weighted estimate (per-frame cost, worker capacity)."""
    alpha: float = 0.3
    value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.alpha * x + (1 - self.alpha) * self.value)
        return self.value

    def get(self, default: float) -> float:
        return self.value if self.value is not None else default
