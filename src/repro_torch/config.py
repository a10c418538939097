"""Run configuration for the port.

Only :class:`EDAConfig` (the paper's deadline/early-stop technique) is
ported so far: it is what the vision engine reads.  The language-model
``ModelConfig`` and its architecture registry come with the token path.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EDAConfig:
    esd: float = 0.0                 # early-stop divisor; 0/<=1 disables
    dynamic_esd: bool = False        # AIMD controller (paper §6 future work)
    esd_step: float = 0.25           # additive increase step for dynamic ESD
    segmentation: bool = False
    num_segments: int = 0            # 0 => auto (one per free worker)
    granularity_s: float = 1.0       # video segment length (paper: 1s / 2s)
    fps: int = 30
    download_overhead_s: float = 0.5 # paper-measured enqueue->start delay
    simulate_download_s: float = 0.35  # 1s-test simulated download (paper: 350ms)
    outer_priority: bool = True      # outer videos to strongest workers
    ewma_alpha: float = 0.3          # capacity estimator smoothing
