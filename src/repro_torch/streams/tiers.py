"""Model tiers: input resolution x batch-pool dtype x architecture label.

A replica advertises exactly one tier (``VisionServeEngine(tier=...)``);
the tier fixes the replica's model configs (``configs.eda_vision`` at the
tier resolution) and its batch-pool dtype.  The built-in zoo
(:data:`TIERS`) spans high/base/low/frugal.

Only the tier definitions and the per-stream threshold reader are ported
so far.  The tiers' cost model (``cost_scale``, ``flops_per_frame``,
``frame_bytes``), the backlog-driven ``TierDirector`` (migration and
standby autoscaling), ``service_ms`` and ``frame_energy_j`` come with the
gateway, together with the energy model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch


@dataclass(frozen=True)
class TierSpec:
    """One model tier: resolution x dtype x architecture.

    ``rank`` orders tiers by accuracy/cost (higher = heavier).
    """
    name: str
    input_res: int
    dtype: str = "float32"              # batch-pool dtype
    arch: str = "mnv1+movenet"          # descriptive label (config zoo)
    rank: int = 0

    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


TIERS: Dict[str, TierSpec] = {
    "high": TierSpec("high", input_res=48, dtype="float32",
                     arch="mnv1+movenet/48", rank=3),
    "base": TierSpec("base", input_res=32, dtype="float32",
                     arch="mnv1+movenet/32", rank=2),
    "low": TierSpec("low", input_res=16, dtype="float32",
                    arch="mnv1+movenet/16", rank=1),
    "frugal": TierSpec("frugal", input_res=16, dtype="bfloat16",
                       arch="mnv1+movenet/16-bf16", rank=0),
}


def resolve_tier(tier: Union[str, TierSpec]) -> TierSpec:
    if isinstance(tier, TierSpec):
        return tier
    if tier not in TIERS:
        raise KeyError(f"unknown tier {tier!r}; known: {sorted(TIERS)}")
    return TIERS[tier]


def stream_thresh(eng, key: str) -> Optional[float]:
    """A stream's current adaptive gate threshold, wherever it lives:
    the bound lane's controller, the saved travel snapshot, or the gate's
    init value (never bound yet).  None = gateless engine."""
    st = eng.streams[key]
    gate = eng.gates[st.kind]
    if gate is None:
        return None
    if st.bound:
        return float(gate.thresh[st.lane])
    if st.gate_state is not None:
        return float(st.gate_state["thresh"])
    # canonicalise through f32: the lane arrays hold float32, so a stream
    # read before its first bind must report the same value it will show
    # the moment a lane adopts it
    return float(np.float32(gate.init_thresh))
