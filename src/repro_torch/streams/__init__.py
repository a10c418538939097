"""Fleet vision streaming (the ported part).

  filter         motion-gated frame admission (block-SAD, adaptive per-stream
                 thresholds) — redundant frames never reach a batch slot
  tiers          model tiers (resolution x batch-pool dtype)
  vision_engine  continuous-batching frame server: slot = vehicle stream,
                 fixed-shape per-model batches, outer pre-empts inner,
                 ESD deadline drops accounted as skip rate

The gateway, the fused fleet tick and the cell/region control plane are
not ported yet.
"""
from repro_torch.streams.filter import (GateStats, MotionGate,  # noqa: F401
                                        block_sad)
from repro_torch.streams.tiers import (TIERS, TierSpec,  # noqa: F401
                                       resolve_tier)
from repro_torch.streams.vision_engine import (INNER, OUTER,  # noqa: F401
                                               StreamState,
                                               VisionServeEngine)
