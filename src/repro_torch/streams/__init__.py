"""Fleet vision streaming: batched multi-vehicle frame serving.

  filter         motion-gated frame admission (block-SAD, adaptive per-stream
                 thresholds) — redundant frames never reach a batch slot
  tiers          model tiers (resolution x batch-pool dtype) and the
                 backlog-driven migration/autoscaling ``TierDirector``
  vision_engine  continuous-batching frame server: slot = vehicle stream,
                 fixed-shape per-model batches, outer pre-empts inner,
                 ESD deadline drops accounted as skip rate
  gateway        per-vehicle session lifecycle + CapacityScheduler placement
                 across engine replicas + join backpressure
  cells          hierarchical control plane: CellGateway meshes under a
                 RegionGateway — per-cell host paths, bounded region
                 rebalance, cross-cell handoff with full state travel

The fused fleet tick (the reference's ``fleet_step``) is not ported yet.
"""
from repro_torch.streams.cells import CellGateway, RegionGateway  # noqa: F401
from repro_torch.streams.filter import (GateStats, MotionGate,  # noqa: F401
                                        block_sad)
from repro_torch.streams.gateway import (FleetGateway,  # noqa: F401
                                         StreamSession)
from repro_torch.streams.tiers import (TIERS, TierDirector,  # noqa: F401
                                       TierSpec, resolve_tier)
from repro_torch.streams.vision_engine import (INNER, OUTER,  # noqa: F401
                                               StreamState,
                                               VisionServeEngine)
