"""The EDA runtime substrate the vision engine rides.

  clock         Clock seam: WallClock for serving, VirtualClock for
                deterministic tests and simulation
  early_stop    ESD deadline policy + dynamic-ESD AIMD controller
  telemetry     per-segment turnaround decomposition ledger
  engine_core   the shared continuous-batching EngineCore: slot-pool row
                admission, two-class PriorityQueue, LanePool preemption,
                tick phases + deadline budgets
  scheduler     capacity-aware master/worker placement (paper section 3.2.5)
  segmentation  equal-split / exact-merge of streams (section 3.2.4)
  energy        energy proxy model (section 4.2.3)
  pipeline      simultaneous download + analysis (double-buffered ingest)
  runtime       master loop + event clock reproducing the section 4.2 tables
"""
from repro_torch.core.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.core.early_stop import (DynamicESD,  # noqa: F401
                                         EarlyStopPolicy, budget_mask)
from repro_torch.core.engine_core import (INNER, OUTER,  # noqa: F401
                                          BlockPool, EngineCore, LanePool,
                                          PriorityQueue, batch_axis,
                                          insert_row)
from repro_torch.core.energy import EnergyModel  # noqa: F401
from repro_torch.core.pipeline import DoubleBuffer, overlapped  # noqa: F401
from repro_torch.core.runtime import (PAPER_DEVICES,  # noqa: F401
                                      DeviceProfile, EDARuntime,
                                      SimExecutor)
from repro_torch.core.scheduler import (CapacityScheduler,  # noqa: F401
                                        HardwareInfo, WorkerState)
from repro_torch.core.segmentation import (Segment,  # noqa: F401
                                           SegmentResult, merge_results,
                                           split_video)
from repro_torch.core.telemetry import Ledger, SegmentRecord  # noqa: F401
