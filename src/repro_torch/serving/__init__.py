"""Serving substrate: the token workload shell over the shared EngineCore
(continuous batching, chunked prefill, EDA deadline budgets, Clock/Ledger
seams), on the card through the hand-written attention kernels."""
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
