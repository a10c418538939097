"""PyTorch + CUDA port of the EDA fleet serving stack.

Mirrors ``src/repro/`` module for module; the JAX package stays the
reference it is held against.  This package imports torch, numpy and the
standard library only — never JAX and never the reference package.

Ported so far — the vision main path (push -> ledger record), the token
path (request -> chunked prefill -> decode -> ledger record), the fleet
simulator that drives both on virtual clocks, and training on one card:

  config / configs              EDAConfig, VisionConfig, ModelConfig and
                                the arch registry (starcoder2-3b,
                                recurrentgemma-9b, xlstm-350m)
  core                          clock, early_stop, telemetry, engine_core,
                                scheduler, segmentation, energy
  obs                           sketch, metrics, tracing, probes
  events                        the event plane: envelopes, spools,
                                evidence, sinks, emitters and the pump
  models                        param descriptors, detector/pose CNNs,
                                layers, attention (contiguous and paged
                                KV), RG-LRU, mLSTM/sLSTM, the transformer
                                (attention, hybrid and xLSTM stacks)
  kernels                       hand-written CUDA (sm_90a) kernels, each
                                beside its plain version: ingest,
                                scatter-admit, downscale, block-SAD; paged
                                decode, paged flash, flash, decode; RG-LRU
                                scan, chunkwise mLSTM
  streams                       MotionGate, tiers and TierDirector,
                                VisionServeEngine, FleetGateway, cells
  simulate                      scenario library, runner, trace,
                                invariants (the reference's digests)
  serving                       ServeEngine (the token workload shell)
  launch.serve                  the serving CLI
  train                         AdamW, the train step (lm_loss under
                                autograd, grad accumulation, remat),
                                checkpoints in the reference's format
  launch.train, launch.elastic  the one-card train launcher and its
                                restart-from-checkpoint supervisor
  core.runtime / core.pipeline  the paper's EDA master runtime
                                (EDARuntime, SimExecutor, PAPER_DEVICES)
                                and the double-buffered ingest
  data                          deterministic dash-cam clips, the LM
                                token stream, device_prefetch
  convert                       reference parameter trees and caches ->
                                port tensors
"""
from repro_torch.core.pipeline import DoubleBuffer, overlapped  # noqa: F401,E402
from repro_torch.core.runtime import (PAPER_DEVICES,  # noqa: F401,E402
                                      DeviceProfile, EDARuntime,
                                      SimExecutor)
from repro_torch.data.prefetch import device_prefetch  # noqa: F401,E402
