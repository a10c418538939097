"""PyTorch + CUDA port of the EDA fleet vision-serving stack.

Mirrors ``src/repro/`` module for module; the JAX package stays the
reference it is held against.  This package imports torch, numpy and the
standard library only — never JAX and never the reference package.

Ported so far (the vision main path, push -> ledger record):

  config / configs.eda_vision   EDAConfig, VisionConfig
  core                          clock, early_stop, telemetry, engine_core
  obs                           sketch, metrics, tracing
  events.envelope               event taxonomy
  models                        param descriptors, detector/pose CNNs
  kernels.vision_ops            hand-written CUDA (sm_90a) ingest,
                                scatter-admit, downscale and block-SAD
                                kernels, each beside its plain version
  streams                       MotionGate, tiers, VisionServeEngine
  data.synthetic                deterministic dash-cam clips
  convert                       reference parameter trees -> port weights
"""
