"""Observability plane: sketches, metrics, spans (framework-free), and the
runtime probes (``probes``: the build counter behind the simulator's
recompile invariant, fleet gauges), which read the stack lazily."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.probes import (jit_cache_entries,  # noqa: F401
                                    register_runtime_gauges)
from repro_torch.obs.sketch import QuantileSketch  # noqa: F401
from repro_torch.obs.tracing import (NULL_SPAN, NULL_TRACER,  # noqa: F401
                                     NullTracer, SpanTracer)
