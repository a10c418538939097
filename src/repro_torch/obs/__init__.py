"""Observability plane: sketches, metrics, spans (framework-free)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry)
from repro_torch.obs.sketch import QuantileSketch  # noqa: F401
from repro_torch.obs.tracing import (NULL_SPAN, NULL_TRACER,  # noqa: F401
                                     NullTracer, SpanTracer)
