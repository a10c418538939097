"""Helpers the per-layer metric readers share.  Each reader takes the run's
record and returns a number, or None where it finds nothing to read:

- ``record["spans"]``: {name: [ms, ...]}, host spans of the program's
  ``SpanTracer``; ``record["bench_spans"]``, the benchmark's own, apart;
- ``record["trace"]``: the device trace's summary (``harness/trace.py``),
  None without ``--trace 1`` or a card;
- ``record["counts"]``: the driver's counts over the window (work done,
  frozen operation and byte counts);
- ``record["window_s"]``: the window's seconds.
"""
from __future__ import annotations

import re
from typing import Optional


def device_seconds(record: dict, pattern: str) -> Optional[float]:
    """Device seconds of the operations whose names match ``pattern``."""
    trace = record.get("trace")
    if not trace:
        return None
    rx = re.compile(pattern)
    total = sum(v for k, v in trace["kernels"].items() if rx.search(k))
    return total if total > 0 else None


def idle_percent(record: dict) -> Optional[float]:
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def share_percent(part: float, whole: Optional[float]) -> Optional[float]:
    """``part`` over ``whole`` in percent; None where either is missing or
    nought (a share of a roofline or a peak is never reported as 0)."""
    if not whole or not part:
        return None
    return 100.0 * part / whole


def span_ms(record: dict, name: str):
    return record.get("spans", {}).get(name) or []
