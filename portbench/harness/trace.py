"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler records the card's activity alone (kernels, copies, memsets
and the CUDA runtime calls that launched them), not every PyTorch operation
on the host, so the traced window runs near its untraced pace.  Over the
window it gives:

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the card (one card, so the union is its busy time);
- ``window_s``: the length of the traced window, on the host clock;
- ``kernels``: device seconds summed by operation name;
- ``idle``: idle seconds summed by what the host was doing in the middle of
  each gap: the innermost host span of the program or the benchmark open at
  that moment, and the CUDA runtime call under way, if any.

The profiler stamps events on the wall clock in nanoseconds; host spans come
on ``time.perf_counter``, mapped by the offset between the two clocks read
at the window's start.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple


class DeviceTrace:
    """Context manager around the traced window."""

    def __init__(self, torch, enabled: bool) -> None:
        self.torch = torch
        self.enabled = enabled
        self.prof = None
        self.window_s = 0.0
        self._offset_ns = 0

    def __enter__(self) -> "DeviceTrace":
        if not self.enabled:
            return self
        torch = self.torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)

    def summary(self, host_spans: List[Tuple[str, float, float]]) -> dict:
        """Read the trace.  ``host_spans`` are (name, start, end) on
        ``time.perf_counter``."""
        cuda = self.torch.autograd.DeviceType.CUDA
        dev: List[Tuple[float, float, str]] = []
        runtime: List[Tuple[float, float, str]] = []
        for e in self.prof.profiler.kineto_results.events():
            iv = (e.start_ns(), e.end_ns(), e.name())
            (dev if e.device_type() == cuda else runtime).append(iv)
        kernels: Dict[str, float] = {}
        for s, t, name in dev:
            kernels[name] = kernels.get(name, 0.0) + (t - s) / 1e9
        busy_ns, gaps = _union_and_gaps(dev)
        spans = [(s * 1e9 + self._offset_ns, t * 1e9 + self._offset_ns, n)
                 for n, s, t in host_spans]
        idle: Dict[str, float] = {}
        span_idx = _Intervals(spans)
        rt_idx = _Intervals(runtime, depth=1)
        for s, t in gaps:
            mid = 0.5 * (s + t)
            label = span_idx.innermost(mid) or "outside any span"
            call = rt_idx.innermost(mid)
            if call:
                label = f"{label} / {call}"
            idle[label] = idle.get(label, 0.0) + (t - s) / 1e9
        return {"busy_s": busy_ns / 1e9, "window_s": self.window_s,
                "kernels": kernels, "idle": idle,
                "device_events": len(dev)}


def _union_and_gaps(intervals):
    """Total covered length and the uncovered gaps between the first start
    and the last end, in the intervals' unit."""
    if not intervals:
        return 0.0, []
    ivs = sorted((s, t) for s, t, _ in intervals)
    busy = 0.0
    gaps = []
    cur_s, cur_t = ivs[0]
    for s, t in ivs[1:]:
        if s > cur_t:
            busy += cur_t - cur_s
            gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    busy += cur_t - cur_s
    return busy, gaps


class _Intervals:
    """Nested intervals (name, start, end) searchable by a point: the
    innermost one containing it (the latest start among those that do)."""

    def __init__(self, intervals, depth: int = 64) -> None:
        self.ivs = sorted((s, t, n) for s, t, n in intervals)
        self.starts = [s for s, _, _ in self.ivs]
        self.depth = depth

    def innermost(self, x: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, x)
        best = None
        # walk back over the few intervals that started last before x: the
        # innermost open one is among them (``depth`` 1 for calls that
        # never nest)
        for j in range(i - 1, max(i - 1 - self.depth, -1), -1):
            s, t, n = self.ivs[j]
            if t >= x:
                best = n
                break
        return best


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the idle time by what the host was doing."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in idle]}
