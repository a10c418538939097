"""One run of one cell: set-up, the measured window, the checks, the line.

A driver builds the program's object from the seed, warms up the cell's own
shapes, then calls :meth:`Session.start_window` and
:meth:`Session.end_window` around the timed loop.  ``setup_s`` runs from the
process's start to the window's; the device's peak memory is read at the
window's end, before the driver frees the program and runs the reference.
With ``--trace 1`` the window runs under the profiler, and the benchmark's
own host spans (:meth:`Session.span`) are kept apart from the program's.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Optional, Tuple

from portbench.harness.trace import DeviceTrace


class Session:
    def __init__(self, torch, *, seed: int, seconds: float, trace: bool,
                 device, t_process: float, ticks: Optional[int] = None
                 ) -> None:
        self.torch = torch
        self.seed = seed
        self.seconds = seconds
        self.ticks = ticks
        self.trace = trace
        self.device = device
        self.t_process = t_process
        self.spans: List[Tuple[str, float, float]] = []
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.trace_summary: Optional[dict] = None
        self._dtrace = DeviceTrace(torch, trace and device.type == "cuda")
        self._t0 = 0.0

    def note(self, what: str) -> None:
        """A set-up milestone on standard error: seconds since the
        process started."""
        print(f"portbench: {time.perf_counter() - self.t_process:8.3f} s "
              f"{what}", file=sys.stderr, flush=True)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the benchmark's own, recorded in traced runs."""
        if not self.trace:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t, time.perf_counter()))

    def start_window(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_process
        self._dtrace.__enter__()
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def window_over(self, ticks: int) -> bool:
        """``--seconds`` have passed; or, where the session was given a
        number of ticks (the CPU tests), that many ticks have run."""
        if self.ticks is not None:
            return ticks >= self.ticks
        return self.elapsed() >= self.seconds

    def end_window(self) -> float:
        """Close the window (waiting for the card); returns its seconds."""
        self.sync()
        self.window_s = time.perf_counter() - self._t0
        self._dtrace.__exit__(None, None, None)
        if self.cuda:
            self.memory_peak_bytes = int(
                self.torch.cuda.max_memory_allocated(self.device))
        return self.window_s

    def read_trace(self, program_spans: List[Tuple[str, float, float]]
                   ) -> Optional[dict]:
        """The trace's summary, host spans of the program and the benchmark
        both labelling the idle gaps."""
        if self.trace and self.cuda:
            self.trace_summary = self._dtrace.summary(
                list(program_spans) + self.spans)
        return self.trace_summary


def spans_by_name(spans: List[Tuple[str, float, float]]
                  ) -> Dict[str, List[float]]:
    """{name: [durations in ms]}"""
    out: Dict[str, List[float]] = {}
    for name, s, t in spans:
        out.setdefault(name, []).append((t - s) * 1e3)
    return out


def tracer_spans(tracer) -> List[Tuple[str, float, float]]:
    """A ``SpanTracer``'s complete spans as (name, start, end) seconds."""
    if tracer is None:
        return []
    return [(e["name"], e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
            for e in tracer.spans()]
