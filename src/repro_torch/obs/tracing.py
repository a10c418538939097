"""Deterministic per-tick span tracing with Chrome trace-event export.

Every engine tick decomposes into the phases the serving stack already
executes — ``begin_tick`` / ``stage`` / ``ingest`` / ``gate`` / ``admit``
/ ``forward`` / ``commit`` / ``end_tick`` on the vision shell; on the token
shell, each admission's ``prefill`` (holding ``prefill.upload``, one
``prefill.forward`` a chunk with its ``tokens``, and ``prefill.read``)
and each tick's ``decode`` (holding ``decode.upload``, ``decode.forward``
and ``decode.read``) followed by ``commit``.  Nesting is by time on the
engine's trace thread.
:class:`SpanTracer` records those phases as Chrome trace events
(``{"traceEvents": [...]}`` JSON, drag into https://ui.perfetto.dev or
chrome://tracing) with one trace *thread per engine*, so a fleet tick
reads as parallel per-replica swimlanes.

Two properties make this usable inside the deterministic simulator:

  * **timestamps come from the engine's ``core.clock`` seam** — a span
    only ever calls ``clock.now_s()`` (a pure read; charging work is the
    engine's job), so under a ``VirtualClock`` the trace is a
    bit-deterministic function of the scenario seed, and under a
    ``WallClock`` it is a real profile.  Tracing can observe but never
    perturb: golden-trace digests are identical with tracing on or off
    (pinned by ``tests/test_obs_parity.py``);
  * **a compiled-out fast path**: the module-level :data:`NULL_TRACER`
    (the ``EngineCore`` default) returns one shared no-op span object
    from every call — no allocation, no clock read, no branch beyond
    the method dispatch — and the sampling knob (``sample_every=N``)
    lets a production tracer keep full phase detail on one tick in N
    while the rest take the same null path.

Memory is bounded: past ``max_events`` the tracer stops recording and
counts drops (``dropped``) instead of growing without bound — a trace is
a debugging artifact, not a ledger.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager — the compiled-out span."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op.  ``EngineCore``
    defaults to this, so untraced engines pay one method call per phase
    and nothing else."""

    __slots__ = ()

    enabled = False
    events: tuple = ()
    dropped = 0

    def for_tick(self, tick: int) -> "NullTracer":
        return self

    def span(self, clock, name: str, tid: str = "main", **args) -> _NullSpan:
        return NULL_SPAN

    def instant(self, clock, name: str, tid: str = "main", **args) -> None:
        return None

    def complete(self, name: str, tid: str, ts_s: float, dur_s: float,
                 **args) -> None:
        return None


NULL_TRACER = NullTracer()


class _Span:
    """One live phase span: clock read at enter, event append at exit."""

    __slots__ = ("tracer", "clock", "name", "tid", "args", "t0")

    def __init__(self, tracer: "SpanTracer", clock, name: str, tid: str,
                 args: Optional[dict]) -> None:
        self.tracer = tracer
        self.clock = clock
        self.name = name
        self.tid = tid
        self.args = args

    def __enter__(self) -> "_Span":
        self.t0 = self.clock.now_s()
        return self

    def __exit__(self, *exc) -> None:
        self.tracer.complete(self.name, self.tid, self.t0,
                             self.clock.now_s() - self.t0,
                             **(self.args or {}))


class SpanTracer:
    """Chrome-trace span recorder over the ``core.clock`` seam.

    ``sample_every=N`` records phase spans on ticks where
    ``tick % N == 0`` only (``EngineCore`` routes its phase spans
    through :meth:`for_tick`); 1 records everything.
    """

    enabled = True

    def __init__(self, *, sample_every: int = 1,
                 max_events: int = 200_000) -> None:
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = sample_every
        self.max_events = max_events
        self.events: List[dict] = []
        self.dropped = 0
        self._tids: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def for_tick(self, tick: int):
        """The tracer an engine should route this tick's phase spans
        through: self on sampled ticks, the null tracer otherwise."""
        return self if tick % self.sample_every == 0 else NULL_TRACER

    def _tid(self, name: str) -> int:
        tid = self._tids.get(name)
        if tid is None:
            tid = len(self._tids)
            self._tids[name] = tid
            # metadata event names the swimlane in Perfetto
            self.events.append({"ph": "M", "name": "thread_name", "pid": 0,
                                "tid": tid, "args": {"name": name}})
        return tid

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span(self, clock, name: str, tid: str = "main", **args) -> _Span:
        """Context manager measuring one phase on ``clock`` (enter/exit
        reads only — never charges work)."""
        return _Span(self, clock, name, tid, args or None)

    def complete(self, name: str, tid: str, ts_s: float, dur_s: float,
                 **args) -> None:
        """Record an already-measured span (the tick scaffold holds t0
        itself)."""
        ev = {"ph": "X", "name": name, "pid": 0, "tid": self._tid(tid),
              "ts": round(ts_s * 1e6, 3), "dur": round(dur_s * 1e6, 3)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, clock, name: str, tid: str = "main", **args) -> None:
        """Zero-duration marker (admission, eviction)."""
        ev = {"ph": "i", "name": name, "pid": 0, "tid": self._tid(tid),
              "ts": round(clock.now_s() * 1e6, 3), "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")

    def spans(self, name: Optional[str] = None) -> List[dict]:
        """Recorded complete-spans, optionally filtered by name (tests
        and the dashboard read these; Perfetto reads the JSON)."""
        return [e for e in self.events if e["ph"] == "X"
                and (name is None or e["name"] == name)]

    def __len__(self) -> int:
        return len(self.events)
