"""Clock seam: wall time for production, virtual time for simulation.

The fleet stack (``VisionServeEngine``, ``FleetGateway``) needs time for
three things — per-frame/tick cost EWMAs, deadline (ESD) trims, and ledger
turnaround — and all three used to read ``time.perf_counter`` directly.
That makes the stack untestable under churn: a scenario simulator cannot
reproduce "replica r1 is 4x slower" or "the backlog is 900 ms stale" on a
laptop's real clock, and nothing that depends on wall time can ever be
bit-deterministic per seed.

``Clock`` is the seam.  Production keeps :class:`WallClock` (the default
everywhere, zero behaviour change).  the fleet simulator injects a
:class:`VirtualClock` per replica whose time advances only when the engine
*charges* work onto it, at a per-kind rate derived from the replica's
``HardwareInfo`` — so a weak replica's ticks genuinely take longer in
virtual time, its capacity EWMA genuinely reads lower, and the scheduler's
placement decisions under heterogeneity become deterministic, replayable
functions of the scenario seed.

The charge protocol:

  * ``charge("frame", n)`` — the engine dispatched ``n`` frames of model
    inference; a virtual clock advances ``n * rate["frame"]`` seconds
    (wall clocks ignore it — real dispatch already took real time);
  * ``charge("tick", 1)``  — fixed per-tick overhead (staging, gating,
    host bookkeeping).

Because charges happen *between* the engine's ``now_s()`` reads, the
existing EWMA plumbing measures virtual costs through exactly the code
path that measures wall costs — no simulator-only estimators to drift.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

# Charge kinds used by the engines; a Clock may price any subset of these
# (unknown kinds advance a VirtualClock by 0 — they are free).
FRAME = "frame"          # one frame of vision-model inference
TOKEN = "token"          # one decoded token (token-engine decode tick)
PREFILL = "prefill"      # one prompt token prefilled (chunked prefill)
TICK = "tick"


class Clock:
    """Monotonic time source + work-charging protocol."""

    def now_s(self) -> float:
        raise NotImplementedError

    def charge(self, kind: str, units: float = 1.0) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Real time (``time.perf_counter``).  Work charges are no-ops: real
    dispatch already spends real time between ``now_s()`` reads."""

    def now_s(self) -> float:
        return time.perf_counter()

    def charge(self, kind: str, units: float = 1.0) -> None:
        pass


class VirtualClock(Clock):
    """Deterministic clock: time advances only via :meth:`charge` (at the
    configured per-kind rate) and :meth:`advance` (simulator-driven)."""

    def __init__(self, rates: Optional[Dict[str, float]] = None,
                 start_s: float = 0.0) -> None:
        self.rates = dict(rates or {})        # kind -> seconds per unit
        self._now_s = float(start_s)
        self.charged: Dict[str, float] = {}   # kind -> total units charged

    def now_s(self) -> float:
        return self._now_s

    def charge(self, kind: str, units: float = 1.0) -> None:
        self.charged[kind] = self.charged.get(kind, 0.0) + units
        self._now_s += self.rates.get(kind, 0.0) * units

    def advance(self, dt_s: float) -> None:
        if dt_s < 0:
            raise ValueError(f"clock cannot run backwards (dt_s={dt_s})")
        self._now_s += dt_s
