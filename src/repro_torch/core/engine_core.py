"""Workload-agnostic continuous-batching core (the shared EngineCore).

EDA's central claim is one edge runtime serving heterogeneous analytics
classes (outer/hazard, inner/distraction) under deadlines on transient
devices.  Historically this repo implemented that policy twice: the
vision engine (``streams/vision_engine.py``) and the token engine
(``serving/engine.py``) each carried their own slot pool, priority queue,
deadline→budget derivation, and timing plumbing.  This module is the
single substrate both now ride:

  * :func:`insert_row` / :func:`batch_axis` — slot-pool row admission: a
    1-row tree (a prefilled KV cache, a staged frame batch row) is
    written in place into the ``slot``'th batch row of a fixed-shape
    pool, so admission never changes a shape;
  * :class:`PriorityQueue` — the two-class admission/wait queue: a
    priority-0 (outer/hazard) entry always jumps ahead of every
    priority>0 (inner/distraction) entry, FIFO within a class, with an
    optional bounded-bypass aging pop so sustained hazard load cannot
    starve the distraction class forever;
  * :class:`LanePool` — long-lived binding of work sources (vehicle
    streams, decode requests) to slot rows, with the
    outer-preempts-inner eviction rule (priority 0 evicts the most
    recently bound priority>0 holder) and re-queue-at-front semantics
    for the victim;
  * :class:`EngineCore` — the per-tick phase scaffold shared by every
    workload shell: the ``core.clock`` seam (wall time in production,
    per-replica virtual time under the simulator), the
    ``begin_tick`` / ``end_tick`` halves the fleet-parallel tick
    (``streams.fleet_step``) wraps around one fused dispatch, cost EWMAs
    (per-unit and per-tick), deadline→budget derivation through one
    ``EarlyStopPolicy``, and ``telemetry.Ledger`` record emission.

A workload shell (``VisionServeEngine``: frame-ingest-and-gate;
``ServeEngine``: chunked-prefill-and-decode) supplies only the staging
and model-dispatch semantics; everything schedulable about it — slots,
priorities, deadlines, clocks, ledgers — lives here, which is what lets
the gateway/fleet/simulator stack drive any workload class.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional

from repro_torch.config import EDAConfig
from repro_torch.core.clock import TICK, Clock, WallClock
from repro_torch.core.early_stop import EWMA, EarlyStopPolicy
from repro_torch.core.telemetry import Ledger
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import NULL_TRACER

# The two analytics classes (paper §3.2.5): priority 0 = outer/hazard,
# priority > 0 = inner/distraction.  Exported here so workload shells and
# the fleet stack share one spelling.
OUTER, INNER = "outer", "inner"


@dataclass(frozen=True)
class PressureSignal:
    """One engine's load snapshot for fleet-level control decisions.

    Read by the tier director (``streams.tiers``) at the top of every
    gateway tick — pure host state, so sampling it never perturbs device
    work or digests.  ``backlog_per_slot`` is the primary migration /
    autoscaling signal; ``deadline_ewma`` (smoothed deadline-trimmed
    units per tick) flags replicas that are shedding work to stay live.
    """
    backlog: int                 # queued work units (frames / requests)
    backlog_per_slot: float      # backlog normalised by engine width
    deadline_ewma: float         # EWMA of deadline-dropped units per tick
    tick_cost_ms: float          # current per-tick latency estimate


# ---------------------------------------------------------------------------
# slot-pool row admission
# ---------------------------------------------------------------------------
def batch_axis(a, r) -> int:
    """Find the axis where pool ``a`` and row ``r`` disagree (slots vs 1)."""
    assert a.ndim == r.ndim, (a.shape, r.shape)
    for i, (da, dr) in enumerate(zip(a.shape, r.shape)):
        if da != dr:
            return i
    return 0


def insert_row(pool, row, slot: int):
    """Write a 1-row tree into the ``slot``'th batch row of the pool.

    Each leaf of ``row`` has batch dim 1 at the same axis position as the
    matching ``pool`` leaf's batch dim.  Unlike the reference, whose arrays
    are immutable, the write lands in place in the pool's own storage
    (cast to the pool's dtype), so admission allocates nothing and keeps
    every shape fixed.  Returns ``pool``; leaves are tensors, nested in
    dicts, lists or tuples.
    """
    if isinstance(pool, dict):
        for k in pool:
            insert_row(pool[k], row[k], slot)
        return pool
    if isinstance(pool, (list, tuple)):
        for a, r in zip(pool, row):
            insert_row(a, r, slot)
        return pool
    axis = batch_axis(pool, row)
    pool.narrow(axis, slot, 1).copy_(row)
    return pool


# ---------------------------------------------------------------------------
# paged-KV block pool
# ---------------------------------------------------------------------------
class BlockPoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list.

    Loud by design: silently admitting a request without cache blocks is
    the overflow bug class (a write lands in another request's blocks).
    Callers that want backpressure catch this and leave the request
    queued; callers that cannot ever satisfy the request must reject at
    submit time."""


class BlockPool:
    """Host-side allocator for fixed-size KV cache blocks.

    The paged-KV analogue of the slot pool: device memory holds one
    shared pool of ``num_blocks`` blocks of ``block_size`` cache entries
    (``models.attention.init_paged_cache``); this class owns *which
    request holds which block ids*.  Allocation is all-or-nothing (a
    partially allocated request would decode against missing blocks) and
    ownership-checked on free, so a double-free or a free of another
    request's block raises instead of silently corrupting the pool.
    Block ids are handed out deterministically (ascending free list), so
    simulator traces stay seed-deterministic.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 1 or block_size < 1:
            raise ValueError(f"BlockPool needs num_blocks >= 1 and "
                             f"block_size >= 1, got {num_blocks}, "
                             f"{block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # stack popped from the tail: ids come out ascending-first
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._owner: dict = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._owner)

    def alloc(self, n: int, owner) -> List[int]:
        """Take ``n`` blocks for ``owner``; all-or-nothing.  Raises
        :class:`BlockPoolExhausted` when fewer than ``n`` are free."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"need {n} blocks for {owner!r} but only "
                f"{len(self._free)}/{self.num_blocks} free "
                f"({len(self._owner)} held)")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._owner[b] = owner
        return blocks

    def free(self, blocks: List[int], owner) -> None:
        """Return ``blocks`` held by ``owner``.  A block that is not
        currently allocated (double free) or is held by someone else
        raises before any state changes."""
        for b in blocks:
            if b not in self._owner:
                raise ValueError(
                    f"free of block {b} by {owner!r}: not allocated "
                    f"(double free?)")
            if self._owner[b] != owner:
                raise ValueError(
                    f"free of block {b} by {owner!r}: held by "
                    f"{self._owner[b]!r}")
        for b in blocks:
            del self._owner[b]
            self._free.append(b)

    def owner_of(self, block: int):
        return self._owner.get(block)


# ---------------------------------------------------------------------------
# two-class priority queue
# ---------------------------------------------------------------------------
class PriorityQueue:
    """Two-class FIFO: priority-0 entries order ahead of priority>0 ones.

    Insertion (:meth:`push`) keeps the queue partitioned — every
    priority-0 entry sits ahead of every priority>0 entry, FIFO within a
    class — so a hazard submit is *never ordered behind* a distraction
    entry.  ``front=True`` queues an entry ahead of its own priority
    class (an eviction victim re-binds first among peers) but never ahead
    of a higher class.

    :meth:`pop` takes the head, with optional aging: with a finite
    ``starvation_limit`` K, popping a priority-0 entry while priority>0
    entries wait counts as a bypass, and once K bypasses accumulate the
    oldest waiting priority>0 entry is served instead — so sustained
    hazard load cannot starve the distraction class (at least one
    distraction entry is served per K+1 pops).  The default (``None``)
    disables aging: the vision engine's wait queue relies on lane quantum
    rotation for fairness instead and must keep its exact historical
    ordering (golden-trace pinned).
    """

    def __init__(self, starvation_limit: Optional[int] = None) -> None:
        if starvation_limit is not None and starvation_limit < 1:
            raise ValueError(f"starvation_limit must be >= 1 or None, "
                             f"got {starvation_limit}")
        self.starvation_limit = starvation_limit
        self._items: Deque = deque()
        self._bypasses = 0

    # -- insertion ------------------------------------------------------
    def push(self, item, front: bool = False) -> None:
        if front:
            idx = next((i for i, w in enumerate(self._items)
                        if w.priority >= item.priority), len(self._items))
        else:
            idx = next((i for i, w in enumerate(self._items)
                        if w.priority > item.priority), len(self._items))
        self._items.insert(idx, item)

    # -- removal --------------------------------------------------------
    def pop(self):
        """Pop the head entry (aging-aware when a limit is configured).

        The bypass counter tracks the *current* starvation episode only:
        it resets whenever a priority>0 entry is served (head or aging
        pop) or none is waiting — stale credit from a drained episode
        must not let a fresh priority>0 arrival jump a hazard early."""
        if not self._items:
            raise IndexError("pop from an empty PriorityQueue")
        head = self._items[0]
        if self.starvation_limit is not None:
            if head.priority > 0:
                self._bypasses = 0       # starving class served normally
            else:
                starved = next((i for i, w in enumerate(self._items)
                                if w.priority > 0), None)
                if starved is None:
                    self._bypasses = 0   # nobody waiting behind the hazard
                elif self._bypasses >= self.starvation_limit:
                    self._bypasses = 0
                    item = self._items[starved]
                    del self._items[starved]
                    return item
                else:
                    self._bypasses += 1
        self._items.popleft()
        return head

    def popleft(self):
        """Raw head pop — never applies aging (lane-rotation callers)."""
        return self._items.popleft()

    def remove(self, item) -> None:
        self._items.remove(item)

    # -- container protocol --------------------------------------------
    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, idx):
        return self._items[idx]

    def __delitem__(self, idx) -> None:
        del self._items[idx]

    def __contains__(self, item) -> bool:
        return item in self._items


# ---------------------------------------------------------------------------
# lane pool (slot binding with outer-preempts-inner eviction)
# ---------------------------------------------------------------------------
class LanePool:
    """Binds work sources to slot rows for their lifetime.

    Items need three attributes the pool owns while bound: ``priority``
    (0 = hazard class), ``lane`` (-1 when unbound) and ``bound_seq``
    (binding order, the preemption victim pick).  ``on_bind(item, lane)``
    / ``on_unbind(item, lane)`` hooks let the workload shell move
    per-lane state (gate references, quantum counters) with the binding.

    With ``preempt=True`` (the vision engine) a priority-0 item that
    finds every lane taken evicts the *most recently bound* priority>0
    holder (hazards outrank distraction — paper §3.2.5); the victim keeps
    its backlog and re-queues at the front of its own class.  With
    ``preempt=False`` (the token engine) binding only takes free lanes —
    an admitted request's cache row is never evicted mid-decode.
    """

    def __init__(self, slots: int, *, preempt: bool = True,
                 on_bind: Optional[Callable] = None,
                 on_unbind: Optional[Callable] = None,
                 starvation_limit: Optional[int] = None) -> None:
        self.slots = slots
        self.preempt = preempt
        self.on_bind = on_bind
        self.on_unbind = on_unbind
        self.lanes: List[Optional[object]] = [None] * slots
        self.waiting = PriorityQueue(starvation_limit=starvation_limit)
        self._bind_seq = 0

    # ------------------------------------------------------------------
    def try_bind(self, item) -> bool:
        """Bind to a free lane, else (hazard class only) evict the most
        recently bound lower-priority holder.  Returns False when the
        item must wait."""
        for lane, cur in enumerate(self.lanes):
            if cur is None:
                self.bind(item, lane)
                return True
        if self.preempt and item.priority == 0:
            victims = [s for s in self.lanes if s and s.priority > 0]
            if victims:
                victim = max(victims, key=lambda s: s.bound_seq)
                lane = self.unbind(victim)
                self.waiting.push(victim, front=True)
                self.bind(item, lane)
                return True
        return False

    def bind(self, item, lane: int) -> None:
        self.lanes[lane] = item
        item.lane = lane
        self._bind_seq += 1
        item.bound_seq = self._bind_seq
        if self.on_bind is not None:
            self.on_bind(item, lane)

    def unbind(self, item) -> int:
        lane = item.lane
        if self.on_unbind is not None:
            self.on_unbind(item, lane)
        self.lanes[lane] = None
        item.lane = -1
        return lane

    def free(self, item) -> int:
        """Unbind and hand the lane to the next waiter, if any."""
        lane = self.unbind(item)
        if self.waiting:
            self.bind(self.waiting.popleft(), lane)
        return lane

    @property
    def bound_count(self) -> int:
        return sum(s is not None for s in self.lanes)


# ---------------------------------------------------------------------------
# the shared tick scaffold
# ---------------------------------------------------------------------------
class EngineCore:
    """Continuous-batching tick scaffold shared by every workload shell.

    Owns the schedulable substrate — clock seam, EDA deadline policy,
    cost EWMAs, tick counters, ledger — and the per-tick phase protocol
    the fleet-parallel tick relies on:

        t0 = engine.begin_tick()     # rebalance() hook + TICK charge
        ... stage / dispatch / commit (workload shell) ...
        engine.end_tick(t0, done)    # tick-cost EWMA + tick counter

    Cost estimators: ``unit_cost_ms`` is the batch-amortised per-unit
    (frame/token) throughput estimate fed by :meth:`finish_dispatch`;
    ``tick_cost_ms`` is the per-tick *latency* estimate (a stream or
    request completes one unit per whole tick, however wide the batch) —
    the deadline budget divides by the latter.
    """

    def __init__(self, name: str, *, slots: int,
                 eda: Optional[EDAConfig] = None,
                 ledger: Optional[Ledger] = None,
                 clock: Optional[Clock] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None) -> None:
        self.name = name
        self.slots = slots
        self.clock = clock if clock is not None else WallClock()
        self.eda = eda or EDAConfig()
        self.policy = EarlyStopPolicy(esd=self.eda.esd)
        self.ledger = ledger if ledger is not None else Ledger()
        self.unit_cost_ms = EWMA(alpha=self.eda.ewma_alpha)
        self.tick_cost_ms = EWMA(alpha=self.eda.ewma_alpha)
        self.ticks = 0
        self.busy_s = 0.0
        # deadline-pressure signal: workload shells report trimmed units
        # via note_deadline_drops(); end_tick folds them into an EWMA the
        # tier director reads through pressure()
        self.deadline_drop_ewma = EWMA(alpha=0.2)
        self._deadline_drops_tick = 0
        # observability seams — NULL_TRACER / no registry by default, so
        # an uninstrumented engine pays one attribute read per phase
        self.metrics: Optional[MetricsRegistry] = None
        self.tracer = NULL_TRACER
        self._tick_tracer = NULL_TRACER   # this tick's (sampled) tracer
        self._m_ticks = self._m_tick_ms = None
        self._m_dispatches = self._m_units = self._m_unit_ms = None
        if metrics is not None or tracer is not None:
            self.attach_obs(metrics=metrics, tracer=tracer)
        # event-plane seam (``events``): the gateway installs an
        # EventEmitter when an EventPlane is attached; None costs one
        # attribute read per hook site, exactly like the obs seams
        self.emitter = None

    # ------------------------------------------------------------------
    # observability seams
    # ------------------------------------------------------------------
    def attach_obs(self, metrics: Optional[MetricsRegistry] = None,
                   tracer=None) -> None:
        """(Re)attach the observability plane: a shared
        :class:`~repro_torch.obs.metrics.MetricsRegistry` and/or a
        :class:`~repro_torch.obs.tracing.SpanTracer`.  Late attachment is the
        normal path — the gateway attaches fleet-wide obs to replicas it
        adopts, mirroring how it shares its ledger.  Labeled hot-path
        children are resolved once here, never per tick."""
        if tracer is not None:
            self.tracer = tracer
        if metrics is not None:
            self.metrics = metrics
        m = self.metrics
        if m is None:
            return
        eng = ("engine",)
        self._m_ticks = m.counter(
            "engine_ticks_total", "engine ticks run", eng,
        ).labels(engine=self.name)
        self._m_tick_ms = m.histogram(
            "engine_tick_ms", "per-tick latency, ticks with work", eng,
        ).labels(engine=self.name)
        self._m_dispatches = m.counter(
            "engine_dispatches_total", "model dispatches issued", eng,
        ).labels(engine=self.name)
        self._m_units = m.counter(
            "engine_units_total", "work units (frames/tokens) dispatched",
            eng,
        ).labels(engine=self.name)
        self._m_unit_ms = m.histogram(
            "engine_unit_ms", "batch-amortised per-unit dispatch cost", eng,
        ).labels(engine=self.name)

    def tspan(self, name: str, **args):
        """A phase span on this tick's tracer (the null span unless the
        tick is sampled).  Timestamps come from the engine clock — pure
        reads, so tracing never perturbs virtual time."""
        return self._tick_tracer.span(self.clock, name, tid=self.name,
                                      **args)

    def tinstant(self, name: str, **args) -> None:
        """A zero-duration marker (an admission) on this tick's
        tracer."""
        self._tick_tracer.instant(self.clock, name, tid=self.name, **args)

    # ------------------------------------------------------------------
    # deadline → budget (the ESD derivation, in exactly one place)
    # ------------------------------------------------------------------
    def budget(self, deadline_ms: float, total_units: int,
               est_unit_cost_ms: float) -> int:
        """Units (frames/tokens) affordable inside ``deadline_ms`` at the
        estimated per-unit cost, under the engine's ESD policy.  With no
        deadline or a disabled policy the full total is returned."""
        if deadline_ms <= 0 or not self.policy.enabled:
            return total_units
        return self.policy.frame_budget(deadline_ms, total_units,
                                        est_unit_cost_ms)

    # ------------------------------------------------------------------
    # tick phases
    # ------------------------------------------------------------------
    def rebalance(self) -> None:
        """Tick-start housekeeping hook (lane rebalancing, admission)."""

    def begin_tick(self) -> float:
        """Host half of tick start: the :meth:`rebalance` hook + the fixed
        per-tick clock charge.  Returns the clock reading ``end_tick``
        measures the tick-cost EWMA from.  Split from the dispatch body so
        the fleet-parallel tick (``streams.fleet_step``) can run identical
        host phases around one fused device dispatch."""
        # sample-select the tick's tracer BEFORE rebalance, so admission
        # work done in the rebalance hook (token prefill) is covered
        self._tick_tracer = self.tracer.for_tick(self.ticks)
        self.rebalance()
        t0 = self.clock.now_s()
        self.clock.charge(TICK)                  # fixed per-tick overhead
        return t0

    def end_tick(self, t0_s: float, done: int) -> None:
        """Tick-cost EWMA + tick counter — the closing half of a tick."""
        dt_ms = (self.clock.now_s() - t0_s) * 1000.0
        if done:
            self.tick_cost_ms.update(dt_ms)
        tr = self._tick_tracer
        if tr.enabled:
            tr.complete("tick", self.name, t0_s, dt_ms / 1000.0,
                        tick=self.ticks, done=done)
        if self._m_ticks is not None:
            self._m_ticks.inc()
            if done:
                self._m_tick_ms.observe(dt_ms)
        self.deadline_drop_ewma.update(float(self._deadline_drops_tick))
        self._deadline_drops_tick = 0
        self.ticks += 1

    # ------------------------------------------------------------------
    # backlog / deadline pressure (read by the tier director)
    # ------------------------------------------------------------------
    def note_deadline_drops(self, n: int) -> None:
        """Workload-shell hook: record ``n`` units trimmed to meet a
        deadline this tick (folded into the EWMA at ``end_tick``)."""
        self._deadline_drops_tick += n

    def backlog_units(self) -> int:
        """Queued work units awaiting service.  Workload shells override
        (pending frames, queued+active requests); the base has none."""
        return 0

    def pressure(self) -> PressureSignal:
        """This engine's load snapshot — pure host reads, digest-safe."""
        backlog = self.backlog_units()
        return PressureSignal(
            backlog=backlog,
            backlog_per_slot=backlog / max(self.slots, 1),
            deadline_ewma=self.deadline_drop_ewma.get(0.0),
            tick_cost_ms=self.tick_cost_ms.get(0.0))

    def finish_dispatch(self, n_units: int, t0_s: float, charge_kind: str,
                        dt_override_s: Optional[float] = None) -> float:
        """Account one model dispatch of ``n_units`` work units: clock
        charge, busy time, per-unit cost EWMA.  Returns the dispatch's
        elapsed seconds.  ``dt_override_s`` carries a fleet-parallel
        replica's share of the measured fused wall time (a virtual clock
        never passes it — its charge IS the cost)."""
        self.clock.charge(charge_kind, n_units)  # no-op on a WallClock
        dt = self.clock.now_s() - t0_s
        if dt_override_s is not None:
            dt = dt_override_s
        self.busy_s += dt
        self.unit_cost_ms.update(dt * 1000.0 / n_units)
        if self._m_dispatches is not None:
            self._m_dispatches.inc()
            self._m_units.inc(n_units)
            self._m_unit_ms.observe(dt * 1000.0 / n_units)
        return dt

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        raise NotImplementedError
