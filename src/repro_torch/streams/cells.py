"""Two-level control plane: cell gateways own replica meshes, one region
gateway owns the cells — the city-scale shape.

A single :class:`~repro_torch.streams.gateway.FleetGateway` is O(fleet) on
the host every tick: one scheduler scans every replica, the event pump walks
every stream, the ledger and status surface touch every frame/replica.
That caps the "millions of vehicles" story at a few dozen replicas.  The
hierarchy bounds every per-tick host path by *cell*, not fleet:

  * :class:`CellGateway` IS a FleetGateway (placement, backpressure,
    failure rebind, tiering — all unchanged) plus a cell name and cheap
    load readings.  Everything that was fleet-global — the capacity
    scheduler scan, the TierDirector pressure scan, the fused fleet
    tick — is now cell-local by construction.
  * :class:`RegionGateway` places vehicles across cells by free capacity
    (an O(cells) scan over cached per-cell aggregates), routes
    ``push``/``leave``/``backlog`` through an O(1) vehicle->cell map,
    and runs a *bounded* control round per tick: at most ``pump_budget``
    cells are inspected for imbalance (round-robin cursor), and at most
    one vehicle hands off per inspected cell.
  * Cross-cell handoff reuses the detach/adopt state travel that
    failure rebind and tier migration already certify: the adaptive
    gate threshold, consumed ordinal, pending backlog, and event spool
    all move with the stream — across *gateways*, not just replicas —
    because both cells share one
    :class:`~repro_torch.events.plane.EventPlane` and the per-stream state
    rides ``StreamState``.
  * Telemetry rolls up instead of centralising: each cell owns its own
    ledger (``aggregate=True`` sketch mode at city scale — O(devices)
    host memory, not O(frames)); ``RegionGateway.rollup()`` merges them
    via ``Ledger.merge_from`` on demand.  Conservation holds at every
    level: per-record checks at cell ``add()`` time, cell-total vs
    region-total cross-checks in the simulator invariants.

The region deliberately duck-types the FleetGateway surface the
simulator, invariants, and status snapshot read (``replicas``,
``sessions``, ``dead``, ``_by_name``, ``sched.by_name``, ``rebinds``,
``refused``, ``ledger``) — those merged views are *verification and
display* surfaces, built on access; the serving hot paths never
materialise them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler import Assignment
from repro_torch.core.telemetry import Ledger, SegmentRecord
from repro_torch.streams.gateway import FleetGateway, StreamSession
from repro_torch.streams.vision_engine import OUTER, VisionServeEngine

__all__ = ["CellGateway", "RegionGateway"]


class CellGateway(FleetGateway):
    """One cell: a FleetGateway over its replica mesh, addressable by
    name inside a region.  All FleetGateway semantics are inherited
    unchanged — a cell is exactly the single-gateway deployment, scoped
    to its mesh — plus the cheap aggregate readings the region's
    placement and rebalance rounds consume."""

    def __init__(self, cell_name: str,
                 replicas: Sequence[VisionServeEngine], **kw) -> None:
        super().__init__(replicas, **kw)
        self.cell_name = cell_name

    # -- region-facing readings (O(replicas-in-cell), cells are small) --
    def free_streams(self) -> float:
        """Stream slots left under this cell's overcommit bound."""
        return self.capacity() * self.overcommit - self.active_streams()

    def load_factor(self) -> float:
        """Occupancy relative to the overcommit bound (1.0 = refusing)."""
        bound = self.capacity() * self.overcommit
        if bound <= 0:
            return float("inf")
        return self.active_streams() / bound


class _RegionSchedView:
    """`sched.by_name` over every cell's scheduler — the simulator
    installs HW priors and reads capacity EWMAs through this seam."""

    def __init__(self, cell_of_replica: Dict[str, CellGateway]) -> None:
        self._cell_of = cell_of_replica

    def by_name(self, name: str):
        return self._cell_of[name].sched.by_name(name)


class _RegionTieringView:
    """Merged read surface over the cells' TierDirectors (each director
    scans only its own cell — that is the point).  ``tiers``/``standby``
    answer the invariant suite's conservation checks; ``drain_actions``
    concatenates per-cell action logs in cell order for tracing."""

    def __init__(self, cells: Sequence[CellGateway]) -> None:
        self._cells = [c for c in cells if c.tiering is not None]

    @property
    def tiers(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for c in self._cells:
            out.update(c.tiering.tiers)
        return out

    @property
    def standby(self):
        out = set()
        for c in self._cells:
            out |= set(c.tiering.standby)
        return out

    @property
    def last_shift(self):
        for c in reversed(self._cells):
            if c.tiering.last_shift is not None:
                return c.tiering.last_shift
        return None

    @property
    def last_scale(self):
        for c in reversed(self._cells):
            if c.tiering.last_scale is not None:
                return c.tiering.last_scale
        return None

    def drain_actions(self) -> List[dict]:
        acts: List[dict] = []
        for c in self._cells:
            acts.extend(c.tiering.drain_actions())
        return acts


class _RegionFleetsView:
    """`_fleet.dispatches` summed over the cells' fused steppers — the
    runtime gauge and status snapshot read dispatch counts through the
    gateway's ``_fleet`` attribute."""

    def __init__(self, cells: Sequence[CellGateway]) -> None:
        self._cells = cells

    @property
    def dispatches(self) -> int:
        return sum(c._fleet.dispatches for c in self._cells
                   if c._fleet is not None)


class RegionGateway:
    """Places vehicle sessions across cells; hands off between them.

    The region's own per-tick work is O(cells) + O(pump_budget): pick
    cells by cached aggregates, inspect a bounded window for imbalance,
    delegate everything else.  It holds no per-stream state — the O(1)
    ``placements`` map (vehicle -> cell) is the only region-resident
    routing structure.
    """

    def __init__(self, cells: Sequence[CellGateway], *,
                 events=None, pump_budget: int = 2,
                 rebalance_margin: float = 0.25,
                 metrics=None, tracer=None) -> None:
        if not cells:
            raise ValueError("need at least one cell")
        names = [c.cell_name for c in cells]
        if len(set(names)) != len(names):
            raise ValueError(f"cell names must be unique: {names}")
        self.cells: List[CellGateway] = list(cells)
        self._cell_by_name: Dict[str, CellGateway] = {
            c.cell_name: c for c in self.cells}
        self._cell_of_replica: Dict[str, CellGateway] = {}
        for c in self.cells:
            if c.token_replicas:
                raise ValueError(
                    f"cell {c.cell_name!r} has token replicas — the "
                    f"region control plane places vision sessions only")
            for r in c.replicas:
                if r.name in self._cell_of_replica:
                    raise ValueError(
                        f"replica name {r.name!r} appears in cells "
                        f"{self._cell_of_replica[r.name].cell_name!r} "
                        f"and {c.cell_name!r}")
                self._cell_of_replica[r.name] = c
        for c in self.cells:
            if c.events is not events:
                raise ValueError(
                    f"cell {c.cell_name!r} is not on the region's event "
                    f"plane — all cells must share one plane so spools "
                    f"can travel across cells")
        self.events = events
        self.metrics = metrics
        self.tracer = tracer
        self.pump_budget = max(1, int(pump_budget))
        self.rebalance_margin = float(rebalance_margin)
        self.sched = _RegionSchedView(self._cell_of_replica)
        tv = _RegionTieringView(self.cells)
        self.tiering = tv if tv._cells else None
        # O(1) routing: the region's only per-vehicle state
        self.placements: Dict[str, CellGateway] = {}
        self.handoffs: List[dict] = []
        self._pending_handoffs: List[dict] = []
        self._handoff_rebinds: List[Tuple[str, str, str]] = []
        self._refused = 0
        self._cursor = 0            # round-robin rebalance window start
        self._ticks = 0
        # token surface: empty but present — status/invariants duck-type
        self.token_replicas: List = []
        self._token_by_name: Dict[str, object] = {}
        self.token_done: List = []
        self._fleet = (_RegionFleetsView(self.cells)
                       if any(c._fleet is not None for c in self.cells)
                       else None)

    # ------------------------------------------------------------------
    # merged views (verification / display surfaces — never on hot paths)
    # ------------------------------------------------------------------
    @property
    def replicas(self) -> List[VisionServeEngine]:
        return [r for c in self.cells for r in c.replicas]

    @property
    def sessions(self) -> Dict[str, Tuple[StreamSession, StreamSession]]:
        out: Dict[str, Tuple[StreamSession, StreamSession]] = {}
        for c in self.cells:
            out.update(c.sessions)
        return out

    @property
    def dead(self) -> set:
        out = set()
        for c in self.cells:
            out |= c.dead
        return out

    @property
    def _by_name(self) -> Dict[str, VisionServeEngine]:
        return {name: cell._by_name[name]
                for name, cell in self._cell_of_replica.items()}

    @property
    def rebinds(self) -> List[Tuple[str, str, str]]:
        out: List[Tuple[str, str, str]] = []
        for c in self.cells:
            out.extend(c.rebinds)
        out.extend(self._handoff_rebinds)
        return out

    @property
    def refused(self) -> int:
        return self._refused + sum(c.refused for c in self.cells)

    @property
    def closed(self) -> List[SegmentRecord]:
        out: List[SegmentRecord] = []
        for c in self.cells:
            out.extend(c.closed)
        return out

    @property
    def ledger(self) -> Ledger:
        return self.rollup()

    def rollup(self) -> Ledger:
        """Region telemetry = merge of the cell ledgers: sketches merge
        loss-free, totals/aggregates sum — the replica->cell->region
        roll-up path.  Built fresh on demand (status snapshots, run
        finalisation) so no double-counting accumulator can drift."""
        out = Ledger(aggregate=True)
        for c in self.cells:
            out.merge_from(c.ledger)
        return out

    # ------------------------------------------------------------------
    # capacity / placement
    # ------------------------------------------------------------------
    def live_replicas(self) -> List[VisionServeEngine]:
        return [r for c in self.cells for r in c.live_replicas()]

    def capacity(self) -> int:
        return sum(c.capacity() for c in self.cells)

    def active_streams(self) -> int:
        return sum(c.active_streams() for c in self.cells)

    def can_admit(self) -> bool:
        """True iff some cell can place an (outer, inner) pair under its
        own overcommit bound.  This is the region's admission predicate —
        region-total arithmetic can say "it fits" while every individual
        cell is full (fragmentation), so the invariant suite asks the
        region, not the totals."""
        return any(c.free_streams() >= 2 for c in self.cells)

    def _best_cell(self) -> CellGateway:
        # most free stream slots wins; cell-name tie-break keeps the
        # placement deterministic across runs and tick modes
        return max(self.cells,
                   key=lambda c: (c.free_streams(), c.cell_name))

    def join(self, vehicle: str, now_ms: float = 0.0,
             deadline_ms: Optional[float] = None
             ) -> Optional[Tuple[StreamSession, StreamSession]]:
        """Place the vehicle's (outer, inner) pair in the cell with the
        most free capacity.  Returns None when no cell can take a pair."""
        if vehicle in self.placements:
            raise KeyError(f"vehicle {vehicle!r} already joined")
        cell = self._best_cell()
        if cell.free_streams() < 2:
            self._refused += 1
            return None
        pair = cell.join(vehicle, now_ms=now_ms, deadline_ms=deadline_ms)
        if pair is None:                       # cell refused (race-proof)
            self._refused += 1
            return None
        self.placements[vehicle] = cell
        return pair

    def push(self, vehicle: str, outer_frame: np.ndarray,
             inner_frame: np.ndarray) -> Tuple[bool, bool]:
        return self.placements[vehicle].push(vehicle, outer_frame,
                                             inner_frame)

    def leave(self, vehicle: str) -> List[SegmentRecord]:
        cell = self.placements.pop(vehicle)
        return cell.leave(vehicle)

    def backlog(self, vehicle: str) -> int:
        return self.placements[vehicle].backlog(vehicle)

    def cell_of(self, vehicle: str) -> str:
        return self.placements[vehicle].cell_name

    # ------------------------------------------------------------------
    # replica failure / recovery (delegated to the owning cell)
    # ------------------------------------------------------------------
    def fail_replica(self, name: str, now_ms: float = 0.0
                     ) -> List[Tuple[str, str, str]]:
        """Fail a replica inside its cell: the cell rebinds the orphans
        onto its own survivors (cell-local state travel).  The capacity
        loss shows up in the cell's load factor, so the region's next
        rebalance rounds organically hand vehicles off to other cells."""
        if name not in self._cell_of_replica:
            raise KeyError(name)
        return self._cell_of_replica[name].fail_replica(name, now_ms)

    def restore_replica(self, name: str, now_ms: float = 0.0) -> None:
        if name not in self._cell_of_replica:
            raise ValueError(f"replica {name!r} is not in any cell")
        self._cell_of_replica[name].restore_replica(name, now_ms)

    # ------------------------------------------------------------------
    # cross-cell handoff
    # ------------------------------------------------------------------
    def handoff(self, vehicle: str, dst_cell: str,
                now_ms: float = 0.0) -> dict:
        """Move a vehicle's whole session pair to another cell.

        Per stream this is the same detach/adopt travel ``fail_replica``
        and ``migrate_stream`` perform — counters, pending backlog, the
        adapted gate threshold, and the event spool move with the stream
        — but across *gateways*: the source cell's scheduler frees the
        lanes (its load readings re-derive from engine occupancy), the
        destination cell's scheduler places each stream on its own mesh,
        outer first so the hazard class wins the good lanes.  Returns a
        handoff record carrying per-stream gate thresholds and consumed
        ordinals on both sides, which the ``cell-handoff`` invariant
        certifies (threshold identical, ordinal never decreases)."""
        from repro_torch.streams.tiers import stream_thresh
        src = self.placements[vehicle]
        dst = self._cell_by_name[dst_cell]
        if dst is src:
            raise ValueError(
                f"vehicle {vehicle!r} is already in cell {dst_cell!r}")
        if dst.free_streams() < 2:
            raise RuntimeError(
                f"cell {dst_cell!r} cannot take a pair "
                f"(free={dst.free_streams():.1f})")
        pair = src.sessions.pop(vehicle)
        streams = []
        # outer (hazard) first: same placement-priority rule as rebind
        for sess in sorted(pair, key=lambda s: (s.stream != OUTER, s.key)):
            src_eng = src._by_name[sess.engine]
            thresh_before = stream_thresh(src_eng, sess.key)
            ordinal_before = src_eng.streams[sess.key].consumed
            st = src_eng.detach_stream(sess.key)
            # adopt_stream consumes event_state — read the depth now
            spool_depth = (st.event_state["spool"].depth
                           if st.event_state else 0)
            src._sync_load(now_ms)
            dst._sync_load(now_ms)
            target = dst.sched._pick_worker(now_ms).name
            dst_eng = dst._by_name[target]
            dst_eng.adopt_stream(st)
            moved_from = sess.engine
            sess.engine = target
            sess.assignment = Assignment(sess.assignment.segment, target)
            sess.credit_frames = st.processed
            sess.credit_ms = st.processing_ms
            dst.sched.commit(sess.assignment, busy_until_ms=now_ms)
            self._handoff_rebinds.append((sess.key, moved_from, target))
            streams.append({
                "key": sess.key, "src": moved_from, "dst": target,
                "thresh_before": thresh_before,
                "thresh_after": stream_thresh(dst_eng, sess.key),
                "ordinal_before": ordinal_before,
                "ordinal_after": st.consumed,
                "spool_depth": spool_depth})
        dst.sessions[vehicle] = pair
        self.placements[vehicle] = dst
        rec = {"vehicle": vehicle, "src_cell": src.cell_name,
               "dst_cell": dst.cell_name, "streams": streams}
        self.handoffs.append(rec)
        self._pending_handoffs.append(rec)
        return rec

    def drain_handoffs(self) -> List[dict]:
        """Handoff records since the last drain (runner tracing hook —
        mirrors ``TierDirector.drain_actions``)."""
        out, self._pending_handoffs = self._pending_handoffs, []
        return out

    # ------------------------------------------------------------------
    # bounded region control
    # ------------------------------------------------------------------
    def rebalance(self, now_ms: float = 0.0) -> List[dict]:
        """One bounded control round: inspect at most ``pump_budget``
        cells (round-robin window over the cell list) and hand at most
        one vehicle per inspected cell to the least-loaded cell, when
        the load-factor gap exceeds ``rebalance_margin`` and the target
        can take a pair.  All decisions read host-side counters only —
        deterministic for a seed, and identical under serial and fused
        cell ticks."""
        n = len(self.cells)
        if n < 2:
            return []
        moved: List[dict] = []
        for i in range(min(self.pump_budget, n)):
            cell = self.cells[(self._cursor + i) % n]
            target = min(
                self.cells,
                key=lambda c: (c.load_factor(), c.cell_name))
            if target is cell:
                continue
            if cell.load_factor() - target.load_factor() \
                    <= self.rebalance_margin:
                continue
            if target.free_streams() < 2 or not cell.sessions:
                continue
            vehicle = min(cell.sessions)        # deterministic pick
            moved.append(self.handoff(vehicle, target.cell_name,
                                      now_ms=now_ms))
        self._cursor = (self._cursor + min(self.pump_budget, n)) % n
        return moved

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One region tick: a bounded control round, then every cell's
        own tick (cell-local scheduling, tiering, engine stepping), then
        exactly one event-plane delivery round for the whole region."""
        self._ticks += 1
        self.rebalance(now_ms=float(self._ticks))
        done = 0
        for c in self.cells:
            done += c.tick(pump_events=False)
        if self.events is not None:
            self.events.pump()
        return done

    def drain(self, max_ticks: int = 100_000) -> int:
        done = 0
        ticks = 0
        while any(r.has_work() for c in self.cells
                  for r in c.live_replicas()) and ticks < max_ticks:
            done += self.tick()
            ticks += 1
        return done
