"""FleetStatus: one point-in-time health snapshot of a serving fleet.

The exposition surface's structured half: where ``MetricsRegistry.
expose()`` answers "what are the time series", :func:`FleetStatus.
from_gateway` answers "what is the fleet doing *right now*" — per-replica
lane occupancy and binds, backlogs, adaptive gate thresholds, cost EWMAs,
the fused-dispatch counter (whose 1-dispatch-per-tick contract
``streams.fleet_step`` keeps), the first-use build probe
(``obs.probes.jit_cache_entries``: kernel libraries, shape tables, ticket
buffers — the reference's field name, the port's own count), and
optional per-vehicle battery/energy readings (the simulator passes its
vehicle table; a real deployment passes telemetry from the vehicles).

Everything is a read — building a status never mutates engine state, so
it is safe to snapshot mid-run at any tick.  ``render()`` is the text
dashboard; ``to_dict()`` is the machine surface (JSON endpoint, artifact
dumps).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.probes import jit_cache_entries


@dataclass
class ReplicaStatus:
    """One engine replica's health row (vision or token shell)."""
    name: str
    kind: str                        # "vision" | "token"
    dead: bool
    slots: int
    bound: int
    sessions: int                    # streams open / requests in flight
    waiting: int                     # unbound entries in the wait queue
    backlog: int                     # pending frames / queued requests
    ticks: int
    served: int                      # frames processed / tokens generated
    busy_s: float
    unit_cost_ms: float
    tick_cost_ms: float
    lane_binds: List[Optional[str]] = field(default_factory=list)
    gate_thresh: Optional[Tuple[float, float, float]] = None  # min/mean/max
    spool_depth: int = 0             # undelivered events (event plane)
    tier: Optional[str] = None       # advertised model tier (tiered fleets)

    @property
    def occupancy(self) -> float:
        return self.bound / self.slots if self.slots else 0.0


@dataclass
class FleetStatus:
    """Whole-fleet snapshot: replicas + gateway + runtime counters."""
    replicas: List[ReplicaStatus]
    sessions: int                    # open vehicle sessions (stream pairs)
    refused: int
    rebinds: int
    fused_dispatches: int            # fleet_step's 1-per-tick counter
    jit_cache: int                   # first-use build probe reading
    token_done: int = 0
    ledger_records: int = 0
    ledger_energy_j: float = 0.0
    # event/alert plane counters (all zero when no plane is attached)
    events_emitted: int = 0
    events_accepted: int = 0
    events_duplicates: int = 0       # replays the idempotent sink rejected
    events_suppressed: int = 0       # cooldown-window suppressions
    events_spool_depth: int = 0      # fleet-wide undelivered backlog
    events_overflow: int = 0         # loud bounded-spool drops
    vehicle_energy: Dict[str, Tuple[float, float]] = field(
        default_factory=dict)    # name -> (energy_j, battery_j)
    # per-tier aggregates + the autoscaler's latest decisions (tiered
    # fleets only; both empty/None when no TierDirector is attached)
    tiers: Dict[str, dict] = field(default_factory=dict)
    last_shift: Optional[dict] = None
    last_scale: Optional[dict] = None
    # hierarchical fleets (streams.cells): one aggregate row per cell,
    # cross-cell handoff count, and the full fleet size when the replica
    # rows below are a bounded top-K selection
    cells: Dict[str, dict] = field(default_factory=dict)
    handoffs: int = 0
    total_replicas: int = 0

    # ------------------------------------------------------------------
    @classmethod
    def from_gateway(cls, gw, *,
                     vehicle_energy: Optional[Dict[str, Tuple[float, float]]]
                     = None, top_k: int = 8) -> "FleetStatus":
        """Snapshot a live :class:`~repro_torch.streams.gateway.FleetGateway`
        or :class:`~repro_torch.streams.cells.RegionGateway` (plus token
        replicas, if any).  ``vehicle_energy`` maps vehicle name ->
        (energy_spent_j, battery_budget_j).

        The snapshot stays bounded at fleet scale: hierarchical gateways
        (and flat fleets past 64 replicas) keep one aggregate row per
        cell and only the ``top_k`` highest-pressure replicas
        (backlog + waiting) as individual rows — a 64-replica snapshot
        renders in the same space as an 8-replica one."""
        replicas = []
        ev = getattr(gw, "events", None)

        # one pass over the emitters — the per-replica closure used to
        # rescan every emitter per replica, O(replicas x emitters)
        depth_by_owner: Dict[str, int] = {}
        if ev is not None:
            for em in ev.emitters:
                depth_by_owner[em.owner] = (
                    depth_by_owner.get(em.owner, 0) + em.depth())

        def _spool_depth(name: str) -> int:
            return depth_by_owner.get(name, 0)

        for r in gw.replicas:
            gates = [g for g in r.gates.values() if g is not None]
            thresh = None
            if gates:
                vals = [float(t) for g in gates for t in g.thresh]
                thresh = (min(vals), sum(vals) / len(vals), max(vals))
            replicas.append(ReplicaStatus(
                name=r.name, kind="vision", dead=r.name in gw.dead,
                slots=r.slots, bound=r.bound_count,
                sessions=r.session_count,
                waiting=len(r.waiting),
                backlog=sum(len(st.pending) for st in r.streams.values()),
                ticks=r.ticks, served=r.frames_processed, busy_s=r.busy_s,
                unit_cost_ms=r.unit_cost_ms.get(0.0),
                tick_cost_ms=r.tick_cost_ms.get(0.0),
                lane_binds=[st.key if st is not None else None
                            for st in r.lanes],
                gate_thresh=thresh,
                spool_depth=_spool_depth(r.name),
                tier=(r.tier.name if getattr(r, "tier", None) is not None
                      else None)))
        for e in gw.token_replicas:
            in_flight = sum(req is not None for req in e.active)
            replicas.append(ReplicaStatus(
                name=e.name, kind="token", dead=e.name in gw.dead,
                slots=e.slots, bound=in_flight,
                sessions=in_flight + len(e.queue),
                waiting=len(e.queue),
                backlog=len(e.queue),
                ticks=e.ticks, served=e.tokens_generated, busy_s=e.busy_s,
                unit_cost_ms=e.unit_cost_ms.get(0.0),
                tick_cost_ms=e.tick_cost_ms.get(0.0),
                lane_binds=[req.rid if req is not None else None
                            for req in e.active],
                spool_depth=_spool_depth(e.name)))
        evt_counts = dict(events_emitted=0, events_accepted=0,
                          events_duplicates=0, events_suppressed=0,
                          events_spool_depth=0, events_overflow=0)
        if ev is not None:
            evt_counts = dict(
                events_emitted=ev.emitted,
                events_accepted=ev.sink.accepted_count,
                events_duplicates=ev.sink.duplicates,
                events_suppressed=ev.suppressed,
                events_spool_depth=ev.depth(),
                events_overflow=ev.overflow_dropped())
        tiers: Dict[str, dict] = {}
        last_shift = last_scale = None
        director = getattr(gw, "tiering", None)
        if director is not None:
            standby = set(director.standby)
            for r in gw.replicas:
                tier = director.tiers.get(r.name)
                if tier is None:
                    continue
                agg = tiers.setdefault(tier.name, dict(
                    replicas=0, live=0, standby=0, sessions=0,
                    backlog=0, bound=0, slots=0))
                agg["replicas"] += 1
                if r.name in standby:
                    agg["standby"] += 1
                elif r.name not in gw.dead:
                    agg["live"] += 1
                    agg["sessions"] += r.session_count
                    agg["backlog"] += sum(len(st.pending)
                                          for st in r.streams.values())
                    agg["bound"] += r.bound_count
                    agg["slots"] += r.slots
            last_shift = director.last_shift
            last_scale = director.last_scale
        cells: Dict[str, dict] = {}
        gw_cells = getattr(gw, "cells", None)
        if gw_cells is not None:
            for cell in gw_cells:
                live = cell.live_replicas()
                cells[cell.cell_name] = dict(
                    replicas=len(cell.replicas), live=len(live),
                    sessions=cell.active_streams(),
                    slots=cell.capacity(),
                    bound=sum(r.bound_count for r in live),
                    backlog=sum(len(st.pending) for r in live
                                for st in r.streams.values()),
                    waiting=sum(len(r.waiting) for r in live),
                    refused=cell.refused, rebinds=len(cell.rebinds),
                    load=round(cell.load_factor(), 4))
        total_replicas = len(replicas)
        if (gw_cells is not None or total_replicas > 64) \
                and total_replicas > top_k:
            # bounded rows: the highest-pressure replicas are the ones
            # an operator is looking for; the cell rows keep the rest
            replicas.sort(
                key=lambda r: (-(r.backlog + r.waiting), r.name))
            replicas = replicas[:top_k]
        ledger = gw.ledger
        return cls(
            replicas=replicas,
            sessions=len(gw.sessions),
            refused=gw.refused,
            rebinds=len(gw.rebinds),
            fused_dispatches=gw._fleet.dispatches if gw._fleet else 0,
            jit_cache=jit_cache_entries(),
            token_done=len(gw.token_done),
            ledger_records=int(ledger.totals["records"]),
            ledger_energy_j=ledger.totals["energy_j"],
            vehicle_energy=dict(vehicle_energy or {}),
            tiers=tiers, last_shift=last_shift, last_scale=last_scale,
            cells=cells, handoffs=len(getattr(gw, "handoffs", ())),
            total_replicas=total_replicas,
            **evt_counts)

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "sessions": self.sessions, "refused": self.refused,
            "rebinds": self.rebinds,
            "fused_dispatches": self.fused_dispatches,
            "jit_cache": self.jit_cache, "token_done": self.token_done,
            "ledger_records": self.ledger_records,
            "ledger_energy_j": self.ledger_energy_j,
            "events": {
                "emitted": self.events_emitted,
                "accepted": self.events_accepted,
                "duplicates": self.events_duplicates,
                "suppressed": self.events_suppressed,
                "spool_depth": self.events_spool_depth,
                "overflow": self.events_overflow,
            },
            "replicas": [{
                "name": r.name, "kind": r.kind, "dead": r.dead,
                "slots": r.slots, "bound": r.bound,
                "sessions": r.sessions, "waiting": r.waiting,
                "backlog": r.backlog, "ticks": r.ticks,
                "served": r.served, "busy_s": r.busy_s,
                "unit_cost_ms": r.unit_cost_ms,
                "tick_cost_ms": r.tick_cost_ms,
                "lane_binds": r.lane_binds,
                "gate_thresh": r.gate_thresh,
                "spool_depth": r.spool_depth,
                "tier": r.tier,
            } for r in self.replicas],
            "vehicle_energy": {k: list(v)
                               for k, v in self.vehicle_energy.items()},
            "tiers": self.tiers,
            "last_shift": self.last_shift,
            "last_scale": self.last_scale,
            "cells": self.cells,
            "handoffs": self.handoffs,
            "total_replicas": self.total_replicas,
        }

    def render(self) -> str:
        """The text dashboard: one row per replica + a fleet footer."""
        head = (f"{'replica':10s} {'kind':11s} {'state':6s} {'occ':>7s} "
                f"{'wait':>4s} {'backlog':>7s} {'ticks':>6s} "
                f"{'served':>7s} {'unit_ms':>8s} {'tick_ms':>8s} "
                f"{'gate_thresh (min/mean/max)':26s}")
        lines = [head, "-" * len(head)]
        if self.total_replicas > len(self.replicas):
            lines.append(f"(top {len(self.replicas)} of "
                         f"{self.total_replicas} replicas by pressure; "
                         f"cell rows aggregate the rest)")
        for r in self.replicas:
            state = "DEAD" if r.dead else "live"
            gate = ("-" if r.gate_thresh is None else
                    "/".join(f"{v:.3f}" for v in r.gate_thresh))
            kind = f"{r.kind}/{r.tier}" if r.tier else r.kind
            lines.append(
                f"{r.name:10s} {kind:11s} {state:6s} "
                f"{r.bound}/{r.slots:<2d}{100 * r.occupancy:3.0f}% "
                f"{r.waiting:4d} {r.backlog:7d} {r.ticks:6d} "
                f"{r.served:7d} {r.unit_cost_ms:8.2f} "
                f"{r.tick_cost_ms:8.2f} {gate:26s}")
        lines.append(
            f"fleet: {self.sessions} sessions  {self.refused} refused  "
            f"{self.rebinds} rebinds  {self.fused_dispatches} fused "
            f"dispatches  jit_cache={self.jit_cache}  "
            f"ledger={self.ledger_records} recs "
            f"({self.ledger_energy_j:.1f} J)"
            + (f"  token_done={self.token_done}" if self.token_done else ""))
        if self.events_emitted or self.events_spool_depth:
            lines.append(
                f"events: {self.events_emitted} emitted  "
                f"{self.events_accepted} accepted  "
                f"{self.events_duplicates} dup-rejected  "
                f"{self.events_suppressed} suppressed  "
                f"spool={self.events_spool_depth}  "
                f"overflow={self.events_overflow}")
        if self.cells:
            lines.append("cells: " + "  ".join(
                f"{name}[{agg['live']}/{agg['replicas']}r "
                f"{agg['sessions']}sess load={agg['load']:.2f} "
                f"bkl={agg['backlog']} reb={agg['rebinds']}]"
                for name, agg in sorted(self.cells.items())))
            if self.handoffs:
                lines.append(f"handoffs: {self.handoffs} cross-cell")
        if self.tiers:
            lines.append("tiers: " + "  ".join(
                f"{name}[{agg['live']}l/{agg['standby']}s "
                f"{agg['sessions']}sess bkl={agg['backlog']} "
                f"occ={agg['bound']}/{agg['slots']}]"
                for name, agg in sorted(self.tiers.items())))
        for label, act in (("last shift", self.last_shift),
                           ("last scale", self.last_scale)):
            if act is None:
                continue
            if "key" in act:
                lines.append(
                    f"{label}: t{act['tick']} {act['kind']} {act['key']} "
                    f"{act['src']}({act['tier_from']}) -> "
                    f"{act['dst']}({act['tier_to']})")
            else:
                lines.append(
                    f"{label}: t{act['tick']} {act['kind']} "
                    f"{act['replica']}({act['tier']}) "
                    f"pressure={act['pressure']}")
        if self.vehicle_energy:
            worst = sorted(self.vehicle_energy.items(),
                           key=lambda kv: kv[1][1] - kv[1][0])[:4]
            lines.append("battery (lowest headroom): " + "  ".join(
                f"{name} {100 * (1 - e / b) if b else 0:.0f}%"
                for name, (e, b) in worst))
        return "\n".join(lines)
