"""Global invariant checkers for fleet scenario runs.

Each checker inspects the *live* stack (gateway, engines, scheduler) or
the finished run (ledger, trace, jit caches) and appends
:class:`Violation` records instead of raising — a soak wants the full
violation list, not the first failure.  The suite encodes the properties
the paper's transient-fleet claim rests on:

  conservation   every offered frame is admitted, gated, or dropped —
                 exactly once (``Ledger.check`` per stream, plus the
                 fleet-level offered == pushes cross-check);
  capacity       no engine binds more streams than it has lanes; every
                 live session is placed on a live replica and every
                 admission respected the overcommit bound at join time;
  placement      session bookkeeping is consistent: gateway sessions,
                 engine streams, and scheduler state agree;
  priority       an outer (hazard) stream with pending frames is never
                 left waiting behind a bound inner stream past the
                 preemption bound (one tick — the engine preempts at tick
                 start);
  gate travel    a rebound stream's adaptive gate threshold is identical
                 before and after the rebind (state follows the stream);
  no recompile   after the warmup tick, nothing more is built at first
                 use (``obs.probes.jit_cache_entries``: kernel
                 libraries, the vision kernels' shape tables, the
                 attention kernels' ticket buffers) — churn must not
                 build;
  kv blocks      (token replicas) every replica's BlockPool usage equals
                 the blocks its slot tables hold — a failed replica's
                 evacuated requests must return every block, and the run
                 must end with zero blocks in use;
  event idempot. (event plane) the at-least-once spool + idempotent sink
                 contract: the sink never accepts the same event id
                 twice, accepts ⊆ emits, spool depth respects its cap,
                 and after the final flush the accepted count equals
                 emitted minus overflow drops with zero residual depth;
  tier conserv.  (tiered scenarios) every live session sits on a live,
                 tier-registered replica, per-tier session counts sum to
                 the fleet total, and standby replicas hold zero
                 sessions while parked;
  tier migration an up/downshifted stream's gate threshold is identical
                 across the move and its consumed-frame ordinal never
                 decreases — migration replays nothing and loses
                 nothing;
  tier p95       (tiered scenarios with a bound) the fleet's p95 stream
                 turnaround stays under the scenario's declared
                 ``p95_bound_ms`` — the paper's bounded-latency claim
                 under spike load;
  cell placement (hierarchical scenarios) the region's O(1) vehicle→cell
                 routing map and the cells' session books agree — a
                 handoff never loses, duplicates, or mis-routes a
                 vehicle;
  cell handoff   a cross-cell handoff preserves each moved stream's gate
                 threshold bit-identically and never rewinds its
                 consumed-frame ordinal;
  cell conserv.  every cell's ledger passes its own conservation check
                 and the region roll-up (``Ledger.merge_from`` over the
                 cells) holds exactly the sum of the cell totals and
                 sketch observations.

The checks are the reference package's, unchanged; only the recompile
probe counts the port's own first-use builds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.telemetry import Ledger
from repro_torch.obs.probes import jit_cache_entries as jit_cache_sizes
from repro_torch.streams.gateway import FleetGateway
from repro_torch.streams.vision_engine import OUTER


@dataclass(frozen=True)
class Violation:
    tick: int
    invariant: str
    detail: str

    def __str__(self) -> str:
        return f"[tick {self.tick}] {self.invariant}: {self.detail}"


class InvariantSuite:
    """Online + final invariant checks for one scenario run."""

    def __init__(self, gw: FleetGateway, *, tiers=None,
                 cells=None) -> None:
        self.gw = gw
        self.tiers = tiers        # the scenario's TierPlanSpec, or None
        self.cells = cells        # the scenario's CellPlanSpec, or None
        self.violations: List[Violation] = []

    def _flag(self, tick: int, invariant: str, detail: str) -> None:
        self.violations.append(Violation(tick, invariant, detail))

    # ------------------------------------------------------------------
    # per-tick checks (cheap; called after every gateway tick)
    # ------------------------------------------------------------------
    def on_tick(self, tick: int) -> None:
        self._check_capacity(tick)
        self._check_placement(tick)
        self._check_outer_priority(tick)
        if self.gw.token_replicas:
            self._check_kv_blocks(tick)
        if self.gw.events is not None:
            self._check_events(tick)
        if self.gw.tiering is not None:
            self._check_tiers(tick)
        if self.cells is not None:
            self._check_cells(tick)

    def _check_cells(self, tick: int) -> None:
        """Hierarchical placement conservation: the region's O(1) routing
        map and the cells' session books agree — every placed vehicle
        lives in exactly the cell the region thinks it does, no cell
        holds a vehicle the region forgot, and no vehicle appears in two
        cells (a handoff that lost or duplicated a session would flag
        here the tick it happened)."""
        gw = self.gw
        seen: dict = {}
        for cell in gw.cells:
            for vehicle in cell.sessions:
                if vehicle in seen:
                    self._flag(tick, "cell-placement",
                               f"vehicle {vehicle} appears in cells "
                               f"{seen[vehicle]} and {cell.cell_name}")
                seen[vehicle] = cell.cell_name
        placed = {v: c.cell_name for v, c in gw.placements.items()}
        if placed != seen:
            extra = set(placed) - set(seen)
            missing = set(seen) - set(placed)
            moved = {v for v in set(placed) & set(seen)
                     if placed[v] != seen[v]}
            self._flag(tick, "cell-placement",
                       f"region routing disagrees with cell books: "
                       f"routed-but-unplaced={sorted(extra)[:4]} "
                       f"placed-but-unrouted={sorted(missing)[:4]} "
                       f"wrong-cell={sorted(moved)[:4]}")

    def _check_tiers(self, tick: int) -> None:
        """Tier conservation: the director's view of the fleet matches
        the gateway's — every session sits on a live, tier-registered
        replica, per-tier session counts sum to the fleet total, and a
        standby replica parked by the autoscaler holds zero sessions."""
        d = self.gw.tiering
        live = {r.name for r in self.gw.live_replicas()}
        per_tier: dict = {}
        for r in self.gw.live_replicas():
            tier = d.tiers.get(r.name)
            if tier is None:
                self._flag(tick, "tier-conservation",
                           f"live replica {r.name} is not registered "
                           f"with the tier director")
                continue
            per_tier[tier.name] = (per_tier.get(tier.name, 0)
                                   + r.session_count)
        for vehicle, pair in self.gw.sessions.items():
            for sess in pair:
                if sess.engine not in live:
                    continue          # placement check already flags it
                if sess.engine not in d.tiers:
                    self._flag(tick, "tier-conservation",
                               f"{sess.key} placed on {sess.engine} "
                               f"which has no tier")
        total = sum(r.session_count for r in self.gw.live_replicas())
        if sum(per_tier.values()) != total:
            self._flag(tick, "tier-conservation",
                       f"per-tier session counts {per_tier} sum to "
                       f"{sum(per_tier.values())} but the fleet holds "
                       f"{total}")
        for name in d.standby:
            eng = self.gw._by_name.get(name)
            if eng is not None and eng.session_count:
                self._flag(tick, "tier-conservation",
                           f"standby replica {name} holds "
                           f"{eng.session_count} sessions")

    def _check_kv_blocks(self, tick: int) -> None:
        """BlockPool conservation per token replica: the pool's used
        count must equal the blocks referenced by live slot tables.  A
        mid-request failure that evacuated without freeing would leak
        here immediately."""
        for e in self.gw.token_replicas:
            if not getattr(e, "paged", False):
                continue
            held = sum(len(b) for b in e._slot_blocks)
            used = e.block_pool.used_blocks
            if held != used:
                self._flag(tick, "kv-blocks",
                           f"{e.name}: slot tables hold {held} blocks "
                           f"but the pool counts {used} in use")
            if e.name in self.gw.dead and used:
                self._flag(tick, "kv-blocks",
                           f"dead token replica {e.name} still holds "
                           f"{used} blocks — evacuation leaked")

    def _check_events(self, tick: int) -> None:
        """Cheap per-tick event-plane checks: structural dedup at the
        sink, accepts bounded by emits, spool caps respected."""
        p = self.gw.events
        acc = p.sink.accepted_count
        if len(p.sink.order) != len(p.sink.accepted):
            self._flag(tick, "event-idempotency",
                       "sink accepted the same event id twice")
        if acc > p.emitted:
            self._flag(tick, "event-idempotency",
                       f"sink accepted {acc} events but only "
                       f"{p.emitted} were emitted")
        cap = p.cfg.spool_cap
        for em in p.emitters:
            for key, st in em.streams.items():
                if st.spool.depth > cap:
                    self._flag(tick, "event-spool",
                               f"{em.owner}:{key} spool depth "
                               f"{st.spool.depth} exceeds cap {cap}")

    def _check_capacity(self, tick: int) -> None:
        for r in self.gw.replicas:
            if r.bound_count > r.slots:
                self._flag(tick, "capacity",
                           f"{r.name} binds {r.bound_count} > {r.slots}")
            if r.name in self.gw.dead and r.session_count:
                self._flag(tick, "capacity",
                           f"dead replica {r.name} holds "
                           f"{r.session_count} sessions")

    def _check_placement(self, tick: int) -> None:
        live = {r.name for r in self.gw.live_replicas()}
        placed = 0
        for vehicle, pair in self.gw.sessions.items():
            for sess in pair:
                if sess.engine not in live:
                    self._flag(tick, "placement",
                               f"{sess.key} placed on non-live replica "
                               f"{sess.engine}")
                    continue
                eng = self.gw._by_name[sess.engine]
                if sess.key not in eng.streams:
                    self._flag(tick, "placement",
                               f"{sess.key} missing from {sess.engine}")
                placed += 1
        total = sum(r.session_count for r in self.gw.replicas)
        if placed != total:
            self._flag(tick, "placement",
                       f"gateway tracks {placed} streams, engines hold "
                       f"{total} — a session leaked or double-bound")

    def _check_outer_priority(self, tick: int) -> None:
        """Preemption bound: right after a tick, no engine may hold a
        bound inner stream while an outer stream with pending frames sits
        unbound (the engine preempts at tick start, so one tick is the
        contractual bound)."""
        for r in self.gw.live_replicas():
            inner_bound = any(s is not None and s.priority > 0
                              for s in r.lanes)
            if not inner_bound:
                continue
            for st in r.streams.values():
                if st.kind == OUTER and st.pending and not st.bound:
                    self._flag(tick, "priority",
                               f"outer {st.key} starved on {r.name} "
                               f"({len(st.pending)} pending) while an "
                               f"inner stream holds a lane")

    # ------------------------------------------------------------------
    # event-driven checks
    # ------------------------------------------------------------------
    def on_join(self, tick: int, admitted: bool, active_before: int,
                capacity: int, overcommit: float,
                fits: bool = None) -> None:
        """``fits`` overrides the flat-fleet arithmetic: a hierarchical
        region admits per cell, so region-total ``active+2 <= cap*oc``
        can hold while every individual cell is full (fragmentation) —
        the runner passes the region's own admission predicate."""
        if fits is None:
            fits = active_before + 2 <= capacity * overcommit
        if admitted and not fits:
            self._flag(tick, "capacity",
                       f"admission past overcommit: {active_before}+2 > "
                       f"{capacity}*{overcommit}")
        if not admitted and fits:
            self._flag(tick, "capacity",
                       f"spurious refusal: {active_before}+2 <= "
                       f"{capacity}*{overcommit}")

    def on_handoff(self, tick: int, rec: dict) -> None:
        """Cross-cell handoff state-travel: for every moved stream the
        adaptive gate threshold is bit-identical across the move and the
        consumed-frame ordinal never goes backwards — a handoff replays
        nothing and loses nothing, exactly like a failure rebind."""
        for st in rec["streams"]:
            tb, ta = st["thresh_before"], st["thresh_after"]
            if not (tb is None and ta is None) and tb != ta:
                self._flag(tick, "cell-handoff",
                           f"{st['key']} threshold changed across "
                           f"{rec['src_cell']}->{rec['dst_cell']}: "
                           f"{tb} -> {ta}")
            if st["ordinal_after"] < st["ordinal_before"]:
                self._flag(tick, "cell-handoff",
                           f"{st['key']} consumed ordinal went backwards "
                           f"across {rec['src_cell']}->"
                           f"{rec['dst_cell']}: {st['ordinal_before']} "
                           f"-> {st['ordinal_after']}")

    def on_rebind(self, tick: int, key: str, thresh_before,
                  thresh_after) -> None:
        if thresh_before is None and thresh_after is None:
            return
        if thresh_before != thresh_after:
            self._flag(tick, "gate-travel",
                       f"{key} threshold changed across rebind: "
                       f"{thresh_before} -> {thresh_after}")

    def on_migrate(self, tick: int, rec: dict) -> None:
        """Tier up/downshift state-travel: the stream's adaptive gate
        threshold is bit-identical across the move, and its consumed
        frame ordinal never goes backwards (migration must not replay or
        drop already-consumed frames)."""
        tb, ta = rec["thresh_before"], rec["thresh_after"]
        if not (tb is None and ta is None) and tb != ta:
            self._flag(tick, "gate-travel",
                       f"{rec['key']} threshold changed across "
                       f"{rec['kind']}: {tb} -> {ta}")
        ob, oa = rec["ordinal_before"], rec["ordinal_after"]
        if oa < ob:
            self._flag(tick, "tier-migration",
                       f"{rec['key']} consumed ordinal went backwards "
                       f"across {rec['kind']}: {ob} -> {oa}")

    # ------------------------------------------------------------------
    # final checks
    # ------------------------------------------------------------------
    def finalize(self, tick: int, ledger: Ledger, pushes: int,
                 cache_after_warmup: int) -> None:
        try:
            ledger.check()
        except AssertionError as e:
            self._flag(tick, "conservation", str(e))
        offered = int(ledger.totals["frames_total"])
        if ledger.records:
            # non-aggregate ledgers: the running total must agree with a
            # full rescan of the rows it claims to summarise
            rescan = sum(r.frames_total for r in ledger.records)
            if rescan != offered:
                self._flag(tick, "conservation",
                           f"ledger totals say {offered} frames offered "
                           f"but the records sum to {rescan}")
        if offered != pushes:
            self._flag(tick, "conservation",
                       f"ledger offered {offered} != frames pushed "
                       f"{pushes} — a push vanished unaccounted")
        self._check_metrics(tick, ledger)
        if self.cells is not None:
            self._finalize_cells(tick, ledger)
        if self.gw.token_replicas:
            for e in self.gw.token_replicas:
                if getattr(e, "paged", False) and e.block_pool.used_blocks:
                    self._flag(tick, "kv-blocks",
                               f"{e.name} ends the run with "
                               f"{e.block_pool.used_blocks} KV blocks "
                               f"still allocated")
        if self.gw.events is not None:
            self._finalize_events(tick)
        if (self.tiers is not None
                and getattr(self.tiers, "p95_bound_ms", 0.0) > 0):
            # turnaround here is the session-level elapsed time (first
            # frame to stream close), not per-frame latency — the bound
            # asserts the spike never lets sessions run away unboundedly
            p95 = ledger.sketches["turnaround_ms"].quantile(95)
            if p95 > self.tiers.p95_bound_ms:
                self._flag(tick, "tier-p95",
                           f"p95 stream turnaround {p95:.1f} ms exceeds "
                           f"the scenario bound "
                           f"{self.tiers.p95_bound_ms:.1f} ms")
        cache_now = jit_cache_sizes()
        if cache_now != cache_after_warmup:
            self._flag(tick, "recompile",
                       f"first-use builds grew after warmup: "
                       f"{cache_after_warmup} -> {cache_now}")

    def _finalize_cells(self, tick: int, ledger: Ledger) -> None:
        """Cell-level ledger conservation: every cell's own ledger passes
        its conservation check, and the region roll-up
        (``Ledger.merge_from`` over the cells) holds exactly the sum of
        the cell totals and the sum of the cell sketch observations — the
        replica->cell->region aggregation path loses and invents
        nothing."""
        cell_totals: dict = {}
        sketch_counts: dict = {}
        for cell in self.gw.cells:
            try:
                cell.ledger.check()
            except AssertionError as e:
                self._flag(tick, "cell-conservation",
                           f"cell {cell.cell_name}: {e}")
            for k, v in cell.ledger.totals.items():
                cell_totals[k] = cell_totals.get(k, 0) + v
            for m, sk in cell.ledger.sketches.items():
                sketch_counts[m] = sketch_counts.get(m, 0) + sk.count
        for k, v in cell_totals.items():
            got = ledger.totals.get(k, 0)
            if abs(got - v) > 1e-6 * max(1.0, abs(v)):
                self._flag(tick, "cell-conservation",
                           f"region total {k}={got} but cells sum to "
                           f"{v} — the roll-up lost or invented work")
        for m, want in sketch_counts.items():
            got = ledger.sketches[m].count
            if got != want:
                self._flag(tick, "cell-conservation",
                           f"region {m} sketch holds {got} observations "
                           f"but cells hold {want}")

    def _finalize_events(self, tick: int) -> None:
        """At-least-once conservation after the end-of-run flush: every
        emitted event was accepted exactly once (minus loud overflow
        drops), nothing the plane never emitted was accepted, and no
        spool still holds events."""
        p = self.gw.events
        depth = p.depth()
        if depth:
            self._flag(tick, "event-conservation",
                       f"{depth} events still spooled after final flush")
        acc = p.sink.accepted_count
        want = p.emitted - p.overflow_dropped()
        if acc != want:
            self._flag(tick, "event-conservation",
                       f"sink accepted {acc} events, expected "
                       f"{want} (= {p.emitted} emitted - "
                       f"{p.overflow_dropped()} overflow-dropped)")
        ghost = set(p.sink.accepted) - p.emitted_ids
        if ghost:
            self._flag(tick, "event-conservation",
                       f"sink accepted {len(ghost)} event id(s) the "
                       f"plane never emitted: {sorted(ghost)[:4]}")

    def _check_metrics(self, tick: int, ledger: Ledger) -> None:
        """Metrics conservation: the ledger's streaming sketches must
        account every record exactly once — counts equal the exact record
        counts and sketch sums equal the exact sums (to float tolerance).
        Guards the obs plane itself: a sketch that dropped or double-fed
        a record would report plausible-but-wrong fleet percentiles."""
        n = int(ledger.totals["records"])
        if ledger.records and len(ledger.records) != n:
            self._flag(tick, "metrics",
                       f"ledger holds {len(ledger.records)} records but "
                       f"totals counted {n}")
        sk = ledger.sketches
        for metric, want in (("turnaround_ms", n), ("skip_rate", n),
                             ("ttft_ms",
                              int(ledger.totals["ttft_records"]))):
            if sk[metric].count != want:
                self._flag(tick, "metrics",
                           f"{metric} sketch holds {sk[metric].count} "
                           f"observations, expected {want}")
        exact = (sum(r.turnaround_ms for r in ledger.records)
                 if ledger.records else ledger.totals["turnaround_ms"])
        got = sk["turnaround_ms"].sum
        if abs(got - exact) > 1e-6 * max(1.0, abs(exact)):
            self._flag(tick, "metrics",
                       f"turnaround sketch sum {got} != exact {exact}")

    # ------------------------------------------------------------------
    def report(self) -> str:
        if not self.violations:
            return "all invariants held"
        return "\n".join(str(v) for v in self.violations)
