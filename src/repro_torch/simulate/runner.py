"""Scenario runner: drives the real fleet stack on virtual clocks.

``run_scenario`` interprets a declarative :class:`~.scenario.Scenario`
against the production FleetGateway / VisionServeEngine / MotionGate /
CapacityScheduler / EnergyModel stack — no mocks, the same objects the
serving code constructs — with one :class:`~repro_torch.core.clock.
VirtualClock` per replica whose rates derive from the replica's
``HardwareInfo``.  Every run emits a canonical :class:`~.trace.Trace`
(deterministic SHA-256 digest per seed) and an invariant report.

Per virtual tick the runner:

  1. applies scripted events (replica fail/restore, with gate-threshold
     snapshots around every rebind);
  2. draws Poisson joins and geometric/fixed-lifetime leaves from the
     scenario rng;
  3. pushes each live vehicle's frames (burst patterns and scene
     duplication from the vehicle profile) and accrues EnergyModel cost
     against the vehicle battery — exhaustion forces departure;
  4. ticks the gateway (every live replica steps once on its own clock);
  5. runs the per-tick invariant checkers and emits the aggregate event.

At the end every remaining vehicle leaves (flushing its ledger records),
the conservation/recompile finalizers run, and the result carries the
trace, the ledger, and the violation list.

Where the port departs from the reference package's runner:

  * ``device``: ``build_fleet``, ``build_token_replicas``,
    ``ScenarioRunner`` and ``run_scenario`` take it; ``None`` means the
    card, ``"cpu"`` the CPU.  The vision replicas' motion gates run the
    downscale and block-SAD kernels, a ``use_kernels`` scenario's
    engines the ingest and scatter-admit kernels, and the token replicas
    the attention kernels — each wrapper takes its plain version on the
    CPU.
  * Weights are injected: ``vision_params(i) -> (detector, pose)`` for
    vision replica ``i`` and ``token_params`` for the shared reduced token
    model (e.g. the reference's, through ``repro_torch.convert``).
    Without them replica ``i`` draws from ``torch.Generator().
    manual_seed(i)`` and the token model from ``manual_seed(0)``, on the
    device (the card's generator gives other numbers than the host's).
    Only digests that read a model output depend on them: the event
    plane's hazard/distraction events do; gate decisions, deadline trims
    and virtual-clock costs do not.
  * :func:`warm_kernels` replaces the reference's ``warm_jits``.
  * ``parallel=True`` drives the fleet through the fused fleet tick
    (``streams.fleet_step``), ``fleet_mode`` ``"vmap"`` or ``"shard_map"``
    (a replica mesh of one device a replica: on one card, one replica).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import EDAConfig
from repro_torch.core.clock import FRAME, PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.core.energy import EnergyModel
from repro_torch.core.telemetry import Ledger
from repro_torch.device import resolve_device
from repro_torch.models.attention import RunOpts
from repro_torch.simulate.invariants import (InvariantSuite, Violation,
                                             jit_cache_sizes)
from repro_torch.simulate.scenario import (FLOPS_PER_FRAME, TICK_OVERHEAD_MS,
                                           Scenario, VehicleProfile)
from repro_torch.simulate.trace import Trace
from repro_torch.streams.cells import CellGateway, RegionGateway
from repro_torch.streams.filter import MotionGate
from repro_torch.streams.gateway import FleetGateway
from repro_torch.streams.tiers import (TierDirector, resolve_tier,
                                       stream_thresh)
from repro_torch.streams.vision_engine import VisionServeEngine

# the token replicas' attention runs through the hand-written kernels on
# the card (their plain versions on the CPU)
TOKEN_OPTS = RunOpts(use_kernels=True)

VisionParams = Callable[[int], Tuple[dict, dict]]


class _Vehicle:
    """Live-vehicle state: frame source, duplicate structure, battery."""

    def __init__(self, name: str, profile: VehicleProfile, seed: int,
                 index: int, res: int, joined_tick: int) -> None:
        self.name = name
        self.profile = profile
        self.rng = np.random.default_rng([seed, index])
        self.res = res
        self.joined_tick = joined_tick
        self.energy_j = 0.0
        self.frame_idx = 0
        self._last: Dict[str, np.ndarray] = {}
        self._scene_cursor = 0
        if profile.scene == "dashcam":
            from repro_torch.data.synthetic import frame_loop
            base = seed * 100_003 + 2 * index
            self._loops = {"outer": frame_loop(base, res),
                           "inner": frame_loop(base + 1, res,
                                               moving_objects=1)}
        elif profile.scene != "noise":
            raise ValueError(f"unknown scene {profile.scene!r}")

    def _fresh_pair(self) -> Dict[str, np.ndarray]:
        """Advance the scene by one frame (both cameras move together)."""
        if self.profile.scene == "dashcam":
            i = self._scene_cursor
            self._scene_cursor += 1
            return {k: loop(i) for k, loop in self._loops.items()}
        return {k: self.rng.random((self.res, self.res, 3),
                                   dtype=np.float32)
                for k in ("outer", "inner")}

    def next_frames(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """This tick's (outer, inner) frame pairs.  One duplicate draw per
        pair — the scene moves (or doesn't) for both cameras at once."""
        out = []
        p = self.profile
        for j in range(p.frames_per_tick):
            if not self._last:
                dup = False                      # first frame is always new
            elif p.dup_pattern:
                dup = bool(p.dup_pattern[self.frame_idx
                                         % len(p.dup_pattern)])
            elif p.duplicate_prob > 0:
                dup = bool(self.rng.random() < p.duplicate_prob)
            else:
                dup = False
            if not dup:
                self._last = self._fresh_pair()
            out.append((self._last["outer"], self._last["inner"]))
            self.frame_idx += 1
        return out


@dataclass
class ScenarioResult:
    scenario: Scenario
    trace: Trace
    ledger: Ledger
    violations: List[Violation]
    summary: Dict[str, object]
    # the run's observability plane, when one was attached (None
    # otherwise): a MetricsRegistry and a SpanTracer — both observe-only,
    # so `digest` is bit-identical with or without them
    metrics: Optional[object] = None
    tracer: Optional[object] = None

    @property
    def digest(self) -> str:
        return self.trace.digest()

    @property
    def ok(self) -> bool:
        return not self.violations


def _vision_engine(scenario: Scenario, name: str, slots: int, tier,
                   params: Optional[Tuple[dict, dict]], seed: int,
                   device: torch.device, **kw) -> VisionServeEngine:
    """One vision replica as the scenario declares it.  Its gates run the
    downscale and block-SAD kernels (plain on the CPU)."""
    gate = (MotionGate(slots, use_kernels=True, device=device)
            if scenario.use_gate else None)
    return VisionServeEngine(
        name, slots=slots, frame_res=scenario.frame_res,
        input_res=scenario.input_res, fps=scenario.fps,
        use_gate=scenario.use_gate, gate=gate,
        use_kernels=scenario.use_kernels, tier=tier, params=params,
        generator=(None if params is not None
                   else torch.Generator().manual_seed(seed)),
        device=device, **kw)


def _token_model(scenario: Scenario, token_params, device: torch.device):
    """The reduced token model every token replica shares (the simulator
    studies scheduling: identical weights keep traces seed-deterministic)."""
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.param import tree_to
    arch = (scenario.token_workload.arch if scenario.token_workload
            else "starcoder2-3b")
    cfg = get_arch(arch).reduced()
    if token_params is not None:
        return cfg, tree_to(token_params, device)
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                              device=device)


def warm_kernels(scenario: Scenario, device=None,
                 vision_params: Optional[VisionParams] = None,
                 token_params=None) -> None:
    """Build everything the scenario's engine geometries can reach on the
    card — the kernel libraries and the vision kernels' shape tables
    (``obs.probes.jit_cache_entries``) — on throwaway engines (separate
    ledger, virtual clock — nothing leaks into the run), before the
    scenario's warmup tick.  The recompile invariant demands zero growth
    after that tick, but a scenario is free to starve a whole model class
    for its entire scripted length (priority_inversion holds inner streams
    off the lanes for 200 ticks) — first dispatch would then land mid-soak
    and read as a build.  Real deployments warm before taking traffic for
    the same reason.

    On the CPU every wrapper takes its plain version and nothing is built,
    so there is nothing to warm: the invariant is trivially flat there and
    this returns at once."""
    device = resolve_device(device)
    if device.type != "cuda":
        return
    tiered = scenario.tiers is not None
    if tiered:
        # every distinct (slots, tier) geometry has its own shapes
        # (resolution and batch dtype) — including standby replicas, whose
        # first dispatch otherwise lands whenever the autoscaler
        # activates them mid-soak
        geoms = sorted({(spec.slots, spec.tier)
                        for spec in scenario.replicas})
    else:
        geoms = sorted({(spec.slots, None) for spec in scenario.replicas})
    params = vision_params(0) if vision_params is not None else None
    for n, tier in geoms:
        eng = _vision_engine(scenario, "warmup", n, tier, params, 0, device,
                             clock=VirtualClock())
        eng.open_stream("w/outer", "outer")
        eng.open_stream("w/inner", "inner")
        frame = np.zeros((scenario.frame_res, scenario.frame_res, 3),
                         np.float32)
        for _ in range(2):                   # 2nd tick hits the gated path
            eng.push("w/outer", frame)
            eng.push("w/inner", frame)
            eng.step()
    _warm_token_kernels(scenario, device, token_params)


def _warm_token_kernels(scenario: Scenario, device: torch.device,
                        token_params) -> None:
    """Token-engine half of :func:`warm_kernels`: one throwaway
    ``ServeEngine`` per distinct replica geometry, fed a prompt of
    ``2 * prefill_chunk - 1`` tokens — its descending power-of-two
    decomposition dispatches EVERY chunk width a later admission can —
    plus a short decode, so the attention libraries and their ticket
    buffers exist before the scenario's warmup tick."""
    if not scenario.token_replicas:
        return
    from repro_torch.serving.engine import Request, ServeEngine

    cfg, params = _token_model(scenario, token_params, device)
    geoms = {(spec.slots, spec.cache_capacity, spec.prefill_chunk,
              spec.paged) for spec in scenario.token_replicas}
    for slots, capacity, chunk, paged in sorted(
            geoms, key=lambda g: (g[0], g[1], g[2], repr(g[3]))):
        eng = ServeEngine(cfg, params, name="warmup-tok", slots=slots,
                          cache_capacity=capacity, prefill_chunk=chunk,
                          paged=paged, opts=TOKEN_OPTS, clock=VirtualClock(),
                          device=device)
        n_prompt = min(2 * chunk - 1, capacity - 1)
        for i in range(2):
            eng.submit(Request(rid=f"w{i}", tokens=np.full(
                (n_prompt,), 1, np.int32), max_new_tokens=2))
        eng.run(max_ticks=8)


def build_token_replicas(scenario: Scenario, *, device=None,
                         token_params=None) -> list:
    """Instantiate the scenario's ``ServeEngine`` replicas on virtual
    clocks priced from their HW priors — the token analogue of the
    vision replica construction below.  One reduced model per arch is
    shared across replicas (``token_params``, else drawn from seed 0)."""
    if not scenario.token_replicas:
        return []
    from repro_torch.serving.engine import ServeEngine

    device = resolve_device(device)
    engines = []
    cfg, params = _token_model(scenario, token_params, device)
    for spec in scenario.token_replicas:
        clock = VirtualClock(rates={
            TOKEN: spec.virtual_token_cost_ms() / 1000.0,
            PREFILL: spec.virtual_prefill_cost_ms() / 1000.0,
            TICK: TICK_OVERHEAD_MS / 1000.0,
        })
        engines.append(ServeEngine(
            cfg, params, name=spec.name, slots=spec.slots,
            cache_capacity=spec.cache_capacity,
            prefill_chunk=spec.prefill_chunk, paged=spec.paged,
            eda=EDAConfig(esd=scenario.esd), opts=TOKEN_OPTS, clock=clock,
            device=device))
    return engines


def build_fleet(scenario: Scenario, *, parallel: bool = False,
                fleet_mode: Optional[str] = None,
                metrics=None, tracer=None, device=None,
                vision_params: Optional[VisionParams] = None,
                token_params=None) -> FleetGateway:
    """Instantiate the real engine replicas (virtual clocks, shared
    ledger) and the gateway, exactly as a serving deployment would.
    ``parallel=True`` builds the gateway with the fused fleet tick
    (``streams.fleet_step``) — bit-identical traces on virtual clocks."""
    device = resolve_device(device)
    tiered = scenario.tiers is not None
    replicas = []
    standby_names: List[str] = []
    for i, spec in enumerate(scenario.replicas):
        tier = resolve_tier(spec.tier) if tiered else None
        # a tier's cost_scale prices its resolution/dtype against the
        # base tier on the replica's virtual clock — a `low` replica
        # burns 1/4 the virtual frame time of a `base` one
        frame_cost_ms = spec.virtual_frame_cost_ms()
        if tier is not None:
            frame_cost_ms *= tier.cost_scale
        clock = VirtualClock(rates={
            FRAME: frame_cost_ms / 1000.0,
            TICK: TICK_OVERHEAD_MS / 1000.0,
        })
        replicas.append(_vision_engine(
            scenario, spec.name, spec.slots, tier,
            vision_params(i) if vision_params is not None else None, i,
            device, eda=EDAConfig(esd=scenario.esd),
            quantum=scenario.quantum, max_pending=scenario.max_pending,
            clock=clock))
        if tiered and spec.standby:
            standby_names.append(spec.name)
    tiering = None
    if tiered:
        tp = scenario.tiers
        tiering = TierDirector(
            down_pressure=tp.down_pressure, up_slack=tp.up_slack,
            window=tp.window, cooldown=tp.cooldown,
            max_burst=tp.max_burst,
            scale_out_pressure=tp.scale_out_pressure,
            scale_in_slack=tp.scale_in_slack,
            scale_window=tp.scale_window,
            deadline_ms=scenario.deadline_ms)
    # event/alert plane: constructed only when the scenario declares one
    # — an absent plane leaves every hook dormant and the trace digest
    # byte-identical to a build without the plane
    events = None
    if scenario.events is not None:
        from repro_torch.events import DedupSink, EventConfig, EventPlane
        es = scenario.events
        events = EventPlane(
            EventConfig(cooldown_frames=es.cooldown_frames,
                        spool_cap=es.spool_cap,
                        evidence_frames=es.evidence_frames,
                        backoff_cap=es.backoff_cap),
            DedupSink(), metrics=metrics)
    if scenario.cells is not None:
        return _build_region(scenario, replicas, events=events,
                             parallel=parallel, fleet_mode=fleet_mode,
                             metrics=metrics, tracer=tracer)
    gw = FleetGateway(replicas, deadline_ms=scenario.deadline_ms,
                      overcommit=scenario.overcommit,
                      parallel=parallel, fleet_mode=fleet_mode,
                      token_replicas=build_token_replicas(
                          scenario, device=device,
                          token_params=token_params),
                      metrics=metrics, tracer=tracer, events=events,
                      tiering=tiering, standby=tuple(standby_names))
    # install the heterogeneous HW priors (the gateway defaults to a
    # cores-only prior; scenarios speak full HardwareInfo — the paper's
    # HW_INFO handshake, refined by measurement as the run progresses)
    for spec in scenario.replicas:
        gw.sched.by_name(spec.name).hw = spec.hw
    for spec in scenario.token_replicas:
        gw.token_sched.by_name(spec.name).hw = spec.hw
    return gw


def _build_region(scenario: Scenario, replicas: List[VisionServeEngine],
                  *, events, parallel: bool, fleet_mode: Optional[str],
                  metrics, tracer) -> RegionGateway:
    """Hierarchical build path (``Scenario.cells``): group the already-
    constructed engines by ``ReplicaSpec.cell`` into CellGateways — each
    with its own aggregate-mode ledger and (when tiered) its own
    cell-local TierDirector — under one RegionGateway sharing a single
    event plane.  The runtime gauges register once, against the region,
    so the probe closures span every cell."""
    if scenario.token_replicas:
        raise ValueError("Scenario.cells does not compose with "
                         "token_replicas: the region control plane "
                         "places vision sessions only")
    cp = scenario.cells
    tiered = scenario.tiers is not None
    by_cell: Dict[str, List[Tuple["ReplicaSpec", VisionServeEngine]]] = {}
    for spec, eng in zip(scenario.replicas, replicas):
        by_cell.setdefault(spec.cell or "cell0", []).append((spec, eng))
    cells = []
    for cname in sorted(by_cell):
        members = by_cell[cname]
        cell_tiering = None
        if tiered:
            tp = scenario.tiers
            cell_tiering = TierDirector(
                down_pressure=tp.down_pressure, up_slack=tp.up_slack,
                window=tp.window, cooldown=tp.cooldown,
                max_burst=tp.max_burst,
                scale_out_pressure=tp.scale_out_pressure,
                scale_in_slack=tp.scale_in_slack,
                scale_window=tp.scale_window,
                deadline_ms=scenario.deadline_ms)
        cells.append(CellGateway(
            cname, [eng for _, eng in members],
            deadline_ms=scenario.deadline_ms,
            overcommit=scenario.overcommit,
            ledger=Ledger(aggregate=cp.aggregate_ledgers,
                          rel_err=cp.rel_err),
            parallel=parallel, fleet_mode=fleet_mode,
            metrics=metrics, tracer=tracer, events=events,
            tiering=cell_tiering,
            standby=tuple(spec.name for spec, _ in members
                          if tiered and spec.standby)))
    gw = RegionGateway(cells, events=events,
                       pump_budget=cp.pump_budget,
                       rebalance_margin=cp.rebalance_margin,
                       metrics=metrics, tracer=tracer)
    for spec in scenario.replicas:
        gw.sched.by_name(spec.name).hw = spec.hw
    if metrics is not None:
        # last registration wins the probe closures: the per-cell
        # gateways each registered cell-scoped gauges above; re-register
        # against the region so exposition spans the whole hierarchy
        from repro_torch.obs.probes import register_runtime_gauges
        register_runtime_gauges(metrics, gw)
    return gw


class ScenarioRunner:
    def __init__(self, scenario: Scenario, *, parallel: bool = False,
                 fleet_mode: Optional[str] = None,
                 metrics=None, tracer=None, device=None,
                 vision_params: Optional[VisionParams] = None,
                 token_params=None) -> None:
        self.s = scenario
        self.device = resolve_device(device)
        warm_kernels(scenario, self.device, vision_params, token_params)
        self.metrics = metrics
        self.tracer = tracer
        self.gw = build_fleet(scenario, parallel=parallel,
                              fleet_mode=fleet_mode,
                              metrics=metrics, tracer=tracer,
                              device=self.device,
                              vision_params=vision_params,
                              token_params=token_params)
        self.trace = Trace()
        self.inv = InvariantSuite(self.gw, tiers=scenario.tiers,
                                  cells=scenario.cells)
        self.energy = EnergyModel()
        self.rng = np.random.default_rng(scenario.seed)
        self.vehicles: Dict[str, _Vehicle] = {}
        # vehicles whose uplink is scripted down: no frames, no churn
        # draws, and the event plane buffers their alerts until reconnect
        self._partitioned: set = set()
        self._counter = 0
        self._pushes = 0
        self._joined = 0
        self._closed = dict(off=0, adm=0, gate=0, drop=0, ddl=0)
        self._prev = self._totals()
        self._cache_after_warmup: Optional[int] = None
        # token workload state (mixed scenarios): a dedicated rng stream
        # so declaring token traffic never perturbs the vision draws
        self._token_rng = np.random.default_rng([scenario.seed, 7])
        self._token_submitted = 0
        self._token_offered = 0       # sum of submitted max_new_tokens
        self._token_harvest = 0       # cursor into gw.token_done
        frame_bytes = scenario.frame_res * scenario.frame_res * 3 * 4
        self._pair_flops = (FLOPS_PER_FRAME["outer"]
                            + FLOPS_PER_FRAME["inner"])
        self._pair_bytes = 2 * frame_bytes

    # ------------------------------------------------------------------
    def _totals(self) -> Dict[str, int]:
        """Fleet-cumulative frame accounting: closed records (folded in
        incrementally at leave time — rescanning the ledger every tick
        would be O(ticks x records)) plus the currently open streams."""
        t = dict(self._closed)
        for eng in self.gw.replicas:
            for st in eng.streams.values():
                t["off"] += st.offered
                t["adm"] += st.processed
                t["gate"] += st.gated
                t["drop"] += st.dropped
                t["ddl"] += st.deadline_dropped
        return t

    # ------------------------------------------------------------------
    def _join(self, tick: int) -> None:
        name = f"v{self._counter:03d}"
        profile = self.s.profiles[self._counter % len(self.s.profiles)]
        act, cap = self.gw.active_streams(), self.gw.capacity()
        # hierarchical fleets admit per cell: region-total arithmetic can
        # say a pair fits while every individual cell is full, so the
        # spurious-refusal check asks the region's admission predicate
        fits = (self.gw.can_admit()
                if self.s.cells is not None else None)
        pair = self.gw.join(name, now_ms=float(tick))
        self.inv.on_join(tick, pair is not None, act, cap,
                         self.s.overcommit, fits=fits)
        if pair is None:
            self.trace.emit(tick, "refuse", veh=name, act=act, cap=cap)
            return
        self._counter += 1
        self._joined += 1
        self.vehicles[name] = _Vehicle(
            name, profile, self.s.seed, self._counter, self.s.frame_res,
            joined_tick=tick)
        self.trace.emit(tick, "join", veh=name, profile=profile.name,
                        outer=pair[0].engine, inner=pair[1].engine,
                        act=act, cap=cap)

    def _leave(self, tick: int, name: str, reason: str) -> None:
        veh = self.vehicles.pop(name)
        recs = self.gw.leave(name)
        for rec in recs:                     # vehicle energy onto its recs
            rec.energy_j = veh.energy_j / len(recs)
            self._closed["off"] += rec.frames_total
            self._closed["adm"] += rec.frames_processed
            self._closed["gate"] += rec.frames_gated or 0
            self._closed["drop"] += rec.frames_dropped or 0
            self._closed["ddl"] += rec.frames_deadline_dropped or 0
        self.trace.emit(
            tick, "leave", veh=name, reason=reason,
            off=sum(r.frames_total for r in recs),
            adm=sum(r.frames_processed for r in recs),
            gate=sum(r.frames_gated or 0 for r in recs),
            drop=sum(r.frames_dropped or 0 for r in recs),
            ddl=sum(r.frames_deadline_dropped or 0 for r in recs),
            energy=veh.energy_j)

    def _scripted(self, tick: int) -> None:
        for ev in self.s.scripted:
            if ev.tick != tick:
                continue
            if ev.action == "fail_replica":
                if ev.arg in self.gw._token_by_name:
                    # token replica: in-flight requests evacuate (KV
                    # blocks freed) and requeue onto the survivors
                    moved = self.gw.fail_replica(ev.arg,
                                                 now_ms=float(tick))
                    self.trace.emit(tick, "fail", replica=ev.arg,
                                    moved=len(moved))
                    for rid, src, dst in moved:
                        self.trace.emit(tick, "req_rebind", rid=rid,
                                        src=src, dst=dst)
                    continue
                eng = self.gw._by_name[ev.arg]
                before = {k: stream_thresh(eng, k)
                          for k in list(eng.streams)}
                moved = self.gw.fail_replica(ev.arg, now_ms=float(tick))
                self.trace.emit(tick, "fail", replica=ev.arg,
                                moved=len(moved))
                for key, src, dst in moved:
                    after = stream_thresh(self.gw._by_name[dst], key)
                    self.inv.on_rebind(tick, key, before[key], after)
                    self.trace.emit(
                        tick, "rebind", key=key, src=src, dst=dst,
                        thresh=-1.0 if after is None else after)
            elif ev.action == "restore_replica":
                self.gw.restore_replica(ev.arg, now_ms=float(tick))
                self.trace.emit(tick, "restore", replica=ev.arg)
            elif ev.action == "partition_vehicle":
                if self.gw.events is None:
                    raise ValueError(
                        "partition_vehicle needs Scenario.events")
                rewound = self.gw.events.partition(ev.arg)
                self._partitioned.add(ev.arg)
                self.trace.emit(tick, "partition", veh=ev.arg,
                                rewound=rewound)
            elif ev.action == "reconnect_vehicle":
                self.gw.events.reconnect(ev.arg)
                self._partitioned.discard(ev.arg)
                self.trace.emit(tick, "reconnect", veh=ev.arg)
            else:
                raise ValueError(f"unknown scripted action {ev.action!r}")

    def _push_all(self, tick: int) -> None:
        for name in list(self.vehicles):
            if name in self._partitioned:
                continue              # uplink down: frames never arrive
            veh = self.vehicles[name]
            flops = bytes_moved = 0.0
            for outer, inner in veh.next_frames():
                self.gw.push(name, outer, inner)
                self._pushes += 2
                flops += self._pair_flops
                bytes_moved += self._pair_bytes
            veh.energy_j += self.energy.segment_energy_j(
                veh.profile.device_class, flops, bytes_moved,
                active_s=1.0 / self.s.fps)

    def _churn(self, tick: int) -> None:
        for name in list(self.vehicles):
            if name in self._partitioned:
                continue    # an offline vehicle cannot signal departure
            veh = self.vehicles[name]
            life = veh.profile.lifetime_ticks
            if life and tick - veh.joined_tick >= life:
                self._leave(tick, name, "lifetime")
            elif self.s.leave_rate and self.rng.random() < self.s.leave_rate:
                self._leave(tick, name, "churn")

    def _battery(self, tick: int) -> None:
        for name in list(self.vehicles):
            veh = self.vehicles[name]
            if veh.energy_j >= veh.profile.battery_j:
                self._leave(tick, name, "battery")

    def _trace_handoffs(self, tick: int) -> None:
        """Drain the region's cross-cell handoff log: every record runs
        through the gate-travel/ordinal invariant and lands in the trace
        (one ``handoff`` event per moved stream)."""
        for rec in self.gw.drain_handoffs():
            self.inv.on_handoff(tick, rec)
            for st in rec["streams"]:
                self.trace.emit(
                    tick, "handoff", veh=rec["vehicle"],
                    key=st["key"], src_cell=rec["src_cell"],
                    dst_cell=rec["dst_cell"], src=st["src"],
                    dst=st["dst"],
                    thresh=(-1.0 if st["thresh_after"] is None
                            else st["thresh_after"]),
                    ordinal=st["ordinal_after"],
                    spool=st["spool_depth"])

    # ------------------------------------------------------------------
    # token workload (mixed vision+token scenarios)
    # ------------------------------------------------------------------
    def _submit_requests(self, tick: int) -> None:
        from repro_torch.serving.engine import Request
        tw = self.s.token_workload
        vocab = self.gw.token_replicas[0].cfg.vocab_size
        n = int(self._token_rng.poisson(tw.request_rate))
        for _ in range(n):
            if self._token_submitted >= tw.max_requests:
                return
            rid = f"q{self._token_submitted:03d}"
            plen = int(self._token_rng.integers(*tw.prompt_len))
            prio = int(self._token_rng.random() >= tw.outer_fraction)
            req = Request(
                rid=rid,
                tokens=self._token_rng.integers(0, vocab, plen),
                max_new_tokens=tw.max_new_tokens, priority=prio,
                deadline_ms=tw.deadline_ms)
            engine = self.gw.submit_request(req, now_ms=float(tick))
            self._token_submitted += 1
            self._token_offered += tw.max_new_tokens
            self.trace.emit(tick, "req", rid=rid, prio=prio, plen=plen,
                            eng=engine)

    def _harvest_requests(self, tick: int) -> None:
        fresh = self.gw.token_done[self._token_harvest:]
        self._token_harvest = len(self.gw.token_done)
        for req in fresh:
            self.trace.emit(
                tick, "req_done", rid=req.rid, toks=len(req.generated),
                turn=req.turnaround_ms, ttft=req.ttft_ms,
                trunc=req.truncated)

    # ------------------------------------------------------------------
    def run(self, on_tick=None) -> ScenarioResult:
        """Drive the scenario to completion.  ``on_tick(tick, runner)``,
        when given, is called after every gateway tick — the dashboard
        CLI's live-refresh hook; it must only *read* the stack (a
        mutating callback would fork the trace from the golden digest)."""
        s = self.s
        for _ in range(s.initial_vehicles):
            self._join(0)
        for tick in range(s.ticks):
            self._scripted(tick)
            if s.join_rate and len(self.vehicles) < s.max_vehicles:
                for _ in range(int(self.rng.poisson(s.join_rate))):
                    if len(self.vehicles) >= s.max_vehicles:
                        break
                    self._join(tick)
            if tick:                          # initial cohort joins at 0
                self._churn(tick)
            self._push_all(tick)
            self._battery(tick)
            if s.token_workload and self.gw.token_replicas:
                self._submit_requests(tick)
            self.gw.tick()
            self.inv.on_tick(tick)
            cur = self._totals()
            delta = {k: cur[k] - self._prev[k] for k in cur}
            self._prev = cur
            self.trace.emit(
                tick, "tick", **delta,
                bound=sum(r.bound_count for r in self.gw.live_replicas()),
                wait=sum(len(r.waiting)
                         for r in self.gw.live_replicas()),
                live=len(self.vehicles))
            if self.gw.tiering is not None:
                # emitted only for tiered scenarios, so every pre-tier
                # scenario digest is untouched
                for act in self.gw.tiering.drain_actions():
                    if act["kind"] in ("downshift", "upshift"):
                        self.inv.on_migrate(tick, act)
                        self.trace.emit(
                            tick, "shift", op=act["kind"],
                            key=act["key"], src=act["src"],
                            dst=act["dst"], tier_from=act["tier_from"],
                            tier_to=act["tier_to"])
                    else:                     # scale_out / scale_in
                        self.trace.emit(
                            tick, "scale", op=act["kind"],
                            replica=act["replica"], tier=act["tier"],
                            pressure=round(act["pressure"], 4))
                        for key, src, dst, tb, ta in act.get("moved", ()):
                            self.inv.on_rebind(tick, key, tb, ta)
                            self.trace.emit(
                                tick, "rebind", key=key, src=src, dst=dst,
                                thresh=-1.0 if ta is None else ta)
            if self.s.cells is not None:
                # emitted only for hierarchical scenarios, so flat-fleet
                # trace digests are untouched by the region extension
                self._trace_handoffs(tick)
            if self.gw.token_replicas:
                # emitted only for mixed scenarios, so vision-only trace
                # digests are untouched by the token extension
                self._harvest_requests(tick)
                self.trace.emit(tick, "tok", sub=self._token_submitted,
                                done=len(self.gw.token_done),
                                backlog=self.gw.token_backlog())
            if self.gw.events is not None:
                # emitted only when the scenario declares a plane, so
                # every pre-existing scenario digest is untouched
                p = self.gw.events
                self.trace.emit(
                    tick, "evt", emitted=p.emitted,
                    acc=p.sink.accepted_count, dup=p.sink.duplicates,
                    sup=p.suppressed, depth=p.depth(),
                    ovf=p.overflow_dropped())
            if tick == s.warmup_ticks:
                self._cache_after_warmup = jit_cache_sizes()
            if on_tick is not None:
                on_tick(tick, self)
        # drain + close every survivor so the ledger holds the whole run
        self.gw.drain(max_ticks=4 * s.ticks + 64)
        if s.cells is not None:      # drain ticks can still rebalance
            self._trace_handoffs(s.ticks)
        if self.gw.token_replicas:
            self._harvest_requests(s.ticks)
        if self.gw.events is not None:
            # end of run: every still-partitioned vehicle reconnects and
            # the plane drains to empty — the finalize invariants then
            # check full at-least-once conservation (zero residual depth,
            # zero duplicate accepts)
            for name in sorted(self._partitioned):
                self.gw.events.reconnect(name)
                self.trace.emit(s.ticks, "reconnect", veh=name)
            self._partitioned.clear()
            self.gw.events.flush()
        for name in list(self.vehicles):
            self._leave(s.ticks, name, "end")
        for spec in s.replicas:
            w = self.gw.sched.by_name(spec.name)
            eng = self.gw._by_name[spec.name]
            self.trace.emit(s.ticks, "replica", name=spec.name,
                            ticks=eng.ticks,
                            processed=eng.frames_processed,
                            busy_ms=eng.busy_s * 1000.0,
                            capacity=w.capacity())
        if self._cache_after_warmup is None:
            self._cache_after_warmup = jit_cache_sizes()
        # ledger conservation covers both workload classes: every pushed
        # frame AND every submitted request's token allotment must land in
        # a record's frames_total exactly once
        self.inv.finalize(s.ticks, self.gw.ledger,
                          self._pushes + self._token_offered,
                          self._cache_after_warmup)
        totals = self._totals()
        summary = {
            "scenario": s.name, "seed": s.seed, "ticks": s.ticks,
            "joined": self._joined, "refused": self.gw.refused,
            "rebinds": len(self.gw.rebinds),
            "battery_departures": len(
                [e for e in self.trace.of_kind("leave")
                 if e.get("reason") == "battery"]),
            **totals,
            "violations": len(self.inv.violations),
        }
        if self.gw.token_replicas:
            done = self.gw.token_done
            summary.update(
                tok_submitted=self._token_submitted,
                tok_done=len(done),
                tok_generated=sum(len(r.generated) for r in done),
                tok_truncated=sum(r.truncated for r in done))
        if self.gw.events is not None:
            p = self.gw.events
            summary.update(
                evt_emitted=p.emitted, evt_suppressed=p.suppressed,
                evt_accepted=p.sink.accepted_count,
                evt_duplicates=p.sink.duplicates,
                evt_overflow=p.overflow_dropped(),
                evt_spool_depth=p.depth())
        return ScenarioResult(scenario=s, trace=self.trace,
                              ledger=self.gw.ledger,
                              violations=self.inv.violations,
                              summary=summary,
                              metrics=self.metrics, tracer=self.tracer)


def run_scenario(scenario: Scenario, *, parallel: bool = False,
                 fleet_mode: Optional[str] = None,
                 metrics=None, tracer=None, device=None,
                 vision_params: Optional[VisionParams] = None,
                 token_params=None) -> ScenarioResult:
    """Run a scenario on ``device`` (the card unless ``"cpu"``), with
    injected weights if given (see the module docstring).
    ``metrics``/``tracer`` attach an observability plane for the run —
    observe-only, so the trace digest is identical with or without them.
    ``parallel=True`` drives the fleet through the fused fleet tick
    instead of serial per-replica stepping (``tests/test_torch_fleet_step.
    py`` pins the two to bit-identical trace digests)."""
    return ScenarioRunner(scenario, parallel=parallel, fleet_mode=fleet_mode,
                          metrics=metrics, tracer=tracer, device=device,
                          vision_params=vision_params,
                          token_params=token_params).run()
