"""Declarative fleet-scenario DSL + the built-in scenario library.

A :class:`Scenario` is pure data: replica specs (heterogeneity enters via
``HardwareInfo``, exactly the paper's HW_INFO handshake), vehicle profiles
(frame cadence, duplicate structure, battery), churn rates, deadline/ESD
policy, and scripted events (replica failure/restore).  The runner
(:mod:`repro_torch.simulate.runner`) interprets one against the *real*
FleetGateway → VisionServeEngine → MotionGate → CapacityScheduler →
EnergyModel stack — no mocks — on per-replica virtual clocks.

Adding a scenario is one function + a ``@_scenario`` registration.
Reproduce any run from its seed (``device="cpu"`` off the card):

    PYTHONPATH=src python -c "from repro_torch.simulate import *; \
        print(run_scenario(get_scenario('golden_churn'), device='cpu').digest)"

Same seed ⇒ identical canonical trace.  The library keeps the reference
package's scenarios under their names with every number unchanged, so the
port's digests are held against the reference's
(``tests/golden/fleet_scenario_v1.json`` pins ``golden_churn``).  The
reference's ``use_pallas`` flag is :attr:`Scenario.use_kernels` here: the
engines' hand-written ingest and scatter-admit kernels.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.scheduler import HardwareInfo

# Virtual frame cost calibration: a reference replica (default
# HardwareInfo: 2 GHz x 8 cores, capacity prior 16) spends 4 ms of virtual
# time per frame of model inference; everything else scales inversely with
# the capacity prior, mirroring how the paper's measured frames/s scale
# with device strength.
REF_FRAME_COST_MS = 4.0
REF_CAPACITY_PRIOR = 16.0
TICK_OVERHEAD_MS = 0.2          # staging + gating + host bookkeeping / tick

# Token-engine calibration (the unified EngineCore's second workload
# class): virtual cost per decoded token and per prefilled prompt token on
# the reference replica — prefill is cheaper per token than decode (one
# chunked matmul amortises many positions), both scale with the HW prior
# exactly like frames.
REF_TOKEN_COST_MS = 2.0
REF_PREFILL_COST_MS = 0.4

# Per-frame energy accounting (vehicle side), matching the runtime's
# MobileNetV1/MoveNet FLOP estimates.
FLOPS_PER_FRAME = {"outer": 0.8e9, "inner": 0.5e9}


@dataclass(frozen=True)
class ReplicaSpec:
    """One engine replica; speed derives from the HW_INFO prior.

    ``tier`` / ``standby`` only take effect when the scenario declares a
    :class:`TierPlanSpec` (``Scenario.tiers``); otherwise they are
    ignored and the replica serves the scenario-wide ``input_res`` at
    float32 — so untiered scenario digests are untouched by the fields'
    existence.  A standby replica starts parked (dead to placement) and
    joins the fleet only when the autoscaler activates it.

    ``cell`` only takes effect when the scenario declares a
    :class:`CellPlanSpec` (``Scenario.cells``): replicas sharing a cell
    name form one :class:`~repro_torch.streams.cells.CellGateway` mesh under a
    region gateway.  Without a cell plan the field is ignored."""
    name: str
    slots: int = 4
    hw: HardwareInfo = field(default_factory=HardwareInfo)
    frame_cost_ms: Optional[float] = None    # explicit override
    tier: str = "base"                       # streams.tiers.TIERS key
    standby: bool = False
    cell: str = ""                           # CellPlanSpec grouping key

    def virtual_frame_cost_ms(self) -> float:
        if self.frame_cost_ms is not None:
            return self.frame_cost_ms
        prior = max(self.hw.capacity_prior(), 1e-6)
        return REF_FRAME_COST_MS * REF_CAPACITY_PRIOR / prior


@dataclass(frozen=True)
class VehicleProfile:
    """One class of vehicle: frame cadence, scene structure, battery."""
    name: str = "standard"
    device_class: str = "pixel6"        # EnergyModel table key
    frames_per_tick: int = 1
    # scene duplication: dup_pattern cycles over the frames of a tick
    # ((0, 1, 1) = a 30 fps camera over a 10 fps scene — two of every
    # three frames duplicate the previous one); with no pattern,
    # duplicate_prob draws per frame from the vehicle's rng
    dup_pattern: Tuple[int, ...] = ()
    duplicate_prob: float = 0.0
    # frame source: "noise" draws iid frames (scores far from gate
    # thresholds — maximally robust traces); "dashcam" cycles a seeded
    # data.synthetic.frame_loop clip (smoothly moving blobs — realistic
    # near-duplicate structure for the adaptive gate)
    scene: str = "noise"
    battery_j: float = float("inf")     # departure when cumulative energy
    lifetime_ticks: int = 0             # fixed session length (0 = churn)


@dataclass(frozen=True)
class TokenReplicaSpec:
    """One token-serving (``ServeEngine``) replica; speed derives from
    the HW_INFO prior exactly like a vision replica's."""
    name: str
    slots: int = 2
    cache_capacity: int = 64
    prefill_chunk: int = 8
    hw: HardwareInfo = field(default_factory=HardwareInfo)
    token_cost_ms: Optional[float] = None    # explicit override
    # KV layout: None = auto (paged wherever the arch is eligible),
    # True/False force.  Charges (and so trace digests) are layout-
    # invariant — this knob exists so scenarios can pin/compare layouts.
    paged: Optional[bool] = None

    def virtual_token_cost_ms(self) -> float:
        if self.token_cost_ms is not None:
            return self.token_cost_ms
        prior = max(self.hw.capacity_prior(), 1e-6)
        return REF_TOKEN_COST_MS * REF_CAPACITY_PRIOR / prior

    def virtual_prefill_cost_ms(self) -> float:
        return (self.virtual_token_cost_ms()
                * REF_PREFILL_COST_MS / REF_TOKEN_COST_MS)


@dataclass(frozen=True)
class TokenWorkload:
    """Declarative token-request traffic for mixed scenarios: Poisson
    arrivals of LM decode requests routed through the gateway's token
    scheduler — the inner/outer priority mix mirrors the vision classes."""
    arch: str = "starcoder2-3b"         # reduced() before instantiation
    request_rate: float = 0.3           # Poisson mean requests per tick
    prompt_len: Tuple[int, int] = (4, 12)   # uniform [lo, hi) draw
    max_new_tokens: int = 6
    outer_fraction: float = 0.25        # share submitted as priority 0
    deadline_ms: float = 0.0            # per-request deadline (ESD budget)
    max_requests: int = 64              # total submissions cap


@dataclass(frozen=True)
class EventPlaneSpec:
    """Declarative event/alert plane config: turning this on attaches a
    :class:`repro_torch.events.EventPlane` (+ idempotent DedupSink receiver) to
    the gateway and adds ``evt`` trace events + event invariants.  Off
    (``Scenario.events = None``) the plane does not exist and scenario
    digests are byte-identical to pre-event-plane builds."""
    cooldown_frames: int = 8
    spool_cap: int = 64
    evidence_frames: int = 4
    backoff_cap: int = 16


@dataclass(frozen=True)
class TierPlanSpec:
    """Declarative tier/autoscaling control plane: turning this on gives
    replicas their advertised tiers (``ReplicaSpec.tier``), parks the
    ``standby`` replicas, and attaches a
    :class:`~repro_torch.streams.tiers.TierDirector` to the gateway.  Off
    (``Scenario.tiers = None``) the director does not exist and scenario
    digests are byte-identical to pre-tier builds."""
    down_pressure: float = 1.5      # backlog/slot that triggers downshift
    up_slack: float = 0.25          # fleet-wide slack needed to upshift
    window: int = 4                 # ticks between migration evaluations
    cooldown: int = 8               # per-stream ticks between shifts
    max_burst: int = 8              # AIMD downshift burst ceiling
    scale_out_pressure: float = 2.5  # EWMA pressure to activate a standby
    scale_in_slack: float = 0.1     # EWMA slack to retire a scale-out
    scale_window: int = 6           # consecutive hot/calm ticks required
    p95_bound_ms: float = 0.0       # finalize-time p95 turnaround bound
    #                                 (0 = no bound check)


@dataclass(frozen=True)
class CellPlanSpec:
    """Declarative hierarchical control plane: turning this on groups
    replicas by ``ReplicaSpec.cell`` into
    :class:`~repro_torch.streams.cells.CellGateway` meshes under one
    :class:`~repro_torch.streams.cells.RegionGateway` — per-cell ledgers in
    aggregate sketch mode rolled up via ``Ledger.merge_from``, bounded
    region rebalance rounds, one shared event plane pumped once per
    region tick.  Off (``Scenario.cells = None``) the hierarchy does not
    exist and scenario digests are byte-identical to flat-fleet builds."""
    pump_budget: int = 2            # cells inspected per rebalance round
    rebalance_margin: float = 0.25  # load-factor gap before a handoff
    aggregate_ledgers: bool = True  # per-cell Ledger(aggregate=True)
    rel_err: float = 0.01           # sketch quantile relative error


@dataclass(frozen=True)
class ScriptedEvent:
    # action: fail_replica | restore_replica (vision OR token replica)
    #         | partition_vehicle | reconnect_vehicle (uplink, needs events)
    tick: int
    action: str
    arg: str = ""


@dataclass(frozen=True)
class Scenario:
    name: str
    seed: int
    ticks: int
    replicas: Tuple[ReplicaSpec, ...]
    profiles: Tuple[VehicleProfile, ...] = (VehicleProfile(),)
    initial_vehicles: int = 2
    join_rate: float = 0.0              # Poisson mean joins per tick
    leave_rate: float = 0.0             # per-vehicle leave probability/tick
    max_vehicles: int = 32
    deadline_ms: float = 0.0
    esd: float = 0.0
    overcommit: float = 1.5
    use_gate: bool = True
    use_kernels: bool = False           # VisionServeEngine(use_kernels)
    frame_res: int = 64
    input_res: int = 32
    fps: int = 10
    quantum: int = 32
    max_pending: int = 64
    warmup_ticks: int = 10              # recompile-free after this tick
    scripted: Tuple[ScriptedEvent, ...] = ()
    # mixed vision+token serving: token replicas join the gateway's fleet
    # (shared ledger, own capacity scheduler) and the workload drives
    # Poisson request arrivals through FleetGateway.submit_request
    token_replicas: Tuple[TokenReplicaSpec, ...] = ()
    token_workload: Optional[TokenWorkload] = None
    # event/alert plane: None leaves the plane off (digests untouched);
    # a spec attaches EventPlane+DedupSink and enables partition scripting
    events: Optional[EventPlaneSpec] = None
    # model-tier control plane: None leaves replicas untiered (digests
    # untouched); a spec activates ReplicaSpec.tier/standby and attaches
    # a TierDirector (AIMD migration + standby autoscaling)
    tiers: Optional[TierPlanSpec] = None
    # hierarchical control plane: None keeps today's flat FleetGateway
    # (digests untouched); a spec groups replicas by ReplicaSpec.cell
    # into CellGateways under a RegionGateway (streams.cells)
    cells: Optional[CellPlanSpec] = None
    description: str = ""


# ---------------------------------------------------------------------------
# Library
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {}


def _scenario(fn: Callable[[], Scenario]) -> Callable[[], Scenario]:
    s = fn()
    assert s.name not in SCENARIOS, s.name
    SCENARIOS[s.name] = s
    return fn


def get_scenario(name: str, **overrides) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}")
    s = SCENARIOS[name]
    return replace(s, **overrides) if overrides else s


def list_scenarios() -> Dict[str, str]:
    return {name: s.description for name, s in SCENARIOS.items()}


def _uniform_replicas(n: int, slots: int = 4) -> Tuple[ReplicaSpec, ...]:
    return tuple(ReplicaSpec(f"r{i}", slots=slots) for i in range(n))


@_scenario
def steady_state() -> Scenario:
    return Scenario(
        name="steady_state", seed=101, ticks=120,
        replicas=_uniform_replicas(2),
        profiles=(VehicleProfile(duplicate_prob=0.5),),
        initial_vehicles=3,
        description="Fixed fleet, no churn: continuous frames with 50% "
                    "scene duplication exercise gate + batching baselines.")


@_scenario
def dashcam_scene() -> Scenario:
    return Scenario(
        name="dashcam_scene", seed=111, ticks=200,
        replicas=_uniform_replicas(2),
        profiles=(VehicleProfile(name="dashcam", scene="dashcam"),),
        initial_vehicles=3, join_rate=0.15, leave_rate=0.02,
        max_vehicles=8,
        description="Looped synthetic dash-cam clips (data.synthetic."
                    "frame_loop): smoothly-moving scenes exercise the "
                    "adaptive gate thresholds on realistic near-"
                    "duplicates instead of iid noise.")


@_scenario
def poisson_churn() -> Scenario:
    return Scenario(
        name="poisson_churn", seed=202, ticks=400,
        replicas=_uniform_replicas(3),
        profiles=(VehicleProfile(duplicate_prob=0.3),),
        initial_vehicles=2, join_rate=0.35, leave_rate=0.04,
        max_vehicles=12,
        description="Transient fleet: Poisson joins, geometric session "
                    "lifetimes — admission/backpressure under churn.")


@_scenario
def heterogeneous_fleet() -> Scenario:
    return Scenario(
        name="heterogeneous_fleet", seed=303, ticks=300,
        replicas=(
            ReplicaSpec("weak", hw=HardwareInfo(cpu_ghz=1.0, cores=4)),
            ReplicaSpec("mid", hw=HardwareInfo(cpu_ghz=2.0, cores=8)),
            ReplicaSpec("strong", hw=HardwareInfo(cpu_ghz=3.2, cores=8)),
        ),
        profiles=(VehicleProfile(duplicate_prob=0.3),),
        initial_vehicles=4, join_rate=0.2, leave_rate=0.03,
        max_vehicles=10,
        description="Replica speed spread from HardwareInfo priors: the "
                    "capacity EWMAs diverge and placement follows strength.")


@_scenario
def battery_drain() -> Scenario:
    return Scenario(
        name="battery_drain", seed=404, ticks=250,
        replicas=_uniform_replicas(2),
        profiles=(
            VehicleProfile(name="lowbatt", device_class="pixel3",
                           battery_j=0.35, duplicate_prob=0.2),
            VehicleProfile(name="flagship", device_class="findx2pro",
                           battery_j=1.2, duplicate_prob=0.2),
        ),
        initial_vehicles=4, join_rate=0.25, max_vehicles=10,
        description="Energy-bounded sessions: cumulative EnergyModel cost "
                    "exhausts vehicle batteries and forces departures.")


@_scenario
def burst_duplicates() -> Scenario:
    return Scenario(
        name="burst_duplicates", seed=505, ticks=250,
        replicas=_uniform_replicas(2),
        profiles=(VehicleProfile(name="cam30on10", frames_per_tick=3,
                                 dup_pattern=(0, 1, 1)),),
        initial_vehicles=3, join_rate=0.1, leave_rate=0.02,
        max_vehicles=8, max_pending=96,
        description="30 fps cameras over a 10 fps scene: bursty 3x frame "
                    "duplication — the motion gate must shed ~2/3.")


@_scenario
def priority_inversion() -> Scenario:
    return Scenario(
        name="priority_inversion", seed=606, ticks=200,
        replicas=(ReplicaSpec("r0", slots=2),),
        profiles=(VehicleProfile(duplicate_prob=0.2),),
        initial_vehicles=4, join_rate=0.0, leave_rate=0.0,
        overcommit=4.0, quantum=4, use_gate=True,
        description="8 streams on 2 lanes: outer/inner inversion pressure "
                    "— hazards must preempt within the bound, inner must "
                    "still make progress through quantum rotation.")


@_scenario
def replica_failure() -> Scenario:
    return Scenario(
        name="replica_failure", seed=707, ticks=260,
        replicas=_uniform_replicas(3),
        profiles=(VehicleProfile(duplicate_prob=0.4),),
        initial_vehicles=5, join_rate=0.15, leave_rate=0.02,
        max_vehicles=10,
        scripted=(ScriptedEvent(60, "fail_replica", "r1"),
                  ScriptedEvent(140, "restore_replica", "r1")),
        description="Replica r1 dies mid-run and later recovers: sessions "
                    "rebind with gate state intact, then refill.")


@_scenario
def deadline_pressure() -> Scenario:
    return Scenario(
        name="deadline_pressure", seed=808, ticks=220,
        replicas=(
            ReplicaSpec("slow0", hw=HardwareInfo(cpu_ghz=0.25, cores=4)),
            ReplicaSpec("slow1", hw=HardwareInfo(cpu_ghz=0.25, cores=4)),
        ),
        profiles=(VehicleProfile(frames_per_tick=2, duplicate_prob=0.1),),
        initial_vehicles=4, join_rate=0.1, leave_rate=0.02,
        max_vehicles=8,
        deadline_ms=800.0, esd=2.0,
        description="Slow replicas + 2x ingest rate + ESD deadline: stale "
                    "backlogs must be trimmed into deadline drops, not "
                    "served late.")


@_scenario
def pallas_ingest() -> Scenario:
    return Scenario(
        name="pallas_ingest", seed=909, ticks=40,
        replicas=_uniform_replicas(2, slots=2),
        profiles=(VehicleProfile(duplicate_prob=0.5),),
        initial_vehicles=2, join_rate=0.1, leave_rate=0.02,
        max_vehicles=4, use_kernels=True,
        description="Short churn run through the fused ingest kernels "
                    "(their plain versions on the CPU): kernel path obeys "
                    "the same invariants and never recompiles "
                    "post-warmup.")


@_scenario
def golden_churn() -> Scenario:
    return Scenario(
        name="golden_churn", seed=1234, ticks=150,
        replicas=_uniform_replicas(2),
        profiles=(
            VehicleProfile(duplicate_prob=0.4),
            VehicleProfile(name="burst", frames_per_tick=3,
                           dup_pattern=(0, 1, 1), lifetime_ticks=40),
        ),
        initial_vehicles=3, join_rate=0.25, leave_rate=0.03,
        max_vehicles=8, deadline_ms=300.0, esd=2.0,
        description="Frozen regression scenario: churn + bursts + gate + "
                    "deadline; its trace digest is committed in "
                    "tests/golden/ and drift fails the golden test.")


@_scenario
def mixed_serving() -> Scenario:
    return Scenario(
        name="mixed_serving", seed=1717, ticks=80,
        replicas=_uniform_replicas(2),
        profiles=(VehicleProfile(duplicate_prob=0.4),),
        initial_vehicles=2, join_rate=0.1, leave_rate=0.02,
        max_vehicles=6, deadline_ms=400.0, esd=2.0,
        token_replicas=(
            TokenReplicaSpec("lm0", slots=2),
            TokenReplicaSpec("lm1", slots=2,
                             hw=HardwareInfo(cpu_ghz=1.0, cores=4)),
        ),
        # 24 ms virtual deadline at esd=2 -> ~5-token budgets on the strong
        # replica and ~1 on the weak one: the ESD truncation path is live
        token_workload=TokenWorkload(request_rate=0.35, deadline_ms=24.0,
                                     max_requests=24),
        description="Mixed vision+token serving on the unified EngineCore: "
                    "vehicle streams and LM decode requests share the "
                    "gateway, ledger, and deadline policy — token "
                    "turnaround/TTFT are seed-deterministic on virtual "
                    "clocks.")


@_scenario
def partitioned_reconnect() -> Scenario:
    return Scenario(
        name="partitioned_reconnect", seed=2626, ticks=180,
        # slow replicas + 2x ingest keep the ESD trim path hot: steady
        # deadline-miss emission guarantees unacked sends exist at the
        # partition tick, so the at-least-once rewind/replay is exercised
        # (the sink must then reject the replays — zero duplicate accepts)
        replicas=(
            ReplicaSpec("r0", hw=HardwareInfo(cpu_ghz=0.5, cores=4)),
            ReplicaSpec("r1", hw=HardwareInfo(cpu_ghz=0.5, cores=4)),
        ),
        profiles=(VehicleProfile(frames_per_tick=2, duplicate_prob=0.1,
                                 lifetime_ticks=10 ** 9),),
        initial_vehicles=4, join_rate=0.0, leave_rate=0.0,
        max_vehicles=4, deadline_ms=400.0, esd=2.0,
        events=EventPlaneSpec(cooldown_frames=4, spool_cap=48,
                              evidence_frames=4),
        scripted=(
            # two vehicles lose their uplink: spools buffer offline and
            # anything sent-but-unacked rewinds for re-delivery
            ScriptedEvent(40, "partition_vehicle", "v000"),
            ScriptedEvent(44, "partition_vehicle", "v001"),
            # a replica dies INSIDE the partition window: buffered spools
            # must travel with the stream rebinds (detach/adopt)
            ScriptedEvent(70, "fail_replica", "r1"),
            ScriptedEvent(100, "restore_replica", "r1"),
            # reconnect: drain at-least-once; the DedupSink receiver
            # absorbs the replayed unacked sends with zero duplicates
            ScriptedEvent(120, "reconnect_vehicle", "v000"),
            ScriptedEvent(124, "reconnect_vehicle", "v001"),
        ),
        description="Event-plane partition drill: vehicles buffer alerts "
                    "offline through a replica failure, then reconnect "
                    "and drain — at-least-once delivery, idempotent "
                    "receiver, zero duplicate accepts (invariant).")


@_scenario
def token_failover() -> Scenario:
    return Scenario(
        name="token_failover", seed=2828, ticks=100,
        replicas=_uniform_replicas(2),
        profiles=(VehicleProfile(duplicate_prob=0.4),),
        initial_vehicles=2, join_rate=0.1, leave_rate=0.02,
        max_vehicles=6, deadline_ms=400.0, esd=2.0,
        token_replicas=(
            TokenReplicaSpec("lm0", slots=2),
            TokenReplicaSpec("lm1", slots=2,
                             hw=HardwareInfo(cpu_ghz=1.0, cores=4)),
        ),
        token_workload=TokenWorkload(request_rate=0.4, deadline_ms=24.0,
                                     max_requests=28),
        events=EventPlaneSpec(cooldown_frames=4),
        scripted=(
            # lm0 — the strong replica carrying the traffic — dies with
            # requests in flight: they evacuate (KV blocks freed on the
            # corpse) and requeue onto lm1; new submissions must route
            # around the dead replica
            ScriptedEvent(30, "fail_replica", "lm0"),
            ScriptedEvent(65, "restore_replica", "lm0"),
        ),
        description="Token-replica failover: mid-request failure "
                    "evacuates + requeues decodes onto the survivor "
                    "(blocks conserved), restore re-derives worker state "
                    "— placement resumes on both replicas.")


@_scenario
def traffic_spike() -> Scenario:
    return Scenario(
        name="traffic_spike", seed=3131, ticks=240,
        replicas=(
            # the steady fleet: two base-tier replicas + one low-tier
            ReplicaSpec("base0", tier="base"),
            ReplicaSpec("base1", tier="base"),
            ReplicaSpec("low0", tier="low"),
            # parked capacity the autoscaler may activate under sustained
            # pressure (the frugal bf16 tier is cheapest per frame and
            # wins the energy-guided pick)
            ReplicaSpec("sb_low", tier="low", standby=True),
            ReplicaSpec("sb_frugal", tier="frugal", standby=True),
        ),
        profiles=(VehicleProfile(duplicate_prob=0.3),),
        initial_vehicles=3, join_rate=0.5, leave_rate=0.02,
        max_vehicles=14, overcommit=3.0,
        deadline_ms=600.0, esd=2.0,
        tiers=TierPlanSpec(down_pressure=1.5, up_slack=0.25,
                           window=4, cooldown=8,
                           scale_out_pressure=2.5, scale_in_slack=0.1,
                           scale_window=5, p95_bound_ms=5000.0),
        description="Traffic spike onto a tiered fleet: joins outrun the "
                    "base tier, the director AIMD-downshifts streams onto "
                    "low/frugal replicas and scales out the standbys, "
                    "holding p95 turnaround bounded (invariant-certified, "
                    "serial == parallel digests).")


@_scenario
def soak_churn() -> Scenario:
    return Scenario(
        name="soak_churn", seed=4242, ticks=2000,
        replicas=(
            ReplicaSpec("strong", hw=HardwareInfo(cpu_ghz=3.2, cores=8)),
            ReplicaSpec("mid", hw=HardwareInfo(cpu_ghz=2.0, cores=8)),
            ReplicaSpec("weak", hw=HardwareInfo(cpu_ghz=1.0, cores=4)),
        ),
        profiles=(
            VehicleProfile(duplicate_prob=0.4),
            VehicleProfile(name="burst", frames_per_tick=3,
                           dup_pattern=(0, 1, 1)),
            VehicleProfile(name="lowbatt", device_class="pixel3",
                           battery_j=0.12, duplicate_prob=0.2),
        ),
        initial_vehicles=4, join_rate=0.3, leave_rate=0.025,
        max_vehicles=12, deadline_ms=1500.0, esd=2.0,
        scripted=(ScriptedEvent(500, "fail_replica", "mid"),
                  ScriptedEvent(900, "restore_replica", "mid"),
                  ScriptedEvent(1400, "fail_replica", "weak"),
                  ScriptedEvent(1700, "restore_replica", "weak"),),
        description="The 2k-tick invariant soak: heterogeneous replicas, "
                    "Poisson churn, bursts, battery departures, two "
                    "fail/restore cycles, gating and deadlines at once.")


def city_replicas(cells: int, per_cell: int,
                  slots: int = 16) -> Tuple[ReplicaSpec, ...]:
    """Uniform hierarchical fleet: ``cells`` cells of ``per_cell``
    replicas each, named ``c<cell>r<idx>`` in cell ``cell<cell>``."""
    return tuple(ReplicaSpec(f"c{c}r{r}", slots=slots, cell=f"cell{c}")
                 for c in range(cells) for r in range(per_cell))


@_scenario
def city_scale() -> Scenario:
    return Scenario(
        name="city_scale", seed=77, ticks=20,
        # 64 virtual replicas in 8 cells, 1024 slots; overcommit 12x
        # bounds the region at 12288 streams — 5100 vehicles (10200
        # streams) load every cell to ~83% of its own bound
        replicas=city_replicas(cells=8, per_cell=8, slots=16),
        profiles=(VehicleProfile(duplicate_prob=0.9),),
        initial_vehicles=5100, join_rate=0.0, leave_rate=0.0,
        max_vehicles=6000, overcommit=12.0,
        use_gate=True, frame_res=16, input_res=8, fps=30,
        max_pending=4, warmup_ticks=2,
        # organic cross-cell handoffs: failing one replica shrinks its
        # cell's bound below occupancy, so the region's bounded
        # rebalance rounds migrate vehicles out until it recovers
        scripted=(ScriptedEvent(6, "fail_replica", "c0r0"),
                  ScriptedEvent(14, "restore_replica", "c0r0"),),
        events=EventPlaneSpec(cooldown_frames=64, spool_cap=16,
                              evidence_frames=0),
        cells=CellPlanSpec(pump_budget=2, rebalance_margin=0.1),
        description="City scale: 10k+ streams over 64 virtual replicas "
                    "in 8 cells under a region gateway — aggregate "
                    "ledger roll-up, bounded rebalance, cross-cell "
                    "handoff under replica failure.")
