"""Model tiers + the backlog-driven migration/autoscaling director.

The EDA paper's defining constraint is a fleet of heterogeneous,
resource-constrained devices that must keep turnaround near real time
"with a tolerable loss in accuracy".  This module supplies the fleet-side
mechanism for that trade:

  * :class:`TierSpec` — one model tier: input resolution x batch dtype x
    architecture label.  A replica advertises exactly one tier
    (``VisionServeEngine(tier=...)``); the tier fixes the replica's model
    configs (``configs.eda_vision`` at the tier resolution) and batch-pool
    dtype, and prices its virtual frame cost (``cost_scale``) so a
    low-tier replica really does clear backlog faster than a high-tier
    one.  The built-in zoo (:data:`TIERS`) spans high/base/low/frugal.
  * :class:`TierDirector` — the control loop the gateway runs at the top
    of every tick:

      migration   AIMD up/downshift of individual streams between tiers,
                  the same controller idiom as ``MotionGate._adapt`` and
                  ``DynamicESD``: sustained backlog/deadline pressure
                  triggers a *multiplicative* downshift burst (the burst
                  doubles while consecutive pressured windows persist,
                  resets on calm) and a calm fleet earns an *additive*
                  upshift of one stream per window.  Migration reuses the
                  gateway's detach/adopt state travel
                  (:meth:`FleetGateway.migrate_stream`), so gate
                  thresholds, frame ordinals, and event-spool state
                  survive every shift — certified by the simulator's
                  ``gate-travel`` / ``tier-migration`` invariants.
      autoscale   sustained fleet-mean pressure (an EWMA over the
                  replicas' :meth:`EngineCore.pressure` signals) past
                  ``scale_out_pressure`` activates a parked standby
                  replica; sustained slack retires the most recently
                  activated one (its sessions rebind onto survivors).
                  Standby choice is roofline- and energy-guided:
                  feasibility = the tier's estimated per-frame service
                  time against the replica's ``HardwareInfo`` capacity
                  prior vs the fleet deadline, then minimum per-frame
                  energy (``core.energy.EnergyModel`` with the TPU-v5e
                  profile).

Everything here is host-side and deterministic: replica iteration is in
construction order, streams sort by key, and time is the replicas' shared
virtual tick — so tiered scenario traces stay seed-reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.early_stop import EWMA
from repro_torch.core.energy import TPU_V5E, EnergyModel

# Reference calibration shared with ``core.runtime`` / ``simulate.scenario``:
# MobileNetV1 detector + MoveNet pose at the base tier's 32 px input.
BASE_RES = 32
REF_PAIR_FLOPS = 0.8e9 + 0.5e9          # outer + inner, per frame pair
# bf16 batches halve bandwidth and run the matrix units at double rate;
# the end-to-end frame speedup is smaller (host staging stays f32) — 0.6
# is the roofline-weighted estimate the virtual cost model uses.  This,
# like the TPU-v5e energy profile below, prices *virtual* time and energy
# only: the scenarios' standby picks and digests depend on them, so they
# stay the reference's numbers.
BF16_COST_FACTOR = 0.6


@dataclass(frozen=True)
class TierSpec:
    """One model tier: resolution x dtype x architecture.

    ``rank`` orders tiers by accuracy/cost (higher = heavier); the
    director only ever downshifts to a strictly lower rank and upshifts
    toward a stream's recorded home rank.
    """
    name: str
    input_res: int
    dtype: str = "float32"              # batch-pool dtype
    arch: str = "mnv1+movenet"          # descriptive label (config zoo)
    rank: int = 0

    @property
    def dtype_bytes(self) -> int:
        return 2 if self.dtype == "bfloat16" else 4

    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def cost_scale(self) -> float:
        """Relative per-frame cost vs the base tier (conv cost scales
        with pixel count; bf16 gets the roofline factor)."""
        scale = (self.input_res / BASE_RES) ** 2
        if self.dtype == "bfloat16":
            scale *= BF16_COST_FACTOR
        return scale

    def flops_per_frame(self) -> float:
        return REF_PAIR_FLOPS * (self.input_res / BASE_RES) ** 2

    def frame_bytes(self) -> int:
        return self.input_res * self.input_res * 3 * self.dtype_bytes


# The tier zoo: resolutions from the existing config generators
# (``detector_config``/``pose_config`` accept any input_res), dtypes the
# batch pools support.  "frugal" is the scale-out tier of last resort.
TIERS: Dict[str, TierSpec] = {
    "high": TierSpec("high", input_res=48, dtype="float32",
                     arch="mnv1+movenet/48", rank=3),
    "base": TierSpec("base", input_res=32, dtype="float32",
                     arch="mnv1+movenet/32", rank=2),
    "low": TierSpec("low", input_res=16, dtype="float32",
                    arch="mnv1+movenet/16", rank=1),
    "frugal": TierSpec("frugal", input_res=16, dtype="bfloat16",
                       arch="mnv1+movenet/16-bf16", rank=0),
}


def resolve_tier(tier: Union[str, TierSpec]) -> TierSpec:
    if isinstance(tier, TierSpec):
        return tier
    if tier not in TIERS:
        raise KeyError(f"unknown tier {tier!r}; known: {sorted(TIERS)}")
    return TIERS[tier]


def stream_thresh(eng, key: str) -> Optional[float]:
    """A stream's current adaptive gate threshold, wherever it lives:
    the bound lane's controller, the saved travel snapshot, or the gate's
    init value (never bound yet).  None = gateless engine."""
    st = eng.streams[key]
    gate = eng.gates[st.kind]
    if gate is None:
        return None
    if st.bound:
        return float(gate.thresh[st.lane])
    if st.gate_state is not None:
        return float(st.gate_state["thresh"])
    # canonicalise through f32: the lane arrays hold float32, so a stream
    # read before its first bind must report the same value it will show
    # the moment a lane adopts it (gate-travel compares the two exactly)
    return float(np.float32(gate.init_thresh))


def service_ms(tier: TierSpec, hw) -> float:
    """Roofline-style per-frame service estimate on a replica: the HW
    capacity prior is frames/s at the base tier, so a tier's service
    time scales with its compute cost."""
    frames_per_s = max(hw.capacity_prior(), 1e-6) / tier.cost_scale
    return 1000.0 / frames_per_s


_TIER_ENERGY = EnergyModel(table={TPU_V5E.name: TPU_V5E})


def frame_energy_j(tier: TierSpec, model: Optional[EnergyModel] = None
                   ) -> float:
    """Estimated replica-side energy per frame at this tier (compute +
    batch-row movement, TPU-v5e profile) — the autoscaler's tie-break."""
    m = model if model is not None else _TIER_ENERGY
    return m.segment_energy_j(TPU_V5E.name, tier.flops_per_frame(),
                              tier.frame_bytes(), 0.0)


class TierDirector:
    """AIMD tier migration + standby autoscaling for one gateway.

    Pure host-side control state; :meth:`step` runs at the top of every
    ``FleetGateway.tick`` (before any engine work) and reads host state
    only.  Every decision is
    appended to :attr:`actions` for the runner to drain into trace
    events and invariant checks.
    """

    def __init__(self, *, down_pressure: float = 1.5,
                 up_slack: float = 0.25, window: int = 4,
                 cooldown: int = 8, max_burst: int = 8,
                 scale_out_pressure: float = 2.5,
                 scale_in_slack: float = 0.1, scale_window: int = 6,
                 deadline_ms: float = 0.0,
                 pressure_alpha: float = 0.3) -> None:
        self.down_pressure = down_pressure
        self.up_slack = up_slack
        self.window = window
        self.cooldown = cooldown
        self.max_burst = max_burst
        self.scale_out_pressure = scale_out_pressure
        self.scale_in_slack = scale_in_slack
        self.scale_window = scale_window
        self.deadline_ms = deadline_ms
        # replica name -> advertised tier (the gateway registers these)
        self.tiers: Dict[str, TierSpec] = {}
        # parked replicas the autoscaler may activate
        self.standby: List[str] = []
        # decision log, drained by the runner each tick
        self.actions: List[dict] = []
        self.last_shift: Optional[dict] = None
        self.last_scale: Optional[dict] = None
        self._scaled_out: List[str] = []     # activation stack (LIFO retire)
        self._home_rank: Dict[str, int] = {}  # stream key -> pre-shift rank
        self._cool: Dict[str, int] = {}       # stream key -> cooldown tick
        self._burst = 1                       # multiplicative downshift width
        self._since = 0
        self._tick = 0
        self._hot = 0
        self._calm = 0
        self._pressure = EWMA(alpha=pressure_alpha)

    # ------------------------------------------------------------------
    def register(self, name: str, tier: Union[str, TierSpec]) -> None:
        self.tiers[name] = resolve_tier(tier)

    def add_standby(self, name: str) -> None:
        if name not in self.tiers:
            raise KeyError(f"standby {name!r} has no registered tier")
        self.standby.append(name)

    def drain_actions(self) -> List[dict]:
        acts, self.actions = self.actions, []
        return acts

    def fleet_pressure(self) -> float:
        """The autoscaler's smoothed fleet-mean backlog-per-slot."""
        return self._pressure.get(0.0)

    # ------------------------------------------------------------------
    def step(self, gw) -> None:
        """One control round: autoscale check every tick, migration
        evaluation once per ``window`` ticks."""
        self._tick += 1
        # all replicas share one virtual tick; any live clock names "now"
        now_ms = gw.replicas[0].clock.now_s() * 1000.0
        live = [r for r in gw.replicas if r.name not in gw.dead]
        press = {r.name: r.pressure() for r in live}
        self._autoscale(gw, live, press, now_ms)
        self._since += 1
        if self._since < self.window:
            return
        self._since = 0
        # a scale event above may have changed the live set
        live = [r for r in gw.replicas if r.name not in gw.dead]
        press = {r.name: r.pressure() for r in live}
        hot = [r for r in live
               if press[r.name].backlog_per_slot > self.down_pressure
               or press[r.name].deadline_ewma > 0.5]
        if hot:
            budget = self._burst
            for r in sorted(hot, key=lambda r: (
                    -press[r.name].backlog_per_slot, r.name)):
                if budget <= 0:
                    break
                budget -= self._downshift(gw, live, r, budget, now_ms)
            if budget < self._burst:
                # multiplicative increase while pressure persists
                self._burst = min(self._burst * 2, self.max_burst)
            return
        self._burst = 1
        if all(p.backlog_per_slot < self.up_slack
               and p.deadline_ewma < 0.05 for p in press.values()):
            self._upshift(gw, live, now_ms)

    # ------------------------------------------------------------------
    # migration (AIMD)
    # ------------------------------------------------------------------
    def _downshift(self, gw, live, replica, budget: int,
                   now_ms: float) -> int:
        """Move up to ``budget`` streams off a pressured replica onto
        lower-rank tiers.  Returns the number moved."""
        cur = self.tiers[replica.name]
        targets = [r for r in live
                   if self.tiers[r.name].rank < cur.rank]
        if not targets:
            return 0
        free = {r.name: r.slots - r.session_count for r in targets}
        streams = [s for pair in gw.sessions.values() for s in pair
                   if s.engine == replica.name]
        # shed the distraction class first — accuracy loss is tolerable
        # there; hazards downshift only when inner streams run out
        streams.sort(key=lambda s: (s.stream == "outer", s.key))
        moved = 0
        for sess in streams:
            if moved >= budget:
                break
            if self._cool.get(sess.key, -1) >= self._tick:
                continue
            # gentlest shift: the highest rank strictly below the current
            # tier that still has a free lane
            cands = sorted(
                (r for r in targets if free[r.name] > 0),
                key=lambda r: (-self.tiers[r.name].rank,
                               -free[r.name], r.name))
            if not cands:
                break
            dst = cands[0]
            rec = gw.migrate_stream(sess, dst.name, now_ms)
            free[dst.name] -= 1
            self._home_rank.setdefault(sess.key, cur.rank)
            self._cool[sess.key] = self._tick + self.cooldown
            rec.update(kind="downshift", tick=self._tick,
                       tier_from=cur.name,
                       tier_to=self.tiers[dst.name].name)
            self.actions.append(rec)
            self.last_shift = rec
            moved += 1
        return moved

    def _upshift(self, gw, live, now_ms: float) -> None:
        """Additive recovery: one previously-downshifted stream per calm
        window climbs one rank back toward its home tier."""
        by_name = {r.name: r for r in live}
        for key in sorted(self._home_rank):
            if self._cool.get(key, -1) >= self._tick:
                continue
            sess = next((s for pair in gw.sessions.values() for s in pair
                         if s.key == key), None)
            if sess is None or sess.engine not in by_name:
                self._home_rank.pop(key, None)   # stream left the fleet
                self._cool.pop(key, None)
                continue
            cur = self.tiers[sess.engine]
            home = self._home_rank[key]
            if cur.rank >= home:
                self._home_rank.pop(key, None)   # already back home
                continue
            cands = sorted(
                (r for r in live
                 if cur.rank < self.tiers[r.name].rank <= home
                 and r.session_count < r.slots and r.name != sess.engine),
                key=lambda r: (self.tiers[r.name].rank, r.name))
            if not cands:
                return
            dst = cands[0]
            rec = gw.migrate_stream(sess, dst.name, now_ms)
            if self.tiers[dst.name].rank >= home:
                self._home_rank.pop(key, None)
            self._cool[key] = self._tick + self.cooldown
            rec.update(kind="upshift", tick=self._tick,
                       tier_from=cur.name,
                       tier_to=self.tiers[dst.name].name)
            self.actions.append(rec)
            self.last_shift = rec
            return                               # additive: one per window

    # ------------------------------------------------------------------
    # autoscaling
    # ------------------------------------------------------------------
    def _autoscale(self, gw, live, press, now_ms: float) -> None:
        if not press:
            return
        mean = (sum(p.backlog_per_slot for p in press.values())
                / len(press))
        p = self._pressure.update(mean)
        if p > self.scale_out_pressure:
            self._hot += 1
            self._calm = 0
        elif p < self.scale_in_slack:
            self._calm += 1
            self._hot = 0
        else:
            self._hot = self._calm = 0
        if self._hot >= self.scale_window and self.standby:
            name = self._pick_standby(gw)
            gw.restore_replica(name, now_ms)
            self.standby.remove(name)
            self._scaled_out.append(name)
            rec = dict(kind="scale_out", tick=self._tick, replica=name,
                       tier=self.tiers[name].name, pressure=round(p, 4))
            self.actions.append(rec)
            self.last_scale = rec
            self._hot = 0
        elif (self._calm >= self.scale_window and self._scaled_out
              and len(live) > 1):
            name = self._scaled_out.pop()
            # capture gate thresholds before retirement: the rebinds the
            # failure path performs must conserve them (invariant)
            eng = gw._by_name[name]
            before = {k: stream_thresh(eng, k) for k in list(eng.streams)}
            moved = gw.fail_replica(name, now_ms=now_ms)
            self.standby.append(name)
            detail = [(key, src, dst, before[key],
                       stream_thresh(gw._by_name[dst], key))
                      for key, src, dst in moved]
            rec = dict(kind="scale_in", tick=self._tick, replica=name,
                       tier=self.tiers[name].name, pressure=round(p, 4),
                       moved=detail)
            self.actions.append(rec)
            self.last_scale = rec
            self._calm = 0

    def _pick_standby(self, gw) -> str:
        """Roofline/energy-guided standby choice: prefer tiers whose
        estimated per-frame service time meets the fleet deadline, then
        minimum per-frame energy, then raw speed."""
        best_key, best_name = None, None
        for name in sorted(self.standby):
            tier = self.tiers[name]
            hw = gw.sched.by_name(name).hw
            svc = service_ms(tier, hw)
            feasible = self.deadline_ms <= 0 or svc <= self.deadline_ms
            key = (not feasible, frame_energy_j(tier), svc, name)
            if best_key is None or key < best_key:
                best_key, best_name = key, name
        return best_name
