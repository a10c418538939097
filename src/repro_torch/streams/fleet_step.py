"""The fused fleet tick: every replica's device work in one call a tick.

The serial ``FleetGateway.tick`` steps replicas one after another, so each
tick pays (replicas x classes) separate gate and model launches, a host
read of the gate scores and of the flags for each, and the card only ever
sees one replica's small batch at a time — adding replicas adds wall
clock instead of dividing it, the opposite of the paper's parallel-devices
scaling story (§3.2.5).  ``FleetStep`` lays the replicas' engine state
side by side along a leading replica axis —

    batch pools   (R, slots, res, res, 3)   per model class
    stage frames  (R, slots, H, W, 3)       host buffers, one upload
    gate refs     (R, slots, g, g, 3)       + thresh/has_ref (R, slots)
    lane masks    (R, slots) bool           liveness is masked, not reshaped
    model params  laid out once for grouped convolutions (R*O, ...)

— and runs ingest, gate score, admit threshold and model forward for all
replicas in one call with one computation per **tier group**:

  * replicas are grouped by model geometry — ``(dc, pc, input_res, batch
    dtype)``, i.e. by :class:`~repro_torch.streams.tiers.TierSpec` in a
    tiered fleet, in order of first appearance.  A uniform fleet is one
    group; a mixed-tier fleet one group per tier, all in the same call;
  * inside a group the replicas' rows are flattened to R_g x slots rows,
    so each kernel launches once a group and class with R_g x slots
    streams instead of once per replica: the kernels treat rows
    independently (one gate block a stream, per-stream model-row blocks,
    column tables keyed on (W, C, m, g)), so a row's arithmetic does not
    depend on how many rows share the launch;
  * the group's forward is one grouped convolution a layer over the
    stacked weights (``models.vision.analyse_outer_stacked``), in
    channels-last memory — the convolutions are cuDNN's, as in the serial
    engine.  It is not bitwise the per-replica forward, so its flags are
    held equal to the per-replica forwards' by tests, on the CPU and the
    card.

Modes (the reference's two):

  * ``"vmap"``: that flattened, stacked layout on one device;
  * ``"shard_map"``: the reference's single-controller replica mesh,
    ``sharding.compat.make_mesh((R,), ("replica",))``: a list of R
    devices (the visible cards, or the CPU repeated in place of the
    reference's forced host devices), not a process group.  Replica i's
    rows live on mesh device i (its engine must be built there), and each
    replica runs the single-replica program: its own group of one, the
    serial engine's forward on its own weights, so its results are bit for
    bit the serial tick's.  It needs one tier group (a mesh maps one
    program) and as many devices as replicas; too small a pool raises
    with the number the mesh needs.

Without a mode, ``resolve_mode`` picks ``"shard_map"`` only when R > 1
and the engines are on cards with at least R of them, as the reference
picks it only on an accelerator mesh with enough devices; on one card it
picks ``"vmap"``.

Inside the call the kernels are the serial path's: ``vision_ops.
ingest_frame`` / ``scatter_admit`` on the kernel path, the gate's own
arithmetic (``streams.filter.gate_scores``) on the plain path, each taking
its plain version on the CPU.  Each engine stages frames into its row of
its group's host buffer (``VisionServeEngine.enable_host_staging``), the
rows of the replicas that staged a frame are uploaded once a tick, a class
with no active lane in a group is skipped (it would admit nothing), and
one (4, R, slots) bool tensor of admit masks and flags comes back to the
host once a tick.

Host/device split: everything the serial path does on the host stays on
the host, per replica, in the same order — lane rebalancing, deadline
trims, backlog pops (``begin_tick``/``stage_class``), the gate's AIMD
controller and stats (``MotionGate.commit_decision``), counter/EWMA/ledger
bookkeeping (``commit_class``/``end_tick``).  Only the per-pixel work and
the admit threshold (a float32 compare against the host-owned per-lane
thresholds, sent as float32 data) move into the fused call.  Churn —
join/leave/fail/rebind/tier migration — therefore works exactly as in
serial mode; a dead (or standby) replica's rows ride along with an
all-False lane mask and its host phases are skipped, so shapes never
change and nothing is built mid-run.

Under virtual clocks (``repro_torch.simulate``) the fused tick is
bit-identical to the serial tick: same admit decisions, same ledger
records, same trace digests (``tests/test_torch_fleet_step.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.clock import VirtualClock
from repro_torch.kernels import vision_ops
from repro_torch.models import vision as V
from repro_torch.sharding.compat import make_mesh
from repro_torch.streams.filter import gate_scores
from repro_torch.streams.vision_engine import INNER, OUTER, VisionServeEngine

MODES = ("shard_map", "vmap")
KINDS = (OUTER, INNER)


def resolve_mode(n_replicas: int, mode: Optional[str] = None,
                 device_type: str = "cuda") -> str:
    """``shard_map`` on cards when there are at least ``n_replicas`` > 1 of
    them, ``vmap`` otherwise; an explicit mode is taken as asked.  Any
    other string raises ``ValueError``."""
    if mode is not None:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        return mode
    if (n_replicas > 1 and device_type == "cuda"
            and torch.cuda.is_available()
            and torch.cuda.device_count() >= n_replicas):
        return "shard_map"
    return "vmap"


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` are one card when card 0 is current."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device
    return (a.index if a.index is not None else cur()) == (
        b.index if b.index is not None else cur())


class FleetStep:
    """One fused call a fleet tick over the replicas' engine state."""

    def __init__(self, replicas: Sequence[VisionServeEngine], *,
                 mode: Optional[str] = None) -> None:
        if not replicas:
            raise ValueError("need at least one engine replica")
        self.replicas: List[VisionServeEngine] = list(replicas)
        ref = self.replicas[0]
        self.mode = resolve_mode(len(self.replicas), mode,
                                 ref.device.type)
        # the replica mesh: one device per replica (a list, not a process
        # group); too small a pool raises with the count the mesh needs
        self.mesh = (make_mesh((len(self.replicas),), ("replica",),
                               device_type=ref.device.type)
                     if self.mode == "shard_map" else None)
        for i, r in enumerate(self.replicas):
            # fleet-wide uniform: slot width, source frame geometry, the
            # kernel path and the device (in shard_map mode, each replica
            # on its mesh device).  Model geometry (dc/pc/input_res/batch
            # dtype) may differ per replica — those split into tier groups
            # below.
            if self.mesh is not None and not _same_device(r.device,
                                                          self.mesh[i]):
                raise ValueError(
                    f"shard_map puts replica {i} ({r.name}) on "
                    f"{self.mesh[i]}; its engine is on {r.device}")
            uniform = ("slots", "frame_res", "use_kernels") + (
                ("device",) if self.mesh is None else ())
            for attr in uniform:
                if getattr(r, attr) != getattr(ref, attr):
                    raise ValueError(
                        f"fleet-parallel tick needs uniform engine geometry: "
                        f"{r.name}.{attr}={getattr(r, attr)} != "
                        f"{ref.name}.{attr}={getattr(ref, attr)}")
            if (r.gates[OUTER] is None) != (ref.gates[OUTER] is None):
                raise ValueError("fleet-parallel tick needs a uniform "
                                 "use_gate setting across replicas")
        self.slots = ref.slots
        self.frame_res = ref.frame_res
        self.device = ref.device
        self.use_kernels = ref.use_kernels
        self.use_gate = ref.gates[OUTER] is not None
        if self.use_gate:
            g0 = ref.gates[OUTER]
            for r in self.replicas:
                for kind in KINDS:
                    g = r.gates[kind]
                    if (g.gate_res, g.block, g.use_kernels) != (
                            g0.gate_res, g0.block, g0.use_kernels):
                        raise ValueError(
                            "fleet-parallel tick needs uniform gate "
                            "geometry (gate_res, block, use_kernels) "
                            "across replicas")
            self.gate_res, self.block = g0.gate_res, g0.block
            self.gate_kernels = g0.use_kernels
        else:
            self.gate_res, self.block, self.gate_kernels = 1, 8, False
        # tier groups, by first appearance: a uniform fleet is one group
        # in replica order
        self._group_keys: List[tuple] = []
        self._members: List[List[int]] = []
        for i, r in enumerate(self.replicas):
            sig = (r.dc, r.pc, r.input_res, str(r.batches[OUTER].dtype))
            if sig in self._group_keys:
                self._members[self._group_keys.index(sig)].append(i)
            else:
                self._group_keys.append(sig)
                self._members.append([i])
        if self.mesh is not None and len(self._group_keys) > 1 \
                and mode is None:
            self.mode, self.mesh = "vmap", None   # auto-resolved: fall back
        if self.mesh is not None:
            if len(self._group_keys) > 1:
                raise ValueError(
                    "shard_map maps one program over the replica mesh and "
                    "cannot mix tier geometries; mixed-tier fleets run "
                    "mode='vmap'")
            # each replica its own group of one, on its own device
            self._group_keys = self._group_keys * len(self.replicas)
            self._members = [[i] for i in range(len(self.replicas))]
        self._devs = [self.replicas[mem[0]].device for mem in self._members]
        order = np.concatenate([np.asarray(m) for m in self._members])
        # the gather that restores replica order in the mask output
        self._inv = (None if (order == np.arange(len(order))).all()
                     else torch.as_tensor(np.argsort(order),
                                          device=self.device))
        pin = self.device.type == "cuda"
        S, H = self.slots, self.frame_res
        # one host staging buffer per group, pinned on the card; each
        # engine's buffer is a view of its row (both classes share it:
        # their lanes are disjoint), so the frames are written once.  Its
        # device copy persists: a tick uploads the rows of the replicas
        # that staged a frame, and the other rows' stale frames are masked
        # off like any inactive lane's
        self._stage_groups: List[torch.Tensor] = []
        self._stage_dev: List[torch.Tensor] = []
        # per group, per class: threshold, has-ref and active, float32 —
        # one upload a tick; the threshold keeps its float32 value
        self._ctl: List[torch.Tensor] = []
        for mem, dev in zip(self._members, self._devs):
            buf = torch.zeros((len(mem), S, H, H, 3), dtype=torch.float32,
                              pin_memory=pin)
            self._stage_groups.append(buf)
            self._stage_dev.append(torch.zeros(buf.shape, dtype=buf.dtype,
                                               device=dev))
            self._ctl.append(torch.zeros((len(KINDS), 3, len(mem) * S),
                                         dtype=torch.float32,
                                         pin_memory=pin))
            for j, i in enumerate(mem):
                r = self.replicas[i]
                r.enable_host_staging()
                r._stage_t = buf[j]
                r._stage = r._stage_t.numpy()
                r._upload_done = None
        # engines never retrain: stack the group's weights once
        self._dp = [V.stack_params([self.replicas[i].dp for i in mem])
                    for mem in self._members]
        self._pp = [V.stack_params([self.replicas[i].pp for i in mem])
                    for mem in self._members]
        # gateless scatters still take (fixed-shape) reference operands
        self._null_refs = [torch.zeros((len(mem) * S, 1, 1, 3),
                                       dtype=torch.float32, device=dev)
                           for mem, dev in zip(self._members, self._devs)]
        # the last call's stacked outputs and the row views handed to the
        # engines, per (group, state name): reused as the next call's
        # input only while every engine still holds exactly those views
        self._stacks: Dict[Tuple[int, str],
                           Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]] = {}
        self.dispatches = 0            # fused calls issued
        self._warm()

    # ------------------------------------------------------------------
    # the fused call
    # ------------------------------------------------------------------
    def _stacked(self, g: int, name: str,
                 rows: List[torch.Tensor]) -> torch.Tensor:
        """The group's (R_g, ...) stack of the engines' current state.
        The engines read and replace ``batches`` and ``gates[kind].refs``
        between ticks (a rebind's restore writes a lane in place), so this
        reads them every call; it skips the copy only while they are still
        the row views of the last call's output, whose storage any in-place
        write went to."""
        last = self._stacks.get((g, name))
        if last is not None and all(a is b for a, b in zip(last[1], rows)):
            return last[0]
        return torch.stack(rows)

    def _one_class(self, g: int, kind: str, staged: torch.Tensor,
                   ctl: torch.Tensor):
        """One class of one group on its R_g x slots flattened rows.
        Returns (admit (R_g*slots,) bool, new batch (R_g, ...), new refs
        (R_g, ...) or None)."""
        mem = self._members[g]
        engines = [self.replicas[i] for i in mem]
        batch = self._stacked(g, f"batch_{kind}",
                              [r.batches[kind] for r in engines])
        R_g, pool = batch.shape[0], batch.dtype
        batch = batch.reshape(R_g * self.slots, *batch.shape[2:])
        thr, href, act = ctl[0], ctl[1] > 0, ctl[2] > 0
        refs = None
        if self.use_gate:
            refs = self._stacked(g, f"refs_{kind}",
                                 [r.gates[kind].refs for r in engines])
            refs = refs.reshape(R_g * self.slots, *refs.shape[2:])
        if self.use_kernels:
            res = engines[0].input_res
            if self.use_gate:
                model, small, scores = vision_ops.ingest_frame(
                    staged, refs, model_res=res, gate_res=self.gate_res,
                    block=self.block)
                admit = act & ((scores > thr) | ~href)
                batch, refs = vision_ops.scatter_admit(
                    batch, model, refs, small, admit)
            else:
                model = vision_ops.downscale(staged, res)
                admit = act
                batch, _ = vision_ops.scatter_admit(
                    batch, model, self._null_refs[g], self._null_refs[g],
                    admit)
        else:
            # the host-staging engine's masked select, then the gate's own
            # arithmetic (MotionGate.admit) on all the group's rows
            batch = torch.where(act[:, None, None, None], staged.to(pool),
                                batch)
            admit = act
            if self.use_gate:
                small, scores = gate_scores(
                    refs, batch, gate_res=self.gate_res, block=self.block,
                    use_kernels=self.gate_kernels)
                admit = act & ((scores > thr) | ~href)
                refs = torch.where(admit[:, None, None, None], small, refs)
        batch = batch.reshape(R_g, self.slots, *batch.shape[1:])
        if refs is not None:
            refs = refs.reshape(R_g, self.slots, *refs.shape[1:])
        return admit, batch, refs

    def _forward(self, g: int, kind: str, batch: torch.Tensor
                 ) -> torch.Tensor:
        """The group's model for ``kind`` on (R_g, slots, ...) batches;
        (R_g*slots,) per-lane flags."""
        dc, pc = self._group_keys[g][:2]
        if self.mesh is not None:
            # the single-replica program: the serial engine's forward
            r = self.replicas[self._members[g][0]]
            if kind == OUTER:
                flags, _ = V.analyse_outer(dc, r.dp, batch[0])
                return flags.any(dim=1).reshape(-1)
            distracted, _ = V.analyse_inner(pc, r.pp, batch[0])
            return distracted.reshape(-1)
        if kind == OUTER:
            flags, _ = V.analyse_outer_stacked(dc, self._dp[g], batch)
            return flags.any(dim=2).reshape(-1)
        distracted, _ = V.analyse_inner_stacked(pc, self._pp[g], batch)
        return distracted.reshape(-1)

    def _dispatch(self, act: Dict[str, np.ndarray]):
        """The fused call: upload each group's staged rows and control
        rows once, run each class of each group that has an active lane
        (a class with none would admit nothing and change no state), read
        the (4, R, slots) masks (admit outer, admit inner, flags outer,
        flags inner) back once.  Returns (host masks, {(group, state
        name): (R_g, ...) new state})."""
        per_group, out = [], {}
        for g, mem in enumerate(self._members):
            dev = self._devs[g]
            ctl = self._ctl[g].numpy()
            for k, kind in enumerate(KINDS):
                ctl[k, 2] = act[kind][mem].reshape(-1)
                if self.use_gate:
                    gates = [self.replicas[i].gates[kind] for i in mem]
                    ctl[k, 0] = np.concatenate([gt.thresh for gt in gates])
                    ctl[k, 1] = np.concatenate([gt.has_ref for gt in gates])
            staged = self._stage_dev[g]
            for j, i in enumerate(mem):
                if act[OUTER][i].any() or act[INNER][i].any():
                    staged[j].copy_(self._stage_groups[g][j],
                                    non_blocking=True)
            ctl_dev = self._ctl[g].to(dev, non_blocking=True, copy=True)
            if dev.type == "cuda":
                # the next tick's staging writes wait for these uploads
                done = torch.cuda.Event()
                done.record()
                for i in mem:
                    self.replicas[i]._upload_done = done
            staged = staged.reshape(-1, *staged.shape[2:])
            rows = []
            for k, kind in enumerate(KINDS):
                if not act[kind][mem].any():
                    rows.append(None)
                    continue
                admit, batch, refs = self._one_class(g, kind, staged,
                                                     ctl_dev[k])
                out[(g, f"batch_{kind}")] = batch
                if refs is not None:
                    out[(g, f"refs_{kind}")] = refs
                rows.append((admit, self._forward(g, kind, batch)))
            none = torch.zeros(len(mem) * self.slots, dtype=torch.bool,
                               device=dev)
            per_group.append(torch.stack(
                [r[0] if r else none for r in rows]
                + [r[1] if r else none for r in rows]
            ).reshape(4, len(mem), self.slots))
        if self.mesh is not None:
            # one read a replica device, in replica order
            return (np.concatenate([m.cpu().numpy() for m in per_group],
                                   axis=1), out)
        masks = torch.cat(per_group, dim=1)
        if self._inv is not None:
            masks = masks[:, self._inv]
        return masks.cpu().numpy(), out

    def _warm(self) -> None:
        """Run the fused call once at construction — the exact shapes and
        dtypes of every later tick, every class of every group — so the
        kernels' shape tables and cuDNN's plans exist before the first
        tick and no churn mid-run observes a first use.  Its one active
        lane a group and class admits into a throwaway state: nothing is
        committed, so the engines' state is untouched."""
        R = len(self.replicas)
        act = {kind: np.zeros((R, self.slots), bool) for kind in KINDS}
        for mem in self._members:
            for kind in KINDS:
                act[kind][mem[0], 0] = True
        self._dispatch(act)

    # ------------------------------------------------------------------
    # host orchestration
    # ------------------------------------------------------------------
    def tick(self, gw) -> int:
        """One fleet tick with serial semantics: the serial path's host
        phases per live replica around one fused call.  ``gw`` is the
        owning ``FleetGateway`` (scheduler feedback, dead-replica set,
        tracer, token replicas)."""
        R = len(self.replicas)
        live = [r for r in self.replicas if r.name not in gw.dead]
        t0s = {r.name: r.begin_tick() for r in live}
        act = {kind: np.zeros((R, self.slots), bool) for kind in KINDS}
        for i, r in enumerate(self.replicas):
            if r.name in gw.dead:
                continue
            for kind in KINDS:
                act[kind][i] = r.stage_class(kind)

        per_done = {r.name: 0 for r in live}
        wall_share_s = {r.name: 0.0 for r in live}
        if act[OUTER].any() or act[INNER].any():
            wall0 = time.perf_counter()
            masks, out = self._dispatch(act)
            wall = time.perf_counter() - wall0
            self.dispatches += 1
            tr = getattr(gw, "tracer", None)
            if tr is not None and tr.enabled:
                # one fleet-lane span per fused call: anchored at the lead
                # replica's tick start, duration = measured host wall
                tr.complete("fused_dispatch", "fleet", t0s[live[0].name],
                            wall, dispatch=self.dispatches,
                            n_active=int(act[OUTER].sum()
                                         + act[INNER].sum()))
            admit = {OUTER: masks[0], INNER: masks[1]}
            flags = {OUTER: masks[2], INNER: masks[3]}
            self._commit_state(act, out)
            total = int(admit[OUTER].sum() + admit[INNER].sum())
            for i, r in enumerate(self.replicas):
                if r.name in gw.dead:
                    continue
                on_wall = not isinstance(r.clock, VirtualClock)
                for kind in KINDS:
                    m_row = admit[kind][i]
                    dt = (wall * int(m_row.sum()) / total
                          if on_wall and total else None)
                    if dt is not None:
                        wall_share_s[r.name] += dt
                    per_done[r.name] += r.commit_class(
                        kind, act[kind][i], m_row, flags[kind][i],
                        dt_share_s=dt)

        done = 0
        for r in live:
            n = per_done[r.name]
            r.end_tick(t0s[r.name], n)
            if n:
                if isinstance(r.clock, VirtualClock):
                    # same reads/charges as the serial path: bit-identical
                    dt_ms = (r.clock.now_s() - t0s[r.name]) * 1000.0
                else:
                    # wall clocks: the time since t0 spans the WHOLE
                    # fleet's host and device work — feed the capacity
                    # EWMA this replica's share of the fused call instead,
                    # matching serial observe semantics
                    dt_ms = wall_share_s[r.name] * 1000.0
                gw.sched.by_name(r.name).observe(n, dt_ms)
            done += n
        if gw.token_replicas:
            # mixed fleets: the fused call covers the vision replicas; the
            # token replicas step after it with the serial tick's host
            # phases, in its order, so mixed scenarios stay bit-identical
            done += gw._tick_tokens()
        return done

    def _commit_state(self, act: Dict[str, np.ndarray], out: dict) -> None:
        """Hand each live replica its rows of the new state (views of the
        group's output), only where its class had active lanes — where the
        serial path would have run that class at all."""
        for (g, name), stack in out.items():
            kind = name.split("_", 1)[1]
            views = stack.unbind(0)
            self._stacks[(g, name)] = (stack, views)
            for j, i in enumerate(self._members[g]):
                if not act[kind][i].any():
                    continue
                r = self.replicas[i]
                if name.startswith("batch"):
                    r.batches[kind] = views[j]
                else:
                    r.gates[kind].refs = views[j]
