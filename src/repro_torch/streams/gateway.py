"""Fleet front door: per-vehicle session lifecycle over engine replicas.

A vehicle joining the fleet opens an (outer, inner) stream pair — exactly
the paper's paired-download protocol, scaled out.  The gateway:

  * **places** the pair with the existing ``CapacityScheduler``: each
    ``VisionServeEngine`` replica is a worker whose capacity EWMA is fed
    from its measured frames/s, so the same decision tree that sharded
    dash-cam segments onto heterogeneous phones now shards vehicle sessions
    onto heterogeneous replicas (outer to the strongest, §3.2.5);
  * **bounds admission** (backpressure): when every replica's lanes are
    oversubscribed past ``overcommit``, joins are refused rather than
    letting queues grow without bound — the caller retries after churn;
  * **tracks churn**: ``leave`` closes both streams, flushes their
    ``SegmentRecord`` into the shared ledger, and credits the scheduler's
    capacity estimate with the session's measured throughput;
  * **serves token workloads** (``token_replicas``): because the token
    engine (``serving.ServeEngine``) rides the same ``EngineCore``
    substrate, :meth:`submit_request` places a decode request on a token
    replica with a second ``CapacityScheduler`` (capacity EWMA fed from
    measured tokens/s), :meth:`tick` steps token replicas alongside the
    vision fleet, and finished requests flush into the same shared
    ledger — one scheduling substrate, heterogeneous analytics classes;
  * **trades accuracy for latency** (``tiering``): replicas may advertise
    a model tier (``streams.tiers``); a :class:`~repro_torch.streams.tiers.
    TierDirector` then runs at the top of every tick, migrating streams
    across tiers under backlog/deadline pressure (:meth:`migrate_stream`
    — the detach/adopt state travel of :meth:`fail_replica`, so gate
    thresholds, ordinals, and event spools survive) and activating /
    retiring ``standby`` replicas from sustained fleet pressure.

``parallel=True`` runs each tick through the fused fleet tick
(``streams.fleet_step``): every live replica's device work in one call,
with the serial tick's host phases around it — bit-identical to stepping
the replicas one by one under virtual clocks.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.scheduler import (Assignment, CapacityScheduler,
                                        HardwareInfo, WorkerState)
from repro_torch.core.segmentation import Segment
from repro_torch.core.telemetry import Ledger, SegmentRecord
from repro_torch.streams.vision_engine import INNER, OUTER, VisionServeEngine

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.events.plane import EventPlane
    from repro_torch.serving.engine import Request, ServeEngine


@dataclass
class StreamSession:
    """One directional stream of one vehicle, placed on one replica."""
    vehicle: str
    stream: str                       # outer | inner
    engine: str                       # replica name
    assignment: Assignment
    joined_ms: float = 0.0
    pushed: int = 0
    shed: int = 0                     # frames dropped by backpressure
    # counters at the last rebind: leave() credits the current replica's
    # capacity EWMA only with work done *since adoption* — throughput
    # measured on a failed origin replica must not skew the adopter's
    credit_frames: int = 0
    credit_ms: float = 0.0

    @property
    def key(self) -> str:
        return f"{self.vehicle}/{self.stream}"


class _FleetScheduler(CapacityScheduler):
    """CapacityScheduler with commit-between-picks pair placement.

    The base N-worker branch calls ``_pick_worker`` twice with no state
    change in between, so both picks of a pair always return the same
    device — fine for the paper's short video jobs, wrong for long-lived
    fleet sessions (the pair would never split and a 3+-replica fleet
    leaves replicas idle).  A provisional queue bump between the picks
    restores the strongest-takes-outer / next-takes-inner pairing.

    The everyone-busy branch also considers the master replica: the paper
    excludes the master there because it coordinates the phones, but an
    engine replica named "master" is just the first replica — concentrating
    all overcommitted sessions on the others would skew their latency.

    ``down`` holds failed replicas (paper: a phone leaving the network
    mid-segment).  While any replica is down every pick runs over the live
    pool only; with an empty ``down`` the paper's decision tree is used
    unchanged."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.down: Set[str] = set()

    def _pick_worker(self, now_ms):
        if self.down:
            alive = [w for w in self.devices if w.name not in self.down]
            if not alive:
                raise RuntimeError("every replica is down")
            free = [w for w in alive if w.free_at(now_ms)]
            return max(free or alive,
                       key=lambda w: (w.capacity(), -w.queue_len))
        anyone_free = (self.master.free_at(now_ms)
                       or any(w.free_at(now_ms) for w in self.workers))
        if not anyone_free:
            return max(self.devices,
                       key=lambda w: (w.capacity(), -w.queue_len))
        return super()._pick_worker(now_ms)

    def schedule_pair(self, outer, inner, now_ms, **kw):
        if not self.down and (len(self.workers) <= 1
                              or kw.get("segmentation")):
            return super().schedule_pair(outer, inner, now_ms, **kw)
        first = self._pick_worker(now_ms)
        first.queue_len += 1                    # provisional, for pick 2
        try:
            second = self._pick_worker(now_ms)
        finally:
            first.queue_len -= 1
        return [Assignment(outer, first.name),
                Assignment(inner, second.name)]


class FleetGateway:
    """Join/leave churn + placement + backpressure for vehicle fleets."""

    def __init__(self, replicas: Sequence[VisionServeEngine], *,
                 deadline_ms: float = 0.0, overcommit: float = 1.5,
                 ledger: Optional[Ledger] = None, parallel: bool = False,
                 fleet_mode: Optional[str] = None,
                 token_replicas: Sequence["ServeEngine"] = (),
                 metrics=None, tracer=None,
                 events: Optional["EventPlane"] = None,
                 tiering=None, standby: Sequence[str] = ()) -> None:
        if not replicas:
            raise ValueError("need at least one engine replica")
        if deadline_ms > 0 and not any(r.policy.enabled for r in replicas):
            # deadline trimming is the engines' ESD policy; a deadline with
            # esd<=1 everywhere would silently never drop a frame
            warnings.warn(
                "FleetGateway deadline_ms is set but no replica has an "
                "EarlyStopPolicy enabled (EDAConfig esd > 1): stale frames "
                "will never be dropped", stacklevel=2)
        self.replicas = list(replicas)
        self.deadline_ms = deadline_ms
        self.overcommit = overcommit
        self.ledger = ledger if ledger is not None else Ledger()
        # fleet-wide observability plane: every replica shares one
        # registry/tracer, exactly like the shared ledger above
        self.metrics = metrics
        self.tracer = tracer
        for r in self.replicas:
            r.ledger = self.ledger            # one fleet-wide ledger
            r.attach_obs(metrics=metrics, tracer=tracer)

        # replica heterogeneity enters through the HW prior; measurement
        # (frames/s per tick) refines it exactly like the phone handshake
        states = [WorkerState(name=r.name,
                              hw=HardwareInfo(cores=r.slots),
                              is_master=(i == 0))
                  for i, r in enumerate(self.replicas)]
        self.sched = _FleetScheduler(states[0], states[1:],
                                     outer_priority=True)
        self._by_name: Dict[str, VisionServeEngine] = {
            r.name: r for r in self.replicas}
        self.sessions: Dict[str, Tuple[StreamSession, StreamSession]] = {}
        self.dead: Set[str] = set()           # failed replicas (by name)
        self.refused = 0
        self.rebinds: List[Tuple[str, str, str]] = []  # (key, from, to)
        self.closed: List[SegmentRecord] = []

        # model-tier control plane (``streams.tiers``): the director runs
        # at the top of every tick; ``standby`` replicas start parked —
        # dead to placement, rows riding the fused tick with all-False
        # masks — until sustained pressure scales them out
        self.tiering = tiering
        if tiering is not None:
            for r in self.replicas:
                if r.tier is None:
                    raise ValueError(
                        f"tiering enabled but replica {r.name!r} "
                        f"advertises no tier (VisionServeEngine(tier=...))")
                tiering.register(r.name, r.tier)
        for sb in standby:
            if sb not in self._by_name:
                raise KeyError(f"standby replica {sb!r} is not in the fleet")
            self.dead.add(sb)
            self.sched.down.add(sb)
            w = self.sched.by_name(sb)
            w.busy_until_ms = float("inf")
            w.queue_len = 10 ** 9
            if tiering is not None:
                tiering.add_standby(sb)
        # parallel=True fuses every live replica's device work into one
        # call per tick (streams.fleet_step); host-side churn, placement
        # and bookkeeping above are identical in both modes
        self.parallel = bool(parallel)
        self._fleet = None
        if self.parallel:
            from repro_torch.streams.fleet_step import FleetStep
            self._fleet = FleetStep(self.replicas, mode=fleet_mode)

        # token-serving replicas (ServeEngine) share the fleet ledger and
        # get their own capacity scheduler — token throughput (tokens/s)
        # and frame throughput (frames/s) are different units, so their
        # EWMAs must not mix in one worker pool
        self.token_replicas: List["ServeEngine"] = list(token_replicas)
        self._token_by_name: Dict[str, "ServeEngine"] = {}
        self.token_sched: Optional[_FleetScheduler] = None
        self.token_done: List["Request"] = []
        self._token_assign: Dict[str, Assignment] = {}
        self._token_harvested: Dict[str, int] = {}
        if self.token_replicas:
            names = ([r.name for r in self.replicas]
                     + [e.name for e in self.token_replicas])
            if len(set(names)) != len(names):
                raise ValueError(f"replica names must be unique across "
                                 f"vision and token fleets: {names}")
            for e in self.token_replicas:
                e.ledger = self.ledger        # one fleet-wide ledger
                e.attach_obs(metrics=metrics, tracer=tracer)
                self._token_by_name[e.name] = e
                self._token_harvested[e.name] = 0
            tstates = [WorkerState(name=e.name,
                                   hw=HardwareInfo(cores=e.slots),
                                   is_master=(i == 0))
                       for i, e in enumerate(self.token_replicas)]
            self.token_sched = _FleetScheduler(tstates[0], tstates[1:],
                                               outer_priority=True)
        # requests orphaned by a token-replica failure with no survivors
        # to adopt them: rejected loudly, parked here for the caller
        self.token_stranded: List["Request"] = []

        # event/alert plane (``repro_torch.events``): every replica — vision
        # AND token — gets an emitter; the gateway pumps delivery once
        # per tick
        self.events = events
        if events is not None:
            for r in self.replicas:
                r.emitter = events.new_emitter(r.name)
            for e in self.token_replicas:
                e.emitter = events.new_emitter(e.name)

        if metrics is not None:
            from repro_torch.obs.probes import register_runtime_gauges
            register_runtime_gauges(metrics, self)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def live_replicas(self) -> List[VisionServeEngine]:
        return [r for r in self.replicas if r.name not in self.dead]

    def capacity(self) -> int:
        return sum(r.slots for r in self.live_replicas())

    def active_streams(self) -> int:
        return sum(r.session_count for r in self.live_replicas())

    def join(self, vehicle: str, now_ms: float = 0.0,
             deadline_ms: Optional[float] = None
             ) -> Optional[Tuple[StreamSession, StreamSession]]:
        """Open the vehicle's (outer, inner) pair.  Returns None when the
        fleet is saturated (backpressure) — the vehicle should retry."""
        if vehicle in self.sessions:
            raise KeyError(f"vehicle {vehicle!r} already joined")
        if self.active_streams() + 2 > self.capacity() * self.overcommit:
            self.refused += 1
            return None
        self._sync_load(now_ms)

        outer_seg = Segment(video_id=vehicle, index=0, num_segments=1,
                            frame_start=0, frame_count=0, stream=OUTER)
        inner_seg = Segment(video_id=vehicle, index=0, num_segments=1,
                            frame_start=0, frame_count=0, stream=INNER)
        pair = []
        ddl = deadline_ms if deadline_ms is not None else self.deadline_ms
        for a in self.sched.schedule_pair(outer_seg, inner_seg, now_ms):
            sess = StreamSession(vehicle=vehicle, stream=a.segment.stream,
                                 engine=a.worker, assignment=a,
                                 joined_ms=now_ms)
            self._by_name[a.worker].open_stream(
                sess.key, a.segment.stream, deadline_ms=ddl)
            self.sched.commit(a, busy_until_ms=now_ms)
            pair.append(sess)
        self.sessions[vehicle] = (pair[0], pair[1])
        return self.sessions[vehicle]

    def push(self, vehicle: str, outer_frame: np.ndarray,
             inner_frame: np.ndarray) -> Tuple[bool, bool]:
        """Route one (outer, inner) frame pair; False = shed by backpressure."""
        accepted = []
        for sess, frame in zip(self.sessions[vehicle],
                               (outer_frame, inner_frame)):
            ok = self._by_name[sess.engine].push(sess.key, frame)
            sess.pushed += 1
            sess.shed += not ok
            accepted.append(ok)
        return accepted[0], accepted[1]

    def leave(self, vehicle: str) -> List[SegmentRecord]:
        """Close both streams; flush records; credit measured capacity."""
        recs = []
        for sess in self.sessions.pop(vehicle):
            rec = self._by_name[sess.engine].close_stream(sess.key)
            self.sched.complete(
                sess.assignment,
                rec.frames_processed - sess.credit_frames,
                rec.processing_ms - sess.credit_ms)
            recs.append(rec)
        self.closed.extend(recs)
        return recs

    def _sync_load(self, now_ms: float) -> None:
        """Refresh scheduler busy-ness from actual lane occupancy.

        CapacityScheduler assumes short jobs whose queue_len drains at
        complete(); fleet sessions are long-lived, so a replica must read
        as *free* while it still has unbound lanes (else the master replica
        is excluded forever after its first session and its lanes idle
        while workers oversubscribe).  Full replicas keep their session
        count as queue_len (and a future busy horizon) so the scheduler's
        shortest-queue tie-break orders them at full resolution.  Dead
        replicas read permanently busy with a poisoned queue as defence in
        depth — the scheduler's ``down`` filter already excludes them."""
        for r in self.replicas:
            w = self.sched.by_name(r.name)
            if r.name in self.dead:
                w.busy_until_ms = float("inf")
                w.queue_len = 10 ** 9
                continue
            has_free_lanes = r.session_count < r.slots
            w.busy_until_ms = 0.0 if has_free_lanes else now_ms + 1.0
            w.queue_len = 0 if has_free_lanes else r.session_count

    # ------------------------------------------------------------------
    # replica failure / recovery
    # ------------------------------------------------------------------
    def fail_replica(self, name: str, now_ms: float = 0.0
                     ) -> List[Tuple[str, str, str]]:
        """Take a replica out of service and rebind its sessions onto the
        survivors (the fleet analogue of a phone dropping off Wi-Fi Direct
        mid-segment).  Streams are *detached*, not closed: counters, the
        pending backlog, and the saved gate state (including the adapted
        threshold) travel to the adopting replica.  Returns the rebind
        list ``[(stream_key, from_replica, to_replica), ...]``.

        A *token* replica name takes the token path instead: its worker
        is marked down in the token scheduler, every in-flight and queued
        request is evacuated (KV blocks freed on the dead replica) and
        re-placed onto surviving token replicas — or parked in
        ``token_stranded`` with a loud warning when none survive."""
        if name in self._token_by_name:
            return self._fail_token_replica(name, now_ms)
        if name not in self._by_name:
            raise KeyError(name)
        if name in self.dead:
            raise ValueError(f"replica {name!r} is already down")
        if len(self.live_replicas()) <= 1:
            raise RuntimeError("cannot fail the last live replica")
        self.dead.add(name)
        self.sched.down.add(name)
        dead_engine = self._by_name[name]
        moved: List[Tuple[str, str, str]] = []
        # outer (hazard) streams rebind first: if the survivors are tight
        # on lanes the priority class must win the good placements
        orphans = sorted((s for pair in self.sessions.values() for s in pair
                          if s.engine == name),
                         key=lambda s: (s.stream != OUTER, s.key))
        for sess in orphans:
            st = dead_engine.detach_stream(sess.key)
            self._sync_load(now_ms)
            target = self.sched._pick_worker(now_ms).name
            self._by_name[target].adopt_stream(st)
            sess.engine = target
            sess.assignment = Assignment(sess.assignment.segment, target)
            sess.credit_frames = st.processed
            sess.credit_ms = st.processing_ms
            self.sched.commit(sess.assignment, busy_until_ms=now_ms)
            moved.append((sess.key, name, target))
        w = self.sched.by_name(name)
        w.busy_until_ms = float("inf")
        w.queue_len = 10 ** 9
        if self.events is not None and dead_engine.emitter is not None:
            # live streams' spools travelled with detach/adopt above;
            # re-home whatever is left (closed streams still draining)
            self.events.stranded(dead_engine.emitter)
        self.rebinds.extend(moved)
        return moved

    def _fail_token_replica(self, name: str, now_ms: float
                            ) -> List[Tuple[str, str, str]]:
        """Token-side failure: mark the worker down, evacuate its
        in-flight + queued requests (their KV blocks return to the dead
        replica's pool so the block ledger closes at zero), and re-place
        them on the survivors.  Unlike the vision fleet there is no
        last-replica guard — with no survivors the orphans are parked in
        ``token_stranded`` and a warning is raised (reject loudly)."""
        if name in self.dead:
            raise ValueError(f"replica {name!r} is already down")
        self.dead.add(name)
        self.token_sched.down.add(name)
        w = self.token_sched.by_name(name)
        w.busy_until_ms = float("inf")
        w.queue_len = 10 ** 9
        dead_engine = self._token_by_name[name]
        orphans = dead_engine.evacuate()
        if self.events is not None and dead_engine.emitter is not None:
            # spooled-but-undelivered completion events must survive the
            # replica: re-home them so the pump keeps draining them
            self.events.stranded(dead_engine.emitter)
        moved: List[Tuple[str, str, str]] = []
        live = self.live_token_replicas()
        if not live:
            if orphans:
                warnings.warn(
                    f"token replica {name!r} failed with no surviving "
                    f"token replicas: {len(orphans)} request(s) stranded "
                    f"(see FleetGateway.token_stranded)", stacklevel=3)
            for req, _age in orphans:
                self._token_assign.pop(req.rid, None)
                self.token_stranded.append(req)
            return moved
        for req, age_s in orphans:
            old = self._token_assign.pop(req.rid)
            self._sync_token_load(now_ms)
            target = self.token_sched._pick_worker(now_ms).name
            self._token_by_name[target].adopt_request(req, age_s)
            assignment = Assignment(old.segment, target)
            self._token_assign[req.rid] = assignment
            self.token_sched.commit(assignment, busy_until_ms=now_ms)
            moved.append((req.rid, name, target))
        self.rebinds.extend(moved)
        return moved

    def restore_replica(self, name: str, now_ms: float = 0.0) -> None:
        """Bring a failed replica back into service (empty lanes; it fills
        again through new joins and scheduler placement).  Works for both
        fleets: a token replica's worker state is re-derived from its
        (now empty) occupancy instead of keeping the poisoned reading."""
        if name not in self.dead:
            raise ValueError(f"replica {name!r} is not down")
        if name in self._token_by_name:
            self.dead.discard(name)
            self.token_sched.down.discard(name)
            self._sync_token_load(now_ms)   # re-derive busy/queue state
            return
        self.dead.discard(name)
        self.sched.down.discard(name)
        self._sync_load(now_ms)       # re-derives the worker's free state

    def migrate_stream(self, sess: StreamSession, target: str,
                       now_ms: float = 0.0) -> dict:
        """Move one live stream to another live replica (tier up/downshift).

        The same detach/adopt state travel :meth:`fail_replica` performs
        per orphan — counters, backlog, the adapted gate threshold, and
        the event spool all move — plus the session bookkeeping (capacity
        credits, assignment rewrite, scheduler commit, rebind log).
        Returns a migration record with the gate threshold and consumed
        ordinal on both sides, which the simulator's ``gate-travel`` /
        ``tier-migration`` invariants certify."""
        from repro_torch.streams.tiers import stream_thresh
        src = sess.engine
        if target == src:
            raise ValueError(f"stream {sess.key!r} is already on {target!r}")
        if target not in self._by_name:
            raise KeyError(target)
        if src in self.dead or target in self.dead:
            raise ValueError(f"migrate {sess.key!r}: {src!r} -> {target!r} "
                             f"must both be live")
        src_eng = self._by_name[src]
        dst_eng = self._by_name[target]
        thresh_before = stream_thresh(src_eng, sess.key)
        ordinal_before = src_eng.streams[sess.key].consumed
        st = src_eng.detach_stream(sess.key)
        dst_eng.adopt_stream(st)
        sess.engine = target
        sess.assignment = Assignment(sess.assignment.segment, target)
        sess.credit_frames = st.processed
        sess.credit_ms = st.processing_ms
        self._sync_load(now_ms)
        self.sched.commit(sess.assignment, busy_until_ms=now_ms)
        self.rebinds.append((sess.key, src, target))
        return {"key": sess.key, "src": src, "dst": target,
                "thresh_before": thresh_before,
                "thresh_after": stream_thresh(dst_eng, sess.key),
                "ordinal_before": ordinal_before,
                "ordinal_after": st.consumed}

    def backlog(self, vehicle: str) -> int:
        """Frames still queued across the vehicle's two streams."""
        return sum(len(self._by_name[s.engine].streams[s.key].pending)
                   for s in self.sessions[vehicle])

    # ------------------------------------------------------------------
    # token workloads (requests onto ServeEngine replicas)
    # ------------------------------------------------------------------
    def live_token_replicas(self) -> List["ServeEngine"]:
        return [e for e in self.token_replicas if e.name not in self.dead]

    def _sync_token_load(self, now_ms: float) -> None:
        """Refresh the token scheduler's busy-ness from engine occupancy
        (the token analogue of :meth:`_sync_load`): a replica with a free
        decode slot reads as free; a full one keeps its in-flight count
        as queue_len for the shortest-queue tie-break.  Dead replicas are
        never derived from occupancy (their lanes read empty after
        evacuation, which would make them look attractive) — they keep a
        poisoned reading as defence in depth behind the ``down`` filter."""
        for e in self.token_replicas:
            w = self.token_sched.by_name(e.name)
            if e.name in self.dead:
                w.busy_until_ms = float("inf")
                w.queue_len = 10 ** 9
                continue
            in_flight = (sum(r is not None for r in e.active)
                         + len(e.queue))
            has_free = in_flight < e.slots
            w.busy_until_ms = 0.0 if has_free else now_ms + 1.0
            w.queue_len = 0 if has_free else in_flight

    def submit_request(self, req: "Request", now_ms: float = 0.0) -> str:
        """Place one token request on a token replica via the capacity
        scheduler (measured tokens/s EWMA over the HW prior — the same
        HW_INFO -> measurement handoff vehicle sessions use) and submit
        it.  Returns the chosen replica's name."""
        if not self.token_replicas:
            raise RuntimeError("gateway has no token replicas — construct "
                               "FleetGateway(..., token_replicas=[...])")
        if req.rid in self._token_assign:
            raise KeyError(f"request {req.rid!r} already submitted")
        # the single-replica fast path must count LIVE replicas: with one
        # token replica down, the old ``len(self.token_replicas) == 1``
        # check happily routed new requests onto the corpse
        live = self.live_token_replicas()
        if not live:
            raise RuntimeError(
                "all token replicas are down — cannot place request "
                f"{req.rid!r} (restore a replica and resubmit)")
        if len(live) == 1:
            target = live[0].name
        else:
            self._sync_token_load(now_ms)
            target = self.token_sched._pick_worker(now_ms).name
        seg = Segment(video_id=req.rid, index=0, num_segments=1,
                      frame_start=0, frame_count=req.max_new_tokens,
                      stream=OUTER if req.priority == 0 else INNER)
        assignment = Assignment(seg, target)
        self._token_by_name[target].submit(req)
        self.token_sched.commit(assignment, busy_until_ms=now_ms)
        self._token_assign[req.rid] = assignment
        return target

    def _tick_tokens(self) -> int:
        """Step every token replica once and harvest finished requests:
        scheduler completion (tokens/s capacity credit) + the shared
        ``token_done`` list the simulator reads."""
        done = 0
        for e in self.live_token_replicas():
            t0 = e.clock.now_s()
            n = e.step()
            dt_ms = (e.clock.now_s() - t0) * 1000.0
            if n:
                self.token_sched.by_name(e.name).observe(n, dt_ms)
            done += n
            fresh = e.finished[self._token_harvested[e.name]:]
            self._token_harvested[e.name] = len(e.finished)
            for req in fresh:
                self.token_sched.complete(
                    self._token_assign.pop(req.rid),
                    frames=len(req.generated),
                    processing_ms=req.processing_ms)
                self.token_done.append(req)
        return done

    def token_backlog(self) -> int:
        """Requests still queued or decoding across the token fleet."""
        return sum(len(e.queue) + sum(r is not None for r in e.active)
                   for e in self.token_replicas)

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def tick(self, *, pump_events: bool = True) -> int:
        """Step every live replica once; feed measured frames/s back into
        the scheduler's capacity EWMAs (the HW_INFO -> measurement
        handoff).  Timing reads each replica's own clock, so a simulated
        replica's virtual speed profile flows into the same capacity
        estimate a wall-clocked replica's real speed does.

        With ``parallel=True`` the same tick runs every live replica's
        device work in one fused call (``streams.fleet_step``) — identical
        host phases, identical accounting, bit-identical results under
        virtual clocks.  Token replicas (if any) step after the vision
        replicas in both modes; the return value counts frames + tokens
        served.

        ``pump_events=False`` skips the event-plane delivery round: the
        hierarchical control plane (``streams.cells``) shares ONE plane
        across many cell gateways, and the region must pump it exactly
        once per region tick — per-cell pumps would multiply the backoff
        round counter and the delivery cadence."""
        if self.tiering is not None:
            # the tier control round runs before any engine work, reading
            # only host state — so serial and fused fleets make identical
            # migration/scale decisions
            self.tiering.step(self)
        if self._fleet is not None:
            done = self._fleet.tick(self)
        else:
            done = 0
            for r in self.live_replicas():
                t0 = r.clock.now_s()
                n = r.step()
                dt_ms = (r.clock.now_s() - t0) * 1000.0
                if n:
                    self.sched.by_name(r.name).observe(n, dt_ms)
                done += n
            if self.token_replicas:
                done += self._tick_tokens()
        if self.events is not None and pump_events:
            # one delivery round per gateway tick, after all engine work
            # — shared by both modes so attaching the plane cannot fork
            # serial and fused traces
            self.events.pump()
        return done

    def drain(self, max_ticks: int = 100_000) -> int:
        done = 0
        ticks = 0
        while (any(r.has_work() for r in self.live_replicas())
               or any(e.has_work() for e in self.token_replicas)) \
                and ticks < max_ticks:
            done += self.tick()
            ticks += 1
        return done
