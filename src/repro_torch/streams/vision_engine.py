"""Fleet-scale vision serving engine: continuous batching over frames.

``VisionServeEngine`` serves a fleet of vehicle streams on one device; the
unit of work is a *frame*:

  * each slot (lane) is one vehicle stream — the stream holds the lane for
    its lifetime, its frames flow through that batch row;
  * admission writes frames into fixed-shape per-model batches (detector
    for outer streams, pose for inner) at the lane index, so no shape ever
    changes whichever lanes are live on a given tick;
  * ``use_kernels=True`` swaps the ingest stage for the hand-written CUDA
    kernels of ``kernels.vision_ops``: frames stage into a host buffer
    (pinned on the card), one upload per class per tick, one
    ``ingest_frame`` pass normalizes + downscales to model AND gate
    resolution + scores block-SAD, the host thresholds the (slots,) scores
    (``MotionGate.decide``), and one ``scatter_admit`` pass writes admitted
    rows into the batch and refreshes gate references; the batch pool then
    holds model-resolution frames (the model's own downscale is the
    identity gather);
  * outer/hazard streams pre-empt inner/distraction streams: they jump the
    binding queue and, when every lane is taken, evict the most recently
    bound inner stream (hazards outrank distraction — paper §3.2.5);
  * each stream carries a deadline window; before every tick the stream's
    backlog is trimmed to the frame budget the ``EarlyStopPolicy`` affords
    at the engine's EWMA per-frame cost, and the trimmed (stale) frames are
    accounted exactly like the paper's skip rate;
  * per-stream lifecycle closes into a ``telemetry.SegmentRecord`` (with
    the explicit processed/gated/dropped decomposition ``Ledger.check``
    asserts);
  * all timing flows through the ``core.clock`` seam: a ``WallClock`` by
    default, a ``VirtualClock`` for deterministic runs;
  * ``detach_stream``/``adopt_stream`` move a live stream between
    replicas with counters, backlog, and gate state intact.

Weights are injected (``params=``, e.g. converted from the reference by
``repro_torch.convert``) or drawn from ``generator=``.  The ``emitter``
seam is ``None`` unless a gateway with an event plane
(``repro_torch.events``) attaches one: then hazard, distraction and
deadline-miss events leave from the host phases, and a stream's spool,
cooldowns and evidence ring travel with it on detach/adopt.  The
fleet-parallel tick's host-staging mode and ``commit_class`` are not
ported yet.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import EDAConfig
from repro_torch.configs.eda_vision import detector_config, pose_config
from repro_torch.core.clock import FRAME, Clock
from repro_torch.core.engine_core import INNER, OUTER, EngineCore, LanePool
from repro_torch.core.telemetry import Ledger, SegmentRecord
from repro_torch.device import resolve_device
from repro_torch.events.envelope import DEADLINE_MISS, DISTRACTION, HAZARD
from repro_torch.kernels import vision_ops
from repro_torch.models import vision as V
from repro_torch.models.param import tree_to
from repro_torch.streams.filter import MotionGate
from repro_torch.streams.tiers import TierSpec, resolve_tier


@dataclass
class StreamState:
    """One vehicle stream bound to (or waiting for) an engine lane."""
    key: str
    kind: str                        # outer | inner
    priority: int                    # 0 = outer/hazard class
    deadline_ms: float               # per-window deadline (0 = no drops)
    lane: int = -1                   # -1 = waiting for a lane
    bound_seq: int = -1              # binding order (preemption victim pick)
    served_since_bind: int = 0       # round-robin quantum accounting
    pending: Deque[np.ndarray] = field(default_factory=deque)
    offered: int = 0
    processed: int = 0
    gated: int = 0                   # motion-gate rejects
    dropped: int = 0                 # deadline/backpressure/churn drops
    deadline_dropped: int = 0        # subset of dropped: ESD deadline trims
    flagged: int = 0                 # danger/distraction frames
    first_s: float = 0.0
    last_s: float = 0.0
    processing_ms: float = 0.0
    gate_state: Optional[dict] = None  # travels with the stream, not the lane
    event_state: Optional[dict] = None  # spool/cooldown/evidence, same travel

    @property
    def bound(self) -> bool:
        return self.lane >= 0

    @property
    def consumed(self) -> int:
        """Monotone per-stream frame cursor (the next consumed frame's
        ordinal).  Counters travel intact across rebinds, so ordinals —
        and therefore idempotent event ids — are stable whichever replica
        serves the frame."""
        return self.processed + self.gated + self.dropped


class VisionServeEngine(EngineCore):
    """Continuous-batching frame server for a fleet of vehicle streams.

    A workload shell over :class:`~repro_torch.core.engine_core.EngineCore`:
    the core owns the clock seam, ESD deadline policy, cost EWMAs, tick
    phases, lane pool, and ledger; this class supplies the frame-ingest-
    and-gate semantics (staging, motion gating, the two vision models).
    ``device=None`` means the card; pass ``device="cpu"`` to run on the
    CPU, where the kernel wrappers take their plain versions.
    """

    def __init__(self, name: str = "replica0", *, slots: int = 8,
                 frame_res: int = 64, input_res: int = 48,
                 fps: int = 30, eda: Optional[EDAConfig] = None,
                 gate: Optional[MotionGate] = None, use_gate: bool = True,
                 use_kernels: bool = False,
                 max_pending: int = 256, quantum: int = 32,
                 tier=None,
                 ledger: Optional[Ledger] = None,
                 clock: Optional[Clock] = None,
                 params: Optional[Tuple[dict, dict]] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> None:
        super().__init__(name, slots=slots, eda=eda, ledger=ledger,
                         clock=clock)
        self.device = resolve_device(device)
        # a tier (name or TierSpec) pins the replica's model resolution
        # and batch-pool dtype; the explicit input_res is ignored so a
        # replica can never advertise one tier and serve another
        self.tier: Optional[TierSpec] = None
        if tier is not None:
            self.tier = resolve_tier(tier)
            input_res = self.tier.input_res
        self.frame_res = frame_res
        self.input_res = input_res
        self.use_kernels = use_kernels
        self.fps = fps
        self.max_pending = max_pending
        self.quantum = quantum

        self.dc = detector_config(input_res)
        self.pc = pose_config(input_res)
        if params is not None:
            self.dp, self.pp = (tree_to(p, self.device) for p in params)
        else:
            g = (generator if generator is not None
                 else torch.Generator().manual_seed(0))
            self.dp = V.init_detector(self.dc, g, self.device)
            self.pp = V.init_pose(self.pc, g, self.device)

        # kernel path: the batch pool holds model-resolution frames
        # (ingest_frame emits them); the plain path stages at frame
        # resolution and lets the model downscale internally
        res = input_res if use_kernels else frame_res
        shape = (slots, res, res, 3)
        batch_dtype = (self.tier.torch_dtype() if self.tier is not None
                       else torch.float32)
        self.batches = {kind: torch.zeros(shape, dtype=batch_dtype,
                                          device=self.device)
                        for kind in (OUTER, INNER)}
        if use_kernels:
            # host staging buffer: lanes write rows, one upload per class
            # per tick; stale inactive rows are masked by `active`.  On the
            # card it is pinned and uploaded asynchronously, so the next
            # staging write first waits for the upload that reads it.
            self._stage_t = torch.zeros(
                (slots, frame_res, frame_res, 3), dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
            self._stage = self._stage_t.numpy()
            self._upload_done: Optional[torch.cuda.Event] = None
            # the gateless scatter still flows through scatter_admit; it
            # needs a (fixed-shape) reference operand no gate holds
            self._null_refs = torch.zeros((slots, 1, 1, 3),
                                          dtype=torch.float32,
                                          device=self.device)
        # one gate per model class: lanes are disjoint per stream, but the
        # two classes dispatch separately and keep separate stats; a custom
        # gate's configuration applies to both classes
        if not use_gate:
            if gate is not None:
                raise ValueError("gate provided but use_gate=False — "
                                 "the gate config would be silently dropped")
            self.gates: Dict[str, Optional[MotionGate]] = {
                OUTER: None, INNER: None}
        else:
            if gate is not None and gate.slots != slots:
                raise ValueError(
                    f"gate.slots={gate.slots} must match engine slots={slots}")
            if gate is not None and gate.device != self.device:
                raise ValueError(f"gate.device={gate.device} must match "
                                 f"engine device={self.device}")
            outer_gate = (gate if gate is not None
                          else MotionGate(slots, device=self.device))
            self.gates = {OUTER: outer_gate, INNER: outer_gate.similar()}

        # lane machinery lives in the core's LanePool: free-lane binding,
        # outer-evicts-most-recent-inner preemption, victim-requeues-at-
        # front — the hooks move per-lane gate state with the binding
        self.pool = LanePool(slots, preempt=True,
                             on_bind=self._on_bind,
                             on_unbind=self._on_unbind)
        self.streams: Dict[str, StreamState] = {}
        # throughput estimate (batch-amortised, the core's unit EWMA) vs
        # latency estimate (a stream completes ONE frame per dispatch,
        # however wide the batch — the core's tick EWMA)
        self.frame_cost_ms = self.unit_cost_ms
        self.results: Dict[str, Deque[bool]] = {}
        self.frames_processed = 0

    # ------------------------------------------------------------------
    # stream lifecycle
    # ------------------------------------------------------------------
    def open_stream(self, key: str, kind: str, *, priority: Optional[int] = None,
                    deadline_ms: float = 0.0) -> StreamState:
        """Register a stream and bind it to a lane (or queue it).

        Outer streams default to priority 0 and may evict the most recently
        bound inner stream when every lane is taken.
        """
        if key in self.streams:
            raise KeyError(f"stream {key!r} already open")
        if kind not in (OUTER, INNER):
            # fail at the caller, not deep inside a later _bind
            raise ValueError(f"kind must be {OUTER!r} or {INNER!r}, "
                             f"got {kind!r}")
        prio = priority if priority is not None else (0 if kind == OUTER else 1)
        st = StreamState(key=key, kind=kind, priority=prio,
                         deadline_ms=deadline_ms)
        self.streams[key] = st
        self.results[key] = deque(maxlen=self.max_pending)
        if not self.pool.try_bind(st):
            self.waiting.push(st)
        return st

    @property
    def lanes(self) -> List[Optional[StreamState]]:
        return self.pool.lanes

    @property
    def waiting(self):
        """Priority-ordered wait queue (core PriorityQueue): hazard class
        ahead of distraction, FIFO within a class."""
        return self.pool.waiting

    def close_stream(self, key: str) -> SegmentRecord:
        """Unbind, account leftovers as skipped, flush a SegmentRecord."""
        st = self.streams.pop(key)
        if self.emitter is not None:
            # departure keeps the spool draining; only evidence/cooldown
            # tracking stops (no more frames will be consumed)
            self.emitter.close(key)
        self.results.pop(key, None)          # churn must not leak flag lists
        st.dropped += len(st.pending)
        st.pending.clear()
        if st.bound:
            self.pool.free(st)
        elif st in self.waiting:
            self.waiting.remove(st)
        rec = SegmentRecord(
            video_id=st.key, stream=st.kind, device=self.name,
            processing_ms=st.processing_ms,
            video_len_ms=1000.0 * st.offered / self.fps,
            esd=self.eda.esd,
            frames_total=st.offered, frames_processed=st.processed,
            frames_gated=st.gated, frames_dropped=st.dropped,
            frames_deadline_dropped=st.deadline_dropped)
        if st.processed:
            turnaround_ms = max(st.last_s - st.first_s, 0.0) * 1000.0
        elif st.offered:
            # a session that analysed nothing must not read as near-real-
            # time: account wall time until abandonment, floored past the
            # video length so real_time is False
            wall_ms = (self.clock.now_s() - st.first_s) * 1000.0
            turnaround_ms = max(wall_ms, rec.video_len_ms + 1.0)
        else:
            turnaround_ms = 0.0
        rec.close(turnaround_ms)
        self.ledger.add(rec)
        return rec

    def detach_stream(self, key: str) -> StreamState:
        """Remove a stream *without* closing it: no ledger record, every
        counter, the pending backlog, and the saved gate state stay on the
        returned ``StreamState`` so another replica can adopt it (replica
        failure rebind).  The unbind saves the lane's gate snapshot into
        ``st.gate_state`` — the adaptive threshold travels with the stream.
        """
        st = self.streams.pop(key)
        self.results.pop(key, None)
        if st.bound:
            self.pool.free(st)             # saves gate state via the hook
        elif st in self.waiting:
            self.waiting.remove(st)
        if self.emitter is not None:
            st.event_state = self.emitter.detach(key)
        # convert clock-domain timestamps to *ages* (now - t): each replica
        # has its own clock, so adopt_stream must rebase them
        now = self.clock.now_s()
        if st.offered:
            st.first_s = now - st.first_s
        if st.processed:
            st.last_s = now - st.last_s
        return st

    def adopt_stream(self, st: StreamState) -> StreamState:
        """Install a detached stream (counters/backlog/gate state intact)
        and bind it to a lane or queue it — the receiving half of a
        cross-replica rebind.  The ages detach_stream stored rebase into
        this replica's clock domain."""
        if st.key in self.streams:
            raise KeyError(f"stream {st.key!r} already open")
        now = self.clock.now_s()
        if st.offered:
            st.first_s = now - st.first_s
        if st.processed:
            st.last_s = now - st.last_s
        st.lane = -1
        self.streams[st.key] = st
        self.results[st.key] = deque(maxlen=self.max_pending)
        if self.emitter is not None and st.event_state is not None:
            self.emitter.adopt(st.key, st.event_state)
            st.event_state = None
        if not self.pool.try_bind(st):
            self.waiting.push(st)
        return st

    def push(self, key: str, frame: np.ndarray) -> bool:
        """Enqueue one frame.  Returns False if backpressure dropped it
        (bounded per-stream backlog: stale live video is worthless)."""
        st = self.streams[key]
        expect = (self.frame_res, self.frame_res, 3)
        if tuple(np.shape(frame)) != expect:
            # a row write would silently embed an undersized frame over
            # another stream's stale pixels — fail loudly instead
            raise ValueError(
                f"stream {key!r}: frame shape {np.shape(frame)} != {expect}")
        st.offered += 1
        if st.offered == 1:
            # same clock domain as last_s — turnaround must subtract this
            # engine's clock from this engine's clock, never a caller's
            st.first_s = self.clock.now_s()
        if len(st.pending) >= self.max_pending:
            st.dropped += 1
            return False
        st.pending.append(frame)
        return True

    # ------------------------------------------------------------------
    # lane management (core LanePool + gate-state travel hooks)
    # ------------------------------------------------------------------
    def _on_bind(self, st: StreamState, lane: int) -> None:
        st.served_since_bind = 0
        gate = self.gates[st.kind]
        if gate is not None:
            gate.restore(lane, st.gate_state)

    def _on_unbind(self, st: StreamState, lane: int) -> None:
        gate = self.gates[st.kind]
        if gate is not None:
            st.gate_state = gate.save(lane)

    @property
    def bound_count(self) -> int:
        return self.pool.bound_count

    @property
    def session_count(self) -> int:
        return len(self.streams)

    def has_work(self) -> bool:
        return any(st.pending for st in self.streams.values())

    def backlog_units(self) -> int:
        """Frames queued across every stream (the core pressure signal)."""
        return sum(len(st.pending) for st in self.streams.values())

    def stats(self) -> dict:
        """Serving-loop telemetry (throughput vs latency cost estimators)."""
        return {
            "ticks": self.ticks,
            "frames_processed": self.frames_processed,
            "busy_s": self.busy_s,
            "frame_cost_ms": self.frame_cost_ms.get(0.0),
            "tick_cost_ms": self.tick_cost_ms.get(0.0),
        }

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------
    def _trim_to_deadline(self, st: StreamState) -> None:
        """ESD frame budget over the backlog; stale frames become skip."""
        if not st.pending:
            return
        # a stream finishes one frame per tick, so its per-frame *latency*
        # is the tick cost, not the batch-amortised throughput cost
        budget = self.budget(st.deadline_ms, len(st.pending),
                             self.tick_cost_ms.get(1000.0 / self.fps))
        first_ord = st.consumed                  # first trimmed frame's id
        trimmed = 0
        while len(st.pending) > max(budget, 1):
            st.pending.popleft()                 # oldest frame is stalest
            st.dropped += 1
            st.deadline_dropped += 1
            trimmed += 1
        if trimmed:
            self.note_deadline_drops(trimmed)
            if self.emitter is not None:
                # one deadline-miss event per trim batch; the ordinal names
                # the first frame sacrificed, so the id is stable under
                # replay
                self.emitter.emit(st.key, DEADLINE_MISS, first_ord,
                                  emit_s=self.clock.now_s(), n=trimmed)

    def rebalance(self) -> None:
        """Tick-start lane rebalancing (the core's ``begin_tick`` hook)."""
        # lanes freed since the last tick soak up waiters
        for lane, cur in enumerate(self.lanes):
            if cur is None and self.waiting:
                self.pool.bind(self.waiting.popleft(), lane)
        # hazard class preempts at every tick, not just at open: a waiting
        # outer stream holding frames evicts the most recently bound inner
        for w in [w for w in list(self.waiting)
                  if w.priority == 0 and w.pending]:
            victims = [s for s in self.lanes if s is not None and s.priority > 0]
            if not victims:
                break
            victim = max(victims, key=lambda s: s.bound_seq)
            lane = self.pool.unbind(victim)
            self.waiting.remove(w)
            self.waiting.push(victim, front=True)
            self.pool.bind(w, lane)
        # time-share oversubscribed lanes: a bound stream yields when its
        # backlog is empty OR its round-robin quantum expires.  Quantum
        # rotation never demotes a stream for a lower-priority waiter.
        if self.waiting:
            for lane, cur in enumerate(self.lanes):
                if cur is None:
                    continue
                idle = not cur.pending
                expired = cur.served_since_bind >= self.quantum
                if not idle and not expired:
                    continue
                idx = next(
                    (i for i, w in enumerate(self.waiting)
                     if w.pending and (idle or w.priority <= cur.priority)),
                    None)
                if idx is None:
                    continue
                nxt = self.waiting[idx]
                del self.waiting[idx]
                self.pool.unbind(cur)
                self.waiting.push(cur)
                self.pool.bind(nxt, lane)

    def step(self) -> int:
        """One tick: admit one frame per bound stream, gate, run both
        batched models (outer first).  Returns frames processed."""
        t0 = self.begin_tick()
        done = 0
        for kind in (OUTER, INNER):              # outer/hazard class first
            done += self._step_class(kind)
        self.end_tick(t0, done)
        return done

    def stage_class(self, kind: str) -> np.ndarray:
        """Deadline-trim and pop one frame per bound ``kind`` stream into
        the staging layout (batch rows on the plain path, the host staging
        buffer on the kernel path).  Returns the (slots,) active mask."""
        with self.tspan("stage", cls=kind):
            batch = self.batches[kind]
            active = np.zeros(self.slots, bool)
            if self.use_kernels and self._upload_done is not None:
                # the last upload from the staging buffer may still be
                # reading it
                self._upload_done.synchronize()
                self._upload_done = None
            for lane, st in enumerate(self.lanes):
                if st is None or st.kind != kind or not st.pending:
                    continue
                self._trim_to_deadline(st)
                if self.emitter is not None:
                    self.emitter.record_frame(st.key, st.consumed,
                                              st.pending[0])
                frame = st.pending.popleft()
                st.served_since_bind += 1  # gated frames consume quantum too
                if self.use_kernels:
                    self._stage[lane] = frame
                else:
                    batch[lane].copy_(torch.from_numpy(
                        np.asarray(frame, np.float32)))
                active[lane] = True
        return active

    def _step_class(self, kind: str) -> int:
        active = self.stage_class(kind)
        if not active.any():
            return 0
        batch = self.batches[kind]
        gate = self.gates[kind]
        if self.use_kernels:
            with self.tspan("ingest", cls=kind):
                batch, admit = self._ingest_kernels(batch, gate, active)
            self.batches[kind] = batch
        else:
            with self.tspan("gate", cls=kind):
                admit = (gate.admit(batch, active) if gate is not None
                         else active)
        for lane in np.nonzero(active & ~admit)[0]:
            self.lanes[lane].gated += 1

        n_admit = int(admit.sum())
        if n_admit == 0:
            return 0
        self.tinstant("admit", cls=kind, n=n_admit)
        t0 = self.clock.now_s()
        with self.tspan("forward", cls=kind):
            per_frame = self._forward(kind, batch)
        return self._finish_class(admit, per_frame, t0, n_admit)

    def _forward(self, kind: str, batch: torch.Tensor) -> np.ndarray:
        """Model dispatch for one class; returns (slots,) per-lane flags."""
        if kind == OUTER:
            flags, _ = V.analyse_outer(self.dc, self.dp, batch)
            return flags.any(dim=1).cpu().numpy()              # (slots,)
        distracted, _ = V.analyse_inner(self.pc, self.pp, batch)
        return distracted.cpu().numpy()

    def _finish_class(self, admit: np.ndarray, per_frame: np.ndarray,
                      t0_s: float, n_admit: int) -> int:
        """Post-forward accounting: clock charge, cost EWMAs (core
        ``finish_dispatch``), per-stream counters/flags/timestamps."""
        with self.tspan("commit", n=n_admit):
            dt = self.finish_dispatch(n_admit, t0_s, FRAME)

            now = self.clock.now_s()
            for lane in np.nonzero(admit)[0]:
                st = self.lanes[lane]
                st.processed += 1
                st.last_s = now
                st.processing_ms += dt * 1000.0 / n_admit
                flag = bool(per_frame[lane])
                st.flagged += flag
                self.results[st.key].append(flag)
                if flag and self.emitter is not None:
                    # detection -> alert: the just-processed frame's
                    # ordinal is consumed-1 (processed was incremented)
                    self.emitter.emit(
                        st.key,
                        HAZARD if st.kind == OUTER else DISTRACTION,
                        st.consumed - 1, emit_s=now, lane=int(lane))
            self.frames_processed += n_admit
        return n_admit

    def _ingest_kernels(self, batch: torch.Tensor,
                        gate: Optional[MotionGate], active: np.ndarray):
        """Kernel ingest: one upload of the staged frames, one
        ``ingest_frame`` pass scores + downscales them, the host thresholds,
        one ``scatter_admit`` commits admitted rows into the batch and the
        gate references."""
        staged = self._stage_t.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            self._upload_done = torch.cuda.Event()
            self._upload_done.record()
        if gate is not None:
            model, small, scores = vision_ops.ingest_frame(
                staged, gate.refs, model_res=self.input_res,
                gate_res=gate.gate_res, block=gate.block)
            admit = gate.decide(scores.cpu().numpy(), active)
            batch, gate.refs = vision_ops.scatter_admit(
                batch, model, gate.refs, small,
                torch.as_tensor(admit, device=self.device))
        else:
            model = vision_ops.downscale(staged, self.input_res)
            admit = active
            batch, _ = vision_ops.scatter_admit(
                batch, model, self._null_refs, self._null_refs,
                torch.as_tensor(admit, device=self.device))
        return batch, admit

    def drain(self, max_ticks: int = 100_000) -> int:
        """Step until every backlog is empty.  Returns frames processed."""
        done = 0
        ticks = 0
        while self.has_work() and ticks < max_ticks:
            done += self.step()
            ticks += 1
        return done
