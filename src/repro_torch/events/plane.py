"""Event plane: emitters on the engines, spools on the uplinks, one pump.

Wiring (``FleetGateway(events=EventPlane(...))``):

  * every engine replica (vision AND token) gets an :class:`EventEmitter`
    — the emission API the engine hooks call from their *host* phases
    (attaching the plane never forks the vision trace's frame
    accounting);
  * the emitter owns per-stream state: cooldown ordinals, an evidence
    ring (vision), and a bounded :class:`~repro_torch.events.spool.EventSpool`;
    ``detach``/``adopt`` move that state between replicas with the
    stream on failure rebind (riding ``StreamState.event_state``, the
    same travel machinery as the adaptive gate threshold);
  * the plane pumps every spool once per gateway tick: connected spools
    drain into the sink (idempotent receiver — ``events.sink``),
    partitioned vehicles' spools buffer, sink outages back off
    exponentially, and partition onset rewinds unacked sends so
    reconnect re-delivers them (at-least-once; the dedup absorbs it).

Determinism: spools are pumped in sorted-key order and every counter is
a pure function of the emission sequence, so a scenario's ``evt`` trace
events are seed-deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.events.envelope import (DEADLINE_MISS, DISTRACTION, HAZARD,
                                         TOKEN_DONE, Event)
from repro_torch.events.evidence import EvidenceRing, clip_digest
from repro_torch.events.sink import SinkUnavailable
from repro_torch.events.spool import EventSpool

__all__ = ["EventConfig", "EventEmitter", "EventPlane",
           "HAZARD", "DISTRACTION", "DEADLINE_MISS", "TOKEN_DONE"]


@dataclass(frozen=True)
class EventConfig:
    """Plane-wide policy knobs."""
    cooldown_frames: int = 8        # per (stream, type) suppression window
    spool_cap: int = 64             # bounded buffer per stream
    evidence_frames: int = 4        # ring size (0 disables clips)
    backoff_cap: int = 16           # max pump rounds skipped after failure


class _StreamEvents:
    """Per-stream emitter state: spool + cooldowns + evidence ring."""

    def __init__(self, cfg: EventConfig) -> None:
        self.spool = EventSpool(cfg.spool_cap, cfg.backoff_cap)
        self.last_emit: Dict[str, int] = {}     # etype -> frame ordinal
        self.ring = (EvidenceRing(cfg.evidence_frames)
                     if cfg.evidence_frames else None)


class EventEmitter:
    """One engine replica's emission front end (vision or token shell)."""

    def __init__(self, plane: "EventPlane", owner: str) -> None:
        self.plane = plane
        self.owner = owner
        self.streams: Dict[str, _StreamEvents] = {}
        # pump index: keys whose spool may hold work (pending OR
        # inflight).  ``record_frame`` creates per-stream state for every
        # consumed frame — at city scale that is 10k+ entries — but only
        # streams that actually emitted need a delivery round, so the
        # pump walks this set instead of ``streams``
        self.dirty: set = set()

    def _state(self, key: str) -> _StreamEvents:
        st = self.streams.get(key)
        if st is None:
            st = self.streams[key] = _StreamEvents(self.plane.cfg)
        return st

    # ------------------------------------------------------------------
    # engine hooks
    # ------------------------------------------------------------------
    def record_frame(self, key: str, index: int, frame: np.ndarray) -> None:
        """Feed the stream's evidence ring (called from the staging
        phase: one consumed frame per stream per tick)."""
        st = self._state(key)
        if st.ring is not None:
            st.ring.push(index, frame)

    def emit(self, key: str, etype: str, frame_index: int, *,
             segment: int = 0, emit_s: float = 0.0,
             **payload) -> Optional[Event]:
        """Build + spool one event; returns None when the per-stream
        cooldown suppresses it.  The id is idempotent — re-emitting the
        same (key, segment, ordinal, type) yields the same event."""
        st = self._state(key)
        cd = self.plane.cfg.cooldown_frames
        last = st.last_emit.get(etype)
        if last is not None and frame_index - last < cd:
            self.plane.suppressed += 1
            return None
        st.last_emit[etype] = frame_index
        ev = Event.make(key, etype, frame_index, segment=segment,
                        emit_s=emit_s, **payload)
        if st.ring is not None:
            idxs, clip = st.ring.clip(frame_index)
            if clip is not None:
                ev.clip_len = len(idxs)
                ev.clip_digest = clip_digest(clip)
                ev.evidence = clip
        st.spool.append(ev)
        self.dirty.add(key)
        self.plane._note_emit(ev)
        return ev

    def close(self, key: str) -> None:
        """Stream closed (churn/leave): stop evidence/cooldown tracking
        but keep the spool until it drains — departure must not lose
        buffered alerts."""
        st = self.streams.get(key)
        if st is None:
            return
        st.spool.closed = True
        st.last_emit.clear()
        st.ring = None
        if st.spool.depth == 0:
            self.plane._retire_spool(st.spool)
            del self.streams[key]
            self.dirty.discard(key)
        else:
            # still draining: the pump retires it once depth hits zero
            self.dirty.add(key)

    # ------------------------------------------------------------------
    # failure-rebind state travel
    # ------------------------------------------------------------------
    def detach(self, key: str) -> Optional[dict]:
        """Pop the stream's event state for cross-replica travel.  Unacked
        inflight sends rewind to pending — the origin replica is gone, so
        their acks can never arrive (classic at-least-once rewind)."""
        st = self.streams.pop(key, None)
        self.dirty.discard(key)
        if st is None:
            return None
        st.spool.on_partition()
        return {"spool": st.spool, "last_emit": st.last_emit,
                "ring": st.ring}

    def adopt(self, key: str, state: Optional[dict]) -> None:
        if state is None:
            return
        if key in self.streams:
            raise KeyError(f"event state for {key!r} already present")
        st = _StreamEvents(self.plane.cfg)
        st.spool = state["spool"]
        st.last_emit = state["last_emit"]
        st.ring = state["ring"]
        self.streams[key] = st
        if st.spool.depth:
            self.dirty.add(key)

    def depth(self) -> int:
        return sum(st.spool.depth for st in self.streams.values())


class EventPlane:
    """Gateway-owned delivery plane: emitters, partitions, the pump."""

    def __init__(self, cfg: Optional[EventConfig] = None, sink=None,
                 metrics=None) -> None:
        from repro_torch.events.sink import DedupSink
        self.cfg = cfg if cfg is not None else EventConfig()
        self.sink = sink if sink is not None else DedupSink()
        self.metrics = metrics
        self.emitters: List[EventEmitter] = []
        self.partitioned: set = set()           # vehicle names, uplink down
        self.rounds = 0                         # pump counter (backoff base)
        # conservation ledger for the simulator invariants
        self.emitted = 0
        self.suppressed = 0
        self.emitted_ids: set = set()
        # overflow drops whose spool has since been deleted (drained +
        # closed) — without this the conservation ledger would forget
        # them and finalize would read a phantom shortfall
        self._overflow_retired = 0

    def _retire_spool(self, spool: EventSpool) -> None:
        self._overflow_retired += spool.overflow_dropped

    # ------------------------------------------------------------------
    def new_emitter(self, owner: str) -> EventEmitter:
        em = EventEmitter(self, owner)
        self.emitters.append(em)
        return em

    def _note_emit(self, ev: Event) -> None:
        self.emitted += 1
        self.emitted_ids.add(ev.eid)
        if self.metrics is not None:
            self.metrics.counter(
                "events_emitted_total", "events emitted fleet-wide",
                ("etype",)).labels(etype=ev.etype).inc()

    # ------------------------------------------------------------------
    # connectivity (vehicle uplinks)
    # ------------------------------------------------------------------
    def partition(self, vehicle: str) -> int:
        """Vehicle uplink down: its spools buffer, and anything already
        sent but unacked rewinds (the ack is lost with the link)."""
        self.partitioned.add(vehicle)
        rewound = 0
        for em in self.emitters:
            for key, st in em.streams.items():
                if key.split("/", 1)[0] == vehicle:
                    rewound += st.spool.on_partition()
                    if st.spool.depth:
                        em.dirty.add(key)   # pump after reconnect
        return rewound

    def reconnect(self, vehicle: str) -> None:
        self.partitioned.discard(vehicle)

    # ------------------------------------------------------------------
    # delivery pump
    # ------------------------------------------------------------------
    def pump(self) -> Dict[str, int]:
        """One delivery round (called once per gateway tick): ack the
        previous round's sends, then drain connected, non-backing-off
        spools into the sink in sorted-key order."""
        self.rounds += 1
        sent = accepted = dups = 0
        for em in self.emitters:
            # walk the dirty index, not every stream: only keys with
            # spooled work need a round.  A skipped key has depth 0 —
            # nothing to ack, nothing to deliver — so skipping it cannot
            # change delivery order (the walk stays sorted) or outcome,
            # and the digest parity tests pin exactly that
            drained = []
            for key in sorted(em.dirty):
                st = em.streams[key]
                spool = st.spool
                if key.split("/", 1)[0] in self.partitioned:
                    continue          # stays dirty; pumps after reconnect
                spool.ack_inflight()
                if spool.ready(self.rounds):
                    while spool.pending:
                        ev = spool.pending[0]
                        try:
                            ok = self.sink.deliver(ev)
                        except SinkUnavailable:
                            spool.on_send_failure(self.rounds)
                            break
                        spool.pending.popleft()
                        spool.mark_sent(ev)
                        spool.on_send_success()
                        sent += 1
                        accepted += ok
                        dups += not ok
                if spool.depth == 0:
                    drained.append(key)
            # drained keys leave the index; drained AND closed streams
            # retire entirely — soak runs must not grow emitter state
            # with churned-away vehicles
            for key in drained:
                em.dirty.discard(key)
                st = em.streams[key]
                if st.spool.closed:
                    self._retire_spool(st.spool)
                    del em.streams[key]
        if self.metrics is not None and sent:
            self.metrics.counter(
                "events_delivered_total",
                "event deliveries that reached the sink").inc(sent)
        return {"sent": sent, "accepted": accepted, "dups": dups}

    def flush(self, max_rounds: int = 1000) -> int:
        """Pump until every connected spool drains (end-of-run / tests).
        Stops early when a round makes no progress (e.g. still-partitioned
        vehicles) — their depth is the caller's signal."""
        for _ in range(max_rounds):
            if self.depth() == 0:
                break
            before = self.depth()
            self.pump()
            # a freshly-sent batch still sits inflight until the next
            # round's ack — progress means pending+inflight shrank OR
            # pending moved to inflight (another round will ack it)
            if self.depth() == before and not any(
                    st.spool.inflight for em in self.emitters
                    for st in em.streams.values()):
                break
        # final ack round for anything left inflight
        self.pump()
        return self.depth()

    # ------------------------------------------------------------------
    # readings (status surface / invariants)
    # ------------------------------------------------------------------
    def depth(self) -> int:
        return sum(em.depth() for em in self.emitters)

    def overflow_dropped(self) -> int:
        return self._overflow_retired + sum(
            st.spool.overflow_dropped
            for em in self.emitters for st in em.streams.values())

    def stranded(self, emitter: EventEmitter) -> int:
        """Re-home a failed replica's residual spools (streams no longer
        open on it — closed streams still draining) onto a plane-level
        orphan emitter so their events keep pumping.  Live streams travel
        with their rebinds; this catches everything else."""
        orphans = [k for k in emitter.streams]
        if not orphans:
            return 0
        home = next((em for em in self.emitters if em.owner == "_orphans"),
                    None)
        if home is None:
            home = self.new_emitter("_orphans")
        moved = 0
        for key in orphans:
            state = emitter.detach(key)
            if key in home.streams:        # merge: append behind existing
                for ev in state["spool"].pending:
                    home.streams[key].spool.append(ev)
                self._retire_spool(state["spool"])
            else:
                home.adopt(key, state)
            st = home.streams[key]
            st.spool.closed = True
            if st.spool.depth:
                home.dirty.add(key)
            else:                      # nothing to drain: retire now
                self._retire_spool(st.spool)
                del home.streams[key]
                home.dirty.discard(key)
            moved += 1
        return moved
