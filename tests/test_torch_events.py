"""Port parity: the event plane vs the reference's (CPU).

The same scripted emissions go through the port's ``repro_torch.events``
and the reference's ``repro.events``: event ids, clip digests, every
counter of the plane, the spools and the sink, and the delivery order
must be equal — for cooldown suppression, bounded-spool overflow, a sink
outage with exponential backoff, a vehicle partition and reconnect, and a
failed replica's spools travelling by detach/adopt and ``stranded``.
Then ``partitioned_reconnect`` (shortened) runs through both runners with
the reference's weights carried across: the digests must be equal.
"""
import warnings

import numpy as np
import pytest
import torch

from repro import events as JE
from repro_torch import events as PE
from test_torch_simulate import port_run, ref_run


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(plane):
    """Everything the plane, its emitters, spools and sink hold."""
    return dict(
        emitted=plane.emitted, suppressed=plane.suppressed,
        ids=sorted(plane.emitted_ids), depth=plane.depth(),
        overflow=plane.overflow_dropped(), rounds=plane.rounds,
        partitioned=sorted(plane.partitioned),
        sink=(list(plane.sink.order), plane.sink.duplicates,
              plane.sink.attempts),
        spools={(em.owner, k): ([e.eid for e in st.spool.pending],
                                [e.eid for e in st.spool.inflight],
                                st.spool.fails, st.spool.next_attempt,
                                st.spool.closed, dict(st.last_emit))
                for em in plane.emitters
                for k, st in sorted(em.streams.items())},
        dirty={em.owner: sorted(em.dirty) for em in plane.emitters})


def _frame(i):
    return np.random.default_rng(i).random((8, 8, 3), dtype=np.float32)


def _emit_all(em, keys, t, etypes):
    out = []
    for j, k in enumerate(keys):
        em.record_frame(k, t, _frame(100 * j + t))
        for et in etypes:
            ev = em.emit(k, et, t, segment=t // 10, emit_s=0.5 * t,
                         score=float(t % 7) / 7)
            out.append(None if ev is None else
                       (ev.eid, ev.clip_len, ev.clip_digest, ev.etype))
    return out


def _script(M, name):
    """One scripted scenario over events module ``M``; returns the log."""
    log = []
    cfg = dict(cooldown=M.EventConfig(cooldown_frames=3, spool_cap=8,
                                      evidence_frames=4),
               overflow=M.EventConfig(cooldown_frames=0, spool_cap=4,
                                      evidence_frames=2),
               outage=M.EventConfig(cooldown_frames=1, spool_cap=16,
                                    evidence_frames=0, backoff_cap=4),
               travel=M.EventConfig(cooldown_frames=2, spool_cap=12,
                                    evidence_frames=3))[name]
    sink = M.FlakySink(fail_first=5) if name == "outage" else M.DedupSink()
    plane = M.EventPlane(cfg, sink)
    # replica r0 serves v000's pair, r1 v001's
    owned = {plane.new_emitter("r0"): ["v000/outer", "v000/inner"],
             plane.new_emitter("r1"): ["v001/outer", "v001/inner"]}
    a, b = owned
    etypes = [M.HAZARD, M.DEADLINE_MISS]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for t in range(14):
            for em, keys in owned.items():
                log.append(_emit_all(em, keys, t, etypes))
            if name == "overflow" and t < 6:
                continue                      # let the spools fill up
            if name == "travel":
                if t == 3:
                    log.append(("partition", plane.partition("v000")))
                if t == 5:                    # v001/outer rebinds r1 -> r0
                    a.adopt("v001/outer", b.detach("v001/outer"))
                    owned[a].append(owned[b].pop(0))
                    b.close("v001/inner")     # v001/inner leaves
                    owned[b].pop(0)
                if t == 7:                    # r1 fails with spools left
                    log.append(("stranded", plane.stranded(b)))
                if t == 9:
                    plane.reconnect("v000")
            if name == "outage" or t % 3 == 0:
                log.append(plane.pump())
            log.append(_state(plane))
        log.append(("flush", plane.flush()))
        log.append(_state(plane))
    log.append(sorted(str(w.message) for w in caught))
    return log, plane


@pytest.mark.parametrize("name", ["cooldown", "overflow", "outage",
                                  "travel"])
def test_event_plane_equals_the_reference(name):
    got, plane = _script(PE, name)
    want, _ = _script(JE, name)
    for g, w in zip(got, want):
        assert g == w
    assert len(got) == len(want)
    if name == "cooldown":
        assert plane.suppressed > 0 and plane.emitted > 0
        assert any(e.clip_len for e in plane.sink.accepted.values())
    if name == "overflow":
        assert plane.overflow_dropped() > 0 and got[-1]
    if name == "outage":
        assert plane.sink.failures == 5
    if name == "travel":
        assert plane.sink.duplicates > 0
        assert ("stranded", 1) in got and ("partition", 4) in got
    assert plane.depth() == 0
    assert plane.sink.accepted_count == (plane.emitted
                                         - plane.overflow_dropped())


def test_event_ids_and_clip_digests_equal_the_reference():
    for key, etype, idx, seg in (("v000/outer", PE.HAZARD, 0, 0),
                                 ("v123/inner", PE.DISTRACTION, 41, 4),
                                 ("lm0", PE.TOKEN_DONE, 7, 0)):
        assert PE.event_id(key, seg, idx, etype) == JE.event_id(
            key, seg, idx, etype)
    clip = np.stack([_frame(i) for i in range(3)])
    assert PE.clip_digest(clip) == JE.clip_digest(clip)
    assert PE.clip_digest(None) == JE.clip_digest(None) == ""


@pytest.fixture(scope="module")
def reference_partitioned():
    """The reference's partitioned_reconnect at 130 ticks (every scripted
    event lands; the last reconnect is at tick 124), run in set-up."""
    return ref_run("partitioned_reconnect", ticks=130)


def test_partitioned_reconnect_with_the_reference_weights(
        reference_partitioned):
    want, runner = reference_partitioned
    got = port_run("partitioned_reconnect", weights_of=runner, ticks=130)
    assert got.violations == [] and want.violations == []
    assert got.trace.canonical() == want.trace.canonical()
    assert got.digest == want.digest
    assert got.summary == want.summary
    counts = got.trace.counts()
    assert counts["partition"] == counts["reconnect"] == 2
    assert counts["rebind"] > 0
    assert got.summary["evt_duplicates"] > 0
    assert got.summary["evt_spool_depth"] == 0
