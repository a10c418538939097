"""The reference's scheduler property tests, replayed on the port (CPU).

``tests/test_scheduler_properties.py`` run against ``repro_torch``: the
same properties, strategies and example counts, on the port's
CapacityScheduler / _FleetScheduler placement, the EngineCore
PriorityQueue and BlockPool, and the port's engines on the CPU.

The one difference is ``deadline=None`` on every Hypothesis ``settings``:
the reference's join/leave property fails on Hypothesis's 200 ms default
deadline when a JAX compile lands in its first example.  The port compiles
nothing, but its first example still pays one-time set-up (the first
engine's convolution and allocator warm-up on the CPU), and a test that
passes or fails with the machine's load would say nothing about placement.

Runs under real ``hypothesis`` when installed, else the vendored
deterministic fallback (``tests/_hypothesis_stub.py``).  Properties:

  * capacity      — across arbitrary join/leave sequences the gateway
                    never lets an engine bind more streams than lanes,
                    and admission never exceeds the overcommit bound;
  * placement     — every live session is placed on exactly one live
                    replica (engines and gateway bookkeeping agree), and
                    a refused join leaves no partial state behind;
  * conservation  — queue lengths never go negative and every commit is
                    matched by exactly one complete across any sequence;
  * segmentation  — splitting the inner video conserves frame counts and
                    only targets real devices;
  * priority      — the two-class PriorityQueue both engines share keeps
                    every priority-0 entry ordered ahead of every
                    priority-1 entry, and (with a finite starvation
                    limit) never starves the priority-1 class under
                    sustained priority-0 load.
"""
from dataclasses import dataclass

import numpy as np
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                # pragma: no cover
    from _hypothesis_stub import given, settings, strategies as st

from repro_torch.core.engine_core import (BlockPool, BlockPoolExhausted,
                                          PriorityQueue)
from repro_torch.core.scheduler import (CapacityScheduler, HardwareInfo,
                                        Segment, WorkerState)
from repro_torch.streams import FleetGateway, VisionServeEngine


def _fleet(n_replicas, slots, overcommit):
    engines = [VisionServeEngine(f"r{i}", slots=slots, frame_res=64,
                                 input_res=32, fps=10, use_gate=False,
                                 device="cpu")
               for i in range(n_replicas)]
    return engines, FleetGateway(engines, overcommit=overcommit)


@settings(max_examples=12, deadline=None)
@given(n_replicas=st.integers(2, 4), slots=st.integers(1, 3),
       seed=st.integers(0, 10_000))
def test_join_leave_sequences_conserve_placement(n_replicas, slots, seed):
    """Arbitrary interleaved join/leave churn: every live session is
    placed, bound lanes never exceed slots, and admission respects the
    overcommit bound at every step."""
    engines, gw = _fleet(n_replicas, slots, overcommit=1.5)
    rng = np.random.default_rng(seed)
    live = []
    counter = 0
    for step in range(40):
        if live and rng.random() < 0.4:
            veh = live.pop(int(rng.integers(len(live))))
            gw.leave(veh)
        else:
            veh = f"veh{counter}"
            counter += 1
            act, cap = gw.active_streams(), gw.capacity()
            res = gw.join(veh, now_ms=float(step))
            if res is None:
                assert act + 2 > cap * gw.overcommit   # true backpressure
                assert veh not in gw.sessions          # no partial state
            else:
                assert act + 2 <= cap * gw.overcommit
                live.append(veh)
        # global invariants after every operation
        assert sum(e.session_count for e in engines) == 2 * len(gw.sessions)
        for e in engines:
            assert e.bound_count <= e.slots
        for pair in gw.sessions.values():
            for sess in pair:
                assert sess.key in gw._by_name[sess.engine].streams
    for veh in live:
        gw.leave(veh)
    assert gw.active_streams() == 0
    assert all(gw.sched.by_name(e.name).queue_len >= 0 for e in engines)


@settings(max_examples=15, deadline=None)
@given(caps=st.lists(st.floats(1.0, 50.0), min_size=2, max_size=5),
       seed=st.integers(0, 10_000))
def test_scheduler_queue_lengths_never_negative(caps, seed):
    """Random schedule/commit/complete interleavings: queue_len stays
    >= 0 and every assignment names a real device."""
    states = [WorkerState(f"w{i}", hw=HardwareInfo(cpu_ghz=c, cores=4),
                          is_master=(i == 0))
              for i, c in enumerate(caps)]
    sched = CapacityScheduler(states[0], states[1:])
    rng = np.random.default_rng(seed)
    names = {w.name for w in states}
    inflight = []
    for i in range(30):
        if inflight and rng.random() < 0.5:
            a = inflight.pop(int(rng.integers(len(inflight))))
            sched.complete(a, frames=int(rng.integers(1, 30)),
                           processing_ms=float(rng.uniform(1, 100)))
        else:
            outer = Segment(f"v{i}", 0, 1, 0, 30, "outer")
            inner = Segment(f"v{i}", 0, 1, 0, 30, "inner")
            for a in sched.schedule_pair(outer, inner, now_ms=float(i)):
                assert a.worker in names
                sched.commit(a, busy_until_ms=float(i))
                inflight.append(a)
        assert all(w.queue_len >= 0 for w in sched.devices)
    for a in inflight:
        sched.complete(a, 1, 1.0)
    assert all(w.queue_len == 0 for w in sched.devices)


@settings(max_examples=15, deadline=None)
@given(frames=st.integers(2, 240), n_workers=st.integers(2, 5),
       num_segments=st.integers(0, 6))
def test_segmentation_conserves_frames(frames, n_workers, num_segments):
    states = [WorkerState(f"w{i}", is_master=(i == 0))
              for i in range(n_workers + 1)]
    sched = CapacityScheduler(states[0], states[1:])
    outer = Segment("v", 0, 1, 0, frames, "outer")
    inner = Segment("v", 0, 1, 0, frames, "inner")
    out = sched.schedule_pair(outer, inner, now_ms=0.0,
                              segmentation=True,
                              num_segments=num_segments)
    names = {w.name for w in states}
    assert all(a.worker in names for a in out)
    assert out[0].segment.stream == "outer"            # hazard class first
    inner_frames = sum(a.segment.frame_count for a in out[1:])
    assert inner_frames == frames                      # exact conservation


# ---------------------------------------------------------------------------
# unified EngineCore PriorityQueue (both engines' admission/wait queue)
# ---------------------------------------------------------------------------
@dataclass
class _Item:
    priority: int
    seq: int


def _class_blocks_ordered(q: PriorityQueue) -> bool:
    """No priority-1 entry may sit ahead of any priority-0 entry."""
    prios = [w.priority for w in q]
    first_inner = next((i for i, p in enumerate(prios) if p > 0), len(prios))
    return all(p > 0 for p in prios[first_inner:])


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(st.integers(0, 2), min_size=1, max_size=60),
       limit=st.integers(1, 6), seed=st.integers(0, 10_000))
def test_priority_zero_never_ordered_behind_priority_one(ops, limit, seed):
    """Across arbitrary push/pop interleavings (aging pops included), a
    priority-0 submit always lands ahead of every priority-1 entry, and
    FIFO order holds within each class."""
    rng = np.random.default_rng(seed)
    q = PriorityQueue(starvation_limit=limit)
    seq = 0
    for op in ops:
        if op == 2 and len(q):
            q.pop()
        else:
            q.push(_Item(priority=op % 2, seq=seq))
            seq += 1
        assert _class_blocks_ordered(q)
        for prio in (0, 1):
            seqs = [w.seq for w in q if w.priority == prio]
            assert seqs == sorted(seqs), "FIFO broken within a class"
    # drain: entries come out class-blocked up to the bounded aging bypass
    while q:
        q.pop()
        assert _class_blocks_ordered(q)


@settings(max_examples=20, deadline=None)
@given(limit=st.integers(1, 8), n_hazard=st.integers(10, 60))
def test_priority_one_not_starved_under_sustained_priority_zero(
        limit, n_hazard):
    """Bounded bypass: with a finite starvation limit K, a waiting
    priority-1 entry is served after at most K priority-0 pops, however
    many fresh priority-0 submits keep arriving."""
    q = PriorityQueue(starvation_limit=limit)
    q.push(_Item(priority=1, seq=-1))
    served_inner_after = None
    for i in range(n_hazard):
        q.push(_Item(priority=0, seq=i))
        popped = q.pop()
        if popped.priority == 1:
            served_inner_after = i + 1
            break
    assert served_inner_after is not None, "priority-1 entry starved"
    assert served_inner_after <= limit + 1


def test_bypass_credit_does_not_leak_across_starvation_episodes():
    """Regression: the aging counter must track the *current* starvation
    episode only.  Stale credit from a drained episode used to let a
    fresh priority-1 arrival jump a waiting hazard after fewer than
    `limit` bypasses."""
    q = PriorityQueue(starvation_limit=2)
    q.push(_Item(priority=1, seq=0))
    q.push(_Item(priority=0, seq=1))
    assert q.pop().priority == 0              # bypass 1
    assert q.pop().priority == 1              # episode ends (served, reset)
    # fresh era: h1, b(inner), h2 — both hazards must be served before b
    q.push(_Item(priority=0, seq=2))
    q.push(_Item(priority=1, seq=3))
    q.push(_Item(priority=0, seq=4))
    assert q.pop().seq == 2
    assert q.pop().seq == 4, "stale bypass credit let inner jump a hazard"
    assert q.pop().seq == 3
    # counter also resets when no priority-1 entry is waiting at pop time
    q.push(_Item(priority=0, seq=5))
    q.pop()
    q.push(_Item(priority=0, seq=6))
    q.push(_Item(priority=1, seq=7))
    q.push(_Item(priority=0, seq=8))
    assert [q.pop().seq, q.pop().seq] == [6, 8]


def test_starvation_limit_disabled_is_strict_priority():
    """The vision wait queue (limit=None) must keep strict class order —
    its fairness comes from lane quantum rotation instead (golden-trace
    pinned behaviour)."""
    q = PriorityQueue(starvation_limit=None)
    q.push(_Item(priority=1, seq=0))
    for i in range(50):
        q.push(_Item(priority=0, seq=1 + i))
        assert q.pop().priority == 0


def test_serve_engine_priority_admission_is_queue_ordered():
    """Engine-level: ServeEngine admission pops through the same queue —
    a late hazard submit decodes before earlier distraction submits, and
    under sustained hazard load distraction requests still finish."""
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine

    cfg = get_arch("starcoder2-3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = ServeEngine(cfg, params, slots=1, cache_capacity=32,
                      prefill_chunk=8, starvation_limit=2, device="cpu")
    rng = np.random.default_rng(3)

    def _req(rid, prio):
        return Request(rid=rid, tokens=rng.integers(0, cfg.vocab_size, 5),
                       max_new_tokens=2, priority=prio)

    eng.submit(_req("inner-0", 1))
    for i in range(6):
        eng.submit(_req(f"outer-{i}", 0))
    done = [r.rid for r in eng.run()]
    assert set(done) == {"inner-0"} | {f"outer-{i}" for i in range(6)}
    # the inner request is served within the bypass bound, not last
    assert done.index("inner-0") <= 2


def test_fleet_scheduler_down_filter_excludes_dead_replicas():
    """With a replica down every pick lands on the live pool, whatever
    the capacity ordering says."""
    engines, gw = _fleet(3, slots=2, overcommit=4.0)
    # make the dying replica look strongest so exclusion is load-bearing
    gw.sched.by_name("r1").capacity_ewma.update(1e6)
    gw.fail_replica("r1")
    for v in range(5):
        assert gw.join(f"veh{v}") is not None
    assert all(s.engine != "r1"
               for pair in gw.sessions.values() for s in pair)


# ---------------------------------------------------------------------------
# paged-KV block pool (repro_torch.core.engine_core.BlockPool)
# ---------------------------------------------------------------------------


@settings(max_examples=15, deadline=None)
@given(num_blocks=st.integers(1, 24), seed=st.integers(0, 10_000))
def test_block_pool_alloc_free_round_trip_conserves_blocks(num_blocks, seed):
    """Random admit/retire churn: blocks are never leaked, never handed
    to two owners at once, and free+used always equals the pool size."""
    pool = BlockPool(num_blocks, block_size=8)
    rng = np.random.default_rng(seed)
    held = {}
    rid = 0
    for _ in range(60):
        if held and rng.random() < 0.45:
            owner = list(held)[int(rng.integers(len(held)))]
            pool.free(held.pop(owner), owner)
        else:
            n = int(rng.integers(1, num_blocks + 1))
            try:
                blocks = pool.alloc(n, f"r{rid}")
            except BlockPoolExhausted:
                assert n > pool.free_blocks
                continue
            assert len(blocks) == len(set(blocks)) == n
            assert all(pool.owner_of(b) == f"r{rid}" for b in blocks)
            held[f"r{rid}"] = blocks
            rid += 1
        all_held = [b for bs_ in held.values() for b in bs_]
        assert len(all_held) == len(set(all_held)) == pool.used_blocks
        assert pool.free_blocks + pool.used_blocks == pool.num_blocks
    for owner, blocks in held.items():
        pool.free(blocks, owner)
    assert pool.free_blocks == pool.num_blocks and pool.used_blocks == 0


def test_block_pool_double_free_and_foreign_free_raise():
    pool = BlockPool(4, 8)
    a = pool.alloc(2, "a")
    b = pool.alloc(1, "b")
    pool.free(a, "a")
    with np.testing.assert_raises_regex(ValueError, "double free"):
        pool.free(a, "a")
    with np.testing.assert_raises_regex(ValueError, "held by"):
        pool.free(b, "a")
    # a failed free must not have changed anything
    assert pool.used_blocks == 1 and pool.owner_of(b[0]) == "b"


def test_block_pool_exhaustion_is_loud_and_all_or_nothing():
    pool = BlockPool(3, 8)
    pool.alloc(2, "a")
    with np.testing.assert_raises_regex(BlockPoolExhausted, "only 1/3"):
        pool.alloc(2, "b")
    # the failed alloc took nothing
    assert pool.free_blocks == 1
    pool.alloc(1, "c")


@settings(max_examples=10, deadline=None)
@given(num_blocks=st.integers(2, 16), seed=st.integers(0, 10_000))
def test_block_pool_no_fragmentation(num_blocks, seed):
    """The pool is an id allocator, not an address-contiguous arena:
    after ANY churn, an allocation succeeds iff enough blocks are free —
    freed blocks never become unusable (zero fragmentation by
    construction)."""
    pool = BlockPool(num_blocks, 8)
    rng = np.random.default_rng(seed)
    held = {}
    for step in range(40):
        if held and rng.random() < 0.5:
            owner = list(held)[int(rng.integers(len(held)))]
            pool.free(held.pop(owner), owner)
        n = int(rng.integers(1, num_blocks + 1))
        if n <= pool.free_blocks:
            held[f"s{step}"] = pool.alloc(n, f"s{step}")  # must not raise


def test_serve_engine_pool_exhaustion_backpressures_queue():
    """An undersized pool: admission raises BlockPoolExhausted inside
    rebalance, the engine re-queues the request at the front of its
    class and serves it once blocks free up — nothing is lost, nothing
    is silently admitted without cache blocks."""
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine

    cfg = get_arch("starcoder2-3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    # 2 slots but blocks for only one 2-column request at a time
    eng = ServeEngine(cfg, params, slots=2, cache_capacity=64,
                      prefill_chunk=8, paged=True, num_blocks=2,
                      device="cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(rid=f"r{i}",
                           tokens=rng.integers(0, cfg.vocab_size, 12),
                           max_new_tokens=3))
    done = eng.run()
    assert sorted(r.rid for r in done) == ["r0", "r1", "r2"]
    assert all(len(r.generated) == 3 for r in done)
    assert eng.block_pool.used_blocks == 0
    # serialized by pool pressure: at most one was ever decoding at once,
    # so each later request finished strictly after the previous one
    fins = sorted(r.finish_s for r in done)
    assert fins[0] < fins[1] < fins[2]


def test_serve_engine_rejects_request_larger_than_pool():
    """A request that could NEVER be satisfied (needs more blocks than
    the pool has) must be rejected loudly at submit, not left to spin in
    the queue forever."""
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving import Request, ServeEngine

    cfg = get_arch("starcoder2-3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    eng = ServeEngine(cfg, params, slots=1, cache_capacity=64,
                      prefill_chunk=8, paged=True, num_blocks=1,
                      device="cpu")
    with np.testing.assert_raises_regex(ValueError, "grow num_blocks"):
        eng.submit(Request(rid="big",
                           tokens=np.arange(30, dtype=np.int32) % 7,
                           max_new_tokens=8))
