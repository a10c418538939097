"""Port parity: the host-side substrate vs the reference (exact).

Clock, early stop, telemetry, sketches, metrics, tracing, the engine
core's queues and pools, tiers, the event taxonomy and the synthetic data
are plain Python or numpy in both packages: the same inputs must give the
same outputs to the last bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.core import clock as jclock
from repro.core import early_stop as jes
from repro.core import engine_core as jcore
from repro.core import telemetry as jtel
from repro.data import synthetic as jsyn
from repro.events import envelope as jenv
from repro.obs import metrics as jmet
from repro.obs import sketch as jsk
from repro.obs import tracing as jtr
from repro.streams import tiers as jtiers
from repro_torch import config as tconfig
from repro_torch.core import clock as tclock
from repro_torch.core import early_stop as tes
from repro_torch.core import engine_core as tcore
from repro_torch.core import telemetry as ttel
from repro_torch.data import synthetic as tsyn
from repro_torch.events import envelope as tenv
from repro_torch.obs import metrics as tmet
from repro_torch.obs import sketch as tsk
from repro_torch.obs import tracing as ttr
from repro_torch.streams import tiers as ttiers


def _records(tel, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        total = int(rng.integers(1, 60))
        proc = int(rng.integers(0, total + 1))
        gated = int(rng.integers(0, total - proc + 1))
        out.append(tel.SegmentRecord(
            video_id=f"v{i}", stream="outer" if i % 2 else "inner",
            device=f"d{i % 3}", download_ms=float(rng.random() * 400),
            processing_ms=float(rng.random() * 900),
            wait_ms=float(rng.random() * 50), video_len_ms=1000.0,
            esd=float(rng.choice([0.0, 2.0])), frames_total=total,
            frames_processed=proc, frames_gated=gated,
            frames_dropped=total - proc - gated,
            ttft_ms=float(rng.random() * 30) if i % 4 == 0 else 0.0,
            energy_j=float(rng.random()), is_master=i == 0))
        out[-1].close(float(rng.random() * 2000))
    return out


@pytest.mark.parametrize("aggregate", [False, True], ids=["rows", "sketch"])
def test_ledger_summarise_and_percentiles_exact(aggregate):
    led = {}
    for name, tel in (("j", jtel), ("t", ttel)):
        led[name] = tel.Ledger(aggregate=aggregate)
        for r in _records(tel, 40, seed=1):
            led[name].add(r)
        led[name].check()
    for wall in (None, 12.5):
        assert ([dataclasses.asdict(s) for s in led["t"].summarise(wall)]
                == [dataclasses.asdict(s) for s in led["j"].summarise(wall)])
        assert led["t"].table(wall) == led["j"].table(wall)
    assert led["t"].percentiles() == led["j"].percentiles()
    assert led["t"].sketch_percentiles((1, 50, 99.9)) == \
        led["j"].sketch_percentiles((1, 50, 99.9))
    assert led["t"].real_time_fraction() == led["j"].real_time_fraction()
    assert led["t"].mean_turnaround_ms() == led["j"].mean_turnaround_ms()


def test_ledger_check_names_the_same_violations():
    bad = {}
    for name, tel in (("j", jtel), ("t", ttel)):
        led = tel.Ledger()
        led.add(tel.SegmentRecord("v", "outer", "d", frames_total=5,
                                  frames_processed=3, frames_gated=1,
                                  frames_dropped=0))
        with pytest.raises(AssertionError) as e:
            led.check()
        bad[name] = str(e.value)
    assert bad["t"] == bad["j"]
    assert ttel.percentile([3.0, 1.0, 2.0, 9.0], 95) == \
        jtel.percentile([3.0, 1.0, 2.0, 9.0], 95)


def test_sketch_quantiles_and_merge_exact():
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.lognormal(3, 1, 500), np.zeros(20)])
    sk = {}
    for name, mod in (("j", jsk), ("t", tsk)):
        a, b = mod.QuantileSketch(0.01), mod.QuantileSketch(0.01)
        a.extend(vals[:300])
        b.extend(vals[300:])
        sk[name] = a.merge(b)
    qs = (0, 1, 25, 50, 90, 99, 100)
    assert sk["t"].quantiles(qs) == sk["j"].quantiles(qs)
    assert sk["t"].to_dict() == sk["j"].to_dict()
    small = tsk.QuantileSketch(0.05, max_buckets=8)
    ref = jsk.QuantileSketch(0.05, max_buckets=8)
    small.extend(vals)
    ref.extend(vals)
    assert small.to_dict() == ref.to_dict()        # collapse rule too


def test_metrics_exposition_and_merge_exact():
    def fill(mod):
        r1, r2 = mod.MetricsRegistry(), mod.MetricsRegistry()
        for r, k in ((r1, 1.0), (r2, 2.5)):
            r.counter("ticks_total", "ticks", ("engine",)).labels(
                engine="r0").inc(k)
            h = r.histogram("tick_ms", "tick latency")
            for v in (1.0, 3.0 * k, 7.5):
                h.observe(v)
            r.gauge("depth", "queue depth").set(4 * k)
        return r1.merge(r2).expose()
    assert fill(tmet) == fill(jmet)


def test_tracing_events_exact():
    out = {}
    for name, tr, ck in (("j", jtr, jclock), ("t", ttr, tclock)):
        tracer = tr.SpanTracer(sample_every=2, max_events=9)
        clock = ck.VirtualClock(rates={"tick": 0.5})
        for tick in range(4):
            t = tracer.for_tick(tick)
            with t.span(clock, "stage", tid="r0", cls="outer"):
                clock.charge("tick")
            t.instant(clock, "admit", tid="r1", n=tick)
        out[name] = (tracer.to_chrome(), tracer.dropped)
    assert out["t"] == out["j"]
    assert ttr.NULL_TRACER.span(None, "x") is ttr.NULL_SPAN


def test_clock_and_early_stop_exact():
    for mod in (jclock, tclock):
        c = mod.VirtualClock(rates={mod.FRAME: 0.004, mod.TICK: 0.0002})
        c.charge(mod.FRAME, 7)
        c.charge(mod.TICK)
        c.advance(0.25)
        with pytest.raises(ValueError):
            c.advance(-1.0)
    jc = jclock.VirtualClock({"frame": 0.004})
    tc = tclock.VirtualClock({"frame": 0.004})
    for n in (3, 5, 11):
        jc.charge("frame", n)
        tc.charge("frame", n)
    assert (tc.now_s(), tc.charged) == (jc.now_s(), jc.charged)
    for esd in (0.0, 1.0, 2.5, 4.0):
        jp, tp = jes.EarlyStopPolicy(esd), tes.EarlyStopPolicy(esd)
        for args in ((1000.0, 30, 12.5), (1000.0, 30, 0.0),
                     (500.0, 30, 40.0, 100.0)):
            assert tp.frame_budget(*args) == jp.frame_budget(*args)
    jd, td = jes.DynamicESD(), tes.DynamicESD()
    for ta in (1500.0, 1400.0, 900.0, 700.0, 1200.0):
        assert td.update(ta, 1000.0) == jd.update(ta, 1000.0)
    assert td.adjustments == jd.adjustments and td.misses == jd.misses
    want = np.asarray(jes.budget_mask(8, jnp.int32(5)))
    got = tes.budget_mask(8, torch.tensor(5)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    assert dataclasses.asdict(tconfig.EDAConfig()) == \
        dataclasses.asdict(jconfig.EDAConfig())


@dataclasses.dataclass(eq=False)
class _Item:
    name: str
    priority: int
    lane: int = -1
    bound_seq: int = -1


def _queue_trace(core, limit):
    q = core.PriorityQueue(starvation_limit=limit)
    rng = np.random.default_rng(4)
    trace = []
    for step in range(60):
        if rng.random() < 0.6 or not q:
            q.push(_Item(f"i{step}", int(rng.integers(0, 2))),
                   front=bool(rng.random() < 0.2))
        else:
            trace.append(q.pop().name)
    return trace + [w.name for w in q]


@pytest.mark.parametrize("limit", [None, 1, 3])
def test_priority_queue_order_exact(limit):
    assert _queue_trace(tcore, limit) == _queue_trace(jcore, limit)


def _lane_trace(core):
    events = []
    pool = core.LanePool(3, preempt=True,
                         on_bind=lambda it, l: events.append(("b", it.name, l)),
                         on_unbind=lambda it, l: events.append(("u", it.name, l)))
    items = [_Item(f"s{i}", p) for i, p in enumerate([1, 1, 1, 0, 1, 0, 0, 0])]
    for it in items:
        if not pool.try_bind(it):
            pool.waiting.push(it)
    pool.free(items[3])
    pool.free(items[0])
    events.append(("lanes", [s.name if s else None for s in pool.lanes],
                   [w.name for w in pool.waiting], pool.bound_count))
    return events


def test_lane_pool_binding_and_preemption_exact():
    assert _lane_trace(tcore) == _lane_trace(jcore)


def test_block_pool_exact():
    out = {}
    for name, core in (("j", jcore), ("t", tcore)):
        bp = core.BlockPool(6, 4)
        a = bp.alloc(2, "a")
        b = bp.alloc(3, "b")
        with pytest.raises(core.BlockPoolExhausted):
            bp.alloc(2, "c")
        with pytest.raises(ValueError):
            bp.free(a, "b")
        bp.free(a, "a")
        with pytest.raises(ValueError):
            bp.free(a, "a")                  # double free
        c = bp.alloc(3, "c")
        out[name] = (a, b, c, bp.free_blocks, bp.used_blocks, bp.owner_of(c[0]))
    assert out["t"] == out["j"]


def test_insert_row_writes_in_place_like_reference():
    rng = np.random.default_rng(5)
    pool = {"k": rng.random((4, 2, 3)).astype(np.float32),
            "v": [rng.random((2, 4, 3)).astype(np.float32)]}
    row = {"k": rng.random((1, 2, 3)).astype(np.float32),
           "v": [rng.random((2, 1, 3)).astype(np.float32)]}
    want = jcore.insert_row({"k": jnp.asarray(pool["k"]),
                             "v": [jnp.asarray(pool["v"][0])]},
                            {"k": jnp.asarray(row["k"]),
                             "v": [jnp.asarray(row["v"][0])]}, 2)
    tpool = {"k": torch.from_numpy(pool["k"].copy()),
             "v": [torch.from_numpy(pool["v"][0].copy())]}
    storage = tpool["k"].data_ptr()
    got = tcore.insert_row(tpool, {"k": torch.from_numpy(row["k"]),
                                   "v": [torch.from_numpy(row["v"][0])]}, 2)
    assert got["k"].data_ptr() == storage
    np.testing.assert_array_equal(got["k"].numpy(), np.asarray(want["k"]))
    np.testing.assert_array_equal(got["v"][0].numpy(),
                                  np.asarray(want["v"][0]))


def test_tiers_and_envelope_exact():
    for name, spec in ttiers.TIERS.items():
        ref = jtiers.TIERS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
        assert (spec.torch_dtype() == torch.bfloat16) == \
            (ref.jnp_dtype() == jnp.bfloat16)
    assert ttiers.resolve_tier("low") is ttiers.TIERS["low"]
    with pytest.raises(KeyError):
        ttiers.resolve_tier("ultra")
    assert tenv.EVENT_TYPES == jenv.EVENT_TYPES
    for args in (("v003/outer", 0, 17, tenv.HAZARD),
                 ("v9/inner", 2, 0, tenv.DISTRACTION)):
        assert tenv.event_id(*args) == jenv.event_id(*args)
    ev = tenv.Event.make("v1/outer", tenv.DEADLINE_MISS, 4, n=3)
    assert dataclasses.asdict(ev) == dataclasses.asdict(
        jenv.Event.make("v1/outer", jenv.DEADLINE_MISS, 4, n=3))


def test_synthetic_frames_bit_identical():
    np.testing.assert_array_equal(tsyn.synth_frames(7, 5, res=32),
                                  jsyn.synth_frames(7, 5, res=32))
    ta, ja = tsyn.frame_loop(3, res=32, frames=6), jsyn.frame_loop(
        3, res=32, frames=6)
    for i in (0, 5, 6, 13):
        np.testing.assert_array_equal(ta(i), ja(i))
    tp = tsyn.DashCamSource(0.5, fps=8, res=32, seed=2).pair(1)
    jp = jsyn.DashCamSource(0.5, fps=8, res=32, seed=2).pair(1)
    assert tp.video_id == jp.video_id and tp.frames == jp.frames
    np.testing.assert_array_equal(tp.outer, jp.outer)
    np.testing.assert_array_equal(tp.inner, jp.inner)
