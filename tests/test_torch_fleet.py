"""Port parity: the fleet layer vs the reference (CPU).

The energy model, segmentation, the capacity scheduler, the tier cost
model and ``TierDirector``, ``FleetGateway`` and the cell/region gateways
of the port are driven through the same scripted sequences as the
reference's, and what they decide must be equal: placements, refusals,
rebinds (with each stream's gate threshold read before and after),
migration and scale actions, handoff records and every ledger record.
The engines run on virtual clocks with fixed rates; their frames are
seeded noise with exact duplicates, so the gate decisions sit far from
their thresholds and the records read no model output.

Also here: the synthetic dash-cam clips the ``dashcam`` scenes cycle are
the reference's bit for bit.  The fused fleet tick (``parallel=True``) is
held in ``tests/test_torch_fleet_step.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import streams as JS
from repro.config import EDAConfig as JEDAConfig
from repro.core import clock as JC
from repro.core import energy as JE
from repro.core import scheduler as JSch
from repro.core import segmentation as JSeg
from repro.core.telemetry import Ledger as JLedger
from repro.data.synthetic import frame_loop as j_frame_loop
from repro.streams import tiers as JT
from repro_torch import streams as PS
from repro_torch.config import EDAConfig
from repro_torch.core import clock as PC
from repro_torch.core import energy as PE
from repro_torch.core import scheduler as PSch
from repro_torch.core import segmentation as PSeg
from repro_torch.core.telemetry import Ledger
from repro_torch.data.synthetic import frame_loop
from repro_torch.streams import tiers as PT

RATES = (0.004, 0.0002)          # virtual s per frame, per tick


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# one gateway per side, built and driven the same way
# ---------------------------------------------------------------------------


def _engines(side, specs, *, esd=0.0, kernels=False):
    """``specs``: (name, slots, tier or None, frame-cost scale)."""
    out = []
    for i, (name, slots, tier, scale) in enumerate(specs):
        common = dict(slots=slots, frame_res=32, input_res=16, fps=10,
                      tier=tier)
        if side == "ref":
            clock = JC.VirtualClock(rates={JC.FRAME: RATES[0] * scale,
                                           JC.TICK: RATES[1]})
            out.append(JS.VisionServeEngine(
                name, **common, eda=JEDAConfig(esd=esd), clock=clock,
                use_pallas=kernels, pallas_interpret=True,
                rng=jax.random.key(i)))
        else:
            clock = PC.VirtualClock(rates={PC.FRAME: RATES[0] * scale,
                                           PC.TICK: RATES[1]})
            out.append(PS.VisionServeEngine(
                name, **common, eda=EDAConfig(esd=esd), clock=clock,
                use_kernels=kernels,
                gate=PS.MotionGate(slots, use_kernels=True, device="cpu"),
                generator=torch.Generator().manual_seed(i), device="cpu"))
    return out


def _frames(seed, n, res=32):
    """n frames of noise, each drawn new or an exact repeat of the last."""
    rng = np.random.default_rng(seed)
    out, last = [], None
    for _ in range(n):
        if last is None or rng.random() >= 0.4:
            last = rng.random((res, res, 3), dtype=np.float32)
        out.append(last)
    return out


def _records(ledger):
    return [dataclasses.asdict(r) for r in ledger.records]


def _sessions(gw):
    return {v: [(s.key, s.engine, s.pushed, s.shed, s.credit_frames,
                 s.credit_ms) for s in pair]
            for v, pair in sorted(gw.sessions.items())}


def _thresholds(gw, thresh):
    return {s.key: thresh(gw._by_name[s.engine], s.key)
            for pair in gw.sessions.values() for s in pair}


# ---------------------------------------------------------------------------
# energy, segmentation, scheduler
# ---------------------------------------------------------------------------


def test_energy_model_equals_the_reference():
    assert PE.DEVICE_ENERGY == {k: PE.DeviceEnergy(**dataclasses.asdict(v))
                                for k, v in JE.DEVICE_ENERGY.items()}
    assert dataclasses.asdict(PE.TPU_V5E) == dataclasses.asdict(JE.TPU_V5E)
    pm, jm = PE.EnergyModel(), JE.EnergyModel()
    rng = np.random.default_rng(0)
    for dev in sorted(JE.DEVICE_ENERGY):
        for _ in range(8):
            flops, nbytes, act, wall = (float(x) for x in rng.random(4)
                                        * (2e9, 3e7, 2.0, 60.0))
            e = jm.segment_energy_j(dev, flops, nbytes, act)
            assert pm.segment_energy_j(dev, flops, nbytes, act) == e
            assert pm.battery_pct(dev, e, wall) == jm.battery_pct(dev, e,
                                                                  wall)
    for name in JT.TIERS:
        pt, jt = PT.TIERS[name], JT.TIERS[name]
        assert (pt.cost_scale, pt.flops_per_frame(), pt.frame_bytes()) == (
            jt.cost_scale, jt.flops_per_frame(), jt.frame_bytes())
        assert PT.frame_energy_j(pt) == JT.frame_energy_j(jt)
        for ghz, cores, ram, batt in ((2.0, 8, 4.0, 100.0),
                                      (0.5, 4, 0.5, 10.0)):
            hw = dict(cpu_ghz=ghz, cores=cores, free_ram_gb=ram,
                      battery_pct=batt)
            assert PT.service_ms(pt, PSch.HardwareInfo(**hw)) == \
                JT.service_ms(jt, JSch.HardwareInfo(**hw))


def test_segmentation_equals_the_reference():
    for total, n in ((30, 4), (7, 3), (5, 9), (240, 6), (1, 1)):
        payload = np.arange(total)
        for stream in ("outer", "inner"):
            ps = PSeg.split_video("v", total, n, stream=stream,
                                  payload=payload)
            js = JSeg.split_video("v", total, n, stream=stream,
                                  payload=payload)
            key = lambda s: (s.video_id, s.index, s.num_segments,
                             s.frame_start, s.frame_count, s.stream,
                             s.splittable, s.video_frames, s.segment_id,
                             s.parent_frames, s.payload.tolist())
            assert [key(s) for s in ps] == [key(s) for s in js]
            parts = [PSeg.SegmentResult(s, {i: (s.index, i) for i in
                                            range(s.frame_count)})
                     for s in ps[::-1]]
            jparts = [JSeg.SegmentResult(s, {i: (s.index, i) for i in
                                             range(s.frame_count)})
                      for s in js[::-1]]
            assert PSeg.merge_results(parts) == JSeg.merge_results(jparts)
        assert [t.tolist() for t in PSeg.split_tokens(payload, n)] == \
            [t.tolist() for t in JSeg.split_tokens(payload, n)]
    with pytest.raises(ValueError, match="missing segments"):
        PSeg.merge_results([PSeg.SegmentResult(
            PSeg.split_video("v", 10, 2)[0])])


def _sched_trace(M, caps, seed):
    """A scripted schedule/commit/complete sequence over ``M`` (a
    scheduler module): every assignment and every capacity reading."""
    states = [M.WorkerState(f"w{i}", hw=M.HardwareInfo(cpu_ghz=c, cores=4,
                                                       battery_pct=50.0 + c),
                            is_master=(i == 0))
              for i, c in enumerate(caps)]
    sched = M.CapacityScheduler(states[0], states[1:],
                                outer_priority=seed % 2 == 0)
    rng = np.random.default_rng(seed)
    out, inflight = [], []
    for i in range(24):
        if inflight and rng.random() < 0.4:
            a = inflight.pop(int(rng.integers(len(inflight))))
            sched.complete(a, frames=int(rng.integers(1, 30)),
                           processing_ms=float(rng.uniform(1, 100)))
            continue
        seg = rng.random() < 0.3
        outer = M.Segment(f"v{i}", 0, 1, 0, 30, "outer")
        inner = M.Segment(f"v{i}", 0, 1, 0, 30, "inner",
                          splittable=bool(rng.random() < 0.7))
        for a in sched.schedule_pair(outer, inner, now_ms=float(i),
                                     segmentation=seg,
                                     num_segments=int(rng.integers(0, 4))):
            out.append((a.worker, a.segment.segment_id,
                        a.segment.frame_count))
            sched.commit(a, busy_until_ms=float(i) + rng.random())
            inflight.append(a)
        out.append(tuple((w.name, w.capacity(), w.queue_len,
                          w.busy_until_ms) for w in sched.devices))
    return out


@pytest.mark.parametrize("caps", [(16.0,), (16.0, 4.0), (2.0, 9.0, 5.5),
                                  (1.0, 3.0, 3.0, 8.0, 2.5)])
def test_capacity_scheduler_equals_the_reference(caps):
    for seed in range(3):
        assert _sched_trace(PSch, caps, seed) == _sched_trace(JSch, caps,
                                                              seed)


# ---------------------------------------------------------------------------
# gateway
# ---------------------------------------------------------------------------


def _gateway_script(side):
    """Join (until refusal), push, tick, leave, fail a replica (rebinds
    with gate state), restore it, join again, drain, close everything."""
    M, thresh = ((JS, JT.stream_thresh) if side == "ref"
                 else (PS, PT.stream_thresh))
    specs = [("r0", 2, None, 1.0), ("r1", 2, None, 2.0),
             ("r2", 3, None, 0.5)]
    engines = _engines(side, specs, esd=2.0)
    gw = M.FleetGateway(engines, deadline_ms=60.0, overcommit=1.5,
                        ledger=(JLedger() if side == "ref" else Ledger()))
    log = []
    clips = {}
    for t in range(30):
        if t < 12 or t == 20:
            v = f"veh{t:02d}"
            pair = gw.join(v, now_ms=float(t))
            log.append(("join", v, None if pair is None else
                        [(s.key, s.engine) for s in pair],
                        gw.active_streams(), gw.capacity(), gw.refused))
            if pair is not None:
                clips[v] = _frames(t, 40)
        if t in (9, 15):
            v = sorted(gw.sessions)[1]
            recs = gw.leave(v)
            clips.pop(v)
            log.append(("leave", v, [dataclasses.asdict(r) for r in recs]))
        if t == 13:
            before = _thresholds(gw, thresh)
            moved = gw.fail_replica("r2", now_ms=float(t))
            after = _thresholds(gw, thresh)
            log.append(("fail", moved, [(k, before[k], after[k])
                                        for k, _, _ in moved]))
            assert moved and all(before[k] == after[k] for k, _, _ in moved)
        if t == 18:
            gw.restore_replica("r2", now_ms=float(t))
            log.append(("restore", gw.live_replicas()[-1].name))
        for v, frames in sorted(clips.items()):
            gw.push(v, frames[t], frames[t][::-1].copy())
        log.append(("tick", gw.tick(), _sessions(gw),
                    _thresholds(gw, thresh),
                    [gw.sched.by_name(r.name).capacity()
                     for r in gw.replicas]))
    log.append(("drain", gw.drain(max_ticks=200)))
    for v in sorted(gw.sessions):
        log.append(("close", v, [dataclasses.asdict(r)
                                 for r in gw.leave(v)]))
    gw.ledger.check()
    return log, _records(gw.ledger), gw.rebinds, gw.refused


@pytest.fixture(scope="module")
def reference():
    """The reference's side of the three scripted fleets, run once in the
    fixture's set-up (its first runs pay the JAX compiles)."""
    return {"gateway": _gateway_script("ref"), "tiers": _tier_script("ref"),
            "cells": _cells_script("ref")}


def test_gateway_lifecycle_equals_the_reference(reference):
    got, want = _gateway_script("port"), reference["gateway"]
    assert got[3] == want[3] > 0                    # refusals happened
    assert got[2] == want[2] and len(got[2]) > 0    # rebinds happened
    for g, w in zip(got[0], want[0]):
        assert g == w
    assert len(got[0]) == len(want[0])
    assert got[1] == want[1]
    assert sum(r["frames_gated"] for r in got[1]) > 0
    assert sum(r["frames_deadline_dropped"] for r in got[1]) > 0


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------


def _tier_script(side):
    """A tiered fleet under a join spike: the director's migrations and
    scale actions, with the gateway state after each tick."""
    M, TM = (JS, JT) if side == "ref" else (PS, PT)
    specs = [("base0", 2, "base", 1.0), ("low0", 2, "low", 1.0),
             ("sb_low", 2, "low", 1.0), ("sb_frugal", 2, "frugal", 1.0)]
    engines = _engines(side, specs, esd=2.0)
    director = TM.TierDirector(down_pressure=1.0, up_slack=0.5, window=2,
                               cooldown=3, scale_out_pressure=1.5,
                               scale_in_slack=0.3, scale_window=2,
                               deadline_ms=200.0)
    gw = M.FleetGateway(engines, deadline_ms=200.0, overcommit=3.0,
                        tiering=director, standby=("sb_low", "sb_frugal"),
                        ledger=(JLedger() if side == "ref" else Ledger()))
    log, clips = [], {}
    for t in range(36):
        if t < 6:
            v = f"veh{t}"
            if gw.join(v, now_ms=float(t)) is not None:
                clips[v] = _frames(100 + t, 40)
        if t == 24:
            for v in sorted(gw.sessions)[:4]:
                gw.leave(v)
                clips.pop(v)
        for v, frames in sorted(clips.items()):
            for k in range(3 if t < 20 else 1):
                gw.push(v, frames[(3 * t + k) % 40], frames[t % 40])
        gw.tick()
        log.append((t, director.drain_actions(), _sessions(gw),
                    sorted(gw.dead), director.fleet_pressure()))
    return log


def test_tier_director_decisions_equal_the_reference(reference):
    got, want = _tier_script("port"), reference["tiers"]
    assert got == want
    kinds = {a["kind"] for _, acts, *_ in got for a in acts}
    assert {"downshift", "scale_out"} <= kinds, kinds


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _cells_script(side):
    """Two cells under a region: placement by free capacity, a replica
    failure that shrinks one cell, the region's bounded rebalance rounds
    handing vehicles off, then the roll-up ledger."""
    M, thresh = ((JS, JT.stream_thresh) if side == "ref"
                 else (PS, PT.stream_thresh))
    L = JLedger if side == "ref" else Ledger
    specs = [("c0r0", 2, None, 1.0), ("c0r1", 2, None, 1.0),
             ("c1r0", 2, None, 1.0), ("c1r1", 2, None, 1.0)]
    engines = _engines(side, specs)
    cells = [M.CellGateway(f"cell{c}", engines[2 * c:2 * c + 2],
                           overcommit=1.0, ledger=L(aggregate=True))
             for c in range(2)]
    region = M.RegionGateway(cells, pump_budget=2, rebalance_margin=0.1)
    log, clips = [], {}
    for t in range(20):
        if t < 5:
            v = f"veh{t}"
            pair = region.join(v, now_ms=float(t))
            log.append(("join", v, pair is not None and
                        [(s.key, s.engine) for s in pair],
                        region.can_admit()))
            if pair is not None:
                clips[v] = _frames(200 + t, 20)
        if t == 6:
            log.append(("fail", region.fail_replica("c0r0", float(t))))
        if t == 12:
            region.restore_replica("c0r0", float(t))
        for v, frames in sorted(clips.items()):
            region.push(v, frames[t], frames[t])
        region.tick()
        hand = [dict(h, streams=[{k: st[k] for k in sorted(st)}
                                 for st in h["streams"]])
                for h in region.drain_handoffs()]
        log.append((t, hand, {v: c.cell_name for v, c in
                              sorted(region.placements.items())},
                    _thresholds(region, thresh)))
    region.drain(max_ticks=100)
    for v in sorted(region.placements):
        region.leave(v)
    roll = region.rollup()
    log.append(("rollup", dict(roll.totals), region.refused,
                sorted(region.rebinds)))
    return log


def test_cells_and_region_equal_the_reference(reference):
    got, want = _cells_script("port"), reference["cells"]
    assert got == want
    assert any(t[1] for t in got if isinstance(t[0], int))  # a handoff


# ---------------------------------------------------------------------------
# the dashcam scenes' frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,res,objects", [(0, 64, 2), (111 * 100_003 + 2,
                                                           64, 1),
                                              (7, 256, 2)])
def test_frame_loop_equals_the_reference_bit_for_bit(seed, res, objects):
    ours = frame_loop(seed, res, moving_objects=objects)
    ref = j_frame_loop(seed, res, moving_objects=objects)
    for i in (0, 1, 17, 47, 48, 95):
        a, b = ours(i), np.asarray(ref(i))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
