"""The port's fused fleet tick against its serial tick and the reference.

``FleetGateway(parallel=True)`` must be bit-identical to stepping the
replicas one by one under virtual clocks: the same admit decisions, ledger
records, summaries and trace digests — over the reference's FAST list
(``tests/test_fleet_step.py``), the 1/2/8-replica sweep, a mid-run
fail/restore rebind and a three-group mixed-tier fleet.  The fused tick
also reproduces the reference's digests (the committed ``golden_churn``
golden; ``pallas_ingest`` as the reference computes it here), keeps one
fused call per tick with work, and refuses what it cannot run.  Beneath
it: the kernels' plain versions on R x slots flattened rows equal R
per-replica calls bit for bit, and the stacked forward's flags equal the
per-replica forwards' (outputs within TIGHT).

All on the CPU, one torch thread; the reference's runs sit in a module
fixture, outside the tests' time budget.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from kernel_harness import TIGHT
from repro import simulate as J
from repro_torch.configs.eda_vision import detector_config, pose_config
from repro_torch.data.synthetic import DashCamSource
from repro_torch.kernels import vision_ops as vo
from repro_torch.models import vision as V
from repro_torch.simulate import (ReplicaSpec, Scenario, ScriptedEvent,
                                  VehicleProfile, get_scenario, run_scenario)
from repro_torch.simulate.scenario import TierPlanSpec
from repro_torch.streams import (FleetGateway, FleetStep, MotionGate,
                                 VisionServeEngine, resolve_mode)
from repro_torch.streams.filter import gate_scores

GOLDEN = (pathlib.Path(__file__).resolve().parent / "golden"
          / "fleet_scenario_v1.json")
FAST = [
    ("steady_state", dict(ticks=40)),
    ("golden_churn", dict(ticks=60)),
    ("replica_failure", dict(ticks=80)),      # fail_replica fires at 60
    ("pallas_ingest", {}),                    # kernel ingest, full length
    ("priority_inversion", dict(ticks=40)),   # 8 streams on 2 lanes
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``pallas_ingest`` digest, computed once."""
    return {"pallas_ingest":
            J.run_scenario(J.get_scenario("pallas_ingest")).digest}


def _record_key(r):
    return (r.video_id, r.stream, r.device, r.frames_total,
            r.frames_processed, r.frames_gated, r.frames_dropped,
            r.frames_deadline_dropped, r.processing_ms, r.turnaround_ms)


def assert_bit_identical(serial, fused):
    assert not serial.violations, "\n".join(map(str, serial.violations))
    assert not fused.violations, "\n".join(map(str, fused.violations))
    assert [_record_key(r) for r in serial.ledger.records] \
        == [_record_key(r) for r in fused.ledger.records], \
        "ledger records diverged between the serial and the fused tick"
    assert serial.summary == fused.summary
    if serial.digest != fused.digest:             # pragma: no cover
        sa, pa = serial.trace.canonical(), fused.trace.canonical()
        for i, (a, b) in enumerate(zip(sa.splitlines(), pa.splitlines())):
            assert a == b, f"first trace divergence at event {i}:\n" \
                           f"  serial: {a}\n  fused:  {b}"
        raise AssertionError("trace lengths diverged")


def _both(s, **kw):
    return (run_scenario(s, device="cpu", **kw),
            run_scenario(s, device="cpu", parallel=True, **kw))


@pytest.mark.parametrize("name,overrides", FAST, ids=[n for n, _ in FAST])
def test_fused_tick_equals_serial(name, overrides, reference):
    serial, fused = _both(get_scenario(name, **overrides))
    assert_bit_identical(serial, fused)
    if name in reference:
        assert fused.digest == reference[name]


def test_fused_golden_churn_equals_the_committed_golden():
    golden = json.loads(GOLDEN.read_text())
    res = run_scenario(get_scenario(golden["scenario"]), device="cpu",
                       parallel=True)
    assert res.violations == []
    assert {k: res.summary[k] for k in golden["summary"]} == golden["summary"]
    assert res.trace.counts() == golden["counts"]
    assert len(res.trace) == golden["events"]
    assert res.digest == golden["digest"]


def _sweep_scenario(n_replicas: int, **kw) -> Scenario:
    """The reference's churny sweep: 3 initial vehicles over
    ``n_replicas`` uniform replicas — at R=8 most lane masks are empty
    (uneven occupancy), at R=1 the lanes are oversubscribed."""
    base = dict(
        name=f"sweep_r{n_replicas}", seed=7_000 + n_replicas, ticks=50,
        replicas=tuple(ReplicaSpec(f"r{i}", slots=4)
                       for i in range(n_replicas)),
        profiles=(VehicleProfile(duplicate_prob=0.4),
                  VehicleProfile(name="burst", frames_per_tick=2,
                                 dup_pattern=(0, 1))),
        initial_vehicles=3, join_rate=0.3, leave_rate=0.03,
        max_vehicles=3 * n_replicas + 1, overcommit=2.0)
    base.update(kw)
    return Scenario(**base)


@pytest.mark.parametrize("n_replicas", [1, 2, 8])
def test_fused_tick_replica_count_sweep(n_replicas):
    assert_bit_identical(*_both(_sweep_scenario(n_replicas)))


def test_fused_fail_restore_rebind_keeps_saved_gate_refs():
    """Rebinds mid-run: gate state travels, digests stay equal — and a
    saved gate reference never changes under its owner: the fused call's
    scatter and select return new tensors, and ``save`` clones the row."""
    from repro_torch.simulate import ScenarioRunner
    s = _sweep_scenario(
        3, name="sweep_fail", ticks=70,
        scripted=(ScriptedEvent(20, "fail_replica", "r1"),
                  ScriptedEvent(45, "restore_replica", "r1")))
    saved = []

    def on_tick(tick, runner):
        if tick in (10, 30):
            for r in runner.gw.replicas:
                for kind, g in r.gates.items():
                    for lane in range(r.slots):
                        st = g.save(lane)
                        saved.append((st["ref"], st["ref"].clone()))
    serial = run_scenario(s, device="cpu")
    runner = ScenarioRunner(s, parallel=True, device="cpu")
    fused = runner.run(on_tick=on_tick)
    assert serial.summary["rebinds"] > 0, "scenario must actually rebind"
    assert_bit_identical(serial, fused)
    assert saved and all(torch.equal(a, b) for a, b in saved)


def _mixed_tier_scenario() -> Scenario:
    """The reference's three-group mixed-tier fleet (base, low, frugal:
    three model geometries, the frugal pool bf16), director quiescent."""
    return Scenario(
        name="mixed_tier_inline", seed=77, ticks=40,
        replicas=(ReplicaSpec("a", tier="base"),
                  ReplicaSpec("b", tier="low"),
                  ReplicaSpec("c", tier="frugal")),
        profiles=(VehicleProfile(duplicate_prob=0.25),),
        initial_vehicles=3, join_rate=0.3, leave_rate=0.05,
        max_vehicles=8,
        tiers=TierPlanSpec(down_pressure=1e9, up_slack=-1.0,
                           scale_out_pressure=1e9))


def test_mixed_tier_fleet_fused_equals_serial_in_three_groups():
    from repro_torch.simulate import ScenarioRunner
    s = _mixed_tier_scenario()
    runner = ScenarioRunner(s, parallel=True, device="cpu")
    step = runner.gw._fleet
    assert step._members == [[0], [1], [2]]
    assert [k[2] for k in step._group_keys] == [32, 16, 16]
    assert step._group_keys[2][3] == "torch.bfloat16"
    fused = runner.run()
    serial = run_scenario(s, device="cpu")
    assert_bit_identical(serial, fused)
    assert serial.summary["adm"] > 0


def test_wall_clock_admit_parity_and_one_dispatch_per_tick():
    """Under wall clocks timing differs but admit/gate decisions are
    clock-independent: the fused gateway processes exactly the frames the
    serial one does, in one fused call per tick with work."""
    def drive(parallel):
        replicas = [VisionServeEngine(
            f"r{i}", slots=2, frame_res=32, input_res=16, use_gate=True,
            generator=torch.Generator().manual_seed(i), device="cpu")
            for i in range(3)]
        gw = FleetGateway(replicas, parallel=parallel)
        src = DashCamSource(granularity_s=0.4, fps=30, res=32, seed=3)
        for v in range(2):
            gw.join(f"v{v}")
            pair = src.pair(v)
            for outer, inner in zip(pair.outer[:8], pair.inner[:8]):
                gw.push(f"v{v}", outer, inner)
        ticks = 0
        while any(r.has_work() for r in gw.live_replicas()):
            gw.tick()
            ticks += 1
        if parallel:
            assert ticks > 0 and gw._fleet.dispatches == ticks
        out = []
        for v in range(2):
            for rec in gw.leave(f"v{v}"):
                out.append((rec.video_id, rec.stream, rec.frames_total,
                            rec.frames_processed, rec.frames_gated))
        return sorted(out)

    serial = drive(False)
    assert sum(r[4] for r in serial) > 0         # the gate did gate
    assert serial == drive(True)


def test_fleet_step_refuses_what_it_cannot_run():
    def eng(name, slots=2, **kw):
        return VisionServeEngine(name, slots=slots, frame_res=32,
                                 input_res=16, device="cpu",
                                 generator=torch.Generator().manual_seed(0),
                                 **kw)
    with pytest.raises(ValueError, match="uniform engine geometry"):
        FleetStep([eng("a"), eng("b", slots=4)])
    with pytest.raises(ValueError, match="uniform use_gate"):
        FleetStep([eng("a"), eng("b", use_gate=False)])
    with pytest.raises(ValueError, match="uniform gate geometry"):
        FleetStep([eng("a"), eng("b", gate=MotionGate(2, gate_res=16,
                                                      device="cpu"))])
    staged = eng("s")
    staged.enable_host_staging()
    staged.open_stream("v0", "outer")
    staged.push("v0", np.zeros((32, 32, 3), np.float32))
    with pytest.raises(RuntimeError, match="fused fleet tick"):
        staged.step()
    assert resolve_mode(4, device_type="cpu") == "vmap" == resolve_mode(
        4, "vmap")
    # shard_map resolves; a replica mesh larger than the pool raises with
    # the number of devices it needs
    assert resolve_mode(2, "shard_map") == "shard_map"
    assert FleetStep([eng("a"), eng("b")], mode="shard_map").mode == \
        "shard_map"
    from repro_torch.sharding.compat import make_mesh
    with pytest.raises(ValueError, match=r"needs 3 devices, only 2"):
        make_mesh((3,), ("replica",), devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="mode must be one of"):
        resolve_mode(2, "pmap")


def _rows(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    return torch.from_numpy(rng.random(shape, dtype=np.float32))


def test_plain_kernels_on_flattened_rows_equal_per_replica_calls():
    """R x slots rows in one call give each replica's rows bit for bit as
    R calls of ``slots`` rows do: ingest (fp32 and uint8 frames), scatter
    (fp32 and bf16 pools), downscale, block-SAD, and the gate's
    arithmetic."""
    for u8 in (False, True):
        _flattened_rows_case(u8)


def _flattened_rows_case(u8):
    R, S, H, m, g = 4, 4, 64, 24, 16
    frames = _rows((R * S, H, H, 3), 0, np.uint8 if u8 else np.float32)
    refs = _rows((R * S, g, g, 3), 1)
    admit = torch.from_numpy(np.random.default_rng(2).random(R * S) < 0.5)

    def per_replica(fn, *args):
        outs = [fn(*(a[r * S:(r + 1) * S] for a in args)) for r in range(R)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)

    def same(a, b):
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def ingest(f, r):
        return vo.ingest_frame(f, r, model_res=m, gate_res=g, block=8)
    model, small, scores = ingest(frames, refs)
    same((model, small, scores), per_replica(ingest, frames, refs))
    same(vo.downscale(frames, m), per_replica(
        lambda f: vo.downscale(f, m), frames))
    same(vo.block_sad(refs, small), per_replica(vo.block_sad, refs, small))
    for pool in (torch.float32, torch.bfloat16):
        batch = _rows((R * S, m, m, 3), 3).to(pool)
        same(vo.scatter_admit(batch, model, refs, small, admit),
             per_replica(vo.scatter_admit, batch, model, refs, small, admit))
    if not u8:
        for kernels in (False, True):
            def score(r, f):
                return gate_scores(r, f, gate_res=g, block=8,
                                   use_kernels=kernels)
            same(score(refs, frames), per_replica(score, refs, frames))


def test_stacked_forward_equals_per_replica_forwards():
    """One grouped convolution a layer over stacked weights: every
    replica's flags equal its own forward's, outputs within TIGHT, at the
    base and high tiers' resolutions.  The detector head's weights are
    scaled up so that hazard flags fire (at random weights no anchor
    passes the 0.5 score)."""
    for res in (32, 48):
        _stacked_forward_case(res)


def _stacked_forward_case(res):
    R, B = 3, 8
    dc, pc = detector_config(res), pose_config(res)
    dps, pps = [], []
    for r in range(R):
        gen = torch.Generator().manual_seed(r)
        dp = V.init_detector(dc, gen, "cpu")
        dp["head"]["w"] = dp["head"]["w"] * 100.0
        dps.append(dp)
        pps.append(V.init_pose(pc, gen, "cpu"))
    frames = _rows((R, B, 64, 64, 3), 7)
    flags, det = V.analyse_outer_stacked(dc, V.stack_params(dps), frames)
    dist, kp = V.analyse_inner_stacked(pc, V.stack_params(pps), frames)
    fired = [0, 0]
    for r in range(R):
        rows = slice(r * B, (r + 1) * B)
        f1, d1 = V.analyse_outer(dc, dps[r], frames[r])
        g1, k1 = V.analyse_inner(pc, pps[r], frames[r])
        assert torch.equal(flags[r], f1) and torch.equal(dist[r], g1)
        for key in ("score", "cy", "cx", "h", "w"):
            torch.testing.assert_close(det[key][rows], d1[key], **TIGHT)
        for key in ("y", "x", "score"):
            torch.testing.assert_close(kp[key][rows], k1[key], **TIGHT)
        fired[0] += int(f1.any(dim=1).sum())
        fired[1] += int(g1.sum())
    assert fired[0] > 0 and fired[1] > 0         # both flags non-vacuous
