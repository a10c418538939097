"""Port parity: repro_torch.core.runtime (the paper's EDA master runtime)
vs the reference's ``core/runtime.py`` (CPU).

``SimExecutor`` runs of both packages must give equal ledgers field for
field (every ``SegmentRecord`` as a dict, exact floats), equal merged
``results`` and equal ``esd_values()``, on the configurations of
``tests/test_core.py``'s runtime claims (1-5, the segmented merge, the
energy ordering) and on ``examples/quickstart.py``'s case study (3 phones,
2 s videos, 50 pairs), whose ledger digest is pinned here and in
``chip_smoke.py``.  The claims themselves are then asserted on the port's
runs.  A fixed-cost vision executor runs each package's detector and pose
models on the same 64 px ``DashCamSource`` frames with converted weights
(processing time n x 5 ms, so the schedule cannot depend on wall time):
equal ledgers and equal merged flags.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.config import EDAConfig as JEDAConfig
from repro.configs.eda_vision import detector_config as jdetector_config
from repro.configs.eda_vision import pose_config as jpose_config
from repro.core.runtime import PAPER_DEVICES as JPAPER_DEVICES
from repro.core.runtime import EDARuntime as JEDARuntime
from repro.data import DashCamSource as JDashCamSource
from repro.models import vision as JV
from repro_torch import PAPER_DEVICES, EDARuntime
from repro_torch import convert
from repro_torch.config import EDAConfig
from repro_torch.configs.eda_vision import detector_config, pose_config
from repro_torch.core.runtime import ledger_digest
from repro_torch.data import DashCamSource
from repro_torch.models import vision as TV

PHONES = ("pixel3", "pixel6", "oneplus8", "findx2pro")
THREE = ("findx2pro", ("pixel6", "oneplus8"))
# examples/quickstart.py's case study: findx2pro master + pixel6 +
# oneplus8, 2 s granularity, segmentation, dynamic ESD, 50 pairs
CASE_STUDY_DIGEST = ("08acd776db08d50cdecf32f23f5f80e9"
                     "7a739924056e020b4d83ab290392c822")
# (master, workers, granularity, simulated download, segmentation, pairs):
# the runs of tests/test_core.py's claims
CASES = {
    **{f"claim1-{p}": (p, (), 1.0, 0.35, False, 150) for p in PHONES},
    "claim2": ("pixel6", ("pixel3",), 1.0, 0.35, False, 150),
    **{f"claim3-{p}": (p, (), 2.0, 0.0, False, 150)
       for p in ("pixel3", "pixel6")},
    "claim4": (*THREE, 2.0, 0.0, True, 150),
    "claim5": (*THREE, 2.0, 0.0, True, 60),
    "merge": (*THREE, 2.0, 0.0, True, 40),
}


def _run(jax_side, master, workers=(), gran=1.0, simdl=0.35, seg=False,
         n=150):
    """tests/test_core.py's ``_run`` on either package."""
    R, D, E = ((JEDARuntime, JPAPER_DEVICES, JEDAConfig) if jax_side else
               (EDARuntime, PAPER_DEVICES, EDAConfig))
    m = dataclasses.replace(D[master], dynamic_esd=True)
    ws = [dataclasses.replace(D[w], dynamic_esd=True) for w in workers]
    rt = R(eda=E(granularity_s=gran, simulate_download_s=simdl,
                 segmentation=seg, dynamic_esd=True), master=m, workers=ws)
    return rt, rt.run(n)


def _same(t, j):
    """Two (runtime, ledger) pairs agree field for field."""
    (trt, tled), (jrt, jled) = t, j
    assert ([dataclasses.asdict(r) for r in tled.records]
            == [dataclasses.asdict(r) for r in jled.records])
    assert trt.results == jrt.results
    assert trt.esd_values() == jrt.esd_values()
    assert not trt._pending and not jrt._pending
    assert ([dataclasses.asdict(s) for s in tled.summarise()]
            == [dataclasses.asdict(s) for s in jled.summarise()])
    assert ledger_digest(tled) == ledger_digest(jled)


@pytest.mark.parametrize("case", list(CASES))
def test_sim_ledgers_equal_reference(case):
    args = CASES[case]
    _same(_run(False, *args), _run(True, *args))


def test_paper_claims_hold_on_the_port():
    """tests/test_core.py's claims 1-5, the segmented merge and the energy
    ordering, asserted on the port's runs."""
    need, power = {}, {}
    for name in PHONES:                                       # claim 1
        rt, led = _run(False, name)
        need[name] = rt.esd_values()[name] > 1.05
        assert led.mean_turnaround_ms() <= 1050
        power[name] = led.summarise()[0].avg_power_mw
    assert need["pixel3"] and need["pixel6"]
    assert not need["oneplus8"] and not need["findx2pro"]
    assert power["findx2pro"] > power["oneplus8"]             # energy
    assert power["oneplus8"] > 2 * max(power["pixel6"], power["pixel3"])
    rt, _ = _run(False, "pixel6", ["pixel3"])                 # claim 2
    assert rt.esd_values()["pixel6"] <= 1.05 < rt.esd_values()["pixel3"]
    for name in ("pixel3", "pixel6"):                         # claim 3
        s1 = _run(False, name)[1].summarise()[0].skip_rate
        s2 = _run(False, name, gran=2.0, simdl=0.0)[1].summarise()[0]
        assert s2.skip_rate <= s1 + 1e-9
    rt, led = _run(False, *THREE, gran=2.0, simdl=0.0, seg=True)  # claim 4
    assert all(v <= 1.05 for v in rt.esd_values().values())
    assert led.mean_turnaround_ms() <= 2000
    for r in led.records:                                     # claim 5
        parts = (r.download_ms + r.transfer_ms + r.return_ms
                 + r.processing_ms + r.wait_ms + r.overhead_ms)
        assert abs(parts - r.turnaround_ms) < 1e-6
    rt, _ = _run(False, *THREE, gran=2.0, simdl=0.0, seg=True, n=40)
    assert len(rt.results) == 80 and not rt._pending          # merge


def _case_study(jax_side):
    R, D, E = ((JEDARuntime, JPAPER_DEVICES, JEDAConfig) if jax_side else
               (EDARuntime, PAPER_DEVICES, EDAConfig))
    rt = R(eda=E(granularity_s=2.0, segmentation=True, dynamic_esd=True),
           master=dataclasses.replace(D["findx2pro"], dynamic_esd=True),
           workers=[dataclasses.replace(D["pixel6"], dynamic_esd=True),
                    dataclasses.replace(D["oneplus8"], dynamic_esd=True)])
    return rt, rt.run(50)


def test_case_study_ledger_digest_is_pinned():
    """quickstart's case study: the two packages' ledgers equal, their
    digest the pinned one, which ``chip_smoke.py`` checks on the card's
    machine too."""
    port, ref = _case_study(False), _case_study(True)
    _same(port, ref)
    assert ledger_digest(port[1]) == CASE_STUDY_DIGEST
    assert len(port[0].results) == 100
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.CASE_STUDY_DIGEST == CASE_STUDY_DIGEST


class _FixedCostVision:
    """Runs one package's detector / pose models on the segment's frames
    and charges n x 5 ms (``tests/test_integration.py``'s RealExecutor
    with the wall clock taken out)."""

    def __init__(self, jax_side, source):
        self.jax_side, self.source = jax_side, source
        key = jax.random.key(0)
        self.cfgs = ((jdetector_config(64), jpose_config(64)) if jax_side
                     else (detector_config(64), pose_config(64)))
        dp = JV.init_detector(jdetector_config(64), key)
        pp = JV.init_pose(jpose_config(64), key)
        if jax_side:
            self.params = (dp, pp)
        else:
            self.params = (
                convert.detector_from_jax(jax.tree.map(np.asarray, dp),
                                          device="cpu"),
                convert.pose_from_jax(jax.tree.map(np.asarray, pp),
                                      device="cpu"))

    def frame_cost_ms(self, device, stream, frames=30):
        return 5.0

    def run(self, device, seg, budget):
        n = min(budget, seg.frame_count)
        if n == 0:
            return 0, 0.0, {}
        pair = self.source.pair(int(seg.video_id.split("_")[0][1:]))
        clip = (pair.outer if seg.stream == "outer" else
                pair.inner)[seg.frame_start: seg.frame_start + n]
        V = JV if self.jax_side else TV
        x = clip if self.jax_side else torch.as_tensor(clip)
        if seg.stream == "outer":
            flags, _ = V.analyse_outer(self.cfgs[0], self.params[0], x)
            flags = np.asarray(flags).any(axis=1)
        else:
            flags, _ = V.analyse_inner(self.cfgs[1], self.params[1], x)
            flags = np.asarray(flags)
        return n, n * 5.0, {i: {"danger": bool(flags[i])} for i in range(n)}


def _vision_run(jax_side):
    Src, R, D, E = ((JDashCamSource, JEDARuntime, JPAPER_DEVICES,
                     JEDAConfig) if jax_side else
                    (DashCamSource, EDARuntime, PAPER_DEVICES, EDAConfig))
    src = Src(granularity_s=1.0, fps=6, res=64, seed=3)
    rt = R(eda=E(granularity_s=1.0, fps=6, simulate_download_s=0.35,
                 segmentation=True, dynamic_esd=True),
           master=D["findx2pro"], workers=[D["pixel6"], D["oneplus8"]],
           executor=_FixedCostVision(jax_side, src))
    return rt, rt.run(6)


@pytest.fixture(scope="module")
def vision_runs():
    """(port, reference) runs of the fixed-cost vision executor: the
    reference's jitted models compile once a segment length, so the runs
    sit here, outside the per-test time budget."""
    return _vision_run(False), _vision_run(True)


def test_vision_executor_ledgers_and_flags_equal_reference(vision_runs):
    """tests/test_integration.py's fixture (6 pairs of 64 px frames at 6
    fps, three phones, segmentation, dynamic ESD) through both runtimes
    and both packages' models: equal ledgers and merged flags."""
    src, jsrc = (DashCamSource(1.0, 6, 64, 3), JDashCamSource(1.0, 6, 64, 3))
    assert np.array_equal(src.pair(2).inner, np.asarray(jsrc.pair(2).inner))
    port, ref = vision_runs
    _same(port, ref)
    assert len(port[0].results) == 12
    assert any(r["danger"] for v in port[0].results.values()
               for r in v.values())
