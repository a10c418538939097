"""Port parity: ``repro_torch.roofline.analysis`` and
``launch.presets.default_parallel`` vs the reference, the counterparts of
its seven ``tests/test_roofline.py`` cases.

The reference parses collective operand bytes from optimized HLO; the port
counts what runs (``CountMode``).  On a fake 16-rank world (a subprocess,
so no process group reaches the test worker) the same three collectives
as the reference's ``HLO_SAMPLE`` give its numbers: an all-gather of a
bf16 (128, 4096) shard 1,048,576 bytes, an all-reduce of f32[256] 1,024
bytes, a permute (the pipeline's ring shift) of the bf16 shard 1,048,576
bytes.  The FLOPs of a column- and a row-parallel product are counted on
each rank's local shards and equal hand counts.  ``model_flops`` and the
memory model equal the reference's for every arch and shape;
``default_parallel`` built with the reference's ``HW_V5E`` values equals
its ``ParallelConfig`` field for field in every cell of both meshes, and
with ``HW_H100`` every runnable cell's estimate fits 80 GB.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

from repro.config import SHAPES as JSHAPES
from repro.config import get_arch as jget_arch
from repro.configs import ASSIGNED
from repro.launch.presets import default_parallel as jdefault_parallel
from repro.roofline.analysis import HW_V5E
from repro.roofline.analysis import \
    estimate_memory_per_device as jestimate_memory
from repro.roofline.analysis import model_flops as jmodel_flops
from repro_torch.config import SHAPES, cell_skip_reason, get_arch
from repro_torch.launch.presets import default_parallel
from repro_torch.roofline.analysis import (HW_H100, HardwareSpec,
                                           analyse_counted,
                                           estimate_memory_per_device,
                                           model_flops, roofline_terms)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_FAKE_COUNTS = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
from repro_torch.roofline.analysis import CountMode, collective_bytes
from repro_torch.sharding.compat import make_device_mesh
from repro_torch.sharding.pipeline import _ring_shift
mesh = make_device_mesh((16,), ("d",))
x = DTensor.from_local(torch.zeros(128, 4096, dtype=torch.bfloat16), mesh,
                       [Shard(0)], run_check=False)
p = DTensor.from_local(torch.zeros(256), mesh, [Partial()], run_check=False)
c = CountMode()
with c:
    x.redistribute(mesh, [Replicate()])
    p.redistribute(mesh, [Replicate()])
    _ring_shift(x.to_local(), mesh.get_group())
per = collective_bytes(c, per_op=True)
print("COLL", per["all-gather"], per["all-reduce"], per["collective-permute"],
      per["all-to-all"], per["reduce-scatter"], collective_bytes(c))
B, D, F = 64, 256, 512
X = DTensor.from_local(torch.ones(B, D), mesh, [Replicate()], run_check=False)
Wc = DTensor.from_local(torch.ones(D, F // 16), mesh, [Shard(1)],
                        run_check=False)
Xr = DTensor.from_local(torch.ones(B, D // 16), mesh, [Shard(1)],
                        run_check=False)
Wr = DTensor.from_local(torch.ones(D // 16, F), mesh, [Shard(0)],
                        run_check=False)
for name, a, b in (("col", X, Wc), ("row", Xr, Wr)):
    for rep in range(2):                # DTensor's shape inference: once
        c = CountMode()
        with c:
            y = a @ b
        print("FLOPS", name, rep, c.flops, tuple(y.to_local().shape),
              y.placements)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def fake_counts():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _FAKE_COUNTS],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_collective_bytes_reproduce_hlo_sample(fake_counts):
    line = [l for l in fake_counts.splitlines() if l.startswith("COLL")][0]
    ag, ar, cp, a2a, rs, total = map(int, line.split()[1:])
    assert ag == 128 * 4096 * 2 == 1_048_576     # bf16 (128, 4096) shard
    assert ar == 256 * 4 == 1_024                # f32[256]
    assert cp == 128 * 4096 * 2                  # the ring shift's send
    assert a2a == 0 and rs == 0
    assert total == ag + ar + cp


def test_local_flops_of_column_and_row_parallel_products(fake_counts):
    B, D, F, n = 64, 256, 512, 16
    want = {"col": 2 * B * D * (F // n), "row": 2 * B * (D // n) * F}
    got = [l.split() for l in fake_counts.splitlines()
           if l.startswith("FLOPS")]
    assert len(got) == 4
    for _, name, rep, flops, *_rest in got:
        assert int(flops) == want[name], (name, rep, flops)
    assert "Partial" in [l for l in fake_counts.splitlines()
                         if "FLOPS row" in l][0]


def test_roofline_terms_at_the_h100_peaks():
    c, m, k = roofline_terms(989e12, 3.35e12, 450e9, 256, HW_H100)
    assert abs(c - 1.0) < 1e-9 and abs(m - 1.0) < 1e-9 and abs(k - 1.0) < 1e-9
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.link_bw,
            HW_H100.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)


def test_model_flops_and_memory_model_equal_reference():
    for arch in ASSIGNED:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        assert cfg.param_counts() == jcfg.param_counts()
        for name in SHAPES:
            assert model_flops(cfg, SHAPES[name]) == jmodel_flops(
                jcfg, JSHAPES[name])
            for tp, dp, fsdp, accum, remat, sdt in (
                    (16, 16, False, 1, "full", "float32"),
                    (16, 32, True, 4, "none", "bfloat16"),
                    (1, 1, False, 2, "dots", "float32")):
                kw = dict(tp=tp, dp=dp, fsdp=fsdp, grad_accum=accum,
                          remat=remat, opt_state_dtype=sdt)
                assert estimate_memory_per_device(cfg, SHAPES[name], **kw) \
                    == jestimate_memory(jcfg, JSHAPES[name], **kw), (arch,
                                                                    name, kw)


def test_moe_uses_active_params():
    cfg = get_arch("deepseek-v2-236b")
    total, active = cfg.param_counts()
    fl = model_flops(cfg, SHAPES["train_4k"])
    assert fl == 6.0 * active * 256 * 4096
    assert fl < 6.0 * total * 256 * 4096 * 0.2


def test_default_parallel_equals_reference_with_v5e_values():
    v5e = HardwareSpec(HW_V5E.name, peak_flops=HW_V5E.peak_flops,
                       hbm_bw=HW_V5E.hbm_bw, link_bw=HW_V5E.ici_bw,
                       hbm_bytes=HW_V5E.hbm_bytes)
    n = 0
    for arch in ASSIGNED:
        for name in SHAPES:
            for multi in (False, True):
                got = default_parallel(get_arch(arch), SHAPES[name],
                                       multi_pod=multi, hw=v5e)
                want = jdefault_parallel(jget_arch(arch), JSHAPES[name],
                                         multi_pod=multi)
                assert vars(got) == vars(want), (arch, name, multi)
                n += cell_skip_reason(get_arch(arch), SHAPES[name]) is None
    assert n == 68
    # the reference's two large cells at 16 GB, and the same at 80 GB
    big = default_parallel(get_arch("command-r-plus-104b"),
                           SHAPES["train_4k"], hw=v5e)
    assert (big.grad_accum, big.opt_state_dtype) == (16, "float32")
    for arch, want in (("command-r-plus-104b", (2, "float32")),
                       ("deepseek-v2-236b", (1, "float32"))):
        par = default_parallel(get_arch(arch), SHAPES["train_4k"])
        assert (par.grad_accum, par.opt_state_dtype) == want, arch


def test_every_runnable_cell_fits_the_h100():
    for arch in ASSIGNED:
        cfg = get_arch(arch)
        for name in SHAPES:
            if cell_skip_reason(cfg, SHAPES[name]):
                continue
            for multi in (False, True):
                par = default_parallel(cfg, SHAPES[name], multi_pod=multi)
                est = estimate_memory_per_device(
                    cfg, SHAPES[name], tp=16, dp=32 if multi else 16,
                    fsdp=par.fsdp, grad_accum=par.grad_accum,
                    remat=par.remat, opt_state_dtype=par.opt_state_dtype)
                assert est["total"] < HW_H100.hbm_bytes, (arch, name, multi,
                                                          est)
    # the large dense model does not fit without FSDP at 16 GB, as in the
    # reference's test
    m2 = estimate_memory_per_device(get_arch("command-r-plus-104b"),
                                    SHAPES["train_4k"], tp=16, dp=16,
                                    fsdp=False, grad_accum=16, remat="full")
    assert m2["total"] > HW_V5E.hbm_bytes


def test_analyse_counted_report_uses_its_hardware():
    cfg = get_arch("starcoder2-3b")
    coll = {"all-gather": 1e9, "all-reduce": 1e9, "reduce-scatter": 0,
            "all-to-all": 0, "collective-permute": 0}
    rep = analyse_counted("starcoder2-3b", SHAPES["decode_32k"], "single",
                          256, {"flops": 1e12, "bytes accessed": 1e12}, coll,
                          cfg)
    assert rep.dominant in ("compute", "memory", "collective")
    assert rep.step_s == max(rep.compute_s, rep.memory_s, rep.collective_s)
    assert rep.coll_bytes == 3e9                 # all-reduce counts twice
    assert rep.collective_s == 3e9 / HW_H100.link_bw
    slow = dataclasses.replace(HW_H100, peak_flops=HW_H100.peak_flops / 2)
    rep2 = analyse_counted("starcoder2-3b", SHAPES["decode_32k"], "single",
                           256, {"flops": 1e12, "bytes accessed": 1e12},
                           coll, cfg, hw=slow)
    assert rep2.hw is slow
    # the useful-FLOPs share at the report's own peak
    assert abs(rep2.roofline_fraction / rep.roofline_fraction
               - 2 * rep.step_s / rep2.step_s) < 1e-9
    assert rep.row()["arch"] == "starcoder2-3b"
