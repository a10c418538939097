"""``repro_torch.launch.dryrun`` on small fake worlds, and the kernels'
refusal of a DTensor.

Every fake world runs in a subprocess (a module fixture runs one per
arch, three at a time), so no process group reaches a test worker.  Each arch's
reduced config runs its four cells, at small sizes of the same kinds (a
``SHAPES`` entry's name keeps its skip rule), on a (2, 2) ``("data",
"model")`` and a (2, 2, 2) ``("pod", "data", "model")`` mesh: every cell is
``ok`` and the skips are the reference's.  The counted FLOPs of a train
cell are exactly linear in depth (what the reference's depth calibration
assumes of XLA's count, here with nothing to calibrate) and sit within
[1.0, 1.6] x 6ND for remat none; a tensor-parallel cell counts collective
bytes.  The command line writes the reference's JSON fields (its cell with
``attn_batch_sharded``, so ``RunOpts.attn_specs`` places q, k and v).
"""
import json
import os
import subprocess
import sys

import pytest

from repro.config import SHAPES as JSHAPES
from repro.config import cell_skip_reason as jcell_skip_reason
from repro.config import get_arch as jget_arch
from repro_torch.configs import ASSIGNED

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL = {"train_4k": (64, 8), "prefill_32k": (64, 8),
         "decode_32k": (64, 8), "long_500k": (128, 1)}
MESHES = [("single", (2, 2)), ("multi", (2, 2, 2))]

_CELLS = """
import dataclasses, json, sys
from repro_torch.config import SHAPES, ShapeConfig, get_arch
from repro_torch.launch import dryrun
arch, small, meshes = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = []
for mesh, dims in meshes:
    for name, (S, B) in small.items():
        shape = ShapeConfig(name, S, B, SHAPES[name].kind)
        r = dryrun.run_cell(arch, name, mesh, {}, None, reduced=True,
                            mesh_shape=tuple(dims), shape=shape)
        out.append({k: r.get(k) for k in ("arch", "shape", "mesh", "ok",
                                           "skip", "error", "cost",
                                           "collective_bytes")})
print("CELLS " + json.dumps(out))
"""

_LINEAR = """
import dataclasses, json
from repro_torch.config import ShapeConfig, get_arch
from repro_torch.launch import dryrun
cfg = get_arch("starcoder2-3b").reduced()
shape = ShapeConfig("train_4k", 64, 8, "train")
res = {}
for L in (2, 3, 4):
    r = dryrun.run_cell("starcoder2-3b", "train_4k", "single",
                        {"remat": "none"}, None, mesh_shape=(2, 2),
                        cfg=dataclasses.replace(cfg, num_layers=L),
                        shape=shape)
    assert r["ok"], r["error"]
    res[L] = {"cost": r["cost"], "coll": r["collectives"],
              "model_flops": r["roofline"]["model_flops"],
              "chips": r["chips"]}
print("LINEAR " + json.dumps(res))
"""

_REFUSE = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Replicate
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
from repro_torch.kernels import (decode_attention, flash_attention, mlstm,
                                 paged_attention, rglru)
from repro_torch.sharding.compat import make_device_mesh
mesh = make_device_mesh((1,), ("model",))
dt = lambda t: DTensor.from_local(t, mesh, [Replicate()], run_check=False)
B, S, H, D, C = 1, 4, 2, 16, 8
q, k, v = torch.zeros(B, S, H, D), torch.zeros(B, C, H, D), torch.zeros(B, C, H, D)
pos = torch.zeros(B, S, dtype=torch.int32)
kpos = torch.zeros(B, C, dtype=torch.int32)
kp, vp = torch.zeros(2, 4, H, D), torch.zeros(2, 4, H, D)
ppos = torch.zeros(2, 4, dtype=torch.int32)
tbl = torch.zeros(B, 2, dtype=torch.int32)
calls = {
  "paged_decode_attention": lambda: paged_attention.paged_decode_attention(
      dt(q[:, :1]), kp, vp, ppos, tbl, pos[:, :1]),
  "paged_flash_attention": lambda: paged_attention.paged_flash_attention(
      dt(q), kp, vp, ppos, tbl, pos),
  "flash_attention": lambda: flash_attention.flash_attention(
      dt(q), k, v, pos, kpos),
  "decode_attention": lambda: decode_attention.decode_attention(
      dt(q[:, :1]), k, v, pos[:, :1], kpos),
  "rglru_scan": lambda: rglru.rglru_scan(dt(torch.zeros(B, S, D)),
                                         torch.zeros(B, S, D)),
  "mlstm_chunkwise": lambda: mlstm.mlstm_chunkwise(
      dt(torch.zeros(B, H, S, D)), torch.zeros(B, H, S, D),
      torch.zeros(B, H, S, D), torch.zeros(B, H, S), torch.zeros(B, H, S)),
}
for name, call in calls.items():
    try:
        call()
    except TypeError as e:
        assert "a DTensor reached the hand kernel" in str(e), e
        assert name in str(e), (name, e)
        print("REFUSED", name)
    else:
        print("PASSED", name)
dist.destroy_process_group()
"""


def _spawn(code, *args):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, "-c", code, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _result(proc, tag, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [l for l in out.splitlines() if l.startswith(tag)][0]
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every arch's cells, the depth series and the CLI, three processes
    at a time (the suite's other workers share the machine)."""
    out = tmp_path_factory.mktemp("dryrun")
    jobs = [(arch, "CELLS", (_CELLS, arch, json.dumps(SMALL),
                              json.dumps(MESHES))) for arch in ASSIGNED]
    jobs.append(("linear", "LINEAR", (_LINEAR,)))
    jobs.append(("cli", None, (
        "from repro_torch.launch.dryrun import main; "
        "raise SystemExit(main())", "--reduced", "--arch", "starcoder2-3b",
        "--shape", "decode_32k", "--mesh", "single", "--out", str(out),
        "--set", "attn_batch_sharded=true")))
    res, running = {}, []
    try:
        while jobs or running:
            while jobs and len(running) < 3:
                key, tag, argv = jobs.pop(0)
                running.append((key, tag, _spawn(*argv)))
            key, tag, proc = running.pop(0)
            if tag is None:
                so, se = proc.communicate(timeout=600)
                res[key] = (proc.returncode, so, se, out)
            else:
                res[key] = _result(proc, tag)
    finally:
        for _, _, p in running:
            if p.poll() is None:
                p.kill()
    return res


@pytest.mark.parametrize("arch", ASSIGNED)
def test_reduced_cells_ok_and_skips_match(runs, arch):
    cells = runs[arch]
    assert len(cells) == 8
    for c in cells:
        want = jcell_skip_reason(jget_arch(arch), JSHAPES[c["shape"]])
        assert c["skip"] == want, c
        assert c["ok"], (c["mesh"], c["shape"], c["error"])
        if not c["skip"]:
            assert c["cost"]["flops"] > 0 and c["cost"]["bytes_accessed"] > 0


def test_counted_train_cost_is_exactly_linear_in_depth(runs):
    res = {int(k): v for k, v in runs["linear"].items()}
    for key in ("flops", "bytes_accessed"):
        d1 = res[3]["cost"][key] - res[2]["cost"][key]
        d2 = res[4]["cost"][key] - res[3]["cost"][key]
        assert d1 == d2 > 0, (key, d1, d2)
    for op in res[2]["coll"]:
        assert (res[3]["coll"][op] - res[2]["coll"][op]
                == res[4]["coll"][op] - res[3]["coll"][op]), op


def test_train_flops_within_1_to_1_6_of_6nd_and_tp_collectives(runs):
    for L, r in runs["linear"].items():
        ratio = r["cost"]["flops"] * r["chips"] / r["model_flops"]
        assert 1.0 <= ratio <= 1.6, (L, ratio)
        assert sum(r["coll"].values()) > 0        # TP over the model axis


def test_cli_writes_the_reference_fields(runs):
    rc, so, se, out = runs["cli"]
    assert rc == 0, se[-3000:]
    assert "dry-run complete; failures: 0" in so
    with open(out / "single__starcoder2-3b__decode_32k.json") as f:
        rec = json.load(f)
    for k in ("ok", "skip", "parallel", "memory_analytic", "cost",
              "collectives", "collective_bytes", "roofline"):
        assert k in rec, k
    assert rec["ok"] and rec["chips"] == 256
    assert rec["parallel"]["attn_batch_sharded"] == "True"   # attn_specs
    assert rec["roofline"]["hw"] == "NVIDIA H100 80GB HBM3"
    assert set(rec["collectives"]) == {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all",
                                       "collective-permute"}


def test_dtensor_into_kernels_5_to_10_raises():
    proc = _spawn(_REFUSE)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    refused = [l.split()[1] for l in out.splitlines()
               if l.startswith("REFUSED")]
    assert refused == ["paged_decode_attention", "paged_flash_attention",
                       "flash_attention", "decode_attention", "rglru_scan",
                       "mlstm_chunkwise"], out
