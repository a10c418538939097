"""Port parity on gloo process groups: the counterparts of the reference's
six ``tests/test_sharding.py`` cases (which run on a forced 8-device host
mesh), on four CPU ranks (``torch_dist_common.run_ranks``).

- a TP/DP train step on (2, 2) and (1, 4) ``("data", "model")`` meshes,
  from the reference's parameters: loss within rtol 1e-5 of the port's
  unsharded step and of the reference's unsharded loss, parameters within
  2e-3 of the unsharded step (the reference's tolerances); the same for
  xlstm-350m (its blocks run on each rank's rows) and granite-moe (its
  MoE layers on every token) on (2, 2);
- granite-moe ``fsdp+ep``: the specs shard over both axes and the forward
  runs sharded, equal to the unsharded forward;
- each rank's local slice equals the slice JAX's ``NamedSharding`` gives
  that mesh coordinate (the reference side in a subprocess with four
  forced host devices), multi-axis dims included;
- GPipe over four stages equals the sequential stack (S 4, L 8, M 6, B 2,
  D 16, 1e-5);
- ``int8_psum`` equals the reference's on the same numpy input, bit for
  bit (the reference under ``jax.vmap`` with ``axis_name="pod"``);
- the int8 cross-pod step's gradients are within max|g| / 127 of the
  uncompressed ones on a (2, 1, 2) ``("pod", "data", "model")`` mesh;
- a checkpoint saved from (2, 2) restores onto (4, 1) and (1, 4) bit for
  bit.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.sharding.collectives import int8_psum as jint8_psum
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.config import ParallelConfig, get_arch
from repro_torch.models import transformer as TT
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

from torch_dist_common import SRC, run_ranks
from torch_train_common import (flat, np_batch, port_params, ref_params,
                                torch_batch)

ARCH = "starcoder2-3b"
B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_REFS = {}


def _reference_of(arch):
    """The reference's reduced ``arch`` parameters and batch, and its
    unsharded step's loss on them (once an arch)."""
    if arch not in _REFS:
        from repro.config import ParallelConfig as JParallelConfig
        cfg = jget_arch(arch).reduced()
        params = ref_params(cfg)
        batch = np_batch(cfg, B, S)
        step = jax.jit(jmake_train_step(cfg, JParallelConfig(),
                                        JAdamWConfig(**OPT)))
        jp = jax.tree.map(jnp.asarray, params)
        _, _, m = step(jp, jinit_opt_state(jp),
                       {k: jnp.asarray(v) for k, v in batch.items()})
        _REFS[arch] = (params, batch, float(m["loss"]))
    return _REFS[arch]


@pytest.fixture(scope="module")
def reference():
    return _reference_of(ARCH)


@pytest.fixture(scope="module")
def references():
    """Every arch of the train-step cases, before the first runs."""
    return {a: _reference_of(a) for a in (ARCH, "xlstm-350m",
                                          "granite-moe-1b-a400m")}


def _dump(tmp_path, **objs):
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(objs, f)


_LOAD = """
import pickle
from repro_torch import convert
from repro_torch.config import ParallelConfig, ShapeConfig, get_arch
from repro_torch.sharding import rules
from repro_torch.sharding.compat import make_device_mesh
from repro_torch.models import transformer as T
with open(os.path.join(os.path.dirname(out), "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
"""


@pytest.mark.parametrize("arch,shape", [
    (ARCH, (2, 2)), (ARCH, (1, 4)),
    ("xlstm-350m", (2, 2)),               # blocks on each rank's rows
    ("granite-moe-1b-a400m", (2, 2))])    # MoE on every token
def test_tp_dp_train_step_matches_unsharded(tmp_path, references, arch,
                                            shape):
    np_params, np_b, ref_loss = references[arch]
    _dump(tmp_path, params=np_params, batch=np_b, shape=shape)
    out, _ = run_ranks(tmp_path, 4, _LOAD + f"""
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
cfg = get_arch({arch!r}).reduced()
par = ParallelConfig()
mesh = make_device_mesh(inp["shape"], ("data", "model"))
params = convert.transformer_from_jax(inp["params"], cfg, "cpu")
specs = rules.param_pspecs(cfg, par, mesh)
dparams = rules.distribute(params, mesh, specs)
assert any(p.placements != dparams["embed"]["tokens"].placements or True
           for p in [dparams["embed"]["tokens"]])
bspecs = rules.batch_pspecs(cfg, ShapeConfig("t", {S}, {B}, "train"),
                            par, mesh)
batch = rules.distribute({{k: torch.as_tensor(v)
                          for k, v in inp["batch"].items()}}, mesh, bspecs)
step = make_train_step(cfg, par, AdamWConfig(**{OPT!r}), mesh=mesh)
p2, _, m = step(dparams, init_opt_state(dparams), batch)
from repro_torch.models.param import tree_map
whole = tree_map(lambda t: t.full_tensor().numpy(), p2)
if rank == 0:
    with open(os.path.join(out, "res.pkl"), "wb") as f:
        pickle.dump({{"loss": float(m["loss"]), "params": whole,
                     "sharded": sum(any(not p.is_replicate()
                                        for p in t.placements)
                                    for t in __import__("repro_torch").models
                                    .param.tree_leaves(dparams))}}, f)
""")
    with open(out / "res.pkl", "rb") as f:
        res = pickle.load(f)
    assert res["sharded"] > 0
    cfg = get_arch(arch).reduced()
    params = port_params(cfg, np_params)
    step = make_train_step(cfg, ParallelConfig(), AdamWConfig(**OPT))
    want, _, m = step(params, init_opt_state(params), torch_batch(np_b))
    np.testing.assert_allclose(res["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(res["loss"], ref_loss, rtol=1e-5)
    for (path, a), (_, b) in zip(flat(res["params"]), flat(want)):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-3, atol=2e-3,
                                   err_msg=path)


def test_fsdp_ep_specs_shard_and_forward_runs(tmp_path):
    """granite-moe ``fsdp+ep``: experts over ``model``, d_model over
    ``data``; the sharded forward equals the unsharded one."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32))
    want, _, _ = TT.forward(cfg, params, tokens)
    _dump(tmp_path, params=params, tokens=tokens)
    out, _ = run_ranks(tmp_path, 4, _LOAD + """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.models.param import tree_leaves
cfg = get_arch("granite-moe-1b-a400m").reduced()
par = ParallelConfig(fsdp=True, ep=True)
mesh = make_device_mesh((2, 2), ("data", "model"))
specs = rules.param_pspecs(cfg, par, mesh)
flat = [str(s) for s in tree_leaves(specs)]
assert any("model" in s for s in flat) and any("data" in s for s in flat)
moe = specs["layers"][0]["moe"]
assert moe["wi"][0] == "model", moe          # experts over model (EP)
params = rules.distribute(inp["params"], mesh, specs)
tokens = rules.distribute({"t": inp["tokens"]}, mesh,
                          {"t": rules.PartitionSpec(("data",), None)})["t"]
with implicit_replication():
    logits, _, _ = T.forward(cfg, params, tokens)
assert tuple(logits.shape) == (4, 8, cfg.vocab_size)
whole = logits.full_tensor()
if rank == 0:
    torch.save(whole, os.path.join(out, "logits.pt"))
""")
    got = torch.load(out / "logits.pt")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


_JAX_SLICES = """
import json, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.sharding.compat import make_mesh
cases = json.loads(sys.argv[1])
out = []
for sizes, names, shape, spec in cases:
    mesh = make_mesh(tuple(sizes), tuple(names))
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    coords = {}
    for pos, d in __import__("numpy").ndenumerate(mesh.devices):
        coords[d.id] = list(pos)
    out.append([[coords[d.id], [[s.start, s.stop] for s in sl]]
                for d, sl in idx.items()])
print(json.dumps(out))
"""


@pytest.mark.parametrize("sizes,names", [
    ((2, 2), ("data", "model")),
    ((2, 2, 1), ("pod", "data", "model"))])
def test_local_slices_equal_reference_slices(tmp_path, sizes, names):
    """Each rank's local tensor is the slice JAX's ``NamedSharding``
    assigns that mesh coordinate, for dims over one axis and over two
    (``("pod", "data")``, ``("data", "model")``: DTensor splits them in
    mesh order, as JAX does)."""
    shape = [8, 4, 6, 4]
    data = [a for a in names if a != "model"]
    specs = [[data, None, "model", None], [None, data + ["model"], None, None],
             [None, None, None, None], ["model", None, None, data]]
    if len(data) == 1:
        specs.append([[data[0], "model"], None, None, None])
    cases = [[list(sizes), list(names), shape, s] for s in specs]
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    import json
    proc = subprocess.run([sys.executable, "-c", _JAX_SLICES,
                           json.dumps(cases)], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    _dump(tmp_path, sizes=sizes, names=names, shape=shape, specs=specs)
    out, _ = run_ranks(tmp_path, 4, _LOAD + """
full = torch.arange(int(np.prod(inp["shape"]))).reshape(inp["shape"])
mesh = make_device_mesh(inp["sizes"], tuple(inp["names"]))
res = []
for spec in inp["specs"]:
    spec = rules.PartitionSpec(*[tuple(e) if isinstance(e, list) else e
                                 for e in spec])
    t = rules.distribute({"x": full}, mesh, {"x": spec})["x"]
    res.append(t.to_local().numpy())
np.save(os.path.join(out, f"r{rank}.npy"), np.stack(
    [r.reshape(-1)[:1] for r in res]))
with open(os.path.join(out, f"r{rank}.pkl"), "wb") as f:
    pickle.dump({"coord": mesh.get_coordinate(), "local": res}, f)
""")
    full = np.arange(int(np.prod(shape))).reshape(shape)
    seen = 0
    for r in range(4):
        with open(out / f"r{r}.pkl", "rb") as f:
            got = pickle.load(f)
        for case, local in zip(ref, got["local"]):
            want = [sl for coord, sl in case if coord == list(got["coord"])]
            assert len(want) == 1
            idx = tuple(slice(a, b) for a, b in want[0])
            np.testing.assert_array_equal(local, full[idx])
            seen += 1
    assert seen == 4 * len(specs)


def test_pipeline_equals_sequential_stack(tmp_path):
    """GPipe over a four-rank ``stage`` mesh == the layers applied in
    order (the reference's S 4, L 8, M 6, B 2, D 16, 1e-5)."""
    Sg, L, M, Bm, D = 4, 8, 6, 2, 16
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((M, Bm, D)).astype(np.float32)
    _dump(tmp_path, ws=ws, xs=xs)
    out, _ = run_ranks(tmp_path, 4, _LOAD + f"""
from repro_torch.sharding.pipeline import (bubble_fraction, make_pipeline,
                                           stage_split)
mesh = make_device_mesh(({Sg},), ("stage",))

def stage_fn(w_stack, x):
    for w in w_stack:
        x = torch.tanh(x @ w)
    return x

piped = make_pipeline(stage_fn, mesh, "stage")
got = piped(stage_split({{"w": torch.from_numpy(inp["ws"])}}, {Sg})["w"],
            torch.from_numpy(inp["xs"]))
assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-9
np.save(os.path.join(out, f"y{{rank}}.npy"), got.numpy())
""")
    want = xs.copy()
    for i in range(L):
        want = np.tanh(want @ ws[i])
    for r in range(Sg):
        np.testing.assert_allclose(np.load(out / f"y{r}.npy"), want,
                                   rtol=1e-5, atol=1e-5)


def test_int8_psum_equals_reference(tmp_path):
    """Four ranks' int8 all-reduce mean == the reference's ``int8_psum``
    under ``jax.vmap`` over a ``pod`` axis, bit for bit, and within
    max|x| / 127 of the exact mean."""
    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda a: jint8_psum(a, "pod"),
                               axis_name="pod")(jnp.asarray(x)))
    _dump(tmp_path, x=x)
    out, _ = run_ranks(tmp_path, 4, _LOAD + """
from repro_torch.sharding.collectives import int8_psum
got = int8_psum(torch.from_numpy(inp["x"][rank]))
np.save(os.path.join(out, f"g{rank}.npy"), got.numpy())
""")
    for r in range(4):
        got = np.load(out / f"g{r}.npy")
        np.testing.assert_array_equal(got, want[r])
        assert np.abs(got - x.mean(0)).max() <= np.abs(x).max() / 127 + 1e-6


def test_compressed_step_within_int8_bound(tmp_path, reference):
    """``compress_grads`` on a (2, 2) ``("pod", "model")`` mesh (two pods
    of two tensor-parallel ranks): each leaf's gradient within max|g| /
    127 of the uncompressed mean, g the pods' gradients (the port's
    unsharded gradients of each pod's half of the batch, which the
    sharded step equals); the compressed step runs."""
    np_params, np_b, _ = reference
    _dump(tmp_path, params=np_params, batch=np_b)
    out, _ = run_ranks(tmp_path, 4, _LOAD + f"""
from repro_torch.models.param import tree_map
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
from repro_torch.train.train_step import make_compressed_loss_and_grad
from torch.distributed.tensor.experimental import implicit_replication
cfg = get_arch({ARCH!r}).reduced()
par = ParallelConfig(data_axes=("pod",), compress_grads=True)
mesh = make_device_mesh((2, 2), ("pod", "model"))
params = rules.distribute(
    convert.transformer_from_jax(inp["params"], cfg, "cpu"), mesh,
    rules.param_pspecs(cfg, par, mesh))
batch = rules.distribute(
    {{k: torch.as_tensor(v) for k, v in inp["batch"].items()}}, mesh,
    rules.batch_pspecs(cfg, ShapeConfig("t", {S}, {B}, "train"), par, mesh))
with implicit_replication():
    loss, comp, _ = make_compressed_loss_and_grad(cfg, par, mesh)(
        params, batch)
comp = tree_map(lambda g: g.full_tensor().numpy(), comp)
step = make_train_step(cfg, par, AdamWConfig(lr=1e-3, warmup_steps=1),
                       mesh=mesh)
_, _, m = step(params, init_opt_state(params), batch)
if rank == 0:
    with open(os.path.join(out, "res.pkl"), "wb") as f:
        pickle.dump({{"grads": comp, "loss": float(loss),
                     "step_loss": float(m["loss"]),
                     "gnorm": float(m["grad_norm"])}}, f)
""")
    with open(out / "res.pkl", "rb") as f:
        res = pickle.load(f)
    cfg = get_arch(ARCH).reduced()
    from repro_torch.train.train_step import make_loss_and_grad
    grad = make_loss_and_grad(cfg, ParallelConfig())
    params = port_params(cfg, np_params)
    pods = [grad(params, torch_batch({k: v[h * B // 2:(h + 1) * B // 2]
                                      for k, v in np_b.items()}))
            for h in range(2)]
    np.testing.assert_allclose(res["loss"], np.mean([float(l) for l, _, _
                                                     in pods]), rtol=1e-5)
    assert res["step_loss"] == res["loss"] and np.isfinite(res["gnorm"])
    n = 0
    for (path, c), (_, g0), (_, g1) in zip(flat(res["grads"]),
                                           flat(pods[0][2]),
                                           flat(pods[1][2])):
        g0, g1 = g0.numpy(), g1.numpy()
        bound = max(np.abs(g0).max(), np.abs(g1).max()) / 127 + 1e-7
        err = np.abs(c - (g0 + g1) / 2).max()
        assert err <= bound, (path, err, bound)
        n += 1
    assert n == len(flat(pods[0][2]))


def test_checkpoint_restores_onto_other_meshes_bit_for_bit(tmp_path):
    """Saved from a (2, 2) mesh, restored onto (4, 1) and (1, 4): every
    leaf whole equals the saved one bit for bit (the reference's elastic
    restore from (2, 4) onto (4, 2) and (1, 8))."""
    cfg = get_arch(ARCH).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _dump(tmp_path, params=params)
    ck = tmp_path / "ck"
    out, _ = run_ranks(tmp_path, 4, _LOAD + f"""
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train import checkpoint
cfg = get_arch({ARCH!r}).reduced()
par = ParallelConfig()
mesh = make_device_mesh((2, 2), ("data", "model"))
params = rules.distribute(inp["params"], mesh,
                          rules.param_pspecs(cfg, par, mesh))
checkpoint.save({str(ck)!r}, 7, {{"params": params}})
dist.barrier()
for shp in ((4, 1), (1, 4)):
    mesh2 = make_device_mesh(shp, ("data", "model"))
    sh2 = rules.shardings(mesh2, rules.param_pspecs(cfg, par, mesh2))
    restored, step = checkpoint.restore(
        {str(ck)!r}, {{"params": T.abstract_params(cfg)}}, device="cpu",
        shardings={{"params": sh2}})
    assert step == 7
    for a, b, s in zip(tree_leaves(inp["params"]),
                       tree_leaves(restored["params"]), tree_leaves(sh2)):
        assert tuple(b.placements) == tuple(s.placements)
        assert torch.equal(a, b.full_tensor())
""")


def test_train_launcher_on_two_gloo_ranks_equals_one_rank(tmp_path):
    """``launch.train --model-parallel 2`` on two ranks (``torchrun``'s
    environment, a file rendezvous) writes a checkpoint from its (1, 2)
    mesh; its losses equal the one-rank launcher's, and the checkpoint
    equals the one-rank run's parameters.  ``--mesh single`` on one rank
    exits naming the world it needs."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint
    argv = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "8", "--log-every", "100"]
    one = launch_train.main(argv)
    ck = tmp_path / "ck"
    out, _ = run_ranks(tmp_path, 2, f"""
import pickle
from repro_torch.launch import train
res = train.main({argv!r} + ["--model-parallel", "2", "--ckpt", {str(ck)!r},
                             "--init-method", "file://" + os.environ["STORE"]])
assert not dist.is_initialized()
if rank == 0:
    with open(os.path.join(out, "res.pkl"), "wb") as f:
        pickle.dump({{"losses": res["losses"]}}, f)
""", join=False)
    with open(out / "res.pkl", "rb") as f:
        res = pickle.load(f)
    np.testing.assert_allclose(res["losses"], one["losses"], rtol=1e-5)
    saved, step = checkpoint.restore(str(ck), {"params": one["params"]},
                                     device="cpu")
    assert step == 3
    for (path, a), (_, b) in zip(flat(saved["params"]), flat(one["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=path)
    with pytest.raises(SystemExit, match="needs a world of 256"):
        launch_train.main(argv + ["--mesh", "single"])
