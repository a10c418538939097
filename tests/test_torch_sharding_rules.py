"""Port parity: ``repro_torch.sharding.rules`` (and the shape stand-ins it
reads) vs the reference's rules, with no process group.

The reference's rules read only ``mesh.shape``, so they run on a
``jax.sharding.AbstractMesh`` of the production sizes: (16, 16)
``("data", "model")`` and (2, 16, 16) ``("pod", "data", "model")``.  The
port's take the same ``{axis: size}``.  Every arch at full width, under
``ParallelConfig()``, ``fsdp+ep`` and ``sp``, every ``SHAPES`` entry.  The
reference stacks a repeated segment's layers under a leading, never
sharded ``layers`` axis; its trees are unstacked into the port's per-layer
layout (``convert``'s rule) before the specs are compared, spec for spec.
A one-axis tuple entry is JAX's spelling of that axis (``("data",)`` reads
back as ``"data"``), so entries are compared as tuples of axis names.
"""
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import SHAPES as JSHAPES
from repro.config import ParallelConfig as JParallelConfig
from repro.config import cell_skip_reason as jcell_skip_reason
from repro.config import get_arch as jget_arch
from repro.configs import ASSIGNED
from repro.models import param as JPm
from repro.models import transformer as JT
from repro.sharding import rules as JR
from repro_torch.config import SHAPES, ParallelConfig, cell_skip_reason, get_arch
from repro_torch.models import param as Pm
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import encoder_plan, plan_layers
from repro_torch.sharding import rules as R

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PARS = [dict(), dict(fsdp=True, ep=True), dict(sp=True)]


def _pars(names):
    data = tuple(a for a in names if a != "model")
    for kw in PARS:
        yield (ParallelConfig(data_axes=data, **kw),
               JParallelConfig(data_axes=data, **kw))


def _is_spec(x):
    return type(x).__name__ == "PartitionSpec"


def _norm(spec):
    out = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        else:
            out.append(tuple(e) if isinstance(e, (tuple, list)) else (e,))
    return tuple(out)


def _unstack(segments, plan, leaf=lambda x: x):
    """The reference's segment list -> one tree per layer; a stacked
    leaf loses its leading ``layers`` entry."""
    layers = []
    for (sig, repeats), seg in zip(plan, segments):
        for _r in range(repeats):
            for j in range(len(sig)):
                tree = seg[f"b{j}"]
                if repeats > 1:
                    tree = jax.tree.map(leaf, tree, is_leaf=_leafy)
                layers.append(tree)
    return layers


def _leafy(x):
    return _is_spec(x) or isinstance(x, jax.ShapeDtypeStruct)


def _drop_layers(x):
    if _is_spec(x):
        assert tuple(x)[0] is None, x
        return type(x)(*tuple(x)[1:])
    return jax.ShapeDtypeStruct(x.shape[1:], x.dtype)


def _ref_layout(tree, cfg):
    """A reference parameter tree (specs or shapes) in the port's layout."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"],
           "layers": _unstack(tree["segments"], plan_layers(cfg),
                              _drop_layers)}
    if "encoder" in tree:
        out["encoder"] = {
            "layers": _unstack(tree["encoder"]["segments"],
                               encoder_plan(cfg), _drop_layers),
            "final_norm": tree["encoder"]["final_norm"]}
    if "patch_proj" in tree:
        out["patch_proj"] = tree["patch_proj"]
    return out


def _pairs(port, ref, path=""):
    """(path, port leaf, ref leaf) over two trees of one layout."""
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    elif isinstance(port, list):
        assert len(port) == len(ref), (path, len(port), len(ref))
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, port, ref


def _assert_specs_equal(port, ref, where):
    n = 0
    for path, a, b in _pairs(port, ref):
        assert _norm(a) == _norm(b), (where, path, a, b)
        n += 1
    assert n > 0


def test_param_pspecs_equal_reference_all_archs_both_meshes():
    for arch in ASSIGNED:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        for sizes, names in MESHES:
            amesh = AbstractMesh(sizes, names)
            for par, jpar in _pars(names):
                ref = _ref_layout(JR.param_pspecs(jcfg, jpar, amesh), jcfg)
                port = R.param_pspecs(cfg, par, dict(zip(names, sizes)))
                _assert_specs_equal(port, ref, (arch, sizes, par))


def test_batch_pspecs_equal_reference_every_shape():
    for arch in ASSIGNED:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        for sizes, names in MESHES:
            amesh = AbstractMesh(sizes, names)
            for par, jpar in _pars(names):
                for name in SHAPES:
                    ref = JR.batch_pspecs(jcfg, JSHAPES[name], jpar, amesh)
                    port = R.batch_pspecs(cfg, SHAPES[name], par,
                                          dict(zip(names, sizes)))
                    assert set(port) == set(ref), (arch, name)
                    for k in port:
                        if k == "caches":
                            continue
                        assert _norm(port[k]) == _norm(ref[k]), (
                            arch, sizes, name, k, port[k], ref[k])


def test_cache_pspecs_equal_reference_decode_shapes():
    for arch in ASSIGNED:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        for sizes, names in MESHES:
            amesh = AbstractMesh(sizes, names)
            for par, jpar in _pars(names):
                for name in ("decode_32k", "long_500k"):
                    ref = _unstack(JR.cache_pspecs(jcfg, JSHAPES[name], jpar,
                                                   amesh),
                                   plan_layers(cfg), _drop_layers)
                    port = R.cache_pspecs(cfg, SHAPES[name], par,
                                          dict(zip(names, sizes)))
                    _assert_specs_equal(port, ref, (arch, sizes, name))


def test_long_500k_cache_takes_the_idle_axes():
    """The reference's ``test_decode_cache_specs_seq_shard``: at B 1 the
    cache sequence dim takes the data axes (and the model axis where the
    kv heads do not divide it)."""
    cfg = get_arch("starcoder2-3b")
    for sizes, names in MESHES:
        data = tuple(a for a in names if a != "model")
        specs = R.cache_pspecs(cfg, SHAPES["long_500k"],
                               ParallelConfig(data_axes=data),
                               dict(zip(names, sizes)))
        k = specs[0]["k"]
        assert k[0] is None                      # B 1 does not shard
        assert k[1] == data + ("model",), k      # kv heads 2 of 16: seq
        assert k[2] is None
    small = R.cache_pspecs(cfg, TT_shape("long", 1024, 1),
                           ParallelConfig(), {"data": 2, "model": 4})
    assert "data" in small[0]["k"][1]


def TT_shape(name, S, B, kind="decode"):
    from repro_torch.config import ShapeConfig
    return ShapeConfig(name, S, B, kind)


def test_abstract_params_equal_reference_shapes_and_dtypes():
    for arch in ASSIGNED:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        ref = _ref_layout(JT.abstract_params(jcfg), jcfg)
        port = TT.abstract_params(cfg)
        n = 0
        for path, a, b in _pairs(port, ref):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), (arch, path)
            assert str(a.dtype).replace("torch.", "") == str(b.dtype), (
                arch, path)
            n += 1
        assert n >= len(jax.tree.leaves(JT.abstract_params(jcfg)))


def test_input_specs_equal_reference_every_cell():
    for arch in ASSIGNED:
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        for name in SHAPES:
            ref = JT.input_specs(jcfg, JSHAPES[name])
            port = TT.input_specs(cfg, SHAPES[name])
            assert set(port) == set(ref), (arch, name)
            if "caches" in ref:
                ref = dict(ref, caches=_unstack(
                    ref["caches"], plan_layers(cfg), _drop_layers))
            for path, a, b in _pairs(port, ref):
                assert tuple(a.shape) == tuple(b.shape), (arch, name, path)
                assert str(a.dtype).replace("torch.", "") == str(b.dtype), (
                    arch, name, path)


def test_shapes_and_skip_reasons_agree():
    assert list(SHAPES) == list(JSHAPES)
    for name in SHAPES:
        assert vars(SHAPES[name]) == vars(JSHAPES[name])
    runnable = 0
    for arch in ASSIGNED:
        for name in SHAPES:
            got = cell_skip_reason(get_arch(arch), SHAPES[name])
            assert got == jcell_skip_reason(jget_arch(arch), JSHAPES[name])
            runnable += got is None
    assert runnable == 34                       # 6 of the 40 cells skip
    assert vars(ParallelConfig()) == vars(JParallelConfig())


def test_spec_tree_equals_reference():
    for arch in ("starcoder2-3b", "deepseek-v2-236b", "recurrentgemma-9b"):
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        rules = R.axis_rules(ParallelConfig(fsdp=True))
        ref = _ref_layout(JPm.spec_tree(JT.model_param_tree(jcfg),
                                        JR.axis_rules(JParallelConfig(
                                            fsdp=True))), jcfg)
        port = Pm.spec_tree(TT.model_param_tree(cfg), rules)
        _assert_specs_equal(port, ref, arch)


def test_placements_map_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = R.PartitionSpec
    assert R.placements(mesh, P(None, "model")) == (
        Replicate(), Replicate(), Shard(1))
    assert R.placements(mesh, P(("pod", "data"), None, "model", None)) == (
        Shard(0), Shard(0), Shard(2))
    assert R.placements(mesh, P()) == (Replicate(),) * 3
    assert R.placements(mesh, P(("data", "model"))) == (
        Replicate(), Shard(0), Shard(0))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        R.placements(mesh, P(("data", "pod")))
    flat = SimpleNamespace(mesh_dim_names=("pod.data", "model"), ndim=2)
    assert R.placements(flat, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(2))
    assert R.placements(flat, P(None, ("pod", "data", "model"))) == (
        Shard(1), Shard(1))
    assert R.placements(flat, P("data")) == (Shard(0), Replicate())
    tree = R.shardings(flat, {"a": [P("model"), P(None, "pod")]})
    assert tree == {"a": [(flat, (Replicate(), Shard(0))),
                          (flat, (Shard(1), Replicate()))]}
    assert tree["a"][0].placements == (Replicate(), Shard(0))
    assert isinstance(P("data"), tuple) and repr(P(None)) == "PartitionSpec(None,)"
    assert not any(isinstance(x, torch.Tensor) for x in P("a"))
