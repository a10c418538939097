"""Logical->mesh partition rules (DP / TP / FSDP / EP / SP) and their
DTensor placements.

Every parameter tensor carries logical axis names on its ``P`` descriptor
(``repro_torch.models.param``).  This module maps those names onto mesh
axes given a :class:`repro_torch.config.ParallelConfig`, with
**divisibility enforcement**: a logical axis only shards when the tensor
dimension divides evenly by the mesh axis size, otherwise it falls back to
replication (e.g. whisper's vocab 51865 on a 16-way model axis stays
replicated; its projections still shard on the fused head-feature dims).
The rules are the reference's, verbatim, as pure Python over a ``{axis:
size}`` mapping: a ``DeviceMesh`` with ``mesh_dim_names`` gives one, or
the caller passes it directly.  They return :class:`PartitionSpec`, a
tuple with one entry per tensor dimension (None, a mesh axis name, or a
tuple of names).

Cache sharding is resolved from a *role* per leaf (:func:`cache_roles`).
A special case gives long-context decode its parallelism: when the batch
dim cannot shard over the data axes (e.g. ``long_500k`` B=1), the cache
*sequence* dim shards there instead (flash-decode style sequence
parallelism; the softmax over a sharded sequence is reduced by DTensor).

The reference stacks a repeated segment's layers under a leading
``layers`` axis, which is never sharded; the port keeps one parameter and
one cache dict per layer, so its specs are the reference's without that
leading None.

:func:`shardings` turns a spec into DTensor placements, one per mesh
dimension: ``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
``Replicate()``.  A dim named by several axes (``("data", "model")``) gets
``Shard(d)`` on each, and DTensor splits it over them in mesh-dimension
order, as JAX splits a multi-axis ``PartitionSpec`` entry; a spec that
lists them in another order raises.  A three-dim (pod, data, model) mesh
runs as its two-dim flattening (:func:`compute_mesh`).  :func:`distribute`
places a tree.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

from repro_torch.config import (ATTN, MLSTM, RGLRU, SLSTM, ModelConfig,
                                ParallelConfig, ShapeConfig)
from repro_torch.models.param import P, _map_with_path, tree_map


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis
    name, or a tuple of names (the dim split over each, in order)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


def mesh_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``) or of
    a mapping given directly."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


# ---------------------------------------------------------------------------
# Axis rules for parameters
# ---------------------------------------------------------------------------


def data_axis_names(parallel: ParallelConfig) -> tuple:
    return tuple(parallel.data_axes)


def axis_rules(parallel: ParallelConfig) -> dict:
    """logical axis -> mesh axis (or tuple of axes) candidates."""
    model = parallel.model_axis
    fsdp = parallel.fsdp_axes if parallel.fsdp else None
    return {
        # tensor-parallel (Megatron-style): fused head/feature dims
        "heads": model,
        "kv_heads": model,
        "mlp": model,
        "expert_mlp": model,
        "inner": model,
        "inner2": None,
        "lru": model,
        "vocab": model,
        # expert parallelism: expert dim wins the model axis when enabled,
        # expert_mlp then falls back to replicated on those tensors
        "expert": model if parallel.ep else None,
        # FSDP/ZeRO: shard the d_model dim of weights over (a suffix of) the
        # data axes; DTensor gathers them before use
        "embed": fsdp,
        "embed2": None,
        # never sharded
        "q_lora": None,
        "kv_lora": None,
        "rope": None,
        "conv": None,
        "norm": None,
        "layers": None,
    }


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _flat_axes(axis) -> tuple:
    if axis is None:
        return ()
    if isinstance(axis, (tuple, list)):
        return tuple(axis)
    return (axis,)


def _resolve_dims(shape: tuple, logical: tuple, rules: dict,
                  sizes: dict) -> PartitionSpec:
    """Per-dim mesh assignment with divisibility + at-most-once enforcement."""
    used: set = set()
    out = []
    for dim, ax in zip(shape, logical):
        cand = rules.get(ax) if ax is not None else None
        flat = _flat_axes(cand)
        if (cand is None
                or any(a in used or a not in sizes for a in flat)
                or dim % _axis_size(sizes, cand) != 0):
            out.append(None)
            continue
        used.update(flat)
        out.append(tuple(cand) if isinstance(cand, (tuple, list)) else cand)
    return PartitionSpec(*out)


def param_pspecs(cfg: ModelConfig, parallel: ParallelConfig, mesh) -> Any:
    """PartitionSpec tree matching ``transformer.model_param_tree``."""
    from repro_torch.models.transformer import model_param_tree
    rules = axis_rules(parallel)
    sizes = mesh_sizes(mesh)

    def f(p: P, path):
        return _resolve_dims(p.shape, p.axes, rules, sizes)
    return _map_with_path(model_param_tree(cfg), f)


# ---------------------------------------------------------------------------
# Batch (input) specs
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 parallel: ParallelConfig, mesh) -> dict:
    """PartitionSpecs matching ``transformer.input_specs(cfg, shape)``."""
    da = data_axis_names(parallel)
    sizes = mesh_sizes(mesh)
    dsize = math.prod(sizes[a] for a in da)
    B = shape.global_batch
    batch_ax = da if B % dsize == 0 else None
    # SP (opt-in): shard the sequence dim over the model axis
    seq_ax = None
    if parallel.sp and shape.kind in ("train", "prefill"):
        if shape.seq_len % sizes[parallel.model_axis] == 0:
            seq_ax = parallel.model_axis

    if shape.kind == "train":
        specs = {
            "tokens": PartitionSpec(batch_ax, seq_ax),
            "labels": PartitionSpec(batch_ax, seq_ax),
            "mask": PartitionSpec(batch_ax, seq_ax),
        }
        if cfg.family == "encdec":
            specs["frames"] = PartitionSpec(batch_ax, None, None)
        if cfg.family == "vlm":
            specs["patches"] = PartitionSpec(batch_ax, None, None)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": PartitionSpec(batch_ax, seq_ax)}
        if cfg.family == "encdec":
            specs["frames"] = PartitionSpec(batch_ax, None, None)
        if cfg.family == "vlm":
            specs["patches"] = PartitionSpec(batch_ax, None, None)
        return specs
    # decode
    return {
        "tokens": PartitionSpec(batch_ax, None),
        "index": PartitionSpec(),
        "caches": cache_pspecs(cfg, shape, parallel, mesh),
    }


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

# Role vocabulary: batch | seq | kv_heads | heads | lru | dmodel | none


def _attn_cache_roles(cfg: ModelConfig, cross: bool) -> dict:
    if cfg.attention == "mla":
        roles = {"c": ("batch", "seq", None),
                 "k_rope": ("batch", "seq", None),
                 "pos": ("batch", "seq")}
    else:
        roles = {"k": ("batch", "seq", "kv_heads", None),
                 "v": ("batch", "seq", "kv_heads", None),
                 "pos": ("batch", "seq")}
    if cross:
        roles["cross_k"] = ("batch", None, "kv_heads", None)
        roles["cross_v"] = ("batch", None, "kv_heads", None)
    return roles


def _block_cache_roles(cfg: ModelConfig, kind: str, cross: bool) -> dict:
    if kind == ATTN:
        return _attn_cache_roles(cfg, cross)
    if kind == RGLRU:
        return {"h": ("batch", "lru"), "conv": ("batch", None, "lru")}
    if kind == MLSTM:
        return {"C": ("batch", "heads", None, None),
                "n": ("batch", "heads", None),
                "m": ("batch", "heads")}
    if kind == SLSTM:
        return {"c": ("batch", "dmodel"), "n": ("batch", "dmodel"),
                "h": ("batch", "dmodel"), "m": ("batch", "dmodel")}
    raise ValueError(kind)


def cache_roles(cfg: ModelConfig) -> list:
    """Role dicts, one per layer, mirroring ``transformer.cache_shapes``."""
    cross = cfg.family == "encdec"
    return [_block_cache_roles(cfg, kind, cross)
            for kind in cfg.layer_kinds()]


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig,
                 parallel: ParallelConfig, mesh) -> list:
    from repro_torch.models.transformer import cache_shapes
    sizes = mesh_sizes(mesh)
    da = data_axis_names(parallel)
    dsize = math.prod(sizes[a] for a in da)
    model = parallel.model_axis
    msize = sizes[model]
    B = shape.global_batch
    batch_shardable = B % dsize == 0

    shapes = cache_shapes(cfg, B, shape.seq_len)
    roles = cache_roles(cfg)

    def _axes_size(axes) -> int:
        return math.prod(sizes[a] for a in axes)

    def resolve(shp: tuple, role: tuple) -> PartitionSpec:
        used: set = set()
        out = []
        # first pass: which axes can heads claim?  (heads get priority over
        # seq only when they divide; most GQA kv-head counts don't divide a
        # 16-way model axis, in which case the cache *sequence* dim takes the
        # model axis — the flash-decode layout)
        heads_take_model = any(
            r in ("kv_heads", "heads", "lru", "dmodel")
            and dim % msize == 0
            for dim, r in zip(shp, role))
        for dim, r in zip(shp, role):
            if r == "batch":
                if batch_shardable and dim % dsize == 0:
                    out.append(da)
                    used.update(da)
                else:
                    out.append(None)
            elif r == "seq":
                # seq-parallel cache: soak up every axis the batch/heads
                # left idle (long_500k B=1 -> data+model; decode_32k with
                # non-divisible kv heads -> model)
                free_da = tuple(a for a in da if a not in used)
                m = () if (heads_take_model or model in used) else (model,)
                options = [free_da + m, free_da, m]
                picked = None
                for opt in options:
                    if opt and dim % _axes_size(opt) == 0:
                        picked = opt
                        break
                if picked:
                    out.append(picked if len(picked) > 1 else picked[0])
                    used.update(picked)
                else:
                    out.append(None)
            elif r in ("kv_heads", "heads", "lru", "dmodel"):
                if dim % msize == 0 and model not in used:
                    out.append(model)
                    used.add(model)
                else:
                    out.append(None)
            else:
                out.append(None)
        return PartitionSpec(*out)

    return [{k: resolve(layer[k][0], role[k]) for k in layer}
            for layer, role in zip(shapes, roles)]


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


_COMPUTE_MESHES: list = []


def compute_mesh(mesh):
    """The ``DeviceMesh`` DTensor runs on: the mesh itself up to two dims;
    a (pod, data, model) mesh flattened to ``("pod.data", "model")`` over
    the same ranks in the same row-major order (DTensor's sharding
    propagation over three mesh dims takes minutes for one attention
    product here, over two well under a second).  A dim over
    ``("pod", "data")`` becomes one over the flattened dim: the same
    slice on every rank.  A dim over ``data`` alone (FSDP's default
    ``fsdp_axes``) is then sharded over all pod x data ranks, as the memory
    model (``roofline.estimate_memory_per_device``, ``dp`` = pod x data)
    counts it.  Every rank must call this in the same order (it builds
    process groups); the result is kept for the mesh."""
    if mesh.ndim <= 2:
        return mesh
    for m, flat in _COMPUTE_MESHES:
        if m is mesh:
            return flat
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    flat = DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape(-1, mesh.shape[-1]),
                      mesh_dim_names=(".".join(names[:-1]), names[-1]))
    _COMPUTE_MESHES.append((mesh, flat))
    return flat


def forget_compute_meshes() -> None:
    """Drop the kept flattenings (their process groups are gone once the
    world that built them is destroyed)."""
    _COMPUTE_MESHES.clear()


def placements(mesh, spec: PartitionSpec) -> tuple:
    """One placement per mesh dimension for ``spec``: ``Shard(d)`` where
    tensor dim ``d`` names the mesh axis, else ``Replicate()``.  A mesh dim
    named ``"pod.data"`` (:func:`compute_mesh`) holds each axis it lists."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    owner = {a: i for i, n in enumerate(names) for a in n.split(".")}
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _flat_axes(entry)
        idx = []
        for a in axes:
            if owner[a] not in idx:
                idx.append(owner[a])
        if idx != sorted(idx):
            # DTensor splits a dim over its mesh dims in mesh order
            raise ValueError(f"spec {spec}: dim {d} lists mesh axes {axes} "
                             f"out of the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A mesh and one placement per mesh dimension (the counterpart of
    JAX's ``NamedSharding(mesh, spec)``)."""
    mesh: Any
    placements: tuple


def shardings(mesh, specs: Any) -> Any:
    """A :class:`NamedSharding` for every spec of a tree (dicts and lists
    are nodes; a spec is a leaf)."""
    cm = compute_mesh(mesh)
    return tree_map(lambda s: NamedSharding(cm, placements(cm, s)), specs)


def distribute(tree: Any, mesh, specs: Any) -> Any:
    """Place a tree of tensors on ``mesh`` by ``specs`` (a tree of the same
    structure): each leaf becomes a DTensor holding this rank's slice.
    Every rank passes the same full tensors (drawn from one seed), so
    nothing is broadcast."""
    from torch.distributed.tensor import distribute_tensor
    cm = compute_mesh(mesh)
    return tree_map(lambda t, s: distribute_tensor(
        t, cm, placements(cm, s), src_data_rank=None), tree, specs)
