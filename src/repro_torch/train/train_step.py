"""The train step: CE loss, gradient accumulation, remat.

The reference's ``train/train_step.py`` for one card:

  - loss = ``transformer.lm_loss`` (CE + MoE aux) under the configured
    remat policy, its gradients by ``torch.autograd.grad`` over the
    parameter leaves (detached views that require grad: the caller's
    tensors need not);
  - gradient accumulation: ``grad_accum`` microbatches sliced from the
    batch as the reference's ``_microbatch`` slices them, their gradients
    summed into fp32 buffers and scaled by ``1/accum``;
  - the AdamW update (``train.optimizer``), written in place.

Returned step signature: ``step(params, opt_state, batch) -> (params,
opt_state, metrics)`` with ``metrics = {"loss", "grad_norm", "lr"}``
(0-d tensors on the parameters' device).  The step updates ``params`` and
``opt_state`` IN PLACE and returns them: the reference's launcher donates
both buffers to its jitted step, and the port's step always does, so a
caller that needs the old values clones them first.

Over a mesh (``mesh=`` a ``DeviceMesh``) the same step runs on DTensor
parameters, moments and batch placed by ``repro_torch.sharding.rules``:
plain tensors made inside the model count as replicated
(``implicit_replication``), each microbatch's gradients are settled to
their parameter's placements (DTensor's reduction over the data axes, a
reduce-scatter where FSDP shards the parameter), a microbatch is a slice
of each rank's local rows (the mean gradient is the one of the whole
batch), and the metrics come back as plain tensors.  Where DTensor has no
sharded form of an op it is gathered around (``sharding.gathered``).

``ParallelConfig.compress_grads`` with a ``pod`` mesh axis: each pod
computes its gradients on its own slice of the batch over the in-pod mesh
(the mesh without ``pod``: full-precision reduction within the pod), then
the cross-pod hop is :func:`repro_torch.sharding.collectives.int8_psum`
(the reference's ``shard_map`` over ``pod``).  Without a ``pod`` axis the
reference returns the plain step, and so does the port.  The training
path launches no hand kernel: with ``use_kernels`` (default False, as in
every reference preset) the kernels raise, since none has a backward.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models.attention import RunOpts
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.models.transformer import lm_loss
from repro_torch.sharding.gathered import is_dtensor
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _microbatch(batch: dict, i: int, accum: int) -> dict:
    def slc(x):
        if is_dtensor(x):
            # this rank's rows, sliced locally: no rows move between ranks
            from torch.distributed.tensor import DTensor
            loc = slc(x.to_local())
            return DTensor.from_local(loc, x.device_mesh, x.placements,
                                      run_check=False)
        mb = x.shape[0] // accum
        return x[i * mb:(i + 1) * mb]
    return {k: slc(v) for k, v in batch.items()}


def _settle_like(g, p):
    """``g`` placed as its parameter ``p`` (DTensors), else ``g``."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(t):
    return t.full_tensor() if is_dtensor(t) else t


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_loss_and_grad(cfg: ModelConfig, parallel: ParallelConfig,
                       opts: Optional[RunOpts] = None) -> Callable:
    """``accum_grads(params, batch) -> (loss, aux, grads)``: grads a tree
    like ``params`` (fp32 with accumulation, else the parameters'
    dtypes); aux is ``lm_loss``'s without accumulation, else {}."""
    opts = opts or RunOpts(use_kernels=parallel.use_kernels,
                           remat=parallel.remat,
                           block_kv=parallel.block_kv,
                           mxu_bf16=parallel.mxu_bf16)

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, aux = lm_loss(cfg, _unflatten(params, leaves), batch,
                                opts=opts)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach gets 0, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else _settle_like(g, p)
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def accum_grads(params, batch):
        accum = parallel.grad_accum
        if accum <= 1:
            loss, aux, grads = grad_fn(params, batch)
            return loss, aux, _unflatten(params, grads)
        acc = [torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
               for p in tree_leaves(params)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=acc[0].device)
        for i in range(accum):
            loss, _aux, grads = grad_fn(params, _microbatch(batch, i, accum))
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
            loss_sum = loss_sum + loss
        inv = 1.0 / accum
        for a in acc:
            a.mul_(inv)
        return loss_sum * inv, {}, _unflatten(params, acc)

    return accum_grads


def make_train_step(cfg: ModelConfig, parallel: ParallelConfig,
                    opt_cfg: AdamWConfig, mesh=None,
                    opts: Optional[RunOpts] = None) -> Callable:
    """One training step (see the module docstring: in place)."""
    accum_grads = make_loss_and_grad(cfg, parallel, opts=opts)
    if mesh is None:
        def step(params, opt_state, batch):
            loss, _aux, grads = accum_grads(params, batch)
            new_params, new_state, opt_metrics = adamw_update(
                opt_cfg, grads, params, opt_state)
            return new_params, new_state, {"loss": loss, **opt_metrics}
        return step

    from torch.distributed.tensor.experimental import implicit_replication
    if parallel.compress_grads and "pod" in mesh.mesh_dim_names:
        pod_grads = make_compressed_loss_and_grad(cfg, parallel, mesh, opts)

        def compressed_step(params, opt_state, batch):
            with implicit_replication():
                loss, grads, views = pod_grads(params, batch, opt_state)
                p_in, s_in = views
                adamw = adamw_update(opt_cfg, grads, p_in, s_in)
            return params, opt_state, {"loss": loss, **{
                k: _plain(v) for k, v in adamw[2].items()}}
        return compressed_step

    def mesh_step(params, opt_state, batch):
        with implicit_replication():
            loss, _aux, grads = accum_grads(params, batch)
            new_params, new_state, opt_metrics = adamw_update(
                opt_cfg, grads, params, opt_state)
        return new_params, new_state, {
            "loss": _plain(loss), **{k: _plain(v)
                                     for k, v in opt_metrics.items()}}
    return mesh_step


def _in_pod(t, sub, rows: bool = False):
    """A DTensor of the run's mesh as one of the in-pod mesh ``sub``
    (the mesh without ``pod``), over this rank's local tensor (no copy).
    Its placement on ``pod`` is dropped; on a flattened ``"pod.data"``
    dim (``rules.compute_mesh``) it moves to ``data``, which holds for a
    batch's rows (``rows``: the pod's slice, split over its data ranks)
    and for a replicated tensor."""
    from torch.distributed.tensor import DTensor
    if not is_dtensor(t):
        return t
    pl = []
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == "pod":
            continue
        if name.startswith("pod.") and p.is_shard() and not rows:
            raise ValueError(
                "compress_grads on a (pod, data, model) mesh needs "
                "parameters replicated over pod x data (no fsdp)")
        pl.append(p)
    return DTensor.from_local(t.to_local(), sub, pl, run_check=False)


def make_compressed_loss_and_grad(cfg: ModelConfig, parallel: ParallelConfig,
                                  mesh, opts: Optional[RunOpts] = None):
    """``f(params, batch, opt_state=None) -> (loss, grads, (params, state))``
    of the int8 cross-pod variant: the parameters, the state and this
    pod's rows of the batch viewed on the in-pod mesh (the same storage),
    gradients reduced in full precision within the pod and through
    :func:`int8_psum` across pods; loss the mean over pods."""
    import torch.distributed as dist
    from repro_torch.sharding.collectives import compressed_grad_allreduce
    accum_grads = make_loss_and_grad(cfg, parallel, opts=opts)
    names = tuple(mesh.mesh_dim_names)
    rest = tuple(a for a in names if a != "pod")
    sub = mesh[rest if len(rest) > 1 else rest[0]]
    group = mesh["pod"].get_group()
    n = dist.get_world_size(group)

    def f(params, batch, opt_state=None):
        view = lambda t: _in_pod(t, sub)
        p_in = tree_map(view, params)
        b_in = {k: _in_pod(v, sub, rows=True) for k, v in batch.items()}
        s_in = None
        if opt_state is not None:
            s_in = {"mu": tree_map(view, opt_state["mu"]),
                    "nu": tree_map(view, opt_state["nu"]),
                    "step": opt_state["step"]}
        loss, _aux, grads = accum_grads(p_in, b_in)
        grads = compressed_grad_allreduce(grads, mesh)
        loss = _plain(loss).clone()
        dist.all_reduce(loss, group=group)
        return loss / n, grads, (p_in, s_in)
    return f
