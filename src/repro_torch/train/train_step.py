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

``ParallelConfig.compress_grads`` (int8 cross-pod gradients) needs a
``pod`` mesh axis; without a mesh the reference returns the plain step,
and the port, which has none, does the same.  The training path launches
no hand kernel: with ``use_kernels`` (default False, as in every reference
preset) the kernels raise, since none has a backward.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.models.attention import RunOpts
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.models.transformer import lm_loss
from repro_torch.train.optimizer import AdamWConfig, adamw_update


def _microbatch(batch: dict, i: int, accum: int) -> dict:
    def slc(x):
        mb = x.shape[0] // accum
        return x[i * mb:(i + 1) * mb]
    return {k: slc(v) for k, v in batch.items()}


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
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def accum_grads(params, batch):
        accum = parallel.grad_accum
        if accum <= 1:
            loss, aux, grads = grad_fn(params, batch)
            return loss, aux, _unflatten(params, grads)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
                    opt_cfg: AdamWConfig,
                    opts: Optional[RunOpts] = None) -> Callable:
    """One training step (see the module docstring: in place)."""
    accum_grads = make_loss_and_grad(cfg, parallel, opts=opts)

    def step(params, opt_state, batch):
        loss, _aux, grads = accum_grads(params, batch)
        new_params, new_state, opt_metrics = adamw_update(
            opt_cfg, grads, params, opt_state)
        return new_params, new_state, {"loss": loss, **opt_metrics}

    return step
