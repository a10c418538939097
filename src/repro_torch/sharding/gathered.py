"""Where DTensor cannot run an op of the model's path sharded, the port
gathers around it, as GSPMD inserts gathers around ops it cannot
partition, or runs an op on each rank's local shards where DTensor's
placement search costs more than the op.  Each form is listed here:

- :func:`splittable`: a fused head projection is gathered before it is
  reshaped into heads where its split does not fall on head boundaries
  (:func:`merged_heads`: the same for the gradient of a merge of heads).
- :func:`settle`: DTensor's vocab-sharded ``gather`` leaves a masked
  partial sum whose mask no later view or reduction reshapes, so the
  cross-entropy's gold logit is reduced to ``Replicate()`` right after
  the gather.
- :func:`replicate`: an MoE layer runs on every token (its input rows
  gathered), so its routing's scatters never meet a row split; its
  experts stay split over their axis.
- :func:`replicated_local`: the MoE's routing (sorts, counts, scatters of
  token indices) runs on every rank on the gathered router probabilities
  as plain tensors, and its results re-enter as replicated DTensors.
- :func:`vocab_parallel_lookup`: the embedding lookup over a vocab
  split, each rank in its own split, summed.
- :func:`local_rows`: an xLSTM block runs on each rank's own rows as
  plain tensors, its weights gathered (``transformer._block_on_local_
  rows``): the sLSTM's per-token recurrence would pay DTensor's per-op
  host cost thousands of times, the mLSTM's products merge row and head
  splits, and DTensor has no placement rule for ``log_sigmoid``'s
  forward and backward.

A plain tensor passes through each untouched.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

@functools.lru_cache(maxsize=None)
def _dtensor_class():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:                      # a torch without distributed
        return None
    return DTensor


def is_dtensor(t) -> bool:
    """True for a DTensor (the sharded paths); False for a plain tensor."""
    cls = _dtensor_class()
    return cls is not None and isinstance(t, cls)


class _ReplicatedGrad(torch.autograd.Function):
    """Identity on a replicated DTensor whose gradient is replicated too
    (DTensor would hand back the gradient split as the consumer's rows)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        return g.redistribute(g.device_mesh,
                              [Replicate()] * g.device_mesh.ndim)


def replicate(t: torch.Tensor) -> torch.Tensor:
    """``t`` gathered whole on every rank (``Replicate()`` everywhere),
    its gradient gathered the same way."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return _ReplicatedGrad.apply(
        t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim))


def splittable(t: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``t`` with dim ``dim`` gathered where its split over the mesh does
    not divide ``parts`` (the heads a fused projection is reshaped into:
    24 heads over a 16-way model axis cannot be cut on head boundaries)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dim = dim % t.ndim
    mesh = t.device_mesh
    split = 1
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            split *= mesh.size(i)
    if parts % split == 0:
        return t
    return t.redistribute(mesh, [Replicate() if p == Shard(dim) else p
                                 for p in t.placements])


class _SplittableGrad(torch.autograd.Function):
    """Identity whose gradient passes through :func:`splittable`."""

    @staticmethod
    def forward(ctx, x, dim, parts):
        ctx.dim, ctx.parts = dim, parts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, ctx.dim, ctx.parts), None, None


def merged_heads(t: torch.Tensor, parts: int) -> torch.Tensor:
    """``t`` (heads merged into its last dim), whose gradient is gathered
    where its split does not fall on the ``parts`` head boundaries: the
    merge's backward splits that gradient back into heads."""
    return _SplittableGrad.apply(t, -1, parts) if is_dtensor(t) else t


def settle(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every partial placement reduced to ``Replicate()``."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def replicated_local(t: torch.Tensor, rows_of: torch.Tensor = None
                     ) -> Tuple[torch.Tensor, Callable]:
    """(the whole of ``t`` as a plain tensor, a function that wraps a
    plain tensor computed from it back as a replicated DTensor on ``t``'s
    mesh).  Both are differentiable.  ``rows_of``: a DTensor whose rows
    (dim 0) each rank computes with its own split of; the gradient of
    ``t`` is then a partial sum over the mesh dims that split those rows.
    For a plain ``t``, (t, identity)."""
    if not is_dtensor(t):
        return t, lambda u: u
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = t.device_mesh
    rep = [Replicate()] * mesh.ndim
    grad = rep
    if rows_of is not None:
        grad = [Partial() if p == Shard(0) else Replicate()
                for p in rows_of.placements]
    whole = t.redistribute(mesh, rep).to_local(grad_placements=grad)
    return whole, lambda u: DTensor.from_local(u, mesh, rep, run_check=False)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``groups`` forward, identity backward: each
    rank's partial lookup into its vocab split, summed."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_parallel_lookup(table: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` for a DTensor table split over its vocab (dim 0):
    each rank looks its rows' tokens up in its own vocab split (0 where a
    token falls outside it) and the splits are summed (Megatron's
    vocab-parallel embedding).  The table's model dim is gathered first,
    and the result's rows are split as ``tokens``'.  DTensor's own
    vocab-split lookup leaves a masked partial that not every torch
    reduces."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in tokens.placements]
    # vocab stays split where the rows are not (a mesh dim cannot split
    # both), the model dim is gathered
    vocab = [Shard(0) if (p == Shard(0) and r != Shard(0)) else Replicate()
             for p, r in zip(table.placements, rows)]
    grad = [Partial() if r == Shard(0) else v for r, v in zip(rows, vocab)]
    local = table.redistribute(mesh, vocab).to_local(grad_placements=grad)
    tok = tokens.redistribute(mesh, rows).to_local().long()
    coord = mesh.get_coordinate()
    split, n = [i for i, v in enumerate(vocab) if v == Shard(0)], 0
    for i in split:
        n = n * mesh.size(i) + coord[i]
    lo = n * local.shape[0]
    inside = (tok >= lo) & (tok < lo + local.shape[0])
    out = torch.nn.functional.embedding(
        torch.where(inside, tok - lo, torch.zeros_like(tok)), local)
    out = out * inside[..., None].to(out.dtype)
    if split:
        out = _SumOver.apply(out, [mesh.get_group(i) for i in split])
    shape = list(out.shape)
    for i, r in enumerate(rows):
        if r == Shard(0):
            shape[0] *= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=torch.Size(shape), stride=stride)


class ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient comes back contiguous: a DTensor's local
    gradient must be, since DTensor runs a reshape's backward as a view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_rows(t: torch.Tensor, like: torch.Tensor):
    """(this rank's rows of ``t`` as a plain tensor, every other dim
    gathered, a function wrapping a plain tensor of such rows back as a
    DTensor).  Rows (dim 0) stay split over the mesh dims where ``like``,
    a DTensor, splits its own dim 0; ``t`` may be plain (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in like.placements]
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    local = ContiguousGrad.apply(t.redistribute(mesh, rows).to_local())

    def wrap(u: torch.Tensor) -> torch.Tensor:
        u = u.contiguous()
        shape = list(u.shape)
        for i, pl in enumerate(rows):
            if pl.is_shard():
                shape[0] *= mesh.size(i)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(u, mesh, rows, run_check=False,
                                  shape=torch.Size(shape), stride=stride)
    return local, wrap
