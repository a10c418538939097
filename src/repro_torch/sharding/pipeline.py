"""GPipe-style pipeline parallelism over a ``stage`` mesh dimension.

The model's layer stack is split into ``num_stages`` contiguous groups;
stage i holds group i.  Microbatches stream through the stages with a
ring shift per tick; the classic GPipe schedule runs ``num_micro +
num_stages - 1`` ticks, so bubble fraction ``(S-1)/(M+S-1)``.

The reference writes this with ``shard_map`` + ``ppermute``; here each
rank of the stage group runs the same loop:

- stage 0 ingests microbatch t (clipped to the last one once t >= M);
  the other stages take the activation shifted in at the last tick;
- the last stage keeps its output of microbatch ``t - (S-1)`` when valid;
- the ring shift sends this tick's output to rank ``(i + 1) % S`` and
  receives from ``(i - 1) % S`` with ``dist.batch_isend_irecv``;
- after the last tick the outputs, zero on every other stage, are summed
  over the group, as the reference's closing ``psum`` does.

All stages run the same ``stage_fn`` (homogeneous transformer segments).
The 68 dry-run cells use DP x TP (+FSDP/EP) without it, as the
reference's do.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def stage_split(tree, num_stages: int):
    """Split a stacked-params tree (leading dim = layers) into one with
    leading dim = stages (layers/stage folded inside)."""
    from repro_torch.models.param import tree_map

    def f(x):
        L = x.shape[0]
        assert L % num_stages == 0, (L, num_stages)
        return x.reshape(num_stages, L // num_stages, *x.shape[1:])
    return tree_map(f, tree)


def _ring_shift(y: torch.Tensor, group) -> torch.Tensor:
    """Send ``y`` to the next stage, receive the previous stage's."""
    S = dist.get_world_size(group)
    i = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (i + 1) % S)
    prv = dist.get_global_rank(group, (i - 1) % S)
    buf = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, buf, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return buf


def pipelined(stage_fn: Callable, mesh, axis: str = "stage"):
    """Build a pipelined apply: ``f(stage_params, x) -> y`` with
    ``y[m] = stage_{S-1}(...stage_0(x[m]))``.

    ``stage_params`` leaves have leading dim ``num_stages`` (a
    :func:`stage_split` tree); each rank runs the slice at its ``axis``
    coordinate.  ``x`` has leading dim ``num_micro`` and is the same on
    every rank; ``y`` is returned on every rank."""
    from repro_torch.models.param import tree_map
    group = mesh[axis].get_group()
    num_stages = mesh[axis].size()

    def apply(stage_params, x):
        stage = dist.get_rank(group)
        params = tree_map(lambda p: p[stage], stage_params)
        M = x.shape[0]
        ticks = M + num_stages - 1
        buf = torch.zeros_like(x[0])                   # current activation
        out = torch.zeros_like(x)                      # collected outputs
        for t in range(ticks):
            # stage 0 ingests microbatch t (if in range), others the shift
            cur = x[min(t, M - 1)] if stage == 0 else buf
            y = stage_fn(params, cur)
            # last stage emits microbatch (t - (S-1)) when valid
            m_out = t - (num_stages - 1)
            if stage == num_stages - 1 and 0 <= m_out < M:
                out[m_out] = y
            if num_stages > 1:      # one stage has no neighbour to shift to
                buf = _ring_shift(y, group)
        # outputs live on the last stage; sum them to every rank
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    return apply


def make_pipeline(stage_fn: Callable, mesh, axis: str = "stage"):
    """The reference's convenience wrapper (it adds a ``jit``; the port
    runs eagerly): :func:`pipelined`."""
    return pipelined(stage_fn, mesh, axis)


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)
