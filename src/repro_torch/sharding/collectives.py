"""Compressed cross-pod collectives.

The multi-pod mesh's ``pod`` axis rides the slow inter-pod links, so the
per-step gradient all-reduce over it dominates the collective roofline term
for training cells.  ``int8_psum`` compresses that traffic 4x (bf16->int8
per-tensor scaled) at the cost of quantisation noise bounded by
``max|g| / 127`` per element; within-pod reduction stays full precision.

The steps are the reference's: an all-reduce (MAX) of the local max-abs
agrees one scale, each rank quantises with ``torch.round`` (half to even,
like ``jnp.round``) and clips to +-127, the int8 payloads are summed in
int32 (a sum of up to n int8 values overflows int8), then rescaled and
divided by n.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def int8_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce mean of ``x`` over ``group`` with an int8 payload."""
    n = dist.get_world_size(group)
    local_max = torch.clamp(x.abs().max(), min=1e-8).to(torch.float32)
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    smax = (local_max / 127.0).to(x.dtype)
    qs = torch.clamp(torch.round(x / smax), -127, 127).to(torch.int8)
    total = qs.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return (total.to(x.dtype) * smax) / n


def compressed_grad_allreduce(grads: Any, mesh, pod_axis: str = "pod"):
    """Mean-reduce a gradient tree over the pod axis with int8 payload.

    Gradients are assumed already reduced within the pod; this handles
    only the slow cross-pod hop.  A leaf is a plain tensor or a DTensor
    replicated over the pod axis (its local tensor is reduced in place of
    it).  Without a ``pod`` axis the grads come back unchanged."""
    from repro_torch.models.param import tree_map
    if mesh is None or pod_axis not in (mesh.mesh_dim_names or ()):
        return grads
    group = mesh[pod_axis].get_group()

    def one(g):
        from torch.distributed.tensor import DTensor
        if isinstance(g, DTensor):
            return DTensor.from_local(int8_psum(g.to_local(), group),
                                      g.device_mesh, g.placements,
                                      run_check=False, shape=g.shape,
                                      stride=g.stride())
        return int8_psum(g, group)
    return tree_map(one, grads)
