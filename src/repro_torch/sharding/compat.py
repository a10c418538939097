"""The two mesh constructors of the port.

``make_device_mesh(shape, names)`` is the SPMD mesh: a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names`` over
the running process group (NCCL ranks on cards, gloo ranks on the CPU, or
the dry-run's fake world), whose size must be the mesh's.

``make_mesh(shape, names, devices=None)`` is the fleet's single-controller
replica mesh (``streams.fleet_step``, ``mode="shard_map"``): not a process
group but a list of ``torch.device``, one per mesh position, from the
visible cards, or from the CPU repeated, which stands in for the
reference's forced host devices.  Too small a pool raises with the number
of devices the mesh needs, as the reference's ``make_mesh`` does.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import torch


def make_device_mesh(shape: Sequence[int], names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over every rank of
    the process group (rank ``r`` at the row-major position ``r``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (torchrun, or the dry-run's fake world)")
    n = math.prod(int(s) for s in shape)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {tuple(shape)} needs a world of {n} ranks, "
                         f"this one has {world}")
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(dev, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def _device_pool(device_type: Optional[str] = None) -> List[torch.device]:
    """The devices a replica mesh draws from: the visible cards, or the
    CPU repeated once per core."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * (os.cpu_count() or 1)


def make_mesh(shape: Sequence[int], names: Tuple[str, ...],
              devices: Optional[Sequence[torch.device]] = None,
              device_type: Optional[str] = None) -> List[torch.device]:
    """The first ``prod(shape)`` devices of ``devices`` (default: the
    pool of ``device_type``, the cards when there are any), one per
    position of a mesh named ``names``, row-major."""
    if len(tuple(shape)) != len(tuple(names)):
        raise ValueError(f"mesh {tuple(shape)} and names {tuple(names)}")
    n = math.prod(int(s) for s in shape)
    pool = list(devices) if devices is not None else _device_pool(device_type)
    if len(pool) < n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} devices, "
                         f"only {len(pool)} available")
    return pool[:n]
