"""Production and host mesh construction.

Functions, never module-level constants: importing this module starts no
process group.  ``make_production_mesh`` gives the reference's shapes, so
its specs can be compared: (16, 16) ``("data", "model")`` or (2, 16, 16)
``("pod", "data", "model")``.  It needs a world of that size: the dry-run's
fake one (``launch.dryrun``) or real ranks.  ``make_host_mesh`` is built
over the world the process was started in (``torchrun`` ranks, or one).
"""
from __future__ import annotations

import math

from repro_torch.sharding.compat import make_device_mesh


def production_shape(multi_pod: bool = False):
    """(shape, names) of the 256-chip single-pod or 512-chip two-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    return make_device_mesh(*production_shape(multi_pod))


def make_host_mesh(model: int = 2, data: int = 0):
    """(data, model) mesh over this process group's ranks; ``data``
    defaults to the world size over ``model``."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = data or max(n // model, 1)
    return make_device_mesh((data, model), ("data", "model"))


def mesh_chips(mesh) -> int:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return math.prod(mesh.values())          # a {axis: size} mapping
    return math.prod(mesh.shape)
