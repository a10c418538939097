"""Distribution layer: logical->mesh partition rules and their DTensor
placements, pipeline parallelism, compressed collectives, and the mesh
constructors."""
from repro_torch.sharding.compat import make_device_mesh, make_mesh  # noqa: F401
from repro_torch.sharding.rules import (  # noqa: F401
    PartitionSpec,
    axis_rules,
    batch_pspecs,
    cache_pspecs,
    data_axis_names,
    distribute,
    param_pspecs,
    shardings,
)
