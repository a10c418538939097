"""``--set key=value`` overrides of a ``ParallelConfig``.

The reference's ``launch/presets.py`` ``apply_overrides``.  Its
``default_parallel`` (the per-cell baseline, sized by the roofline
memory model) belongs to the multi-device layer and is not ported yet.
The reference's fields that only a mesh gives meaning (``MESH_FIELDS``,
and ``compress_grads``, whose int8 all-reduce runs on a pod axis) are
refused by name, so a ``--set fsdp=true`` cannot pass silently as a
no-op on one card.
"""
from __future__ import annotations

from dataclasses import fields, replace

from repro_torch.config import ParallelConfig

MESH_FIELDS = ("data_axes", "model_axis", "fsdp", "fsdp_axes", "ep", "sp",
               "scan_layers", "attn_batch_sharded", "donate_caches",
               "compress_grads")


def apply_overrides(par: ParallelConfig, overrides: dict) -> ParallelConfig:
    """'key=value' overrides from the CLI, parsed by the field's type.
    Raises ``ValueError`` for a mesh field or an unknown name."""
    names = {f.name for f in fields(par)}
    kwargs = {}
    for k, v in overrides.items():
        if k in MESH_FIELDS:
            raise ValueError(f"--set {k} needs the multi-device layer, not "
                             f"ported yet (ROADMAP item 7)")
        if k not in names:
            raise ValueError(f"--set {k}: ParallelConfig has no such field "
                             f"(one of {sorted(names)})")
        cur = getattr(par, k)
        if isinstance(cur, bool):
            kwargs[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            kwargs[k] = int(v)
        else:
            kwargs[k] = v
    return replace(par, **kwargs)
