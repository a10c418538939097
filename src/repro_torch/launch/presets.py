"""Per-cell ``ParallelConfig`` presets and ``--set key=value`` overrides.

The reference's ``launch/presets.py``.  ``default_parallel`` is the
paper-faithful baseline: DP over the data axes, Megatron TP over the model
axis, FSDP for everything with optimizer state too big to replicate, EP
for the MoE archs, remat for the train cells, and the smallest gradient
accumulation (fp32 moments first, then bf16) whose analytic per-device
memory fits ``hw.hbm_bytes``: the H100's 80 GB unless another
``HardwareSpec`` is given.  ``apply_overrides`` parses a field by its
type; a tuple field takes comma-separated names (``--set
data_axes=pod,data``).
"""
from __future__ import annotations

from dataclasses import fields, replace

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig


def default_parallel(cfg: ModelConfig, shape: ShapeConfig,
                     multi_pod: bool = False, hw=None) -> ParallelConfig:
    from repro_torch.roofline.analysis import (HW_H100,
                                               estimate_memory_per_device)
    hw = hw or HW_H100
    data_axes = ("pod", "data") if multi_pod else ("data",)
    total, _active = cfg.param_counts()
    # fp32 Adam (mu+nu) + fp32 master grads ~ 14 B/param; TP shards most of
    # it 16-way; replicate across data only when that still fits comfortably
    fsdp = shape.kind == "train" and total * 14 / 16 > 4e9
    # full remat (save layer boundaries only) + adaptive gradient
    # accumulation: the smallest accum whose analytic per-device footprint
    # fits the chip
    remat = "full" if shape.kind == "train" else "none"
    grad_accum = 1
    opt_state_dtype = "float32"
    if shape.kind == "train":
        tp, dp = 16, (32 if multi_pod else 16)

        def fits(accum, sdt):
            est = estimate_memory_per_device(
                cfg, shape, tp=tp, dp=dp, fsdp=fsdp, grad_accum=accum,
                remat=remat, opt_state_dtype=sdt)
            return (est["total"] < hw.hbm_bytes
                    and shape.global_batch % (dp * accum) == 0)

        found = False
        for sdt in ("float32", "bfloat16"):     # prefer fp32 moments
            for accum in (1, 2, 4, 8, 16):
                if fits(accum, sdt):
                    grad_accum, opt_state_dtype, found = accum, sdt, True
                    break
            if found:
                break
        if not found:                            # best effort: max both
            grad_accum, opt_state_dtype = 16, "bfloat16"
    return ParallelConfig(
        data_axes=data_axes,
        model_axis="model",
        fsdp=fsdp,
        fsdp_axes=("data",),           # within-pod: cross-pod stays pure DP
        ep=cfg.moe.enabled,
        sp=False,
        remat=remat,
        scan_layers=True,
        grad_accum=grad_accum,
        compress_grads=False,
        use_kernels=False,             # the plain path; kernels serve only
        opt_state_dtype=opt_state_dtype,
    )


def apply_overrides(par: ParallelConfig, overrides: dict) -> ParallelConfig:
    """'key=value' overrides from the CLI, parsed by the field's type.
    Raises ``ValueError`` for an unknown name."""
    names = {f.name for f in fields(par)}
    kwargs = {}
    for k, v in overrides.items():
        if k not in names:
            raise ValueError(f"--set {k}: ParallelConfig has no such field "
                             f"(one of {sorted(names)})")
        cur = getattr(par, k)
        if isinstance(cur, bool):
            kwargs[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            kwargs[k] = int(v)
        elif isinstance(cur, tuple):
            kwargs[k] = tuple(s for s in v.split(",") if s)
        else:
            kwargs[k] = v
    return replace(par, **kwargs)
