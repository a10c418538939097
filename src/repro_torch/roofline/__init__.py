"""Roofline analysis of a counted step (no compilation): per-device FLOPs,
bytes and collective bytes against an H100's rates."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW_H100,
    CountMode,
    HardwareSpec,
    RooflineReport,
    analyse_counted,
    collective_bytes,
    estimate_memory_per_device,
    model_flops,
    roofline_terms,
)
