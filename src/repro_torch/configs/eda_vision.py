"""The paper's own two workloads, as PyTorch models.

- ``eda-detector``: MobileNetV1-SSD-style object detector (outer videos,
  road-hazard detection).  Depthwise-separable conv backbone + SSD-ish head
  over a coarse anchor grid [arXiv:1704.04861; paper §3.2.3 OuterAnalysis].
- ``eda-pose``: MoveNet-Lightning-style pose/heatmap model (inner videos,
  driver-distractedness) — conv backbone + keypoint heatmap head
  [paper §3.2.3 InnerAnalysis].

These are small CNNs (the paper runs them on phones); they are described by
``VisionConfig`` rather than ``ModelConfig`` and are consumed by
``repro_torch.models.vision`` and the vision engine (``repro_torch.streams``).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class VisionConfig:
    name: str
    task: str                 # detect | pose
    input_res: int = 192      # paper downscales frames to the model input res
    channels: tuple = (16, 32, 64, 128, 256)
    num_classes: int = 10     # detector: COCO-ish subset (vehicle/person/...)
    num_anchors: int = 4      # detector: anchors per cell
    num_keypoints: int = 17   # pose: COCO keypoints
    width_mult: float = 1.0


def detector_config(input_res: int = 192) -> VisionConfig:
    return VisionConfig(name="eda-detector", task="detect", input_res=input_res)


def pose_config(input_res: int = 192) -> VisionConfig:
    return VisionConfig(name="eda-pose", task="pose", input_res=input_res)


# Paper's device classes (Table 4.1) with relative processing capacity used by
# the CPU evaluation harness.  Capacities are calibrated from the paper's
# one-node processing times (Table 4.2: FindX2Pro fastest).
DEVICE_CLASSES = {
    # name: (relative_speed, joules_per_gflop, idle_w, battery_mah)
    "pixel3": (0.55, 0.55, 0.35, 2915),
    "pixel6": (0.75, 0.60, 0.40, 4614),
    "oneplus8": (1.00, 0.95, 0.55, 4300),
    "findx2pro": (1.10, 1.20, 0.60, 4260),
}
