"""The paper's two analytics workloads as PyTorch models (§3.2.3).

  OuterAnalysis  — MobileNetV1-SSD-style detector: depthwise-separable conv
                   backbone + per-cell anchor head (class logits + boxes);
                   hazard flagging = non-vehicle object on the road region,
                   or a vehicle box large enough to indicate tailgating.
  InnerAnalysis  — MoveNet-Lightning-style pose model: conv backbone +
                   keypoint heatmap head; distraction flagging = a hand above
                   three-quarters of the frame height, or eyes positioned
                   below the ears (phone-glance posture).

Public functions take and return NHWC, as the reference does, so tests
compare like with like; inside, the convolutions run NCHW on
``torch.nn.functional.conv2d`` (the reference leaves its convolutions to
the compiler too — there is no hand kernel for them).  Three layout facts
are kept explicitly:

  * weights live in PyTorch's OIHW layout; :func:`from_hwio` converts a
    tree in the reference's HWIO layout (depthwise ``(kh,kw,1,c)`` becomes
    ``(c,1,kh,kw)`` by the same permutation);
  * ``"SAME"`` padding with stride 2 pads asymmetrically — ``(0, 1)`` on an
    even input — so :func:`_same_pad` pads explicitly and the convolution
    itself runs with ``padding=0``;
  * the detector head is permuted back to NHWC before its
    ``(B, g*g*A, C+4)`` reshape, or the anchors would scramble while every
    shape still matched.

Nothing here sets global numerics flags: cuDNN runs float32 convolutions
in TF32 unless the caller turns that off (``chip_smoke.py`` does).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.eda_vision import VisionConfig
from repro_torch.device import resolve_device
from repro_torch.models.param import P, init_tree

# COCO-ish class ids used by the detector head
VEHICLE_CLASSES = (2, 3, 4)        # car, truck, bus
PERSON_CLASS = 0
# keypoint ids (COCO-17 subset used by the flag logic)
KP_LEFT_EYE, KP_RIGHT_EYE = 1, 2
KP_LEFT_EAR, KP_RIGHT_EAR = 3, 4
KP_LEFT_WRIST, KP_RIGHT_WRIST = 9, 10


# ---------------------------------------------------------------------------
# Shared conv backbone (MobileNetV1-style depthwise separable stack)
# ---------------------------------------------------------------------------


def _conv_p(kh, kw, cin, cout):
    return {"w": P((kh, kw, cin, cout), (None, None, None, None), scale=1.0),
            "b": P((cout,), (None,), init="zeros")}


def _dw_p(kh, kw, c):
    return {"w": P((kh, kw, 1, c), (None, None, None, None), scale=1.0),
            "b": P((c,), (None,), init="zeros")}


def backbone_params(cfg: VisionConfig) -> dict:
    """Descriptors in the reference's HWIO shapes (so fan-in, and hence the
    init scale, is the reference's); :func:`from_hwio` lays them out."""
    chans = [int(c * cfg.width_mult) for c in cfg.channels]
    p = {"stem": _conv_p(3, 3, 3, chans[0])}
    for i in range(1, len(chans)):
        p[f"dw{i}"] = _dw_p(3, 3, chans[i - 1])
        p[f"pw{i}"] = _conv_p(1, 1, chans[i - 1], chans[i])
    return p


def from_hwio(tree):
    """HWIO ``(kh,kw,cin,cout)`` conv weights -> OIHW ``(cout,cin,kh,kw)``
    (depthwise ``(kh,kw,1,c)`` -> ``(c,1,kh,kw)``); biases as they are."""
    if isinstance(tree, dict):
        return {k: (v.permute(3, 2, 0, 1).contiguous()
                    if k == "w" and not isinstance(v, dict) else from_hwio(v))
                for k, v in tree.items()}
    return tree


def _same_pad(x: torch.Tensor, kh: int, kw: int, stride: int) -> torch.Tensor:
    """XLA ``"SAME"`` padding on an NCHW tensor: output ``ceil(n/stride)``,
    total pad split low = total // 2, high = the rest."""
    def split(n, k):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        return total // 2, total - total // 2

    top, bottom = split(x.shape[2], kh)
    left, right = split(x.shape[3], kw)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom))


def _conv(p, x, stride=1, groups=1):
    w = p["w"].to(x.dtype)
    x = _same_pad(x, w.shape[2], w.shape[3], stride)
    return F.conv2d(x, w, p["b"].to(x.dtype), stride=stride, groups=groups)


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _backbone(cfg: VisionConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """NCHW in, NCHW out."""
    chans = [int(c * cfg.width_mult) for c in cfg.channels]
    x = _relu6(_conv(p["stem"], x, stride=2))
    for i in range(1, len(chans)):
        stride = 2 if i <= 3 else 1
        x = _relu6(_conv(p[f"dw{i}"], x, stride=stride, groups=chans[i - 1]))
        x = _relu6(_conv(p[f"pw{i}"], x))
    return x


def backbone_apply(cfg: VisionConfig, p: dict, x: torch.Tensor
                   ) -> torch.Tensor:
    """x: (B, H, W, 3) in [0,1] -> (B, H/16, W/16, C_top)."""
    return _backbone(cfg, p, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Detector (outer)
# ---------------------------------------------------------------------------


def detector_params(cfg: VisionConfig) -> dict:
    c_top = int(cfg.channels[-1] * cfg.width_mult)
    out = cfg.num_anchors * (cfg.num_classes + 1 + 4)   # +1 background
    return {"backbone": backbone_params(cfg),
            "head": _conv_p(3, 3, c_top, out)}


def init_detector(cfg: VisionConfig, generator: torch.Generator,
                  device=None) -> dict:
    return from_hwio(init_tree(detector_params(cfg), generator, "float32",
                               resolve_device(device)))


def detector_apply(cfg: VisionConfig, p: dict, frames: torch.Tensor):
    """frames: (B, res, res, 3) -> dict of per-anchor predictions.

    Returns {"scores": (B, N, classes+1), "boxes": (B, N, 4)} with N =
    (res/16)^2 * anchors; boxes are (cy, cx, h, w) offsets from cell centres.
    """
    feats = _backbone(cfg, p["backbone"], frames.permute(0, 3, 1, 2))
    # back to NHWC BEFORE the reshape: anchors are laid out (g, g, A, C+4)
    raw = _conv(p["head"], feats).permute(0, 2, 3, 1)    # (B, g, g, A*(C+5))
    B, g = raw.shape[0], raw.shape[1]
    A, C = cfg.num_anchors, cfg.num_classes + 1
    raw = raw.reshape(B, g * g * A, C + 4)
    return {"scores": torch.softmax(raw[..., :C], dim=-1),
            "boxes": raw[..., C:],
            "grid": g}


def decode_detections(cfg: VisionConfig, preds: dict,
                      score_thresh: float = 0.5):
    """Per-frame top detections: (class, score, cy, cx, h, w) tensors."""
    scores = preds["scores"][..., 1:]                    # drop background
    best_c = torch.argmax(scores, dim=-1)                # (B, N), first max
    best_s = torch.amax(scores, dim=-1)
    g = preds["grid"]
    A = cfg.num_anchors
    n = g * g * A
    cell = torch.arange(n, device=scores.device) // A
    cy = ((cell // g).to(torch.float32) + 0.5) / g
    cx = ((cell % g).to(torch.float32) + 0.5) / g
    boxes = torch.sigmoid(preds["boxes"])                # offsets in [0,1]
    out_cy = cy[None, :] + (boxes[..., 0] - 0.5) / g
    out_cx = cx[None, :] + (boxes[..., 1] - 0.5) / g
    h = boxes[..., 2]
    w = boxes[..., 3]
    keep = best_s >= score_thresh
    return {"cls": best_c, "score": best_s, "keep": keep,
            "cy": out_cy, "cx": out_cx, "h": h, "w": w}


def flag_hazards(det: dict, road_y: float = 0.55,
                 road_x: Tuple[float, float] = (0.25, 0.75),
                 tailgate_area: float = 0.18) -> torch.Tensor:
    """Paper §3.2.3 OuterAnalysis flag logic, vectorised over anchors.

    hazard  := non-vehicle detection whose box centre lies in the
               lower-middle "road" region of the frame
    tailgate:= vehicle detection large enough to imply dangerous proximity
    Returns (B, N) bool per-detection danger flags.
    """
    vehicles = torch.tensor(VEHICLE_CLASSES, device=det["cls"].device)
    is_vehicle = torch.isin(det["cls"], vehicles)
    on_road = ((det["cy"] > road_y)
               & (det["cx"] > road_x[0]) & (det["cx"] < road_x[1]))
    hazard = (~is_vehicle) & on_road
    tailgate = is_vehicle & (det["h"] * det["w"] > tailgate_area)
    return det["keep"] & (hazard | tailgate)


# ---------------------------------------------------------------------------
# Pose (inner)
# ---------------------------------------------------------------------------


def pose_params(cfg: VisionConfig) -> dict:
    c_top = int(cfg.channels[-1] * cfg.width_mult)
    return {"backbone": backbone_params(cfg),
            "head": _conv_p(3, 3, c_top, cfg.num_keypoints)}


def init_pose(cfg: VisionConfig, generator: torch.Generator,
              device=None) -> dict:
    return from_hwio(init_tree(pose_params(cfg), generator, "float32",
                               resolve_device(device)))


def pose_apply(cfg: VisionConfig, p: dict, frames: torch.Tensor):
    """frames: (B, res, res, 3) -> keypoints {"y","x","score"}: (B, K)."""
    feats = _backbone(cfg, p["backbone"], frames.permute(0, 3, 1, 2))
    heat = _conv(p["head"], feats).permute(0, 2, 3, 1)   # (B, g, g, K)
    B, g, _, K = heat.shape
    flat = heat.reshape(B, g * g, K)
    idx = torch.argmax(flat, dim=1)                      # (B, K), first max
    score = torch.sigmoid(torch.amax(flat, dim=1))
    ky = ((idx // g).to(torch.float32) + 0.5) / g
    kx = ((idx % g).to(torch.float32) + 0.5) / g
    return {"y": ky, "x": kx, "score": score}


def flag_distraction(kp: dict, hand_line: float = 0.25,
                     eye_margin: float = 0.02,
                     min_score: float = 0.3) -> torch.Tensor:
    """Paper §3.2.3 InnerAnalysis flag logic.

    distracted := a wrist above three-quarters of the frame height (phone to
    the ear), or eyes positioned below the ears (glancing down at a phone).
    y runs top(0) -> bottom(1); "above 3/4 height" = y < ``hand_line``.
    Returns (B,) bool.
    """
    def ok(i):
        return kp["score"][:, i] >= min_score

    hand_up = ((ok(KP_LEFT_WRIST) & (kp["y"][:, KP_LEFT_WRIST] < hand_line))
               | (ok(KP_RIGHT_WRIST) & (kp["y"][:, KP_RIGHT_WRIST] < hand_line)))
    eyes = (kp["y"][:, KP_LEFT_EYE] + kp["y"][:, KP_RIGHT_EYE]) / 2
    ears = (kp["y"][:, KP_LEFT_EAR] + kp["y"][:, KP_RIGHT_EAR]) / 2
    eyes_ok = (ok(KP_LEFT_EYE) & ok(KP_RIGHT_EYE)
               & ok(KP_LEFT_EAR) & ok(KP_RIGHT_EAR))
    glance_down = eyes_ok & (eyes > ears + eye_margin)
    return hand_up | glance_down


# ---------------------------------------------------------------------------
# FLOPs accounting (energy model / roofline)
# ---------------------------------------------------------------------------


def backbone_flops(cfg: VisionConfig) -> float:
    """MACs*2 of one frame through the backbone + a 3x3 head."""
    chans = [int(c * cfg.width_mult) for c in cfg.channels]
    hw = cfg.input_res // 2
    total = 2 * 9 * 3 * chans[0] * hw * hw               # stem
    for i in range(1, len(chans)):
        if i <= 3:
            hw //= 2
        total += 2 * 9 * chans[i - 1] * hw * hw          # depthwise
        total += 2 * chans[i - 1] * chans[i] * hw * hw   # pointwise
    return float(total)


def model_flops(cfg: VisionConfig) -> float:
    chans_top = int(cfg.channels[-1] * cfg.width_mult)
    hw = cfg.input_res // 16
    if cfg.task == "detect":
        out = cfg.num_anchors * (cfg.num_classes + 1 + 4)
    else:
        out = cfg.num_keypoints
    head = 2 * 9 * chans_top * out * hw * hw
    return backbone_flops(cfg) + head


# ---------------------------------------------------------------------------
# Frame downscaling (the paper's pre-inference resize)
# ---------------------------------------------------------------------------


def downscale(frames: torch.Tensor, res: int, *, use_kernels: bool = False,
              method: str = "nearest") -> torch.Tensor:
    """(B, H, W, 3) -> (B, res, res, 3) nearest-neighbour (cheap, like the
    paper's Bitmap scaling).

    ``use_kernels`` dispatches to the ``kernels.vision_ops`` resample kernel
    (normalized fp32 out; bit-identical to the gather for fp32 inputs and
    ``method="nearest"``, box filtering also available); the default gather
    keeps the model functions self-contained.
    """
    if use_kernels:
        from repro_torch.kernels import vision_ops
        return vision_ops.downscale(frames, res, method=method)
    # the gather is nearest-only: refuse rather than silently aliasing
    # when a caller asked for box filtering without the kernel path
    if method != "nearest":
        raise ValueError(f"method={method!r} requires use_kernels=True "
                         f"(kernels.vision_ops)")
    B, H, W, _ = frames.shape
    ys = torch.arange(res, device=frames.device) * H // res
    xs = torch.arange(res, device=frames.device) * W // res
    return frames[:, ys][:, :, xs]


@torch.no_grad()
def analyse_outer(cfg: VisionConfig, params: dict, frames: torch.Tensor):
    """Full outer pipeline: downscale -> detect -> flag.  Returns
    (danger_flags (B,N) bool, detections dict)."""
    x = downscale(frames.to(torch.float32), cfg.input_res)
    det = decode_detections(cfg, detector_apply(cfg, params, x))
    return flag_hazards(det), det


@torch.no_grad()
def analyse_inner(cfg: VisionConfig, params: dict, frames: torch.Tensor):
    """Full inner pipeline: downscale -> pose -> flag.  Returns
    (distracted (B,) bool, keypoints dict)."""
    x = downscale(frames.to(torch.float32), cfg.input_res)
    kp = pose_apply(cfg, params, x)
    return flag_distraction(kp), kp
