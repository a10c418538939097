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

The fused fleet tick runs a tier group's R replicas at once
(:func:`analyse_outer_stacked`, :func:`analyse_inner_stacked`): their
weights laid out once (:func:`stack_params`), their channels side by side
in one batch in channels-last memory, each layer one grouped convolution
with R times the layer's groups — what ``jax.vmap`` of the reference's
forward folds the replicas into.

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


def stack_params(trees):
    """R replicas' parameter trees (the same structure and shapes) as one
    tree laid out for grouped convolutions, leaf by leaf: each weight
    (O, C/groups, kh, kw) becomes (R*O, C/groups, kh, kw), replica r's
    filters in block r, in channels-last memory (the layout the stacked
    forward's activations take); each bias (R*O,).  The weights of one
    tier group of the fused fleet tick, laid out once at its
    construction."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in trees]) for k in first}
    out = torch.cat(list(trees))
    return (out.contiguous(memory_format=torch.channels_last)
            if out.ndim == 4 else out)


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


def _conv_stacked(p, x, R, stride=1, groups=1):
    """R replicas' convolutions as one grouped convolution: x is
    (B, R*C, H, W), replica r's channels in block r; p holds the
    :func:`stack_params` layout, (R*O, C/groups, kh, kw) with R*groups
    groups, so block r of the output is replica r's convolution."""
    w = p["w"]
    x = _same_pad(x, w.shape[2], w.shape[3], stride)
    return F.conv2d(x, w, p["b"], stride=stride, groups=R * groups)


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


def _backbone_stacked(cfg: VisionConfig, p: dict, x: torch.Tensor,
                      R: int) -> torch.Tensor:
    """:func:`_backbone` for R replicas at once: (B, R*C, H, W) in and
    out, every layer one grouped convolution (stacked weights)."""
    chans = [int(c * cfg.width_mult) for c in cfg.channels]
    x = _relu6(_conv_stacked(p["stem"], x, R, stride=2))
    for i in range(1, len(chans)):
        stride = 2 if i <= 3 else 1
        x = _relu6(_conv_stacked(p[f"dw{i}"], x, R, stride=stride,
                                 groups=chans[i - 1]))
        x = _relu6(_conv_stacked(p[f"pw{i}"], x, R))
    return x


def _head_stacked(cfg: VisionConfig, p: dict, frames: torch.Tensor
                  ) -> torch.Tensor:
    """Backbone and head of R replicas on (R, B, res, res, 3) frames with
    stacked weights ``p``: the replicas' channels side by side in one
    batch of B, one grouped convolution per layer, in channels-last memory
    (cuDNN runs grouped convolutions on NHWC data; NCHW data costs a
    transpose before and after each).  Returns the head's NHWC output for
    the R*B rows, replica-major — each row as the replica's own
    :func:`_backbone` and head give it."""
    R, B, H, W, C = frames.shape
    x = (frames.permute(1, 2, 3, 0, 4).reshape(B, H, W, R * C)
         .permute(0, 3, 1, 2))
    y = _conv_stacked(p["head"], _backbone_stacked(cfg, p["backbone"], x, R),
                      R)
    _, RO, h, w = y.shape
    return (y.permute(0, 2, 3, 1).reshape(B, h, w, R, RO // R)
            .permute(3, 0, 1, 2, 4).reshape(R * B, h, w, RO // R))


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
    return _detections(cfg, _conv(p["head"], feats).permute(0, 2, 3, 1))


def _detections(cfg: VisionConfig, raw: torch.Tensor) -> dict:
    """The detector head's NHWC output (B, g, g, A*(C+5)) as per-anchor
    class probabilities and box offsets."""
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
    return _keypoints(_conv(p["head"], feats).permute(0, 2, 3, 1))


def _keypoints(heat: torch.Tensor) -> dict:
    """Keypoints of the pose head's NHWC heatmaps (B, g, g, K)."""
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


@torch.no_grad()
def analyse_outer_stacked(cfg: VisionConfig, params: dict,
                          frames: torch.Tensor):
    """:func:`analyse_outer` for one tier group of the fused fleet tick:
    (R, B, H, W, 3) frames, ``params`` stacked by :func:`stack_params`.
    Returns (danger flags (R, B, N) bool, detections on the R*B rows)."""
    R, B = frames.shape[:2]
    x = downscale(frames.reshape(R * B, *frames.shape[2:]).to(torch.float32),
                  cfg.input_res)
    raw = _head_stacked(cfg, params, x.reshape(R, B, *x.shape[1:]))
    det = decode_detections(cfg, _detections(cfg, raw))
    return flag_hazards(det).reshape(R, B, -1), det


@torch.no_grad()
def analyse_inner_stacked(cfg: VisionConfig, params: dict,
                          frames: torch.Tensor):
    """:func:`analyse_inner` for one tier group: (R, B, H, W, 3) frames,
    stacked ``params``.  Returns (distracted (R, B) bool, keypoints on the
    R*B rows)."""
    R, B = frames.shape[:2]
    x = downscale(frames.reshape(R * B, *frames.shape[2:]).to(torch.float32),
                  cfg.input_res)
    kp = _keypoints(_head_stacked(cfg, params, x.reshape(R, B, *x.shape[1:])))
    return flag_distraction(kp).reshape(R, B), kp
