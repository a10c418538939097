"""Reference parameter trees (and caches) -> the port's tensors.

Vision models: the reference keeps its convolution weights in HWIO layout
``(kh, kw, cin, cout)`` (depthwise ``(kh, kw, 1, c)``); the port keeps
PyTorch's OIHW ``(cout, cin, kh, kw)`` (depthwise ``(c, 1, kh, kw)``), the
same ``permute(3, 2, 0, 1)`` for both.  Inputs are trees of numpy arrays
(``np.asarray`` of the reference's leaves), so this module needs nothing of
the reference package; the parity tests and any checkpoint loader use it.

Transformers: the reference groups layers into segments run by
``lax.scan``, each leaf of a repeated segment stacked with a leading layer
axis (``models/transformer.py`` ``plan_layers``/``model_param_tree``).
The port keeps one parameter dict per layer and one cache dict per layer,
so :func:`transformer_from_jax` and :func:`caches_from_jax` unstack.  A
hybrid pattern is a multi-position period (recurrentgemma-9b: (RG-LRU,
RG-LRU, attention) x 12 + RG-LRU x 2; xlstm-350m: (7 x mLSTM, sLSTM) x 3):
position j of repeat r is layer ``r * len(period) + j``.  A segment's
signature also carries the layer's MoE flag, so an MoE stack with dense
first layers splits into segments (deepseek-v2-236b: one dense layer, then
the MoE layers stacked); an MoE layer's experts are already stacked
``(E, d, ff)`` in the reference and stay so, the repeat axis in front of
them is the one unstacked.  MLA trees (``wq_a``/``q_norm``/``wq_b`` or
``wq``, ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``) and latent caches
(``c``, ``k_rope``, ``pos``), recurrent state leaves (``h``, ``conv``,
``C``, ``n``, ``m``, ``c``) are carried across as they are.  An
encoder-decoder's encoder segments unstack the same way with
``encoder_plan`` (its ``final_norm`` beside them); its decoder layers'
``ln_cross``/``cross`` weights and ``cross_k``/``cross_v`` cache leaves, and
a VLM's ``patch_proj``, are carried across as they are.  Weights keep their
``(d_in, d_out)`` layout: no transpose.  bf16 leaves (numpy's extension
type) are carried across by their bits.  :func:`opt_state_from_jax`
carries an AdamW state: moments and gradients map as the weights do.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import encoder_plan, plan_layers
from repro_torch.models.vision import from_hwio


def _tensors(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    # np.array copies: the port's weights never alias the caller's arrays
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        # numpy's bf16 is an extension type torch cannot read: its bits
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def detector_from_jax(np_tree: dict, device=None) -> dict:
    """Detector parameters (``{"backbone": ..., "head": ...}``, HWIO numpy)
    -> port tensors on ``device`` (the card unless ``"cpu"`` is asked)."""
    return from_hwio(_tensors(np_tree, resolve_device(device)))


def pose_from_jax(np_tree: dict, device=None) -> dict:
    """Pose parameters, same layout rule as :func:`detector_from_jax`."""
    return from_hwio(_tensors(np_tree, resolve_device(device)))


def _unstack(segments: list, cfg: ModelConfig, plan=None,
             layers_wanted=None) -> list:
    """The reference's segment list -> one tree per layer, in order (the
    decoder's plan unless ``plan`` is given)."""
    plan = plan_layers(cfg) if plan is None else plan
    wanted = cfg.num_layers if layers_wanted is None else layers_wanted
    layers = []
    for (sig, repeats), seg in zip(plan, segments):
        for r in range(repeats):
            for j in range(len(sig)):
                tree = seg[f"b{j}"]
                layers.append(_index(tree, r) if repeats > 1 else tree)
    if len(layers) != wanted:
        raise ValueError(f"{len(layers)} layers unstacked, config has "
                         f"{wanted}")
    return layers


def _index(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def transformer_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference transformer parameters (numpy leaves, scanned segments)
    -> ``{"embed", "final_norm", "layers": [per layer]}`` on ``device``,
    plus ``"encoder": {"layers", "final_norm"}`` (encoder-decoder) and
    ``"patch_proj"`` (VLM) where the reference tree has them."""
    dev = resolve_device(device)
    out = {"embed": _tensors(np_tree["embed"], dev),
           "final_norm": _tensors(np_tree["final_norm"], dev),
           "layers": [_tensors(t, dev)
                      for t in _unstack(np_tree["segments"], cfg)]}
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        out["encoder"] = {
            "layers": [_tensors(t, dev) for t in _unstack(
                enc["segments"], cfg, encoder_plan(cfg),
                cfg.num_encoder_layers)],
            "final_norm": _tensors(enc["final_norm"], dev)}
    if "patch_proj" in np_tree:
        out["patch_proj"] = _tensors(np_tree["patch_proj"], dev)
    return out


def caches_from_jax(np_caches: list, cfg: ModelConfig, device=None) -> list:
    """Reference caches (numpy leaves, one entry per segment: contiguous
    rings or paged pools) -> the port's list of per-layer cache dicts."""
    dev = resolve_device(device)
    return [_tensors(t, dev) for t in _unstack(np_caches, cfg)]


def opt_state_from_jax(np_state: dict, cfg: ModelConfig, device=None) -> dict:
    """A reference AdamW state (``{"mu", "nu"}`` trees like its parameters,
    ``step``; numpy leaves) -> the port's, in the port's layout: the map
    of :func:`transformer_from_jax` is leaf-wise, so it carries the
    moments (and gradients) as it carries the weights."""
    dev = resolve_device(device)
    return {"mu": transformer_from_jax(np_state["mu"], cfg, dev),
            "nu": transformer_from_jax(np_state["nu"], cfg, dev),
            "step": torch.as_tensor(np.array(np_state["step"]),
                                    dtype=torch.int32, device=dev)}
