"""Reference parameter trees -> the port's weights.

The reference keeps its convolution weights in HWIO layout
``(kh, kw, cin, cout)`` (depthwise ``(kh, kw, 1, c)``); the port keeps
PyTorch's OIHW ``(cout, cin, kh, kw)`` (depthwise ``(c, 1, kh, kw)``), the
same ``permute(3, 2, 0, 1)`` for both.  Inputs are trees of numpy arrays
(``np.asarray`` of the reference's leaves), so this module needs nothing of
the reference package; the parity tests and any checkpoint loader use it.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.vision import from_hwio


def _tensors(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    # np.array copies: the port's weights never alias the caller's arrays
    return torch.as_tensor(np.array(tree), device=device)


def detector_from_jax(np_tree: dict, device=None) -> dict:
    """Detector parameters (``{"backbone": ..., "head": ...}``, HWIO numpy)
    -> port tensors on ``device`` (the card unless ``"cpu"`` is asked)."""
    return from_hwio(_tensors(np_tree, resolve_device(device)))


def pose_from_jax(np_tree: dict, device=None) -> dict:
    """Pose parameters, same layout rule as :func:`detector_from_jax`."""
    return from_hwio(_tensors(np_tree, resolve_device(device)))
