"""Device resolution for the port's entry points.

Entry points (``VisionServeEngine``, ``MotionGate``, the model
initialisers) run on the card unless the caller asks for the CPU.  A
caller that asks for nothing on a machine without CUDA gets an error,
never a silent CPU run: a CPU number must never pass for a card number.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current CUDA device; anything else is taken as
    given.  Raises ``RuntimeError`` when CUDA is asked for (explicitly or
    by default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
