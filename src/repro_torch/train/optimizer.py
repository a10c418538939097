"""AdamW with fp32 update math, written in place on the caller's tensors:
the reference's ``train/optimizer.py`` on trees of tensors.

Trees are nested dicts and lists of tensors (the port's parameter layout).
The update keeps the reference's order of operations, leaf by leaf:
gradient times the global-norm clip scale, both moments in fp32, bias
correction with ``step`` as fp32, ``delta = mhat / (sqrt(nhat) + eps) + wd
* p``, ``p - lr * delta`` in fp32 cast back to the parameter's dtype,
moments stored in ``state_dtype``.  ``torch.optim.AdamW`` is not used: it
decays before the moment step and has no global-norm clip or schedule.

``adamw_update`` writes the results into the parameters' and moments'
own tensors (the port's counterpart of the reference launcher's
``donate_argnums``): no second copy of the weights and moments exists
during the update (a 3 B model's bf16 weights and fp32 moments take 30
GB of one card).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.models.param import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | constant
    min_lr_frac: float = 0.1
    # bf16 moments halve the optimizer's memory (update math stays fp32)
    state_dtype: str = "float32"


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine, linear or constant decay to
    ``min_lr_frac``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:  # cosine
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * decay


def init_opt_state(params: Any, state_dtype: str = "float32") -> dict:
    """Zero moments in ``state_dtype`` beside each parameter (placed as
    it is, where it is a DTensor), and ``step`` an int32 0 on the first
    parameter's device."""
    dt = getattr(torch, state_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt,
                                       memory_format=torch.contiguous_format)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(t.float())) for t in tree_leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, params: Any,
                 state: dict) -> Tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics = {"grad_norm", "lr"}).

    The new values are written into ``params``' and ``state``'s own
    tensors, and the returned trees hold those tensors: a caller that
    needs the old values clones them first."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    lr = schedule_lr(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    sdt = getattr(torch, cfg.state_dtype)

    def upd(g, p, mu, nu):
        g = g.float() * scale
        mu2 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu2 = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(g)
        mhat = mu2 / b1c
        nhat = nu2 / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p2 = p.float() - lr * delta
        if mu.dtype != sdt or nu.dtype != sdt:
            raise ValueError(f"moments are {mu.dtype}/{nu.dtype}, the "
                             f"config's state dtype {sdt}")
        p.copy_(p2)                  # cast to the parameter's dtype
        mu.copy_(mu2)                # and to the state dtype
        nu.copy_(nu2)

    tree_map(upd, grads, params, state["mu"], state["nu"])
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
