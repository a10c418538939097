"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU
[arXiv:2402.19427].

Counterpart of the reference's ``models/rglru.py``:

Block:  x -> (W1 -> causal conv4 -> RG-LRU) * gelu(W2) -> Wout
RG-LRU: r_t = sigmoid(blockdiag(Wa) u_t + ba)
        i_t = sigmoid(blockdiag(Wx) u_t + bx)
        a_t = exp(-c * softplus(Lambda) * r_t),  c = 8
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The plain path scans with log2(S) doubling steps, as the reference's
``lax.associative_scan`` (with ``h0`` folded into step 0); ``use_kernels``
routes the scan to the hand kernel (``kernels.rglru.rglru_scan``).  A
1-token input with a cache is one recurrence step and never reaches the
kernel.  The decode cache is ``{"h": (B,W) fp32, "conv": (B, cw-1, W)}``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import rglru as rglru_k
from repro_torch.models.layers import gelu
from repro_torch.models.param import P

_C = 8.0  # RG-LRU temperature


def rglru_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    H = cfg.num_heads
    hd = w // H
    cw = cfg.conv_width
    return {
        "w_in": P((d, w), ("embed", "lru")),
        "w_gate": P((d, w), ("embed", "lru")),
        "w_out": P((w, d), ("lru", "embed")),
        "conv_w": P((cw, w), ("conv", "lru")),
        "conv_b": P((w,), ("lru",), init="zeros"),
        "gate_a_w": P((H, hd, hd), ("heads", None, None)),
        "gate_a_b": P((H, hd), ("heads", None), init="zeros"),
        "gate_x_w": P((H, hd, hd), ("heads", None, None)),
        "gate_x_b": P((H, hd), ("heads", None), init="zeros"),
        # softplus(lambda) ~ uniform-ish decay spectrum at init
        "lam": P((w,), ("lru",), init="ones", scale=1.0),
    }


def _causal_conv(p: dict, u: torch.Tensor, conv_cache: Optional[torch.Tensor]):
    """u: (B,S,W).  Returns (y, new_conv_cache (B,cw-1,W)): the cache is
    cast to u's dtype and the new one is the last cw-1 rows."""
    cw = p["conv_w"].shape[0]
    if conv_cache is None:
        pad = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = conv_cache.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                # (B, S+cw-1, W)
    S = u.shape[1]
    y = torch.zeros_like(u)
    for i in range(cw):
        y = y + full[:, i: i + S] * p["conv_w"][i].to(u.dtype)
    y = y + p["conv_b"].to(u.dtype)
    return y, full[:, -(cw - 1):]


def _gates(cfg: ModelConfig, p: dict, u: torch.Tensor):
    """u: (B,S,W) -> (a, gated input b), both fp32."""
    B, S, W = u.shape
    H = cfg.num_heads
    hd = W // H
    uh = u.reshape(B, S, H, hd).float()
    r = torch.sigmoid(torch.einsum("bshi,hio->bsho", uh,
                                   p["gate_a_w"].float())
                      + p["gate_a_b"].float())
    i = torch.sigmoid(torch.einsum("bshi,hio->bsho", uh,
                                   p["gate_x_w"].float())
                      + p["gate_x_b"].float())
    r = r.reshape(B, S, W)
    i = i.reshape(B, S, W)
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12))
    b = beta * (i * u.float())
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               use_kernel: bool = False) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1.  a, b: (B,S,W) fp32.

    Plain: h0 folded into step 0, then an inclusive scan of the pairs
    (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2) in log2(S)
    doubling steps (the reference's associative scan; another tree, so
    the rounding differs in the last bits)."""
    if use_kernel:
        return rglru_k.rglru_scan(a, b, h0)
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], 1)
        shift *= 2
    return b


def rglru_block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      cache: Optional[dict] = None,
                      fill_cache: bool = False,
                      use_kernel: bool = False):
    """x: (B,S,D).  Returns (y, new_cache)."""
    u = x @ p["w_in"].to(x.dtype)                    # (B,S,W)
    g = gelu(x @ p["w_gate"].to(x.dtype))
    conv_cache = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(p, u, conv_cache)
    a, b = _gates(cfg, p, u)
    h0 = cache["h"].float() if cache is not None else None
    if x.shape[1] == 1 and cache is not None:
        # decode: one recurrence step, never the kernel
        h = (a[:, 0] * h0 + b[:, 0])[:, None, :]
    else:
        h = rglru_scan(a, b, h0, use_kernel=use_kernel)
    new_cache = None
    if cache is not None or fill_cache:
        # a contiguous copy, not a view of h: a later chunk hands it to the
        # scan kernel as h0
        new_cache = {"h": h[:, -1].float().contiguous(),
                     "conv": new_conv.to(getattr(torch, cfg.compute_dtype))}
    y = (h.to(x.dtype) * g) @ p["w_out"].to(x.dtype)
    return y, new_cache


def cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of one RG-LRU layer's state."""
    w = cfg.lru_width or cfg.d_model
    return {"h": ((batch, w), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, w),
                     getattr(torch, cfg.compute_dtype))}


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero state by ``transformer.init_caches``' sentinel rule, on the
    card unless ``device`` says otherwise."""
    from repro_torch.models.transformer import materialize_caches
    return materialize_caches(cache_shapes(cfg, batch), resolve_device(device))
