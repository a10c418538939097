"""Core layers: norms, dense projections, embeddings, RoPE, activations.

Counterpart of the reference's ``models/layers.py``.  Weights keep the
reference's ``(d_in, d_out)`` layout and every projection computes
``x @ w``, so a converted parameter needs no transpose.  Where the two
frameworks' defaults differ, the port follows the reference:

  * ``jax.nn.gelu`` is the tanh approximation; ``torch`` defaults to erf,
    so the port asks for ``approximate="tanh"``.
  * ``jnp.var`` is the population variance (``correction=0``); the norm
    runs in fp32 and casts back to the input's dtype.
  * RoPE rotates the two split halves of the head dim (not interleaved
    pairs), with frequencies computed in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.param import P
from repro_torch.sharding.gathered import is_dtensor, vocab_parallel_lookup

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_params(cfg: ModelConfig) -> dict:
    p = {"scale": P((cfg.d_model,), ("norm",), init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = P((cfg.d_model,), ("norm",), init="zeros")
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + cfg.norm_eps) * p["scale"].float()
    else:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


def dense_params(d_in: int, d_out: int, in_ax: str, out_ax: str,
                 bias: bool = False, scale: float = 1.0) -> dict:
    p = {"w": P((d_in, d_out), (in_ax, out_ax), scale=scale)}
    if bias:
        p["b"] = P((d_out,), (out_ax,), init="zeros")
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_params(cfg: ModelConfig, d_ff: Optional[int] = None,
               mlp_ax: str = "mlp") -> dict:
    ff = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "wi": dense_params(d, ff, "embed", mlp_ax, cfg.mlp_bias),
            "wg": dense_params(d, ff, "embed", mlp_ax, cfg.mlp_bias),
            "wo": dense_params(ff, d, mlp_ax, "embed", cfg.mlp_bias),
        }
    return {  # gelu_mlp
        "wi": dense_params(d, ff, "embed", mlp_ax, cfg.mlp_bias),
        "wo": dense_params(ff, d, mlp_ax, "embed", cfg.mlp_bias),
    }


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        h = F.silu(dense(p["wg"], x)) * dense(p["wi"], x)
    elif cfg.mlp == "geglu":
        h = gelu(dense(p["wg"], x)) * dense(p["wi"], x)
    else:
        h = gelu(dense(p["wi"], x))
    return dense(p["wo"], h)


# ---------------------------------------------------------------------------
# Embeddings / positions
# ---------------------------------------------------------------------------


def embed_params(cfg: ModelConfig) -> dict:
    p = {"tokens": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                     init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def embed_tokens(cfg: ModelConfig, p: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    dtype = getattr(torch, cfg.compute_dtype)
    table = p["tokens"]
    if is_dtensor(table):
        # each rank in its own vocab split (sharding.gathered): DTensor's
        # index and embedding backward over a vocab split fail on some torch
        return vocab_parallel_lookup(table, tokens).to(dtype)
    return table[tokens.long()].to(dtype)


def unembed(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["tokens"].to(x.dtype).T
    else:
        w = p["unembed"].to(x.dtype)
    logits = x @ w
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def sinusoidal_positions(positions: torch.Tensor, dim: int,
                         max_timescale: float = 10_000.0) -> torch.Tensor:
    """(..., dim) sinusoidal embedding for integer positions (...,).  The
    frequencies are built on ``positions``' device (no host copy a call),
    in fp32, with the reference's operations in its order."""
    half = dim // 2
    dev = positions.device
    freqs = torch.exp(-torch.log(torch.tensor(max_timescale, device=dev))
                      * torch.arange(half, dtype=torch.float32, device=dev)
                      / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


#: {(head_dim, theta, device): frequencies} of :func:`rope_freqs` on a card
_CARD_FREQS: dict = {}


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exps)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """(head_dim / 2,) fp32 ``1 / theta ** (2i / head_dim)``, theta rounded
    to fp32 first.  On a card the vector is computed once per (head_dim,
    theta, device) and kept: its upload of ``theta`` waits for the card,
    twice a layer in every forward, and a CUDA graph cannot hold it.  The
    kept tensor is shared; callers do not write to it."""
    if device is None or torch.device(device).type != "cuda":
        return _rope_freqs(head_dim, theta, device)
    key = (head_dim, theta, torch.device(device))
    freqs = _CARD_FREQS.get(key)
    if freqs is None:
        freqs = _CARD_FREQS[key] = _rope_freqs(head_dim, theta, device)
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Rotates the split
    halves ``x[..., :D/2]`` and ``x[..., D/2:]``, in fp32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (d/2,)
    ang = positions[..., None].float() * freqs                # (..., S, d/2)
    sin = torch.sin(ang)[..., None, :]                        # over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
