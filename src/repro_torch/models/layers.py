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
    pairs), with frequencies computed in fp32; YaRN (the port's own,
    ``config.RopeScaling``) blends them as DeepSeek-V2 does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, RopeScaling, yarn_mscale
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


#: {(head_dim, theta, scaling, device): frequencies} of :func:`rope_freqs`
#: on a card
_CARD_FREQS: dict = {}


def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32,
                               device=device) ** exps)


def yarn_correction_range(head_dim: int, theta: float,
                          scaling: RopeScaling) -> tuple:
    """(low, high): YaRN's ramp runs over frequency indices low..high of
    the ``head_dim / 2``; index i turns ``max_position / (2 pi theta **
    (2i / head_dim))`` times over the original context.  DeepSeek-V2's
    ``yarn_find_correction_range``: the index of ``beta_fast`` turns
    floored, of ``beta_slow`` ceiled, clipped to the dims."""
    def dim(turns):
        return (head_dim * math.log(scaling.original_max_position
                                    / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(dim(scaling.beta_fast))
    high = math.ceil(dim(scaling.beta_slow))
    return max(low, 0), min(high, head_dim - 1)


def _yarn_freqs(head_dim: int, theta: float, scaling: RopeScaling,
                device) -> torch.Tensor:
    """YaRN's blend (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``): the
    plain frequencies below index ``low``, those over ``factor`` above
    ``high``, a linear ramp between, in fp32."""
    extra = _rope_freqs(head_dim, theta, device)
    inter = extra / scaling.factor
    low, high = yarn_correction_range(head_dim, theta, scaling)
    if low == high:
        high += 0.001                   # the published guard
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_attention_factor(scaling: Optional[RopeScaling]) -> float:
    """The factor YaRN puts on cos and sin: ``mscale(mscale) /
    mscale(mscale_all_dim)`` (1 without scaling, and for DeepSeek-V2,
    whose two are equal)."""
    if scaling is None:
        return 1.0
    return (yarn_mscale(scaling.factor, scaling.mscale)
            / yarn_mscale(scaling.factor, scaling.mscale_all_dim))


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None,
               scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """(head_dim / 2,) fp32 ``1 / theta ** (2i / head_dim)``, theta rounded
    to fp32 first; YaRN's blend of them where ``scaling`` is given.  On a
    card the vector is computed once per (head_dim, theta, scaling,
    device) and kept: its upload of ``theta`` waits for the card, twice a
    layer in every forward, and a CUDA graph cannot hold it.  The kept
    tensor is shared; callers do not write to it."""
    def make():
        if scaling is None:
            return _rope_freqs(head_dim, theta, device)
        return _yarn_freqs(head_dim, theta, scaling, device)
    if device is None or torch.device(device).type != "cuda":
        return make()
    key = (head_dim, theta, scaling, torch.device(device))
    freqs = _CARD_FREQS.get(key)
    if freqs is None:
        freqs = _CARD_FREQS[key] = make()
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, scaling: Optional[RopeScaling] = None
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int.  Rotates the split
    halves ``x[..., :D/2]`` and ``x[..., D/2:]``, in fp32; YaRN's
    frequencies and cos/sin factor where ``scaling`` is given."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device, scaling)           # (d/2,)
    ang = positions[..., None].float() * freqs                # (..., S, d/2)
    sin = torch.sin(ang)[..., None, :]                        # over heads
    cos = torch.cos(ang)[..., None, :]
    factor = rope_attention_factor(scaling)
    if factor != 1.0:
        sin, cos = sin * factor, cos * factor
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
