"""DeepSeek-V2 Multi-head Latent Attention (MLA) [arXiv:2405.04434].

Counterpart of the reference's ``models/mla.py``.  Prefill: expand the
compressed latent to per-head K/V and run standard causal attention.
Decode: the *absorbed* formulation — fold ``W_UK``/``W_UV`` into the
query/output so attention runs directly against the compressed cache
``{"c" (B, cap, kv_lora), "k_rope" (B, cap, rope), "pos" (B, cap)}``.

Both run as plain torch operations in fp32 (no kernel: the reference's
MLA reaches no Pallas kernel either), with the scale
``1/sqrt(qk_head_dim)`` in fp32.  As in ``models/attention.py``, a decode
write lands in the given cache IN PLACE:

  * a per-row ``cache_index`` tensor (continuous batching, S == 1) writes
    one ring row per batch row at ``cache_index[b] % cap`` (the reference
    rewrites the whole cache through a one-hot mask; same result);
  * a scalar ``cache_index`` writes the S-token chunk at
    ``cache_index % cap``, its start clamped to ``cap - S`` as
    ``dynamic_update_slice`` clamps.

A key is valid for a query when its position is >= 0 and <= the query's;
a row with no valid key softmaxes its NEG_INF scores to uniform weights,
as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import DEFAULT_OPTS, NEG_INF, RunOpts
from repro_torch.models.layers import apply_rope, dense, dense_params
from repro_torch.models.param import P


def mla_params(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = dense_params(d, m.q_lora_rank, "embed", "q_lora")
        p["q_norm"] = P((m.q_lora_rank,), ("norm",), init="ones")
        p["wq_b"] = dense_params(m.q_lora_rank, H * m.qk_head_dim, "q_lora",
                                 "heads")
    else:
        p["wq"] = dense_params(d, H * m.qk_head_dim, "embed", "heads")
    p["wkv_a"] = dense_params(d, m.kv_lora_rank + m.qk_rope_dim, "embed",
                              "kv_lora")
    p["kv_norm"] = P((m.kv_lora_rank,), ("norm",), init="ones")
    p["wkv_b"] = dense_params(m.kv_lora_rank,
                              H * (m.qk_nope_dim + m.v_head_dim),
                              "kv_lora", "heads")
    p["wo"] = dense_params(H * m.v_head_dim, d, "heads", "embed")
    return p


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _project_q(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor):
    m = cfg.mla
    B, S, _ = x.shape
    if m.q_lora_rank:
        q = dense(p["wq_b"], _rmsnorm(dense(p["wq_a"], x), p["q_norm"]))
    else:
        q = dense(p["wq"], x)
    q = q.reshape(B, S, cfg.num_heads, m.qk_head_dim)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _compress_kv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    m = cfg.mla
    ckv = dense(p["wkv_a"], x)
    c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = _rmsnorm(c, p["kv_norm"])
    # shared (headless) rope key
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c, k_rope


def mla_cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                     dtype: Optional[str] = None) -> dict:
    """{name: (shape, dtype)} of one layer's latent cache."""
    m = cfg.mla
    dt = getattr(torch, dtype or cfg.compute_dtype)
    return {"c": ((batch, capacity, m.kv_lora_rank), dt),
            "k_rope": ((batch, capacity, m.qk_rope_dim), dt),
            "pos": ((batch, capacity), torch.int32)}


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int,
                   dtype: Optional[str] = None, device=None) -> dict:
    """One layer's empty latent cache (``pos`` -1), on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    return {k: (torch.full(s, -1, dtype=dt, device=dev) if k == "pos"
                else torch.zeros(s, dtype=dt, device=dev))
            for k, (s, dt) in mla_cache_shapes(cfg, batch, capacity,
                                               dtype).items()}


def _write_cache(cache: dict, c: torch.Tensor, k_rope: torch.Tensor,
                 positions: torch.Tensor, cache_index) -> dict:
    """Write the new latents in place (see the module docstring)."""
    cap = cache["c"].shape[1]
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        if c.shape[1] != 1:
            raise ValueError(f"per-row cache_index needs S == 1, got "
                             f"{c.shape[1]}")
        rows = torch.arange(c.shape[0], device=c.device)
        idx = cache_index.long() % cap
        cache["c"][rows, idx] = c[:, 0].to(cache["c"].dtype)
        cache["k_rope"][rows, idx] = k_rope[:, 0].to(cache["k_rope"].dtype)
        cache["pos"][rows, idx] = positions[:, 0].to(torch.int32)
        return cache
    S = c.shape[1]
    start = min(max(int(cache_index) % cap, 0), cap - S)
    cache["c"][:, start:start + S] = c.to(cache["c"].dtype)
    cache["k_rope"][:, start:start + S] = k_rope.to(cache["k_rope"].dtype)
    cache["pos"][:, start:start + S] = positions.to(torch.int32)
    return cache


def mla_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[dict] = None,
              cache_index=None,
              fill_cache: bool = False,
              cache_capacity: Optional[int] = None,
              opts: RunOpts = DEFAULT_OPTS):
    """Returns (y, new_cache).  ``opts`` is taken for the attention
    module's signature; no option changes MLA."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c, k_rope = _compress_kv(cfg, p, x, positions)
    scale = 1.0 / torch.sqrt(torch.tensor(float(m.qk_head_dim),
                                          dtype=torch.float32,
                                          device=x.device))

    if cache is not None:
        # ---- absorbed decode against the compressed cache ----
        new_cache = _write_cache(cache, c, k_rope, positions, cache_index)
        wkv_b = p["wkv_b"]["w"].reshape(m.kv_lora_rank, H,
                                        m.qk_nope_dim + m.v_head_dim)
        w_uk = wkv_b[..., : m.qk_nope_dim].float()          # (L,H,nope)
        w_uv = wkv_b[..., m.qk_nope_dim:].float()           # (L,H,v)
        q_c = torch.einsum("bshn,lhn->bshl", q_nope.float(), w_uk)
        cc = new_cache["c"].float()
        kr = new_cache["k_rope"].float()
        scores = (torch.einsum("bshl,bcl->bshc", q_c, cc)
                  + torch.einsum("bshr,bcr->bshc", q_rope.float(), kr)) * scale
        kv_pos = new_cache["pos"].long()[:, None, :]
        valid = (kv_pos >= 0) & (kv_pos <= positions.long()[:, :, None])
        scores = torch.where(valid[:, :, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        out_c = torch.einsum("bshc,bcl->bshl", w, cc)
        out = torch.einsum("bshl,lhv->bshv", out_c, w_uv)
        y = dense(p["wo"], out.reshape(B, S, H * m.v_head_dim).to(x.dtype))
        return y, new_cache

    # ---- expanded prefill/train ----
    kv = dense(p["wkv_b"], c).reshape(B, S, H, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., : m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H,
                                                        m.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    scores = torch.einsum("bshd,bchd->bshc", q.float(), k.float()) * scale
    causal = positions[:, :, None] >= positions[:, None, :]
    scores = torch.where(causal[:, :, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bshc,bchv->bshv", w, v.float())
    y = dense(p["wo"], out.reshape(B, S, H * m.v_head_dim).to(x.dtype))
    new_cache = None
    if fill_cache:
        dt = getattr(torch, cfg.compute_dtype)
        cap = cache_capacity or S + 64
        pad = max(cap - S, 0)
        new_cache = {
            "c": torch.nn.functional.pad(c, (0, 0, 0, pad)).to(dt),
            "k_rope": torch.nn.functional.pad(k_rope, (0, 0, 0, pad)).to(dt),
            "pos": torch.nn.functional.pad(positions, (0, pad),
                                           value=-1).to(torch.int32),
        }
    return y, new_cache
