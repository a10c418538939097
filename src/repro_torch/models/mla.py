"""DeepSeek-V2 Multi-head Latent Attention (MLA) [arXiv:2405.04434].

Counterpart of the reference's ``models/mla.py``.  Prefill: expand the
compressed latent to per-head K/V and run standard causal attention.
Decode: the *absorbed* formulation — fold ``W_UK``/``W_UV`` into the
query/output so attention runs directly against the compressed cache
``{"c" (B, cap, kv_lora), "k_rope" (B, cap, rope), "pos" (B, cap)}``.

Both run as plain torch operations in fp32 (no kernel: the reference's
MLA reaches no Pallas kernel either), with the scale
``1/sqrt(qk_head_dim)`` in fp32; YaRN (``cfg.rope_scaling``, the port's
own) scales the rope and multiplies the scale by ``mscale ** 2``
(DeepSeek-V2's ``softmax_scale``).  As in ``models/attention.py``, a
decode write lands in the given cache IN PLACE:

  * a per-row ``cache_index`` tensor (continuous batching, S == 1) writes
    one ring row per batch row at ``cache_index[b] % cap`` (the reference
    rewrites the whole cache through a one-hot mask; same result);
  * a scalar ``cache_index`` writes the S-token chunk at
    ``cache_index % cap``, its start clamped to ``cap - S`` as
    ``dynamic_update_slice`` clamps.

A key is valid for a query when its position is >= 0 and <= the query's;
a row with no valid key softmaxes its NEG_INF scores to uniform weights,
as the reference's does.

Paged (the port's own; the reference's MLA is contiguous only): a layer's
block pool ``{"c" (nb, bs, kv_lora), "k_rope" (nb, bs, rope), "ppos" (nb,
bs)}`` in the compute dtype, read and written through the engine's block
table as the K/V pools of ``models/attention.py`` are (``pages``: the same
write plans, so a prefill chunk needs no host sync and replays from a CUDA
graph).  Decode and prefill chunks alike run the absorbed form over the
row's gathered blocks, on compute-dtype operands: the latent products
(scores, the weighted sum) keep fp32 results (cuBLAS's ``out_dtype`` on
the card, no fp32 copy of the latents), the softmax runs in fp32, and the
weights are rounded to the compute dtype for the weighted sum.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, yarn_mscale
from repro_torch.device import resolve_device
from repro_torch.models.attention import (DEFAULT_OPTS, NEG_INF, RunOpts,
                                         _on_local_shards, paged_write_leaves)
from repro_torch.sharding.gathered import is_dtensor, local_rows
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
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, cfg.rope_scaling)
    return q_nope, q_rope


def _compress_kv(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor):
    m = cfg.mla
    ckv = dense(p["wkv_a"], x)
    c, k_rope = ckv[..., : m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = _rmsnorm(c, p["kv_norm"])
    # shared (headless) rope key
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta, cfg.rope_scaling)[:, :, 0, :]
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


def mla_paged_cache_shapes(cfg: ModelConfig, num_blocks: int,
                           block_size: int) -> dict:
    """{name: (shape, dtype)} of one layer's latent block pool."""
    m = cfg.mla
    dt = getattr(torch, cfg.compute_dtype)
    return {"c": ((num_blocks, block_size, m.kv_lora_rank), dt),
            "k_rope": ((num_blocks, block_size, m.qk_rope_dim), dt),
            "ppos": ((num_blocks, block_size), torch.int32)}


def softmax_scale(cfg: ModelConfig) -> float:
    """YaRN's ``mscale(factor, mscale_all_dim) ** 2`` (1 without it); the
    contiguous path multiplies its fp32 ``1/sqrt(qk_head_dim)`` by it."""
    r = cfg.rope_scaling
    if r is None or not r.mscale_all_dim:
        return 1.0
    return yarn_mscale(r.factor, r.mscale_all_dim) ** 2


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) with an fp32 result: compute-dtype operands,
    fp32 products and sums (cuBLAS's ``out_dtype`` on the card; the CPU
    has no such product and takes fp32 copies of the operands)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def paged_gather_latents(cache: dict, tbl: torch.Tensor):
    """Each row's latents from the pool: (c (B, M*bs, kv_lora), k_rope
    (B, M*bs, rope), positions (B, M*bs)); a -1 table column reads block 0
    with positions -1 (``attention_common.paged_gather_plain``'s rule)."""
    nb, bs = cache["ppos"].shape
    B, M = tbl.shape
    idx = tbl.long().clamp(0, nb - 1)
    c = cache["c"][idx].reshape(B, M * bs, -1)
    kr = cache["k_rope"][idx].reshape(B, M * bs, -1)
    pos = torch.where(tbl[:, :, None] >= 0, cache["ppos"][idx],
                      -1).reshape(B, M * bs)
    return c, kr, pos


def _paged_absorbed(cfg: ModelConfig, p: dict, q_nope: torch.Tensor,
                    q_rope: torch.Tensor, cache: dict, pages: dict,
                    positions: torch.Tensor) -> torch.Tensor:
    """Absorbed attention of (B, S) queries over each row's blocks, on
    compute-dtype operands (module docstring).  Returns (B, S, H * v)."""
    m = cfg.mla
    B, S, H, _ = q_nope.shape
    L, nope, dv = m.kv_lora_rank, m.qk_nope_dim, m.v_head_dim
    dt = cache["c"].dtype
    wkv_b = p["wkv_b"]["w"].to(dt).reshape(L, H, nope + dv)
    w_uk = wkv_b[..., :nope].permute(1, 2, 0)               # (H, nope, L)
    w_uv = wkv_b[..., nope:].permute(1, 0, 2)               # (H, L, v)
    qn = q_nope.to(dt).permute(2, 0, 1, 3).reshape(H, B * S, nope)
    q_c = torch.bmm(qn, w_uk).reshape(H, B, S, L).permute(1, 2, 0, 3)
    q_c = q_c.reshape(B, S * H, L)
    q_r = q_rope.to(dt).reshape(B, S * H, m.qk_rope_dim)
    c, kr, kv_pos = paged_gather_latents(cache, pages["tbl"])
    scale = m.qk_head_dim ** -0.5 * softmax_scale(cfg)
    scores = (_mm_f32(q_c, c.transpose(1, 2))
              + _mm_f32(q_r, kr.transpose(1, 2))) * scale    # (B, S*H, C)
    valid = ((kv_pos[:, None, :] >= 0)
             & (kv_pos[:, None, :] <= positions.long()[:, :, None]))
    valid = valid[:, :, None, :].expand(B, S, H, c.shape[1])
    scores = torch.where(valid.reshape(B, S * H, -1), scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out_c = _mm_f32(w.to(dt), c).to(dt)                     # (B, S*H, L)
    out_c = out_c.reshape(B, S, H, L).permute(2, 0, 1, 3).reshape(H, B * S, L)
    out = torch.bmm(out_c, w_uv)                            # (H, B*S, v)
    return out.reshape(H, B, S, dv).permute(1, 2, 0, 3).reshape(B, S, H * dv)


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


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, S, X) -> (B, S + pad, X), zeros after; a DTensor on each rank's
    rows (DTensor's pad of a row split fails on some torch)."""
    if is_dtensor(t):
        local, wrap = local_rows(t, t)
        return wrap(torch.nn.functional.pad(local, (0, 0, 0, pad)))
    return torch.nn.functional.pad(t, (0, 0, 0, pad))


def mla_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[dict] = None,
              cache_index=None,
              fill_cache: bool = False,
              cache_capacity: Optional[int] = None,
              pages: Optional[dict] = None,
              opts: RunOpts = DEFAULT_OPTS):
    """Returns (y, new_cache).  ``cache`` a latent ring, or a latent block
    pool with ``pages`` its block table (``attention.attn_apply``'s).
    ``opts`` is taken for the attention module's signature; no option
    changes MLA."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c, k_rope = _compress_kv(cfg, p, x, positions)
    if cache is not None and "ppos" in cache:
        # ---- paged: absorbed, over the row's blocks ----
        if pages is None:
            raise ValueError("paged cache given without a block table "
                             "(pages=None)")
        new_cache = paged_write_leaves(cache, {"c": c, "k_rope": k_rope},
                                       positions, pages)
        out = _paged_absorbed(cfg, p, q_nope, q_rope, new_cache, pages,
                              positions)
        return dense(p["wo"], out.to(x.dtype)), new_cache

    scale = 1.0 / torch.sqrt(torch.tensor(float(m.qk_head_dim),
                                          dtype=torch.float32,
                                          device=x.device))
    if softmax_scale(cfg) != 1.0:
        scale = scale * softmax_scale(cfg)

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

    def attend(q, k, v, q_pos, kv_pos):
        scores = torch.einsum("bshd,bchd->bshc", q.float(), k.float()) * scale
        causal = q_pos[:, :, None] >= kv_pos[:, None, :]
        scores = torch.where(causal[:, :, None, :], scores,
                             torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bshc,bchv->bshv", w, v.float())

    if is_dtensor(q):
        # on each rank's local rows and heads (attention._on_local_shards)
        out = _on_local_shards(attend, q, k, v, positions, positions)
    else:
        out = attend(q, k, v, positions, positions)
    y = dense(p["wo"], out.reshape(B, S, H * m.v_head_dim).to(x.dtype))
    new_cache = None
    if fill_cache:
        dt = getattr(torch, cfg.compute_dtype)
        cap = cache_capacity or S + 64
        pad = max(cap - S, 0)
        new_cache = {
            "c": _pad_seq(c, pad).to(dt),
            "k_rope": _pad_seq(k_rope, pad).to(dt),
            "pos": torch.nn.functional.pad(positions, (0, pad),
                                           value=-1).to(torch.int32),
        }
    return y, new_cache
