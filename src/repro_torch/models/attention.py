"""GQA attention (full / causal / sliding-window) and its KV caches.

Counterpart of the reference's ``models/attention.py``.  Caches store
explicit key positions (``pos``/``ppos``, -1 = empty) so ring-buffer
sliding-window caches, padded caches and recycled pool blocks mask
correctly without host bookkeeping.

Two layouts:

  * contiguous: per-row rings ``k/v (B, cap, Hkv, D)``, ``pos (B, cap)``;
  * paged: one pool shared by every row, ``kp/vp (nb, bs, Hkv, D)``,
    ``ppos (nb, bs)``, read and written through a block table
    ``pages = {"tbl" (B, M), "len" (B,), "reset" (B,)}``.

Where the port departs from the reference's array semantics:

  * Caches are written IN PLACE (the reference's arrays are immutable and
    every write returns a new cache).  ``_write_cache``'s per-row decode
    path writes one entry per row where the reference rewrites the whole
    cache through a one-hot mask; the result is the same.
  * The reference's scatters use ``mode="drop"``: an out-of-range index
    (position < 0, a -1 table column, the ``nb`` sentinel of a reset) is
    skipped silently.  ``torch`` raises on such an index, so the port masks
    those entries out before it writes.
  * ``dynamic_update_slice`` clamps its start to ``cap - S``; the port's
    chunk write clamps the same way.

Cross-attention (the encoder-decoder's): the decoder's queries against the
encoder's K/V, every position 0, not causal, no window, through
``dot_attention``, so ``use_kernels`` runs the flash kernel in its
non-causal form (at S = 1 too: the decode kernel takes causal rows only).

``RunOpts`` carries the reference's options: ``use_kernels``, ``remat``
(read by ``transformer.apply_stack``), ``block_kv`` (the online-softmax
:func:`blocked_dot_attention`), ``mxu_bf16`` (bf16 operands with fp32
products for the two attention products) and ``attn_specs`` (placements
that DTensor q, k and v are moved to before attention).  The reference's
``unroll_scan`` and ``interpret`` have no counterpart (the blocked
attention is a Python loop, and the kernels have no interpret mode).
Over DTensors the plain attention runs on each rank's local rows and
heads (:func:`_on_local_shards`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.attention_common import paged_gather_plain
from repro_torch.models.layers import apply_rope, dense, dense_params
from repro_torch.sharding.gathered import (ContiguousGrad, is_dtensor,
                                          merged_heads, splittable)

NEG_INF = -1e30


@dataclass(frozen=True)
class RunOpts:
    """Runtime options threaded through model apply functions."""
    use_kernels: bool = False     # hand-written CUDA kernels (plain on CPU)
    remat: str = "none"           # none | full | dots (activation checkpointing)
    # blocked online-softmax attention over KV chunks of this many keys:
    # never materialises the S x C score matrix.  0 = dense path.
    block_kv: int = 0
    # the two attention products on operands rounded to K's/V's dtype,
    # products and sums in fp32 (softmax stays fp32); see dot_attention
    mxu_bf16: bool = False
    # (q spec, k/v spec): ``sharding.rules.PartitionSpec`` placements q, k
    # and v are redistributed to before attention where they are DTensors
    # (the reference's ``with_sharding_constraint``); None leaves them
    attn_specs: Optional[tuple] = None


DEFAULT_OPTS = RunOpts()


def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attention == "sliding" else 0


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attn_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "wq": dense_params(d, cfg.q_dim, "embed", "heads", cfg.qkv_bias),
        "wk": dense_params(d, cfg.kv_dim, "embed", "kv_heads", cfg.qkv_bias),
        "wv": dense_params(d, cfg.kv_dim, "embed", "kv_heads", cfg.qkv_bias),
        "wo": dense_params(cfg.q_dim, d, "heads", "embed", cfg.o_bias),
    }


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int,
                 dtype: Optional[str] = None) -> dict:
    """{name: (shape, dtype)} of one layer's contiguous ring (a sliding
    window clips the capacity to the window)."""
    dt = getattr(torch, dtype or cfg.compute_dtype)
    if cfg.attention == "sliding" and cfg.window:
        capacity = min(capacity, cfg.window)
    kv = (batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (kv, dt), "v": (kv, dt), "pos": ((batch, capacity), torch.int32)}


def paged_cache_shapes(cfg: ModelConfig, num_blocks: int, block_size: int,
                       dtype: Optional[str] = None) -> dict:
    """{name: (shape, dtype)} of one layer's shared block pool: no batch
    dim; the per-request mapping lives in the engine's block table."""
    dt = getattr(torch, dtype or cfg.compute_dtype)
    kv = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"kp": (kv, dt), "vp": (kv, dt),
            "ppos": ((num_blocks, block_size), torch.int32)}


def _materialize(shapes: dict, device) -> dict:
    """Zeros, and -1 (empty) for the int32 position leaves."""
    return {k: (torch.full(s, -1, dtype=dt, device=device)
                if dt == torch.int32 else
                torch.zeros(s, dtype=dt, device=device))
            for k, (s, dt) in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype: Optional[str] = None, device=None) -> dict:
    """One layer's empty contiguous ring, on the card unless ``device``
    says otherwise."""
    return _materialize(cache_shapes(cfg, batch, capacity, dtype),
                        resolve_device(device))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: Optional[str] = None, device=None) -> dict:
    """One layer's empty block pool, on the card unless ``device`` says
    otherwise."""
    return _materialize(paged_cache_shapes(cfg, num_blocks, block_size, dtype),
                        resolve_device(device))


def paged_write_plan(positions: torch.Tensor, pages: dict, num_blocks: int,
                     block_size: int) -> dict:
    """Where ``paged_write`` lands: the same for every layer of one
    forward, so the model computes it once.

    Returns ``{"reset": block ids to invalidate, "src": kept entries of the
    flattened (B*S) new K/V, "dst": their flat pool indices}``.  Position p
    of row b lands in column ``(p // bs) % len[b]`` (the block-granular
    ring).  Entries the reference drops — position < 0, a -1 table column —
    are left out here."""
    bs = block_size
    tbl = pages["tbl"].long()
    own = (tbl >= 0) & (pages["reset"].long()[:, None] > 0)
    pos = positions.long()
    ring = pages["len"].long().clamp(min=1)[:, None]
    col = torch.div(pos, bs, rounding_mode="floor") % ring          # (B,S)
    blk = torch.gather(tbl, 1, col)                                 # (B,S)
    flat = (blk * bs + pos % bs).reshape(-1)
    ok = ((pos >= 0) & (blk >= 0)).reshape(-1)
    src = torch.nonzero(ok).reshape(-1)
    return {"reset": tbl[own], "src": src, "dst": flat[src]}


def paged_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor, pages: dict) -> dict:
    """Scatter S new entries per row into the pool through the block table,
    in place.  A row with ``reset > 0`` first invalidates every entry of
    its own blocks (recycled blocks carry the previous owner's positions).
    ``pages["plan"]`` (from :func:`paged_write_plan`) is used when given."""
    kp, vp, pp = cache["kp"], cache["vp"], cache["ppos"]
    nb, bs = kp.shape[0], kp.shape[1]
    plan = pages.get("plan")
    if plan is None:
        plan = paged_write_plan(positions, pages, nb, bs)
    pp[plan["reset"]] = -1
    feat = kp.shape[2:]
    src, dst = plan["src"], plan["dst"]
    kp.view((nb * bs,) + feat)[dst] = k.reshape((-1,) + feat)[src].to(kp.dtype)
    vp.view((nb * bs,) + feat)[dst] = v.reshape((-1,) + feat)[src].to(vp.dtype)
    pp.view(-1)[dst] = positions.reshape(-1)[src].to(torch.int32)
    return cache


def paged_gather(cache: dict, pages: dict):
    """Plain read: materialise (B, M*bs) logical KV + positions from the
    pool (the kernels read the pool in place instead)."""
    return paged_gather_plain(cache["kp"], cache["vp"], cache["ppos"],
                              pages["tbl"])


def _write_cache(cfg: ModelConfig, cache: dict, k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor, cache_index) -> dict:
    """Write S new entries at ring offset ``cache_index``, in place.

    A per-row ``cache_index`` tensor (continuous batching, S == 1) writes
    one entry per row at ``cache_index[b] % cap``.  A scalar writes the
    chunk at ``cache_index % cap``, its start clamped to ``cap - S`` as
    ``dynamic_update_slice`` clamps (the engine's descending power-of-two
    chunks never need the clamp)."""
    cap = cache["k"].shape[1]
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        if k.shape[1] != 1:
            raise ValueError(f"per-row cache_index needs S == 1, got {k.shape[1]}")
        rows = torch.arange(k.shape[0], device=k.device)
        idx = cache_index.long() % cap
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][rows, idx] = positions[:, 0].to(torch.int32)
        return cache
    S = k.shape[1]
    start = min(max(int(cache_index) % cap, 0), cap - S)
    cache["k"][:, start:start + S] = k.to(cache["k"].dtype)
    cache["v"][:, start:start + S] = v.to(cache["v"].dtype)
    cache["pos"][:, start:start + S] = positions.to(torch.int32)
    return cache


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor,
                  causal: bool, window: int = 0,
                  opts: RunOpts = DEFAULT_OPTS) -> torch.Tensor:
    """q (B,S,Hq,D); k/v (B,C,Hkv,D); *_pos (B,S)/(B,C) absolute positions.
    Returns (B,S,Hq,D).

    The plain path is the reference's ``dot_attention``: a row with no
    valid key softmaxes its NEG_INF scores to UNIFORM weights.  The
    kernels (``use_kernels``) give 0 for such a row, as the reference's
    kernels do; only rows of retired slots are ever fully masked.

    ``opts.mxu_bf16`` rounds the query to K's dtype and the weights to V's
    (bf16 in a bf16 model) and takes both products in fp32 on those
    rounded operands: a product of two bf16 values is exact in fp32, so
    this is the reference's bf16 x bf16 product with
    ``preferred_element_type=float32`` (fp32 scores, fp32 sums) up to the
    order of the sums.  A bf16 ``einsum`` would round the scores to bf16
    before the softmax.  Unlike the reference, the port materialises the
    fp32 copies: torch's bf16 product with an fp32 result exists on CUDA
    only."""
    if opts.use_kernels:
        return kops.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                    window=window)
    if is_dtensor(q):
        return _on_local_shards(
            lambda *a: dot_attention(*a, causal=causal, window=window,
                                     opts=opts), q, k, v, q_pos, kv_pos)
    if opts.block_kv and k.shape[1] % opts.block_kv == 0 \
            and k.shape[1] > opts.block_kv:
        return blocked_dot_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window, block=opts.block_kv)
    B, S, Hq, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    if opts.mxu_bf16:
        scores = torch.einsum("bskgd,bckd->bskgc", qg.to(k.dtype).float(),
                              k.float())
    else:
        scores = torch.einsum("bskgd,bckd->bskgc", qg.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    kv_pos, q_pos = kv_pos.long(), q_pos.long()
    valid = (kv_pos[:, None, :] >= 0).expand(B, S, C)
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid = valid & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    mask = valid[:, :, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    if opts.mxu_bf16:
        out = torch.einsum("bskgc,bckd->bskgd", w.to(v.dtype).float(),
                           v.float())
    else:
        out = torch.einsum("bskgc,bckd->bskgd", w, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)



def _constrain(q, k, v, specs):
    """q, k, v redistributed to the placements of ``specs`` = (q spec,
    k/v spec) on their own mesh."""
    from repro_torch.sharding.rules import placements
    q_spec, kv_spec = specs
    mesh = q.device_mesh
    return (q.redistribute(mesh, placements(mesh, q_spec)),
            k.redistribute(mesh, placements(mesh, kv_spec)),
            v.redistribute(mesh, placements(mesh, kv_spec)))


def _on_local_shards(fn, q, k, v, q_pos, kv_pos):
    """Attention over DTensors, run on each rank's local shards:
    ``fn(q, k, v, q_pos, kv_pos)`` on plain tensors.  Attention is
    independent across rows and heads, so each rank keeps q's rows where
    q is sharded over them (dim 0) and its heads (dim 2) where q and k
    both are, so local q heads meet their own kv heads; every other
    placement is gathered first (a sequence or cache-length shard, heads
    that do not divide the mesh).  Without this, DTensor runs the
    products by merging row and head shards into one strided shard, whose
    sharding search takes about a second a product here."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh

    def as_dt(t):
        if is_dtensor(t):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    k, v, q_pos, kv_pos = (as_dt(t) for t in (k, v, q_pos, kv_pos))
    tq = []
    for pq, pk in zip(q.placements, k.placements):
        if pq == Shard(0):
            tq.append(Shard(0))                       # rows
        elif pq == Shard(2) and pk == Shard(2):
            tq.append(Shard(2))                       # heads, both divide
        else:
            tq.append(Replicate())
    tpos = [p if p == Shard(0) else Replicate() for p in tq]
    local = [ContiguousGrad.apply(t.redistribute(mesh, pl).to_local())
             for t, pl in ((q, tq), (k, tq), (v, tq), (q_pos, tpos),
                           (kv_pos, tpos))]
    out = fn(*local).contiguous()
    shape = list(out.shape)                  # (B, S, H, Dv): v's last dim
    for i, pl in enumerate(tq):
        if pl.is_shard():
            shape[pl.dim] *= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, mesh, tq, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def blocked_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                          causal: bool, window: int = 0,
                          block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``block`` keys (C a
    multiple of it): the reference's ``blocked_dot_attention``, its
    ``lax.scan`` a Python loop carrying the running (m, l, acc), so only
    (B,S,Hkv,G,block) score panels exist.  Differentiable by autograd.  A
    row with no valid key gives 0 (l stays 0), where the dense path gives
    uniform weights."""
    B, S, Hq, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    q_pos = q_pos.long()
    m = torch.full((B, S, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, Hkv, G, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, C, block):
        kb, vb = k[:, c0:c0 + block], v[:, c0:c0 + block]
        pb = kv_pos[:, c0:c0 + block].long()
        s = torch.einsum("bskgd,bckd->bskgc", qg, kb.float()) * scale
        valid = (pb[:, None, :] >= 0).expand(B, S, pb.shape[1])
        if causal:
            valid = valid & (pb[:, None, :] <= q_pos[:, :, None])
        if window:
            valid = valid & ((q_pos[:, :, None] - pb[:, None, :]) < window)
        valid = valid[:, :, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgc,bckd->bskgd", p, vb.float())
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, S, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------


def make_filled_cache(cfg: ModelConfig, k, v, positions, capacity: int):
    """A ring-consistent cache (slot == pos % cap) from prefill K/V; extra
    slots are empty (pos = -1) headroom for decode."""
    B, S = positions.shape
    window = _window(cfg)
    cap = min(window, capacity) if window else capacity
    dt = getattr(torch, cfg.compute_dtype)
    if S >= cap:
        # a roll by (last position + 1) % cap, as a gather on the card:
        # ring slot j holds the tail's element (j - shift) % cap
        shift = (positions[0, -1].long() + 1) % cap
        src = (torch.arange(cap, device=k.device) - shift) % cap
        ck = k[:, -cap:].index_select(1, src)
        cv = v[:, -cap:].index_select(1, src)
        cp = positions[:, -cap:].index_select(1, src)
    else:
        pad = cap - S
        ck = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        cv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cp = torch.nn.functional.pad(positions, (0, pad), value=-1)
    return {"k": ck.to(dt), "v": cv.to(dt), "pos": cp.to(torch.int32)}


def attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
               positions: torch.Tensor,
               cache: Optional[dict] = None,
               cache_index=None,
               causal: bool = True,
               fill_cache: bool = False,
               cache_capacity: Optional[int] = None,
               pages: Optional[dict] = None,
               opts: RunOpts = DEFAULT_OPTS):
    """Self-attention.  Returns (y, new_cache).

    - train:   cache=None, fill_cache=False
    - prefill: cache=None, fill_cache=True  (cache built from k/v)
    - decode:  cache given, cache_index = current write offset
    - paged:   cache is a block pool ({"kp","vp","ppos"}), ``pages`` carries
      the block table; write columns derive from absolute positions
    """
    B, S, _ = x.shape
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    q = splittable(dense(p["wq"], x), -1, H).reshape(B, S, H, cfg.head_dim)
    k = splittable(dense(p["wk"], x), -1, Hkv).reshape(B, S, Hkv,
                                                       cfg.head_dim)
    v = splittable(dense(p["wv"], x), -1, Hkv).reshape(B, S, Hkv,
                                                       cfg.head_dim)
    if opts.attn_specs is not None and is_dtensor(q):
        q, k, v = _constrain(q, k, v, opts.attn_specs)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    window = _window(cfg)
    new_cache = None
    if cache is not None and "kp" in cache:
        if pages is None:
            raise ValueError("paged cache given without a block table "
                             "(pages=None)")
        new_cache = paged_write(cache, k, v, positions, pages)
        if opts.use_kernels:
            out = kops.paged_attention(
                q, new_cache["kp"], new_cache["vp"], new_cache["ppos"],
                pages["tbl"], positions, causal=causal, window=window)
        else:
            kg, vg, pg = paged_gather(new_cache, pages)
            out = dot_attention(q, kg, vg, positions, pg, causal=causal,
                                window=window, opts=opts)
    elif cache is not None:
        new_cache = _write_cache(cfg, cache, k, v, positions, cache_index)
        out = dot_attention(q, new_cache["k"], new_cache["v"],
                            positions, new_cache["pos"],
                            causal=causal, window=window, opts=opts)
    else:
        out = dot_attention(q, k, v, positions, positions,
                            causal=causal, window=window, opts=opts)
        if fill_cache:
            new_cache = make_filled_cache(cfg, k, v, positions,
                                          cache_capacity or S + 64)
    y = dense(p["wo"], merged_heads(out.reshape(B, S, cfg.q_dim), H))
    return y, new_cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------


def cross_attn_params(cfg: ModelConfig) -> dict:
    return attn_params(cfg)


def cross_attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     enc_kv: dict, opts: RunOpts = DEFAULT_OPTS
                     ) -> torch.Tensor:
    """x: (B,S,D); enc_kv: {"k","v"} (B,T,Hkv,Dh) from the encoder (or the
    cache).  Every query and key sits at position 0, not causal: each
    query attends to all T keys."""
    B, S, _ = x.shape
    q = splittable(dense(p["wq"], x), -1, cfg.num_heads).reshape(
        B, S, cfg.num_heads, cfg.head_dim)
    T = enc_kv["k"].shape[1]
    q_pos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    out = dot_attention(q, enc_kv["k"], enc_kv["v"], q_pos, kv_pos,
                        causal=False, window=0, opts=opts)
    return dense(p["wo"], merged_heads(out.reshape(B, S, cfg.q_dim),
                                       cfg.num_heads))


def encode_cross_kv(cfg: ModelConfig, p: dict, enc_out: torch.Tensor) -> dict:
    """The encoder output's cross K/V, each (B, T, Hkv, Dh)."""
    B, T, _ = enc_out.shape
    Hkv = cfg.num_kv_heads
    k = splittable(dense(p["wk"], enc_out), -1, Hkv).reshape(
        B, T, Hkv, cfg.head_dim)
    v = splittable(dense(p["wv"], enc_out), -1, Hkv).reshape(
        B, T, Hkv, cfg.head_dim)
    return {"k": k, "v": v}
