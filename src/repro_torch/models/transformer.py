"""Model assembly: params, caches, forward, for attention (GQA or MLA,
dense or MoE MLP), RG-LRU and xLSTM stacks, the encoder-decoder and the
VLM.

Counterpart of the reference's ``models/transformer.py``, for dense
attention stacks (GQA, full or sliding window, biases, the parallel block:
``starcoder2-3b``/``-7b``, ``qwen1.5-32b``, ``command-r-plus-104b``), MoE
stacks (``granite-moe-1b-a400m``; layers from ``moe.first_dense_layers``
on route their MLP through ``models/moe.py``), multi-head latent attention
(``deepseek-v2-236b``: ``models/mla.py``, MLA + MoE with one dense first
layer), the hybrid RG-LRU + local-attention stack (``recurrentgemma-9b``)
and the mLSTM + sLSTM stack (``xlstm-350m``); the encoder-decoder
(``whisper-base``: a non-causal encoder stack over stub frame embeddings,
sinusoidal positions, a cross-attention branch in every decoder layer) and
the VLM (``internvl2-2b``: stub patch embeddings projected by
``patch_proj`` over the prompt's first ``num_patches`` embeddings).  The
reference groups layers into
scanned segments of stacked parameters (``plan_layers``; hybrid patterns
become multi-position periods); the port runs its layers as a Python loop
over per-layer parameter dicts (``params["layers"]``) and per-layer cache
dicts (a list), with nothing stacked.  ``convert.transformer_from_jax``
unstacks a reference tree into this layout; the encoder's layers are
``params["encoder"]["layers"]``, beside its ``final_norm``.

Caches: an attention layer holds a contiguous ring or a paged pool
(``models/attention.py``), an MLA layer its latent ring ``{"c", "k_rope",
"pos"}`` (contiguous only, as in the reference); a recurrent layer holds its state, ``{"h",
"conv"}`` (RG-LRU), ``{"C", "n", "m"}`` (mLSTM) or ``{"c", "n", "h",
"m"}`` (sLSTM).  :func:`init_caches` fills them with the reference's
sentinels by leaf name (:func:`materialize_caches`): int leaves -1, every
``m`` -1e30, a 2-D ``n`` 1.  An encoder-decoder's attention layers also
hold ``cross_k``/``cross_v`` (B, ``encoder_seq``, Hkv, Dh) in the compute
dtype: zeros until a ``prefill`` with frames fills them, and a cache that
holds them wins over frames passed later, as in the reference.

``forward`` returns the reference's MoE aux loss (the sum over MoE
layers; serving ignores it, :func:`lm_loss` adds it to the cross-entropy).
``opts.remat`` checkpoints every layer of :func:`apply_stack` (decoder and
encoder): ``"full"`` saves the layer's input only, ``"dots"`` also the
outputs of its matrix products without a batch dimension (the reference's
``checkpoint_dots_with_no_batch_dims``: ``aten.mm``/``aten.addmm``, the
projections; the attention and expert ``bmm`` are recomputed).  The
reference checkpoints a scanned period (one layer, or a hybrid pattern's
period) at a time; the gradients are the same.  ``extras`` carries the
stub frontends' inputs: ``{"frames": (B, T, d_model)}`` (encoder-decoder:
``forward`` runs the encoder only when they are given) and ``{"patches":
(B, num_patches, d_model)}`` (VLM).
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config import (ATTN, MLSTM, RGLRU, SLSTM, ModelConfig,
                                ShapeConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import DEFAULT_OPTS, RunOpts
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_params,
                                       embed_tokens, mlp_params, norm_params,
                                       sinusoidal_positions, unembed)
from repro_torch.models.param import P, abstract_tree, init_tree
from repro_torch.sharding.gathered import is_dtensor, settle

# ---------------------------------------------------------------------------
# Layer planning
# ---------------------------------------------------------------------------


def _layer_sigs(cfg: ModelConfig):
    sigs = []
    for i, kind in enumerate(cfg.layer_kinds()):
        moe_flag = (cfg.moe.enabled and kind == ATTN
                    and i >= cfg.moe.first_dense_layers)
        sigs.append((kind, moe_flag))
    return sigs


def plan_layers(cfg: ModelConfig):
    """The reference's segment plan: list of (period_sigs, repeats).  The
    port's forward does not use it; ``convert`` reads the reference's
    stacked parameter and cache trees with it."""
    sigs = _layer_sigs(cfg)
    if cfg.unroll_layers:
        return [((s,), 1) for s in sigs]
    segments = []
    i = 0
    while i < len(sigs):
        best_period, best_repeats = 1, 1
        for period in range(1, min(8, len(sigs) - i) + 1):
            pat = sigs[i: i + period]
            r = 1
            while sigs[i + r * period: i + (r + 1) * period] == pat:
                r += 1
            if (r * period > best_period * best_repeats
                    or (r * period == best_period * best_repeats
                        and period < best_period)):
                best_period, best_repeats = period, r
        segments.append((tuple(sigs[i: i + best_period]), best_repeats))
        i += best_period * best_repeats
    return segments


def encoder_plan(cfg: ModelConfig):
    """The reference's layer plan of the (whisper-style) encoder stack:
    ``num_encoder_layers`` plain attention blocks, one stacked segment
    unless ``unroll_layers``.  ``convert`` reads the reference's encoder
    tree with it."""
    sig = ((ATTN, False),)
    if cfg.unroll_layers:
        return [(sig, 1)] * cfg.num_encoder_layers
    return [(sig, cfg.num_encoder_layers)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layer kind the port does not know."""
    kinds = set(cfg.layer_kinds())
    if not kinds <= {ATTN, RGLRU, MLSTM, SLSTM}:
        raise NotImplementedError(
            f"arch {cfg.name!r} (family {cfg.family!r}, layers "
            f"{sorted(kinds)}) has a layer kind the port does not run: "
            f"attention, RG-LRU, mLSTM and sLSTM blocks run")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _block_params(cfg: ModelConfig, kind: str, moe_flag: bool,
                  cross: bool = False) -> dict:
    p = {"ln1": norm_params(cfg)}
    if kind == ATTN:
        p["attn"] = (mla_mod.mla_params(cfg) if cfg.attention == "mla"
                     else attn_mod.attn_params(cfg))
        if cross:
            p["ln_cross"] = norm_params(cfg)
            p["cross"] = attn_mod.cross_attn_params(cfg)
        if cfg.d_ff > 0 or moe_flag:
            if not cfg.parallel_block:
                p["ln2"] = norm_params(cfg)
            if moe_flag:
                p["moe"] = moe_mod.moe_params(cfg)
            else:
                p["mlp"] = mlp_params(cfg)
    elif kind == RGLRU:
        p["mix"] = rglru_mod.rglru_params(cfg)
        if cfg.d_ff:
            p["ln2"] = norm_params(cfg)
            p["mlp"] = mlp_params(cfg)
    elif kind == MLSTM:
        p["mix"] = ssm_mod.mlstm_params(cfg)
    elif kind == SLSTM:
        p["mix"] = ssm_mod.slstm_params(cfg)
        p["ln2"] = norm_params(cfg)
    else:
        raise ValueError(kind)
    return p


def model_param_tree(cfg: ModelConfig) -> dict:
    """Descriptor tree: ``{"embed", "final_norm", "layers": [per layer]}``;
    an encoder-decoder adds ``"encoder": {"layers", "final_norm"}`` (and a
    cross-attention branch in every decoder layer), a VLM
    ``"patch_proj": {"w"}``."""
    check_supported(cfg)
    cross = cfg.family == "encdec"
    tree = {"embed": embed_params(cfg), "final_norm": norm_params(cfg),
            "layers": [_block_params(cfg, kind, moe_flag, cross=cross)
                       for kind, moe_flag in _layer_sigs(cfg)]}
    if cfg.family == "encdec":
        tree["encoder"] = {
            "layers": [_block_params(cfg, ATTN, False)
                       for _ in range(cfg.num_encoder_layers)],
            "final_norm": norm_params(cfg)}
    if cfg.family == "vlm":
        tree["patch_proj"] = {"w": P((cfg.d_model, cfg.d_model),
                                     ("embed", "embed2"))}
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random weights from ``generator``'s seed, drawn on the card unless
    ``device="cpu"`` (``param.init_tree``: the host and the card give
    other numbers for one seed)."""
    return init_tree(model_param_tree(cfg), generator, cfg.param_dtype,
                     resolve_device(device))


def abstract_params(cfg: ModelConfig, device="meta"):
    """The parameter tree's shapes and dtypes, holding no data
    (``param.abstract_tree``: meta tensors, or fake ones on ``device``
    under a ``FakeTensorMode``)."""
    return abstract_tree(model_param_tree(cfg), cfg.param_dtype, device)


# ---------------------------------------------------------------------------
# Caches (a list of per-layer dicts)
# ---------------------------------------------------------------------------


def _block_cache_shapes(cfg: ModelConfig, kind: str, batch: int,
                        capacity: int, cross: bool = False) -> dict:
    if kind == ATTN:
        if cfg.attention == "mla":
            c = mla_mod.mla_cache_shapes(cfg, batch, capacity)
        else:
            c = attn_mod.cache_shapes(cfg, batch, capacity)
        if cross:
            kv = ((batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim),
                  getattr(torch, cfg.compute_dtype))
            c = dict(c, cross_k=kv, cross_v=kv)
        return c
    if kind == RGLRU:
        return rglru_mod.cache_shapes(cfg, batch)
    if kind == MLSTM:
        return ssm_mod.mlstm_cache_shapes(cfg, batch)
    if kind == SLSTM:
        return ssm_mod.slstm_cache_shapes(cfg, batch)
    raise ValueError(kind)


def materialize_caches(shapes: dict, device) -> dict:
    """Empty cache leaves from ``{name: (shape, dtype)}``, with the
    reference's sentinels by leaf name (its ``_materialize_caches``): int
    leaves -1 (empty slot), every ``m`` -1e30 (log-sum-exp identity), a
    2-D ``n`` 1 (sLSTM normaliser floor), the rest 0."""
    out = {}
    for name, (shape, dt) in shapes.items():
        if dt == torch.int32:
            fill = -1
        elif name == "m":
            fill = -1e30
        elif name == "n" and len(shape) == 2:
            fill = 1.0
        else:
            fill = 0
        out[name] = torch.full(shape, fill, dtype=dt, device=device)
    return out


def init_caches(cfg: ModelConfig, batch: int, capacity: int,
                device=None) -> List[dict]:
    """Empty contiguous caches, one dict per layer: attention rings (MLA:
    latent rings; an encoder-decoder's also zero ``cross_k``/``cross_v``)
    and recurrent states, on the card unless ``device="cpu"``."""
    check_supported(cfg)
    dev = resolve_device(device)
    cross = cfg.family == "encdec"
    return [materialize_caches(
        _block_cache_shapes(cfg, kind, batch, capacity, cross), dev)
        for kind in cfg.layer_kinds()]


def cache_shapes(cfg: ModelConfig, batch: int, capacity: int) -> List[dict]:
    """``[{name: (shape, dtype)}]``, one dict per layer, of
    :func:`init_caches`' leaves."""
    check_supported(cfg)
    cross = cfg.family == "encdec"
    return [_block_cache_shapes(cfg, kind, batch, capacity, cross)
            for kind in cfg.layer_kinds()]


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device="meta") -> dict:
    """Tensors holding no data (meta, or fake on ``device`` under a
    ``FakeTensorMode``) of every model input of this cell, with the
    shapes and dtypes of the reference's ``input_specs``; a decode cell's
    ``caches`` are per layer, as :func:`init_caches` gives them."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cdt = getattr(torch, cfg.compute_dtype)

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device=device)

    def frontends(specs):
        if cfg.family == "encdec":
            specs["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), cdt)
        if cfg.family == "vlm":
            specs["patches"] = sds((B, cfg.num_patches, cfg.d_model), cdt)
        return specs

    if shape.kind == "train":
        return frontends({"tokens": sds((B, S), i32),
                          "labels": sds((B, S), i32),
                          "mask": sds((B, S), torch.float32)})
    if shape.kind == "prefill":
        return frontends({"tokens": sds((B, S), i32)})
    # decode: one new token against a cache of S entries
    return {"tokens": sds((B, 1), i32), "index": sds((), i32),
            "caches": [{k: sds(*v) for k, v in layer.items()}
                       for layer in cache_shapes(cfg, B, S)]}


def paged_eligible(cfg: ModelConfig) -> bool:
    """Paged KV needs every layer to be plain attention with a standard
    K/V cache: no MLA, no recurrent state, no encoder-decoder cross-K/V."""
    return (all(kind == ATTN for kind in cfg.layer_kinds())
            and cfg.attention in ("full", "sliding")
            and cfg.family != "encdec")


def init_paged_caches(cfg: ModelConfig, num_blocks: int, block_size: int,
                      device=None) -> List[dict]:
    """Empty paged caches (all blocks free, ``ppos`` -1), one pool per
    layer."""
    if not paged_eligible(cfg):
        raise ValueError(f"paged KV cache unsupported for arch "
                         f"{cfg.name!r} (layers {cfg.layer_kinds()}, "
                         f"attention {cfg.attention!r}, family "
                         f"{cfg.family!r})")
    check_supported(cfg)
    dev = resolve_device(device)
    return [attn_mod.init_paged_cache(cfg, num_blocks, block_size, device=dev)
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_block(cfg: ModelConfig, kind: str, moe_flag: bool, p: dict,
                 x: torch.Tensor, *, positions, cache, cache_index, causal,
                 fill_cache, cache_capacity, enc_out, pages, opts: RunOpts):
    """One block.  Returns (x, new_cache, aux): aux is the MoE layer's
    load-balance loss, None for any other block.

    A block with a cross-attention branch reads the encoder's K/V from the
    cache when it holds ``cross_k`` (even when ``enc_out`` was given, as in
    the reference), else projects ``enc_out``; a returned cache carries
    them on."""
    if kind in (MLSTM, SLSTM) and is_dtensor(x):
        return _block_on_local_rows(
            cfg, kind, moe_flag, p, x, positions=positions, cache=cache,
            cache_index=cache_index, causal=causal, fill_cache=fill_cache,
            cache_capacity=cache_capacity, enc_out=enc_out, pages=pages,
            opts=opts)
    xn = apply_norm(cfg, p["ln1"], x)
    if kind == ATTN:
        own = (None if cache is None else
               {k: v for k, v in cache.items() if not k.startswith("cross_")})
        if cfg.attention == "mla":
            a_out, ncache = mla_mod.mla_apply(
                cfg, p["attn"], xn, positions=positions, cache=own,
                cache_index=cache_index, fill_cache=fill_cache,
                cache_capacity=cache_capacity, opts=opts)
        else:
            a_out, ncache = attn_mod.attn_apply(
                cfg, p["attn"], xn, positions=positions, cache=own,
                cache_index=cache_index, causal=causal,
                fill_cache=fill_cache, cache_capacity=cache_capacity,
                pages=pages, opts=opts)
        if "cross" in p:
            if cache is not None and "cross_k" in cache:
                enc_kv = {"k": cache["cross_k"], "v": cache["cross_v"]}
            else:
                enc_kv = attn_mod.encode_cross_kv(cfg, p["cross"], enc_out)
            if ncache is not None:
                dt = getattr(torch, cfg.compute_dtype)
                ncache = dict(ncache, cross_k=enc_kv["k"].to(dt),
                              cross_v=enc_kv["v"].to(dt))
        aux = None
        has_mlp = cfg.d_ff > 0 or moe_flag
        if cfg.parallel_block and has_mlp:
            x = x + a_out + apply_mlp(cfg, p["mlp"], xn)
        else:
            x = x + a_out
            if "cross" in p:
                xc = apply_norm(cfg, p["ln_cross"], x)
                x = x + attn_mod.cross_attn_apply(cfg, p["cross"], xc,
                                                  enc_kv, opts=opts)
            if has_mlp:
                xn2 = apply_norm(cfg, p["ln2"], x)
                if moe_flag:
                    m_out, aux = moe_mod.moe_apply(cfg, p["moe"], xn2)
                else:
                    m_out = apply_mlp(cfg, p["mlp"], xn2)
                x = x + m_out
        return x, ncache, aux
    if kind == RGLRU:
        mix, ncache = rglru_mod.rglru_block_apply(
            cfg, p["mix"], xn, cache=cache, fill_cache=fill_cache,
            use_kernel=opts.use_kernels)
        x = x + mix
        if cfg.d_ff:
            x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        return x, ncache, None
    if kind == MLSTM:
        mix, ncache = ssm_mod.mlstm_block_apply(
            cfg, p["mix"], xn, cache=cache, fill_cache=fill_cache,
            use_kernel=opts.use_kernels)
        return x + mix, ncache, None
    if kind == SLSTM:
        mix, ncache = ssm_mod.slstm_mixer_apply(cfg, p["mix"], xn,
                                                cache=cache,
                                                fill_cache=fill_cache)
        x = x + mix
        x = x + ssm_mod.slstm_ffn_apply(p["mix"], apply_norm(cfg, p["ln2"], x))
        return x, ncache, None
    raise ValueError(kind)



def _block_on_local_rows(cfg: ModelConfig, kind: str, moe_flag: bool,
                         p: dict, x: torch.Tensor, *, cache, **kw):
    """An xLSTM block over DTensors: each rank runs its own rows as plain
    tensors, the block's weights gathered (``sharding.gathered``).  The
    sLSTM's recurrence is a loop over tokens and the mLSTM's heads merge
    with rows in its products; DTensor's per-op placement search would
    cost more than the whole block."""
    from repro_torch.models.param import tree_map
    from repro_torch.sharding.gathered import local_rows, replicated_local
    xl, wrap = local_rows(x, x)
    # the weights' gradients: each rank's rows' partial sums
    pl = tree_map(lambda t: replicated_local(t, rows_of=x)[0], p)
    cl = None if cache is None else {k: local_rows(v, x)[0]
                                     for k, v in cache.items()}
    y, nc, aux = _apply_block(cfg, kind, moe_flag, pl, xl, cache=cl, **kw)
    return wrap(y), (None if nc is None else {k: wrap(v)
                                              for k, v in nc.items()}), aux


def apply_stack(cfg: ModelConfig, layers: list, sigs: list,
                x: torch.Tensor, *, positions, caches: Optional[list],
                cache_index, causal: bool, fill_cache: bool,
                cache_capacity: Optional[int] = None, enc_out=None,
                pages: Optional[dict] = None, opts: RunOpts = DEFAULT_OPTS):
    """Run the blocks ``layers`` (per-layer params, signatures ``sigs``)
    in order.  Returns (x, new_caches (a list, or None without caches),
    aux: the MoE layers' summed loss, an fp32 0 without one)."""
    want_cache = caches is not None or fill_cache
    new_caches: Optional[list] = [] if want_cache else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, ((kind, moe_flag), p) in enumerate(zip(sigs, layers)):
        block = partial(
            _apply_block, cfg, kind, moe_flag, p, positions=positions,
            cache=caches[i] if caches is not None else None,
            cache_index=cache_index, causal=causal, fill_cache=fill_cache,
            cache_capacity=cache_capacity, enc_out=enc_out, pages=pages,
            opts=opts)
        x, nc, a = (block(x) if opts.remat == "none"
                    else _remat(block, opts.remat)(x))
        if a is not None:
            aux = aux + a
        if want_cache:
            new_caches.append(nc)
    return x, new_caches, aux


#: the matrix products "dots" saves: those without a batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` under activation checkpointing: ``"full"`` recomputes the
    whole layer in the backward pass, ``"dots"`` keeps its projections'
    outputs.  Any other policy raises, as the reference's ``_remat``."""
    if policy == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _save_dots))
    raise ValueError(policy)


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor,
           opts: RunOpts = DEFAULT_OPTS) -> torch.Tensor:
    """frames: (B, T, d_model) stub frontend embeddings -> the encoder's
    output (B, T, d_model): sinusoidal positions added, the non-causal
    encoder stack (self-attention with q_pos = kv_pos = 0..T-1), its final
    norm.  Runs on ``frames``' device."""
    B, T, _ = frames.shape
    pos = torch.arange(T, dtype=torch.int32, device=frames.device).repeat(B, 1)
    x = frames.to(getattr(torch, cfg.compute_dtype))
    x = x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    enc = params["encoder"]
    sigs = [(ATTN, False)] * len(enc["layers"])
    x, _, _ = apply_stack(cfg, enc["layers"], sigs, x, positions=pos,
                          caches=None, cache_index=None, causal=False,
                          fill_cache=False, opts=opts)
    return apply_norm(cfg, enc["final_norm"], x)


def _embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                  positions: torch.Tensor, extras: dict) -> torch.Tensor:
    """Token embeddings; an encoder-decoder adds sinusoidal positions; a
    VLM given ``patches`` writes ``patches @ patch_proj.w`` over the first
    ``num_patches`` embeddings when the prompt is at least that long (a
    shorter chunk keeps its token embeddings, as in the reference)."""
    x = embed_tokens(cfg, params["embed"], tokens)
    if cfg.family == "encdec":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    if cfg.family == "vlm" and "patches" in extras:
        patches = (extras["patches"].to(x.dtype)
                   @ params["patch_proj"]["w"].to(x.dtype))
        npatch = patches.shape[1]
        if tokens.shape[1] >= npatch:
            x = torch.cat([patches, x[:, npatch:]], dim=1)
    return x


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[list] = None,
            cache_index=None,
            fill_cache: bool = False,
            cache_capacity: Optional[int] = None,
            extras: Optional[dict] = None,
            last_only: bool = False,
            pages: Optional[dict] = None,
            opts: RunOpts = DEFAULT_OPTS):
    """Returns (logits, new_caches, aux).

    ``caches`` is a list of per-layer dicts (contiguous rings, or paged
    pools with ``pages = {"tbl" (B, M), "len" (B,), "reset" (B,)}``); they
    are updated in place and returned.  ``aux`` is the reference's MoE
    auxiliary loss: the sum of every MoE layer's, an fp32 0 without
    one.  ``extras``: ``"frames"`` (encoder-decoder: the encoder runs only
    when they are given; decode steps omit them and read the cross K/V
    from the cache) and ``"patches"`` (VLM)."""
    check_supported(cfg)
    extras = extras or {}
    B, S = tokens.shape
    if positions is None:
        # materialised (not a stride-0 view): the kernels take contiguous
        # position rows
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).repeat(B, 1)
    if pages is not None and caches is not None:
        # where the new K/V land is the same for every layer
        kp = caches[0]["kp"]
        pages = dict(pages, plan=attn_mod.paged_write_plan(
            positions, pages, kp.shape[0], kp.shape[1]))
    x = _embed_inputs(cfg, params, tokens, positions, extras)
    enc_out = None
    if cfg.family == "encdec" and "frames" in extras:
        enc_out = encode(cfg, params, extras["frames"], opts=opts)
    x, new_caches, aux = apply_stack(
        cfg, params["layers"], _layer_sigs(cfg), x, positions=positions,
        caches=caches, cache_index=cache_index, causal=True,
        fill_cache=fill_cache, cache_capacity=cache_capacity,
        enc_out=enc_out, pages=pages, opts=opts)
    x = apply_norm(cfg, params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    logits = unembed(cfg, params["embed"], x)
    return logits, new_caches, aux


def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            opts: RunOpts = DEFAULT_OPTS):
    """Cross-entropy LM loss.  batch: ``tokens``/``labels`` (B, S) int,
    ``mask`` (B, S) optional, ``frames``/``patches`` where the family
    takes them.  Returns ``(loss + aux, {"nll": loss, "aux": aux})``: an
    fp32 log-sum-exp minus the gold logit, averaged under the mask over
    ``max(sum(mask), 1)``, plus the MoE load-balance loss."""
    extras = {k: batch[k] for k in ("frames", "patches") if k in batch}
    logits, _, aux = forward(cfg, params, batch["tokens"], extras=extras,
                             opts=opts)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = settle(torch.gather(logits, -1, batch["labels"].long()[..., None]))
    gold = gold[..., 0]
    nll = lse - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return loss + aux, {"nll": loss, "aux": aux}


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            extras: Optional[dict] = None,
            cache_capacity: Optional[int] = None,
            opts: RunOpts = DEFAULT_OPTS):
    """Returns (last_logits (B,1,V), caches)."""
    logits, caches, _ = forward(cfg, params, tokens, fill_cache=True,
                                cache_capacity=cache_capacity,
                                extras=extras, last_only=True, opts=opts)
    return logits, caches


def decode_step(cfg: ModelConfig, params: dict, caches: list,
                tokens: torch.Tensor, index, extras: Optional[dict] = None,
                opts: RunOpts = DEFAULT_OPTS):
    """One decode step.  tokens: (B,1); index: scalar position.  Returns
    (logits (B,1,V), caches)."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=tokens.device)
    logits, new_caches, _ = forward(cfg, params, tokens, positions=positions,
                                    caches=caches, cache_index=index,
                                    extras=extras, opts=opts)
    return logits, new_caches
