"""Plain reference of DeepSeek-V2 (arXiv:2405.04434; the sizes are the
configuration file's, named as in the model's ``config.json``), in float32
PyTorch: token embedding; per layer an RMSNorm, multi-head latent
attention, an RMSNorm and a feed-forward: a SwiGLU of ``intermediate_size``
in the first ``first_k_dense_replace`` layers, else a mixture of
``n_routed_experts`` SwiGLU experts of ``moe_intermediate_size`` (a
softmax router, the ``num_experts_per_tok`` largest probabilities, raw
where ``norm_topk_prob`` is false, times ``routed_scaling_factor``) beside
``n_shared_experts`` shared experts; a final RMSNorm and an untied output
head.

- MLA in the expanded form: ``q = x @ wq`` (no ``q_lora``), ``[c, k_pe] = x
  @ wkv_a``, ``c`` RMS-normed, ``[k_nope, v] = c @ wkv_b`` a head; the
  rope part of q and the one shared k_pe rotated; scores ``q . [k_nope,
  k_pe]`` times ``mscale ** 2 / sqrt(qk_nope + qk_rope)``, causal softmax.
- YaRN (``rope_scaling``): the frequency ``theta ** (-2i / d)`` kept below
  the correction range of ``beta_fast`` turns over
  ``original_max_position_embeddings``, divided by ``factor`` above that of
  ``beta_slow``, a linear ramp between; cos and sin times
  ``mscale(mscale) / mscale(mscale_all_dim)``; ``mscale(m) = 0.1 m ln
  factor + 1``.
- The MoE computed expert by expert over the tokens routed to each, with
  no capacity: nothing is dropped, as the published model serves.  The
  shared experts as one SwiGLU of ``n_shared_experts *
  moe_intermediate_size``.

Departures from the published model: the rope rotates the two halves of
the 64 rope dimensions, where the checkpoint's are interleaved pairs (a
fixed permutation of the rope columns of ``wq`` and ``wkv_a``, which
changes nothing for seeded weights); the router's top-k takes the largest
probabilities in ``torch.topk``'s order (ties have measure 0).

It imports nothing of the program.  Weights come as the benchmark drew
them, in the program's layout: ``{"embed": {"tokens", "unembed"},
"layers": [{"ln1": {"scale"}, "attn": {"wq", "wkv_a", "kv_norm", "wkv_b",
"wo"}, "ln2": {"scale"}, "mlp": {"wi", "wg", "wo"} or "moe": {"router",
"wi", "wg", "wo" (experts, in, out), "shared": {"wi", "wg", "wo"}}}],
"final_norm": {"scale"}}``, products ``x @ w`` (``w`` (in, out), a matrix
under ``{"w"}``); the gate of each SwiGLU is ``wg``: ``silu(x @ wg) * (x
@ wi) @ wo``.  They are read in their stored type and computed in float32
layer by layer.

``precision="control"`` is the nearest precision below the configuration's
bfloat16: every matrix product, the router's included, takes its two
operands rounded to float8 (``dense_lm.mm``), as do the attention's two
products.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.dense_lm import _fp8, mm

#: the port's ``ModelConfig`` fields this reference computes
PORT_FORM = {"norm": "rmsnorm", "mlp": "swiglu", "attention": "mla",
             "qkv_bias": False, "o_bias": False, "mlp_bias": False,
             "tie_embeddings": False, "rope": True, "parallel_block": False,
             "logit_softcap": 0.0}


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(cfg: dict, pos: torch.Tensor):
    """(cos, sin) (S, rope / 2) at positions ``pos``, YaRN's where the
    configuration scales the rope."""
    d, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    i = torch.arange(0, d, 2, dtype=torch.float64, device=pos.device)
    inv = 1.0 / base ** (i / d)
    factor = 1.0
    rs = cfg.get("rope_scaling")
    if rs:
        factor = float(rs["factor"])
        orig = rs["original_max_position_embeddings"]

        def dim(turns):
            return d * math.log(orig / (turns * 2 * math.pi)) / (
                2 * math.log(base))
        low = max(math.floor(dim(rs["beta_fast"])), 0)
        high = min(math.ceil(dim(rs["beta_slow"])), d - 1)
        ramp = ((torch.arange(d // 2, dtype=torch.float64, device=pos.device)
                 - low) / max(high - low, 1e-3)).clamp(0, 1)
        inv = inv / factor * ramp + inv * (1 - ramp)
    ang = pos.double()[:, None] * inv[None, :]
    att = 1.0
    if rs:
        att = (yarn_mscale(factor, rs.get("mscale", 1.0))
               / yarn_mscale(factor, rs.get("mscale_all_dim", 0.0)))
    return (torch.cos(ang) * att).float(), (torch.sin(ang) * att).float()


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (S, H, d): rotate the halves."""
    h = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def softmax_scale(cfg: dict) -> float:
    s = 1.0 / math.sqrt(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        s *= yarn_mscale(float(rs["factor"]), rs["mscale_all_dim"]) ** 2
    return s


def attention(cfg: dict, a: dict, h: torch.Tensor, cos, sin,
              precision: str) -> torch.Tensor:
    S = h.shape[0]
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    L, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = mm(h, a["wq"]["w"], precision).view(S, H, nope + rope)
    ckv = mm(h, a["wkv_a"]["w"], precision)
    c = _rms(ckv[:, :L], a["kv_norm"], cfg["rms_norm_eps"])
    k_pe = _rope(ckv[:, None, L:], cos, sin)                  # (S, 1, rope)
    kv = mm(c, a["wkv_b"]["w"], precision).view(S, H, nope + dv)
    k = torch.cat([kv[..., :nope], k_pe.expand(S, H, rope)], dim=-1)
    v = kv[..., nope:]
    q = torch.cat([q[..., :nope], _rope(q[..., nope:], cos, sin)], dim=-1)
    qh, kh = q.permute(1, 0, 2), k.permute(1, 2, 0)           # (H,S,D)
    if precision == "control":
        qh, kh = _fp8(qh, -1), _fp8(kh, -2)
    scores = (qh @ kh) * softmax_scale(cfg)                   # (H,S,S)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    vh = v.permute(1, 0, 2)
    if precision == "control":
        w, vh = _fp8(w, -1), _fp8(vh, -2)
    o = (w @ vh).permute(1, 0, 2).reshape(S, H * dv)
    return mm(o, a["wo"]["w"], precision)


def swiglu(p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wg"]["w"], precision))
              * mm(x, p["wi"]["w"], precision), p["wo"]["w"], precision)


def routing(cfg: dict, router: torch.Tensor, x: torch.Tensor,
            precision: str = "fp32"):
    """(weights (S, K), experts (S, K)) of each token."""
    probs = torch.softmax(mm(x, router, precision), dim=-1)
    w, e = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg.get("norm_topk_prob"):
        w = w / w.sum(-1, keepdim=True)
    return w * float(cfg.get("routed_scaling_factor", 1.0)), e


def moe(cfg: dict, p: dict, x: torch.Tensor, precision: str
        ) -> torch.Tensor:
    w, e = routing(cfg, p["router"], x, precision)
    y = torch.zeros_like(x)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(e == j, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = F.silu(mm(xe, p["wg"][j], precision)) * mm(xe, p["wi"][j],
                                                        precision)
        y.index_add_(0, tok, mm(he, p["wo"][j], precision)
                     * w[tok, slot][:, None])
    if cfg.get("n_shared_experts"):
        y = y + swiglu(p["shared"], x, precision)
    return y


def logits(cfg: dict, params: dict, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """(S, vocab) float32 logits of every position of ``tokens`` (S,)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    cos, sin = rope_tables(cfg, pos)
    x = params["embed"]["tokens"][tokens.long()].float()
    for i, p in enumerate(params["layers"]):
        h = _rms(x, p["ln1"]["scale"], eps)
        x = x + attention(cfg, p["attn"], h, cos, sin, precision)
        h = _rms(x, p["ln2"]["scale"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(p["mlp"], h, precision)
        else:
            x = x + moe(cfg, p["moe"], h, precision)
    x = _rms(x, params["final_norm"]["scale"], eps)
    return mm(x, params["embed"]["unembed"], precision)
