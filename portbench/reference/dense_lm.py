"""Plain reference of a dense decoder in the StarCoder2 form, in float32
PyTorch: token embedding; per layer a pre-norm (LayerNorm with bias),
grouped-query attention with biased projections, rotary positions on the
two halves of each head (base ``rope_theta``), a causal mask within the
sliding window, a biased output projection; a pre-norm MLP with biases and
tanh-GELU; a final LayerNorm and the tied embedding as the output head
(arXiv:2402.19173; the sizes are the configuration file's, named as in the
model's ``config.json``).

It imports nothing of the program.  Weights come as the benchmark drew
them, a tree ``{"embed": {"tokens"}, "layers": [{"ln1", "attn": {"wq", "wk",
"wv", "wo"}, "ln2", "mlp": {"wi", "wo"}}], "final_norm"}`` whose products are
``x @ w`` (``w`` of shape (in, out)); they are read in their stored type
and computed in float32 layer by layer, so only one layer's float32 copy
exists at a time.

``precision="control"`` is the nearest precision below the configuration's
bfloat16: every matrix product takes its two operands rounded to float8
(e4m3, one scale a row of the activations and a column of the weights).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the port's ``ModelConfig`` fields this reference computes
PORT_FORM = {"norm": "layernorm", "mlp": "gelu_mlp", "qkv_bias": True,
             "o_bias": True, "mlp_bias": True, "tie_embeddings": True,
             "rope": True, "attention": "sliding"}

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``; float32.
    Under autograd the rounding passes the gradient through unchanged, as
    a low-precision product's backward sees its rounded operands."""
    with torch.no_grad():
        scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
        q = (x / scale).to(FP8).to(torch.float32) * scale
    return x + (q - x).detach() if x.requires_grad else q


class _Fp8Product(torch.autograd.Function):
    """``x @ w`` on operands rounded to float8, the rounding passed through
    by the backward; keeps the rounded activations, not a rounded copy of
    the weights (that would double the weights' memory under autograd)."""

    @staticmethod
    def forward(ctx, x, w):
        xq = _fp8(x.detach(), -1)
        ctx.save_for_backward(xq, w)
        return xq @ _fp8(w.detach(), 0)

    @staticmethod
    def backward(ctx, g):
        xq, w = ctx.saved_tensors
        return g @ _fp8(w.detach(), 0).T, xq.T @ g


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "control":
        return _Fp8Product.apply(x, w.float())
    return x @ w.float()


def _norm(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), cfg["norm_epsilon"])


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D): rotate the halves (x1, x2) by pos * theta^(-2i/D)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = (pos.double()[:, None] * inv[None, :]).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _lin(p: dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    y = mm(x, p["w"], precision)
    return y + p["b"].float() if "b" in p else y


def layer(cfg: dict, p: dict, x: torch.Tensor, pos: torch.Tensor,
          precision: str = "fp32") -> torch.Tensor:
    """One block over a whole sequence x (S, d), positions pos (S,)."""
    S, d = x.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = d // H
    a = p["attn"]
    h = _norm(cfg, p["ln1"], x)
    q = _lin(a["wq"], h, precision).view(S, H, D)
    k = _lin(a["wk"], h, precision).view(S, Hkv, D)
    v = _lin(a["wv"], h, precision).view(S, Hkv, D)
    q = _rope(q, pos, cfg["rope_theta"])
    k = _rope(k, pos, cfg["rope_theta"])
    G = H // Hkv
    qg = q.view(S, Hkv, G, D).permute(1, 2, 0, 3)            # (Hkv,G,S,D)
    kt = k.permute(1, 2, 0)                                   # (Hkv,D,S)
    if precision == "control":
        qg, kt = _fp8(qg, -1), _fp8(kt, -2)
    scores = (qg @ kt[:, None]) / math.sqrt(D)                # (Hkv,G,S,S)
    qp, kp = pos[:, None], pos[None, :]
    allowed = kp <= qp
    if cfg.get("sliding_window"):
        allowed = allowed & (qp - kp < cfg["sliding_window"])
    scores = scores.masked_fill(~allowed, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    vv = v.permute(1, 0, 2)[:, None]                          # (Hkv,1,S,D)
    if precision == "control":
        w, vv = _fp8(w, -1), _fp8(vv, -2)
    o = (w @ vv).permute(2, 0, 1, 3).reshape(S, H * D)
    x = x + _lin(a["wo"], o, precision)
    h = _norm(cfg, p["ln2"], x)
    m = p["mlp"]
    h = F.gelu(_lin(m["wi"], h, precision), approximate="tanh")
    return x + _lin(m["wo"], h, precision)


def logits(cfg: dict, params: dict, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """(S, vocab) float32 logits of every position of ``tokens`` (S,)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"]["tokens"][tokens.long()].float()
    for p in params["layers"]:
        x = layer(cfg, p, x, pos, precision)
    x = _norm(cfg, params["final_norm"], x)
    return mm(x, params["embed"]["tokens"].T, precision)


def loss(cfg: dict, params: dict, tokens: torch.Tensor,
         labels: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """Summed token cross-entropy of one sequence (S,)."""
    lg = logits(cfg, params, tokens, precision)
    return F.cross_entropy(lg, labels.long(), reduction="sum")
