"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with recurrent gate connections) [arXiv:2405.04517].

Counterpart of the reference's ``models/ssm.py``.

mLSTM parallel (stabilized) form, per head:
    D_ts = F_t - F_s + i_s   (s <= t; -inf otherwise), F = cumsum(logsig(f))
    m    = rowmax(D)
    S    = (Q K^T / sqrt(d)) * exp(D - m)
    n    = max(|rowsum(S)|, exp(-m))
    H    = (S / n) V

mLSTM recurrent (decode) form:
    m'   = max(logsig(f) + m, i)
    C'   = exp(logsig(f)+m-m') C + exp(i-m') v k^T
    n'   = exp(logsig(f)+m-m') n + exp(i-m') k
    h    = C' q / max(|n'.q|, exp(-m'))

Two behaviours of the reference are kept as they are: the block divides k
by sqrt(Dh) before both forms, which divide q by sqrt(Dh) again; and the
chunked kernel (``use_kernel``) runs in chunks of 128
(``kernels.mlstm.DEFAULT_CHUNK``), never ``cfg.mlstm_chunk``.  sLSTM is a
true sequential recurrence (gate preactivations include R h_{t-1}), a
Python loop over time with block-diagonal R per head.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.models.layers import gelu
from repro_torch.models.param import P

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    inner = int(d * cfg.mlstm_proj_factor)
    return {
        "w_up": P((d, inner), ("embed", "inner")),
        "w_gate": P((d, inner), ("embed", "inner")),
        "wq": P((inner, inner), ("inner", "inner2")),
        "wk": P((inner, inner), ("inner", "inner2")),
        "wv": P((inner, inner), ("inner", "inner2")),
        "wi": P((inner, cfg.num_heads), ("inner", None)),
        "wf": P((inner, cfg.num_heads), ("inner", None)),
        "bi": P((cfg.num_heads,), (None,), init="zeros"),
        # positive forget bias => long memory at init
        "bf": P((cfg.num_heads,), (None,), init="ones", scale=3.0),
        "w_down": P((inner, d), ("inner", "embed")),
        "skip": P((inner,), ("inner",), init="ones"),
    }


def mlstm_parallel(q, k, v, i_gate, f_gate, use_kernel: bool = False):
    """q, k, v: (B,S,H,Dh); i_gate, f_gate raw logits (B,S,H).
    -> (B,S,H,Dh) in q's dtype: the kernel with ``use_kernel``, else the
    quadratic stabilised form (``kernels.mlstm.mlstm_chunkwise_plain``)."""
    if use_kernel:
        return mlstm_k.mlstm_chunkwise(q, k, v, i_gate, f_gate)
    return mlstm_k.mlstm_chunkwise_plain(q, k, v, i_gate, f_gate)


def mlstm_step(q, k, v, i_gate, f_gate, state: dict):
    """One recurrent step.  q, k, v: (B,H,Dh); gates (B,H).
    state: {"C": (B,H,Dh,Dh) [v x k], "n": (B,H,Dh), "m": (B,H)}."""
    Dh = q.shape[-1]
    qf = q.float() / math.sqrt(Dh)
    kf, vf = k.float(), v.float()
    log_f = F.logsigmoid(f_gate.float())
    i = i_gate.float()
    m_new = torch.maximum(log_f + state["m"], i)
    fp = torch.exp(log_f + state["m"] - m_new)
    ip = torch.exp(i - m_new)
    C = fp[..., None, None] * state["C"] + ip[..., None, None] * (
        vf[..., :, None] * kf[..., None, :])                     # (B,H,Dv,Dk)
    n = fp[..., None] * state["n"] + ip[..., None] * kf
    denom = torch.maximum((n * qf).sum(dim=-1).abs(), torch.exp(-m_new))
    h = torch.einsum("bhvk,bhk->bhv", C, qf) / denom[..., None]
    return h, {"C": C, "n": n, "m": m_new}


def _mlstm_scan(q, k, v, i_gate, f_gate, state: dict):
    """The exact step recurrence over axis 1; returns (h (B,S,H,Dh) fp32,
    final state)."""
    hs = []
    for t in range(q.shape[1]):
        h, state = mlstm_step(q[:, t], k[:, t], v[:, t], i_gate[:, t],
                              f_gate[:, t], state)
        hs.append(h)
    return torch.stack(hs, dim=1), state


def mlstm_block_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      cache: Optional[dict] = None,
                      fill_cache: bool = False,
                      use_kernel: bool = False):
    """x: (B,S,D).  Returns (y, new_cache).

    With a cache, one step (S == 1) or the exact step recurrence (a
    prefill chunk continuing a carried state): neither reaches the kernel.
    Without one, the parallel form (the kernel with ``use_kernel``), and
    under ``fill_cache`` a step scan from the empty state rebuilds the
    final state for decode."""
    B, S, d = x.shape
    H = cfg.num_heads
    inner = p["w_up"].shape[1]
    Dh = inner // H
    u = x @ p["w_up"].to(x.dtype)
    g = F.silu(x @ p["w_gate"].to(x.dtype))
    q = (u @ p["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    # the reference's sqrt(Dh) is jnp.sqrt of an int: fp32, then x's dtype
    k = ((u @ p["wk"].to(x.dtype)).reshape(B, S, H, Dh)
         / torch.tensor(math.sqrt(Dh), dtype=torch.float32).to(x.dtype))
    v = (u @ p["wv"].to(x.dtype)).reshape(B, S, H, Dh)
    i_gate = u @ p["wi"].to(x.dtype) + p["bi"].to(x.dtype)
    f_gate = u @ p["wf"].to(x.dtype) + p["bf"].to(x.dtype)

    new_cache = None
    if cache is not None and S == 1:
        h, new_cache = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_gate[:, 0],
                                  f_gate[:, 0], cache)
        h = h[:, None].to(x.dtype).reshape(B, S, inner)
    elif cache is not None:
        # chunked prefill continuing from carried state: exact recurrence
        hs, new_cache = _mlstm_scan(q, k, v, i_gate, f_gate, cache)
        h = hs.to(x.dtype).reshape(B, S, inner)
    else:
        h = mlstm_parallel(q, k, v, i_gate, f_gate, use_kernel=use_kernel)
        h = h.reshape(B, S, inner)
        if fill_cache:
            # rebuild the final state by the step recurrence from the empty
            # state: exact state for decode continuation
            _, new_cache = _mlstm_scan(q, k, v, i_gate, f_gate,
                                       init_mlstm_state(cfg, B, x.device))
    h = h + u * p["skip"].to(x.dtype)
    y = (h * g) @ p["w_down"].to(x.dtype)
    return y, new_cache


def mlstm_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of one mLSTM layer's state."""
    H = cfg.num_heads
    Dh = int(cfg.d_model * cfg.mlstm_proj_factor) // H
    f32 = torch.float32
    return {"C": ((batch, H, Dh, Dh), f32), "n": ((batch, H, Dh), f32),
            "m": ((batch, H), f32)}


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Empty state by ``transformer.init_caches``' sentinel rule: C = n = 0,
    m = -1e30 (the log-sum-exp identity); on the card unless ``device``
    says otherwise."""
    from repro_torch.models.transformer import materialize_caches
    return materialize_caches(mlstm_cache_shapes(cfg, batch),
                              resolve_device(device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    ff = int(d * cfg.slstm_proj_factor)
    gates = {}
    for gname in ("z", "i", "f", "o"):
        gates[f"w_{gname}"] = P((d, d), ("embed", "embed2"))
        gates[f"r_{gname}"] = P((H, hd, hd), ("heads", None, None))
        gates[f"b_{gname}"] = P((d,), ("embed2",), init="zeros")
    gates["b_f"] = P((d,), ("embed2",), init="ones", scale=3.0)
    return {
        **gates,
        "ff_wi": P((d, ff), ("embed", "mlp")),
        "ff_wg": P((d, ff), ("embed", "mlp")),
        "ff_wo": P((ff, d), ("mlp", "embed")),
    }


def _slstm_gates(p: dict, x_t: torch.Tensor, h_prev: torch.Tensor, H: int):
    """x_t, h_prev: (B,D) fp32.  Returns raw gate preactivations (B,D) x4."""
    B, D = x_t.shape
    hd = D // H
    hh = h_prev.reshape(B, H, hd)
    outs = []
    for g in ("z", "i", "f", "o"):
        rec = torch.einsum("bhi,hio->bho", hh, p[f"r_{g}"].float())
        outs.append(x_t @ p[f"w_{g}"].float() + rec.reshape(B, D)
                    + p[f"b_{g}"].float())
    return outs


def slstm_step(p: dict, state: dict, x_t: torch.Tensor, H: int) -> dict:
    """state: {"c","n","h","m"} each (B,D) fp32; x_t (B,D) fp32."""
    zt, it, ft, ot = _slstm_gates(p, x_t, state["h"], H)
    z = torch.tanh(zt)
    log_i = it
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + state["m"], log_i)
    ip = torch.exp(log_i - m_new)
    fp = torch.exp(log_f + state["m"] - m_new)
    c = fp * state["c"] + ip * z
    n = torch.maximum(fp * state["n"] + ip, torch.exp(-m_new))
    h = torch.sigmoid(ot) * c / n
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_mixer_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                      cache: Optional[dict] = None,
                      fill_cache: bool = False):
    """Recurrence sublayer only.  x: (B,S,D).  Returns (h, new_cache).

    Without a cache the scan starts from :func:`init_slstm_state` (m = 0);
    a served cache starts from ``transformer.init_caches``' sentinels
    (m = -1e30), as in the reference: the two give different numbers."""
    B, S, D = x.shape
    xf = x.float()
    state = cache if cache is not None else init_slstm_state(cfg, B, x.device)
    state = {k: v.float() for k, v in state.items()}
    hs = []
    for t in range(S):
        state = slstm_step(p, state, xf[:, t], cfg.num_heads)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)            # (B,S,D)
    new_cache = state if (cache is not None or fill_cache) else None
    return h, new_cache


def slstm_ffn_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated FFN sublayer (proj factor 4/3)."""
    ff = gelu(x @ p["ff_wg"].to(x.dtype)) * (x @ p["ff_wi"].to(x.dtype))
    return ff @ p["ff_wo"].to(x.dtype)


def slstm_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{name: (shape, dtype)} of one sLSTM layer's state."""
    s = ((batch, cfg.d_model), torch.float32)
    return {"c": s, "n": s, "h": s, "m": s}


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """The cache-less start: c = h = m = 0, n = 1; on the card unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    out = {k: torch.zeros(s, dtype=dt, device=dev)
           for k, (s, dt) in slstm_cache_shapes(cfg, batch).items()}
    out["n"].fill_(1.0)
    return out
