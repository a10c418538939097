"""Chunkwise stabilised mLSTM (xLSTM's matrix memory), exact.

Replaces the reference's ``kernels/mlstm.py`` ``_mlstm_kernel`` (wrapper
``mlstm_chunkwise_bhsd``) with ``mlstm_chunkwise`` of
``csrc/recurrent.cu``.  q, k, v (B,S,H,Dh) bf16/fp32 are read in the
model's layout (the reference's wrapper transposes to (B*H,S,Dh) and pads
Dh to 128 lanes); gates (B,S,H) raw logits, cast to fp32 here.  Chunks of
``DEFAULT_CHUNK`` = 128 rows, the reference's ``ops.mlstm_chunkwise``
default (``cfg.mlstm_chunk`` is read by neither); a ragged last chunk is
masked, which means what the reference's zero padding of S means: trailing
pads affect no earlier row.  The state (C, n, m) carries across chunks in
shared memory, C split over blocks by 32 value columns (C is 1 MB at
Dh 512, more than a block's 227 KB).

Bound on the card: q, k, v, gates read once and the output written, over
3.35 TB/s, or the chunkwise operations over 989 TFLOP/s (bf16), the
larger (``chip_smoke.py`` counts both from each call's inputs).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.attention_common import (DTYPES, NEG_INF, on_cuda,
                                                  stream)

DEFAULT_CHUNK = 128   # rows per chunk, compiled into csrc/recurrent.cu
MAX_HEAD_DIM = 512    # C[:, 32 columns] + the 128 x 128 panel fit on chip

#: launches of the hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"mlstm_chunkwise": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = (("mlstm_chunkwise", (_P,) * 6 + (_I,) * 4
                + (ctypes.c_float, _I, _P)),)


def reset_launches() -> None:
    LAUNCHES["mlstm_chunkwise"] = 0


def mlstm_chunkwise_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          i_gate: torch.Tensor,
                          f_gate: torch.Tensor) -> torch.Tensor:
    """The quadratic stabilised parallel form (``kernels/ref.py``
    ``mlstm_ref``): q, k, v (B,S,H,Dh); gates (B,S,H) -> (B,S,H,Dh) in q's
    dtype."""
    B, S, H, Dh = q.shape
    qf = q.float() / math.sqrt(Dh)
    kf, vf = k.float(), v.float()
    F_ = torch.cumsum(F.logsigmoid(f_gate.float()), dim=1)        # (B,S,H)
    D = F_[:, :, None, :] - F_[:, None, :, :] + i_gate.float()[:, None, :, :]
    tri = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    tri = tri[None, :, :, None]
    D = torch.where(tri, D, torch.full_like(D, -math.inf))        # (B,T,S,H)
    m = torch.clamp(D.amax(dim=2, keepdim=True), min=NEG_INF)
    dmat = torch.where(tri, torch.exp(D - m), torch.zeros_like(D))
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * dmat
    n = torch.maximum(scores.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    out = torch.einsum("btsh,bshd->bthd", scores / n, vf)
    return out.to(q.dtype)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor,
                    f_gate: torch.Tensor) -> torch.Tensor:
    """q, k, v (B,S,H,Dh) of one dtype; i_gate, f_gate (B,S,H) raw logits.
    Returns (B,S,H,Dh) in q's dtype."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} must be equal (B,S,H,Dh)")
    B, S, H, Dh = q.shape
    if i_gate.shape != (B, S, H) or f_gate.shape != (B, S, H):
        raise ValueError(f"gates {tuple(i_gate.shape)}/{tuple(f_gate.shape)} "
                         f"must be (B,S,H) = {(B, S, H)}")
    if not on_cuda(q, k, v, i_gate, f_gate):
        return mlstm_chunkwise_plain(q, k, v, i_gate, f_gate)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM}")
    ig = i_gate.float().contiguous()
    fg = f_gate.float().contiguous()
    out = torch.empty_like(q)
    lib = build.bind("recurrent", _SIGNATURES)
    build.launch(lib, "mlstm_chunkwise", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), ig.data_ptr(), fg.data_ptr(), out.data_ptr(),
                 B, S, H, Dh, 1.0 / math.sqrt(Dh),
                 int(q.dtype == torch.bfloat16), stream(q))
    LAUNCHES["mlstm_chunkwise"] += 1
    return out
