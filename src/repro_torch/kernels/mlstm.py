"""Chunkwise stabilised mLSTM (xLSTM's matrix memory), exact.

Replaces the reference's ``kernels/mlstm.py`` ``_mlstm_kernel`` (wrapper
``mlstm_chunkwise_bhsd``) with ``mlstm_chunkwise`` of
``csrc/recurrent.cu``.  q, k, v (B,S,H,Dh) bf16/fp32 are read in the
model's layout (the reference's wrapper transposes to (B*H,S,Dh) and pads
Dh to 128 lanes); gates (B,S,H) raw logits, bf16 or fp32, read by the
kernel in their own type, so a call is one launch.  Chunks of
``DEFAULT_CHUNK`` = 128 rows, the reference's ``ops.mlstm_chunkwise``
default (``cfg.mlstm_chunk`` is read by neither); a ragged last chunk is
masked, which means what the reference's zero padding of S means: trailing
pads affect no earlier row.

Design on the card: C is 1 MB fp32 at Dh 512, more than a block's 227 KB,
so the value columns are split over blocks, ``VALUE_COLS`` = 64 each (C's
slice 128 KB): grid (ceil(Dh / 64), B*H), 128 blocks at xlstm-350m's BH 16,
one wave on 132 SMs, 8 warps a block, one to each 16-row tile of the
chunk.  Each block walks the chunks in order: one pass over Dk for q.k^T
(keys at or below the diagonal only), q.C and q.n; the gated panel in
registers; P.V; a second pass over Dk for the state update.  For
bf16 the four products run on the tensor cores (``mma.sync``), q, k and V
as given, the scale on the fp32 scores, every fp32 operand (P, C, V*w)
split into bf16 hi + lo (C is kept split in shared memory); fp32 takes
FMA in the same structure.
:func:`mlstm_tiled_plain` models that tiling and rounding on the CPU for
the tests; :func:`mlstm_smem_bytes` mirrors the kernel's shared memory.

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
                                                  refuse_dtensor, refuse_grad,
                                                  stream)

DEFAULT_CHUNK = 128   # rows per chunk, compiled into csrc/recurrent.cu
MAX_HEAD_DIM = 512    # C[:, 64 columns] + the q/k/V tiles fit on chip
VALUE_COLS = 64       # value columns of C per block (kBv)
THREADS = 256         # 8 warps, one per 16-row tile of a chunk
SMEM_MAX = 227 * 1024  # an H100's dynamic shared memory per block

#: launches of the hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"mlstm_chunkwise": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = (("mlstm_chunkwise", (_P,) * 6 + (_I,) * 4
                + (ctypes.c_float, _I, _I, _P)),
               ("mlstm_smem", (_I,) * 2))


def reset_launches() -> None:
    LAUNCHES["mlstm_chunkwise"] = 0


def mlstm_grid(B: int, H: int, Dh: int) -> tuple:
    """The kernel's grid: (value tiles, B*H) blocks of THREADS."""
    return -(-Dh // VALUE_COLS), B * H


def mlstm_smem_bytes(Dh: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block, as ``mlstm_smem_bytes`` of
    recurrent.cu counts it: C's slice (16 bytes a fragment lane: fp32, or
    bf16 hi + lo) and n over Dk padded to a whole tile (128 bytes of a q/k
    row: 64 bf16 or 32 fp32), the q and k stages (two for bf16, one for
    fp32), the V tile, five gate vectors of the chunk, 16 scalars and two
    Dk tiles' partial sums of n (one per 16-row value tile); each staged
    row is padded by 16 bytes."""
    size = 2 if dtype == torch.bfloat16 else 4
    dt = 128 // size
    dp = -(-Dh // dt) * dt
    stages = 2 if size == 2 else 1
    return (4 * dp * VALUE_COLS + 4 * dp
            + 2 * stages * DEFAULT_CHUNK * (dt + 16 // size) * size
            + DEFAULT_CHUNK * (VALUE_COLS + 16 // size) * size
            + 4 * (5 * DEFAULT_CHUNK + 16 + 2 * (VALUE_COLS // 16) * 64))


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


def split_hi_lo(x: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the kernel's two bf16 mma operands see it: hi =
    bf16(x), lo = bf16(x - hi); returns hi + lo in fp32 (16 bits of x)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def mlstm_tiled_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                      chunk: int = DEFAULT_CHUNK,
                      value_cols: int = VALUE_COLS) -> torch.Tensor:
    """A plain model of the kernel's tiling and rounding, for the tests:
    the chunk recurrence (the reference's ``_mlstm_kernel``) with the state
    C split over value tiles of ``value_cols`` columns as the blocks hold
    it, the 1/sqrt(Dh) scale applied to the fp32 scores (q and k enter the
    product as given), and for bf16 inputs each product's fp32 operand (the
    gated panel, V*w, C) rounded to bf16 hi + lo, C where the update
    stores it (the kernel keeps it split between chunks).  q, k, v
    (B,S,H,Dh); gates (B,S,H) -> (B,S,H,Dh) in q's dtype."""
    B, S, H, Dh = q.shape
    rnd = split_hi_lo if q.dtype == torch.bfloat16 else (lambda x: x)
    scale = 1.0 / math.sqrt(Dh)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    ig = i_gate.float().permute(0, 2, 1)                          # (B,H,S)
    lf = F.logsigmoid(f_gate.float()).permute(0, 2, 1)
    tiles = [slice(c, min(c + value_cols, Dh))
             for c in range(0, Dh, value_cols)]
    C = [qf.new_zeros(B, H, Dh, t.stop - t.start) for t in tiles]
    n = qf.new_zeros(B, H, Dh)
    m = qf.new_full((B, H), NEG_INF)
    out = torch.empty_like(qf)
    for c0 in range(0, S, chunk):
        L = min(chunk, S - c0)
        qc, kc, vc = (x[:, :, c0:c0 + L] for x in (qf, kf, vf))
        bc = torch.cumsum(lf[:, :, c0:c0 + L], dim=-1)            # (B,H,L)
        ic = ig[:, :, c0:c0 + L]
        g = bc[..., -1]
        tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
        dmat = torch.where(tri, bc[..., :, None] - bc[..., None, :]
                           + ic[..., None, :], torch.full_like(tri, NEG_INF,
                                                               dtype=qf.dtype))
        m_t = torch.clamp(torch.maximum(dmat.amax(-1), bc + m[..., None]),
                          min=NEG_INF)
        coeff = torch.exp(bc + m[..., None] - m_t)
        p = torch.where(tri, (qc @ kc.transpose(-1, -2)) * scale
                        * torch.exp(dmat - m_t[..., None]),
                        torch.zeros_like(dmat))
        qn = (qc @ n[..., None])[..., 0] * scale * coeff
        denom = torch.maximum((p.sum(-1) + qn).abs(), torch.exp(-m_t))
        w_s = g[..., None] - bc + ic
        m_new = torch.maximum(g + m, w_s.amax(-1))
        scale_old = torch.exp(g + m - m_new)
        w = torch.exp(w_s - m_new[..., None])
        for t, Ct in zip(tiles, C):
            h = (rnd(p) @ vc[..., t] + (qc @ Ct) * (scale * coeff)[
                ..., None]) / denom[..., None]
            out[:, :, c0:c0 + L, t] = h
            Ct.copy_(rnd(Ct * scale_old[..., None, None]
                         + kc.transpose(-1, -2) @ rnd(vc[..., t]
                                                       * w[..., None])))
        n = n * scale_old[..., None] + (kc * w[..., None]).sum(-2)
        m = m_new
    return out.permute(0, 2, 1, 3).to(q.dtype)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor,
                    f_gate: torch.Tensor) -> torch.Tensor:
    """q, k, v (B,S,H,Dh) of one dtype; i_gate, f_gate (B,S,H) raw logits
    of one dtype.  Returns (B,S,H,Dh) in q's dtype."""
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v {tuple(q.shape)}/{tuple(k.shape)}/"
                         f"{tuple(v.shape)} must be equal (B,S,H,Dh)")
    B, S, H, Dh = q.shape
    if i_gate.shape != (B, S, H) or f_gate.shape != (B, S, H):
        raise ValueError(f"gates {tuple(i_gate.shape)}/{tuple(f_gate.shape)} "
                         f"must be (B,S,H) = {(B, S, H)}")
    refuse_dtensor("mlstm_chunkwise", q, k, v, i_gate, f_gate)
    refuse_grad("mlstm_chunkwise", q, k, v, i_gate, f_gate)
    if not on_cuda(q, k, v, i_gate, f_gate):
        return mlstm_chunkwise_plain(q, k, v, i_gate, f_gate)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if i_gate.dtype not in DTYPES or f_gate.dtype != i_gate.dtype:
        raise TypeError(f"gates must share one of {DTYPES}, got "
                        f"{i_gate.dtype}/{f_gate.dtype}")
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dh} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lib = build.bind("recurrent", _SIGNATURES)
    build.launch(lib, "mlstm_chunkwise", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), i_gate.data_ptr(), f_gate.data_ptr(),
                 out.data_ptr(), B, S, H, Dh, 1.0 / math.sqrt(Dh),
                 int(q.dtype == torch.bfloat16),
                 int(i_gate.dtype == torch.bfloat16), stream(q))
    LAUNCHES["mlstm_chunkwise"] += 1
    return out


def kernel_smem_bytes(Dh: int, dtype: torch.dtype) -> int:
    """The kernel's own count of its shared memory (builds the library);
    :func:`mlstm_smem_bytes` must equal it."""
    lib = build.bind("recurrent", _SIGNATURES)
    return lib.mlstm_smem(Dh, int(dtype == torch.bfloat16))
