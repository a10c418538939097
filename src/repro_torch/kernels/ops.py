"""Model-facing kernel entry points with the reference's routing
(``kernels/ops.py``): a single causal query token goes to the decode
kernel, anything else to the flash kernel; the RG-LRU scan and the
chunkwise mLSTM go to their kernels of ``csrc/recurrent.cu``.

The reference's wrappers pad to 128 lanes and transpose to the kernels'
layouts; the port's kernels read the model's layouts in place, so these
wrappers only route, and the two recurrent entry points are the kernel
modules' own functions.  Each callee launches its hand kernel for CUDA
tensors and runs its plain version for CPU tensors.  None has a backward:
each raises, on either device, when grad mode is on and a floating input
requires grad (``attention_common.refuse_grad``), so training runs with
``use_kernels=False``, the reference's own training path, and serving
runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.kernels import paged_attention as pa_k
from repro_torch.kernels import rglru as rglru_k


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,D); k/v (B,C,Hkv,D); *_pos (B,S)/(B,C) -> (B,S,Hq,D)."""
    if q.shape[1] == 1 and causal:
        return decode_attention(q, k, v, q_pos, kv_pos, window=window)
    return fa_k.flash_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single query token: q (B,1,Hq,D) -> (B,1,Hq,D)."""
    return dec_k.decode_attention(q, k, v, q_pos, kv_pos, window=window)


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    ppos: torch.Tensor, tbl: torch.Tensor, q_pos: torch.Tensor,
                    *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,D); kp/vp (nb,bs,Hkv,D) block pool; ppos (nb,bs); tbl
    (B,M) int32 (-1 = unused) -> (B,S,Hq,D).  S == 1 (causal) routes to the
    paged decode kernel, larger S to paged flash."""
    if q.shape[1] == 1 and causal:
        return pa_k.paged_decode_attention(q, kp, vp, ppos, tbl, q_pos,
                                           window=window)
    return pa_k.paged_flash_attention(q, kp, vp, ppos, tbl, q_pos,
                                      causal=causal, window=window)


#: h_t = a_t h_{t-1} + b_t; a, b (B,S,W) fp32 -> (B,S,W) fp32, any S and W
rglru_scan = rglru_k.rglru_scan
#: q, k, v (B,S,H,Dh), gates (B,S,H) -> (B,S,H,Dh), in chunks of 128
#: (the reference's default; it never reads ``cfg.mlstm_chunk``)
mlstm_chunkwise = mlstm_k.mlstm_chunkwise


_MODULES = (fa_k, dec_k, pa_k, rglru_k, mlstm_k)


def reset_launches() -> None:
    """Zero the launch counts of all six token-path kernels."""
    for mod in _MODULES:
        mod.reset_launches()


def launches() -> dict:
    """Launch counts of all six token-path kernels, by name."""
    return {k: n for mod in _MODULES for k, n in mod.LAUNCHES.items()}


def add_launches(counts: dict) -> None:
    """Add ``counts`` ({name: n}, n may be negative) to the launch counts:
    a CUDA graph's capture launches nothing, and each replay launches what
    the capture counted."""
    for mod in _MODULES:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] += counts.get(k, 0)
