"""Model-facing attention entry points with the reference's routing
(``kernels/ops.py``): a single causal query token goes to the decode
kernel, anything else to the flash kernel.

The reference's wrappers pad to 128 lanes and transpose to the kernels'
layouts; the port's kernels read the model's layouts in place, so these
wrappers only route.  Each callee launches its hand kernel for CUDA
tensors and runs its plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import paged_attention as pa_k


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


def reset_launches() -> None:
    """Zero the launch counts of all four attention kernels."""
    for mod in (fa_k, dec_k, pa_k):
        mod.reset_launches()


def launches() -> dict:
    """Launch counts of all four attention kernels, by name."""
    return {**fa_k.LAUNCHES, **dec_k.LAUNCHES, **pa_k.LAUNCHES}
