"""Single-token decode over a contiguous cache, the GQA group as rows.

Replaces the reference's ``kernels/decode_attention.py`` ``_dec_kernel``
(wrapper ``decode_attention_bhgd``) with ``attn_decode`` of
``csrc/decode_attention.cu``: q (B,1,Hq,D), k/v (B,C,Hkv,D) read in place,
causal by position, optionally windowed.  The TPU's sequential KV-block
axis becomes a split of the keys over blocks: grid (splits, Hkv, B), each
block one split of 128 keys (``attention_common.decode_split``) against the
G = Hq/Hkv query rows of its kv head, on the tensor cores for bf16; the
last block of each (b, kv head) to finish merges the splits' partials in
split order, in the same launch.  The wrapper allocates the partials'
workspace and reuses a per-device buffer of ticket counters.

Bound on the card: each live K/V entry read once per kv head, plus q and
the output, over 3.35 TB/s (the operations, 4 * D per valid key and head,
are far below the bf16 peak).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import attention_common as ac

#: launches of the hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"decode": 0}


def reset_launches() -> None:
    LAUNCHES["decode"] = 0


def decode_attention_plain(q, k, v, q_pos, kv_pos, *,
                           window: int = 0) -> torch.Tensor:
    """Dense version with the kernel's semantics (fully masked rows give 0)."""
    return ac.masked_attention_plain(q, k, v, q_pos, kv_pos, causal=True,
                                     window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """q (B,1,Hq,D); k/v (B,C,Hkv,D); q_pos (B,1); kv_pos (B,C).
    Returns (B,1,Hq,D) in q's dtype."""
    ac.check_qkv(q, k, v)
    B, S = q.shape[:2]
    C, Hkv = k.shape[1], k.shape[2]
    if S != 1 or k.shape[0] != B or tuple(q_pos.shape) != (B, 1) \
            or tuple(kv_pos.shape) != (B, C):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, kv_pos {tuple(kv_pos.shape)}")
    ac.refuse_dtensor("decode_attention", q, k, v)
    ac.refuse_grad("decode_attention", q, k, v)
    if not ac.on_cuda(q, k, v, q_pos, kv_pos):
        return decode_attention_plain(q, k, v, q_pos, kv_pos, window=window)
    ac.check_aligned(q, k, v)
    ac.check_int32_rows(B * C)
    qp, kvp = ac.as_i32(q_pos), ac.as_i32(kv_pos)
    out = ac.launch_decode("attn_decode", q, (k.data_ptr(), v.data_ptr(),
                                              qp.data_ptr(), kvp.data_ptr()),
                           (C,), Hkv, C, window)
    LAUNCHES["decode"] += 1
    return out
