"""Single-token decode over a contiguous cache, the GQA group as rows.

Replaces the reference's ``kernels/decode_attention.py`` ``_dec_kernel``
(wrapper ``decode_attention_bhgd``) with ``attn_decode`` of
``csrc/attention.cu``: q (B,1,Hq,D), k/v (B,C,Hkv,D) read in place, causal
by position, optionally windowed.  One block per (b, kv head) holding the
G = Hq/Hkv query rows; the TPU's sequential KV-block axis is a loop inside
the block.  For starcoder2-3b at 8 slots that is 16 blocks on 132 SMs:
the card is mostly idle, which ``PERF.md`` records beside the time.
Splitting the keys over blocks is later work.

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
    B, S, Hq, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    if S != 1 or k.shape[0] != B or tuple(q_pos.shape) != (B, 1) \
            or tuple(kv_pos.shape) != (B, C):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, kv_pos {tuple(kv_pos.shape)}")
    if not ac.on_cuda(q, k, v, q_pos, kv_pos):
        return decode_attention_plain(q, k, v, q_pos, kv_pos, window=window)
    ac.check_aligned(k, v)
    qp, kvp = ac.as_i32(q_pos), ac.as_i32(kv_pos)
    out = torch.empty_like(q)
    ac.launch("attn_decode", q.data_ptr(), k.data_ptr(), v.data_ptr(),
              qp.data_ptr(), kvp.data_ptr(), out.data_ptr(), B, Hq, Hkv, C,
              D, int(window), ac.scale_of(D), int(q.dtype == torch.bfloat16),
              ac.stream(q))
    LAUNCHES["decode"] += 1
    return out
