"""Blocked flash attention over a contiguous cache: causal, sliding window,
GQA, masked by explicit positions.

Replaces the reference's ``kernels/flash_attention.py`` ``_fa_kernel``
(wrapper ``flash_attention_bhsd``) with ``attn_flash`` of
``csrc/attention.cu``: q (B,S,Hq,D), k/v (B,C,Hkv,D) read in place (the
reference's transposes and 128-lane padding are not copied), q_pos (B,S),
kv_pos (B,C) int32 with -1 = empty.  The TPU's sequential KV-block axis
becomes a split of the keys over blocks: grid (splits, Hkv * row tiles,
B), each block one split of the keys (``attention_common.flash_split``)
against a tile of 64 (position, group-head) rows, 64-key tiles brought in
by ``cp.async`` in their own type, on the tensor cores for bf16; the last
block of each (b, kv head, row tile) to finish merges the splits'
partials in split order, in the same launch.  The wrapper allocates the
partials' workspace and reuses a per-device buffer of ticket counters
(not the decode kernels').

Bound on the card: bytes = each live K/V entry read once per kv head plus
q and the output; operations = 4 * D * (query row, head, valid key)
triples; the larger of bytes / 3.35 TB/s and operations / 989 TFLOP/s
(bf16).  ``chip_smoke.py`` computes it from each run's inputs; the measured
times are in ``PERF.md``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import attention_common as ac

#: launches of the hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"flash": 0}


def reset_launches() -> None:
    LAUNCHES["flash"] = 0


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Gather-free dense version with the kernel's semantics (fully masked
    rows give 0)."""
    return ac.masked_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,D); k/v (B,C,Hkv,D); q_pos (B,S); kv_pos (B,C).
    Returns (B,S,Hq,D) in q's dtype."""
    ac.check_qkv(q, k, v)
    B, S, Hq, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or tuple(q_pos.shape) != (B, S) \
            or tuple(kv_pos.shape) != (B, C):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, kv_pos {tuple(kv_pos.shape)}")
    ac.refuse_grad("flash_attention", q, k, v)
    if not ac.on_cuda(q, k, v, q_pos, kv_pos):
        return flash_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window)
    ac.check_aligned(q, k, v)
    ac.check_int32_rows(B * C)
    qp, kvp = ac.as_i32(q_pos), ac.as_i32(kv_pos)
    out = ac.launch_flash("attn_flash", q, (k.data_ptr(), v.data_ptr(),
                                            qp.data_ptr(), kvp.data_ptr()),
                          (C,), Hkv, C, causal, window)
    LAUNCHES["flash"] += 1
    return out
