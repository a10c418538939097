"""Attention over the paged KV pool, read through the block table.

Replaces the reference's ``kernels/paged_attention.py``:

  ``paged_decode_attention``  ``_paged_dec_kernel`` (wrapper
                              ``paged_decode_attention_bhgd``): one query
                              token per row, the GQA group as rows;
                              ``attn_paged_decode`` of
                              ``csrc/decode_attention.cu``, the table's
                              entries split over blocks (grid (splits,
                              Hkv, B), 128 entries each), the splits'
                              partials merged in split order by the last
                              block of each (b, kv head), in one launch.
  ``paged_flash_attention``   ``_paged_fa_kernel`` (wrapper
                              ``paged_flash_attention_bhsd``): chunked
                              prefill, kv head ``h // G``;
                              ``attn_paged_flash`` of ``csrc/attention.cu``,
                              the same split and in-launch merge over a
                              tile of 64 (position, group-head) rows per
                              block (``attention_common.flash_split``).

The pool is read where it lies — kp/vp (nb,bs,Hkv,D), ppos (nb,bs) —
through tbl (B,M) int32 (-1 = unused column): the reference's
``_pool_to_kernel`` transposes and pads the whole pool on every call; the
port does not.  Each block reads its own table columns in place of the
TPU's scalar prefetch and loads only valid entries: a -1 column, an empty
slot or a key outside every row's range is zero-filled and never read, and
a tile of keys with no valid entry is neither loaded nor computed.

Bound on the card: each live K/V entry read once per kv head (plus its
position), q and the output, over 3.35 TB/s; or 4 * D operations per valid
(query row, head, key) over 989 TFLOP/s bf16, whichever is larger.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import attention_common as ac

#: launches of each hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"paged_decode": 0, "paged_flash": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def paged_flash_attention_plain(q, kp, vp, ppos, tbl, q_pos, *,
                                causal: bool = True,
                                window: int = 0) -> torch.Tensor:
    """Gather the logical KV through the table, then dense masked attention
    (``ref.paged_prefill_ref``); fully masked rows give 0."""
    k, v, kv_pos = ac.paged_gather_plain(kp, vp, ppos, tbl)
    return ac.masked_attention_plain(q, k, v, q_pos, kv_pos, causal=causal,
                                     window=window)


def paged_decode_attention_plain(q, kp, vp, ppos, tbl, q_pos, *,
                                 window: int = 0) -> torch.Tensor:
    return paged_flash_attention_plain(q, kp, vp, ppos, tbl, q_pos,
                                       causal=True, window=window)


def _check(q, kp, vp, ppos, tbl, q_pos) -> None:
    ac.check_qkv(q, kp, vp)
    B, S = q.shape[:2]
    nb, bs = kp.shape[:2]
    if tuple(ppos.shape) != (nb, bs) or tbl.ndim != 2 or tbl.shape[0] != B \
            or tuple(q_pos.shape) != (B, S):
        raise ValueError(f"q {tuple(q.shape)}, pool {tuple(kp.shape)}, ppos "
                         f"{tuple(ppos.shape)}, tbl {tuple(tbl.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}")


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, ppos: torch.Tensor,
                           tbl: torch.Tensor, q_pos: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q (B,1,Hq,D); pool kp/vp (nb,bs,Hkv,D), ppos (nb,bs); tbl (B,M);
    q_pos (B,1).  Causal.  Returns (B,1,Hq,D) in q's dtype."""
    _check(q, kp, vp, ppos, tbl, q_pos)
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one query token, got q {tuple(q.shape)}")
    ac.refuse_grad("paged_decode_attention", q, kp, vp)
    if not ac.on_cuda(q, kp, vp, ppos, tbl, q_pos):
        return paged_decode_attention_plain(q, kp, vp, ppos, tbl, q_pos,
                                            window=window)
    ac.check_aligned(q, kp, vp)
    nb, bs, Hkv = kp.shape[:3]
    M = tbl.shape[1]
    ac.check_int32_rows(nb * bs)
    pp, tb, qp = ac.as_i32(ppos), ac.as_i32(tbl), ac.as_i32(q_pos)
    out = ac.launch_decode("attn_paged_decode", q,
                           (kp.data_ptr(), vp.data_ptr(), pp.data_ptr(),
                            tb.data_ptr(), qp.data_ptr()),
                           (bs, M), Hkv, M * bs, window)
    LAUNCHES["paged_decode"] += 1
    return out


def paged_flash_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                          ppos: torch.Tensor, tbl: torch.Tensor,
                          q_pos: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,D) against the pool; same arguments as the decode kernel.
    Returns (B,S,Hq,D) in q's dtype."""
    _check(q, kp, vp, ppos, tbl, q_pos)
    ac.refuse_grad("paged_flash_attention", q, kp, vp)
    if not ac.on_cuda(q, kp, vp, ppos, tbl, q_pos):
        return paged_flash_attention_plain(q, kp, vp, ppos, tbl, q_pos,
                                           causal=causal, window=window)
    ac.check_aligned(q, kp, vp)
    bs, Hkv = kp.shape[1], kp.shape[2]
    M = tbl.shape[1]
    ac.check_int32_rows(kp.shape[0] * bs)
    pp, tb, qp = ac.as_i32(ppos), ac.as_i32(tbl), ac.as_i32(q_pos)
    out = ac.launch_flash("attn_paged_flash", q,
                          (kp.data_ptr(), vp.data_ptr(), pp.data_ptr(),
                           tb.data_ptr(), qp.data_ptr()),
                          (bs, M), Hkv, M * bs, causal, window)
    LAUNCHES["paged_flash"] += 1
    return out
