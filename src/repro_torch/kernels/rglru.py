"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` (diagonal gates).

Replaces the reference's ``kernels/rglru.py`` ``_rglru_kernel`` (wrapper
``rglru_scan_blocked``) with ``rglru_scan`` of ``csrc/recurrent.cu``:
a, b (B,S,W) fp32 and h0 (B,W) fp32 (or None: zeros) -> h (B,S,W) fp32.
Each channel's recurrence stays one sequential chain (a time-parallel scan
would reassociate the sums).  A block owns ``CHANNELS_PER_BLOCK``
neighbouring channels, so B 1 x W 4096 gives 128 blocks; all of its
threads copy the block's (time x channels) tiles of a and b into shared
memory by ``cp.async`` in stages of 32 steps, four stages in flight, and
one thread per channel walks the chain as the stages land.  The Pallas
kernel's (bs, bw) VMEM blocks and its 128-lane padding of W are TPU layout
choices and are not carried over.

Bound on the card: 12 bytes per element (a, b read, h written) plus h0,
over 3.35 TB/s.  The kernel rounds the product and the sum separately, as
:func:`rglru_scan_plain` does, so the two are bit-identical.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention_common import (on_cuda, refuse_dtensor,
                                                  refuse_grad, stream)

#: launches of the hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"rglru_scan": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = (("rglru_scan", (_P,) * 4 + (_I,) * 4 + (_P,)),)
CHANNELS_PER_BLOCK = 32   # kCh of csrc/recurrent.cu: 16, 32 or 64
SCAN_THREADS = 128        # kScanThreads: all stage, kCh walk the chains


def reset_launches() -> None:
    LAUNCHES["rglru_scan"] = 0


def rglru_grid(B: int, W: int, channels: int = CHANNELS_PER_BLOCK) -> tuple:
    """The kernel's grid: (channel blocks, B) blocks of SCAN_THREADS."""
    return -(-W // channels), B


def rglru_smem_bytes(channels: int = CHANNELS_PER_BLOCK) -> int:
    """Dynamic shared memory of one block: a and b, four stages of 32 steps
    x ``channels`` fp32 each (``scan_smem_bytes`` of recurrent.cu)."""
    return 2 * 4 * 32 * channels * 4


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential, as the reference's ``kernels/ref.py`` ``rglru_scan_ref``:
    h0 folded into step 0's input, then ``h = a_t * h + b_t`` from 0."""
    a, b = a.float(), b.float()
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0.float()
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (B,S,W) fp32; h0 (B,W) fp32 or None.  Returns (B,S,W) fp32."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         f"equal (B,S,W)")
    B, S, W = a.shape
    if h0 is not None and tuple(h0.shape) != (B, W):
        raise ValueError(f"h0 {tuple(h0.shape)} must be (B,W) = {(B, W)}")
    refuse_dtensor("rglru_scan", a, b, *(() if h0 is None else (h0,)))
    refuse_grad("rglru_scan", a, b, *(() if h0 is None else (h0,)))
    if not on_cuda(a, b, *(() if h0 is None else (h0,))):
        return rglru_scan_plain(a, b, h0)
    for t in (a, b) + (() if h0 is None else (h0,)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan takes fp32, got {t.dtype}")
    out = torch.empty_like(a)
    lib = build.bind("recurrent", _SIGNATURES)
    build.launch(lib, "rglru_scan", a.data_ptr(), b.data_ptr(),
                 None if h0 is None else h0.data_ptr(), out.data_ptr(), B, S,
                 W, CHANNELS_PER_BLOCK, stream(a))
    LAUNCHES["rglru_scan"] += 1
    return out
