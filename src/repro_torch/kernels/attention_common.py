"""What the four attention kernels share: the library, the dispatch rule,
the input checks and the plain masked attention.

The kernels themselves live in ``csrc/attention.cu`` (one templated
routine, four C entry points) and are built with ``nvcc`` for ``sm_90a``
at first use (``kernels/build.py``).  Their wrappers, launch counts and
plain versions are in ``flash_attention.py``, ``decode_attention.py`` and
``paged_attention.py``.

Dispatch rule: a CUDA tensor always goes to the hand kernel (or the call
raises); a CPU tensor goes to the plain PyTorch version.  There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128, 256)  # instantiated in csrc/attention.cu
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = (
    ("attn_flash", (_P,) * 6 + (_I,) * 8 + (_F, _I, _P)),
    ("attn_decode", (_P,) * 6 + (_I,) * 6 + (_F, _I, _P)),
    ("attn_paged_flash", (_P,) * 7 + (_I,) * 9 + (_F, _I, _P)),
    ("attn_paged_decode", (_P,) * 7 + (_I,) * 7 + (_F, _I, _P)),
)


def launch(name: str, *args) -> None:
    """Launch ``name`` of ``csrc/attention.cu`` (built at first use)."""
    build.launch(build.bind("attention", _SIGNATURES), name, *args)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True: launch the kernel.  False: every tensor is on the CPU, use the
    plain version.  Anything else (mixed devices, another backend, a
    strided view) raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"the kernels run on cuda or cpu tensors, got {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"kernel inputs must be contiguous, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    return True


def check_aligned(*kv: torch.Tensor) -> None:
    """The kernels read K/V rows as 8- and 16-byte vectors."""
    for t in kv:
        if t.data_ptr() % 16:
            raise ValueError(f"K/V must be 16-byte aligned, got a tensor at "
                             f"{t.data_ptr():#x}")


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B,S,Hq,D); k/v (..., Hkv, D) of q's dtype, Hq a multiple of Hkv."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B,S,Hq,D) and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} 4-d and equal")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {DTYPES}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    D, Hq, Hkv = q.shape[3], q.shape[2], k.shape[2]
    if k.shape[3] != D or Hq % Hkv:
        raise ValueError(f"head dims differ or Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")


def as_i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def scale_of(D: int) -> float:
    """1/sqrt(D) of the real head dim, as the reference's kernels use."""
    return 1.0 / math.sqrt(D)


def masked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                           causal: bool, window: int = 0) -> torch.Tensor:
    """The reference's golden (``kernels/ref.py`` ``flash_attention_ref``):
    q (B,S,Hq,D); k/v (B,C,Hkv,D); positions absolute (-1 = empty).  Masked
    softmax in fp32; a row with no valid key gives exactly 0, as the
    kernels do.  Returns (B,S,Hq,D) in q's dtype."""
    B, S, Hq, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bskgd,bckd->bskgc", qg, k.float()) / math.sqrt(D)
    kv_pos, q_pos = kv_pos.long(), q_pos.long()
    valid = (kv_pos[:, None, :] >= 0).expand(B, S, C)
    if causal:
        valid = valid & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid = valid & ((q_pos[:, :, None] - kv_pos[:, None, :]) < window)
    mask = valid[:, :, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    w = torch.where(mask, w, torch.zeros_like(w))
    out = torch.einsum("bskgc,bckd->bskgd", w, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def paged_gather_plain(kp: torch.Tensor, vp: torch.Tensor,
                       ppos: torch.Tensor, tbl: torch.Tensor):
    """Each row's logical KV from the pool (``ref.paged_gather_ref``):
    kp/vp (nb,bs,Hkv,D), ppos (nb,bs), tbl (B,M) with -1 unused.  Returns
    (k (B,M*bs,Hkv,D), v, kv_pos (B,M*bs)); unused columns read block 0
    but carry kv_pos = -1."""
    nb, bs = kp.shape[0], kp.shape[1]
    B, M = tbl.shape
    idx = tbl.long().clamp(0, nb - 1)
    kg = kp[idx].reshape(B, M * bs, *kp.shape[2:])
    vg = vp[idx].reshape(B, M * bs, *vp.shape[2:])
    pg = torch.where(tbl[:, :, None] >= 0, ppos[idx].long(),
                     torch.full_like(ppos[idx].long(), -1)).reshape(B, M * bs)
    return kg, vg, pg
