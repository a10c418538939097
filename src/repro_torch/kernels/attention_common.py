"""What the four attention kernels share: the libraries, the dispatch
rule, the input checks, the split of the keys over blocks with its
workspace and ticket counters, and the plain masked attention.

The kernels themselves live in two CUDA sources, each built with ``nvcc``
for ``sm_90a`` at first use (``kernels/build.py``): ``csrc/attention.cu``
(the two flash kernels, one templated routine) and
``csrc/decode_attention.cu`` (the two decode kernels, one templated
routine); both split each row's keys over blocks and merge the splits'
partials in the same launch, and both take their ``cp.async``,
``ldmatrix`` and ``mma`` helpers from ``csrc/attention_helpers.cuh``.
Their wrappers, launch counts and plain versions are in
``flash_attention.py``, ``decode_attention.py`` and ``paged_attention.py``.
The split rules (``decode_split``, ``flash_split``) are computed from the
shapes alone, so no wrapper waits for the card; ``split_partials_plain``
and ``merge_partials_plain`` model the split arithmetic on the CPU.

Dispatch rule: a CUDA tensor always goes to the hand kernel (or the call
raises); a CPU tensor goes to the plain PyTorch version.  There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128, 256)  # instantiated in both CUDA sources
DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: {source under csrc/: ((C entry point, argtypes), ...)}
_LIBRARIES = {
    "attention": (
        ("attn_flash", (_P,) * 8 + (_I,) * 10 + (_F, _I, _P)),
        ("attn_paged_flash", (_P,) * 9 + (_I,) * 11 + (_F, _I, _P)),
    ),
    "decode_attention": (
        ("attn_decode", (_P,) * 8 + (_I,) * 7 + (_F, _I, _P)),
        ("attn_paged_decode", (_P,) * 9 + (_I,) * 8 + (_F, _I, _P)),
        ("attn_decode_smem", (_I,) * 3),
    ),
}
_SOURCE_OF = {fn: src for src, sigs in _LIBRARIES.items() for fn, _ in sigs}

# the decode kernels' split of the keys (csrc/decode_attention.cu)
ROWS = 16            # query heads of a GQA group per block (kRows)
SPLIT_QUANTUM = 64   # split sizes are multiples of this (kWarps * kChunk)
SPLIT_KEYS = 128     # keys per split unless the capacity needs more
MAX_SPLITS = 128     # kMaxSplits

# the flash kernels' rows and split (csrc/attention.cu)
FLASH_ROWS = 64            # query rows per block, bf16: 64 or 128 (kBR)
FLASH_TILE = 64            # keys per tile (kTileK); splits are multiples
FLASH_SPLIT_KEYS = 256     # keys per split unless the grid is small
FLASH_MAX_SPLITS = 64      # kMaxSplits of attention.cu
SMS = 132                  # an H100 SXM's SMs, where no card is asked


def launch(name: str, *args) -> None:
    """Launch C entry point ``name`` of its ``csrc`` source (built at first
    use)."""
    src = _SOURCE_OF[name]
    build.launch(build.bind(src, _LIBRARIES[src]), name, *args)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need ``name``'s backward: grad mode is on
    and a floating input requires grad.  The hand kernels return tensors
    without a ``grad_fn`` (the reference's Pallas kernels have no VJP
    either, and ``jax.grad`` through them fails), so a silent launch would
    drop the gradient of everything feeding them.  Called before the
    device dispatch, so the plain CPU path refuses too."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors if t.is_floating_point()):
        raise RuntimeError(
            f"{name}: the hand kernel has no backward (neither has the "
            f"reference's Pallas kernel); train with use_kernels=False, or "
            f"call it under torch.no_grad()")


_DTENSOR = []


def refuse_dtensor(name: str, *tensors: torch.Tensor) -> None:
    """Raise for a DTensor input: a hand kernel runs on one device's whole
    tensors, and a silent gather would hide the mesh.  The sharded paths
    (training, the dry-run) run the plain path (``use_kernels=False``),
    as the reference's presets do."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    if any(isinstance(t, _DTENSOR[0]) for t in tensors):
        raise TypeError(f"{name}: a DTensor reached the hand kernel; run "
                        f"sharded tensors with use_kernels=False, or gather "
                        f"them (full_tensor) first")


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


def check_aligned(*ts: torch.Tensor) -> None:
    """The kernels read K/V rows (and the decode kernels q rows) as 8- and
    16-byte vectors."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"q/K/V must be 16-byte aligned, got a tensor at "
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


def decode_split(capacity: int) -> tuple:
    """(keys per split, splits) of a decode call over ``capacity`` logical
    entries (C, or M * bs): SPLIT_KEYS, raised to a multiple of
    SPLIT_QUANTUM where more than MAX_SPLITS splits would be needed.  From
    the shapes alone, so the wrapper never waits for the card."""
    keys = max(SPLIT_KEYS, -(-capacity // MAX_SPLITS))
    keys = -(-keys // SPLIT_QUANTUM) * SPLIT_QUANTUM
    return keys, max(1, -(-capacity // keys))


def decode_smem_bytes(D: int, dtype: torch.dtype, split_keys: int) -> int:
    """Dynamic shared memory of one decode block (builds the library)."""
    lib = build.bind("decode_attention", _LIBRARIES["decode_attention"])
    return lib.attn_decode_smem(D, split_keys, int(dtype == torch.bfloat16))


_COUNTERS: dict = {}


def ticket_counters(kind: str, device: torch.device,
                    n: int = 0) -> torch.Tensor:
    """The ticket counters of the ``kind`` kernels ("decode" or "flash") on
    ``device``, at least ``n`` of them: zeroed once and reused, as every
    call leaves them at 0 again.  Each kind has its own buffer, so a decode
    call never meets a flash call's tickets; one buffer per device and
    kind assumes the calls on a device run on one stream."""
    c = _COUNTERS.get((kind, device))
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[(kind, device)] = c
    return c


def decode_counters(device: torch.device, n: int = 0) -> torch.Tensor:
    """The decode kernels' ticket counters (:func:`ticket_counters`)."""
    return ticket_counters("decode", device, n)


def flash_counters(device: torch.device, n: int = 0) -> torch.Tensor:
    """The flash kernels' ticket counters (:func:`ticket_counters`)."""
    return ticket_counters("flash", device, n)


def launch_decode(name: str, q: torch.Tensor, kv_ptrs: tuple, dims: tuple,
                  Hkv: int, capacity: int, window: int) -> torch.Tensor:
    """Launch ``attn_decode`` or ``attn_paged_decode`` on q (B,1,Hq,D):
    ``kv_ptrs`` are the source's pointers after q, ``dims`` its sizes after
    Hkv (C, or bs and M).  Allocates the output and the fp32 workspace of
    the partials; returns the output."""
    B, _, Hq, D = q.shape
    split_keys, splits = decode_split(capacity)
    slots = B * Hkv * -(-(Hq // Hkv) // ROWS)
    ws = torch.empty(slots * splits * ROWS * (D + 2), dtype=torch.float32,
                     device=q.device)
    cnt = decode_counters(q.device, slots)
    out = torch.empty_like(q)
    launch(name, q.data_ptr(), *kv_ptrs, out.data_ptr(), ws.data_ptr(),
           cnt.data_ptr(), B, Hq, Hkv, *dims, D, int(window), split_keys,
           scale_of(D), int(q.dtype == torch.bfloat16), stream(q))
    return out


def flash_rows(dtype: torch.dtype) -> int:
    """Query rows per flash block: FLASH_ROWS for bf16; fp32 (the tests and
    the card-vs-CPU checks) always takes 64, whose fp32 tiles fit the
    shared memory at every head dim."""
    return FLASH_ROWS if dtype == torch.bfloat16 else 64


def flash_split(B: int, S: int, G: int, Hkv: int, capacity: int, *,
                rows: int = 64, sms: int = SMS) -> tuple:
    """(row tiles, keys per split, splits) of a flash call: S query tokens
    of B rows, GQA group G, over ``capacity`` logical entries (C, or M *
    bs).  The rows of a (b, kv head) enumerate (s, g), cut into tiles of
    ``rows``; the keys are cut into splits of FLASH_SPLIT_KEYS, halved
    (down to one FLASH_TILE) while the grid B * Hkv * row tiles * splits
    would not give every one of the ``sms`` SMs a block, and raised to a
    multiple of FLASH_TILE where more than FLASH_MAX_SPLITS splits would be
    needed.  From the shapes alone, so the wrapper never waits for the
    card."""
    row_tiles = -(-S * G // rows)
    base = B * Hkv * row_tiles
    keys = FLASH_SPLIT_KEYS
    while keys > FLASH_TILE and base * -(-capacity // keys) < sms:
        keys = max(FLASH_TILE, -(-(keys // 2) // FLASH_TILE) * FLASH_TILE)
    cap_keys = -(-capacity // FLASH_MAX_SPLITS)
    keys = max(keys, -(-cap_keys // FLASH_TILE) * FLASH_TILE)
    return row_tiles, keys, max(1, -(-capacity // keys))


def flash_smem_bytes(D: int, dtype: torch.dtype, rows: int, split_keys: int,
                     splits: int) -> int:
    """Dynamic shared memory of one flash block, as ``smem_bytes`` of
    attention.cu counts it: q's rows, the K/V ring (two stages where they
    fit the 223 KB, else one; in the merging block it also holds every
    split's m and l), fp32's P scratch, and the split's positions and tile
    list.  Each shared-memory row is D plus 16 bytes of padding."""
    size = 2 if dtype == torch.bfloat16 else 4
    row = (D + 16 // size) * size
    q = rows * row
    stage = 2 * FLASH_TILE * row
    scratch = 0 if size == 2 else rows * (FLASH_TILE + 4) * 4
    ring = 2 if q + 2 * stage + scratch + 16 * 1024 <= 223 * 1024 else 1
    region = max(ring * stage, 8 * splits * rows)
    return (q + region + scratch
            + 4 * (2 * split_keys + split_keys // FLASH_TILE))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_flash(name: str, q: torch.Tensor, kv_ptrs: tuple, dims: tuple,
                 Hkv: int, capacity: int, causal: bool,
                 window: int) -> torch.Tensor:
    """Launch ``attn_flash`` or ``attn_paged_flash`` on q (B,S,Hq,D):
    ``kv_ptrs`` are the source's pointers after q (q_pos last), ``dims``
    its sizes after Hkv (C, or bs and M).  Allocates the output and, with
    more than one split, the fp32 workspace of the partials; returns the
    output."""
    B, S, Hq, D = q.shape
    rows = flash_rows(q.dtype)
    row_tiles, split_keys, splits = flash_split(
        B, S, Hq // Hkv, Hkv, capacity, rows=rows,
        sms=_sm_count(q.device.index))
    slots = B * Hkv * row_tiles
    ws = cnt = None
    if splits > 1:
        ws = torch.empty(slots * splits * rows * (D + 2), dtype=torch.float32,
                         device=q.device)
        cnt = flash_counters(q.device, slots)
    out = torch.empty_like(q)
    launch(name, q.data_ptr(), *kv_ptrs, out.data_ptr(),
           0 if ws is None else ws.data_ptr(),
           0 if cnt is None else cnt.data_ptr(), B, S, Hq, Hkv, *dims, D,
           int(causal), int(window), rows, split_keys, scale_of(D),
           int(q.dtype == torch.bfloat16), stream(q))
    return out


def check_int32_rows(rows: int) -> None:
    """The kernels index K/V rows with 32-bit ints."""
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} K/V entries do not fit 32-bit row indices")


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


def split_partials_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                         split_keys: int, window: int = 0,
                         causal: bool = True, rows: int | None = None):
    """The plain counterpart of the kernels' split blocks: the keys cut
    into splits of ``split_keys`` logical entries, each split's
    unnormalised online-softmax state for every query row.  q (B,S,Hq,D);
    k/v (B,C,Hkv,D); q_pos (B,S); kv_pos (B,C).  Returns fp32 (m, l, acc);
    a (split, row) with no valid key gives (-1e30, 0, 0).

    Without ``rows``: m, l (B, n, S * Hq) and acc (B, n, S * Hq, D), the
    rows in q's (s, head) order; at S = 1 that is the decode kernels'
    layout (their rows are the query heads).  With ``rows`` (the flash
    kernels' row tile): the rows of each (b, kv head) enumerate (s, g), g
    fastest, cut into tiles of ``rows``, the last padded with inert rows;
    m, l (B, Hkv, T, n, rows) and acc (B, Hkv, T, n, rows, D), one (b, kv
    head, tile) per ticket counter of the kernel.  Nothing on the card's
    path calls it."""
    B, S, Hq, D = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n = max(1, -(-C // split_keys))
    qg = q.reshape(B, S, Hkv, G, D).float()
    kp, qp = kv_pos.long()[:, None, :], q_pos.long()[:, :, None]
    valid = (kp >= 0).expand(B, S, C)
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & ((qp - kp) < window)
    ms, ls, accs = [], [], []
    for i in range(n):
        sl = slice(i * split_keys, (i + 1) * split_keys)
        s = torch.einsum("bskgd,bckd->bskgc", qg,
                         k[:, sl].float()) / math.sqrt(D)
        ok = valid[:, :, None, None, sl]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
        ms.append(m)                                     # (B, S, Hkv, G)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bskgc,bckd->bskgd", p, v[:, sl].float()))
    m, l, acc = torch.stack(ms, 1), torch.stack(ls, 1), torch.stack(accs, 1)
    if rows is None:
        return (m.reshape(B, n, S * Hq), l.reshape(B, n, S * Hq),
                acc.reshape(B, n, S * Hq, D))
    T = -(-S * G // rows)
    pad = T * rows - S * G

    def tiles(x, fill):
        # (B, n, S, Hkv, G, ...) -> (B, Hkv, T, n, rows, ...)
        x = x.movedim(3, 1).reshape(B, Hkv, n, S * G, *x.shape[5:])
        x = torch.cat([x, x.new_full((B, Hkv, n, pad, *x.shape[4:]), fill)],
                      dim=3)
        return x.reshape(B, Hkv, n, T, rows, *x.shape[4:]).movedim(3, 2)

    return tiles(m, NEG_INF), tiles(l, 0.0), tiles(acc, 0.0)


def untile_rows_plain(x: torch.Tensor, S: int, G: int) -> torch.Tensor:
    """Tiled rows (B, Hkv, T, rows, ...) of :func:`split_partials_plain`
    (after :func:`merge_partials_plain`) back to (B, S, Hkv * G, ...),
    dropping the padded rows."""
    B, Hkv, T, rows = x.shape[:4]
    x = x.reshape(B, Hkv, T * rows, *x.shape[4:])[:, :, :S * G]
    x = x.reshape(B, Hkv, S, G, *x.shape[3:]).movedim(1, 2)
    return x.reshape(B, S, Hkv * G, *x.shape[4:])


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """The plain counterpart of the kernels' merge: partials m, l
    (..., n, R) and acc (..., n, R, D) of n splits, fp32, give m* = max m_i,
    l = sum l_i e^(m_i - m*), acc = sum acc_i e^(m_i - m*) and out = acc /
    max(l, 1e-30) (..., R, D); a row with no valid key in any split (every
    l_i = 0, acc_i = 0) gives exactly 0.  Nothing on the card's path calls
    it."""
    m_star = m.amax(dim=-2, keepdim=True)
    w = torch.exp(m - m_star)
    l_sum = (l * w).sum(dim=-2)
    a = (acc * w[..., None]).sum(dim=-3)
    return a / l_sum.clamp(min=1e-30)[..., None]
