"""Frame-ingest kernel suite: fused downscale + normalize + gate score.

Counterpart of the reference's Pallas suite (``src/repro/kernels/
vision_ops.py``), as hand-written CUDA C++ for Hopper in
``csrc/vision_ops.cu``, built with ``nvcc`` for ``sm_90a`` at first use
and bound with ``ctypes`` (``kernels/build.py``).

  ``ingest_frame``   normalize (uint8 -> [0,1] fp32), resample to BOTH the
                     model resolution and the gate resolution, and score
                     the max block mean-absolute-difference against each
                     stream's reference.  Replaces ``_ingest_kernel``.
  ``scatter_admit``  masked row select: admitted lanes adopt the new model
                     frame in the batch pool (cast to the pool dtype) and the
                     new gate frame in the references.  Replaces
                     ``_scatter_kernel``.
  ``downscale``      the resample half alone, on the ingest's model-row
                     code.  Replaces ``_downscale_kernel``.
  ``block_sad``      the score half alone, on the ingest's gate reduction.
                     Replaces ``_block_sad_kernel``.

Dispatch rule: a CUDA tensor always goes to the hand kernel (or the call
raises); a CPU tensor goes to the plain PyTorch version beside it
(``*_plain``), which is also what the kernels are held against on the card.
There is no fallback from one to the other.  Each wrapper adds one to
``LAUNCHES[name]`` where it launches its kernel, and nowhere else.

Bounds on the card (H100 SXM, 3.35 TB/s HBM, 67 TFLOP/s fp32 outside the
tensor cores).  Every kernel here does a few flops per byte, so each is
bound by the bytes it must move: each input element it needs read once,
each output written once.  P is the number of source pixels per frame the
resample needs: for nearest only the sampled rows x columns (the union over
the model and gate outputs for ingest), for box the whole H*W frame.

  ingest_frame   S*P*C*in_bytes + 2*S*g*g*C*4 + S*m*m*C*4 + 4*S bytes.
                 Design: one launch (:func:`ingest_plan`): a gate block per
                 stream (the gate frame, its |gate-ref| map in shared
                 memory, the tile reduction; the gate frame is never read
                 back from device memory) beside blocks of model rows, a
                 thread holding 16 bytes of several rows, their loads in
                 flight together, gathering through column maps tabulated
                 once per shape (:func:`ingest_tables`).
                 The frame does not fit in a block's shared memory, so the
                 TPU's whole-frame-in-VMEM layout is not copied.
                 :func:`ingest_blocks_plain` is the kernel's arithmetic in
                 plain PyTorch.
  scatter_admit  S*(m*m*C*(4 + pool_bytes) + 2*g*g*C*4) + S bytes: each
                 row reads only the input it selects.  Design: grid (X, S)
                 (:func:`scatter_plan`); a block reads ``admit[s]`` once and
                 copies its share of the row from that one source, 16 bytes
                 a thread; rows that are not 16-byte multiples copy element
                 by element.
  downscale      S*P*C*in_bytes + S*res*res*C*4 bytes.  Design: the
                 ingest's model-row blocks alone, the same device code
                 (:func:`downscale_plan`), so its frames equal
                 ``ingest_frame``'s at the same resolution bit for bit.
  block_sad      2*S*H*W*C*4 + 4*S bytes.  Design: the ingest's gate
                 score alone (:func:`sad_plan`), one block a stream: the
                 same map builder reading the frame at gate size, the same
                 tile reduction, so on the ingest's own gate frame it
                 gives the ingest's score bit for bit.
                 :func:`sad_blocks_plain` is its arithmetic in plain
                 PyTorch; ``downscale``'s is :func:`_resample_rows`.

Measured times beside these bounds are in ``PERF.md``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.attention_common import SMS

METHODS = ("nearest", "box")
_METHOD_CODE = {"nearest": 0, "box": 1}          # csrc/vision_ops.cu kNearest
MAX_CHANNELS = 4                                  # csrc kMaxC
# dynamic shared memory a block may take on the H100 (227 KB), less room
# for the static shared memory beside it
SMEM_MAX = 227 * 1024 - 1024
THREADS = 256                  # csrc kThreads (the scatter's blocks)
ROWS_PER_THREAD = 4            # model rows an ingest thread holds
MAX_ROWS_PER_THREAD = 4        # csrc kMaxRows
GATE_THREADS = 256             # an ingest or block_sad block's threads,
                               # at least
MAX_BLOCK_THREADS = 512        # csrc kMaxBlock
GATE_BATCH = 4                 # csrc kGateBatch: map pixels a thread loads
# the least grid a downscale launch takes where the shapes allow: two
# blocks an SM
DOWNSCALE_MIN_BLOCKS = 2 * SMS
INGEST_TX = 256                # most threads across one model row
SCATTER_UNROLL = 4             # csrc kUnroll: 16-byte copies a thread
# vector-path flags (csrc kModelVec; kBatchRowVec, kRefsRowVec)
_MODEL_VEC = 1
_BATCH_ROW_VEC, _REFS_ROW_VEC = 1, 2
_INT_MAX = 2 ** 31 - 1
# the uint8 normalization factor, rounded to fp32 once so the plain version
# and the kernel multiply by the same float
U8_SCALE = float(np.float32(1.0 / 255.0))

#: launches of each hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ingest_frame": 0, "scatter_admit": 0,
                            "downscale": 0, "block_sad": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vo_downscale": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                     _I, _I, _P),
    "vo_ingest": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _F, _I, _I, _I, _I, _I, _P),
    "vo_block_sad": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "vo_scatter_admit": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build
    lib = build.load("vision_ops")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch(name: str, *args) -> None:
    err = getattr(_lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True: launch the kernel.  False: every tensor is on the CPU, use the
    plain version.  Anything else (mixed devices, another backend) raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"vision_ops runs on cuda or cpu tensors, got {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"kernel inputs must be contiguous, got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
    return True


def _check_frames(frames: torch.Tensor, method: str, res: int) -> None:
    if frames.ndim != 4:
        raise ValueError(f"frames must be (S, H, W, C), got {tuple(frames.shape)}")
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    S, H, W, C = frames.shape
    if S < 1 or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"need S >= 1 and 1 <= C <= {MAX_CHANNELS}, "
                         f"got {tuple(frames.shape)}")
    if method == "box" and (res > H or res > W):
        # box buckets [i*H//res, (i+1)*H//res) are empty when upsampling
        raise ValueError(f"box resampling cannot upsample: res={res}, "
                         f"frames {tuple(frames.shape)}")


def _check_f32(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")


# ---------------------------------------------------------------------------
# launch geometry: host mirrors of what csrc/vision_ops.cu computes
# ---------------------------------------------------------------------------


def _check_rows(rows: int) -> None:
    if not 1 <= rows <= MAX_ROWS_PER_THREAD:
        raise ValueError(f"rows must be in 1..{MAX_ROWS_PER_THREAD}, got "
                         f"{rows}")


def _model_units(H: int, W: int, C: int, m: int, g: int = 0):
    """The model rows' geometry that ``ingest_frame`` and ``downscale``
    share: (16-byte path, units a row, threads across a row, chunks a
    row).  A unit is 16 bytes of output where the row is a multiple of
    that, else one element.  Raises where 32-bit indexing would not hold
    the shapes."""
    if max(H * W * C, (max(m, g) + 1) * max(H, W) * C) > _INT_MAX:
        res = f"{m}/{g}" if g else f"{m}"
        raise ValueError(f"frames ({H}, {W}, {C}) at resolution {res} "
                         f"overflow the kernel's 32-bit indexing")
    model_vec = (m * C) % 4 == 0
    units = m * C // 4 if model_vec else m * C
    tx = min(INGEST_TX, -(-units // 32) * 32)
    return model_vec, units, tx, -(-units // tx)


def ingest_plan(S: int, H: int, W: int, C: int, m: int, g: int, block: int,
                *, rows: int = None) -> dict:
    """The ``ingest_frame`` launch: grid (S, 1 + ceil(m / (ty * rows)),
    chunks), blocks of (tx, ty) threads, at least ``GATE_THREADS``.
    blockIdx.y 0 is each stream's gate block; in every other block thread
    (x, y) holds one 16-byte unit of ``rows`` consecutive model rows
    (``model_rows`` lists each block's) where rows are 16-byte multiples
    (``model_vec``), else one element; ``chunks`` blocks cover a row wider
    than ``INGEST_TX`` units.  Dynamic shared memory: the gate block's
    g x g map.  Raises where the card's grid, a block's shared memory or
    32-bit indexing would not hold the shapes."""
    rows = ROWS_PER_THREAD if rows is None else rows
    _check_rows(rows)
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    model_vec, units, tx, chunks = _model_units(H, W, C, m, g)
    ty = -(-GATE_THREADS // tx)
    group = ty * rows
    groups = -(-m // group)
    smem = g * g * 4
    if smem > SMEM_MAX:
        raise ValueError(f"a {g}x{g} score map needs {smem} bytes of shared "
                         f"memory, over {SMEM_MAX}")
    if 1 + groups > 65535 or chunks > 65535:
        raise ValueError(f"{m} model rows of {units} units overflow the grid")
    return dict(grid=(S, 1 + groups, chunks), block=(tx, ty),
                threads=tx * ty, blocks=S * (1 + groups) * chunks,
                rows=rows, chunks=chunks, units=units,
                model_rows=[(r * group, min(m, (r + 1) * group))
                            for r in range(groups)],
                smem=smem, model_vec=model_vec,
                flags=_MODEL_VEC * model_vec)


def downscale_plan(S: int, H: int, W: int, C: int, res: int, *,
                   rows: int = None) -> dict:
    """The ``downscale`` launch: :func:`ingest_plan`'s model-row blocks
    with no gate block, grid (S, ceil(res / (ty * rows)), chunks) of (tx,
    ty) threads, thread (x, y) holding one 16-byte unit (or one element) of
    ``rows`` consecutive output rows.  No gate block shares the launch, so
    the block is not tied to ``GATE_THREADS``: unless ``rows`` is given,
    the ingest's setting (``ROWS_PER_THREAD`` rows a thread, about
    ``GATE_THREADS`` threads a block) halves its rows a thread, then its
    rows of threads, while the grid holds fewer than
    ``DOWNSCALE_MIN_BLOCKS`` blocks, so a small output (the gate's 32 px)
    still spreads over the card.  Raises where the card's grid or 32-bit
    indexing would not hold the shapes."""
    auto = rows is None
    rows = ROWS_PER_THREAD if auto else rows
    _check_rows(rows)
    model_vec, units, tx, chunks = _model_units(H, W, C, res)
    ty = -(-GATE_THREADS // tx)

    def blocks(ty, rows):
        return S * -(-res // (ty * rows)) * chunks
    while auto and rows > 1 and blocks(ty, rows) < DOWNSCALE_MIN_BLOCKS:
        rows //= 2
    while auto and ty > 1 and blocks(ty, rows) < DOWNSCALE_MIN_BLOCKS:
        ty //= 2
    group = ty * rows
    groups = -(-res // group)
    if groups > 65535 or chunks > 65535:
        raise ValueError(f"{res} rows of {units} units overflow the grid")
    return dict(grid=(S, groups, chunks), block=(tx, ty), threads=tx * ty,
                blocks=S * groups * chunks, rows=rows, chunks=chunks,
                units=units, model_rows=[(r * group, min(res, (r + 1) * group))
                                         for r in range(groups)],
                model_vec=model_vec, flags=_MODEL_VEC * model_vec)


def sad_plan(S: int, H: int, W: int, C: int, block: int) -> dict:
    """The ``block_sad`` launch: grid (S,), one block a stream of
    ``threads``: at least ``GATE_THREADS``, and up to ``MAX_BLOCK_THREADS``
    a warp a tile and at most ``GATE_BATCH`` map pixels a thread; the H x W
    map in dynamic shared memory, ``tiles`` block x block tiles dealt to
    its warps in turn.  Raises where a block's shared memory or the
    kernel's channels would not hold the shapes."""
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"the block_sad kernel takes 1..{MAX_CHANNELS} "
                         f"channels, got {C}")
    smem = H * W * 4
    if smem > SMEM_MAX:
        raise ValueError(f"a {H}x{W} score map needs {smem} bytes of shared "
                         f"memory, over {SMEM_MAX}")
    tiles = -(-H // block) * -(-W // block)
    warps = max(tiles, -(-H * W // (GATE_BATCH * 32)))
    threads = min(MAX_BLOCK_THREADS, max(GATE_THREADS, warps * 32))
    return dict(grid=(S,), blocks=S, threads=threads, smem=smem,
                tiles=tiles)


def ingest_tables(W: int, C: int, m: int, g: int,
                  method: str = "nearest") -> torch.Tensor:
    """The ingest kernel's column maps, int32: for each model element e (of
    m * C) the offset of its first source element in a source row, for box
    also the end of its bucket, then each gate pixel's source column
    (g + 1 entries: box reads [gx[j], gx[j+1])).  g = 0: the model's maps
    alone (``downscale``)."""
    c = torch.arange(C)

    def elems(x):                    # pixel columns -> element offsets
        return (x[:, None] * C + c).reshape(-1)
    j = torch.arange(m)
    parts = [elems(j * W // m)]
    if method == "box":
        parts.append(elems((j + 1) * W // m))
    if g:
        parts.append(torch.arange(g + 1) * W // g)
    return torch.cat(parts).to(torch.int32)


@functools.lru_cache(maxsize=64)
def _device_tables(W: int, C: int, m: int, g: int, method: str,
                   device: torch.device) -> torch.Tensor:
    return ingest_tables(W, C, m, g, method).to(device)


def _chunks(units: int, parts: int) -> List[Tuple[int, int]]:
    """Block x's share [lo, hi) of a row of ``units``, as the kernel
    splits it: ``parts`` contiguous chunks of ceil(units / parts)."""
    chunk = -(-units // parts)
    out = []
    for x in range(parts):
        lo = min(x * chunk, units)
        out.append((lo, min(lo + chunk, units)))
    return out


def scatter_plan(S: int, nb: int, nr: int, pool_dtype) -> dict:
    """The ``scatter_admit`` launch: grid (X, S), ``THREADS`` a block.  A
    row of the pool copies in 16-byte units (4 fp32 or 8 bf16 elements)
    when its length is a multiple of the unit, else element by element;
    the references likewise (4 fp32).  X gives each thread at most
    ``SCATTER_UNROLL`` units of the pool row, all in flight at once."""
    if S > 65535 or max(nb, nr) > _INT_MAX // 4:
        raise ValueError(f"scatter rows of {nb} / {nr} elements x {S} "
                         f"overflow the kernel's grid or 32-bit offsets")
    per = 8 if pool_dtype == torch.bfloat16 else 4
    batch_vec, refs_vec = nb % per == 0, nr % 4 == 0
    units_b = nb // per if batch_vec else nb
    units_r = nr // 4 if refs_vec else nr
    X = max(1, -(-units_b // (SCATTER_UNROLL * THREADS)))
    return dict(grid=(X, S), blocks=X * S, threads=THREADS,
                batch_vec=batch_vec, refs_vec=refs_vec, batch_units=units_b,
                refs_units=units_r, batch_per_unit=per if batch_vec else 1,
                refs_per_unit=4 if refs_vec else 1,
                flags=(_BATCH_ROW_VEC * batch_vec)
                | (_REFS_ROW_VEC * refs_vec))


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def normalize_plain(frames: torch.Tensor) -> torch.Tensor:
    """fp32; uint8 additionally scales to [0, 1]."""
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * U8_SCALE
    return x


def _box_weights(n_out: int, n_in: int, device) -> torch.Tensor:
    i = np.arange(n_out)[:, None]
    j = np.arange(n_in)[None, :]
    lo, hi = i * n_in // n_out, (i + 1) * n_in // n_out
    w = ((j >= lo) & (j < hi)) / (hi - lo)                 # rows sum to 1
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def downscale_plain(frames: torch.Tensor, res: int, *,
                    method: str = "nearest") -> torch.Tensor:
    """(S, H, W, C) -> (S, res, res, C) fp32: normalize, then resample.
    Nearest is the strided gather at ``i * H // res``; box is the mean of
    the bucket ``[i*H//res, (i+1)*H//res)``."""
    x = normalize_plain(frames)
    S, H, W, C = x.shape
    if method == "nearest":
        ys = torch.arange(res, device=x.device) * H // res
        xs = torch.arange(res, device=x.device) * W // res
        return x[:, ys][:, :, xs]
    wy = _box_weights(res, H, x.device)
    wx = _box_weights(res, W, x.device)
    x = torch.einsum("ih,shwc->siwc", wy, x)
    return torch.einsum("jw,siwc->sijc", wx, x)


def block_sad_plain(refs: torch.Tensor, frames: torch.Tensor,
                    block: int = 8) -> torch.Tensor:
    """Per-stream max block mean-absolute-difference -> (S,) fp32.  H, W
    need not divide ``block``: edge blocks average their valid pixels."""
    S, H, W, _ = frames.shape
    # cast before subtracting: a uint8 difference would wrap modulo 256
    d = (frames.to(torch.float32) - refs.to(torch.float32)).abs().mean(dim=-1)
    nh, nw = -(-H // block), -(-W // block)
    d = torch.nn.functional.pad(d, (0, nw * block - W, 0, nh * block - H))
    sums = d.reshape(S, nh, block, nw, block).sum(dim=(2, 4))
    cnt_h = np.minimum(block, H - np.arange(nh) * block)
    cnt_w = np.minimum(block, W - np.arange(nw) * block)
    counts = torch.as_tensor(np.outer(cnt_h, cnt_w), dtype=torch.float32,
                             device=d.device)
    return (sums / counts).reshape(S, -1).amax(dim=-1)


def ingest_frame_plain(frames: torch.Tensor, refs: torch.Tensor, *,
                       model_res: int, gate_res: int, block: int = 8,
                       method: str = "nearest"):
    """The three passes ``ingest_frame`` fuses."""
    model = downscale_plain(frames, model_res, method=method)
    gate = downscale_plain(frames, gate_res, method=method)
    return model, gate, block_sad_plain(refs, gate, block)


def _resample_rows(x: torch.Tensor, res: int, method: str) -> torch.Tensor:
    """x (S, H, W, C, fp32) resampled to res x res in the kernel's
    arithmetic: nearest gathers; box adds each bucket's elements one at a
    time, row by row, left to right, then divides by the bucket's size."""
    S, H, W, C = x.shape
    xs = torch.arange(res, device=x.device) * W // res
    if method == "nearest":
        ys = torch.arange(res, device=x.device) * H // res
        return x[:, ys][:, :, xs]
    wid = (torch.arange(1, res + 1, device=x.device) * W // res) - xs
    rows = []
    for i in range(res):
        y0, y1 = i * H // res, (i + 1) * H // res
        acc = x.new_zeros((S, res, C))
        for y in range(y0, y1):
            for k in range(int(wid.max())):
                col = (xs + k).clamp(max=W - 1)
                acc = torch.where((k < wid)[None, :, None],
                                  acc + x[:, y, col], acc)
        rows.append(acc / ((y1 - y0) * wid).to(torch.float32)[None, :, None])
    return torch.stack(rows, dim=1)


def _tile_max(d: torch.Tensor, block: int) -> torch.Tensor:
    """The gate score's reduction of the (S, h, w) map: per tile, lane l of
    a warp sums the tile's columns l, l+32, ... top to bottom, a fixed tree
    of shuffles adds the 32 lanes, the sum is divided by the tile's valid
    pixels; the max over tiles.  (S,) fp32."""
    S, h, w = d.shape
    best = d.new_full((S,), float("-inf"))
    for y0 in range(0, h, block):
        for x0 in range(0, w, block):
            v = d[:, y0:y0 + block, x0:x0 + block]
            hy, hx = v.shape[1:]
            v = torch.nn.functional.pad(v, (0, -(-hx // 32) * 32 - hx))
            lanes = d.new_zeros((S, 32))
            for j in range(v.shape[2] // 32):
                for yy in range(hy):
                    lanes = lanes + v[:, yy, 32 * j:32 * (j + 1)]
            for off in (16, 8, 4, 2, 1):
                lanes = lanes[:, :off] + lanes[:, off:2 * off]
            best = torch.maximum(best, lanes[:, 0] / torch.full_like(
                best, float(hy * hx)))
    return best


def sad_blocks_plain(refs: torch.Tensor, frames: torch.Tensor,
                     block: int = 8) -> torch.Tensor:
    """``block_sad``'s kernel arithmetic in plain PyTorch (and the
    ingest's score of its gate frame): the map as the kernel builds it,
    per pixel the channels' |frame - ref| added in order and divided by a
    tensor C, then :func:`_tile_max`.  (S,) fp32."""
    C = frames.shape[3]
    diff = frames.new_zeros(frames.shape[:3])
    for c in range(C):
        diff = diff + (frames[..., c] - refs[..., c]).abs()
    return _tile_max(diff / torch.full_like(diff, float(C)), block)


def ingest_blocks_plain(frames: torch.Tensor, refs: torch.Tensor, *,
                        model_res: int, gate_res: int, block: int = 8,
                        method: str = "nearest"):
    """``ingest_frame``'s kernel arithmetic in plain PyTorch: the model rows
    as the model blocks compute them; the gate block's frame and its score
    (:func:`sad_blocks_plain`).  Nearest frames equal
    :func:`ingest_frame_plain`'s bitwise; box frames and the score sum in
    the kernel's order instead of the einsum's.  Every division is by a
    tensor: PyTorch divides a CUDA tensor by a Python number as a product
    with its reciprocal, which rounds differently."""
    x = normalize_plain(frames)
    model = _resample_rows(x, model_res, method)
    gate = _resample_rows(x, gate_res, method)
    return model, gate, sad_blocks_plain(refs, gate, block)


def scatter_blocks_plain(batch, model, refs, gate, admit):
    """``scatter_admit``'s kernel decomposition in plain PyTorch: every
    (block, stream) of :func:`scatter_plan`'s grid copies its chunk of the
    row, in 16-byte units or element by element, from the one source its
    stream's admit bit selects.  Returns new tensors (batch', refs')."""
    S = batch.shape[0]
    plan = scatter_plan(S, batch[0].numel(), refs[0].numel(), batch.dtype)
    X = plan["grid"][0]
    outs = (torch.empty_like(batch), torch.empty_like(refs))
    rows = ((batch, model, outs[0], plan["batch_units"],
             plan["batch_per_unit"]),
            (refs, gate, outs[1], plan["refs_units"], plan["refs_per_unit"]))
    for s in range(S):
        take = bool(admit[s])
        for keep, adopt, out, units, per in rows:
            src = (adopt if take else keep)[s].reshape(-1)
            dst = out[s].view(-1)
            for lo, hi in _chunks(units, X):
                dst[lo * per:hi * per] = src[lo * per:hi * per].to(out.dtype)
    return outs


def scatter_admit_plain(batch, model, refs, gate, admit):
    """Masked row select into new tensors: (batch', refs')."""
    m = admit.reshape(-1, 1, 1, 1)
    return (torch.where(m, model.to(batch.dtype), batch),
            torch.where(m, gate.to(refs.dtype), refs))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def ingest_frame(frames: torch.Tensor, refs: torch.Tensor, *, model_res: int,
                 gate_res: int, block: int = 8, method: str = "nearest"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused ingest: (S,H,W,C) frames + (S,g,g,C) refs ->
    (model (S,m,m,C) fp32, gate (S,g,g,C) fp32, scores (S,) fp32)."""
    # box feasibility must hold for BOTH output resolutions
    _check_frames(frames, method, max(model_res, gate_res))
    S, H, W, C = frames.shape
    if tuple(refs.shape) != (S, gate_res, gate_res, C):
        raise ValueError(f"refs {tuple(refs.shape)} != "
                         f"{(S, gate_res, gate_res, C)}")
    _check_f32("refs", refs)
    if not _on_cuda(frames, refs):
        return ingest_frame_plain(frames, refs, model_res=model_res,
                                  gate_res=gate_res, block=block,
                                  method=method)
    plan = ingest_plan(S, H, W, C, model_res, gate_res, block)
    opts = dict(dtype=torch.float32, device=frames.device)
    model = torch.empty((S, model_res, model_res, C), **opts)
    gate = torch.empty((S, gate_res, gate_res, C), **opts)
    score = torch.empty((S,), **opts)
    tab = _device_tables(W, C, model_res, gate_res, method, frames.device)
    is_u8 = frames.dtype == torch.uint8
    _launch("vo_ingest", frames.data_ptr(), refs.data_ptr(), tab.data_ptr(),
            model.data_ptr(), gate.data_ptr(), score.data_ptr(),
            S, H, W, C, model_res, gate_res, block, int(is_u8),
            _METHOD_CODE[method], U8_SCALE if is_u8 else 1.0, plan["rows"],
            *plan["block"], plan["chunks"], plan["flags"], _stream(frames))
    LAUNCHES["ingest_frame"] += 1
    return model, gate, score


def downscale(frames: torch.Tensor, res: int, *,
              method: str = "nearest") -> torch.Tensor:
    """(S, H, W, C) -> (S, res, res, C) fp32 normalized resample."""
    _check_frames(frames, method, res)
    if not _on_cuda(frames):
        return downscale_plain(frames, res, method=method)
    S, H, W, C = frames.shape
    plan = downscale_plan(S, H, W, C, res)
    out = torch.empty((S, res, res, C), dtype=torch.float32,
                      device=frames.device)
    tab = _device_tables(W, C, res, 0, method, frames.device)
    is_u8 = frames.dtype == torch.uint8
    _launch("vo_downscale", frames.data_ptr(), tab.data_ptr(),
            out.data_ptr(), S, H, W, C, res, int(is_u8),
            _METHOD_CODE[method], U8_SCALE if is_u8 else 1.0, plan["rows"],
            *plan["block"], plan["chunks"], plan["flags"], _stream(frames))
    LAUNCHES["downscale"] += 1
    return out


def block_sad(refs: torch.Tensor, frames: torch.Tensor, block: int = 8
              ) -> torch.Tensor:
    """Per-stream max block-MAD of (S,H,W,C) frames vs refs -> (S,) fp32."""
    if refs.shape != frames.shape or frames.ndim != 4:
        raise ValueError(f"refs {tuple(refs.shape)} and frames "
                         f"{tuple(frames.shape)} must be equal (S, H, W, C)")
    _check_f32("refs", refs)
    _check_f32("frames", frames)
    if not _on_cuda(refs, frames):
        return block_sad_plain(refs, frames, block)
    S, H, W, C = frames.shape
    plan = sad_plan(S, H, W, C, block)
    score = torch.empty((S,), dtype=torch.float32, device=frames.device)
    _launch("vo_block_sad", refs.data_ptr(), frames.data_ptr(),
            score.data_ptr(), S, H, W, C, block, plan["threads"],
            _stream(frames))
    LAUNCHES["block_sad"] += 1
    return score


def scatter_admit(batch: torch.Tensor, model: torch.Tensor,
                  refs: torch.Tensor, gate: torch.Tensor,
                  admit: torch.Tensor):
    """Masked admission scatter: rows of ``admit`` adopt the new model frame
    in ``batch`` and the new gate frame in ``refs``; gated rows keep both.
    Returns NEW tensors (batch', refs') — the inputs stay as they were, so a
    caller holding one of their rows (a saved gate reference) never sees it
    change."""
    if batch.shape != model.shape or refs.shape != gate.shape:
        raise ValueError(f"batch {tuple(batch.shape)} / model "
                         f"{tuple(model.shape)}, refs {tuple(refs.shape)} / "
                         f"gate {tuple(gate.shape)} must match pairwise")
    if admit.dtype != torch.bool or tuple(admit.shape) != (batch.shape[0],):
        raise ValueError(f"admit must be a ({batch.shape[0]},) bool tensor")
    if batch.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"batch must be float32 or bfloat16, got {batch.dtype}")
    for name, t in (("model", model), ("refs", refs), ("gate", gate)):
        _check_f32(name, t)
    if not _on_cuda(batch, model, refs, gate, admit):
        return scatter_admit_plain(batch, model, refs, gate, admit)
    S = batch.shape[0]
    plan = scatter_plan(S, batch[0].numel(), refs[0].numel(), batch.dtype)
    batch_out, refs_out = torch.empty_like(batch), torch.empty_like(refs)
    flags = plan["flags"]
    if not _aligned(batch, model):
        flags &= ~_BATCH_ROW_VEC
    if not _aligned(refs, gate):
        flags &= ~_REFS_ROW_VEC
    _launch("vo_scatter_admit", admit.data_ptr(), batch.data_ptr(),
            model.data_ptr(), refs.data_ptr(), gate.data_ptr(),
            batch_out.data_ptr(), refs_out.data_ptr(),
            batch[0].numel(), refs[0].numel(), S,
            int(batch.dtype == torch.bfloat16), plan["grid"][0], flags,
            _stream(batch))
    LAUNCHES["scatter_admit"] += 1
    return batch_out, refs_out
