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
  ``downscale``      the resample half alone.  Replaces ``_downscale_kernel``.
  ``block_sad``      the score half alone.  Replaces ``_block_sad_kernel``.

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
                 Design: one thread per model-resolution output pixel over
                 many blocks per stream (the frame does not fit in a
                 block's shared memory, so the TPU's whole-frame-in-VMEM
                 layout is not copied), plus one block per stream for the
                 small gate frame whose |gate-ref| map stays in shared
                 memory for the block reduction — the gate frame is never
                 read back from device memory.
  scatter_admit  S*(m*m*C*(4 + pool_bytes) + 2*g*g*C*4) + S bytes: each
                 row reads only the input it selects.  Design: one flat
                 grid-stride pass, each element a select.
  downscale      S*P*C*in_bytes + S*res*res*C*4 bytes.
  block_sad      2*S*H*W*C*4 + 4*S bytes; one block per stream, the
                 difference map in shared memory.

These are first, simple kernels: measured times beside these bounds are in
``PERF.md``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

METHODS = ("nearest", "box")
_METHOD_CODE = {"nearest": 0, "box": 1}          # csrc/vision_ops.cu kNearest
MAX_CHANNELS = 4                                  # csrc kMaxC
SHARED_BYTES = 48 * 1024       # static-launch shared memory per block
# the uint8 normalization factor, rounded to fp32 once so the plain version
# and the kernel multiply by the same float
U8_SCALE = float(np.float32(1.0 / 255.0))

#: launches of each hand kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"ingest_frame": 0, "scatter_admit": 0,
                            "downscale": 0, "block_sad": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "vo_downscale": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "vo_ingest": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _F, _P),
    "vo_block_sad": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "vo_scatter_admit": (_P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P),
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


def _check_shared(h: int, w: int, block: int) -> None:
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if h * w * 4 > SHARED_BYTES:
        raise ValueError(f"a {h}x{w} score map needs {h * w * 4} bytes of "
                         f"shared memory, over {SHARED_BYTES}")


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
    _check_shared(gate_res, gate_res, block)
    opts = dict(dtype=torch.float32, device=frames.device)
    model = torch.empty((S, model_res, model_res, C), **opts)
    gate = torch.empty((S, gate_res, gate_res, C), **opts)
    score = torch.empty((S,), **opts)
    is_u8 = frames.dtype == torch.uint8
    _launch("vo_ingest", frames.data_ptr(), refs.data_ptr(),
            model.data_ptr(), gate.data_ptr(), score.data_ptr(),
            S, H, W, C, model_res, gate_res, block, int(is_u8),
            _METHOD_CODE[method], U8_SCALE if is_u8 else 1.0,
            _stream(frames))
    LAUNCHES["ingest_frame"] += 1
    return model, gate, score


def downscale(frames: torch.Tensor, res: int, *,
              method: str = "nearest") -> torch.Tensor:
    """(S, H, W, C) -> (S, res, res, C) fp32 normalized resample."""
    _check_frames(frames, method, res)
    if not _on_cuda(frames):
        return downscale_plain(frames, res, method=method)
    S, H, W, C = frames.shape
    out = torch.empty((S, res, res, C), dtype=torch.float32,
                      device=frames.device)
    is_u8 = frames.dtype == torch.uint8
    _launch("vo_downscale", frames.data_ptr(), out.data_ptr(), S, H, W, C,
            res, int(is_u8), _METHOD_CODE[method],
            U8_SCALE if is_u8 else 1.0, _stream(frames))
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
    _check_shared(H, W, block)
    score = torch.empty((S,), dtype=torch.float32, device=frames.device)
    _launch("vo_block_sad", refs.data_ptr(), frames.data_ptr(),
            score.data_ptr(), S, H, W, C, block, _stream(frames))
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
    batch_out, refs_out = torch.empty_like(batch), torch.empty_like(refs)
    _launch("vo_scatter_admit", admit.data_ptr(), batch.data_ptr(),
            model.data_ptr(), refs.data_ptr(), gate.data_ptr(),
            batch_out.data_ptr(), refs_out.data_ptr(),
            batch[0].numel(), refs[0].numel(), S,
            int(batch.dtype == torch.bfloat16), _stream(batch))
    LAUNCHES["scatter_admit"] += 1
    return batch_out, refs_out
