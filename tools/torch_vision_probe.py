#!/usr/bin/env python3
"""Where the time goes inside the ingest and block_sad kernels, on one card.

    python3 tools/torch_vision_probe.py

``ncu`` and ``nsys`` do not run where the card is, so this builds an
instrumented copy of ``src/repro_torch/kernels/csrc/vision_ops.cu`` (under
the git-ignored ``src/repro_torch/kernels/_build/probe_vision/``).  Thread
(0, 0) of every block records ``%globaltimer`` when the block starts and
when it leaves, and in the gate-score blocks (the ingest's gate blocks and
``block_sad``'s blocks: the same device code) the SM cycles of the map
(pixels loaded, the |pixel - ref| map in shared memory), of thread 0's
warp's tiles and of the block's max.  At the main path's shape (32
streams of 256 px fp32 -> model 192, gate 32) at 1, 2 and 4 model rows a
thread, and at the frugal tier (model 16), it prints from one cold-L2 call each the ingest's span (first
block start to last block end), when the model blocks start (quantiles
after the first: waves show as steps) and how long one runs, when the gate
blocks start and end, and their phases in SM cycles (median and max).
Then ``block_sad`` on (32, 32, 32, 3) and (32, 20, 20, 3) fp32 frames,
block 8: its span, when its blocks start and end, and the phases' cycles,
from a cold-L2 call and from a warm one (inputs and
code in L2), beside the cold-L2 time of the call (CUDA events, median of
20) and that of a 32-float fill under the same method: what the span
leaves of that time is the launch and the timing method, not the
blocks.

The phase anchors are lines of the source: when the source changes, the
probe fails naming the anchor it no longer finds.  Needs a card.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from torch_decode_probe import EXPORTS, build_instrumented  # noqa: E402

N_STAMPS = 5                     # start, end (globaltimer); gate phases
MAX_BLOCKS = 8192

PRELUDE = '''
__device__ unsigned long long g_probe[%d][%d];
__device__ __forceinline__ unsigned long long probe_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_BLOCK (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * \\
                                               blockIdx.z))
#define PROBE_MINE (threadIdx.x == 0 && threadIdx.y == 0 && \\
                    PROBE_BLOCK < %d)
#define GTIME(k) do { if (PROBE_MINE) \\
  g_probe[k][PROBE_BLOCK] = probe_gtime(); } while (0)
#define CYCLES(k) do { const unsigned long long t_ = clock64(); \\
  if (PROBE_MINE) g_probe[k][PROBE_BLOCK] = t_ - probe_t; probe_t = t_; \\
  } while (0)
struct ProbeEnd {
  __device__ ~ProbeEnd() { GTIME(1); }
};
''' % (N_STAMPS, MAX_BLOCKS, MAX_BLOCKS)

_START = ("  extern __shared__ float dmap[];\n  GTIME(0);\n"
          "  ProbeEnd probe_end;\n")
# (anchor, replacement): each anchor must occur once in vision_ops.cu
PATCHES = (
    ("  extern __shared__ float dmap[];                   // g * g, gate "
     "blocks\n", _START),
    ("  extern __shared__ float dmap[];                   // h * w, one "
     "stream\n", _START),
    ("  build_map(src, ref, dmap, h * w, C, tid, nthreads);\n",
     "  unsigned long long probe_t = clock64();\n"
     "  build_map(src, ref, dmap, h * w, C, tid, nthreads);\n"),
    ("  __syncthreads();\n  float best = tile_max(",
     "  __syncthreads();\n  CYCLES(2);\n  float best = tile_max("),
    ("  best = block_max_all(best, tid, nthreads);\n",
     "  CYCLES(3);\n  best = block_max_all(best, tid, nthreads);\n"),
    ("  if (tid == 0) *score = best;\n}\n",
     "  if (tid == 0) *score = best;\n  CYCLES(4);\n}\n"),
)


def instrument(src: str) -> str:
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_vision_probe: anchor not found once in "
                             f"vision_ops.cu: {anchor!r}")
        src = src.replace(anchor, text)
    src = src.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    return src.replace('extern "C" {\n', EXPORTS, 1)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_vision_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import vision_ops as vo

    lib = build_instrumented(build, "vision_ops", instrument, "probe_vision")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, H, g = cs.SLOTS, cs.FRAME_RES, cs.GATE_RES
    frames = torch.rand(S, H, H, 3, generator=gen, device=dev)
    refs = torch.rand(S, g, g, 3, generator=gen, device=dev)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    q = (0.25, 0.5, 0.75, 1.0)
    rows_default = vo.ROWS_PER_THREAD
    for m, rows in ((cs.INPUT_RES, 1), (cs.INPUT_RES, 2), (cs.INPUT_RES, 4),
                    (16, 1)):
        kw = dict(model_res=m, gate_res=g, block=cs.BLOCK)
        vo.ROWS_PER_THREAD = rows
        got = vo.ingest_frame(frames, refs, **kw)
        want = vo.ingest_frame_plain(frames, refs, **kw)
        cs.max_err(got[:2], want[:2], exact=True)
        cs.max_err(got[2], want[2])
        plan = vo.ingest_plan(S, H, H, 3, m, g, cs.BLOCK)
        if plan["blocks"] > MAX_BLOCKS:
            raise SystemExit(f"torch_vision_probe: {plan['blocks']} blocks, "
                             f"over {MAX_BLOCKS} stamps")
        stamps = np.zeros((N_STAMPS, MAX_BLOCKS), dtype=np.uint64)
        flush.zero_()
        torch.cuda.synchronize()
        lib.probe_zero(stamps.ctypes.data)
        vo.ingest_frame(frames, refs, **kw)
        torch.cuda.synchronize()
        lib.probe_read(stamps.ctypes.data)
        st = stamps[:, :plan["blocks"]].astype(np.int64)
        t0 = st[0].min()
        start, end = (st[0] - t0) / 1e3, (st[1] - t0) / 1e3
        # blocks in launch order: x (the stream) fastest, then y (0: gate)
        X, Y, _ = plan["grid"]
        idx = np.arange(plan["blocks"])
        model = (idx // X) % Y != 0
        gate = ~model & (idx < X * Y)
        dur = end[model] - start[model]
        print(f"ingest {S} x {H} px -> {m}/{g}, {rows} model rows a thread: "
              f"grid {plan['grid']} of {plan['block']}; span "
              f"{end.max():.1f} us; model blocks start after the first "
              f"(quantiles {'/'.join(map(str, q))}): "
              + "/".join(f"{v:.1f}" for v in np.quantile(start[model], q))
              + f" us, each runs median {np.median(dur):.2f} max "
              f"{dur.max():.2f} us; gate blocks start by "
              f"{start[gate].max():.1f} us, end by {end[gate].max():.1f} us; "
              f"gate pixels median {np.median(st[2][gate]):.0f} max "
              f"{st[2][gate].max():.0f} cycles, tiles median "
              f"{np.median(st[3][gate]):.0f} max {st[3][gate].max():.0f} "
              f"cycles, block max median {np.median(st[4][gate]):.0f} "
              f"cycles", flush=True)
    vo.ROWS_PER_THREAD = rows_default
    one = torch.empty(S, device=dev)
    floor_ms = cs.time_ms(lambda: one.fill_(1.0))
    for hw in (g, 20):
        a = torch.rand(S, hw, hw, 3, generator=gen, device=dev)
        b = torch.rand(S, hw, hw, 3, generator=gen, device=dev)
        cs.max_err(vo.block_sad(a, b, cs.BLOCK),
                   vo.block_sad_plain(a, b, cs.BLOCK))
        plan = vo.sad_plan(S, hw, hw, 3, cs.BLOCK)
        ms = cs.time_ms(lambda: vo.block_sad(a, b, cs.BLOCK))
        cells = []
        for label, cold in (("cold", True), ("warm", False)):
            stamps = np.zeros((N_STAMPS, MAX_BLOCKS), dtype=np.uint64)
            vo.block_sad(a, b, cs.BLOCK)
            if cold:
                flush.zero_()
            torch.cuda.synchronize()
            lib.probe_zero(stamps.ctypes.data)
            vo.block_sad(a, b, cs.BLOCK)
            torch.cuda.synchronize()
            lib.probe_read(stamps.ctypes.data)
            st = stamps[:, :plan["blocks"]].astype(np.int64)
            start = (st[0] - st[0].min()) / 1e3
            end = (st[1] - st[0].min()) / 1e3
            cells.append(
                f"{label}: span {end.max():.2f} us, blocks start by "
                f"{start.max():.2f} us, each runs median "
                f"{np.median(end - start):.2f} us, map median "
                f"{np.median(st[2]):.0f} max {st[2].max():.0f} cycles, "
                f"tiles median {np.median(st[3]):.0f} max "
                f"{st[3].max():.0f} cycles, block max median "
                f"{np.median(st[4]):.0f} cycles")
        print(f"block_sad {S} x {hw} px, block {cs.BLOCK}: {plan['blocks']} "
              f"blocks of {plan['threads']} threads, {plan['tiles']} tiles "
              f"a stream; a cold-L2 call {ms * 1e3:.2f} us (instrumented "
              f"build; a 32-float fill under the same method "
              f"{floor_ms * 1e3:.2f} us); " + "; ".join(cells), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
