#!/usr/bin/env python3
"""Where the time goes inside the chunkwise mLSTM kernel, on one card.

    python3 tools/torch_recurrent_probe.py

``ncu`` and ``nsys`` do not run where the card is, so this builds an
instrumented copy of ``src/repro_torch/kernels/csrc/recurrent.cu`` (under
the git-ignored ``src/repro_torch/kernels/_build/probe_recurrent/``).
Thread 0 of every block adds the SM cycles of each phase of the mLSTM
kernel, summed over the chunks, into a device array: the loads' issue and
the gates (A), pass 1 over Dk (B: q.k^T, q.C, q.n, its waits for the
tiles included), the gating and denominators, P.V, the output's stores
and pass 2 (D: the state update).  Lane 0 of every warp adds its own
cycles inside pass 1's and pass 2's tile products (no barrier waits), so
the warps' balance shows.  At xlstm-350m's prefill shape (B 4 x H 4, S
512, Dh 512, bf16 with bf16 gates, ``chip_smoke.py`` phase 9's timed
case) it prints from one cold-L2 call the kernel's span (globaltimer,
first block start to last block end) and, per phase and per warp, the
median and the largest over the blocks, in SM cycles.

The phase anchors are lines of the source: when the source changes, the
probe fails naming the anchor it no longer finds.  Needs a card.
"""
from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from torch_decode_probe import EXPORTS, build_instrumented  # noqa: E402

N_STAMPS = 32
MAX_BLOCKS = 1024
PHASES = ("setup", "loads + gates (A)", "pass 1 (B)", "gating",
          "P.V", "out", "pass 2 (D)")
PASS1_WARP, PASS2_WARP, SPAN = 8, 16, 24     # stamp rows

PRELUDE = '''
__device__ unsigned long long g_probe[%d][%d];
__device__ __forceinline__ unsigned long long probe_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_BLOCK (blockIdx.x + gridDim.x * blockIdx.y)
#define ACC(k) do { if (threadIdx.x == 0 && PROBE_BLOCK < %d) { \\
  const unsigned long long t_ = clock64(); \\
  g_probe[k][PROBE_BLOCK] += t_ - probe_t; probe_t = t_; } } while (0)
#define WARP_START() do { if ((threadIdx.x & 31) == 0) probe_w = clock64(); \\
  } while (0)
#define WARP_ACC(k) do { if ((threadIdx.x & 31) == 0 && \\
  PROBE_BLOCK < %d) g_probe[(k) + (threadIdx.x >> 5)][PROBE_BLOCK] += \\
  clock64() - probe_w; } while (0)
#define GTIME(k) do { if (threadIdx.x == 0 && PROBE_BLOCK < %d) \\
  g_probe[k][PROBE_BLOCK] = probe_gtime(); } while (0)
''' % (N_STAMPS, MAX_BLOCKS, MAX_BLOCKS, MAX_BLOCKS, MAX_BLOCKS)

# (anchor, replacement): each anchor must occur once in recurrent.cu
PATCHES = (
    ("  for (int i = tid; i < Dp * kBv + Dp; i += kMThreads) Cf[i] = 0.f;\n",
     "  GTIME(%d);\n  unsigned long long probe_t = clock64(), probe_w = 0;\n"
     "  for (int i = tid; i < Dp * kBv + Dp; i += kMThreads) Cf[i] = 0.f;\n"
     "  ACC(0);\n" % SPAN),
    ("    scale_old = expf((gsum + m_prev) - m_new);\n",
     "    scale_old = expf((gsum + m_prev) - m_new);\n    ACC(1);\n"),
    ("      pass1_tile(sacc, oacc, qn, qs + buf, ks + buf, Cf, ns, d * kDt, "
     "inter,\n                 rt, lane);\n",
     "      WARP_START();\n"
     "      pass1_tile(sacc, oacc, qn, qs + buf, ks + buf, Cf, ns, d * kDt, "
     "inter,\n                 rt, lane);\n"
     "      WARP_ACC(%d);\n" % PASS1_WARP),
    ("    if (!last) {                       // pass D's first k tile, "
     "early\n",
     "    ACC(2);\n    if (!last) {                       // pass D's first "
     "k tile, early\n"),
    ("    panel_v(oacc, sacc, vs, rt, lane);\n",
     "    ACC(3);\n    panel_v(oacc, sacc, vs, rt, lane);\n    ACC(4);\n"),
    ("    if (last) break;\n", "    ACC(5);\n    if (last) break;\n"),
    ("      if constexpr (Tile::kMma)\n        update_tile(",
     "      WARP_START();\n      if constexpr (Tile::kMma)\n"
     "        update_tile("),
    ("                    lane);\n      if constexpr (kStages == 1) {\n",
     "                    lane);\n      WARP_ACC(%d);\n"
     "      if constexpr (kStages == 1) {\n" % PASS2_WARP),
    ("    m_prev = m_new;\n  }\n}\n",
     "    ACC(6);\n    m_prev = m_new;\n  }\n  GTIME(%d);\n}\n" % (SPAN + 1)),
)


def instrument(src: str) -> str:
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_recurrent_probe: anchor not found once "
                             f"in recurrent.cu: {anchor!r}")
        src = src.replace(anchor, text)
    src = src.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    return src.replace('extern "C" {\n', EXPORTS, 1)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_recurrent_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import mlstm as mlstm_k

    lib = build_instrumented(build, "recurrent", instrument,
                             "probe_recurrent")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    xs = [torch.randn(4, 512, 4, 512, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3)]
    xs += [(torch.randn(4, 512, 4, generator=gen, device=dev) + shift).to(
        torch.bfloat16) for shift in (0.0, 2.0)]
    B, S, H, Dh = xs[0].shape
    cs.max_err(mlstm_k.mlstm_chunkwise(*xs),
               mlstm_k.mlstm_chunkwise_plain(*xs), tol=cs.LOOSE)
    nblocks = mlstm_k.mlstm_grid(B, H, Dh)[0] * B * H
    stamps = np.zeros((N_STAMPS, MAX_BLOCKS), dtype=np.uint64)
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    flush.zero_()
    torch.cuda.synchronize()
    lib.probe_zero(stamps.ctypes.data)
    mlstm_k.mlstm_chunkwise(*xs)
    torch.cuda.synchronize()
    lib.probe_read(stamps.ctypes.data)
    st = stamps[:, :nblocks].astype(np.int64)
    span = (st[SPAN + 1].max() - st[SPAN].min()) / 1e3
    starts = (st[SPAN] - st[SPAN].min()) / 1e3
    print(f"mlstm bf16 B {B} S {S} H {H} Dh {Dh}: {nblocks} blocks, span "
          f"{span:.1f} us (first to last block), starts within "
          f"{starts.max():.1f} us", flush=True)
    for k, name in enumerate(PHASES):
        print(f"  phase {name:18s}: median {np.median(st[k]):9.0f}  max "
              f"{st[k].max():9.0f} cycles", flush=True)
    for label, row in (("pass 1 products", PASS1_WARP),
                       ("pass 2 products", PASS2_WARP)):
        med = [np.median(st[row + w]) for w in range(8)]
        print(f"  {label}, warps 0-7 (median over blocks): "
              + " ".join(f"{m:.0f}" for m in med), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
