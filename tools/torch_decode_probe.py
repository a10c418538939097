#!/usr/bin/env python3
"""Where the time goes inside the decode attention kernels, on one card.

    python3 tools/torch_decode_probe.py

``ncu`` and ``nsys`` do not run where the card is, so this builds an
instrumented copy of ``src/repro_torch/kernels/csrc/decode_attention.cu``
(under the git-ignored ``src/repro_torch/kernels/_build/probe/``): thread 0
of every block records ``clock64`` at the kernel's phase boundaries and
``%globaltimer`` at its start and end into a device array.  At the main
path's shapes (bf16; starcoder2-3b's heads, paged and contiguous, and
recurrentgemma-9b's D 256, contiguous) and at 64, 128 and 256 keys per
split it prints, from one cold-L2 call each:

* the kernel's span (first block start to last block end, globaltimer)
  beside its cold-L2 time (``chip_smoke.py`` phase 6 times the build
  without stamps);
* per block, the SM cycles of each phase (median and max): positions;
  for blocks with a valid key, the wait for q and K/V, the chunks'
  compute (with the last chunk's S = QK^T, softmax and PV), the warp
  merge, partial and ticket; for empty blocks, the ticket; for the
  merging block, staging m and l, the weights, reading the live
  partials' acc, writing the output.

The phase anchors are lines of the source: when the source changes, the
probe fails naming the anchor it no longer finds.  Needs a card.
"""
from __future__ import annotations

import ctypes
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (64, 128, 256)
N_STAMPS = 15
MAX_BLOCKS = 2048

def prelude(n_stamps: int, max_blocks: int, gtime: tuple) -> str:
    """The device array of stamps and ``STAMP(k)``: thread 0 of each block
    records ``%globaltimer`` for the stamps in ``gtime`` (comparable across
    SMs) and ``clock64`` (SM cycles) for the others."""
    cond = " || ".join(f"k == {k}" for k in gtime)
    return '''
__device__ unsigned long long g_probe[%d][%d];
__device__ __forceinline__ unsigned long long probe_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0) { \\
  const int b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * \\
                                            blockIdx.z); \\
  if (b_ < %d) g_probe[k][b_] = (%s) ? probe_gtime() : clock64(); } \\
  } while (0)
''' % (n_stamps, max_blocks, max_blocks, cond)


PRELUDE = prelude(N_STAMPS, MAX_BLOCKS, (0, 7))

EXPORTS = '''extern "C" {
int probe_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
}
int probe_zero(void* host) {
  return (int)cudaMemcpyToSymbol(g_probe, host, sizeof(g_probe));
}
'''

# (anchor line(s) of the source, stamp inserted after it)
AFTER = (
    ("  const int slot = (b * Hkv + hk) * row_tiles + rt;\n", 1),
    ("  live = __syncthreads_or(live);\n", 2),
    ("        __syncthreads();                       // q, loaded by all "
     "warps\n", 3),
    ("    cp_async_wait<0>();\n    __syncwarp();\n", 4),
    ("    for (int i = 0; i < 4; ++i) s[n][i] += t[n][i];\n", 8),
    ("  softmax_step(st, s, vmask, lane, scale2);\n"
     "  unsigned ph[4], pl[4];\n", 9),
    ("  if (mine) live_split[before] = tid;\n  __syncthreads();\n", 12),
    ("    if (row && sub == 0) rinv[r] = 1.f / fmaxf(L, 1e-30f);\n  }\n"
     "  __syncthreads();\n", 13),
    ("  T* ob = out + (static_cast<long long>(b) * Hq + hk * G + row0) * "
     "kD;\n", 14),
)


def instrument(src: str) -> str:
    def need(anchor):
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_decode_probe: anchor not found once in "
                             f"decode_attention.cu: {anchor!r}")
    s = src.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    for anchor, k in AFTER:
        need(anchor)
        stamp = ("      if (c == 0) STAMP(3);\n" if k == 3
                 else f"  STAMP({k});\n")
        s = s.replace(anchor, anchor + stamp)
    s = s.replace("  const int slot = (b * Hkv + hk) * row_tiles + rt;\n"
                  "  STAMP(1);\n",
                  "  const int slot = (b * Hkv + hk) * row_tiles + rt;\n"
                  "  STAMP(0); STAMP(1);\n")
    pv_end = ("    mma_bf16(st.acc[2 * j + 1], pl, bv[2], bv[3]);\n  }\n}\n")
    ret = "  if (!is_last) return;\n"
    done = ("  if (tid == 0) cnt[slot] = 0;                 "
            "// ready for the next call\n")
    for anchor in (pv_end, ret, done, 'extern "C" {\n'):
        need(anchor)
    s = s.replace(pv_end, pv_end[:-2] + "  STAMP(10);\n}\n")
    s = s.replace(ret, "  STAMP(5);\n  if (!is_last) { STAMP(7); return; }\n"
                       "  STAMP(11);\n")
    s = s.replace(done, done + "  STAMP(6); STAMP(7);\n")
    return s.replace('extern "C" {\n', EXPORTS, 1)


def build_instrumented(build, name: str, instrument, subdir: str):
    """Build ``instrument(csrc/<name>.cu text)`` (with the ``csrc``
    headers) under ``_build/<subdir>/`` and load it; points ``build`` at
    that copy for the rest of the process.  Returns the library, its stamp
    readers declared."""
    probe_dir = build.BUILD_DIR / subdir
    probe_dir.mkdir(parents=True, exist_ok=True)
    (probe_dir / f"{name}.cu").write_text(
        instrument((build.CSRC / f"{name}.cu").read_text()))
    for header in build.CSRC.glob("*.cuh"):
        (probe_dir / header.name).write_text(header.read_text())
    build.CSRC, build.BUILD_DIR = probe_dir, probe_dir / "_build"
    build.load.cache_clear()
    build.bind.cache_clear()
    t0 = time.perf_counter()
    lib = build.load(name)
    print(f"instrumented build {time.perf_counter() - t0:.1f} s", flush=True)
    lib.probe_read.argtypes = lib.probe_zero.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import attention_common as ac
    from repro_torch.kernels import build

    lib = build_instrumented(build, "decode_attention", instrument, "probe")
    card = cs.card_line()

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    lens = torch.randint(cs.TOK_PROMPT[0], cs.TOK_PROMPT[1] + 1,
                         (cs.TOK_SLOTS,), generator=gen).tolist()
    M = -(-(4096 - 1) // cs.TOK_BLOCK) + 1
    host = np.zeros((N_STAMPS, MAX_BLOCKS), np.uint64)
    zero = np.zeros_like(host)
    shapes = (("starcoder2-3b heads", 24, 2, 128, 0, M, ("paged_decode",
                                                         "decode")),
              ("D 256", 16, 1, 256, 2048, 129, ("decode",)))

    def q(x):
        return (f"med {np.median(x):.0f} max {x.max():.0f}" if len(x)
                else "-")

    for label, Hq, Hkv, D, window, MM, names in shapes:
        c = cs.attn_case(torch, gen, dev, lens, 1, Hq, Hkv, D, cs.TOK_BLOCK,
                         MM, torch.bfloat16, nb=cs.TOK_SLOTS * MM,
                         C=cs.TOK_CAPACITY)
        for name in names:
            kern, plain = cs.attn_calls(c, window)[name]
            cs.max_err(kern(), plain(), tol=cs.LOOSE)
            cap = MM * cs.TOK_BLOCK if name == "paged_decode" \
                else cs.TOK_CAPACITY
            default = ac.SPLIT_KEYS
            for keys in SPLITS:
                ac.SPLIT_KEYS = keys
                ms = cs.time_ms(kern)
                lib.probe_zero(zero.ctypes.data)
                cs._FLUSH[0].zero_()
                kern()
                torch.cuda.synchronize()
                if lib.probe_read(host.ctypes.data) != 0:
                    raise SystemExit("torch_decode_probe: reading the "
                                     "stamps failed")
                _, splits = ac.decode_split(cap)
                n = splits * Hkv * cs.TOK_SLOTS
                t = host[:, :n].astype(np.int64)
                live, last = t[4] != 0, t[6] != 0
                g0 = t[0].min()
                print(f"{name} at {label}, {keys} keys per split: "
                      f"{ms * 1e3:.1f} us cold-L2; "
                      f"instrumented span {(t[7].max() - g0) / 1e3:.2f} us; "
                      f"{n} blocks, {live.sum()} with a valid key, "
                      f"{last.sum()} merging; block starts within "
                      f"{(t[0].max() - g0) / 1e3:.2f} us", flush=True)
                print(f"  SM cycles: positions {q(t[2] - t[1])}; "
                      f"live blocks: q+K/V wait {q((t[3] - t[2])[live])}, "
                      f"chunks {q((t[4] - t[3])[live])} (last chunk: S "
                      f"{q((t[8] - t[3])[live])} from the first, softmax "
                      f"{q((t[9] - t[8])[live])}, PV "
                      f"{q((t[10] - t[9])[live])}), warp merge + partial + "
                      f"ticket {q((t[5] - t[4])[live])}; empty blocks: "
                      f"ticket {q((t[5] - t[2])[~live])}", flush=True)
                print(f"  merging block: stage m,l and list "
                      f"{q((t[12] - t[11])[last])}, "
                      f"weights {q((t[13] - t[12])[last])}, live acc "
                      f"{q((t[14] - t[13])[last])}, output "
                      f"{q((t[6] - t[14])[last])}; in all "
                      f"{q((t[6] - t[5])[last])}", flush=True)
            ac.SPLIT_KEYS = default
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
