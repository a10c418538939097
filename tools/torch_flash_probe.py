#!/usr/bin/env python3
"""Where the time goes inside the flash attention kernels, on one card.

    python3 tools/torch_flash_probe.py

``ncu`` and ``nsys`` do not run where the card is, so this builds an
instrumented copy of ``src/repro_torch/kernels/csrc/attention.cu`` (under
the git-ignored ``src/repro_torch/kernels/_build/probe_flash/``): thread 0
of every block records ``clock64`` at the kernel's phase boundaries and
``%globaltimer`` at its start, at its ticket and at its end into a device
array.  At the three timed shapes of ``chip_smoke.py`` phase 6 (bf16, one
128-token chunk against a row of ~1000 keys: starcoder2-3b's heads
contiguous and paged, recurrentgemma-9b's D 256 contiguous with window
2048), at the default rows per block and keys per split, it prints from
one cold-L2 call each:

* the kernel's span (first block start to last block end, globaltimer)
  beside its cold-L2 time (``chip_smoke.py`` times the build without
  stamps), the blocks with a valid key and the merging blocks, and when
  the blocks start (the spread says how many waves the grid takes);
* per block, the SM cycles of each phase (median and max): positions and
  row positions; the tile list; the wait for q and the first K/V tile;
  the tiles (compute, with the later tiles' loads in flight); the partial
  and the ticket; for the merging block, staging m and l with the live
  list, the weights, and the live partials' acc with the output;
* the timeline in ns from the first block's start: the median and the
  last live block's ticket, and the last merge's end.

The phase anchors are lines of the source: when the source changes, the
probe fails naming the anchor it no longer finds.  Needs a card.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from torch_decode_probe import (EXPORTS, build_instrumented,  # noqa: E402
                                prelude)

N_STAMPS = 12
MAX_BLOCKS = 4096

PRELUDE = prelude(N_STAMPS, MAX_BLOCKS, (0, 7, 11))

# (anchor, text inserted after it)
AFTER = (
    ("  const int ntiles = split_keys / kTileK;\n",
     "  STAMP(0); STAMP(1);\n"),
    ("  __syncthreads();\n  // keys in the hull of the rows' valid ranges;",
     None),
    ("  const int nt = n_tiles;\n", "  STAMP(3);\n"),
    ("      __syncthreads();\n      if constexpr (kRing >= 2) {\n",
     None),
    ("    cp_async_wait<0>();\n  }\n", "  STAMP(5);\n"),
    ("  if (nsplit == 1) {                           // no partial, no "
     "merge\n", "    STAMP(6); STAMP(11);\n"),
    ("  if (!is_last) return;\n", None),
    ("  const int nlive = n_live;\n", "  STAMP(8);\n"),
    ("    rinv[r] = 1.f / fmaxf(L, 1e-30f);\n  }\n  __syncthreads();\n",
     "  STAMP(9);\n"),
    ("  if (tid == 0) cnt[slot] = 0;                 // ready for the next "
     "call\n", "  STAMP(10); STAMP(7);\n"),
)


def instrument(src: str) -> str:
    def need(anchor):
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_flash_probe: anchor not found once in "
                             f"attention.cu: {anchor!r}")
    s = src.replace("namespace {\n", PRELUDE + "namespace {\n", 1)
    for anchor, stamp in AFTER:
        need(anchor)
        if stamp is not None:
            s = s.replace(anchor, anchor + stamp)
    s = s.replace("  __syncthreads();\n  // keys in the hull of the rows' "
                  "valid ranges;",
                  "  __syncthreads();\n  STAMP(2);\n  // keys in the hull of "
                  "the rows' valid ranges;")
    loop = "      __syncthreads();\n      if constexpr (kRing >= 2) {\n"
    s = s.replace(loop, loop.replace("();\n", "();\n      if (it == 0) "
                                                "STAMP(4);\n", 1))
    s = s.replace("  if (!is_last) return;\n",
                  "  STAMP(6); STAMP(11);\n  if (!is_last) { STAMP(7); "
                  "return; }\n")
    ret = "    return;\n  }\n\n  // the partial:"
    need(ret)
    s = s.replace(ret, "    STAMP(7);\n" + ret)
    need('extern "C" {\n')
    return s.replace('extern "C" {\n', EXPORTS, 1)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import attention_common as ac
    from repro_torch.kernels import build

    lib = build_instrumented(build, "attention", instrument, "probe_flash")
    card = cs.card_line()

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    lens = torch.randint(cs.TOK_PROMPT[0], cs.TOK_PROMPT[1] + 1,
                         (cs.TOK_SLOTS,), generator=gen).tolist()
    M = -(-(4096 - 1) // cs.TOK_BLOCK) + 1
    host = np.zeros((N_STAMPS, MAX_BLOCKS), np.uint64)
    zero = np.zeros_like(host)
    # chip_smoke.py phase 6's timed shapes: one 128-token chunk of the
    # longest of its rows
    shapes = (("starcoder2-3b heads", 24, 2, 128, 0, M, cs.TOK_SLOTS * M,
               ("flash", "paged_flash")),
              ("D 256", 16, 1, 256, 2048, 129, None, ("flash",)))

    def q(x):
        return (f"med {np.median(x):.0f} max {x.max():.0f}" if len(x)
                else "-")

    for label, Hq, Hkv, D, window, MM, nb, names in shapes:
        c = cs.attn_case(torch, gen, dev, [max(lens)], cs.TOK_CHUNK, Hq, Hkv,
                         D, cs.TOK_BLOCK, MM, torch.bfloat16, nb=nb,
                         C=cs.TOK_CAPACITY)
        for name in names:
            kern, plain = cs.attn_calls(c, window)[name]
            cs.max_err(kern(), plain(), tol=cs.LOOSE)
            cap = (MM * cs.TOK_BLOCK if name == "paged_flash"
                   else cs.TOK_CAPACITY)
            ms = cs.time_ms(kern)
            lib.probe_zero(zero.ctypes.data)
            cs._FLUSH[0].zero_()
            kern()
            torch.cuda.synchronize()
            if lib.probe_read(host.ctypes.data) != 0:
                raise SystemExit("torch_flash_probe: reading the stamps "
                                 "failed")
            rows = ac.flash_rows(torch.bfloat16)
            tiles, keys, splits = ac.flash_split(
                1, cs.TOK_CHUNK, Hq // Hkv, Hkv, cap, rows=rows,
                sms=torch.cuda.get_device_properties(0).multi_processor_count)
            n = splits * Hkv * tiles
            if n > MAX_BLOCKS:
                raise SystemExit(f"torch_flash_probe: {n} blocks > "
                                 f"{MAX_BLOCKS}")
            t = host[:, :n].astype(np.int64)
            live, last = t[4] != 0, t[8] != 0
            g0 = t[0].min()
            print(f"{name} at {label}: {rows} rows x {keys} keys per split, "
                  f"{ms * 1e3:.1f} us cold-L2; instrumented span "
                  f"{(t[7].max() - g0) / 1e3:.2f} us; {n} blocks, "
                  f"{live.sum()} with a valid key, {last.sum()} merging; "
                  f"block starts: median {np.median(t[0] - g0) / 1e3:.2f} "
                  f"us, last {(t[0].max() - g0) / 1e3:.2f} us (live: last "
                  f"{(t[0][live].max() - g0) / 1e3:.2f} us)", flush=True)
            print(f"  SM cycles: positions {q(t[2] - t[1])}; tile list "
                  f"{q(t[3] - t[2])}; live blocks: q + first tile "
                  f"{q((t[4] - t[3])[live])}, tiles {q((t[5] - t[4])[live])},"
                  f" partial + ticket {q((t[6] - t[5])[live])}; empty "
                  f"blocks: partial + ticket {q((t[6] - t[3])[~live])}",
                  flush=True)
            print(f"  merging block: stage m,l + live list "
                  f"{q((t[8] - t[6])[last])}, weights "
                  f"{q((t[9] - t[8])[last])}, acc + output "
                  f"{q((t[10] - t[9])[last])}", flush=True)
            print(f"  timeline (ns from the first start): live tickets median "
                  f"{np.median(t[11][live] - g0):.0f}, last "
                  f"{(t[11][live] - g0).max():.0f}; merges end median "
                  f"{np.median(t[7][last] - g0):.0f}, last "
                  f"{(t[7][last] - g0).max():.0f}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
