#!/usr/bin/env python3
"""The flash attention kernels with one design choice changed, on one card.

    python3 tools/torch_flash_ablate.py

Builds copies of ``src/repro_torch/kernels/csrc/attention.cu`` with one
text patch each (under the git-ignored
``src/repro_torch/kernels/_build/ablate/<variant>/``), one ``nvcc`` per
copy, all started together, and times each copy's kernels at the three
timed shapes of ``chip_smoke.py`` phase 6 (bf16, one 128-token chunk
against a row of ~1000 keys: starcoder2-3b's heads contiguous and paged,
recurrentgemma-9b's D 256 contiguous with window 2048), cold L2, the
median of 20 calls, at the default rows per block and keys per split.
Every variant is first held against the plain version within LOOSE.

The variants are the alternatives the kernel's design chose against:

* ``base``: the source as it is;
* ``p_once``: P rounded once to bf16 for P V (one mma per 8 output dims),
  not P = P_hi + P_lo (two);
* ``ring1``, ``ring3``, ``ring4``: a K/V ring of 1, at most 3 or at most
  4 stages where the shared memory takes them (the source takes 2).

A patch's anchor is a line of the source: when the source changes, the
tool fails naming the anchor it no longer finds.  Needs a card.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RING = ("             ? 2\n             : 1;\n")


def _ring(n: int) -> str:
    fits = ("q_bytes<T, kD, kBR>() + {} * stage_bytes<T, kD>() + "
            "pscratch_bytes<T, kBR>() + kKeyBudget <= kSmemMax")
    out = "1"
    for k in range(2, n + 1):
        out = f"{fits.format(k)} ? {k} : {out}"
    return f"             ? ({out})\n             : 1;\n"


#: {variant: {anchor: replacement}}
VARIANTS = {
    "base": {},
    "p_once": {
        "      mma_bf16(st.acc[2 * j], pl, bv[0], bv[1]);\n"
        "      mma_bf16(st.acc[2 * j + 1], pl, bv[2], bv[3]);\n": ""},
    "ring1": {_RING: "             ? 1\n             : 1;\n"},
    "ring3": {_RING: _ring(3)},
    "ring4": {_RING: _ring(4)},
}


def patched(src: str, patch: dict) -> str:
    for anchor, text in patch.items():
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_flash_ablate: anchor not found once in "
                             f"attention.cu: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def _build(variant_dir: str) -> float:
    """Build the copy in ``variant_dir`` (a child process: ``build`` keys
    on module globals)."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    build.CSRC = Path(variant_dir)
    build.BUILD_DIR = Path(variant_dir) / "_build"
    t0 = time.perf_counter()
    build.build("attention")
    return time.perf_counter() - t0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_ablate: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build

    src = (build.CSRC / "attention.cu").read_text()
    root = build.BUILD_DIR / "ablate"
    dirs = {}
    for name, patch in VARIANTS.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "attention.cu").write_text(patched(src, patch))
        for header in build.CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        dirs[name] = d
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(dirs),
                                                mp_context=ctx) as pool:
        secs = dict(zip(dirs, pool.map(_build, map(str, dirs.values()))))
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s "
          f"(each {min(secs.values()):.1f}-{max(secs.values()):.1f} s)",
          flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    lens = torch.randint(cs.TOK_PROMPT[0], cs.TOK_PROMPT[1] + 1,
                         (cs.TOK_SLOTS,), generator=gen).tolist()
    M = -(-(4096 - 1) // cs.TOK_BLOCK) + 1
    # chip_smoke.py phase 6's timed shapes: one 128-token chunk of the
    # longest of its rows
    cases = []
    for label, Hq, Hkv, D, window, MM, nb, names in (
            ("starcoder2-3b heads", 24, 2, 128, 0, M, cs.TOK_SLOTS * M,
             ("flash", "paged_flash")),
            ("D 256", 16, 1, 256, 2048, 129, None, ("flash",))):
        c = cs.attn_case(torch, gen, dev, [max(lens)], cs.TOK_CHUNK, Hq, Hkv,
                         D, cs.TOK_BLOCK, MM, torch.bfloat16, nb=nb,
                         C=cs.TOK_CAPACITY)
        for name in names:
            cases.append((f"{name} at {label}", c, window, name))

    for variant, d in dirs.items():
        build.CSRC, build.BUILD_DIR = d, d / "_build"
        build.load.cache_clear()
        build.bind.cache_clear()
        cells = []
        for label, c, window, name in cases:
            kern, plain = cs.attn_calls(c, window)[name]
            err = cs.max_err(kern(), plain(), tol=cs.LOOSE)
            cells.append(f"{label} {cs.time_ms(kern):.4f} ms "
                         f"(err {err:.3g})")
        print(f"{variant}: " + "  ".join(cells), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
