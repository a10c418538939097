#!/usr/bin/env python3
"""The ingest kernel with one part changed or removed, on one card.

    python3 tools/torch_vision_ablate.py

Builds copies of ``src/repro_torch/kernels/csrc/vision_ops.cu`` with one
text patch each (under the git-ignored
``src/repro_torch/kernels/_build/ablate_vision/<variant>/``), one ``nvcc``
per copy, all started together, and times each copy's ``ingest_frame`` at
``chip_smoke.py`` phase 2's timed shape (32 streams of 256 px fp32 frames
-> model 192, gate 32, block 8) and at the frugal tier (model 16), cold
L2, the median of 20 calls.  Variants that compute what the kernel
computes are first held against the plain version (nearest frames
bit-exact, the score within TIGHT); the others remove work to show what
it costs, and are timed only:

* ``base``: the source as it is;
* ``plain_loads``: source elements read with plain loads, not through the
  read-only cache (``__ldg``);
* ``gate_batch2``: a gate thread loads 2 pixels at once, not 4;
* ``regs_32``: at most 32 registers a thread (``__launch_bounds__(512,
  4)``), for more resident blocks;
* ``l2_256B``: fp32 source elements loaded with a 256-byte L2 prefetch;
* ``stream_stores``: the model rows stored with ``__stcs`` (evict first);
* ``no_gate`` (timed only): the gate blocks return at once;
* ``gate_only`` (timed only): the model blocks return at once;
* ``no_store`` (timed only): the model rows' stores skipped.

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

_STORE = "    *reinterpret_cast<float4*>(out + k * mC + e) = v[k];\n"
_GATE = "  if (blockIdx.z != 0) return;\n"
_MODEL = "  const int u = blockIdx.z * blockDim.x + threadIdx.x;\n"
_LDG = "  return __ldg(p + o);\n"

_BATCH = "constexpr int kGateBatch = 4;"
_BOUNDS = "__global__ void __launch_bounds__(kMaxBlock)\ningest_kernel("
_L2 = """  return __ldg(p + o);\n"""
_L2_256 = ("""  float v;\n"""
           """  asm("ld.global.nc.L2::256B.f32 %0, [%1];" : "=f"(v) """
           """: "l"(p + o));\n  return v;\n""")

#: {variant: ({anchor: replacement}, held against plain)}
VARIANTS = {
    "base": ({}, True),
    "plain_loads": ({_LDG: "  return p[o];\n"}, True),
    "no_gate": ({_GATE: "  if (blockIdx.z != 0 || G.g > 0) return;\n"},
                False),
    "gate_only": ({_MODEL: _MODEL + "  if (G.m > 0) return;\n"}, False),
    "gate_batch2": ({_BATCH: "constexpr int kGateBatch = 2;"}, True),
    "regs_32": ({_BOUNDS: "__global__ void __launch_bounds__(kMaxBlock, 4)\n"
                          "ingest_kernel("}, True),
    "l2_256B": ({_L2: _L2_256}, True),
    "stream_stores": ({_STORE: "    __stcs(reinterpret_cast<float4*>(out + "
                               "k * mC + e), v[k]);\n"}, True),
    "no_store": ({_STORE: "    if (v[k].x == -1.f) "
                          "*reinterpret_cast<float4*>(out + k * mC + e) = "
                          "v[k];\n"},
                 False),
}


def patched(src: str, patch: dict) -> str:
    for anchor, text in patch.items():
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_vision_ablate: anchor not found once in "
                             f"vision_ops.cu: {anchor!r}")
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
    build.build("vision_ops")
    return time.perf_counter() - t0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_vision_ablate: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import vision_ops as vo

    src = (build.CSRC / "vision_ops.cu").read_text()
    root = build.BUILD_DIR / "ablate_vision"
    dirs = {}
    for name, (patch, _) in VARIANTS.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "vision_ops.cu").write_text(patched(src, patch))
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
    gen = torch.Generator(device=dev).manual_seed(0)
    S, H, g = cs.SLOTS, cs.FRAME_RES, cs.GATE_RES
    frames = torch.rand(S, H, H, 3, generator=gen, device=dev)
    refs = torch.rand(S, g, g, 3, generator=gen, device=dev)
    cases = [(label, dict(model_res=m, gate_res=g, block=cs.BLOCK))
             for label, m in (("main", cs.INPUT_RES), ("frugal", 16))]
    wants = {label: vo.ingest_frame_plain(frames, refs, **kw)
             for label, kw in cases}
    for variant, d in dirs.items():
        build.CSRC, build.BUILD_DIR = d, d / "_build"
        build.load.cache_clear()
        build.bind.cache_clear()
        vo._lib.cache_clear()
        cells = []
        for label, kw in cases:
            got = vo.ingest_frame(frames, refs, **kw)
            if VARIANTS[variant][1]:
                cs.max_err(got[:2], wants[label][:2], exact=True)
                cs.max_err(got[2], wants[label][2])
            ms = cs.time_ms(lambda: vo.ingest_frame(frames, refs, **kw))
            cells.append(f"{label} {ms:.4f} ms")
        print(f"{variant}{'' if VARIANTS[variant][1] else ' (timed only)'}"
              f": " + "  ".join(cells), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
