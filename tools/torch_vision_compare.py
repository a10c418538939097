#!/usr/bin/env python3
"""Time the four vision kernels of two checkouts on one card, taking turns.

    python3 tools/torch_vision_compare.py --base DIR [--base DIR2 ...]
                                          [--rounds 2] [--sweep]

Each ``DIR`` is another checkout of the repo (for example the parent
commit, unpacked with ``git archive``); this checkout is the change.  As
in ``tools/torch_recurrent_compare.py`` (whose driver this reuses), each
side runs in its own child process with its own ``src/`` first on the path
and builds its own ``csrc/vision_ops.cu``; the sides take turns, the
bases, the change, the change, the bases in reverse (``--rounds`` times),
each timing at ``chip_smoke.py`` phase 2's shapes, cold L2, the median of
20 calls:

* ``ingest_frame`` at the main path (32 streams of 256 px fp32 frames ->
  model 192, gate 32, block 8) and at the frugal tier (model 16);
* ``scatter_admit`` at the main path (a (32, 192, 192, 3) fp32 pool, refs
  (32, 32, 32, 3)) and at the frugal tier (a (32, 16, 16, 3) bf16 pool);
* ``downscale`` of the same frames to 192 (the gateless engine) and to 32
  (``MotionGate.admit``), nearest;
* ``block_sad`` of (32, 32, 32, 3) fp32 frames, block 8.

Each turn first prints the ptxas registers and spills of the side's
vision kernels (from its build's ``-Xptxas -v`` report).

With ``--sweep``, each turn also times ``ingest_frame`` at the main path at
1, 2 and 4 model rows a thread where the side's wrapper offers that
setting.  Every call is first held against the plain version (nearest
frames and the scatter bit-exact, scores within TIGHT).  Prints one line
per turn, a summary and the card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import sys

from torch_recurrent_compare import ROOT, _use, compare, settings, timed


def _turn(tree: str, sweep: bool) -> dict:
    """Time ``tree``'s kernels 1-2 at the timed shapes; {case: ms}."""
    _use(tree)
    sys.path.insert(1, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import vision_ops as vo
    log = build.build("vision_ops").with_suffix(".log")
    regs = cs.ptxas_entries(
        log.read_text() if log.exists() else "",
        r"Compiling entry function '\S*?(ingest_kernel|scatter_rows_kernel"
        r"|downscale_kernel|score_kernel|resample_kernel|sad_kernel)"
        r"(?:I(h|f|13__nv_bfloat16)E)?",
        lambda m: f"{m.group(1)} {m.group(2) or ''}".strip())
    print(f"{tree}: ptxas (registers, B spilled) " + "  ".join(
        f"{k} {v}" for k, v in sorted(regs.items())), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S, H, m, g = cs.SLOTS, cs.FRAME_RES, cs.INPUT_RES, cs.GATE_RES

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    frames, refs = rand(S, H, H, 3), rand(S, g, g, 3)
    admit = rand(S) < 0.5
    out = {}

    def ingest_check(want):
        def check(got):
            cs.max_err(got[:2], want[:2], exact=True)
            cs.max_err(got[2], want[2])
        return check

    for res, label in ((m, "main"), (16, "frugal")):
        kw = dict(model_res=res, gate_res=g, block=cs.BLOCK)
        want = vo.ingest_frame_plain(frames, refs, **kw)
        for tag, value in settings(vo, "ROWS_PER_THREAD", cs.ROWS_SWEEP,
                                   sweep and label == "main"):
            out[f"ingest_frame {label}{tag}"] = timed(
                vo, "ROWS_PER_THREAD", value,
                lambda: vo.ingest_frame(frames, refs, **kw),
                ingest_check(want))
    gate = rand(S, g, g, 3)
    for res, pool, label in ((m, torch.float32, "main"),
                             (16, torch.bfloat16, "frugal")):
        batch, model = rand(S, res, res, 3).to(pool), rand(S, res, res, 3)
        want = vo.scatter_admit_plain(batch, model, refs, gate, admit)
        out[f"scatter_admit {label}"] = timed(
            vo, "", None,
            lambda: vo.scatter_admit(batch, model, refs, gate, admit),
            lambda got: cs.max_err(got, want, exact=True))
    for res in (m, g):
        want = vo.downscale_plain(frames, res)
        out[f"downscale {res}"] = timed(
            vo, "", None, lambda: vo.downscale(frames, res),
            lambda got: cs.max_err(got, want, exact=True))
    a, b = rand(S, g, g, 3), rand(S, g, g, 3)
    want = vo.block_sad_plain(a, b, cs.BLOCK)
    out["block_sad"] = timed(vo, "", None,
                             lambda: vo.block_sad(a, b, cs.BLOCK),
                             lambda got: cs.max_err(got, want))
    return out


def main(argv=None) -> int:
    return compare(argv, "vision_ops", _turn,
                   "also time ingest_frame at 1, 2 and 4 model rows a thread")


if __name__ == "__main__":
    sys.exit(main())
