#!/usr/bin/env python3
"""Time the recurrent kernels of two checkouts on one card, taking turns.

    python3 tools/torch_recurrent_compare.py --base DIR [--base DIR2 ...]
                                             [--rounds 2] [--sweep]

Each ``DIR`` is another checkout of the repo (for example the parent
commit, unpacked with ``git archive``, or a copy with one design choice
changed); this checkout is the change.  Each side runs in its own child
process with its own ``src/`` first on the path, so each uses its own
wrappers and builds its own ``csrc/recurrent.cu`` (into its own
git-ignored ``_build/``).  All are built first, one ``nvcc`` each, started
together; then the sides take turns, the bases, the change, the change,
the bases in reverse (``--rounds`` times), each timing at
``chip_smoke.py`` phase 9's timed shapes, cold L2, the median of 20
calls:

* the RG-LRU scan at (B 1, S 128, W 4096) with h0, the main path's
  prefill chunk, and at S 16, a shorter chunk of the same drain;
* the chunkwise mLSTM at xlstm-350m's prefill (B 4 x H 4, S 512, Dh 512),
  bf16 with bf16 gates, the wrapper called as the model calls it.

With ``--sweep``, each turn also times every channels per block (16, 32,
64) where the side's wrapper offers that setting.  Every call
is first held against the plain version (the RG-LRU bit-exact, the mLSTM
within LOOSE).  Prints one line per turn, a summary and the
card's name and power limit.  Needs a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import multiprocessing
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _use(tree: str) -> None:
    """Put ``tree``'s package first on the path (a fresh child process)."""
    sys.path.insert(0, os.path.join(tree, "src"))


def _build(tree: str, source: str = "recurrent") -> float:
    _use(tree)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build(source)
    return time.perf_counter() - t0


def settings(mod, attr, values, sweep):
    """(label, value) of each setting to time: the default alone, or every
    value with ``sweep`` where the wrapper offers the knob."""
    if not (sweep and hasattr(mod, attr)):
        return [("", None)]
    return [(f" {attr} {v}", v) for v in values]


def timed(mod, attr, value, kern, check):
    """``check(kern())``, then kern's cold-L2 time, with ``mod.attr`` set
    to ``value`` (unless None) for the duration."""
    import chip_smoke as cs
    old = getattr(mod, attr, None)
    if value is not None:
        setattr(mod, attr, value)
    try:
        check(kern())
        return cs.time_ms(kern)
    finally:
        if value is not None:
            setattr(mod, attr, old)


def _turn(tree: str, sweep: bool) -> dict:
    """Time ``tree``'s kernels at the timed shapes; returns {case: ms}."""
    _use(tree)
    sys.path.insert(1, ROOT)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import mlstm as mlstm_k
    from repro_torch.kernels import rglru as rglru_k
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for S in (cs.TOK_CHUNK, 16):
        a = 0.2 + 0.799 * torch.rand(1, S, 4096, generator=gen, device=dev)
        b = torch.randn(1, S, 4096, generator=gen, device=dev)
        h0 = torch.randn(1, 4096, generator=gen, device=dev)
        want = rglru_k.rglru_scan_plain(a, b, h0)
        for label, value in settings(rglru_k, "CHANNELS_PER_BLOCK",
                                     (16, 32, 64), sweep):
            out[f"rglru_scan S {S}{label}"] = timed(
                rglru_k, "CHANNELS_PER_BLOCK", value,
                lambda: rglru_k.rglru_scan(a, b, h0),
                lambda got: cs.max_err(got, want, exact=True))
    xs = [torch.randn(4, 512, 4, 512, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3)]
    xs += [(torch.randn(4, 512, 4, generator=gen, device=dev) + shift).to(
        torch.bfloat16) for shift in (0.0, 2.0)]
    want = mlstm_k.mlstm_chunkwise_plain(*xs)
    out["mlstm_chunkwise bf16"] = timed(
        mlstm_k, "", None, lambda: mlstm_k.mlstm_chunkwise(*xs),
        lambda got: cs.max_err(got, want, tol=cs.LOOSE))
    return out


def compare(argv, source: str, turn, sweep_help: str) -> int:
    """Build ``csrc/<source>.cu`` in each checkout, then time each side
    with ``turn(tree, sweep) -> {case: ms}`` in turns; prints every turn, a
    summary, the card and one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, action="append",
                    help="another checkout of the repo (the parent, or a "
                         "variant); may be given more than once")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sweep", action="store_true", help=sweep_help)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print(f"{os.path.basename(sys.argv[0])}: needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    bases = {os.path.basename(os.path.normpath(d)): os.path.abspath(d)
             for d in args.base}
    trees = {**bases, "change": ROOT}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(trees),
                                                mp_context=ctx) as pool:
        secs = dict(zip(trees, pool.map(functools.partial(
            _build, source=source), trees.values())))
    print("build: " + "  ".join(f"{k} {v:.1f} s" for k, v in secs.items()),
          flush=True)
    order = (list(bases) + ["change", "change"]
             + list(reversed(list(bases)))) * args.rounds
    times = {k: [] for k in trees}
    for side in order:
        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=ctx) as pool:
            row = pool.submit(turn, trees[side], args.sweep).result()
        times[side].append(row)
        print(f"{side}: " + "  ".join(f"{k} {v:.4f} ms"
                                      for k, v in row.items()), flush=True)
    summary = {side: {k: statistics.median(r[k] for r in rows)
                      for k in rows[0]} for side, rows in times.items()}
    for side, row in summary.items():
        print(f"median over turns, {side}: " + "  ".join(
            f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    card = cs.card_line()
    print(card, flush=True)
    print(json.dumps({"card": card, "build_s": secs, "turns": times,
                      "median_ms": summary}), flush=True)
    return 0


def main(argv=None) -> int:
    return compare(argv, "recurrent", _turn,
                   "also time every channels per block")


if __name__ == "__main__":
    sys.exit(main())
