"""Serving driver: the EDA case study mapped onto LM inference.

The port's mirror of the reference's ``launch/serve.py``: the same flags
and the same reduced config, plus ``--device`` (the card unless ``cpu`` is
asked).  Two request classes stream in, mirroring the paper's dual dash
cams: ``outer`` (hazard, priority 0) and ``inner`` (distraction, priority
1).  The engine applies the paper's techniques — priority admission,
chunked prefill (segmentation), deadline token budgets (early stopping) —
and this prints the per-class turnaround/skip table like the paper's §4.2.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \\
        --requests 12 --slots 4 --esd 2.0 [--device cpu]

``--arch`` takes any arch of the registry (``starcoder2-3b``,
``recurrentgemma-9b``, ``xlstm-350m``, ``whisper-base``, ``internvl2-2b``,
...), each at its reduced size.  As the reference's launcher, it passes no
frames or patches: a whisper-base request cross-attends to the zero
``cross_k``/``cross_v`` rows of its fresh cache.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import EDAConfig, get_arch
from repro_torch.models import transformer as T
from repro_torch.models.attention import RunOpts
from repro_torch.serving import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> List[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--esd", type=float, default=0.0)
    ap.add_argument("--deadline-ms", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots,
                      cache_capacity=max(64, args.prompt_len + args.max_new + 8),
                      prefill_chunk=16,
                      eda=EDAConfig(esd=args.esd),
                      opts=RunOpts(use_kernels=True), device=args.device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        stream = "outer" if i % 2 == 0 else "inner"
        eng.submit(Request(
            rid=f"{stream}-{i:03d}",
            tokens=rng.integers(0, cfg.vocab_size,
                                rng.integers(4, args.prompt_len + 1)),
            max_new_tokens=args.max_new,
            priority=0 if stream == "outer" else 1,
            deadline_ms=args.deadline_ms))
    done = eng.run()

    print(f"{'rid':12s} {'prio':4s} {'ttft_ms':>8s} {'turn_ms':>8s} "
          f"{'tokens':>6s} {'skip':>6s}")
    for r in done:
        print(f"{r.rid:12s} {r.priority:4d} {r.ttft_ms:8.1f} "
              f"{r.turnaround_ms:8.1f} {len(r.generated):6d} "
              f"{100 * r.skip_rate:5.1f}%")
    for prio in (0, 1):
        rs = [r for r in done if r.priority == prio]
        if rs:
            print(f"class {prio}: mean turnaround "
                  f"{np.mean([r.turnaround_ms for r in rs]):.1f} ms, "
                  f"mean skip {100 * np.mean([r.skip_rate for r in rs]):.1f}%")
    return done


if __name__ == "__main__":
    main()
