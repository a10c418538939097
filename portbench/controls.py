#!/usr/bin/env python3
"""Readings of a cell's control and planted faults, at the cell's own size,
on the card: the upper readings its limits are set from.

    python3 portbench/controls.py --workload <cell> --seeds 11 12 13 \\
        --seconds 5 --mode control [--mode fault_half_batch ...]

``control``: the plain reference, one precision below the configuration's,
stands in the program's place and is judged as the program is (float8
operands of every product of the bfloat16 language model).  ``fault_half_batch`` (training): the
reference in the program's place takes each step's mean gradient over the
first half of the rows alone.  One line of JSON a run, each number beside
the limit ``limits/<cell>.json`` holds.  The benchmark's own runs never run
this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench.harness import env  # noqa: E402

env.prepare_environment()

from portbench import run  # noqa: E402
from portbench.harness import cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--mode", action="append", required=True,
                    choices=("program", "control", "fault_half_batch"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for mode in args.mode:
            spec = cell.load_cell(args.workload)
            t = time.perf_counter()
            line = run.run_cell(torch, spec, seed=seed, seconds=args.seconds,
                                trace=False, device=torch.device("cuda", 0),
                                t_process=t, mode=mode)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "mode": mode,
                "correct": line["correct"], "seconds": time.perf_counter() - t,
                "checks": line["checks"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
