#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.  Exits non-zero and prints no result without
a card, in a directory without the program, or when a JAX module was
loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402

env.prepare_environment()

from portbench.harness import cell  # noqa: E402
from portbench.harness.session import Session  # noqa: E402
from portbench.harness.trace import breakdown  # noqa: E402


def run_cell(torch, spec: dict, *, seed: int, seconds: float, trace: bool,
             device, t_process: float, mode: str = "program",
             ticks: int = None):
    """Run the cell; returns the result line's object."""
    numerics = env.set_numerics(torch)
    s = Session(torch, seed=seed, seconds=seconds, trace=trace,
                device=device, t_process=t_process, ticks=ticks)
    drv = cell.driver(spec["mix"]["driver"])
    out = drv.run(s, spec["config"], spec["mix"], spec["limits"], mode=mode)
    checks = out["checks"]
    correct = bool(checks) and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    if trace:
        metrics = cell.read_metrics(spec["per_layer"], out["record"],
                                    spec["bench_dir"])
    else:
        metrics = {name: {"value": v, "unit": units[name]}
                   for name, v in out["e2e"].items() if name in units}
        metrics["setup_s"] = {"value": s.setup_s, "unit": units["setup_s"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": s.memory_peak_bytes}
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev,
            "numerics": numerics, "setup_s": s.setup_s,
            "window_s": s.window_s}
    if trace and s.trace_summary is not None:
        dev["busy_s"] = s.trace_summary["busy_s"]
        dev["window_s"] = s.trace_summary["window_s"]
        line["breakdown"] = breakdown(s.trace_summary)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not env.checkout_complete():
        print("portbench: no program beside the benchmark "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    spec = cell.load_cell(args.workload)
    import torch
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = run_cell(torch, spec, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda", 0),
                    t_process=T_PROCESS)
    # the window has closed: whatever the port loaded is in sys.modules now
    found = env.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in the benchmark process: "
              f"{found[:20]}", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
