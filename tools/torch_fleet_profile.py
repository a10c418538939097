#!/usr/bin/env python3
"""Where a gateway tick of the port's fleet spends its time, serial and
fused, on one NVIDIA card.

    python3 tools/torch_fleet_profile.py [--replicas 2 8] [--ticks 150]
        [--window 40 100] [--src DIR]

For each fleet width R: ``chip_smoke.py`` 13 (e)'s full-size cell
(golden_churn's traffic by ``get_scenario`` overrides only: R replicas x
16 slots, 256 px frames, 192 px models, kernel ingest, 3R/2 initial and
8R most vehicles), run serial, fused, fused, serial (one process, in
turns; each run's wall ms per gateway tick printed), then once more each
way under ``torch.profiler`` over gateway ticks ``--window``:

  * ms per gateway tick over the window (host clock, synchronised at both
    ends) and the device's busy share of it (the union of the device's
    kernel and copy intervals);
  * device ms per tick by kernel or copy (the ten largest), the host-to-
    device copies' ms per tick, device operations per tick;
  * host ms per tick in the tick's parts: the engines' ``stage_class``,
    ``_ingest_kernels``, ``_forward``, ``_finish_class`` and
    ``commit_class``; the fused tick's ``_dispatch`` (the whole fused
    call, mask read included), ``_one_class``, ``_forward`` and
    ``_commit_state`` (``record_function`` ranges put around those
    methods by this tool; a range that ends in a device sync includes the
    wait).

TF32 is off, as in ``chip_smoke.py``.  Weights are drawn on the card from
each replica's seed.  ``--src DIR`` profiles the package under
``DIR/src`` (another checkout, such as the parent's ``git archive``).
Prints the card's name and power limit and one JSON line per width.
Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, FRAME_RES, INPUT_RES = 16, 256, 192


def scenario(get_scenario, ReplicaSpec, R: int, ticks: int):
    return get_scenario(
        "golden_churn", frame_res=FRAME_RES, input_res=INPUT_RES,
        replicas=tuple(ReplicaSpec(f"r{i}", slots=SLOTS) for i in range(R)),
        initial_vehicles=3 * R // 2, max_vehicles=8 * R, use_kernels=True,
        ticks=ticks)


def ranged(torch, cls, names, prefix):
    """Put a profiler range around each method of ``cls`` in ``names``."""
    for name in names:
        orig = getattr(cls, name)

        def wrapped(*a, _orig=orig, _label=f"{prefix}.{name}", **kw):
            with torch.profiler.record_function(_label):
                return _orig(*a, **kw)
        setattr(cls, name, wrapped)


def union_ms(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def run(torch, s, parallel, window=None):
    """One run; with ``window`` (first, last gateway tick) profile those
    ticks.  Returns (ms per gateway tick of the run, profile or None,
    window ms, ticks in the window, digest)."""
    from repro_torch.simulate import ScenarioRunner
    runner = ScenarioRunner(s, parallel=parallel, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts) if window else None
    state = {"n": 0, "t0": 0.0, "dt": 0.0}
    tick = runner.gw.tick

    def counted(**kw):
        if window and state["n"] == window[0]:
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.perf_counter()
        out = tick(**kw)
        state["n"] += 1
        if window and state["n"] == window[1]:
            torch.cuda.synchronize()
            state["dt"] = time.perf_counter() - state["t0"]
            prof.stop()
        return out
    runner.gw.tick = counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if res.violations:
        raise SystemExit(f"violations: {res.violations[:3]}")
    n = (window[1] - window[0]) if window else 0
    return dt * 1e3 / state["n"], prof, state["dt"] * 1e3, n, res.digest


def summarise(torch, prof, wall_ms, n):
    dev, spans, host = {}, [], {}
    launches, h2d_ms = 0, 0.0
    for e in prof.events():
        ours = e.name.startswith(("engine.", "fused."))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if ours:
                continue          # the ranges' device-side annotations
            ms = (e.time_range.end - e.time_range.start) / 1e3
            dev[e.name] = dev.get(e.name, 0.0) + ms
            spans.append((e.time_range.start, e.time_range.end))
            launches += 1
            if "HtoD" in e.name:
                h2d_ms += ms
        elif ours:
            host[e.name] = host.get(e.name, 0.0) + e.cpu_time_total / 1e3
    if not spans:
        raise SystemExit("the profiler saw no device event")
    busy = union_ms(spans)
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_ticks": n,
        "ms_per_tick": wall_ms / n,
        "device_busy_ms_per_tick": busy / n,
        "device_busy_share": busy / wall_ms,
        "device_ops_per_tick": launches / n,
        "h2d_ms_per_tick": h2d_ms / n,
        "device_ms_per_tick_by_op": {k[:80]: v / n for k, v in top},
        "host_ms_per_tick_by_part": {k: v / n for k, v in
                                     sorted(host.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, nargs="*", default=[2, 8])
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--window", type=int, nargs=2, default=[40, 100])
    ap.add_argument("--src", default=ROOT)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_fleet_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    from repro_torch.simulate import ReplicaSpec, get_scenario
    from repro_torch.streams import fleet_step
    from repro_torch.streams.vision_engine import VisionServeEngine
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ranged(torch, VisionServeEngine,
           ("stage_class", "_ingest_kernels", "_forward", "_finish_class",
            "commit_class"), "engine")
    ranged(torch, fleet_step.FleetStep,
           ("_dispatch", "_one_class", "_forward", "_commit_state"),
           "fused")
    for R in args.replicas:
        s = scenario(get_scenario, ReplicaSpec, R, args.ticks)
        turns, digests = {"serial": [], "fused": []}, set()
        for parallel in (False, True, True, False):
            ms, _, _, _, digest = run(torch, s, parallel)
            turns["fused" if parallel else "serial"].append(ms)
            digests.add(digest)
        profiles = {}
        for parallel in (False, True):
            _, prof, wall, n, digest = run(torch, s, parallel, args.window)
            digests.add(digest)
            profiles["fused" if parallel else "serial"] = summarise(
                torch, prof, wall, n)
        if len(digests) != 1:
            print(f"torch_fleet_profile: serial and fused digests differ "
                  f"at R={R}: {sorted(digests)}", file=sys.stderr)
            return 1
        print(json.dumps({"card": card, "replicas": R, "slots": SLOTS,
                          "ms_per_gateway_tick_in_turns": turns,
                          "digest": digests.pop(), **profiles}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
