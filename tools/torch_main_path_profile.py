#!/usr/bin/env python3
"""Where the PyTorch port's main path spends a tick, on one NVIDIA card.

    python3 tools/torch_main_path_profile.py [--src DIR]

Runs the same main path as ``chip_smoke.py`` (``VisionServeEngine`` with
``use_kernels=True``, slots=32, frame_res=256, input_res=192, 16 outer +
16 inner streams of 32 frames) twice after a warm-up:

  1. with a ``SpanTracer`` on the engine's wall clock: host time per phase
     (``stage``, ``ingest``, ``forward``, ``commit``; ``ingest`` and
     ``forward`` end in a device sync, so they include the device work);
  2. under ``torch.profiler``: device time per kernel and copy, summed
     (the twelve largest, and every kernel of the port's own), and the
     device's busy share of the drain's wall time (one stream, so the sum
     is the busy time).

``--src DIR`` profiles the package under ``DIR/src`` (another checkout,
such as the parent's ``git archive``), so the parent and the change can be
profiled in one call, one process each.  Prints the card's name and power
limit and one JSON summary line.  Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOTS, FRAME_RES, INPUT_RES = 32, 256, 192
STREAMS_PER_CLASS, FRAMES = 16, 32


def feed(frame_loop, classes, per_class, frames):
    """{key: (kind, [frames])}: per_class looped dash-cam streams of each
    class, as ``chip_smoke.py`` feeds them."""
    out = {}
    for c, kind in enumerate(classes):
        for i in range(per_class):
            at = frame_loop(1000 * c + i, res=FRAME_RES, frames=frames)
            out[f"{kind}{i:02d}"] = (kind, [at(t) for t in range(frames)])
    return out


def drive(eng, streams):
    """Open, push everything, drain (timed), close; returns (drain seconds,
    ticks)."""
    import torch
    for key, (kind, frames) in streams.items():
        eng.open_stream(key, kind)
        for f in frames:
            eng.push(key, f)
    t0, ticks0 = time.perf_counter(), eng.ticks
    eng.drain()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for key in streams:
        eng.close_stream(key)
    eng.ledger.check()
    return dt, eng.ticks - ticks0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=ROOT,
                    help="the checkout whose package to profile")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_main_path_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    from repro_torch.core.engine_core import INNER, OUTER
    from repro_torch.data.synthetic import frame_loop
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.streams import VisionServeEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    common = dict(slots=SLOTS, frame_res=FRAME_RES, input_res=INPUT_RES,
                  fps=30, use_kernels=True, device="cuda")
    warm = VisionServeEngine("warm", generator=torch.Generator().manual_seed(0),
                             **common)
    drive(warm, feed(frame_loop, (OUTER, INNER), 1, 2))
    streams = feed(frame_loop, (OUTER, INNER), STREAMS_PER_CLASS, FRAMES)
    params = (warm.dp, warm.pp)

    # 1. host phases
    tracer = SpanTracer()
    eng = VisionServeEngine("traced", params=params, **common)
    eng.attach_obs(tracer=tracer)
    wall_s, ticks = drive(eng, streams)
    phases = {}
    for ev in tracer.spans():
        phases[ev["name"]] = phases.get(ev["name"], 0.0) + ev["dur"] / 1e3

    # 2. device kernels
    eng = VisionServeEngine("profiled", params=params, **common)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prof_wall_s, prof_ticks = drive(eng, streams)
        prof_total_s = time.perf_counter() - t0
    # device-side events only (kernels, memcpys): a CPU op's device time
    # repeats the kernels it launched
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[e.key] = (kernels.get(e.key, 0.0)
                          + e.self_device_time_total / 1e3)
    if not kernels:
        print("torch_main_path_profile: the profiler saw no device event",
              file=sys.stderr)
        return 1
    busy_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    # the port's own kernels (csrc's anonymous namespace), every one
    port = {k: v for k, v in kernels.items()
            if "(anonymous namespace)::" in k and "at::native" not in k}

    print(card, flush=True)
    print(json.dumps({
        "card": card, "src": args.src, "ticks": ticks,
        "drain_ms": wall_s * 1e3,
        "ms_per_tick": wall_s * 1e3 / ticks,
        "host_phase_ms_per_tick": {k: v / ticks for k, v in
                                   sorted(phases.items())},
        "profiled_drain_ms": prof_wall_s * 1e3,
        "profiled_total_ms": prof_total_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (prof_wall_s * 1e3),
        "device_ms_per_tick_by_kernel": {k[:90]: v / prof_ticks
                                         for k, v in top},
        "port_kernel_ms_per_tick": {k[:90]: v / prof_ticks
                                    for k, v in sorted(port.items())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
