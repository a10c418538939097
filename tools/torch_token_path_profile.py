#!/usr/bin/env python3
"""Where the PyTorch port's token path spends its time, on one NVIDIA card.

    python3 tools/torch_token_path_profile.py [--arch recurrentgemma-9b |
                                               --arch xlstm-350m] [--src DIR]

1. Attention kernels alone (starcoder2-3b only): each of the four kernels
   at the token path's head shapes (Hq 24, Hkv 2, D 128, bf16, block 16,
   257 table columns, contiguous capacity 2048) over a sweep of live
   lengths, device time per call with a cold L2.  The slope over the live
   length is the cost of 32 more keys; the intercept the fixed cost of a
   call.
2. The token main path that ``chip_smoke.py`` serves (``ServeEngine`` on
   the full-width, full-depth arch, slots 8, 16 requests of 33-1000
   prompt tokens, 32 new tokens each; starcoder2-3b paged,
   recurrentgemma-9b contiguous): host time per phase from a ``SpanTracer``
   (``prefill`` and ``decode`` end in a device sync, so they include the
   device work), then one more drain under ``torch.profiler``: device time
   per kernel, summed by name, and the device's busy share of the drain's
   wall time.
   The port's own kernels are listed with their device time and launches
   over that drain.
3. A decode window: 8 requests admitted at once, then 16 decode-only ticks
   under ``torch.profiler``: host ms per tick, device busy ms per tick and
   the device time per tick by kernel.

``--arch xlstm-350m`` profiles instead what ``chip_smoke.py`` phase 11
times first: ``transformer.prefill`` of 4 prompts x 512 tokens (the
mLSTM kernel once in each of its 21 mLSTM layers; the served drain never
launches it): its wall time, then one more prefill under
``torch.profiler`` with the device time per kernel and the port's
kernels' device time and launches.

``--src DIR`` profiles the package under ``DIR/src`` (another checkout,
for example the parent commit unpacked with ``git archive``) in place of
this checkout's: it builds that checkout's kernels into its own
``_build/``, so two calls in one machine compare a change with its parent
on one card.

The random weights are drawn on the card from a seed, as ``chip_smoke.py``
phases 7 and 10 draw them.  Prints the card's name
and power limit and one JSON summary line.  Needs a card; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = (32, 128, 512, 1024)
SLOTS, CAPACITY, CHUNK, BLOCK = 8, 2048, 128, 16
REQUESTS, NEW, PROMPT, SEED = 16, 32, (33, 1000), 0
PREFILL = (4, 512)                       # xlstm-350m: prompts x tokens
HQ, HKV, D = 24, 2, 128
M = -(-(4096 - 1) // BLOCK) + 1          # table columns at 8 x 257 blocks
FLUSH_BYTES = 1 << 30                    # > 20x the H100's 50 MB L2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call with a cold L2: ``flush`` (1 GiB) is
    zeroed before each call, which evicts the inputs and keeps the card
    busy while the host enqueues the call."""
    for _ in range(warmup):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def sweep_case(torch, gen, dev, L, B, S):
    """B rows of L live keys each, as a shuffled block pool of SLOTS * M
    blocks read through a table (columns past L are -1) and as a
    contiguous (B, CAPACITY) cache (positions -1 past L); S queries per row
    at its last S positions."""
    cols = -(-L // BLOCK)
    nb = SLOTS * M
    perm = torch.randperm(nb, generator=gen)[:B * cols].view(B, cols)
    kp = torch.randn(nb, BLOCK, HKV, D, generator=gen)
    vp = torch.randn(nb, BLOCK, HKV, D, generator=gen)
    ppos = torch.full((nb, BLOCK), -1, dtype=torch.int32)
    tbl = torch.full((B, M), -1, dtype=torch.int32)
    tbl[:, :cols] = perm.int()
    p = torch.arange(cols * BLOCK)
    ppos.view(-1)[(perm[:, p // BLOCK] * BLOCK + p % BLOCK).view(-1)] = (
        torch.where(p < L, p, -1).int().repeat(B))
    k = torch.randn(B, CAPACITY, HKV, D, generator=gen)
    v = torch.randn(B, CAPACITY, HKV, D, generator=gen)
    kv_pos = torch.full((B, CAPACITY), -1, dtype=torch.int32)
    kv_pos[:, :L] = torch.arange(L, dtype=torch.int32)
    q = torch.randn(B, S, HQ, D, generator=gen)
    q_pos = torch.arange(L - S, L, dtype=torch.int32).repeat(B, 1)
    bf = lambda t: t.to(dev, torch.bfloat16)
    return (bf(q), bf(kp), bf(vp), ppos.to(dev), tbl.to(dev), bf(k), bf(v),
            q_pos.to(dev), kv_pos.to(dev))


def kernel_sweep(torch, dev):
    """{kernel: {live length: ms}} at the token path's head shapes."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import paged_attention as pa_k
    gen = torch.Generator().manual_seed(3)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {}
    for L in SWEEP:
        for S, B in ((1, SLOTS), (min(CHUNK, L), 1)):
            q, kp, vp, ppos, tbl, k, v, q_pos, kv_pos = sweep_case(
                torch, gen, dev, L, B, S)
            calls = ({"paged_decode": lambda: pa_k.paged_decode_attention(
                          q, kp, vp, ppos, tbl, q_pos),
                      "decode": lambda: dec_k.decode_attention(
                          q, k, v, q_pos, kv_pos)} if S == 1 else
                     {"paged_flash": lambda: pa_k.paged_flash_attention(
                          q, kp, vp, ppos, tbl, q_pos),
                      "flash": lambda: fa_k.flash_attention(
                          q, k, v, q_pos, kv_pos)})
            for name, fn in calls.items():
                out.setdefault(name, {})[L] = time_ms(torch, fn, flush)
    for name, row in out.items():
        per_tile = (row[SWEEP[-1]] - row[SWEEP[-2]]) / (
            (SWEEP[-1] - SWEEP[-2]) / 32)
        print(f"sweep {name}: " + "  ".join(
            f"L={L}: {ms:.4f} ms" for L, ms in row.items())
            + f"  -> {per_tile * 1e3:.2f} us per 32 keys", flush=True)
    return out


def requests(Request, vocab, n, new, prompt, seed):
    """n requests alternating priority 0/1, prompts of ``prompt`` lengths."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    return [Request(rid=f"{'outer' if i % 2 == 0 else 'inner'}-{i:02d}",
                    tokens=rng.integers(0, vocab, int(L)),
                    max_new_tokens=new, priority=i % 2)
            for i, L in enumerate(lens)]


def engine(cfg, params, dev):
    """A ServeEngine on the card: paged wherever the arch allows it."""
    from repro_torch.models.attention import RunOpts
    from repro_torch.serving import ServeEngine
    return ServeEngine(cfg, params, slots=SLOTS, cache_capacity=CAPACITY,
                       prefill_chunk=CHUNK, block_size=BLOCK,
                       opts=RunOpts(use_kernels=True), device=dev)


def serve(torch, cfg, params, reqs, dev, tracer=None):
    """Drain fresh copies of ``reqs`` through a ServeEngine on the card;
    returns the drain's wall seconds."""
    eng = engine(cfg, params, dev)
    if tracer is not None:
        eng.attach_obs(tracer=tracer)
    for r in reqs:
        eng.submit(copy.deepcopy(r))
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_ms(torch, prof) -> dict:
    """Device time by kernel name (ms) from a profile: device-side events
    only (kernels, copies); a CPU op's device time repeats the kernels it
    launched."""
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3)
    return kernels


def port_kernels(torch, prof) -> dict:
    """{kernel: (device ms, launches)} of the port's own CUDA kernels (the
    ``csrc`` sources define them in an anonymous namespace, a template
    instance's name starting with its return type, a plain kernel's with
    the namespace; PyTorch's kernels there name ``at::native``), by
    instance."""
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.key.startswith(("void (anonymous namespace)::",
                                      "(anonymous namespace)::"))
                and "at::native" not in e.key):
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return out


def decode_window(torch, cfg, params, reqs, dev, ticks=16):
    """Admit SLOTS requests in one tick, then profile ``ticks`` decode-only
    ticks.  Returns (host ms per tick, {kernel: device ms per tick})."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine(cfg, params, dev)
    for r in reqs[:SLOTS]:
        r = copy.deepcopy(r)
        r.max_new_tokens = ticks + 4             # no one retires in the window
        eng.submit(r)
    eng.step()                                  # admissions + first decode
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall * 1e3 / ticks, {k: ms / ticks
                                for k, ms in device_ms(torch, prof).items()}


def prefill_profile(torch, cfg, params, dev, card, src) -> int:
    """xlstm-350m: ``transformer.prefill`` of PREFILL prompts, timed, then
    once more under ``torch.profiler``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    opts = RunOpts(use_kernels=True)
    B, S = PREFILL
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.long, device=dev)
    TT.prefill(cfg, params, toks[:, :16], opts=opts)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    TT.prefill(cfg, params, toks, opts=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        TT.prefill(cfg, params, toks, opts=opts)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = device_ms(torch, prof)
    if not kernels:
        print("the profiler saw no device event", file=sys.stderr)
        return 1
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(f"{cfg.name} prefill {B} x {S} tokens (package {src}): "
          f"{wall * 1e3:.1f} ms; profiled {prof_wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms ({100 * busy / (prof_wall * 1e3):.1f} %) on "
          f"{card}", flush=True)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name[:100]}", flush=True)
    ours = port_kernels(torch, prof)
    for name, (ms, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        print(f"port kernel over the prefill: {ms:9.2f} ms in {n} launches "
              f"({ms * 1e3 / n:.2f} us each)  {name[:100]}", flush=True)
    print(card, flush=True)
    print(json.dumps({
        "card": card, "arch": cfg.name, "src": src, "prefill_s": wall,
        "profiled_prefill_s": prof_wall, "device_busy_ms": busy,
        "device_top_ms": {name[:100]: ms for name, ms in top},
        "port_kernels_ms_launches": {name[:100]: v for name, v in
                                     ours.items()}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b",
                    choices=("starcoder2-3b", "recurrentgemma-9b",
                             "xlstm-350m"))
    ap.add_argument("--src", default=ROOT,
                    help="the checkout whose package is profiled")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_token_path_profile: needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    from repro_torch.config import get_arch
    from repro_torch.kernels import build
    from repro_torch.models import transformer as TT
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving import Request

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    for name in ("attention", "decode_attention", "recurrent"):
        build.build(name)
    sweep = kernel_sweep(torch, dev) if args.arch == "starcoder2-3b" else None

    cfg = get_arch(args.arch)
    params = TT.init_params(cfg, torch.Generator().manual_seed(SEED),
                            device=dev)
    if args.arch == "xlstm-350m":
        return prefill_profile(torch, cfg, params, dev, card, args.src)
    reqs = requests(Request, cfg.vocab_size, REQUESTS, NEW, PROMPT, SEED)
    serve(torch, cfg, params, reqs[:2], dev)                  # warm-up
    tracer = SpanTracer()
    wall = serve(torch, cfg, params, reqs, dev, tracer=tracer)
    phases = {}
    for name in ("prefill", "decode", "tick"):
        spans = tracer.spans(name)
        phases[name] = {"ms": sum(e["dur"] for e in spans) / 1e3,
                        "count": len(spans)}
    for name, p in phases.items():
        print(f"{cfg.name} host phase {name}: {p['ms']:.1f} ms in "
              f"{p['count']} spans ({p['ms'] / max(p['count'], 1):.3f} ms "
              f"each) of a {wall * 1e3:.1f} ms drain on {card}", flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = serve(torch, cfg, params, reqs, dev)
    kernels = device_ms(torch, prof)
    if not kernels:
        print("the profiler saw no device event", file=sys.stderr)
        return 1
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(f"device: busy {busy:.1f} ms of a {prof_wall * 1e3:.1f} ms "
          f"profiled drain ({100 * busy / (prof_wall * 1e3):.1f} %)",
          flush=True)
    for name, ms in top:
        print(f"  {ms:9.2f} ms  {name[:100]}", flush=True)
    ours = port_kernels(torch, prof)
    for name, (ms, n) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        print(f"port kernel over the drain: {ms:9.2f} ms in {n} launches "
              f"({ms * 1e3 / n:.2f} us each)  {name[:100]}", flush=True)

    tick_ms, per_tick = decode_window(torch, cfg, params, reqs, dev)
    tick_busy = sum(per_tick.values())
    tick_top = sorted(per_tick.items(), key=lambda kv: -kv[1])[:12]
    print(f"decode window ({SLOTS} slots, profiled): {tick_ms:.3f} ms per "
          f"tick on the host, device busy {tick_busy:.3f} ms per tick "
          f"({100 * tick_busy / tick_ms:.1f} %)", flush=True)
    for name, ms in tick_top:
        print(f"  {ms:9.4f} ms/tick  {name[:100]}", flush=True)
    print(card, flush=True)
    print(json.dumps({
        "card": card, "arch": cfg.name, "layers": cfg.num_layers,
        "sweep_ms": sweep, "host_phases": phases, "drain_s": wall,
        "profiled_drain_s": prof_wall, "device_busy_ms": busy,
        "device_top_ms": {name[:100]: ms for name, ms in top},
        "port_kernels_ms_launches": {name[:100]: v for name, v in
                                     ours.items()},
        "decode_tick_ms": tick_ms, "decode_tick_busy_ms": tick_busy,
        "decode_tick_top_ms": {name[:100]: ms for name, ms in tick_top}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
