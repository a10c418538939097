#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time, on one
NVIDIA card.

    python3 tools/torch_train_profile.py [--layers N] [--batch 8]
                                         [--seq 512] [--accum 2]

starcoder2-3b at full width (full depth unless ``--layers``), bf16
parameters, fp32 Adam moments, remat full: the step of ``chip_smoke.py``
phase 18 (b).  The step is run as its two halves, each timed on the host
(ending in a device sync) after two warm steps, then once more under
``torch.profiler``:

1. the gradients (``train_step.make_loss_and_grad``: forward, recompute
   and backward of every microbatch, and the fp32 accumulation);
2. the AdamW update (``optimizer.adamw_update``, in place).

For each half: wall ms, device busy ms (the sum of every kernel's device
time; one stream, so no overlap), the host gaps (wall minus busy), and
the device time by operator class: GEMM (``aten::mm``/``addmm``: the
bf16 projections, MLP and LM head), attention's batched products
(``aten::bmm``: the fp32 score and value einsums), and the rest
(elementwise, reductions, copies, the softmax and the embedding's
scatter), then the ten operators with the most device time.  Prints the
card's name and power limit and one JSON line.  Needs a card; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMM = ("aten::mm", "aten::addmm")
BMM = ("aten::bmm",)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0].strip()


def device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def profiled(torch, fn, label):
    """Wall ms of ``fn`` alone, then its device time under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [(e.key, device_ms(e), e.count) for e in prof.key_averages()
           if device_ms(e) > 0 and e.key.startswith("aten::")]
    busy = sum(ms for _, ms, _ in ops)
    gemm = sum(ms for k, ms, _ in ops if k in GEMM)
    bmm = sum(ms for k, ms, _ in ops if k in BMM)
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "host_gap_ms": wall - busy, "gemm_ms": gemm, "attn_bmm_ms": bmm,
           "other_ms": busy - gemm - bmm,
           "top": sorted(ops, key=lambda r: -r[1])[:10]}
    print(f"{label}: wall {wall:.1f} ms (unprofiled), device busy "
          f"{busy:.1f} ms (profiled), host gaps {wall - busy:.1f} ms; GEMM "
          f"{gemm:.1f} ms, attention bmm {bmm:.1f} ms, other "
          f"{busy - gemm - bmm:.1f} ms", flush=True)
    for key, ms, n in out["top"]:
        print(f"  {key:40s} {ms:9.2f} ms  {n:6d} calls", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_profile: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.config import ParallelConfig, get_arch
    from repro_torch.data import lm_batches
    from repro_torch.models import transformer as TT
    from repro_torch.train import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.train.train_step import make_loss_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda")
    cfg = get_arch("starcoder2-3b")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), dev)
    state = init_opt_state(params)
    grads_of = make_loss_and_grad(cfg, ParallelConfig(
        grad_accum=args.accum, remat="full"))
    opt = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=20)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(lm_batches(
        args.batch, args.seq, cfg.vocab_size, seed=0, steps=1)).items()}
    box = {}

    def grads():
        box["grads"] = None
        box["grads"] = grads_of(params, batch)[2]

    def update():
        adamw_update(opt, box["grads"], params, state)

    for _ in range(2):
        grads()
        update()
    total, _ = cfg.param_counts()
    print(f"starcoder2-3b, {cfg.num_layers} layers, {total / 1e9:.3f} B "
          f"parameters bf16, B {args.batch} x S {args.seq}, grad_accum "
          f"{args.accum}, remat full; {card}", flush=True)
    out = {"card": card, "layers": cfg.num_layers, "batch": args.batch,
           "seq": args.seq, "accum": args.accum,
           "grads": profiled(torch, grads, "gradients"),
           "adamw": profiled(torch, update, "AdamW update")}
    step = out["grads"]["wall_ms"] + out["adamw"]["wall_ms"]
    print(f"step {step:.1f} ms: gradients "
          f"{100 * out['grads']['wall_ms'] / step:.1f}%, AdamW "
          f"{100 * out['adamw']['wall_ms'] / step:.1f}%", flush=True)
    print(card, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
