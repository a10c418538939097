#!/usr/bin/env python3
"""Drive the PyTorch port's vision main path on one NVIDIA card and check it.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits non-zero; nothing is swallowed):

  1. build     compile ``src/repro_torch/kernels/csrc/vision_ops.cu`` with
               nvcc for sm_90a; print the build time and the card's name
               and power limit.
  2. kernels   hold each hand kernel against its plain PyTorch version on
               the card, at the main path's shapes and at edge shapes
               (uint8 frames, box resampling, g=20 with block=8, a bf16
               pool); time kernel, plain version and, where one PyTorch
               call computes the same function, that call, each with a
               cold L2 (inputs come from HBM, as the bound assumes).
  3. main path ``VisionServeEngine(use_kernels=True, slots=32,
               frame_res=256, input_res=192)`` with the motion gate on:
               16 outer + 16 inner dash-cam streams, 32 frames each,
               drained and closed, ``ledger.check()``; the ``ingest_frame``
               and ``scatter_admit`` launch counts must be above 0.  Then
               the same drain on fresh engines, REPEATS more times: every
               run must give the same outcome, and each run's rates are
               printed.
  4. paths     the gateless kernel path (``downscale``) and the plain
               engine path with ``MotionGate(use_kernels=True)``
               (``downscale`` + ``block_sad``), each with its own counts.
  5. card/CPU  the main path again on the CPU, same weights and frames:
               per-stream processed/gated/dropped counts and flags equal.

TF32 is turned off for cuDNN and matmuls here (the library modules set no
global flags): the flags are threshold and argmax decisions, and TF32
rounding could flip them between the card and the CPU.

The last lines are: the card's name and power limit, one JSON object with
a ``kernels`` list (launches on the main path, errors, times, bounds), and
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores
TIGHT = dict(rtol=2e-5, atol=2e-5)  # tests/kernel_harness.py TIGHT

SLOTS, FRAME_RES, INPUT_RES, GATE_RES, BLOCK = 32, 256, 192, 32, 8
STREAMS_PER_CLASS, FRAMES, REPEATS = 16, 32, 3
FLUSH_BYTES = 1 << 30              # > 20x the H100's 50 MB L2
REPLACES = {
    "ingest_frame": "src/repro/kernels/vision_ops.py:126",
    "scatter_admit": "src/repro/kernels/vision_ops.py:153",
    "downscale": "src/repro/kernels/vision_ops.py:140",
    "block_sad": "src/repro/kernels/vision_ops.py:148",
}
SOURCE = "src/repro_torch/kernels/csrc/vision_ops.cu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


_FLUSH = []


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` with a cold L2.  Before each
    call a 1 GiB buffer is zeroed: that evicts the inputs from L2, so the
    call reads them from HBM as the bound assumes, and it keeps the card
    busy while the host enqueues the call, so the CUDA events around the
    call time the device and not the launch."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in marks:
        _FLUSH[0].zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def pixels_read(H: int, W: int, resolutions, method: str) -> int:
    """Source pixels per frame that resampling to each of ``resolutions``
    must read.  Nearest reads only the sampled rows x columns (``i*H//res``,
    as ``downscale_plain``), their union over the outputs; box averages
    buckets that tile the whole frame when downscaling."""
    if method == "box":
        return H * W
    ys = {i * H // r for r in resolutions for i in range(r)}
    xs = {i * W // r for r in resolutions for i in range(r)}
    return len(ys) * len(xs)


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, exact: bool = False) -> float:
    import torch
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if isinstance(want, torch.Tensor) else list(want)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype {tuple(g.shape)} {g.dtype} != "
                 f"{tuple(w.shape)} {w.dtype}")
        if not torch.isfinite(g.float()).all():
            fail("kernel output is not finite")
        if exact and not torch.equal(g, w):
            fail("kernel output is not bit-identical to its plain version")
        torch.testing.assert_close(g.float(), w.float(), **TIGHT)
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def check_kernels(torch, vo, dev):
    """Phase 2.  Returns {name: row} for the JSON line (launches filled in
    later from the paths)."""
    rng = torch.Generator(device=dev).manual_seed(0)
    S, H, m, g = SLOTS, FRAME_RES, INPUT_RES, GATE_RES

    def rand(*shape, dtype=torch.float32):
        if dtype == torch.uint8:
            return torch.randint(0, 256, shape, generator=rng, device=dev,
                                 dtype=torch.uint8)
        return torch.rand(shape, generator=rng, device=dev)

    frames, frames_u8 = rand(S, H, H, 3), rand(S, H, H, 3, dtype=torch.uint8)
    refs = rand(S, g, g, 3)
    rows, errs = {}, {k: 0.0 for k in REPLACES}

    # ingest_frame: main-path shape, then uint8 / box / g=20 edges
    kw = dict(model_res=m, gate_res=g, block=BLOCK)
    for f, method in ((frames, "nearest"), (frames_u8, "nearest"),
                      (frames, "box"), (frames_u8, "box")):
        errs["ingest_frame"] = max(errs["ingest_frame"], max_err(
            vo.ingest_frame(f, refs, method=method, **kw),
            vo.ingest_frame_plain(f, refs, method=method, **kw)))
    for f in (frames, frames_u8):       # nearest model/gate frames are exact
        a = vo.ingest_frame(f, refs, **kw)
        b = vo.ingest_frame_plain(f, refs, **kw)
        max_err(a[:2], b[:2], exact=True)
    refs20 = rand(S, 20, 20, 3)
    small = rand(4, 64, 64, 3)
    for f, r, kw20 in ((frames, refs20, dict(model_res=m, gate_res=20)),
                       (small, refs20[:4], dict(model_res=48, gate_res=20))):
        errs["ingest_frame"] = max(errs["ingest_frame"], max_err(
            vo.ingest_frame(f, r, block=8, **kw20),
            vo.ingest_frame_plain(f, r, block=8, **kw20)))

    # downscale: gateless (-> model res) and gate (-> gate res) shapes
    for f in (frames, frames_u8):
        for res in (m, g):
            max_err(vo.downscale(f, res), vo.downscale_plain(f, res),
                    exact=True)
            errs["downscale"] = max(errs["downscale"], max_err(
                vo.downscale(f, res, method="box"),
                vo.downscale_plain(f, res, method="box")))

    # block_sad: gate shape, and partial edge blocks (20 and 30 with 8)
    for hw in (g, 20, 30):
        a, b = rand(S, hw, hw, 3), rand(S, hw, hw, 3)
        errs["block_sad"] = max(errs["block_sad"], max_err(
            vo.block_sad(a, b, BLOCK), vo.block_sad_plain(a, b, BLOCK)))

    # scatter_admit: f32 and bf16 pools, gated refs and the gateless (1x1)
    admit = torch.rand(S, generator=rng, device=dev) < 0.5
    model, gate = rand(S, m, m, 3), rand(S, g, g, 3)
    null = torch.zeros(S, 1, 1, 3, device=dev)
    for pool in (torch.float32, torch.bfloat16):
        batch = rand(S, m, m, 3).to(pool)
        for r, gt in ((refs, gate), (null, null)):
            max_err(vo.scatter_admit(batch, model, r, gt, admit),
                    vo.scatter_admit_plain(batch, model, r, gt, admit),
                    exact=True)
    torch.cuda.synchronize()

    # times at the main path's shapes (f32 frames, nearest, f32 pool).
    # Bytes: each input element the function needs read once, each output
    # written once.  Nearest needs only the sampled source pixels; the
    # scatter reads, per row, only the input it selects (model or batch,
    # gate or refs), plus the mask.
    ys = torch.arange(m, device=dev) * H // m
    batch = rand(S, m, m, 3)
    sad_a, sad_b = rand(S, g, g, 3), rand(S, g, g, 3)
    f4, pix = 4, 3
    plan = {
        "ingest_frame": (
            lambda: vo.ingest_frame(frames, refs, **kw),
            lambda: vo.ingest_frame_plain(frames, refs, **kw), None,
            S * pixels_read(H, H, (m, g), "nearest") * pix * f4
            + 2 * S * g * g * pix * f4 + S * m * m * pix * f4 + S * f4,
            S * (g * g * pix * 3 + g * g)),
        "scatter_admit": (
            lambda: vo.scatter_admit(batch, model, refs, gate, admit),
            lambda: vo.scatter_admit_plain(batch, model, refs, gate, admit),
            None,
            S * (2 * m * m * pix * f4 + 2 * g * g * pix * f4) + S,
            0),
        "downscale": (
            lambda: vo.downscale(frames, m),
            lambda: vo.downscale_plain(frames, m),
            lambda: frames[:, ys[:, None], ys[None, :]],
            S * pixels_read(H, H, (m,), "nearest") * pix * f4
            + S * m * m * pix * f4,
            0),
        "block_sad": (
            lambda: vo.block_sad(sad_a, sad_b, BLOCK),
            lambda: vo.block_sad_plain(sad_a, sad_b, BLOCK), None,
            2 * S * g * g * pix * f4 + S * f4,
            S * (g * g * pix * 2 + g * g)),
    }
    for name, (kern, plain, lib, nbytes, flops) in plan.items():
        b_ms, b_by = bound(nbytes, flops)
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": time_ms(kern),
            "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lib) if lib is not None else None,
        }
        print(f"kernel {name}: max_abs_err {errs[name]:.3g}  cold L2: "
              f"kernel {rows[name]['ms']:.4f} ms  plain "
              f"{rows[name]['plain_ms']:.4f} ms  library "
              f"{rows[name]['library_ms']}  bound {b_ms * 1e3:.2f} us "
              f"({b_by}, {nbytes / 1e6:.2f} MB)", flush=True)
    # yardsticks that are not one call computing the same function
    sel = admit[:, None, None, None]
    where_ms = time_ms(lambda: (torch.where(sel, model, batch),
                                torch.where(sel, gate, refs)))
    print(f"yardstick (cold L2): two torch.where for pool+refs "
          f"{where_ms:.4f} ms", flush=True)
    return rows


def feed(frame_loop, classes, per_class, frames):
    """{key: (kind, [frames])}: per_class streams of each class."""
    out = {}
    for c, kind in enumerate(classes):
        for i in range(per_class):
            at = frame_loop(1000 * c + i, res=FRAME_RES, frames=frames)
            out[f"{kind}{i:02d}"] = (kind, [at(t) for t in range(frames)])
    return out


def drive(eng, streams):
    """Open, push everything, drain, record, close; returns
    (per-stream outcome, drain seconds, ticks)."""
    import torch
    for key, (kind, _) in streams.items():
        eng.open_stream(key, kind)
    for key, (_, frames) in streams.items():
        for f in frames:
            if not eng.push(key, f):
                fail(f"backpressure dropped a frame of {key}")
    t0, ticks0 = time.perf_counter(), eng.ticks
    eng.drain()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {k: (s.processed, s.gated, s.dropped, list(eng.results[k]))
           for k, s in eng.streams.items()}
    for k in streams:
        eng.close_stream(k)
    eng.ledger.check()
    for kind in eng.batches:
        b = eng.batches[kind]
        if not torch.isfinite(b.float()).all():
            fail(f"{kind} batch pool holds non-finite values")
    return out, dt, eng.ticks - ticks0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA card")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    from repro_torch.core.engine_core import INNER, OUTER
    from repro_torch.data.synthetic import frame_loop
    from repro_torch.kernels import build
    from repro_torch.kernels import vision_ops as vo
    from repro_torch.streams import MotionGate, VisionServeEngine

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("numerics: TF32 off for cuDNN convolutions and matmuls", flush=True)

    # ---- phase 1: build -------------------------------------------------
    card = card_line()
    t0 = time.perf_counter()
    lib = build.build("vision_ops")
    print(f"build: vision_ops.cu in {time.perf_counter() - t0:.1f} s "
          f"on {card}", flush=True)
    log = lib.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- phase 2: kernels vs plain --------------------------------------
    rows = check_kernels(torch, vo, dev)

    # ---- phase 3: the main path ------------------------------------------
    common = dict(slots=SLOTS, frame_res=FRAME_RES, input_res=INPUT_RES,
                  fps=30)
    gen = torch.Generator().manual_seed(0)
    warm = VisionServeEngine("warm", use_kernels=True, generator=gen,
                             device=dev, **common)
    drive(warm, feed(frame_loop, (OUTER, INNER), 1, 2))
    streams = feed(frame_loop, (OUTER, INNER), STREAMS_PER_CLASS, FRAMES)
    eng = VisionServeEngine("card", use_kernels=True, device=dev,
                            params=(warm.dp, warm.pp), **common)
    vo.reset_launches()
    card_out, drain_s, ticks = drive(eng, streams)
    main_launches = dict(vo.LAUNCHES)
    for name in ("ingest_frame", "scatter_admit"):
        if main_launches[name] == 0:
            fail(f"main path never launched {name}")
        rows[name]["launches"] = main_launches[name]
    processed = sum(v[0] for v in card_out.values())
    gated = sum(v[1] for v in card_out.values())
    dropped = sum(v[2] for v in card_out.values())
    flagged = sum(sum(v[3]) for v in card_out.values())
    if processed == 0:
        fail("main path processed no frame")
    print(f"main path: {processed} processed, {gated} gated, {dropped} "
          f"dropped, {flagged} flagged in {ticks} ticks; launches "
          f"{main_launches}", flush=True)
    # rates: offered = every frame the drain took in (processed + gated +
    # dropped), against the 960 frames/s that 32 streams at 30 fps offer;
    # processed = frames that reached a model
    runs = [(drain_s, ticks)]
    for r in range(REPEATS):
        again = VisionServeEngine(f"card{r}", use_kernels=True, device=dev,
                                  params=(warm.dp, warm.pp), **common)
        out, dt, tk = drive(again, streams)
        if out != card_out:
            fail(f"repeat {r} of the main path gave another outcome")
        runs.append((dt, tk))
    for i, (dt, tk) in enumerate(runs):
        print(f"main path run {i}: {tk} ticks in {dt:.4f} s: "
              f"{(processed + gated + dropped) / dt:.1f} offered frames/s, "
              f"{processed / dt:.1f} processed frames/s, "
              f"{dt * 1e3 / tk:.3f} ms/tick on {card}", flush=True)

    # ---- phase 4: the other kernel paths -----------------------------------
    side = feed(frame_loop, (OUTER, INNER), 8, 8)
    gateless = VisionServeEngine("gateless", use_kernels=True, use_gate=False,
                                 device=dev, params=(warm.dp, warm.pp),
                                 **common)
    vo.reset_launches()
    drive(gateless, side)
    if vo.LAUNCHES["downscale"] == 0 or vo.LAUNCHES["scatter_admit"] == 0:
        fail(f"gateless path launches {vo.LAUNCHES}")
    rows["downscale"]["launches"] = vo.LAUNCHES["downscale"]
    print(f"gateless path: launches {dict(vo.LAUNCHES)}", flush=True)
    gated_plain = VisionServeEngine(
        "gate-admit", use_kernels=False, device=dev,
        gate=MotionGate(SLOTS, use_kernels=True, device=dev),
        params=(warm.dp, warm.pp), **common)
    vo.reset_launches()
    drive(gated_plain, side)
    if vo.LAUNCHES["downscale"] == 0 or vo.LAUNCHES["block_sad"] == 0:
        fail(f"MotionGate.admit path launches {vo.LAUNCHES}")
    rows["block_sad"]["launches"] = vo.LAUNCHES["block_sad"]
    print(f"MotionGate.admit path: launches {dict(vo.LAUNCHES)}", flush=True)

    # ---- phase 5: the main path on the CPU, same weights and frames -------
    cpu = VisionServeEngine("cpu", use_kernels=True, device="cpu",
                            params=(warm.dp, warm.pp), **common)
    t0 = time.perf_counter()
    cpu_out, _, _ = drive(cpu, streams)
    if cpu_out != card_out:
        diff = [k for k in card_out if card_out[k] != cpu_out.get(k)]
        fail(f"card and CPU disagree on streams {diff[:8]}")
    print(f"card vs CPU: {len(card_out)} streams agree on counts and flags "
          f"(CPU run {time.perf_counter() - t0:.1f} s)", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
