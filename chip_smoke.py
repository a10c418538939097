#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (any failure exits non-zero; nothing is swallowed; each prints its
wall seconds):

  1. build     compile ``src/repro_torch/kernels/csrc/vision_ops.cu``,
               ``attention.cu``, ``decode_attention.cu`` and
               ``recurrent.cu`` with nvcc for sm_90a, one nvcc per source,
               started together; print the build times, the card's name
               and power limit, and each decode, flash and recurrent
               kernel instance's registers and spills (the vision
               kernels' too) from the ``-Xptxas -v`` report.
  2. kernels   hold each vision kernel against its plain PyTorch version on
               the card, at the main path's shapes and at edge shapes
               (uint8 frames, box resampling, g=20 with block=8, the
               tiers' model resolutions 48/32/16 under gate 32, a uint8
               row of 60 bytes, bf16 pools, the 1x1 null refs, rows that
               are not 16-byte units); ``ingest_frame`` also bitwise equal
               to ``ingest_blocks_plain``, the kernel's arithmetic in plain
               PyTorch; ``downscale`` (192 and 32 px, nearest and box, fp32
               and uint8) bitwise equal to its model ``_resample_rows``
               and to ``ingest_frame``'s model and gate frames;
               ``block_sad`` bitwise equal to ``sad_blocks_plain`` and, on
               ``ingest_frame``'s gate frame, to its score; every kernel
               bitwise equal to a second call.  Time kernel, plain version
               and, where one PyTorch call computes the same function,
               that call, each with a cold L2 (inputs come from HBM, as
               the bound assumes); ``downscale`` at 32 px too.  Then each
               vision kernel's grid, block, shared memory and registers
               with a bitwise repeat, kernels 1-2's times at the frugal
               tier (model 16 into a bf16 pool), and ingest at 1, 2 and 4
               model rows a block, each setting held against plain first.
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
               (``downscale`` + ``block_sad``), each with its own counts;
               ``downscale``'s launches are the two paths' sum.
  5. card/CPU  the vision main path again on the CPU, same weights and
               frames: per-stream processed/gated/dropped counts and flags
               equal.
  6. attention the four attention kernels (paged decode, paged flash,
               flash, decode; the two decode kernels from
               ``decode_attention.cu``, the keys split over blocks) against
               their plain versions on the card: at
               the token path's shapes (starcoder2-3b: Hq 24, Hkv 2, D 128,
               bf16, block 16, 257 table columns, live lengths 33-1000) and
               at edge shapes (fp32, MHA, D 64, window 8 over a wrapped
               ring, a row whose table is all -1, ragged S); the main
               path's shapes in fp32 too, with one row of 1031 keys;
               TIGHT for fp32, LOOSE for bf16; times with a cold L2 beside
               ``scaled_dot_product_attention`` over the same (gathered)
               KV with a mask from the positions.  Then flash and decode
               at recurrentgemma-9b's heads (Hq 16, Hkv 1, D 256, window
               2048, contiguous capacity 2048): edge shapes, main shapes in
               fp32 and bf16, and their times beside SDPA's.  At each
               timed decode shape: the split (keys per split, splits,
               grid, shared memory per block), two calls bitwise equal,
               and the times at 64, 128 and 256 keys per split.  At each
               timed flash shape (one 128-token chunk: starcoder2-3b's
               heads contiguous and paged, D 256): rows per block, the
               split, grid, shared memory, registers and spills, two
               calls bitwise equal, and the times at 64/128 rows per
               block x 128/256/512 keys per split, each setting first
               held against the plain version within LOOSE.
  7. tokens    ``ServeEngine`` on full-width, full-depth starcoder2-3b
               (bf16, random weights drawn on the card from a seed),
               slots=8, capacity 2048, prefill chunk 128: 16 requests of
               33-1000 prompt tokens, 32 new tokens each, drained through the paged layout (the
               default) and then the contiguous one; every request
               complete, ``ledger.check()``, the pool empty, logits
               finite, and the layout's two kernels launched.  Prints
               decode ms/tick, decode and prefill tokens/s and median TTFT.
  8. tok/CPU   the same engine at reduced depth (2 layers, fp32) on the
               card and on the CPU with the same weights, both layouts:
               equal token streams, teacher-forced last logits within
               TOKEN_TOL (a stream may part only where the CPU's top-two
               logit margin is below TOKEN_TOL; printed if so).
  9. recurrent the RG-LRU scan (bit-exact) and the chunkwise mLSTM (fp32
               within MLSTM_TOL, bf16 LOOSE) against their plain versions,
               every case also run twice and required bitwise equal: at
               the main paths' shapes (RG-LRU B 1, W 4096 at the drain's
               chunks S 2, 16, 64 and 128 with h0, B 2; mLSTM BH 16, S
               512, Dh 512) and at edge shapes (S not a multiple of a
               stage or a chunk, S 128 and 129 at the chunk boundary, B*H
               1, W and Dh not multiples of a block or of 16 bytes, a
               strongly negative input gate); bf16 gates read by the
               kernel equal fp32 gates of the same values bitwise.  Each
               kernel's grid, block size, shared memory and registers;
               times with a cold L2 beside the plain versions and the
               bound (the RG-LRU at S 16 too), then a sweep of the
               RG-LRU's channels per block, each setting first held
               bit-exact against the plain version.
 10. rgemma    ``ServeEngine`` on full-width, full-depth recurrentgemma-9b
               (bf16, 8.52 B random parameters drawn on the card from a
               seed), contiguous, slots=8, capacity 2048, chunk 128: the
               16 requests of phase 7; every request complete,
               ``ledger.check()``, logits finite, kernels 7 and 8
               launched and kernel 9 launched once in every prefill chunk
               of two or more tokens of every RG-LRU layer.  Prints decode ms/tick, decode and prefill
               tokens/s, median TTFT and the launches.
 11. xlstm     full-width, full-depth xlstm-350m (bf16): ``prefill`` of 4
               prompts x 512 tokens (the mLSTM kernel in each of its 21
               mLSTM layers), 16 greedy ``decode_step``s, then a
               ``ServeEngine`` drain of 8 requests of 16-128 prompt tokens,
               16 new tokens each.
 12. rec/CPU   phase 8's comparison for recurrentgemma at one full-width
               period (3 layers: R, R, A) and xlstm at one period (8
               layers), fp32, weights drawn on the host; for xlstm also
               the ``prefill`` logits of two 160-token prompts (a ragged
               second chunk).
 13. fleet     the port's scenario runner (``repro_torch.simulate``) on
               the card; each scenario is warmed (``warm_kernels``), then
               driven with every kernel count zeroed just before and read
               just after, and must end with zero invariant violations:
               (a) ``golden_churn`` through the gates' downscale and
               block-SAD kernels: digest, event count, trace counts and
               summary equal ``tests/golden/fleet_scenario_v1.json``;
               (b) ``pallas_ingest`` through ingest and scatter-admit:
               the reference's digest (pinned below); (c)
               ``mixed_serving`` (vision + token replicas, the paged
               attention kernels): the reference's digest, every request
               done; (d) ``token_failover`` twice, its events read the
               card's own weights: one digest, every request done, every
               event accepted, spools empty; (e) golden_churn's traffic at
               the main path's geometry (2 replicas x 16 slots, 256 px
               frames, 192 px full-width models, 16 vehicles, kernel
               ingest), FULL_TICKS ticks, on the card and on the CPU with
               the same host-drawn weights: equal digests; prints ms per
               gateway tick, offered and processed frames/s, and
               ``jit_cache_entries`` at warmup and at the end (equal).
 14. fused     the fused fleet tick (``FleetGateway(parallel=True)``,
               ``streams/fleet_step.py``) on the card: (a) ``ingest_frame``,
               ``scatter_admit`` (fp32 and bf16 pools), ``downscale`` (192
               and 32 px) and ``block_sad`` on 4 x 16 flattened rows (256 px
               frames, fp32 and uint8) bitwise equal to four launches of 16
               rows; (b) ``golden_churn`` (the golden file), ``pallas_ingest``
               and ``mixed_serving`` (the pinned digests) through the fused
               tick, and the three-group mixed-tier fleet of
               ``tests/test_torch_fleet_step.py`` (base, low, frugal; seed
               77; 40 ticks) serial = fused; each prints the fused calls
               against the ticks that staged a frame (equal) and kernels
               1-4's launches fused and serial; (c) the full-size cell of
               13 (e) serial, fused, fused, serial: every digest
               ``FULL_DIGEST``, ms per gateway tick of each; (d) 13 (e)'s
               cell widened to 8 replicas x 16 slots (4x its vehicles):
               serial = fused digests, ms per gateway tick both ways,
               ``jit_cache_entries`` flat from warmup to the end of each.
 15. eda       the paper's EDA master runtime (``core/runtime.py``): (a)
               ``examples/quickstart.py``'s case study (3 phones, 2 s
               videos, 50 pairs) through ``SimExecutor``: the ledger
               digest pinned in ``tests/test_torch_runtime.py``; (b)
               ``examples/torch_eda_dashcam_serve.py``'s ``RealExecutor``
               on the card: the full-depth detector and pose models at
               192 px on 256 px ``DashCamSource`` frames at 30 fps, 1 s
               videos, findx2pro master + pixel6 + oneplus8, segmentation
               and dynamic ESD, 8 pairs: the ledger table, each device's
               mean turnaround decomposition, the near-real-time
               fraction; every video merged and the first 2 pairs' flags
               equal to the CPU's with the same host-drawn weights; (c)
               ``device_prefetch`` of 32 frame pairs: each equal to its
               host batch, the copy's GB/s.
 16. new archs (a) card vs CPU as phase 8, at 2 layers, fp32, for
               granite-moe-1b-a400m (paged) and starcoder2-7b (paged) at
               full width, and qwen1.5-32b (paged), command-r-plus-104b
               and deepseek-v2-236b (contiguous) at their ``reduced()``
               widths (full width would draw 10-25 GB of fp32 weights
               on the host and run them on the CPU); (b) drains at full
               width, bf16, weights drawn on the card: granite (24
               layers, paged) and starcoder2-7b (32 layers, paged then
               contiguous) with phase 7's 16 requests, qwen1.5-32b (8
               layers, paged), command-r-plus-104b (4 layers,
               contiguous) and deepseek-v2-236b (3 layers: one dense,
               two MoE of 160 experts; contiguous, MLA: no port kernel)
               with 8 of them; each drain's counts zeroed before it and
               read after, the layout's two kernels launched and no
               other; decode ms/tick, tokens/s, TTFT and launches printed;
               (c) kernels 5-8 at the new heads (D 64 G 2; D 128 G 9 with
               the 4096 window, G 1, G 12) against their plain versions
               (fp32 TIGHT, bf16 LOOSE) and timed beside SDPA and the
               bound.
 17. enc/VLM   the encoder-decoder (whisper-base) and the VLM
               (internvl2-2b): (a) card vs CPU, fp32, as phase 8 (whisper
               at full width and depth, contiguous; internvl2 at full
               width, 2 layers, both layouts; whisper's teacher-forced
               logits read the zero cross K/V of a fresh cache, as the
               engine serves it), then ``prefill`` of 2 rows with frames
               (2, 1500, 512) or a 300-token prompt over 256 patches and 8
               teacher-forced decode steps: logits within TOKEN_TOL, argmax
               equal; (b) full width and depth, bf16, weights drawn on the
               card: whisper-base ``prefill`` of 8 x 16 tokens with frames
               (8, 1500, 512), then 32 ``decode_step``s (the encoder's ms,
               prefill ms, decode ms/step); internvl2-2b ``prefill`` of 4 x
               320 tokens over 256 patches, then 32 steps; each with its
               launches zeroed before and required equal to what its
               layers call; then phase 7's traffic through ``ServeEngine``
               (whisper contiguous, internvl2 paged and contiguous) as
               phase 16 (b); (c) kernel 7 with ``causal=False`` at
               whisper's encoder shape (B 8, S = C = 1500, 8 heads of 64,
               positions 0..1499) and cross-attention shapes (S 1 and 128
               over 1500 keys, every position 0) against its plain version
               (fp32 TIGHT, bf16 LOOSE, repeat bitwise, one launch a call,
               counters at 0), its rows, split and resources, a sweep of
               rows x keys per split up to one split over the 1500 keys,
               and its time beside SDPA and the bound; at S 1 the decode
               kernel on the same inputs (every position 0: the same
               function); kernels 5-8 at internvl2's heads (D 128, G 2) as
               16 (c).  The ``kernels`` line's attention launches are
               phase 7's plus the drains and paths of phases 16-17.
 18. training  the port's training path (``train/``, ``launch/train.py``,
               ``launch/elastic.py``), which launches no hand kernel (the
               reference trains through its plain path: no Pallas kernel
               has a VJP): (a) card vs CPU, fp32, weights drawn on the
               host: starcoder2-3b at full width and 2 layers, gradients
               of ``make_loss_and_grad`` and one ``make_train_step`` step
               (grad_accum 2, remat full) on a 4 x 128 ``lm_batches``
               batch: loss rtol 1e-5, ``grad_norm`` rtol 1e-4, every
               gradient element within TRAIN_GRAD_TOL (1e-6) of the
               global norm, updated parameters within TRAIN_ATOL (5% of
               lr) wherever the gradient decides Adam's step (|g| above a
               floor set by the CPU's norm, eps and the two tolerances;
               below it the step is lr times the sign of rounding noise,
               and the gradient check holds those elements), every
               parameter finite; then each of the ten archs at
               ``reduced()`` with frames or patches, one step each under
               the same rule; (b) starcoder2-3b at full width and depth
               (3.03 B parameters, bf16, fp32 moments) through the train
               launcher's ``main`` (``launch.train``: parameters drawn on
               the card, ``device_prefetch``, async checkpoints): 20 steps
               of 8 x 512 tokens (grad_accum 2, ``--set remat=full``, lr
               3e-4, the launcher's warmup of steps // 5 = 4) with a
               checkpoint every 10: ms/step (median of steps 3-20),
               tokens/s, peak memory, loss at steps 0 and 19, model
               TFLOP/s counted as 8 N tokens (forward, recompute,
               backward), each checkpoint's host snapshot and write
               seconds; the step-20 checkpoint restored onto the card
               equal to the final parameters bit for bit; step 10's
               checkpoint removed (two on disk at a time), ``--resume``
               for 2 more steps (a blocking save of step 22); then 6 steps
               at the launcher's default, remat none (ms/step and peak, or
               that it does not fit); fails unless every loss and grad
               norm is finite, the loss falls, the resume starts at step
               20 and ends at 22, and no hand kernel launched; (c)
               ``launch.elastic.run_supervised`` on ``python -m
               repro_torch.launch.train --reduced --steps 60 --batch 8
               --seq 32 --ckpt-every 10 --kill-at-step 25`` on the card:
               0 after exactly one restart (``max_restarts`` 1), latest
               checkpoint 60; ``examples/torch_train_tiny_lm.py --steps
               50`` with its loss falling; (d) each of the six token
               kernels' entry points (kernels 5-10), given CUDA inputs
               that require grad under grad mode, raises; under
               ``torch.no_grad()`` it launches once and equals its plain
               version.  Repeats of (b) are not claimed bitwise: the
               embedding's backward accumulates with atomics.
  19. multi-device layer on one card (one NCCL rank: NCCL cannot put
               two ranks on one card).  (a) starcoder2-3b at full width and
               depth, B 8 x S 512, grad_accum 2, remat none: ``make_train_
               step`` on plain tensors, then with parameters, moments and
               batches DTensors on a (1, 1) ``("data", "model")``
               ``DeviceMesh``, 4 steps each from one seed: the first
               step's loss within 1e-5 relative and grad norm within 1e-4
               of the plain step's, ms/step (median of steps 2-4) and peak
               memory of each, no hand kernel launched; (b) ``HW_H100``
               against ``torch.cuda.get_device_properties``: the name, the
               capacity within 5 % (the datasheet's "80 GB" counts GiB)
               and 132 SMs; (c) ``roofline.estimate_memory_per_device``
               against phase 18 (b)'s and (a)'s measured peaks, the ratio
               printed (not held); (d) the dry-run's starcoder2-3b
               ``train_4k`` on the 256-rank ``single`` mesh and
               deepseek-v2-236b ``decode_32k`` on the 512-rank ``multi``
               mesh at full width, in a fake world in a subprocess started
               before (a), both ``ok``: per-device FLOPs, bytes and
               collective bytes, the dominant term, wall seconds; (e)
               ``int8_psum`` and a two-microbatch pipeline on the world of
               one, a one-replica fleet with ``fleet_mode="shard_map"``
               equal to ``vmap`` and serial (digests), and a two-replica
               replica mesh refused, naming the card count.

TF32 is turned off for cuDNN and matmuls here (the library modules set no
global flags): the flags and the sampled tokens are threshold and argmax
decisions, and TF32 rounding could flip them between the card and the CPU.

The last lines are: the card's name and power limit, one JSON object with
a ``kernels`` list of all ten kernels (launches on the main paths, errors,
times, bounds), and
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM, bf16 tensor cores, dense
TIGHT = dict(rtol=2e-5, atol=2e-5)  # tests/kernel_harness.py TIGHT
LOOSE = dict(rtol=2e-2, atol=2e-2)  # tests/kernel_harness.py LOOSE

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
TIER_RES = (48, 32, 16)               # tiers' model resolutions (gate 32)
ROWS_SWEEP = (1, 2, 4)                # model rows an ingest thread holds
VISION_REGS = {}                      # (kernel, dtype): ptxas registers
ATTN_REPLACES = {
    "paged_decode": "src/repro/kernels/paged_attention.py:49",
    "paged_flash": "src/repro/kernels/paged_attention.py:142",
    "flash": "src/repro/kernels/flash_attention.py:35",
    "decode": "src/repro/kernels/decode_attention.py:26",
}
ATTN_SOURCES = {
    "paged_decode": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "paged_flash": "src/repro_torch/kernels/csrc/attention.cu",
    "flash": "src/repro_torch/kernels/csrc/attention.cu",
    "decode": "src/repro_torch/kernels/csrc/decode_attention.cu",
}
SPLIT_SWEEP = (64, 128, 256)          # keys per split, decode kernels
DECODE_REGS = {}                      # (dtype, source, D): ptxas registers
FLASH_SWEEP = ((64, 128), (128, 256, 512))  # rows x keys per split
FLASH_REGS = {}                       # (dtype, source, D, rows): registers
REC_REPLACES = {
    "rglru_scan": "src/repro/kernels/rglru.py:29",
    "mlstm_chunkwise": "src/repro/kernels/mlstm.py:36",
}
REC_SOURCE = "src/repro_torch/kernels/csrc/recurrent.cu"
MLSTM_TOL = dict(rtol=3e-4, atol=3e-4)  # tests/test_kernels.py's mLSTM limit
MLSTM_CHUNK = 128                       # kernels/mlstm.py DEFAULT_CHUNK
RGLRU_SWEEP = (16, 32, 64)              # channels per block, RG-LRU
REC_REGS = {}                           # recurrent.cu instance: registers

# the token main path: starcoder2-3b as served by ServeEngine
TOK_SLOTS, TOK_CAPACITY, TOK_CHUNK, TOK_BLOCK = 8, 2048, 128, 16
TOK_REQUESTS, TOK_NEW, TOK_PROMPT = 16, 32, (33, 1000)
TOK_SEED = 0
# card vs CPU at reduced depth (fp32): teacher-forced last-position logits
# must agree within TOKEN_TOL; fp32 sums in another order differ ~1e-5
TOKEN_TOL = 1e-3
CPU_REQUESTS, CPU_NEW, CPU_PROMPT = 4, 16, (17, 200)
# xlstm-350m: prefill batch, then greedy steps; then a ServeEngine drain
XL_PREFILL, XL_STEPS = (4, 512), 16
XL_REQUESTS, XL_NEW, XL_PROMPT = 8, 16, (16, 128)
# phase 13: the fleet scenarios.  The reference package's digests of the
# scenarios whose traces read no model output, so the card's run must give
# them whatever its weights (tests/test_torch_simulate.py holds these two
# against the reference; golden_churn's is read from its golden file)
GOLDEN_CHURN = "tests/golden/fleet_scenario_v1.json"
PALLAS_INGEST_DIGEST = ("d783006ca518cbf8d2603a281bf29cd57b8e4266"
                        "bc0e901dad46fbfaacd3f98f")
MIXED_SERVING_DIGEST = ("0951a09931cc2565c9b1775c96056161c2fba7a4"
                        "482624fb61aff00d365ee13c")
# (e): golden_churn's traffic at the main path's geometry (FRAME_RES,
# INPUT_RES) for FULL_TICKS ticks on the card and on the CPU.  The CPU half
# must stay near a minute at most: 30 ticks took 1.8 s on the 8-core host
# of an H100, so the scenario keeps its whole 150 ticks
FULL_SLOTS, FULL_VEHICLES, FULL_TICKS = 16, 16, 150
# phase 14: the full-size cell's digest (card = CPU in 13 (e); the CPU's
# serial and fused runs give it too), and (d)'s width: replicas, and the
# initial and most vehicles, each 4x (e)'s
FULL_DIGEST = ("48b9bddad799edf3b18b518980b51f95"
               "b06fb1063af03286d493252a931ca3a9")
WIDE_REPLICAS, WIDE_INITIAL, WIDE_VEHICLES = 8, 12, 64
FLAT_R = 4                                # (a): replicas of SLOTS // 2
# phase 15: the ledger digest of examples/quickstart.py's case study (3
# phones, 2 s videos, 50 pairs) through SimExecutor, the reference's too
# (tests/test_torch_runtime.py pins both to this constant)
CASE_STUDY_DIGEST = ("08acd776db08d50cdecf32f23f5f80e9"
                     "7a739924056e020b4d83ab290392c822")
# (b): the real executor's run; the CPU checks the first EDA_CHECKED pairs'
# flags; (c): frame pairs through device_prefetch
EDA_FPS, EDA_PAIRS, EDA_CHECKED, PREFETCH_BATCHES = 30, 8, 2, 32
# phase 16: kernels 5-8 at the new configs' heads (q heads, kv heads, D,
# window, the kernels their drains launch)
NEW_HEADS = {
    "granite-moe-1b-a400m's heads (G 2)": (16, 8, 64, 0,
                                           ("paged_decode", "paged_flash")),
    "starcoder2-7b's heads (G 9)": (36, 4, 128, 4096,
                                    ("paged_decode", "paged_flash", "flash",
                                     "decode")),
    "qwen1.5-32b's heads (G 1)": (40, 40, 128, 0,
                                  ("paged_decode", "paged_flash")),
    "command-r-plus-104b's heads (G 12)": (96, 8, 128, 0,
                                           ("flash", "decode")),
}
# (a): card vs CPU at 2 layers, fp32: (arch, layouts, reduced width);
# (b): drains at full width: (arch, layers or None for full depth,
# layouts, requests)
NEW_CPU = (("granite-moe-1b-a400m", (True,), False),
           ("starcoder2-7b", (True,), False),
           ("qwen1.5-32b", (True,), True),
           ("command-r-plus-104b", (False,), True),
           ("deepseek-v2-236b", (False,), True))
NEW_DRAINS = (("granite-moe-1b-a400m", None, (True,), TOK_REQUESTS),
              ("starcoder2-7b", None, (True, False), TOK_REQUESTS),
              ("qwen1.5-32b", 8, (True,), 8),
              ("command-r-plus-104b", 4, (False,), 8),
              ("deepseek-v2-236b", 3, (False,), 8))
# phase 17: the encoder-decoder (whisper-base) and the VLM (internvl2-2b).
# (a) card vs CPU, fp32: (arch, layers, layouts) served as phase 8, then
# prefill of FAM_CPU_B rows with frames or patches (internvl2: a
# FAM_CPU_PROMPT-token prompt over its 256 patches) and FAM_CPU_STEPS
# teacher-forced decode steps; (b) full width and depth, bf16: whisper
# prefill of WH_B rows of WH_PROMPT tokens with (WH_B, 1500, 512) frames,
# then WH_STEPS decode steps; internvl2 prefill of VL_B rows of VL_PROMPT
# tokens over 256 patches, then VL_STEPS decode steps; then phase 7's
# traffic through ServeEngine (whisper contiguous, internvl2 both layouts)
FAM_CPU = (("whisper-base", 6, (False,)), ("internvl2-2b", 2, (True, False)))
FAM_CPU_B, FAM_CPU_PROMPT, FAM_CPU_STEPS = 2, 300, 8
WH_B, WH_PROMPT, WH_STEPS = 8, 16, 32
VL_B, VL_PROMPT, VL_STEPS = 4, 320, 32
FAM_DRAINS = (("whisper-base", (False,)), ("internvl2-2b", (True, False)))
# (c): kernel 7 not causal at whisper's shapes (B, S, C, heads, D, the
# positions: the encoder's 0..C-1, cross-attention's 0), and kernels 5-8 at
# internvl2's heads
ENC_SHAPES = {"whisper encoder (S = C = 1500)": (8, 1500, 1500, 8, 64,
                                                 "arange"),
              "whisper cross, a decode step (S 1)": (8, 1, 1500, 8, 64,
                                                     "zeros"),
              "whisper cross, a prefill chunk (S 128)": (8, 128, 1500, 8, 64,
                                                         "zeros")}
ENC_KEYS_SWEEP = (128, 256, 512, 1536)   # 1536: one split over 1500 keys
VLM_HEADS = {
    "internvl2-2b's heads (G 2)": (16, 8, 128, 0,
                                   ("paged_decode", "paged_flash", "flash",
                                    "decode")),
}

# phase 18: training.  (a) card vs CPU at full width, TRAIN_CPU_LAYERS
# layers, fp32; then every arch at reduced(); (b) full width and depth, bf16
TRAIN_ARCH = "starcoder2-3b"
TRAIN_CPU_LAYERS, TRAIN_CPU_B, TRAIN_CPU_S = 2, 4, 128
TRAIN_LR = 1e-3                         # (a): one step at this lr
TRAIN_GRAD_TOL = 1e-6                   # gradient elements / global norm
# updated parameters, card vs CPU: within TRAIN_ATOL wherever the gradient
# decides Adam's step.  A first step is lr * u(g), u(g) = g / (|g| + eps')
# with eps' = eps / clip scale, and |u'(g)| <= eps' / g^2, so a gradient
# difference within TRAIN_GRAD_TOL x the norm moves it by at most
# TRAIN_ATOL where g^2 >= eps' TRAIN_GRAD_TOL norm lr / TRAIN_ATOL: that
# floor comes from the CPU's norm alone.  Below it (a gradient within a
# few eps' of 0, as the k bias's, whose exact gradient is 0) the step is
# lr times the sign of rounding noise: there the gradient check holds
TRAIN_ATOL = 0.05 * TRAIN_LR
TRAIN_ARCH_B, TRAIN_ARCH_S = 4, 16      # (a) at reduced()
TRAIN_ACCUM = 2
# (b): the train launcher at full width and depth; 20 steps with a
# checkpoint every 10, then a resume for 2 more, then remat none
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_RESUMED = 8, 512, 20, 2
TRAIN_NONE_STEPS = 6
TRAIN_FULL = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_B), "--seq",
              str(TRAIN_S), "--grad-accum", str(TRAIN_ACCUM), "--lr", "3e-4",
              "--log-every", "1"]
TRAIN_ELASTIC = ["--arch", "starcoder2-3b", "--reduced", "--steps", "60",
                 "--batch", "8", "--seq", "32", "--ckpt-every", "10",
                 "--kill-at-step", "25"]

# phase 19: the multi-device layer on one card.  (a) the DTensor train step
# on a one-rank NCCL (1, 1) mesh vs the plain step, phase 18 (b)'s cell at
# remat none, MD_STEPS steps each; (d) two dry-run cells at full width in a
# fake world, run in a subprocess beside (a)-(c)
MD_STEPS = 4
MD_DRYRUN = (("starcoder2-3b", "train_4k", "single"),
             ("deepseek-v2-236b", "decode_32k", "multi"))
MD_DRYRUN_TIMEOUT_S = 240


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
    """Median device time of one call of ``fn`` with a cold L2.  Before
    each call a 1 GiB buffer is zeroed: that evicts the inputs from L2, so
    the call reads them from HBM as the bound assumes, and it keeps the
    card busy while the host enqueues the call, so the CUDA events around
    the call time the device and not the launch.  The median, not the
    mean: a host stalled past the zeroing (~0.35 ms) leaves the card idle
    between the events, and one such call moved a 0.02 ms mean 2.4x."""
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
    return statistics.median(s.elapsed_time(e) for s, e in marks)


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


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of their type (fp32 by default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, exact: bool = False, tol=TIGHT) -> float:
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
        torch.testing.assert_close(g.float(), w.float(), **tol)
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

    # ingest_frame: main-path shape, then uint8 / box / g=20 edges, the
    # tiers' model resolutions under gate 32 (their gate rows are not
    # among the model's), a uint8 row of 60 bytes (the kernel's scalar
    # path); every case also bitwise equal to the plain model of the
    # kernel's arithmetic and to a second call
    kw = dict(model_res=m, gate_res=g, block=BLOCK)

    def ingest_case(f, r, exact, **kwargs):
        got = vo.ingest_frame(f, r, **kwargs)
        want = vo.ingest_frame_plain(f, r, **kwargs)
        err = max_err(got, want)
        if exact:                       # nearest model/gate frames
            max_err(got[:2], want[:2], exact=True)
        if not all(map(torch.equal, got, vo.ingest_blocks_plain(
                f, r, **kwargs))):
            fail(f"ingest_frame {tuple(f.shape)} {kwargs}: not bitwise "
                 f"equal to ingest_blocks_plain")
        if not all(map(torch.equal, got, vo.ingest_frame(f, r, **kwargs))):
            fail(f"ingest_frame {tuple(f.shape)} {kwargs}: two calls differ")
        errs["ingest_frame"] = max(errs["ingest_frame"], err)

    for f, method in ((frames, "nearest"), (frames_u8, "nearest"),
                      (frames, "box"), (frames_u8, "box")):
        ingest_case(f, refs, method == "nearest", method=method, **kw)
    refs20 = rand(S, 20, 20, 3)
    small = rand(4, 64, 64, 3)
    for f, r, kw20 in ((frames, refs20, dict(model_res=m, gate_res=20)),
                       (small, refs20[:4], dict(model_res=48, gate_res=20))):
        ingest_case(f, r, True, block=8, **kw20)
    for res in TIER_RES:
        ingest_case(frames, refs, True, model_res=res, gate_res=g,
                    block=BLOCK)
    narrow = rand(4, 20, 20, 3, dtype=torch.uint8)
    for method in ("nearest", "box"):
        ingest_case(narrow, refs20[:4, :10, :10].contiguous(),
                    method == "nearest", model_res=16, gate_res=10, block=4,
                    method=method)
    print(f"ingest_frame: nearest frames bit-identical to plain, scores "
          f"within TIGHT, all bitwise equal to ingest_blocks_plain and to a "
          f"second call, at S {S} 256 px fp32/uint8 nearest/box -> {m}/{g} "
          f"and -> {m}/20, tiers {TIER_RES}/{g}, uint8 20 px -> 16/10",
          flush=True)

    # downscale: gateless (-> model res) and gate (-> gate res) shapes, the
    # ingest's model rows alone: bitwise equal to its model, to a second
    # call and to ingest_frame's frames at the same resolution.
    # block_sad: the ingest's gate score alone: on ingest_frame's own gate
    # frame, bitwise its score
    for f in (frames, frames_u8):
        x = vo.normalize_plain(f)
        for method in ("nearest", "box"):
            fused = vo.ingest_frame(f, refs, method=method, **kw)
            for res, want in ((m, fused[0]), (g, fused[1])):
                got = vo.downscale(f, res, method=method)
                errs["downscale"] = max(errs["downscale"], max_err(
                    got, vo.downscale_plain(f, res, method=method),
                    exact=method == "nearest"))
                for other, what in (
                        (vo._resample_rows(x, res, method), "its model"),
                        (vo.downscale(f, res, method=method), "a second call"),
                        (want, "ingest_frame's frame")):
                    if not torch.equal(got, other):
                        fail(f"downscale {f.dtype} {method} -> {res}: not "
                             f"bitwise equal to {what}")
            if not torch.equal(vo.block_sad(refs, fused[1], BLOCK), fused[2]):
                fail(f"block_sad on ingest_frame's gate frame ({f.dtype} "
                     f"{method}) is not bitwise its score")
    print(f"downscale: nearest bit-identical to plain, box within TIGHT, "
          f"bitwise equal to _resample_rows, to a second call and to "
          f"ingest_frame's frames, at S {S} 256 px fp32/uint8 nearest/box -> "
          f"{m} and {g}; block_sad on ingest_frame's gate frames bitwise "
          f"its scores", flush=True)

    # block_sad: gate shape, and partial edge blocks (20 and 30 with 8)
    for hw in (g, 20, 30):
        a, b = rand(S, hw, hw, 3), rand(S, hw, hw, 3)
        got = vo.block_sad(a, b, BLOCK)
        errs["block_sad"] = max(errs["block_sad"], max_err(
            got, vo.block_sad_plain(a, b, BLOCK)))
        if not (torch.equal(got, vo.sad_blocks_plain(a, b, BLOCK))
                and torch.equal(got, vo.block_sad(a, b, BLOCK))):
            fail(f"block_sad {hw} px: not bitwise equal to sad_blocks_plain "
                 f"and a second call")
    _, gate20, score20 = vo.ingest_frame(frames, refs20, model_res=m,
                                         gate_res=20, block=BLOCK)
    if not torch.equal(vo.block_sad(refs20, gate20, BLOCK), score20):
        fail("block_sad on ingest_frame's 20 px gate frame is not bitwise "
             "its score")
    print(f"block_sad: within TIGHT of plain, bitwise equal to "
          f"sad_blocks_plain and a second call at {g}/20/30 px", flush=True)

    # scatter_admit: f32 and bf16 pools, gated refs and the gateless (1x1),
    # the frugal tier's rows, a row of 75 elements (not 16-byte units)
    admit = torch.rand(S, generator=rng, device=dev) < 0.5
    model, gate = rand(S, m, m, 3), rand(S, g, g, 3)
    null = torch.zeros(S, 1, 1, 3, device=dev)
    for pool in (torch.float32, torch.bfloat16):
        for res in (m, 16, 5):
            batch, mod = rand(S, res, res, 3).to(pool), rand(S, res, res, 3)
            for r, gt in ((refs, gate), (null, null)):
                max_err(vo.scatter_admit(batch, mod, r, gt, admit),
                        vo.scatter_admit_plain(batch, mod, r, gt, admit),
                        exact=True)
    torch.cuda.synchronize()
    print(f"scatter_admit: bit-identical to plain, fp32 and bf16 pools of "
          f"{m}/16/5 px, refs {g} px and the 1x1 null refs", flush=True)

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
    # downscale at gate size (MotionGate.admit's shape)
    ys_g = torch.arange(g, device=dev) * H // g
    nbytes = (S * pixels_read(H, H, (g,), "nearest") * pix * f4
              + S * g * g * pix * f4)
    print(f"kernel downscale -> {g} (MotionGate.admit): cold L2: kernel "
          f"{time_ms(lambda: vo.downscale(frames, g)):.4f} ms  plain "
          f"{time_ms(lambda: vo.downscale_plain(frames, g)):.4f} ms  library "
          f"{time_ms(lambda: frames[:, ys_g[:, None], ys_g[None, :]]):.4f} "
          f"ms  bound {bound(nbytes, 0)[0] * 1e3:.2f} us "
          f"({nbytes / 1e6:.3f} MB)", flush=True)
    vision_geometry(torch, vo, frames, refs, batch, model, gate, admit, kw)
    # the frugal tier: model 16 under gate 32 into a bf16 pool
    lo = 16
    pool16, model16 = rand(S, lo, lo, 3).to(torch.bfloat16), rand(S, lo, lo, 3)
    kw16 = dict(model_res=lo, gate_res=g, block=BLOCK)
    for name, kern, plain, nbytes in (
            ("ingest_frame", lambda: vo.ingest_frame(frames, refs, **kw16),
             lambda: vo.ingest_frame_plain(frames, refs, **kw16),
             S * pixels_read(H, H, (lo, g), "nearest") * pix * f4
             + 2 * S * g * g * pix * f4 + S * lo * lo * pix * f4 + S * f4),
            ("scatter_admit",
             lambda: vo.scatter_admit(pool16, model16, refs, gate, admit),
             lambda: vo.scatter_admit_plain(pool16, model16, refs, gate,
                                            admit),
             S * (lo * lo * pix * (4 + 2) + 2 * g * g * pix * f4) + S)):
        print(f"kernel {name} frugal tier ({lo}/{g}, bf16 pool): cold L2: "
              f"kernel {time_ms(kern):.4f} ms  plain {time_ms(plain):.4f} ms"
              f"  bound {bound(nbytes, 0)[0] * 1e3:.2f} us "
              f"({nbytes / 1e6:.3f} MB)", flush=True)
    rows_sweep(vo, frames, refs, kw)
    return rows


def vision_report(log: str) -> dict:
    """{(kernel, dtype): (registers, spill bytes)} of the vision_ops.cu
    kernels in an ``-Xptxas -v`` report."""
    pat = (r"Compiling entry function '\S*?(ingest_kernel|scatter_rows_kernel"
           r"|downscale_kernel|score_kernel)(?:I(h|f|13__nv_bfloat16)E)?")
    names = {"h": "u8", "f": "f32", "13__nv_bfloat16": "bf16", None: "f32"}
    return ptxas_entries(log, pat, lambda m: (m.group(1), names[m.group(2)]))


def vision_geometry(torch, vo, frames, refs, batch, model, gate, admit, kw):
    """Print each vision kernel's launch at the main path's shapes (grid,
    block, shared memory, registers) and fail unless two calls are bitwise
    equal."""
    S, H, W, C = frames.shape
    p = vo.ingest_plan(S, H, W, C, kw["model_res"], kw["gate_res"],
                       kw["block"])
    if not all(map(torch.equal, vo.ingest_frame(frames, refs, **kw),
                   vo.ingest_frame(frames, refs, **kw))):
        fail("ingest_frame: two calls on the same inputs differ")
    print(f"kernel ingest_frame {tuple(frames.shape)} fp32 -> "
          f"{kw['model_res']}/{kw['gate_res']}: grid {p['grid']} = "
          f"{p['blocks']} blocks of {p['block']} threads ({S} gate blocks, "
          f"{p['rows']} model rows a thread, {p['units']} 16-byte units a "
          f"row), {p['smem']} B dynamic shared memory, vector path "
          f"{p['model_vec']}, {VISION_REGS.get(('ingest_kernel', 'f32'))} "
          f"(registers, B spilled); two calls bitwise equal", flush=True)
    q = vo.scatter_plan(S, batch[0].numel(), refs[0].numel(), batch.dtype)
    if not all(map(torch.equal, vo.scatter_admit(batch, model, refs, gate,
                                                 admit),
                   vo.scatter_admit(batch, model, refs, gate, admit))):
        fail("scatter_admit: two calls on the same inputs differ")
    print(f"kernel scatter_admit {tuple(batch.shape)} fp32 pool: grid "
          f"{q['grid']} = {q['blocks']} blocks of {q['threads']} threads, "
          f"{q['batch_units']} 16-byte units a pool row, {q['refs_units']} a "
          f"refs row, vector paths pool {q['batch_vec']} refs "
          f"{q['refs_vec']}, "
          f"{VISION_REGS.get(('scatter_rows_kernel', 'f32'))} (registers, B "
          f"spilled); two calls bitwise equal", flush=True)
    for res in (kw["model_res"], kw["gate_res"]):
        d = vo.downscale_plan(S, H, W, C, res)
        if not torch.equal(vo.downscale(frames, res), vo.downscale(frames,
                                                                   res)):
            fail(f"downscale -> {res}: two calls on the same inputs differ")
        print(f"kernel downscale {tuple(frames.shape)} fp32 -> {res}: grid "
              f"{d['grid']} = {d['blocks']} blocks of {d['block']} threads "
              f"({d['rows']} rows a thread, {d['units']} 16-byte units a "
              f"row), no shared memory, "
              f"{VISION_REGS.get(('downscale_kernel', 'f32'))} (registers, B "
              f"spilled); two calls bitwise equal", flush=True)
    q = vo.sad_plan(S, kw["gate_res"], kw["gate_res"], C, kw["block"])
    if not torch.equal(vo.block_sad(refs, gate, kw["block"]),
                       vo.block_sad(refs, gate, kw["block"])):
        fail("block_sad: two calls on the same inputs differ")
    print(f"kernel block_sad {tuple(gate.shape)}: grid {q['grid']} = "
          f"{q['blocks']} blocks of {q['threads']} threads, {q['tiles']} "
          f"tiles a stream, {q['smem']} B dynamic shared memory, "
          f"{VISION_REGS.get(('score_kernel', 'f32'))} (registers, B "
          f"spilled); two calls bitwise equal", flush=True)


def rows_sweep(vo, frames, refs, kw):
    """Cold-L2 time of ingest_frame at each model rows a thread of
    ROWS_SWEEP, each setting first held against the plain version (nearest
    frames bit-exact, the score within TIGHT); the default restored
    after."""
    want = vo.ingest_frame_plain(frames, refs, **kw)
    default, cells = vo.ROWS_PER_THREAD, []
    try:
        for rows in ROWS_SWEEP:
            vo.ROWS_PER_THREAD = rows
            got = vo.ingest_frame(frames, refs, **kw)
            max_err(got[:2], want[:2], exact=True)
            max_err(got[2], want[2])
            ms = time_ms(lambda: vo.ingest_frame(frames, refs, **kw))
            cells.append(f"{rows}: {ms:.4f}")
    finally:
        vo.ROWS_PER_THREAD = default
    print(f"kernel ingest_frame {tuple(frames.shape)}: model rows a thread "
          f"-> cold-L2 ms  " + "  ".join(cells) + f" (default {default}; each "
          f"setting held against plain first)", flush=True)


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


# ---------------------------------------------------------------------------
# phase 6: attention kernels
# ---------------------------------------------------------------------------


def attn_case(torch, gen, dev, lens, S, Hq, Hkv, D, bs, M, dtype, nb=None,
              C=None):
    """One input set for all four attention kernels: a shuffled block pool
    holding row b's positions 0..lens[b]-1 (garbage values elsewhere,
    garbage positions in unreferenced blocks, -1 past each row's length,
    table columns past it -1), the same KV as a contiguous (B, C) cache
    (positions -1 past each length), and S queries per row at its last S
    positions.  Drawn on the host from ``gen``, then moved."""
    B = len(lens)
    ncols = [max(1, -(-L // bs)) for L in lens]
    nb = nb or sum(ncols) + 3
    C = C or max(ncols) * bs
    perm = torch.randperm(nb, generator=gen)
    kp = torch.randn(nb, bs, Hkv, D, generator=gen)
    vp = torch.randn(nb, bs, Hkv, D, generator=gen)
    ppos = torch.randint(0, max(lens) + 4, (nb, bs), generator=gen,
                         dtype=torch.int32)
    tbl = torch.full((B, M), -1, dtype=torch.int32)
    k = torch.randn(B, C, Hkv, D, generator=gen)
    v = torch.randn(B, C, Hkv, D, generator=gen)
    kv_pos = torch.full((B, C), -1, dtype=torch.int32)
    take = 0
    for b, L in enumerate(lens):
        blocks = perm[take: take + ncols[b]]
        take += ncols[b]
        tbl[b, :ncols[b]] = blocks.int()
        p = torch.arange(ncols[b] * bs)
        flat = blocks[p // bs] * bs + p % bs
        kp.view(-1, Hkv, D)[flat[:L]] = k[b, :L]
        vp.view(-1, Hkv, D)[flat[:L]] = v[b, :L]
        ppos.view(-1)[flat] = torch.where(p < L, p, -1).int()
        kv_pos[b, :L] = torch.arange(L, dtype=torch.int32)
    q = torch.randn(B, S, Hq, D, generator=gen)
    q_pos = torch.stack([torch.arange(L - S, L) for L in lens]).int()
    out = dict(q=q, k=k, v=v, kp=kp, vp=vp, ppos=ppos, tbl=tbl, q_pos=q_pos,
               kv_pos=kv_pos)
    return {n: (t.to(dev, dtype) if t.is_floating_point() else t.to(dev))
            for n, t in out.items()}


def attn_calls(c, window=0):
    """{kernel name: (kernel call, plain call)} for the case's S."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import paged_attention as pa_k
    pool = (c["q"], c["kp"], c["vp"], c["ppos"], c["tbl"], c["q_pos"])
    dense = (c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
    if c["q"].shape[1] == 1:
        return {
            "paged_decode": (
                lambda: pa_k.paged_decode_attention(*pool, window=window),
                lambda: pa_k.paged_decode_attention_plain(*pool,
                                                          window=window)),
            "decode": (
                lambda: dec_k.decode_attention(*dense, window=window),
                lambda: dec_k.decode_attention_plain(*dense, window=window)),
        }
    return {
        "paged_flash": (
            lambda: pa_k.paged_flash_attention(*pool, window=window),
            lambda: pa_k.paged_flash_attention_plain(*pool, window=window)),
        "flash": (
            lambda: fa_k.flash_attention(*dense, window=window),
            lambda: fa_k.flash_attention_plain(*dense, window=window)),
    }


def attn_work(torch, q, q_pos, kv_pos, Hkv, window=0, table_bytes=0,
              causal=True):
    """(bytes, flops) the function needs on these inputs: each live K/V
    entry (one some query of its row attends) read once per kv head with
    its position, q read and the output written once, the table; 4*D
    operations per valid (query row, head, key)."""
    B, S, Hq, D = q.shape
    kp_, qp_ = kv_pos[:, None, :].long(), q_pos[:, :, None].long()
    valid = (kp_ >= 0) & ((kp_ <= qp_) if causal else (qp_ == qp_))
    if window:
        valid &= (qp_ - kp_) < window
    live = int(valid.any(dim=1).sum())
    pairs = int(valid.sum())
    item = q.element_size()
    nbytes = (live * (Hkv * D * 2 * item + 4) + 2 * q.numel() * item
              + q_pos.numel() * 4 + table_bytes)
    return nbytes, 4 * D * Hq * pairs, valid


def ptxas_entries(log: str, pat: str, key_of) -> dict:
    """{key_of(match): (registers, spill bytes)} of each kernel instance
    whose entry line in an ``-Xptxas -v`` report matches ``pat``."""
    import re
    out, key, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(pat, line)
        if m:
            key = key_of(m)
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[key] = (int(m.group(1)), spill)
            key = None
    return out


def ptxas_report(log: str, kernel: str = "decode") -> dict:
    """{(dtype, source, D[, rows]): (registers, spill bytes)} of the
    ``decode_kernel`` or ``flash_kernel`` instances in an ``-Xptxas -v``
    report (the flash kernels' key ends with their rows per block)."""
    srcs = {"decode": ("PagedKV", "ContigKV"),
            "flash": ("PagedSrc", "ContigSrc")}[kernel]
    pat = (rf"Compiling entry function '\S*{kernel}_kernelI"
           rf"(13__nv_bfloat16|f)\S*?({srcs[0]}|{srcs[1]})\S*?Li(\d+)E"
           + (r"Li(\d+)E" if kernel == "flash" else ""))
    return ptxas_entries(log, pat, lambda m: (
        "bf16" if m.group(1) != "f" else "f32",
        "paged" if m.group(2) == srcs[0] else "contiguous",
        *map(int, m.groups()[2:])))


def decode_report(torch, name, c, kern, capacity, label):
    """Print a decode call's split, grid and per-block resources, and fail
    unless two calls are bitwise equal."""
    from repro_torch.kernels import attention_common as ac
    B, _, Hq, D = c["q"].shape
    Hkv = c["k"].shape[2]
    split_keys, splits = ac.decode_split(capacity)
    tiles = -(-(Hq // Hkv) // ac.ROWS)
    smem = ac.decode_smem_bytes(D, c["q"].dtype, split_keys)
    dt = "bf16" if c["q"].dtype == torch.bfloat16 else "f32"
    regs, spill = DECODE_REGS.get(
        (dt, "paged" if name.startswith("paged") else "contiguous", D),
        (None, None))
    first, second = kern(), kern()
    if not torch.equal(first, second):
        fail(f"{name} {label}: two calls on the same inputs differ")
    print(f"kernel {name} {label}: {splits} splits of {split_keys} keys over "
          f"capacity {capacity}; grid ({splits}, {Hkv * tiles}, {B}) = "
          f"{splits * Hkv * tiles * B} blocks of 128 threads, {smem} B "
          f"dynamic shared memory, {regs} registers ({spill} B spilled) per "
          f"block; two calls bitwise equal", flush=True)


def split_sweep(torch, name, kern, label):
    """Cold-L2 time of a decode call at each keys-per-split of
    SPLIT_SWEEP (the default restored after)."""
    from repro_torch.kernels import attention_common as ac
    default, times = ac.SPLIT_KEYS, {}
    try:
        for keys in SPLIT_SWEEP:
            ac.SPLIT_KEYS = keys
            times[keys] = time_ms(kern)
    finally:
        ac.SPLIT_KEYS = default
    print(f"kernel {name} {label}: keys per split -> cold-L2 ms "
          + "  ".join(f"{k}: {t:.4f}" for k, t in times.items())
          + f" (default {default})", flush=True)


def flash_report(torch, name, c, kern, capacity, label):
    """Print a flash call's rows per block, split, grid and per-block
    resources, and fail unless two calls are bitwise equal."""
    from repro_torch.kernels import attention_common as ac
    B, S, Hq, D = c["q"].shape
    Hkv = c["k"].shape[2]
    rows = ac.flash_rows(c["q"].dtype)
    tiles, split_keys, splits = ac.flash_split(
        B, S, Hq // Hkv, Hkv, capacity, rows=rows,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    smem = ac.flash_smem_bytes(D, c["q"].dtype, rows, split_keys, splits)
    dt = "bf16" if c["q"].dtype == torch.bfloat16 else "f32"
    regs, spill = FLASH_REGS.get(
        (dt, "paged" if name.startswith("paged") else "contiguous", D, rows),
        (None, None))
    first, second = kern(), kern()
    if not torch.equal(first, second):
        fail(f"{name} {label}: two calls on the same inputs differ")
    blocks = splits * Hkv * tiles * B
    print(f"kernel {name} {label}: {rows} rows per block ({tiles} row tiles "
          f"of S*G = {S * Hq // Hkv}); {splits} splits of {split_keys} keys "
          f"over capacity {capacity}; grid ({splits}, {Hkv * tiles}, {B}) = "
          f"{blocks} blocks of {rows * 2} threads, {smem} B dynamic shared "
          f"memory, {regs} registers ({spill} B spilled) per block; two "
          f"calls bitwise equal", flush=True)


def flash_sweep(torch, name, c, kern, plain, capacity, label,
                keys_sweep=FLASH_SWEEP[1]):
    """Cold-L2 time of a bf16 flash call at each rows per block x keys per
    split of FLASH_SWEEP (or ``keys_sweep``; the split actually taken
    beside each: the rule halves it while the grid would leave SMs idle),
    each setting first held against the plain version within LOOSE; the
    defaults restored after.  Returns the largest error."""
    from repro_torch.kernels import attention_common as ac
    B, S, Hq, _ = c["q"].shape
    Hkv = c["k"].shape[2]
    default = (ac.FLASH_ROWS, ac.FLASH_SPLIT_KEYS)
    want = plain()
    cells, err = [], 0.0
    try:
        for rows in FLASH_SWEEP[0]:
            for keys in keys_sweep:
                ac.FLASH_ROWS, ac.FLASH_SPLIT_KEYS = rows, keys
                _, took, splits = ac.flash_split(B, S, Hq // Hkv, Hkv,
                                                 capacity, rows=rows)
                err = max(err, max_err(kern(), want, tol=LOOSE))
                cells.append(f"{rows}x{keys} ({splits} of {took}): "
                             f"{time_ms(kern):.4f}")
    finally:
        ac.FLASH_ROWS, ac.FLASH_SPLIT_KEYS = default
    print(f"kernel {name} {label}: rows x max keys per split (splits of "
          f"keys taken) -> cold-L2 ms  " + "  ".join(cells)
          + f" (default {default[0]}x{default[1]}; each setting within "
          f"LOOSE, max abs err {err:.3g})", flush=True)
    return err


def check_attention(torch, dev):
    """Phase 6.  Returns {name: row} for the JSON line (launches filled in
    from the token paths)."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention_common import paged_gather_plain
    gen = torch.Generator().manual_seed(1)
    errs = {k: 0.0 for k in ATTN_REPLACES}

    def hold(c, window, tol):
        got = {}
        for name, (kern, plain) in attn_calls(c, window).items():
            got[name] = max_err(kern(), plain(), tol=tol)
            errs[name] = max(errs[name], got[name])
        return got

    # edge shapes: fp32 MHA D 64 with ragged S, GQA with a window, bf16;
    # lengths shorter than a block for decode, at least S for a chunk
    for S in (1, 37):
        at_least = lambda ls: [max(L, S) for L in ls]
        hold(attn_case(torch, gen, dev, at_least([5, 70, 40, 16]), S, 4, 4,
                       64, 16, 6, torch.float32), 0, TIGHT)
        hold(attn_case(torch, gen, dev, at_least([9, 40, 77]), S, 24, 2, 128,
                       16, 8, torch.float32), 8, TIGHT)
        hold(attn_case(torch, gen, dev, at_least([9, 40, 77]), S, 24, 2, 128,
                       16, 8, torch.bfloat16), 0, LOOSE)
    # a row whose table is all -1 (and whose positions are all -1): 0
    for S in (1, 5):
        c = attn_case(torch, gen, dev, [12, 30], S, 8, 2, 64, 16, 4,
                      torch.float32)
        c["tbl"][0] = -1
        c["kv_pos"][0] = -1
        for name, (kern, plain) in attn_calls(c).items():
            out = kern()
            if not torch.equal(out[0], torch.zeros_like(out[0])):
                fail(f"{name}: a fully masked row is not exactly 0")
            errs[name] = max(errs[name], max_err(out, plain()))
    # window 8 over rings that have wrapped: 48 positions written through
    # 2 table columns of 16 (column 0 now holds 32..47, column 1 16..31)
    # and through a 32-slot contiguous ring (slot p % 32)
    ring = attn_case(torch, gen, dev, [32], 1, 24, 2, 128, 16, 3,
                     torch.float32)
    ar = lambda lo, hi: torch.arange(lo, hi, dtype=torch.int32, device=dev)
    ring["ppos"][int(ring["tbl"][0, 0])] = ar(32, 48)
    ring["ppos"][int(ring["tbl"][0, 1])] = ar(16, 32)
    ring["kv_pos"][0] = torch.cat([ar(32, 48), ar(16, 32)])
    for S in (1, 3):
        ring["q"] = torch.randn(1, S, 24, 128, generator=gen).to(dev)
        ring["q_pos"] = ar(48 - S, 48)[None]
        hold(ring, 8, TIGHT)
    torch.cuda.synchronize()
    print(f"attention edge shapes: max abs err {errs}", flush=True)

    # the token path's shapes: decode B = 8 slots, prefill one 128-token
    # chunk of one slot; pool of 8 x 257 blocks, contiguous capacity 2048
    rows = {}
    rng = torch.Generator().manual_seed(2)
    lens = torch.randint(TOK_PROMPT[0], TOK_PROMPT[1] + 1, (TOK_SLOTS,),
                         generator=rng).tolist()
    M = -(-(4096 - 1) // TOK_BLOCK) + 1
    nb = TOK_SLOTS * M
    # first in fp32 at TIGHT, with one row as long as a main-path request
    # gets (a 1000-token prompt and 31 decoded): this reaches what only
    # these shapes reach (live-column compaction past 32 table columns,
    # more than 48 KB of shared memory, lists of more than 32 key tiles)
    longest = TOK_PROMPT[1] + TOK_NEW - 1
    fp32 = {}
    for S, ls in {1: lens[:-1] + [longest], TOK_CHUNK: [longest]}.items():
        fp32.update(hold(attn_case(torch, gen, dev, ls, S, 24, 2, 128,
                                   TOK_BLOCK, M, torch.float32, nb=nb,
                                   C=TOK_CAPACITY), 0, TIGHT))
    print(f"attention main-path shapes, fp32 (TIGHT): max abs err {fp32}",
          flush=True)
    shapes = {1: lens, TOK_CHUNK: [max(lens)]}
    for S, ls in shapes.items():
        c = attn_case(torch, gen, dev, ls, S, 24, 2, 128, TOK_BLOCK, M,
                      torch.bfloat16, nb=nb, C=TOK_CAPACITY)
        kg, vg, pg = paged_gather_plain(c["kp"], c["vp"], c["ppos"], c["tbl"])
        for name, (kern, plain) in attn_calls(c).items():
            errs[name] = max(errs[name], max_err(kern(), plain(), tol=LOOSE))
            paged = name.startswith("paged")
            kv_pos = pg if paged else c["kv_pos"]
            nbytes, flops, valid = attn_work(
                torch, c["q"], c["q_pos"], kv_pos, 2,
                table_bytes=c["tbl"].numel() * 4 if paged else 0)
            kk, vv = (kg, vg) if paged else (c["k"], c["v"])
            qT = c["q"].transpose(1, 2).contiguous()
            kT = kk.transpose(1, 2).contiguous()
            vT = vv.transpose(1, 2).contiguous()
            mask = valid[:, None]
            lib = (lambda qT=qT, kT=kT, vT=vT, mask=mask:
                   F.scaled_dot_product_attention(qT, kT, vT, attn_mask=mask,
                                                  enable_gqa=True))
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            cap = c["tbl"].shape[1] * TOK_BLOCK if paged else c["k"].shape[1]
            label = "at starcoder2-3b's heads"
            if name.endswith("decode"):
                decode_report(torch, name, c, kern, cap, label)
                split_sweep(torch, name, kern, label)
            else:
                flash_report(torch, name, c, kern, cap, label)
                errs[name] = max(errs[name], flash_sweep(
                    torch, name, c, kern, plain, cap, label))
            rows[name] = {
                "name": name, "route": "cuda", "source": ATTN_SOURCES[name],
                "replaces": ATTN_REPLACES[name], "launches": 0,
                "max_abs_err": 0.0, "ms": time_ms(kern),
                "plain_ms": time_ms(plain), "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": time_ms(lib),
            }
            r = rows[name]
            print(f"kernel {name}: B={c['q'].shape[0]} S={S} cold L2: "
                  f"kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
                  f"library (sdpa) {r['library_ms']:.4f} ms  bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP)", flush=True)
    # recurrentgemma-9b's heads: Hq 16 over one kv head, D 256 (its
    # 32-key fp32 K+V tile alone is 64 KB), window 2048; its stack is
    # contiguous, so flash and decode are timed; the paged kernels are held
    # at the edge shapes too
    d256 = {}
    for S in (1, 9):
        for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
            c = attn_case(torch, gen, dev, [12, 70, 33], S, 16, 1, 256, 16, 6,
                          dtype)
            for window in (0, 8):
                for name, got in hold(c, window, tol).items():
                    d256[name] = max(d256.get(name, 0.0), got)
    rg_window = 2048
    M = -(-(rg_window - 1) // TOK_BLOCK) + 1
    for S, ls in {1: lens[:-1] + [longest], TOK_CHUNK: [longest]}.items():
        for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
            c = attn_case(torch, gen, dev, ls, S, 16, 1, 256, TOK_BLOCK, M,
                          dtype, C=TOK_CAPACITY)
            for name, (kern, plain) in attn_calls(c, rg_window).items():
                if name.startswith("paged"):
                    continue
                err = max_err(kern(), plain(), tol=tol)
                errs[name] = max(errs[name], err)
                d256[name] = max(d256.get(name, 0.0), err)
                if dtype != torch.bfloat16:
                    continue
                nbytes, flops, valid = attn_work(torch, c["q"], c["q_pos"],
                                                 c["kv_pos"], 1, rg_window)
                qT = c["q"].transpose(1, 2).contiguous()
                kT = c["k"].transpose(1, 2).contiguous()
                vT = c["v"].transpose(1, 2).contiguous()
                lib = (lambda qT=qT, kT=kT, vT=vT, mask=valid[:, None]:
                       F.scaled_dot_product_attention(
                           qT, kT, vT, attn_mask=mask, enable_gqa=True))
                b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
                label = "at D 256 (recurrentgemma-9b's heads)"
                if name == "decode":
                    decode_report(torch, name, c, kern, c["k"].shape[1],
                                  label)
                    split_sweep(torch, name, kern, label)
                else:
                    flash_report(torch, name, c, kern, c["k"].shape[1],
                                 label)
                    err = flash_sweep(torch, name, c, kern, plain,
                                      c["k"].shape[1], label)
                    errs[name] = max(errs[name], err)
                    d256[name] = max(d256[name], err)
                k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain), time_ms(lib)
                print(f"kernel {name} at D 256 (recurrentgemma-9b: Hq 16, "
                      f"Hkv 1, window {rg_window}): B={c['q'].shape[0]} "
                      f"S={S} cold L2: kernel {k_ms:.4f} ms  plain "
                      f"{p_ms:.4f} ms  library (sdpa) {l_ms:.4f} ms  bound "
                      f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB, "
                      f"{flops / 1e9:.3f} GFLOP)", flush=True)
    print(f"attention at D 256, G 16: max abs err {d256} (fp32 TIGHT, bf16 "
          f"LOOSE)", flush=True)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
        print(f"kernel {name}: max_abs_err {errs[name]:.3g} over the edge "
              f"and main-path shapes", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 9: recurrent kernels
# ---------------------------------------------------------------------------


def mlstm_flops(B, S, H, Dh, chunk=MLSTM_CHUNK):
    """Operations of the chunkwise mLSTM on these shapes: per chunk of L
    rows, q.k and P.V over the L(L+1)/2 pairs s <= t; q.C and q.n against
    the carried state past the first chunk; the state update (C, n) before
    the last."""
    starts = list(range(0, S, chunk))
    total = 0
    for ci, c0 in enumerate(starts):
        L = min(chunk, S - c0)
        total += 2 * (L * (L + 1) // 2) * 2 * Dh
        if ci > 0:
            total += 2 * L * Dh * Dh + 2 * L * Dh
        if ci < len(starts) - 1:
            total += 2 * L * Dh * Dh + 2 * L * Dh
    return B * H * total


def recurrent_report(log: str) -> dict:
    """{("rglru", channels) or ("mlstm", dtype, gate dtype): (registers,
    spill bytes)} of the recurrent.cu instances in an ``-Xptxas -v``
    report."""
    pat = (r"Compiling entry function '\S*(?:rglru_kernelILi(\d+)E|"
           r"mlstm_kernelI(13__nv_bfloat16|f)(13__nv_bfloat16|S1_|f)E)")
    dt = lambda m: "f32" if m == "f" else "bf16"
    return ptxas_entries(log, pat, lambda m: (
        ("rglru", int(m.group(1))) if m.group(1) is not None else
        ("mlstm", dt(m.group(2)), dt(m.group(3)))))


def check_recurrent(torch, dev):
    """Phase 9.  Returns {name: row} for the JSON line (launches filled in
    from the recurrentgemma and xlstm paths)."""
    from repro_torch.kernels import mlstm as mlstm_k
    from repro_torch.kernels import rglru as rglru_k
    gen = torch.Generator(device=dev).manual_seed(3)

    def normal(*shape, dtype=torch.float32, shift=0.0):
        x = torch.randn(shape, generator=gen, device=dev) + shift
        return x.to(dtype)

    def decay(*shape):
        return 0.2 + 0.799 * torch.rand(shape, generator=gen, device=dev)

    def mcase(B, S, H, Dh, dtype, i_shift=0.0, gate_dtype=torch.float32):
        q, k, v = (normal(B, S, H, Dh, dtype=dtype) for _ in range(3))
        return (q, k, v, normal(B, S, H, shift=i_shift, dtype=gate_dtype),
                normal(B, S, H, shift=2.0, dtype=gate_dtype))

    def repeat(name, kern):
        if not torch.equal(kern(), kern()):
            fail(f"{name}: two calls on the same inputs differ")

    # RG-LRU: the main path's chunks (B 1, W 4096, S 128 with h0, and the
    # drain's smaller chunks S 2, 16, 64), S not a multiple of a stage and
    # W not a multiple of the channels per block, B 2 with h0, one step
    # at W 77 (4-byte copies)
    errs = {"rglru_scan": 0.0}
    shapes = ((1, TOK_CHUNK, 4096, True), (1, 2, 4096, True),
              (1, 16, 4096, True), (1, 64, 4096, True), (2, 37, 1000, False),
              (2, TOK_CHUNK, 4096, True), (3, 1, 77, True))
    for B, S, W, with_h0 in shapes:
        a, b = decay(B, S, W), normal(B, S, W)
        h0 = normal(B, W) if with_h0 else None
        errs["rglru_scan"] = max(errs["rglru_scan"], max_err(
            rglru_k.rglru_scan(a, b, h0), rglru_k.rglru_scan_plain(a, b, h0),
            exact=True))
        repeat(f"rglru_scan {(B, S, W)}", lambda: rglru_k.rglru_scan(a, b,
                                                                     h0))
    # mLSTM: xlstm-350m's prefill (B 4 x H 4, S 512, Dh 512), a ragged last
    # chunk, one whole chunk and one row past it, B*H = 1, Dh not a
    # multiple of the tiles (48, 20: rows not 16-byte multiples in bf16), a
    # strongly negative input gate
    m_err = {}
    for B, S, H, Dh, shift in ((4, 512, 4, 512, 0.0), (1, 200, 2, 64, 0.0),
                               (1, 128, 1, 512, 0.0), (1, 129, 2, 64, 0.0),
                               (2, 37, 3, 48, 0.0), (2, 20, 1, 20, 0.0),
                               (1, 300, 2, 32, -40.0)):
        for dtype, tol in ((torch.float32, MLSTM_TOL),
                           (torch.bfloat16, LOOSE)):
            x = mcase(B, S, H, Dh, dtype, shift)
            key = f"{str(dtype).split('.')[-1]} B{B} S{S} H{H} Dh{Dh}" + (
                f" i{shift:+g}" if shift else "")
            m_err[key] = max_err(mlstm_k.mlstm_chunkwise(*x),
                                 mlstm_k.mlstm_chunkwise_plain(*x), tol=tol)
            repeat(f"mlstm_chunkwise {key}",
                   lambda: mlstm_k.mlstm_chunkwise(*x))
    errs["mlstm_chunkwise"] = max(m_err.values())
    torch.cuda.synchronize()
    print("rglru_scan: bit-identical to its plain version, two calls bitwise "
          "equal, at (B, S, W, h0) = "
          + ", ".join(str(sh) for sh in shapes), flush=True)
    print(f"mlstm_chunkwise: max abs err vs plain (fp32 tol {MLSTM_TOL}, "
          f"bf16 LOOSE), two calls bitwise equal: {m_err}", flush=True)

    # times at the main paths' shapes: the RG-LRU in fp32 as the model
    # calls it, at the drain's full chunk and at S 16; the mLSTM in bf16
    # with bf16 gates, as xlstm-350m's prefill calls it (the kernel reads
    # them: one launch a call)
    a, b, h0 = decay(1, TOK_CHUNK, 4096), normal(1, TOK_CHUNK, 4096), normal(
        1, 4096)
    a16, b16 = a[:, :16].contiguous(), b[:, :16].contiguous()
    xs = mcase(4, 512, 4, 512, torch.bfloat16, gate_dtype=torch.bfloat16)
    if not torch.equal(mlstm_k.mlstm_chunkwise(*xs), mlstm_k.mlstm_chunkwise(
            *xs[:3], *(g.float() for g in xs[3:]))):
        fail("mlstm_chunkwise: bf16 gates and fp32 gates of the same values "
             "differ")
    B, S, H, Dh = xs[0].shape
    W = a.shape[2]
    smem = mlstm_k.mlstm_smem_bytes(Dh, torch.bfloat16)
    if smem != mlstm_k.kernel_smem_bytes(Dh, torch.bfloat16):
        fail("mlstm_smem_bytes disagrees with the kernel's own count")
    print(f"kernel rglru_scan (1, {TOK_CHUNK}, {W}): grid "
          f"{rglru_k.rglru_grid(1, W)} of {rglru_k.SCAN_THREADS} threads, "
          f"{rglru_k.CHANNELS_PER_BLOCK} channels a block, "
          f"{rglru_k.rglru_smem_bytes()} B dynamic shared memory, "
          f"{REC_REGS.get(('rglru', rglru_k.CHANNELS_PER_BLOCK))} "
          f"(registers, B spilled)", flush=True)
    print(f"kernel mlstm_chunkwise ({B}, {S}, {H}, {Dh}) bf16: grid "
          f"{mlstm_k.mlstm_grid(B, H, Dh)} of {mlstm_k.THREADS} threads, "
          f"{mlstm_k.VALUE_COLS} value columns a block, {smem} B dynamic "
          f"shared memory, "
          f"{REC_REGS.get(('mlstm', 'bf16', 'bf16'))} "
          f"(registers, B spilled); bf16 gates equal fp32 gates bitwise",
          flush=True)
    plan = {
        "rglru_scan": (lambda: rglru_k.rglru_scan(a, b, h0),
                       lambda: rglru_k.rglru_scan_plain(a, b, h0),
                       12 * a.numel() + 4 * h0.numel(), 2 * a.numel(),
                       FP32_FLOPS),
        "mlstm_chunkwise": (lambda: mlstm_k.mlstm_chunkwise(*xs),
                            lambda: mlstm_k.mlstm_chunkwise_plain(*xs),
                            4 * xs[0].numel() * 2 + 2 * xs[3].numel() * 2,
                            mlstm_flops(B, S, H, Dh), BF16_FLOPS),
    }
    rows = {}
    for name, (kern, plain, nbytes, flops, peak) in plan.items():
        b_ms, b_by = bound(nbytes, flops, peak)
        rows[name] = {
            "name": name, "route": "cuda", "source": REC_SOURCE,
            "replaces": REC_REPLACES[name], "launches": 0,
            "max_abs_err": errs[name], "ms": time_ms(kern),
            "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        }
        r = rows[name]
        print(f"kernel {name}: cold L2: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library none  bound "
              f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP)", flush=True)
    ms16 = time_ms(lambda: rglru_k.rglru_scan(a16, b16, h0))
    b16_ms, _ = bound(12 * a16.numel() + 4 * h0.numel(), 0)
    print(f"kernel rglru_scan at S 16: cold L2 {ms16:.4f} ms (S "
          f"{TOK_CHUNK}: {rows['rglru_scan']['ms']:.4f}), bound "
          f"{b16_ms * 1e3:.2f} us", flush=True)
    # channels per block: each setting held bit-exact, then timed
    default, cells = rglru_k.CHANNELS_PER_BLOCK, []
    want = rglru_k.rglru_scan_plain(a, b, h0)
    try:
        for channels in RGLRU_SWEEP:
            rglru_k.CHANNELS_PER_BLOCK = channels
            max_err(rglru_k.rglru_scan(a, b, h0), want, exact=True)
            cells.append(f"{channels}: "
                         f"{time_ms(lambda: rglru_k.rglru_scan(a, b, h0)):.4f}")
    finally:
        rglru_k.CHANNELS_PER_BLOCK = default
    print(f"kernel rglru_scan (1, {TOK_CHUNK}, {W}): channels per block -> "
          f"cold-L2 ms  " + "  ".join(cells) + f" (default {default}; each "
          f"setting bit-exact first)", flush=True)
    return rows


def prefill_chunks(lengths, chunk=TOK_CHUNK) -> int:
    """Prefill chunks of two or more tokens that ``ServeEngine`` runs for
    prompts of ``lengths`` (descending powers of two up to ``chunk``; a
    1-token chunk takes the decode step, not the scan)."""
    return sum(L // chunk + bin(L % chunk).count("1") - (L & 1)
               for L in lengths)


# ---------------------------------------------------------------------------
# phases 7-8: the token main path
# ---------------------------------------------------------------------------


def token_requests(Request, vocab, n, new, prompt, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    return [Request(rid=f"{'outer' if i % 2 == 0 else 'inner'}-{i:02d}",
                    tokens=rng.integers(0, vocab, int(L)),
                    max_new_tokens=new, priority=i % 2)
            for i, L in enumerate(lens)]


def serve(torch, cfg, params, reqs, *, paged, dev, slots, tracer=None):
    """Drain ``reqs`` (fresh copies) through a ServeEngine; returns (engine,
    finished, wall seconds, logits-finite flag)."""
    import copy
    from repro_torch.models.attention import RunOpts
    from repro_torch.serving import ServeEngine
    finite = []

    def sample(logits):
        finite.append(torch.isfinite(logits).all())
        return torch.argmax(logits, dim=-1)

    eng = ServeEngine(cfg, params, slots=slots, cache_capacity=TOK_CAPACITY,
                      prefill_chunk=TOK_CHUNK, block_size=TOK_BLOCK,
                      paged=paged, opts=RunOpts(use_kernels=True),
                      sample=sample, device=dev)
    if tracer is not None:
        eng.attach_obs(tracer=tracer)
    for r in reqs:
        eng.submit(copy.deepcopy(r))
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ok = bool(torch.stack(finite).all()) if finite else True
    return eng, done, dt, ok


def token_main_path(torch, dev, card):
    """Phase 7.  Returns the launch counts of each layout's run."""
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving import Request
    cfg = get_arch("starcoder2-3b")
    params = draw_on_card(torch, cfg, dev)
    reqs = token_requests(Request, cfg.vocab_size, TOK_REQUESTS, TOK_NEW,
                          TOK_PROMPT, TOK_SEED)
    warm = token_requests(Request, cfg.vocab_size, 2, 2, (33, 140), 99)
    launches = {}
    for paged in (True, False):
        layout = "paged" if paged else "contiguous"
        serve(torch, cfg, params, warm, paged=paged, dev=dev,
              slots=TOK_SLOTS)                       # cuBLAS/allocator warm-up
        torch.cuda.empty_cache()
        tracer = SpanTracer()
        kops.reset_launches()
        eng, done, dt, finite = serve(torch, cfg, params, reqs, paged=paged,
                                      dev=dev, slots=TOK_SLOTS, tracer=tracer)
        launches[layout] = kops.launches()
        check_drain(layout, eng, done, TOK_REQUESTS, TOK_NEW, finite)
        if paged and eng.block_pool.used_blocks != 0:
            fail(f"paged pool holds {eng.block_pool.used_blocks} blocks "
                 f"after the drain")
        need = ("paged_decode", "paged_flash") if paged else ("decode",
                                                              "flash")
        for name in need:
            if launches[layout][name] == 0:
                fail(f"{layout} token path never launched {name}")
        report_drain(f"tokens {layout}", eng, done, dt, tracer, card,
                     launches[layout])
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches


def report_drain(label, eng, done, dt, tracer, card, launches):
    """Print a drain's decode ms/tick, decode and prefill tokens/s (from
    the engine's ``decode`` and ``prefill`` spans) and median TTFT."""
    import numpy as np
    dec = tracer.spans("decode")
    pre = tracer.spans("prefill")
    dec_s = sum(e["dur"] for e in dec) / 1e6
    pre_s = sum(e["dur"] for e in pre) / 1e6
    dec_tok = sum(e["args"]["n"] for e in dec)
    pre_tok = sum(e["args"]["tokens"] for e in pre)
    ttft = float(np.median([r.ttft_ms for r in done]))
    print(f"{label}: {len(done)} requests, {pre_tok} prompt + "
          f"{dec_tok + len(done)} generated tokens in {eng.ticks} ticks, "
          f"{dt:.2f} s; decode {dec_s * 1e3 / len(dec):.3f} ms/tick, "
          f"{dec_tok / dec_s:.1f} decode tokens/s, {pre_tok / pre_s:.1f} "
          f"prefill tokens/s, median TTFT {ttft:.1f} ms on {card}; "
          f"launches {launches}", flush=True)


def check_drain(label, eng, done, n, new, finite):
    """Every request finished with ``new`` tokens, the ledger balances,
    the sampled logits were finite."""
    if len(done) != n or any(len(r.generated) != new for r in done):
        fail(f"{label}: not every request finished with {new} tokens: "
             f"{[(r.rid, len(r.generated)) for r in done]}")
    eng.ledger.check()
    if not finite:
        fail(f"{label}: non-finite logits")


# ---------------------------------------------------------------------------
# phases 10-11: recurrentgemma-9b and xlstm-350m at full width and depth
# ---------------------------------------------------------------------------


def draw_on_card(torch, cfg, dev):
    """Full-size random weights drawn on the card from a seeded CUDA
    generator per leaf (billions of parameters: the host's generator
    would take up to a minute); they are never compared with the CPU."""
    from repro_torch.models import transformer as TT
    total, _ = cfg.param_counts()
    t0 = time.perf_counter()
    params = TT.init_params(cfg, torch.Generator().manual_seed(TOK_SEED),
                            device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"{cfg.name}: {cfg.num_layers} layers {cfg.layer_kinds()[:8]}..., "
          f"d_model {cfg.d_model}, {total / 1e9:.3f} B parameters, "
          f"{nbytes / 1e9:.2f} GB {cfg.param_dtype}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return params


def recurrentgemma_main_path(torch, dev, card):
    """Phase 10.  Returns the drain's launch counts."""
    from repro_torch.config import RGLRU, get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving import Request
    cfg = get_arch("recurrentgemma-9b")
    params = draw_on_card(torch, cfg, dev)
    reqs = token_requests(Request, cfg.vocab_size, TOK_REQUESTS, TOK_NEW,
                          TOK_PROMPT, TOK_SEED)
    warm = token_requests(Request, cfg.vocab_size, 2, 2, (33, 140), 99)
    serve(torch, cfg, params, warm, paged=None, dev=dev, slots=TOK_SLOTS)
    torch.cuda.empty_cache()
    tracer = SpanTracer()
    kops.reset_launches()
    eng, done, dt, finite = serve(torch, cfg, params, reqs, paged=None,
                                  dev=dev, slots=TOK_SLOTS, tracer=tracer)
    launches = kops.launches()
    if eng.paged:
        fail("recurrentgemma-9b was served from the paged pool")
    check_drain("recurrentgemma-9b", eng, done, TOK_REQUESTS, TOK_NEW, finite)
    for name in ("flash", "decode", "rglru_scan"):
        if launches[name] == 0:
            fail(f"recurrentgemma-9b path never launched {name}")
    want = prefill_chunks([len(r.tokens) for r in reqs]) * sum(
        kind == RGLRU for kind in cfg.layer_kinds())
    if launches["rglru_scan"] != want:
        fail(f"recurrentgemma-9b drain launched rglru_scan "
             f"{launches['rglru_scan']} times, not once in each of its "
             f"prefill chunks of >= 2 tokens in each RG-LRU layer ({want})")
    report_drain("recurrentgemma-9b contiguous", eng, done, dt, tracer, card,
                 launches)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def xlstm_main_path(torch, dev, card):
    """Phase 11.  Returns the prefill's launch counts."""
    import numpy as np
    from repro_torch.config import MLSTM, get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving import Request
    cfg = get_arch("xlstm-350m")
    params = draw_on_card(torch, cfg, dev)
    opts = RunOpts(use_kernels=True)
    B, S = XL_PREFILL
    toks = torch.as_tensor(np.random.default_rng(TOK_SEED).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.long, device=dev)
    TT.prefill(cfg, params, toks[:, :16], opts=opts)      # cuBLAS warm-up
    torch.cuda.synchronize()
    kops.reset_launches()
    t0 = time.perf_counter()
    logits, caches = TT.prefill(cfg, params, toks, opts=opts)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    launches = kops.launches()
    n_mlstm = cfg.layer_kinds().count(MLSTM)
    if launches["mlstm_chunkwise"] != n_mlstm:
        fail(f"xlstm prefill launched mlstm_chunkwise "
             f"{launches['mlstm_chunkwise']} times, not once in each of its "
             f"{n_mlstm} mLSTM layers")
    finite = torch.isfinite(logits).all()
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(XL_STEPS):
        logits, caches = TT.decode_step(cfg, params, caches, nxt, S + i,
                                        opts=opts)
        finite &= torch.isfinite(logits).all()
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if not bool(finite):
        fail("xlstm prefill/decode gave non-finite logits")
    print(f"xlstm-350m prefill {B} x {S} tokens in {t_pre * 1e3:.1f} ms "
          f"({B * S / t_pre:.1f} tokens/s, mLSTM state rebuilt by the step "
          f"recurrence), {XL_STEPS} decode steps {t_dec * 1e3 / XL_STEPS:.3f} "
          f"ms/step ({B * XL_STEPS / t_dec:.1f} tokens/s) on {card}; prefill "
          f"launches {launches}", flush=True)
    del caches
    reqs = token_requests(Request, cfg.vocab_size, XL_REQUESTS, XL_NEW,
                          XL_PROMPT, TOK_SEED)
    tracer = SpanTracer()
    kops.reset_launches()
    eng, done, dt, finite = serve(torch, cfg, params, reqs, paged=None,
                                  dev=dev, slots=TOK_SLOTS, tracer=tracer)
    check_drain("xlstm-350m", eng, done, XL_REQUESTS, XL_NEW, finite)
    report_drain("xlstm-350m contiguous", eng, done, dt, tracer, card,
                 kops.launches())
    del eng, params
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _leaf_names(tree, path=""):
    """Each leaf's path, list indices as ``*`` (one name for a leaf of
    every layer), in ``_leaves``' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaf_names(v, f"{path}/*")
    else:
        yield path.lstrip("/")


def token_card_vs_cpu(torch, dev, arch="starcoder2-3b", layers=2,
                      layouts=(True, False), reduced=False):
    """Phases 8, 12 and 16 (a): full width (the config's ``reduced()``
    widths if ``reduced``), ``layers`` layers, fp32; card (kernels) vs CPU
    (plain versions), same weights drawn on the host, each KV layout in
    ``layouts``.  Returns (cfg, card params, CPU params)."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    from repro_torch.models.param import tree_to
    from repro_torch.serving import Request
    base = get_arch(arch).reduced() if reduced else get_arch(arch)
    cfg = dataclasses.replace(base, num_layers=layers,
                              param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    cpu_params = TT.init_params(cfg, torch.Generator().manual_seed(7),
                                device="cpu")
    card_params = tree_to(cpu_params, dev)
    print(f"{arch} at {layers} layers {cfg.layer_kinds()}, "
          f"{'reduced' if reduced else 'full'} width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} q / {cfg.num_kv_heads} kv heads of "
          f"{cfg.head_dim}), fp32: weights drawn on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reqs = token_requests(Request, cfg.vocab_size, CPU_REQUESTS, CPU_NEW,
                          CPU_PROMPT, 7)
    opts = RunOpts(use_kernels=True)

    def last_logits(params, seq, device):
        toks = torch.as_tensor(seq, dtype=torch.long, device=device)[None]
        # an encoder-decoder's decoder reads its cross K/V from a cache:
        # the zero rows of a fresh one, as the engine serves it
        caches = (TT.init_caches(cfg, 1, len(seq), device=device)
                  if cfg.family == "encdec" else None)
        logits, _, _ = TT.forward(cfg, params, toks, opts=opts,
                                  caches=caches,
                                  cache_index=0 if caches else None,
                                  last_only=True)
        return logits[0, -1].float().cpu()

    worst = 0.0
    for paged in layouts:
        layout = ("paged" if paged else "contiguous") + f" {arch}"
        t0 = time.perf_counter()
        _, card_done, _, _ = serve(torch, cfg, card_params, reqs,
                                   paged=paged, dev=dev, slots=CPU_REQUESTS)
        _, cpu_done, _, _ = serve(torch, cfg, cpu_params, reqs, paged=paged,
                                  dev=torch.device("cpu"),
                                  slots=CPU_REQUESTS)
        card_out = {r.rid: r.generated for r in card_done}
        for r in cpu_done:
            prompt = [int(t) for t in r.tokens]
            a, b = card_out[r.rid], r.generated
            if a != b:
                i = next(j for j in range(len(b)) if a[j] != b[j])
                top = torch.topk(last_logits(cpu_params, prompt + b[:i],
                                             "cpu"), 2).values
                margin = float(top[0] - top[1])
                if margin >= TOKEN_TOL:
                    fail(f"{layout} {r.rid}: card and CPU streams part at "
                         f"token {i} where the CPU's top-two margin is "
                         f"{margin:.3g} >= {TOKEN_TOL}")
                print(f"tok/CPU {layout} {r.rid}: streams part at token {i}, "
                      f"CPU top-two margin {margin:.3g} < {TOKEN_TOL}",
                      flush=True)
            seq = prompt + b[:-1]
            d = float((last_logits(card_params, seq, dev)
                       - last_logits(cpu_params, seq, "cpu")).abs().max())
            worst = max(worst, d)
            if d > TOKEN_TOL:
                fail(f"{layout} {r.rid}: teacher-forced logits differ by "
                     f"{d:.3g} > {TOKEN_TOL}")
        print(f"tok/CPU {layout}: {len(cpu_done)} requests, streams "
              f"{'equal' if all(card_out[r.rid] == r.generated for r in cpu_done) else 'part (see above)'}"
              f", max |card - CPU| teacher-forced logit {worst:.3g} "
              f"(tol {TOKEN_TOL}); {time.perf_counter() - t0:.1f} s",
              flush=True)
    return cfg, card_params, cpu_params


def xlstm_prefill_card_vs_cpu(torch, dev, cfg, card_params, cpu_params):
    """Phase 12's extra check: xlstm ``prefill`` logits of two 160-token
    prompts (a 128-row chunk and a ragged 32-row one through the mLSTM
    kernel on the card, the quadratic form on the CPU) within TOKEN_TOL."""
    import numpy as np
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    opts = RunOpts(use_kernels=True)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 160))
    out = {}
    for device, params in ((dev, card_params), ("cpu", cpu_params)):
        t = torch.as_tensor(toks, dtype=torch.long, device=device)
        logits, _ = TT.prefill(cfg, params, t, opts=opts)
        out[str(device)] = logits.float().cpu()
    d = float((out[str(dev)] - out["cpu"]).abs().max())
    if not d <= TOKEN_TOL:
        fail(f"xlstm prefill logits differ card vs CPU by {d:.3g}")
    print(f"rec/CPU xlstm prefill 2 x 160: max |card - CPU| logit {d:.3g} "
          f"(tol {TOKEN_TOL})", flush=True)


# ---------------------------------------------------------------------------
# phase 13: the fleet scenarios on the card
# ---------------------------------------------------------------------------


def run_scenario_counted(torch, label, scenario, dev, need, **kw):
    """One scenario through the port's runner on ``dev``: warm (in the
    runner's constructor), then zero every kernel count, run, read the
    counts.  Fails on a violation or if a kernel in ``need`` never
    launched.  Returns (result, runner, wall seconds of the run, gateway
    ticks, launches, gateway ticks in which a replica staged a frame)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import vision_ops as vo
    from repro_torch.simulate import ScenarioRunner
    runner = ScenarioRunner(scenario, device=dev, **kw)
    ticks, work, busy = [0], [0], []
    for r in runner.gw.replicas:
        def staged(kind, _stage=r.stage_class):
            active = _stage(kind)
            busy.append(bool(active.any()))
            return active
        r.stage_class = staged
    tick = runner.gw.tick

    def counted_tick(**tkw):
        ticks[0] += 1
        busy.clear()
        out = tick(**tkw)
        work[0] += any(busy)
        return out
    runner.gw.tick = counted_tick
    vo.reset_launches()
    kops.reset_launches()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: n for k, n in {**vo.LAUNCHES, **kops.launches()}.items()
                if n}
    if res.violations:
        fail(f"{label}: {len(res.violations)} violations: "
             f"{[str(v) for v in res.violations[:4]]}")
    for name in need:
        if not launches.get(name):
            fail(f"{label} never launched {name} (launches {launches})")
    print(f"scenario {label} on {dev.type}: {scenario.ticks} ticks "
          f"({ticks[0]} gateway ticks with the drain) in {dt:.3f} s; "
          f"digest {res.digest}; {len(res.trace)} events "
          f"{res.trace.counts()}; launches {launches}", flush=True)
    return res, runner, dt, ticks[0], launches, work[0]


def check_golden(label, res, golden):
    """``res`` against the golden file: summary, counts, events, digest."""
    summary = {k: res.summary[k] for k in golden["summary"]}
    if summary != golden["summary"]:
        fail(f"{label} summary {summary} != {golden['summary']}")
    if res.trace.counts() != golden["counts"]:
        fail(f"{label} counts {res.trace.counts()} != {golden['counts']}")
    if len(res.trace) != golden["events"] or res.digest != golden["digest"]:
        fail(f"{label} digest {res.digest} ({len(res.trace)} events) "
             f"!= {golden['digest']} ({golden['events']})")


def fleet_scenarios(torch, dev, card, root):
    """Phase 13 (see the module docstring).  Returns each scenario's
    launches and token_failover's digest, for phase 14."""
    from repro_torch.obs.probes import jit_cache_entries
    from repro_torch.simulate import get_scenario, run_scenario
    gate_kernels = ("downscale", "block_sad")
    tok_kernels = ("paged_decode", "paged_flash")

    # (a) golden_churn against its golden file
    with open(os.path.join(root, GOLDEN_CHURN)) as f:
        golden = json.load(f)
    s = get_scenario(golden["scenario"])
    if (s.seed, s.ticks) != (golden["seed"], golden["ticks"]):
        fail("golden_churn's definition differs from its golden file")
    res, _, _, _, golden_launches, _ = run_scenario_counted(
        torch, "golden_churn", s, dev, gate_kernels)
    serial_launches = {"golden_churn": golden_launches}
    check_golden("golden_churn", res, golden)
    print(f"golden_churn: digest, {len(res.trace)} events, counts and "
          f"summary equal the golden file; launches in one run "
          f"{golden_launches}", flush=True)

    # (b) pallas_ingest through the ingest and scatter-admit kernels
    res, _, _, _, serial_launches["pallas_ingest"], _ = run_scenario_counted(
        torch, "pallas_ingest", get_scenario("pallas_ingest"), dev,
        ("ingest_frame", "scatter_admit"))
    if res.digest != PALLAS_INGEST_DIGEST:
        fail(f"pallas_ingest digest {res.digest} != {PALLAS_INGEST_DIGEST}")

    # (c) mixed_serving: vision and token replicas
    res, _, _, _, serial_launches["mixed_serving"], _ = run_scenario_counted(
        torch, "mixed_serving", get_scenario("mixed_serving"), dev,
        gate_kernels + tok_kernels)
    if res.digest != MIXED_SERVING_DIGEST:
        fail(f"mixed_serving digest {res.digest} != {MIXED_SERVING_DIGEST}")
    if res.summary["tok_done"] != res.summary["tok_submitted"]:
        fail(f"mixed_serving: {res.summary['tok_done']} of "
             f"{res.summary['tok_submitted']} requests done")
    print(f"pallas_ingest and mixed_serving digests equal the reference's",
          flush=True)

    # (d) token_failover twice: the card's own weights, one digest
    digests = []
    for r in range(2):
        res, _, _, _, serial_launches["token_failover"], _ = \
            run_scenario_counted(torch, f"token_failover run {r}",
                                 get_scenario("token_failover"), dev,
                                 gate_kernels + tok_kernels)
        sm = res.summary
        if sm["tok_done"] != sm["tok_submitted"]:
            fail(f"token_failover: {sm['tok_done']} of {sm['tok_submitted']} "
                 f"requests done")
        if sm["evt_accepted"] != sm["evt_emitted"] or sm["evt_spool_depth"]:
            fail(f"token_failover events: accepted {sm['evt_accepted']}, "
                 f"emitted {sm['evt_emitted']}, depth "
                 f"{sm['evt_spool_depth']}")
        digests.append(res.digest)
    if digests[0] != digests[1]:
        fail(f"token_failover gave two digests {digests}")
    print(f"token_failover: both runs {digests[0]}", flush=True)

    # (e) golden_churn's traffic at the vision main path's geometry, card
    # and CPU with the same host-drawn weights
    full = full_scenario()
    host_params = host_params_of(torch)

    print(f"full-size scenario: golden_churn traffic, {FULL_TICKS} ticks, "
          f"2 replicas x {FULL_SLOTS} slots, frames {FRAME_RES} px, models "
          f"{INPUT_RES} px, up to {FULL_VEHICLES} vehicles, kernel ingest",
          flush=True)
    card_res, runner, dt, gticks, launches, _ = run_scenario_counted(
        torch, "full-size", full, dev,
        ("ingest_frame", "scatter_admit"), vision_params=host_params)
    warm, end = runner._cache_after_warmup, jit_cache_entries()
    print(f"full-size jit_cache_entries: {warm} at warmup, {end} at the "
          f"end", flush=True)
    if warm != end:
        fail(f"first-use builds grew after warmup: {warm} -> {end}")
    sm = card_res.summary
    print(f"full-size on the card: {dt * 1e3 / gticks:.3f} ms per gateway "
          f"tick over {gticks} ticks; {sm['off'] / dt:.1f} offered frames/s, "
          f"{sm['adm'] / dt:.1f} processed frames/s ({sm['off']} offered, "
          f"{sm['adm']} processed, {sm['gate']} gated, {sm['drop']} "
          f"dropped) on {card}", flush=True)
    t0 = time.perf_counter()
    cpu_res = run_scenario(full, device="cpu", vision_params=host_params)
    print(f"full-size on the CPU: {time.perf_counter() - t0:.1f} s, digest "
          f"{cpu_res.digest}", flush=True)
    if cpu_res.digest != card_res.digest:
        fail(f"full-size digests differ: card {card_res.digest}, CPU "
             f"{cpu_res.digest}")
    print("full-size: card and CPU digests equal", flush=True)
    return serial_launches, digests[0]


def full_scenario(replicas=2, initial=None, vehicles=FULL_VEHICLES):
    """13 (e)'s cell: golden_churn's traffic by ``get_scenario`` overrides
    only, at the vision main path's geometry, kernel ingest."""
    from repro_torch.simulate import ReplicaSpec, get_scenario
    over = {} if initial is None else {"initial_vehicles": initial}
    return get_scenario(
        "golden_churn", frame_res=FRAME_RES, input_res=INPUT_RES,
        replicas=tuple(ReplicaSpec(f"r{i}", slots=FULL_SLOTS)
                       for i in range(replicas)),
        max_vehicles=vehicles, use_kernels=True, ticks=FULL_TICKS, **over)


_HOST_WEIGHTS = {}


def host_params_of(torch):
    """``vision_params`` for the full-size cells: replica i's weights drawn
    on the host from seed i (once), the same on the card and the CPU."""
    from repro_torch.configs.eda_vision import detector_config, pose_config
    from repro_torch.models import vision as V

    def host_params(i):
        if i not in _HOST_WEIGHTS:
            g = torch.Generator().manual_seed(i)
            _HOST_WEIGHTS[i] = (
                V.init_detector(detector_config(INPUT_RES), g, "cpu"),
                V.init_pose(pose_config(INPUT_RES), g, "cpu"))
        return _HOST_WEIGHTS[i]
    return host_params


# ---------------------------------------------------------------------------
# phase 14: the fused fleet tick on the card
# ---------------------------------------------------------------------------


def flattened_launches(torch, vo, dev):
    """14 (a): each vision kernel on FLAT_R x SLOTS // 2 flattened rows
    (the fused tick's launch) bitwise equal to FLAT_R launches of
    SLOTS // 2 rows (the serial tick's)."""
    R, S = FLAT_R, SLOTS // 2
    gen = torch.Generator(device=dev).manual_seed(14)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def per_replica(fn, *args):
        outs = [fn(*(a[r * S:(r + 1) * S].contiguous() for a in args))
                for r in range(R)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return (torch.cat(outs),)

    def check(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"{name} on {R} x {S} flattened rows differs from {R} "
                 f"launches of {S} rows")

    refs = rand(R * S, GATE_RES, GATE_RES, 3)
    admit = rand(R * S) < 0.5
    for frames in (rand(R * S, FRAME_RES, FRAME_RES, 3),
                   (rand(R * S, FRAME_RES, FRAME_RES, 3) * 255).to(
                       torch.uint8)):
        dt = str(frames.dtype).split(".")[1]

        def ingest(f, r):
            return vo.ingest_frame(f, r, model_res=INPUT_RES,
                                   gate_res=GATE_RES, block=BLOCK)
        model, small, scores = ingest(frames, refs)
        check(f"ingest_frame {dt}", (model, small, scores),
              per_replica(ingest, frames, refs))
        for res in (INPUT_RES, GATE_RES):
            check(f"downscale {dt} {res} px", vo.downscale(frames, res),
                  per_replica(lambda f: vo.downscale(f, res), frames))
        check("block_sad", vo.block_sad(refs, small, BLOCK),
              per_replica(lambda r, f: vo.block_sad(r, f, BLOCK), refs,
                          small))
        for pool in (torch.float32, torch.bfloat16):
            batch = rand(R * S, INPUT_RES, INPUT_RES, 3).to(pool)
            check(f"scatter_admit {dt} pool {pool}",
                  vo.scatter_admit(batch, model, refs, small, admit),
                  per_replica(vo.scatter_admit, batch, model, refs, small,
                              admit))
    print(f"fused launches: ingest_frame, scatter_admit (fp32 and bf16 "
          f"pools), downscale ({INPUT_RES} and {GATE_RES} px) and "
          f"block_sad on {R} x {S} flattened rows ({FRAME_RES} px frames, "
          f"fp32 and uint8) bitwise equal to {R} launches of {S} rows",
          flush=True)


def mixed_tier_scenario():
    """``tests/test_torch_fleet_step.py``'s three-group fleet: base, low
    and frugal replicas (three model geometries, a bf16 pool), the tier
    director present but quiescent."""
    from repro_torch.simulate import ReplicaSpec, Scenario, VehicleProfile
    from repro_torch.simulate.scenario import TierPlanSpec
    return Scenario(
        name="mixed_tier_inline", seed=77, ticks=40,
        replicas=(ReplicaSpec("a", tier="base"), ReplicaSpec("b", tier="low"),
                  ReplicaSpec("c", tier="frugal")),
        profiles=(VehicleProfile(duplicate_prob=0.25),),
        initial_vehicles=3, join_rate=0.3, leave_rate=0.05, max_vehicles=8,
        tiers=TierPlanSpec(down_pressure=1e9, up_slack=-1.0,
                           scale_out_pressure=1e9))


def run_fused(torch, label, scenario, dev, need, **kw):
    """:func:`run_scenario_counted` through the fused tick; fails unless
    it issued exactly one fused call for each tick that staged a frame."""
    out = run_scenario_counted(torch, f"{label} fused", scenario, dev, need,
                               parallel=True, **kw)
    calls, work = out[1].gw._fleet.dispatches, out[5]
    if calls != work or not work:
        fail(f"{label}: {calls} fused calls for {work} ticks with work")
    return out


def vision_launches(launches):
    return {k: launches.get(k, 0) for k in
            ("ingest_frame", "scatter_admit", "downscale", "block_sad")}


def fused_fleet(torch, dev, card, root, serial_launches, failover_digest):
    """Phase 14 (see the module docstring)."""
    from repro_torch.kernels import vision_ops as vo
    from repro_torch.obs.probes import jit_cache_entries
    from repro_torch.simulate import get_scenario
    gate_kernels = ("downscale", "block_sad")

    flattened_launches(torch, vo, dev)                              # (a)

    with open(os.path.join(root, GOLDEN_CHURN)) as f:               # (b)
        golden = json.load(f)
    cases = (("golden_churn", get_scenario("golden_churn"), gate_kernels,
              None),
             ("pallas_ingest", get_scenario("pallas_ingest"),
              ("ingest_frame", "scatter_admit"), PALLAS_INGEST_DIGEST),
             ("mixed_serving", get_scenario("mixed_serving"),
              gate_kernels + ("paged_decode", "paged_flash"),
              MIXED_SERVING_DIGEST),
             # its event plane emits the models' flags: the stacked
             # forward must flag as the serial one did in phase 13 (d)
             ("token_failover", get_scenario("token_failover"),
              gate_kernels + ("paged_decode", "paged_flash"),
              failover_digest))
    for label, scenario, need, want in cases:
        res, runner, _, _, launches, work = run_fused(torch, label, scenario,
                                                      dev, need)
        if want is None:
            check_golden(f"{label} fused", res, golden)
        elif res.digest != want:
            fail(f"{label} fused digest {res.digest} != {want}")
        print(f"{label} fused: digest {res.digest[:8]}… as pinned; "
              f"{runner.gw._fleet.dispatches} fused calls for {work} ticks "
              f"with work; kernels 1-4 fused {vision_launches(launches)}, "
              f"serial {vision_launches(serial_launches[label])}",
              flush=True)
    mixed = mixed_tier_scenario()
    serial, _, _, _, s_launches, _ = run_scenario_counted(
        torch, "mixed tier serial", mixed, dev, gate_kernels)
    res, runner, _, _, launches, work = run_fused(torch, "mixed tier", mixed,
                                                  dev, gate_kernels)
    groups = len(runner.gw._fleet._members)
    if groups != 3 or res.digest != serial.digest \
            or res.summary != serial.summary:
        fail(f"mixed tier: {groups} groups; fused {res.digest} != serial "
             f"{serial.digest}")
    print(f"mixed tier ({groups} groups): serial = fused {res.digest[:8]}…; "
          f"{runner.gw._fleet.dispatches} fused calls for {work} ticks with "
          f"work; kernels 1-4 fused {vision_launches(launches)}, serial "
          f"{vision_launches(s_launches)}", flush=True)

    host_params = host_params_of(torch)
    for label, scenario, order, want in (
            ("full-size (c)", full_scenario(), (False, True, True, False),
             FULL_DIGEST),
            (f"wide (d) {WIDE_REPLICAS} x {FULL_SLOTS}",
             full_scenario(WIDE_REPLICAS, WIDE_INITIAL, WIDE_VEHICLES),
             (False, True), None)):
        ms, digests = {False: [], True: []}, set()
        for parallel in order:
            mode = "fused" if parallel else "serial"
            res, runner, dt, gticks, launches, work = (
                run_fused if parallel else run_scenario_counted)(
                    torch, f"{label} {mode}" if not parallel else label,
                    scenario, dev, ("ingest_frame", "scatter_admit"),
                    vision_params=host_params)
            warm, end = runner._cache_after_warmup, jit_cache_entries()
            if warm != end:
                fail(f"{label} {mode}: first-use builds grew after warmup: "
                     f"{warm} -> {end}")
            ms[parallel].append(dt * 1e3 / gticks)
            digests.add(res.digest)
            sm = res.summary
            print(f"{label} {mode}: {dt * 1e3 / gticks:.3f} ms per gateway "
                  f"tick over {gticks} ticks ({work} with work); "
                  f"{sm['off'] / dt:.1f} offered, {sm['adm'] / dt:.1f} "
                  f"processed frames/s; jit_cache_entries {warm} at warmup, "
                  f"{end} at the end; kernels 1-4 "
                  f"{vision_launches(launches)} on {card}", flush=True)
        if len(digests) != 1 or (want is not None and digests != {want}):
            fail(f"{label}: digests {sorted(digests)} (want {want})")
        print(f"{label}: serial = fused digest {digests.pop()[:8]}…; ms per "
              f"gateway tick serial {ms[False]}, fused {ms[True]} on {card}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 15: the EDA runtime
# ---------------------------------------------------------------------------


def load_example(root, name):
    """A module of ``examples/`` (not a package) by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eda_runtime(torch, dev, card, root):
    """Phase 15 (see the module docstring)."""
    import dataclasses
    import numpy as np
    from repro_torch import EDARuntime, PAPER_DEVICES, device_prefetch
    from repro_torch.config import EDAConfig
    from repro_torch.core.runtime import ledger_digest
    from repro_torch.data import DashCamSource
    from repro_torch.models.param import tree_to

    # (a) the case study through SimExecutor: the pinned ledger digest
    dyn = lambda name: dataclasses.replace(PAPER_DEVICES[name],
                                           dynamic_esd=True)
    rt = EDARuntime(eda=EDAConfig(granularity_s=2.0, segmentation=True,
                                  dynamic_esd=True),
                    master=dyn("findx2pro"),
                    workers=[dyn("pixel6"), dyn("oneplus8")])
    digest = ledger_digest(rt.run(50))
    if digest != CASE_STUDY_DIGEST:
        fail(f"case-study ledger digest {digest} != {CASE_STUDY_DIGEST}")
    print(f"eda (a): SimExecutor case study (3 phones, 2 s, 50 pairs): "
          f"ledger digest {digest[:16]}... as pinned; {len(rt.results)} "
          f"videos merged", flush=True)

    # (b) the real executor on the card: full-depth models at 192 px,
    # 256 px frames at 30 fps, the paper's three phones, segmentation and
    # dynamic ESD; weights drawn on the host, so the CPU can check flags
    ex = load_example(root, "torch_eda_dashcam_serve")
    src = DashCamSource(granularity_s=1.0, fps=EDA_FPS, res=FRAME_RES,
                        seed=7)
    cpu = ex.RealExecutor(src, res=INPUT_RES, device="cpu")
    execu = ex.RealExecutor(src, res=INPUT_RES, device=dev,
                            params=(tree_to(cpu.dp, dev),
                                    tree_to(cpu.pp, dev)))
    warm = src.pair(EDA_PAIRS)                    # cuDNN's algorithm choice
    execu.flags("outer", warm.outer)
    execu.flags("inner", warm.inner)
    torch.cuda.synchronize()
    rt = ex.paper_runtime(execu, EDA_FPS)
    t0 = time.perf_counter()
    ledger = rt.run(EDA_PAIRS)
    wall = time.perf_counter() - t0
    ledger.check()
    if len(rt.results) != 2 * EDA_PAIRS or rt._pending:
        fail(f"eda (b): {len(rt.results)} videos merged of {2 * EDA_PAIRS}")
    print(f"eda (b): {EDA_PAIRS} pairs of {FRAME_RES} px frames at "
          f"{EDA_FPS} fps through the real executor on {card} in "
          f"{wall:.2f} s wall:\n{ledger.table()}", flush=True)
    for name, recs in sorted(ledger.by_device().items()):
        mean = lambda f: statistics.fmean(getattr(r, f) for r in recs)
        print(f"eda (b) turnaround decomposition {name}: "
              f"{len(recs)} segments, mean ms: download "
              f"{mean('download_ms'):.3f} transfer {mean('transfer_ms'):.3f} "
              f"wait {mean('wait_ms'):.3f} processing "
              f"{mean('processing_ms'):.3f} return {mean('return_ms'):.3f} "
              f"overhead {mean('overhead_ms'):.3f} = turnaround "
              f"{mean('turnaround_ms'):.3f} (video {mean('video_len_ms'):.0f})"
              f"; frames {sum(r.frames_processed for r in recs)} of "
              f"{sum(r.frames_total for r in recs)}", flush=True)
    print(f"eda (b): near-real-time fraction "
          f"{ledger.real_time_fraction():.4f}, ESD {rt.esd_values()}",
          flush=True)
    checked = 0
    for vid, frames in sorted(rt.results.items()):
        idx = int(vid.split("_")[0][1:])
        if idx >= EDA_CHECKED:
            continue
        stream = "outer" if "_out" in vid else "inner"
        want = cpu.flags(stream, getattr(src.pair(idx), stream))
        got = {i: r["danger"] for i, r in frames.items()}
        if got != {i: bool(want[i]) for i in frames}:
            fail(f"eda (b): {vid}'s flags differ card vs CPU")
        checked += len(frames)
    print(f"eda (b): flags of the first {EDA_CHECKED} pairs ({checked} "
          f"frames, {sum(r['danger'] for v in rt.results.values() for r in v.values())} "
          f"flagged in all) equal the CPU's (TF32 off)", flush=True)

    # (c) device_prefetch of frame pairs: equal to the host batches
    batches = [(src.pair(i).outer, src.pair(i).inner)
               for i in range(PREFETCH_BATCHES)]
    nbytes = sum(a.nbytes + b.nbytes for a, b in batches)
    list(device_prefetch(iter(batches[:2])))     # pinned pool, stream warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(device_prefetch(iter(batches)))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for (o, i), (go, gi) in zip(batches, out):
        if not (np.array_equal(go.cpu().numpy(), o)
                and np.array_equal(gi.cpu().numpy(), i)):
            fail("eda (c): a prefetched batch differs from its host batch")
    if len(out) != PREFETCH_BATCHES:
        fail(f"eda (c): {len(out)} batches of {PREFETCH_BATCHES}")
    print(f"eda (c): device_prefetch of {PREFETCH_BATCHES} frame pairs "
          f"({nbytes / 1e6:.1f} MB, pinning included) in {dt * 1e3:.1f} ms: "
          f"{nbytes / dt / 1e9:.2f} GB/s on {card}; every batch equals its "
          f"host batch", flush=True)
    del out


# ---------------------------------------------------------------------------
# phase 16: the new architectures
# ---------------------------------------------------------------------------


def new_shape_kernels(torch, dev, rows, heads=NEW_HEADS):
    """Phases 16 (c) and 17 (c): kernels 5-8 at the new configs' heads
    against their plain versions (fp32 TIGHT with a 1031-key row, bf16
    LOOSE at the token path's shapes: 8 decode rows, one 128-token chunk)
    and timed in bf16 beside SDPA and the bound; the errors fold into the
    rows."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention_common import paged_gather_plain
    gen = torch.Generator().manual_seed(3)
    rng = torch.Generator().manual_seed(2)
    lens = torch.randint(TOK_PROMPT[0], TOK_PROMPT[1] + 1, (TOK_SLOTS,),
                         generator=rng).tolist()
    longest = TOK_PROMPT[1] + TOK_NEW - 1
    for label, (Hq, Hkv, D, window, names) in heads.items():
        # the engine's table columns: a window's block ring, else the
        # capacity's blocks
        M = (-(-(window - 1) // TOK_BLOCK) + 1 if window
             else -(-TOK_CAPACITY // TOK_BLOCK))
        for S, ls in {1: lens[:-1] + [longest], TOK_CHUNK: [longest]}.items():
            for dtype, tol in ((torch.float32, TIGHT),
                               (torch.bfloat16, LOOSE)):
                c = attn_case(torch, gen, dev, ls, S, Hq, Hkv, D, TOK_BLOCK,
                              M, dtype, C=TOK_CAPACITY)
                calls = attn_calls(c, window)
                for name in names:
                    if name not in calls:
                        continue
                    kern, plain = calls[name]
                    err = max_err(kern(), plain(), tol=tol)
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"], err)
                    if dtype != torch.bfloat16:
                        continue
                    paged = name.startswith("paged")
                    if paged:
                        kk, vv, kv_pos = paged_gather_plain(
                            c["kp"], c["vp"], c["ppos"], c["tbl"])
                    else:
                        kk, vv, kv_pos = c["k"], c["v"], c["kv_pos"]
                    nbytes, flops, valid = attn_work(
                        torch, c["q"], c["q_pos"], kv_pos, Hkv, window,
                        table_bytes=c["tbl"].numel() * 4 if paged else 0)
                    qT = c["q"].transpose(1, 2).contiguous()
                    kT = kk.transpose(1, 2).contiguous()
                    vT = vv.transpose(1, 2).contiguous()
                    lib = (lambda qT=qT, kT=kT, vT=vT, mask=valid[:, None]:
                           F.scaled_dot_product_attention(
                               qT, kT, vT, attn_mask=mask, enable_gqa=True))
                    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
                    k_ms, p_ms, l_ms = (time_ms(kern), time_ms(plain),
                                        time_ms(lib))
                    print(f"kernel {name} at {label} (Hq {Hq}, Hkv {Hkv}, "
                          f"D {D}, window {window}): B={c['q'].shape[0]} "
                          f"S={S} bf16 cold L2: kernel {k_ms:.4f} ms  plain "
                          f"{p_ms:.4f} ms  library (sdpa) {l_ms:.4f} ms  "
                          f"bound {b_ms * 1e3:.2f} us ({b_by}, "
                          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); "
                          f"max abs err {err:.3g}", flush=True)
    print(f"attention at the new heads: max_abs_err now "
          f"{ {n: rows[n]['max_abs_err'] for n in ATTN_REPLACES} }",
          flush=True)


def new_arch_drain(torch, dev, card, arch, layers, layouts, requests):
    """Phase 16 (b): ``arch`` at full width (``layers`` layers, None:
    full depth), bf16, weights drawn on the card, ``requests`` of phase
    7's traffic through each layout; each drain's kernel counts zeroed
    just before it and read just after.  Returns {layout: launches}."""
    import dataclasses
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as TT
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving import Request
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    TT.check_supported(cfg)
    params = draw_on_card(torch, cfg, dev)
    reqs = token_requests(Request, cfg.vocab_size, requests, TOK_NEW,
                          TOK_PROMPT, TOK_SEED)
    warm = token_requests(Request, cfg.vocab_size, 2, 2, (33, 140), 99)
    out = {}
    for paged in layouts:
        layout = "paged" if paged else "contiguous"
        serve(torch, cfg, params, warm, paged=paged, dev=dev,
              slots=TOK_SLOTS)
        torch.cuda.empty_cache()
        tracer = SpanTracer()
        kops.reset_launches()
        eng, done, dt, finite = serve(torch, cfg, params, reqs, paged=paged,
                                      dev=dev, slots=TOK_SLOTS,
                                      tracer=tracer)
        launches = kops.launches()
        out[layout] = launches
        check_drain(f"{arch} {layout}", eng, done, requests, TOK_NEW, finite)
        if eng.paged != paged:
            fail(f"{arch}: asked for {layout}, the engine chose otherwise")
        if cfg.attention == "mla":
            want = set()
        else:
            want = ({"paged_decode", "paged_flash"} if paged
                    else {"decode", "flash"})
        got = {n for n, k in launches.items() if k}
        if got != want:
            fail(f"{arch} {layout} launched {sorted(got)}, expected "
                 f"{sorted(want)}")
        report_drain(f"{arch} {layout} ({cfg.num_layers} layers)", eng,
                     done, dt, tracer, card, launches)
        if not want:
            print(f"{arch} {layout}: MLA attention and MoE run as torch "
                  f"ops; no port kernel launched", flush=True)
        del eng
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 17: the encoder-decoder and VLM families
# ---------------------------------------------------------------------------


def family_extras(torch, cfg, B, device, seed):
    """The stub frontend's input for ``cfg``: whisper's (B, 1500, d_model)
    frame embeddings or internvl2's (B, 256, d_model) patch embeddings,
    drawn on the host from ``seed`` (the same on both sides of a card vs
    CPU check), in the compute dtype."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        key, n = "frames", cfg.encoder_seq
    else:
        key, n = "patches", cfg.num_patches
    x = torch.randn(B, n, cfg.d_model, generator=gen)
    return {key: x.to(device, getattr(torch, cfg.compute_dtype))}


def family_prefill_card_vs_cpu(torch, dev, cfg, card_params, cpu_params):
    """Phase 17 (a): ``prefill`` of FAM_CPU_B rows with frames or patches,
    then FAM_CPU_STEPS greedy decode steps on the CPU; the card fed the
    CPU's tokens (teacher-forced).  Every step's logits within TOKEN_TOL,
    and the card's argmax equals the CPU's token at each step (its own
    greedy stream is then the CPU's) unless the CPU's top-two margin is
    below TOKEN_TOL (printed if so)."""
    import numpy as np
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    opts = RunOpts(use_kernels=True)
    S = FAM_CPU_PROMPT if cfg.family == "vlm" else 16
    toks = torch.as_tensor(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (FAM_CPU_B, S)), dtype=torch.long)
    t0 = time.perf_counter()
    out = {}
    for device, params in (("cpu", cpu_params), (dev, card_params)):
        extras = family_extras(torch, cfg, FAM_CPU_B, device, 18)
        logits, caches = TT.prefill(cfg, params, toks.to(device),
                                    extras=extras, opts=opts)
        steps = [logits[:, -1].float().cpu()]
        fed = out.get("cpu", {}).get("tokens")
        tokens = []
        for i in range(FAM_CPU_STEPS):
            nxt = (torch.argmax(steps[-1], dim=-1) if fed is None
                   else fed[i])
            tokens.append(nxt)
            logits, caches = TT.decode_step(cfg, params, caches,
                                            nxt[:, None].to(device), S + i,
                                            opts=opts)
            steps.append(logits[:, -1].float().cpu())
        out[str(device)] = {"logits": torch.stack(steps, 1),
                            "tokens": tokens}
    cpu, card = out["cpu"]["logits"], out[str(dev)]["logits"]
    d = float((card - cpu).abs().max())
    if not d <= TOKEN_TOL:
        fail(f"{cfg.name} prefill/decode logits differ card vs CPU by "
             f"{d:.3g} > {TOKEN_TOL}")
    top = torch.topk(cpu, 2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    parted = torch.argmax(card, -1) != torch.argmax(cpu, -1)
    if bool((parted & (margin >= TOKEN_TOL)).any()):
        fail(f"{cfg.name}: card and CPU argmax part where the CPU's "
             f"top-two margin is >= {TOKEN_TOL}")
    what = (f"frames ({FAM_CPU_B}, {cfg.encoder_seq}, {cfg.d_model})"
            if cfg.family == "encdec" else f"{cfg.num_patches} patches")
    print(f"fam/CPU {cfg.name} prefill {FAM_CPU_B} x {S} with {what} + "
          f"{FAM_CPU_STEPS} decode steps: max |card - CPU| logit {d:.3g} "
          f"(tol {TOKEN_TOL}); argmax "
          f"{'equal at every step' if not parted.any() else 'parts only under the margin'}"
          f"; {time.perf_counter() - t0:.1f} s", flush=True)


def timed_s(torch, fn, reps=5):
    """Median wall seconds of ``fn`` (synchronised) over ``reps`` calls,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def family_full_path(torch, dev, card, arch):
    """Phase 17 (b): ``arch`` at full width and depth, bf16, weights drawn
    on the card: ``prefill`` with frames or patches, then greedy
    ``decode_step``s; every kernel count zeroed just before and read just
    after, and each must equal what the layers call: whisper's prefill
    launches flash in each encoder layer (not causal), each decoder
    layer's self-attention and its cross-attention, each step decode in
    each decoder layer and flash (cross, S 1) beside it; internvl2's
    prefill flash in each layer, each step decode.  Prints the encoder's
    ms (whisper), prefill ms and decode ms/step.  Returns the launches."""
    import numpy as np
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunOpts
    cfg = get_arch(arch)
    params = draw_on_card(torch, cfg, dev)
    opts = RunOpts(use_kernels=True)
    B, S, steps = ((WH_B, WH_PROMPT, WH_STEPS) if cfg.family == "encdec"
                   else (VL_B, VL_PROMPT, VL_STEPS))
    toks = torch.as_tensor(np.random.default_rng(TOK_SEED).integers(
        0, cfg.vocab_size, (B, S)), dtype=torch.long, device=dev)
    extras = family_extras(torch, cfg, B, dev, 19)
    enc_ms = None
    if cfg.family == "encdec":
        enc_ms = timed_s(torch, lambda: TT.encode(
            cfg, params, extras["frames"], opts=opts)) * 1e3
    pre_ms = timed_s(torch, lambda: TT.prefill(cfg, params, toks,
                                               extras=extras, opts=opts),
                     reps=3) * 1e3
    kops.reset_launches()
    logits, caches = TT.prefill(cfg, params, toks, extras=extras, opts=opts)
    finite = torch.isfinite(logits).all()
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, caches = TT.decode_step(cfg, params, caches, nxt, S + i,
                                        opts=opts)
        finite &= torch.isfinite(logits).all()
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = kops.launches()
    if not bool(finite):
        fail(f"{arch} prefill/decode gave non-finite logits")
    L = cfg.num_layers
    if cfg.family == "encdec":
        want = {"flash": cfg.num_encoder_layers + 2 * L + steps * L,
                "decode": steps * L}
    else:
        want = {"flash": L, "decode": steps * L}
    got = {n: k for n, k in launches.items() if k}
    if got != want:
        fail(f"{arch} prefill + {steps} steps launched {got}, expected "
             f"{want}")
    total, _ = cfg.param_counts()
    what = (f"frames ({B}, {cfg.encoder_seq}, {cfg.d_model}); encoder "
            f"{enc_ms:.3f} ms" if enc_ms is not None
            else f"{cfg.num_patches} patches")
    print(f"{arch} full width and depth bf16: prefill {B} x {S} tokens with "
          f"{what}; prefill {pre_ms:.3f} ms; {steps} decode steps "
          f"{dec_ms:.3f} ms/step ({B * steps / (dec_ms * steps / 1e3):.1f} "
          f"tokens/s) on {card}; launches {got}", flush=True)
    del caches, params
    torch.cuda.empty_cache()
    return launches


def not_causal_kernels(torch, dev, rows):
    """Phase 17 (c): kernel 7 with ``causal=False`` at whisper-base's
    shapes (ENC_SHAPES) against its plain version, fp32 at TIGHT and bf16
    at LOOSE, two calls bitwise equal, one launch a call, ticket counters
    back at 0; in bf16 its rows, split, grid and resources, a sweep of
    rows x keys per split (one split over the 1500 keys included), and its
    time beside the plain version, SDPA (no mask: every key is valid) and
    the bound.  At S 1 the decode kernel on the same inputs too: with
    every position 0 its causal rows see every key, so it computes the
    same function, and its time says what the 64-row flash tile costs a
    one-token step.  The errors fold into the rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_common as ac
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    gen = torch.Generator().manual_seed(5)
    for label, (B, S, C, H, D, positions) in ENC_SHAPES.items():
        for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
            mk = lambda *shape: torch.randn(*shape, generator=gen).to(
                dev, dtype)
            q, k, v = mk(B, S, H, D), mk(B, C, H, D), mk(B, C, H, D)
            if positions == "arange":
                q_pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
                kv_pos = torch.arange(C, dtype=torch.int32).repeat(B, 1)
            else:
                q_pos = torch.zeros(B, S, dtype=torch.int32)
                kv_pos = torch.zeros(B, C, dtype=torch.int32)
            q_pos, kv_pos = q_pos.to(dev), kv_pos.to(dev)
            c = dict(q=q, k=k, v=v, q_pos=q_pos, kv_pos=kv_pos)
            kern = lambda c=c: fa_k.flash_attention(
                c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"],
                causal=False)
            plain = lambda c=c: fa_k.flash_attention_plain(
                c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"],
                causal=False)
            n0 = fa_k.LAUNCHES["flash"]
            first, second = kern(), kern()
            torch.cuda.synchronize()
            if fa_k.LAUNCHES["flash"] != n0 + 2:
                fail(f"flash {label}: not one launch a call")
            if not torch.equal(first, second):
                fail(f"flash {label}: two calls on the same inputs differ")
            if ac.flash_counters(dev).any():
                fail(f"flash {label}: ticket counters not back at 0")
            err = max_err(first, plain(), tol=tol)
            rows["flash"]["max_abs_err"] = max(rows["flash"]["max_abs_err"],
                                               err)
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(f"kernel flash not causal at {label}: B={B} S={S} C={C} "
                  f"{H} heads of {D} {dt}: max abs err {err:.3g} "
                  f"({'TIGHT' if tol is TIGHT else 'LOOSE'}), repeat "
                  f"bitwise, one launch a call", flush=True)
            if dtype != torch.bfloat16:
                continue
            flash_report(torch, "flash", c, kern, C, f"not causal at {label}")
            err = flash_sweep(torch, "flash", c, kern, plain, C,
                              f"not causal at {label}", ENC_KEYS_SWEEP)
            rows["flash"]["max_abs_err"] = max(rows["flash"]["max_abs_err"],
                                               err)
            nbytes, flops, _ = attn_work(torch, q, q_pos, kv_pos, H,
                                         causal=False)
            qT, kT, vT = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qT, kT, vT)
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
            k_ms, p_ms, l_ms = time_ms(kern), time_ms(plain), time_ms(lib)
            extra = ""
            if S == 1:
                dec = lambda: dec_k.decode_attention(q, k, v, q_pos, kv_pos)
                d_err = max_err(dec(), first, tol=LOOSE)
                extra = (f"; decode kernel on the same inputs "
                         f"{time_ms(dec):.4f} ms (vs flash: max abs "
                         f"{d_err:.3g})")
            print(f"kernel flash not causal at {label}: bf16 cold L2: kernel "
                  f"{k_ms:.4f} ms  plain {p_ms:.4f} ms  library (sdpa) "
                  f"{l_ms:.4f} ms  bound {b_ms * 1e3:.2f} us ({b_by}, "
                  f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP){extra}",
                  flush=True)
            del qT, kT, vT
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: training on the card
# ---------------------------------------------------------------------------


def train_batch(torch, cfg, B, S, seed=0):
    """One ``lm_batches`` batch (host tensors) with the family's frames or
    patches from a numpy seed."""
    import numpy as np
    from repro_torch.data import lm_batches
    batch = next(lm_batches(B, S, cfg.vocab_size, seed=seed, steps=1))
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def check_train_step(torch, dev, cfg, label, B, S):
    """One step card vs CPU from one host draw (fp32, grad_accum 2, remat
    full): the gradients of ``make_loss_and_grad``, then one
    ``make_train_step`` step.  No hand kernel may launch."""
    from repro_torch.config import ParallelConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as TT
    from repro_torch.models.param import tree_to
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    from repro_torch.train.train_step import make_loss_and_grad
    t0 = time.perf_counter()
    par = ParallelConfig(grad_accum=TRAIN_ACCUM, remat="full")
    cpu_params = TT.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    batch = train_batch(torch, cfg, B, S)
    sides = {"card": (tree_to(cpu_params, dev),
                      {k: v.to(dev) for k, v in batch.items()}),
             "cpu": (cpu_params, batch)}
    grads, steps = {}, {}
    kops.reset_launches()
    for side, (params, b) in sides.items():
        loss, _, g = make_loss_and_grad(cfg, par)(params, b)
        grads[side] = (float(loss), [t.float().cpu() for t in _leaves(g)])
        del g
        step = make_train_step(cfg, par, AdamWConfig(lr=TRAIN_LR,
                                                     warmup_steps=1))
        p, _, m = step(params, init_opt_state(params), b)
        steps[side] = ({k: float(v) for k, v in m.items()},
                       [t.float().cpu() for t in _leaves(p)])
    if any(kops.launches().values()):
        fail(f"train {label}: hand kernels launched {kops.launches()}")
    (gl_card, g_card), (gl_cpu, g_cpu) = grads["card"], grads["cpu"]
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_cpu)))
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_card, g_cpu))
    (m_card, p_card), (m_cpu, p_cpu) = steps["card"], steps["cpu"]
    # where |g| decides the step, card and CPU take the same one
    scale = min(1.0, 1.0 / max(m_cpu["grad_norm"], 1e-9))   # grad_clip 1
    floor = math.sqrt(1e-8 / scale * TRAIN_GRAD_TOL * norm * TRAIN_LR
                      / TRAIN_ATOL)
    p_err = noise_err = 0.0
    n_all = 0
    below = {}                          # leaf name -> elements below floor
    finite_p = True
    for a, b, g, name in zip(p_card, p_cpu, g_cpu, _leaf_names(cpu_params)):
        d = (a - b).abs()
        decided = g.abs() >= floor
        p_err = max(p_err, float(torch.where(decided, d, 0.0).max()))
        noise_err = max(noise_err, float(torch.where(decided, 0.0, d).max()))
        below[name] = below.get(name, 0) + int((~decided).sum())
        n_all += d.numel()
        finite_p = finite_p and bool(torch.isfinite(a).all())
    n_noise = sum(below.values())
    most = ", ".join(f"{k} {n}" for k, n in sorted(
        below.items(), key=lambda kv: -kv[1])[:3] if n)
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
           for k in ("loss", "grad_norm")}
    finite = finite_p and all(map(
        lambda x: x == x and abs(x) != float("inf"),
        list(m_card.values()) + list(m_cpu.values())))
    print(f"train {label}: loss card {m_card['loss']:.7f} cpu "
          f"{m_cpu['loss']:.7f} (rel {rel['loss']:.2g}), grad norm card "
          f"{m_card['grad_norm']:.6g} cpu {m_cpu['grad_norm']:.6g} (rel "
          f"{rel['grad_norm']:.2g}), max |grad card - cpu| {g_err:.3g} = "
          f"{g_err / norm:.2g} of the norm (tol {TRAIN_GRAD_TOL:.0e}); max "
          f"|param card - cpu| after the step {p_err:.3g} where |g| >= "
          f"{floor:.3g} (tol {TRAIN_ATOL:.3g}); below, {n_noise} of {n_all} "
          f"elements (most in {most or 'none'}), held by the gradient "
          f"check, differ by up to {noise_err:.3g}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not finite:
        fail(f"train {label}: a metric or parameter is not finite: "
             f"{m_card} {m_cpu}")
    if abs(gl_card - gl_cpu) > 1e-5 * abs(gl_cpu) or rel["loss"] > 1e-5:
        fail(f"train {label}: loss card {m_card['loss']} vs cpu "
             f"{m_cpu['loss']}")
    if rel["grad_norm"] > 1e-4:
        fail(f"train {label}: grad norm card {m_card['grad_norm']} vs cpu "
             f"{m_cpu['grad_norm']}")
    if not g_err <= TRAIN_GRAD_TOL * norm:
        fail(f"train {label}: a gradient element differs by {g_err:.3g} > "
             f"{TRAIN_GRAD_TOL} x the global norm {norm:.4g}")
    if not p_err <= TRAIN_ATOL:
        fail(f"train {label}: updated parameters differ by {p_err:.3g} "
             f"(tol {TRAIN_ATOL:.3g}) where |g| >= {floor:.3g}")


def train_card_vs_cpu(torch, dev):
    """Phase 18 (a) (see the module docstring)."""
    import dataclasses
    from repro_torch.config import get_arch, list_archs
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH),
                              num_layers=TRAIN_CPU_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    check_train_step(torch, dev, cfg, f"{TRAIN_ARCH} full width, "
                     f"{TRAIN_CPU_LAYERS} layers, fp32, B {TRAIN_CPU_B} x S "
                     f"{TRAIN_CPU_S}", TRAIN_CPU_B, TRAIN_CPU_S)
    archs = list_archs()
    if len(archs) != 10:
        fail(f"expected the ten registered archs, got {archs}")
    for arch in archs:
        check_train_step(torch, dev, get_arch(arch).reduced(),
                         f"{arch} reduced(), fp32", TRAIN_ARCH_B,
                         TRAIN_ARCH_S)


def launcher_run(torch, label, args):
    """``launch.train.main(args)`` on the card with the launch counters and
    the peak memory zeroed before; fails if a hand kernel launched or a
    loss or gradient norm is not finite.  Returns its summary and the
    peak bytes allocated."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as launch_train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launches()
    run = launch_train.main(args)
    launched = {k: n for k, n in kops.launches().items() if n}
    if launched:
        fail(f"train {label}: the training path launched hand kernels "
             f"{launched}")
    bad = [x for x in run["losses"] + run["grad_norms"]
           if not x == x or abs(x) == float("inf")]
    if bad:
        fail(f"train {label}: a loss or grad norm is not finite: {bad}")
    return run, torch.cuda.max_memory_allocated()


def train_full_width(torch, dev, card):
    """Phase 18 (b) (see the module docstring).  Returns the numbers it
    printed."""
    import shutil
    import tempfile
    from repro_torch.config import get_arch
    from repro_torch.train import checkpoint
    cfg = get_arch(TRAIN_ARCH)
    total, _ = cfg.param_counts()
    tokens = TRAIN_B * TRAIN_S
    flops = 8 * total * tokens
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-train-")
    need = 2 * 2 * total                  # two bf16 checkpoints on disk
    free = shutil.disk_usage(ckpt).free
    print(f"train full {TRAIN_ARCH}: {free / 1e9:.1f} GB free for its "
          f"checkpoints ({need / 1e9:.1f} GB needed)", flush=True)
    if free < need:
        fail(f"train full: {free / 1e9:.1f} GB free under {ckpt}, "
             f"{need / 1e9:.1f} GB needed")
    try:
        t0 = time.perf_counter()
        run, peak = launcher_run(torch, "full", TRAIN_FULL + [
            "--steps", str(TRAIN_STEPS), "--set", "remat=full", "--ckpt",
            ckpt, "--ckpt-every", "10"])
        wall = time.perf_counter() - t0
        ms = [x * 1e3 for x in run["step_s"]]
        losses = run["losses"]
        step_ms = statistics.median(ms[2:])
        out = {"ms_per_step": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3, "peak_gb": peak / 1e9,
               "loss0": losses[0], "loss19": losses[-1],
               "tflops": flops / (step_ms * 1e-3) / 1e12,
               "ckpt": run["ckpt"]}
        ck = ", ".join(f"step {c['step']}: snapshot {c['snapshot_s']:.2f} s, "
                       f"write {c['write_s']:.2f} s" for c in run["ckpt"])
        print(f"train full {TRAIN_ARCH} through launch.train: {total / 1e9:.3f}"
              f" B parameters bf16, fp32 moments, B {TRAIN_B} x S {TRAIN_S} "
              f"(grad_accum {TRAIN_ACCUM}, remat full, lr 3e-4, warmup "
              f"{min(20, TRAIN_STEPS // 5)}): {step_ms:.1f} ms/step (median "
              f"of steps 3-{TRAIN_STEPS}; steps 1-2 {ms[0]:.0f}, {ms[1]:.0f} "
              f"ms; steps 10 and 20, which take the checkpoints' host "
              f"snapshots, {ms[9]:.0f} and {ms[19]:.0f} ms; steps 11-12, "
              f"under the first write, {ms[10]:.0f}, {ms[11]:.0f} ms), "
              f"{out['tokens_per_s']:.0f} tokens/s, model "
              f"{out['tflops']:.1f} TFLOP/s (8 N tokens = {flops / 1e12:.1f} "
              f"TFLOP a step: forward, recompute, backward), peak "
              f"{out['peak_gb']:.2f} GB allocated, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; checkpoints {ck}; {wall:.1f} s in all; "
              f"{card}", flush=True)
        if not losses[-1] < losses[0]:
            fail(f"train full: the loss did not fall: {losses[0]} -> "
                 f"{losses[-1]}")
        if [c["step"] for c in run["ckpt"]] != [10, TRAIN_STEPS]:
            fail(f"train full: checkpoints {run['ckpt']}")
        t0 = time.perf_counter()
        saved, step = checkpoint.restore(ckpt, {"params": run["params"]},
                                         device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = step == TRAIN_STEPS and all(
            torch.equal(a, b) for a, b in zip(_leaves(saved),
                                              _leaves(run["params"])))
        print(f"train full: the launcher's step-{step} checkpoint restored "
              f"onto the card in {restore_s:.2f} s, equal to its final "
              f"parameters bit for bit: {same}", flush=True)
        if not same:
            fail("train full: the restored checkpoint differs from the "
                 "launcher's final parameters")
        out["restore_s"] = restore_s
        del saved, run
        # two on disk at a time: the resume stages step 22 beside step 20
        shutil.rmtree(os.path.join(ckpt, "step_00000010"))
        t0 = time.perf_counter()
        res, _ = launcher_run(torch, "resumed", TRAIN_FULL + [
            "--steps", str(TRAIN_STEPS + TRAIN_RESUMED), "--set",
            "remat=full", "--ckpt", ckpt, "--resume"])
        latest = checkpoint.latest_step(ckpt)
        print(f"train full: --resume from step {res['start_step']}, steps "
              f"{TRAIN_STEPS}-{TRAIN_STEPS + TRAIN_RESUMED - 1} loss "
              f"{', '.join(f'{x:.4f}' for x in res['losses'])}, "
              f"{', '.join(f'{x * 1e3:.0f}' for x in res['step_s'])} ms; "
              f"blocking save of step {latest}: snapshot "
              f"{res['ckpt'][-1]['snapshot_s']:.2f} s, write "
              f"{res['ckpt'][-1]['write_s']:.2f} s; "
              f"{time.perf_counter() - t0:.1f} s in all", flush=True)
        if (res["start_step"] != TRAIN_STEPS
                or len(res["losses"]) != TRAIN_RESUMED
                or latest != TRAIN_STEPS + TRAIN_RESUMED):
            fail(f"train full: resumed at {res['start_step']} for "
                 f"{len(res['losses'])} steps, latest checkpoint {latest}")
        del res
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    # the launcher's default, remat none, at the same batch
    try:
        none, peak = launcher_run(torch, "remat none", TRAIN_FULL + [
            "--steps", str(TRAIN_NONE_STEPS)])
    except torch.cuda.OutOfMemoryError as e:
        out["none"] = None
        print(f"train full, remat none: does not fit at B {TRAIN_B} x S "
              f"{TRAIN_S} ({str(e).splitlines()[0]})", flush=True)
    else:
        none_ms = statistics.median(x * 1e3 for x in none["step_s"][2:])
        out["none"] = {"ms_per_step": none_ms, "peak_gb": peak / 1e9}
        print(f"train full, remat none (the launcher's default): "
              f"{none_ms:.1f} ms/step (median of steps 3-{TRAIN_NONE_STEPS}),"
              f" {tokens / none_ms * 1e3:.0f} tokens/s, model "
              f"{6 * total * tokens / (none_ms * 1e-3) / 1e12:.1f} TFLOP/s "
              f"(6 N tokens: no recompute), peak {peak / 1e9:.2f} GB "
              f"allocated; {card}", flush=True)
        del none
    torch.cuda.empty_cache()
    return out


def train_entry_points(torch, root):
    """Phase 18 (c) (see the module docstring)."""
    import shutil
    import tempfile
    from repro_torch.launch.elastic import run_supervised
    from repro_torch.train import checkpoint
    src = os.path.join(root, "src")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH", "")) if p)
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-elastic-")
    try:
        t0 = time.perf_counter()
        rc = run_supervised(TRAIN_ELASTIC + ["--ckpt", ckpt],
                            os.path.join(ckpt, "heartbeat.json"),
                            stall_s=120.0, max_restarts=1)
        latest = checkpoint.latest_step(ckpt)
        print(f"elastic: run_supervised returned {rc} with max_restarts 1 "
              f"(killed at step 25, so one restart), latest checkpoint "
              f"{latest}; {time.perf_counter() - t0:.1f} s", flush=True)
        if rc != 0 or latest != 60:
            fail(f"elastic: rc {rc}, latest step {latest} (want 0, 60)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    losses = load_example(root, "torch_train_tiny_lm").main(["--steps", "50"])
    print(f"examples/torch_train_tiny_lm.py --steps 50 on the card: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (all(x == x for x in losses) and losses[-1] < losses[0]):
        fail(f"the tiny-LM example's loss did not fall: {losses}")


def grad_guard_on_card(torch, dev):
    """Phase 18 (d) (see the module docstring)."""
    from repro_torch.kernels import decode_attention as dec_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import mlstm as mlstm_k
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as pa_k
    from repro_torch.kernels import rglru as rglru_k
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, Hq, Hkv, D, bs = 2, 64, 8, 2, 128, 16
    q = torch.randn(B, S, Hq, D, device=dev, generator=g)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=g)
    pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
    kp = k.reshape(B * S // bs, bs, Hkv, D).contiguous()
    ppos = pos.reshape(B * S // bs, bs).contiguous()
    tbl = torch.arange(B * S // bs, dtype=torch.int32,
                       device=dev).reshape(B, S // bs).contiguous()
    a = torch.rand(B, S, 256, device=dev, generator=g)
    qm = torch.randn(B, S, 4, 64, device=dev, generator=g)
    gate = torch.randn(B, S, 4, device=dev, generator=g)
    q1, pos1 = q[:, -1:].contiguous(), pos[:, -1:].contiguous()
    calls = {
        "flash": (q, lambda x: fa_k.flash_attention(x, k, k, pos, pos),
                  lambda x: fa_k.flash_attention_plain(x, k, k, pos, pos)),
        "decode": (q1, lambda x: dec_k.decode_attention(x, k, k, pos1, pos),
                   lambda x: dec_k.decode_attention_plain(x, k, k, pos1,
                                                          pos)),
        "paged_flash": (q, lambda x: pa_k.paged_flash_attention(
            x, kp, kp, ppos, tbl, pos), lambda x:
            pa_k.paged_flash_attention_plain(x, kp, kp, ppos, tbl, pos)),
        "paged_decode": (q1, lambda x: pa_k.paged_decode_attention(
            x, kp, kp, ppos, tbl, pos1), lambda x:
            pa_k.paged_decode_attention_plain(x, kp, kp, ppos, tbl, pos1)),
        "rglru_scan": (a, lambda x: rglru_k.rglru_scan(x, a),
                       lambda x: rglru_k.rglru_scan_plain(x, a)),
        "mlstm_chunkwise": (qm, lambda x: mlstm_k.mlstm_chunkwise(
            x, qm, qm, gate, gate), lambda x: mlstm_k.mlstm_chunkwise_plain(
            x, qm, qm, gate, gate)),
    }
    for name, (x, kern, plain) in calls.items():
        kops.reset_launches()
        try:
            kern(x.clone().requires_grad_())
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"grad guard: {name} took an input that requires grad")
        if kops.launches()[name]:
            fail(f"grad guard: {name} launched before refusing")
        with torch.no_grad():
            got = kern(x.clone().requires_grad_())
        if kops.launches()[name] != 1:
            fail(f"grad guard: {name} under no_grad launched "
                 f"{kops.launches()[name]} times")
        err = max_err(got, plain(x), tol=MLSTM_TOL if name ==
                      "mlstm_chunkwise" else TIGHT)
        print(f"grad guard {name}: refuses an input that requires grad; "
              f"under no_grad one launch, max abs vs plain {err:.3g}",
              flush=True)
    kops.reset_launches()


# ---------------------------------------------------------------------------
# phase 19: the multi-device layer on one card
# ---------------------------------------------------------------------------


def md_dryrun_start(root, out):
    """Phase 19 (d)'s subprocess: the two full-width cells, one after the
    other, in a fake world (CPU only; it runs beside (a)-(c))."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               CUDA_VISIBLE_DEVICES="")
    code = ("import sys; from repro_torch.launch.dryrun import run_cell\n"
            f"for a, s, m in {MD_DRYRUN!r}:\n"
            f"    run_cell(a, s, m, {{}}, {out!r})\n")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def md_dryrun_finish(proc, out, card):
    """Phase 19 (d): both cells ``ok``; their per-device counts."""
    try:
        so, se = proc.communicate(timeout=MD_DRYRUN_TIMEOUT_S)
    except Exception:
        proc.kill()
        proc.wait()
        fail(f"dry-run: not done in {MD_DRYRUN_TIMEOUT_S} s")
    if proc.returncode != 0:
        fail(f"dry-run subprocess exited {proc.returncode}: {se[-2000:]}")
    for arch, shape, mesh in MD_DRYRUN:
        with open(os.path.join(out, f"{mesh}__{arch}__{shape}.json")) as f:
            r = json.load(f)
        if not r["ok"] or r["skip"]:
            fail(f"dry-run {mesh} {arch} {shape}: {r['error'] or r['skip']}")
        rf = r["roofline"]
        print(f"dry-run {arch} {shape} on {mesh} ({r['chips']} fake ranks, "
              f"mesh {r['mesh_shape']}): per device {r['cost']['flops']:.4g}"
              f" FLOPs, {r['cost']['bytes_accessed']:.4g} bytes accessed, "
              f"{r['collective_bytes']:.4g} collective bytes (wire-weighted;"
              f" {', '.join(f'{k} {v:.4g}' for k, v in r['collectives'].items() if v)});"
              f" terms at {rf['hw']}: compute {rf['compute_s']:.4g} s, "
              f"memory {rf['memory_s']:.4g} s, collective "
              f"{rf['collective_s']:.4g} s, dominant {rf['dominant']}, "
              f"useful/counted {rf['useful_ratio']:.4g}, roofline fraction "
              f"{rf['roofline_fraction']:.4g}; analytic memory "
              f"{r['memory_analytic']['total'] / 1e9:.2f} GB a device; "
              f"{r['wall_s']:.1f} s wall (the host's CPU, {card})",
              flush=True)


def md_world(torch, path):
    """A one-rank NCCL process group (a file rendezvous: no port)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)


def md_steps(torch, step_fn, params, state, batches, dev):
    """``MD_STEPS`` steps; (first loss, first grad norm, ms of each)."""
    ms, first = [], None
    for b in batches:
        b = {k: v if isinstance(v, torch.Tensor) else
             torch.as_tensor(v).to(dev) for k, v in b.items()}
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        ms.append((time.perf_counter() - t0) * 1e3)
        first = first or (loss, gnorm)
    return first, ms


def md_dtensor_step(torch, dev, card):
    """Phase 19 (a): the DTensor train step on a (1, 1) mesh vs the plain
    step, one seed and one batch stream."""
    from repro_torch.config import ParallelConfig, ShapeConfig, get_arch
    from repro_torch.data import lm_batches
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as TT
    from repro_torch.sharding import rules
    from repro_torch.sharding.compat import make_device_mesh
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    cfg = get_arch(TRAIN_ARCH)
    par = ParallelConfig(grad_accum=TRAIN_ACCUM, remat="none")
    opt = AdamWConfig(lr=3e-4, warmup_steps=min(20, MD_STEPS // 5),
                      total_steps=MD_STEPS)
    out = {}
    kops.reset_launches()
    for side in ("plain", "dtensor"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = TT.init_params(cfg, torch.Generator().manual_seed(0), dev)
        mesh = None
        if side == "dtensor":
            mesh = make_device_mesh((1, 1), ("data", "model"))
            params = rules.distribute(params, mesh,
                                      rules.param_pspecs(cfg, par, mesh))
        state = init_opt_state(params)
        step = make_train_step(cfg, par, opt, mesh=mesh)
        batches = lm_batches(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0,
                             steps=MD_STEPS)
        if mesh is not None:
            bspecs = rules.batch_pspecs(
                cfg, ShapeConfig("cell", TRAIN_S, TRAIN_B, "train"), par,
                mesh)
            batches = (rules.distribute(
                {k: torch.as_tensor(v).to(dev) for k, v in b.items()}, mesh,
                bspecs) for b in batches)
        first, ms = md_steps(torch, step, params, state, batches, dev)
        out[side] = {"loss": first[0], "grad_norm": first[1],
                     "ms": statistics.median(ms[1:]), "first_ms": ms[0],
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        kind = (type(params["embed"]["tokens"]).__name__)
        print(f"multi-device (a) {side} ({kind} leaves): {TRAIN_ARCH} full "
              f"width and depth, B {TRAIN_B} x S {TRAIN_S}, grad_accum "
              f"{TRAIN_ACCUM}, remat none: first step loss {first[0]:.7f}, "
              f"grad norm {first[1]:.7g}; {out[side]['ms']:.1f} ms/step "
              f"(median of steps 2-{MD_STEPS}; step 1 {ms[0]:.0f} ms), peak "
              f"{out[side]['peak_gb']:.2f} GB allocated; {card}", flush=True)
        del params, state, step
    launched = {k: n for k, n in kops.launches().items() if n}
    if launched:
        fail(f"multi-device (a): the training path launched {launched}")
    p, d = out["plain"], out["dtensor"]
    rel_loss = abs(d["loss"] - p["loss"]) / abs(p["loss"])
    rel_gn = abs(d["grad_norm"] - p["grad_norm"]) / abs(p["grad_norm"])
    print(f"multi-device (a): DTensor vs plain first step: loss rel "
          f"{rel_loss:.3g} (tol 1e-5), grad norm rel {rel_gn:.3g} (tol "
          f"1e-4); {d['ms']:.1f} vs {p['ms']:.1f} ms/step ({d['ms'] / p['ms']:.3f}x),"
          f" peak {d['peak_gb']:.2f} vs {p['peak_gb']:.2f} GB", flush=True)
    if not rel_loss <= 1e-5 or not rel_gn <= 1e-4:
        fail(f"multi-device (a): DTensor step {d} vs plain {p}")
    torch.cuda.empty_cache()
    return out


def md_hardware(torch, card):
    """Phase 19 (b): ``HW_H100`` against the card."""
    from repro_torch.roofline.analysis import H100_SMS, HW_H100
    prop = torch.cuda.get_device_properties(0)
    gib = prop.total_memory / 2 ** 30
    spec_gb = HW_H100.hbm_bytes / 1e9
    print(f"multi-device (b): HW_H100 {HW_H100.name!r} (peak "
          f"{HW_H100.peak_flops:.4g} FLOP/s bf16, HBM {HW_H100.hbm_bw:.4g} "
          f"B/s, link {HW_H100.link_bw:.4g} B/s, {HW_H100.hbm_bytes:.4g} B, "
          f"{H100_SMS} SMs) vs the card {prop.name!r}: {prop.total_memory} "
          f"B = {gib:.2f} GiB, {prop.multi_processor_count} SMs; power "
          f"limit: {card}", flush=True)
    if "H100" not in prop.name or HW_H100.name != prop.name:
        fail(f"multi-device (b): the card is {prop.name!r}, HW_H100 "
             f"names {HW_H100.name!r}")
    # the datasheet's "80 GB" counts 2^30-byte units: the card reports
    # its capacity in bytes, 80e9 x 1.07
    if abs(gib - spec_gb) > 0.05 * spec_gb:
        fail(f"multi-device (b): {gib:.2f} GiB on the card vs "
             f"{spec_gb:.0f} GB in HW_H100")
    if prop.total_memory < HW_H100.hbm_bytes:
        fail("multi-device (b): the card holds less than HW_H100.hbm_bytes")
    if prop.multi_processor_count != H100_SMS:
        fail(f"multi-device (b): {prop.multi_processor_count} SMs, "
             f"HW_H100 counts {H100_SMS}")


def md_memory_model(a, train18):
    """Phase 19 (c): the memory model against the measured peaks (reported,
    not held)."""
    from repro_torch.config import ShapeConfig, get_arch
    from repro_torch.roofline.analysis import estimate_memory_per_device
    cfg = get_arch(TRAIN_ARCH)
    shape = ShapeConfig("cell", TRAIN_S, TRAIN_B, "train")
    cases = [("full", train18["peak_gb"], "phase 18 (b)")]
    if train18.get("none"):
        cases.append(("none", train18["none"]["peak_gb"], "phase 18 (b)"))
    cases.append(("none", a["dtensor"]["peak_gb"], "(a) DTensor"))
    for remat, peak, where in cases:
        est = estimate_memory_per_device(cfg, shape, tp=1, dp=1, fsdp=False,
                                         grad_accum=TRAIN_ACCUM, remat=remat)
        print(f"multi-device (c): remat {remat}: the memory model "
              f"{est['total'] / 1e9:.2f} GB (params "
              f"{est['params'] / 1e9:.2f}, fp32 grads and moments "
              f"{est['opt'] / 1e9:.2f}, activations "
              f"{est['activations'] / 1e9:.2f}) vs {peak:.2f} GB measured "
              f"by {where}: ratio {est['total'] / 1e9 / peak:.3f}",
              flush=True)


def md_degenerate(torch, dev):
    """Phase 19 (e): int8_psum and a two-tick pipeline on the NCCL world of
    one; a one-replica fleet through ``fleet_mode="shard_map"`` against
    vmap and serial; a two-replica mesh on one card refused."""
    from repro_torch.sharding.collectives import int8_psum
    from repro_torch.sharding.compat import make_device_mesh
    from repro_torch.sharding.pipeline import make_pipeline, stage_split
    from repro_torch.simulate import ReplicaSpec, get_scenario, run_scenario
    from repro_torch.streams import FleetStep, VisionServeEngine
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4096, device=dev, generator=g)
    got = int8_psum(x)
    s = x.abs().max().clamp(min=1e-8) / 127.0
    want = torch.clamp(torch.round(x / s), -127, 127) * s
    err = float((got - want).abs().max())
    bound = float(x.abs().max()) / 127
    print(f"multi-device (e): int8_psum over NCCL's world of 1: "
          f"max |got - quantised x| {err:.3g}, max |got - x| "
          f"{float((got - x).abs().max()):.3g} (bound {bound:.3g})",
          flush=True)
    if err > 1e-6 * bound or float((got - x).abs().max()) > bound:
        fail("multi-device (e): int8_psum on one rank")
    mesh = make_device_mesh((1,), ("stage",))
    ws = torch.randn(4, 64, 64, device=dev, generator=g) * 0.1
    xs = torch.randn(2, 8, 64, device=dev, generator=g)

    def stage_fn(w, h):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h
    got = make_pipeline(stage_fn, mesh, "stage")(stage_split(ws, 1), xs)
    want = torch.stack([stage_fn(ws, xs[m]) for m in range(2)])
    perr = float((got - want).abs().max())
    print(f"multi-device (e): GPipe, one stage, two microbatches (two "
          f"ticks) vs the stack: max |diff| {perr:.3g}", flush=True)
    if perr > 1e-6:
        fail(f"multi-device (e): pipeline differs by {perr}")
    s = get_scenario("golden_churn", ticks=60,
                     replicas=(ReplicaSpec("r0", slots=4),))
    runs = {"serial": run_scenario(s, device=dev),
            "vmap": run_scenario(s, device=dev, parallel=True,
                                 fleet_mode="vmap"),
            "shard_map": run_scenario(s, device=dev, parallel=True,
                                      fleet_mode="shard_map")}
    digests = {k: r.digest for k, r in runs.items()}
    print(f"multi-device (e): one-replica fleet on the card: digests "
          f"{ {k: v[:8] for k, v in digests.items()} }, violations "
          f"{sum(len(r.violations) for r in runs.values())}", flush=True)
    if len(set(digests.values())) != 1 or any(r.violations
                                              for r in runs.values()):
        fail(f"multi-device (e): fleet digests {digests}")
    engines = [VisionServeEngine(f"m{i}", slots=4, frame_res=32,
                                 input_res=16, device=dev,
                                 generator=torch.Generator().manual_seed(i))
               for i in range(2)]
    try:
        FleetStep(engines, mode="shard_map")
    except ValueError as e:
        print(f"multi-device (e): two replicas on {torch.cuda.device_count()}"
              f" card(s): {e}", flush=True)
        if f"only {torch.cuda.device_count()} available" not in str(e):
            fail(f"multi-device (e): the refusal does not name the card "
                 f"count: {e}")
    else:
        fail("multi-device (e): a two-replica mesh ran on one card")


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

    # ---- phase 1: build (one nvcc per source, all started together) -----
    card = card_line()
    t_run = t_phase = time.perf_counter()

    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    sources = ("vision_ops", "attention", "decode_attention", "recurrent")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(timed_build, sources)))
    for name, (lib, secs) in built.items():
        print(f"build: {name}.cu in {secs:.1f} s on {card}", flush=True)
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)
    for kernel, source, regs_of in (("decode", "decode_attention",
                                     DECODE_REGS),
                                    ("flash", "attention", FLASH_REGS)):
        log = built[source][0].with_suffix(".log")
        regs_of.update(ptxas_report(log.read_text() if log.exists() else "",
                                    kernel))
        if not regs_of:
            fail(f"no {kernel} kernel instance in the ptxas report")
        for key, (regs, spill) in sorted(regs_of.items()):
            what = " ".join(map(str, key[:2])) + f" D {key[2]}" + (
                f" rows {key[3]}" if len(key) > 3 else "")
            print(f"{kernel} kernel {what}: {regs} registers, {spill} B "
                  f"spilled", flush=True)
    log = built["vision_ops"][0].with_suffix(".log")
    VISION_REGS.update(vision_report(log.read_text() if log.exists() else ""))
    for kernel in ("ingest_kernel", "downscale_kernel", "score_kernel"):
        if (kernel, "f32") not in VISION_REGS:
            fail(f"no {kernel} instance in the ptxas report")
    for (kernel, dt), (regs, spill) in sorted(VISION_REGS.items()):
        print(f"vision kernel {kernel} {dt}: {regs} registers, {spill} B "
              f"spilled", flush=True)
    log = built["recurrent"][0].with_suffix(".log")
    REC_REGS.update(recurrent_report(log.read_text() if log.exists() else ""))
    if not REC_REGS:
        fail("no recurrent kernel instance in the ptxas report")
    for key, (regs, spill) in sorted(REC_REGS.items()):
        what = (f"rglru {key[1]} channels" if key[0] == "rglru" else
                f"mlstm {key[1]} gates {key[2]}")
        print(f"recurrent kernel {what}: {regs} registers, {spill} B "
              f"spilled", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    def phase_done(n, what):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"phase {n} ({what}): {now - t_phase:.1f} s wall", flush=True)
        t_phase = now

    phase_done(1, "build")

    # ---- phase 2: kernels vs plain --------------------------------------
    rows = check_kernels(torch, vo, dev)
    phase_done(2, "vision kernels")

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

    phase_done(3, "vision main path")

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
    rows["downscale"]["launches"] += vo.LAUNCHES["downscale"]
    rows["block_sad"]["launches"] = vo.LAUNCHES["block_sad"]
    print(f"MotionGate.admit path: launches {dict(vo.LAUNCHES)}; downscale "
          f"on both paths {rows['downscale']['launches']}", flush=True)

    phase_done(4, "vision kernel paths")

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
    phase_done(5, "vision card vs CPU")

    # ---- phase 6: attention kernels vs plain -------------------------------
    rows.update(check_attention(torch, dev))
    phase_done(6, "attention kernels")

    # ---- phase 7: the token main path, both KV layouts ---------------------
    tok = token_main_path(torch, dev, card)
    for name in ATTN_REPLACES:
        layout = "paged" if name.startswith("paged") else "contiguous"
        rows[name]["launches"] = tok[layout][name]
    phase_done(7, "token main path")

    # ---- phase 8: the token path on the card vs the CPU --------------------
    token_card_vs_cpu(torch, dev)
    phase_done(8, "token card vs CPU")

    # ---- phase 9: recurrent kernels vs plain --------------------------------
    rows.update(check_recurrent(torch, dev))
    phase_done(9, "recurrent kernels")

    # ---- phase 10: recurrentgemma-9b, full width and depth ------------------
    rg = recurrentgemma_main_path(torch, dev, card)
    rows["rglru_scan"]["launches"] = rg["rglru_scan"]
    print(f"recurrentgemma-9b drain launches: flash {rg['flash']}, decode "
          f"{rg['decode']}, rglru_scan {rg['rglru_scan']}", flush=True)
    phase_done(10, "recurrentgemma-9b main path")

    # ---- phase 11: xlstm-350m, full width and depth --------------------------
    xl = xlstm_main_path(torch, dev, card)
    rows["mlstm_chunkwise"]["launches"] = xl["mlstm_chunkwise"]
    phase_done(11, "xlstm-350m main path")

    # ---- phase 12: both archs on the card vs the CPU ------------------------
    token_card_vs_cpu(torch, dev, "recurrentgemma-9b", 3, (False,))
    xl_args = token_card_vs_cpu(torch, dev, "xlstm-350m", 8, (False,))
    xlstm_prefill_card_vs_cpu(torch, dev, *xl_args)
    phase_done(12, "recurrent card vs CPU")

    # ---- phase 13: the fleet scenarios on the card ------------------------
    serial_launches, failover = fleet_scenarios(torch, dev, card,
                                                os.path.dirname(src))
    phase_done(13, "fleet scenarios")

    # ---- phase 14: the fused fleet tick on the card -----------------------
    fused_fleet(torch, dev, card, os.path.dirname(src), serial_launches,
                failover)
    phase_done(14, "fused fleet tick")

    # ---- phase 15: the EDA runtime -----------------------------------------
    eda_runtime(torch, dev, card, os.path.dirname(src))
    phase_done(15, "EDA runtime")

    # ---- phase 16: the new architectures -----------------------------------
    for arch, layouts, reduced in NEW_CPU:
        token_card_vs_cpu(torch, dev, arch, 2, layouts, reduced=reduced)
    phase_done("16 (a)", "new archs card vs CPU")
    new_launches = {name: 0 for name in ATTN_REPLACES}
    for arch, layers, layouts, requests in NEW_DRAINS:
        for layout, got in new_arch_drain(torch, dev, card, arch, layers,
                                          layouts, requests).items():
            print(f"{arch} {layout} drain launches: "
                  + ", ".join(f"{n} {got[n]}" for n in ATTN_REPLACES),
                  flush=True)
            for name in ATTN_REPLACES:
                new_launches[name] += got[name]
    for name in ATTN_REPLACES:
        rows[name]["launches"] += new_launches[name]
    print(f"attention launches on the new archs' drains {new_launches}; "
          f"with phase 7's: "
          f"{ {n: rows[n]['launches'] for n in ATTN_REPLACES} }", flush=True)
    phase_done("16 (b)", "new archs drains")
    new_shape_kernels(torch, dev, rows)
    phase_done("16 (c)", "attention kernels at the new heads")

    # ---- phase 17: the encoder-decoder and VLM families --------------------
    for arch, layers, layouts in FAM_CPU:
        fam = token_card_vs_cpu(torch, dev, arch, layers, layouts)
        family_prefill_card_vs_cpu(torch, dev, *fam)
        del fam
    phase_done("17 (a)", "encoder-decoder and VLM card vs CPU")
    fam_launches = {name: 0 for name in ATTN_REPLACES}
    for arch in ("whisper-base", "internvl2-2b"):
        got = family_full_path(torch, dev, card, arch)
        for name in ATTN_REPLACES:
            fam_launches[name] += got[name]
    for arch, layouts in FAM_DRAINS:
        for layout, got in new_arch_drain(torch, dev, card, arch, None,
                                          layouts, TOK_REQUESTS).items():
            print(f"{arch} {layout} drain launches: "
                  + ", ".join(f"{n} {got[n]}" for n in ATTN_REPLACES),
                  flush=True)
            for name in ATTN_REPLACES:
                fam_launches[name] += got[name]
    for name in ATTN_REPLACES:
        rows[name]["launches"] += fam_launches[name]
    print(f"attention launches on phase 17's paths {fam_launches}; with "
          f"phases 7 and 16's: "
          f"{ {n: rows[n]['launches'] for n in ATTN_REPLACES} }", flush=True)
    phase_done("17 (b)", "encoder-decoder and VLM at full size")
    not_causal_kernels(torch, dev, rows)
    new_shape_kernels(torch, dev, rows, VLM_HEADS)
    phase_done("17 (c)", "flash not causal; kernels 5-8 at internvl2's heads")

    # ---- phase 18: training on the card ------------------------------------
    train_card_vs_cpu(torch, dev)
    phase_done("18 (a)", "training card vs CPU")
    train18 = train_full_width(torch, dev, card)
    phase_done("18 (b)", f"{TRAIN_ARCH} training at full width and depth")
    train_entry_points(torch, os.path.dirname(src))
    phase_done("18 (c)", "train launcher under the elastic supervisor; "
               "the tiny-LM example")
    grad_guard_on_card(torch, dev)
    phase_done("18 (d)", "the kernels refuse inputs that require grad")

    # ---- phase 19: the multi-device layer on one card ----------------------
    import tempfile
    import torch.distributed as dist
    md_tmp = tempfile.mkdtemp(prefix="chip-smoke-md-")
    dry = md_dryrun_start(os.path.dirname(src), md_tmp)
    try:
        md_world(torch, os.path.join(md_tmp, "store"))
        md_a = md_dtensor_step(torch, dev, card)
        phase_done("19 (a)", "the DTensor train step on a (1, 1) NCCL mesh")
        md_hardware(torch, card)
        md_memory_model(md_a, train18)
        phase_done("19 (b)-(c)", "HW_H100 and the memory model vs the card")
        md_degenerate(torch, dev)
        phase_done("19 (e)", "int8_psum, the pipeline and the replica mesh "
                   "on one card")
        md_dryrun_finish(dry, md_tmp, card)
        phase_done("19 (d)", "the dry-run's two full-width cells (waited)")
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        import shutil
        shutil.rmtree(md_tmp, ignore_errors=True)
    print(f"total {time.perf_counter() - t_run:.1f} s wall", flush=True)

    print(card, flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
