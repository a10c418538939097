"""Pre-training on one card through the step ``train.make_train_step``
returns, as the port's train launcher builds it (gradient accumulation into
fp32, no remat, AdamW with fp32 moments, parameters updated in place).

Set-up draws the weights on the card, makes every batch the window can use
from the seed (every row differs), keeps a host copy of the weights, and
drives the step object through its first ``checked_steps`` steps: the same
object, the same call and feed as the window, which then steps on until
``--seconds`` have passed (each step's loss is read, as the launcher reads
it).  ``train_tokens_per_s`` is tokens a step times whole steps over the
window's seconds.

``correct``: the reference (``reference/dense_lm.py``, float32, the update
rounded to the parameters' bfloat16 as the configuration stores them)
follows the first steps from the same weights and batches once the window
has closed and the program is freed.  Compared: each step's loss; each
leaf's norm of the first gradient as the optimizer got it (the program's
first moment after one step over ``1 - b1``); each leaf's norm of the
parameters' change over the steps.  A leaf's gap is measured against its
reference norm or the median leaf's, whichever is larger; leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the change.
"""
from __future__ import annotations

import math
import statistics
import sys

from portbench.counts import lm as LC
from portbench.harness import lm as H
from portbench.harness.session import spans_by_name
from portbench.harness.weights import rebuild, walk
from portbench.traffic import generator as G


def run(s, config: dict, mix: dict, limits: dict, mode: str = "program"
        ) -> dict:
    torch = s.torch
    from repro_torch.config import ParallelConfig
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)

    o = mix["optimizer"]
    cfg = H.model_config(config)
    params = H.weights(torch, cfg, s.seed, s.device)
    leaves = [t for _, t in walk(params)]
    s.note("weights drawn")
    # a host copy of the starting weights, for the change and the reference
    host = torch.empty(sum(t.numel() for t in leaves), dtype=leaves[0].dtype,
                       pin_memory=s.cuda)
    p0 = list(host.split([t.numel() for t in leaves]))
    for h, t in zip(p0, leaves):
        h.copy_(t.reshape(-1), non_blocking=True)
    p0 = [h.view(t.shape) for h, t in zip(p0, leaves)]
    n_batches = mix["checked_steps"] + int(
        math.ceil(s.seconds / mix["max_step_s"])) + 2
    host_batches = G.lm_batches(mix["batch"], mix["seq"], config["vocab_size"],
                                s.seed, n_batches)
    batches = [{k: torch.as_tensor(v, device=s.device) for k, v in b.items()}
               for b in host_batches]
    s.note(f"{n_batches} batches made")
    par = ParallelConfig(grad_accum=mix["grad_accum"], remat=mix["remat"])
    opt_cfg = AdamWConfig(**o)
    step = make_train_step(cfg, par, opt_cfg)
    state = init_opt_state(params, o["state_dtype"])

    prog = {"loss": []}
    with torch.no_grad():
        for i in range(mix["checked_steps"]):
            params, state, m = step(params, state, batches[i])
            prog["loss"].append(float(m["loss"]))
            if i == 0:
                prog["grad"] = [float(mu.float().norm()) / (1 - o["b1"])
                                for _, mu in walk(state["mu"])]
        prog["change"] = [
            float((t.float() - h.to(s.device, non_blocking=True).float())
                  .norm()) for t, h in zip(leaves, p0)]
    s.note(f"{mix['checked_steps']} steps")

    s.start_window()
    steps = nonfinite = 0
    while True:
        with s.span("train_step"):
            params, state, m = step(params, state,
                                    batches[mix["checked_steps"] + steps])
            loss = float(m["loss"])
        steps += 1
        nonfinite += not math.isfinite(loss)
        if s.elapsed() >= s.seconds or \
                mix["checked_steps"] + steps >= n_batches:
            break
    window_s = s.end_window()
    s.note("window closed")
    trace = s.read_trace([])          # the train step has no spans yet
    if trace:
        s.note("trace read")
    tokens = steps * mix["batch"] * mix["seq"]
    counts = {"steps": steps, "tokens": tokens,
              "model_flops": steps * LC.train_step_flops(
                  config, mix["batch"], mix["seq"])}

    like = rebuild(params, [None] * len(leaves))      # the layout alone
    del params, state, step, leaves, m, batches
    if s.cuda:
        torch.cuda.empty_cache()
    ref_batches = [{k: torch.as_tensor(v, device=s.device) for k, v in b.items()}
                   for b in host_batches[:mix["checked_steps"]]]
    checks = check(torch, config, mix, like, p0, ref_batches, prog, limits,
                   s.device, mode=mode)
    s.note("reference compared")
    record = {"spans": {}, "bench_spans": spans_by_name(s.spans),
              "trace": trace,
              "window_s": window_s, "counts": counts}
    return {"attempted": steps, "failed": nonfinite,
            "e2e": {"train_tokens_per_s": tokens / window_s},
            "record": record, "checks": checks}


def _schedule(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    frac = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    if o["schedule"] == "constant":
        return o["lr"] * warm
    if o["schedule"] == "linear":
        decay = 1.0 - (1.0 - o["min_lr_frac"]) * frac
    else:
        decay = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (
            1 + math.cos(math.pi * frac))
    return o["lr"] * warm * decay


def reference_steps(torch, R, config: dict, mix: dict, like, p0, batches,
                    device, precision: str = "fp32", rows: str = "all"
                    ) -> dict:
    """The reference's steps from the starting weights ``p0``: losses, each
    leaf's first clipped gradient norm (and its unclipped one), each
    leaf's change.  ``rows="half"`` plants a fault: each step's gradient is
    the mean over its first half of the rows alone."""
    o = mix["optimizer"]
    acc = mix["grad_accum"]
    leaves = [h.to(device=device, dtype=torch.float32, copy=True)
              .requires_grad_() for h in p0]
    tree = rebuild(like, leaves)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    out = {"loss": []}
    for n, batch in enumerate(batches, start=1):
        B = batch["tokens"].shape[0]
        mb = B // acc
        parts = [range(i * mb, (i + 1) * mb) for i in range(acc)]
        if rows == "half":
            parts = [range(0, B // 2)]
        loss = 0.0
        for part in parts:
            denom = float(batch["mask"][part.start:part.stop].sum())
            for r in part:
                lr_ = R.loss(config, tree, batch["tokens"][r],
                             batch["labels"][r], precision) / (
                                 denom * len(parts))
                lr_.backward()
                loss += float(lr_.detach())
        with torch.no_grad():
            grads = [t.grad for t in leaves]
            gnorm = math.sqrt(sum(float(g.square().sum()) for g in grads))
            scale = min(o["grad_clip"] / max(gnorm, 1e-9), 1.0)
            lr = _schedule(o, n)
            b1c, b2c = 1 - o["b1"] ** n, 1 - o["b2"] ** n
            if n == 1:
                out["grad"] = [float(g.norm()) * scale for g in grads]
                out["grad_raw"] = [float(g.norm()) for g in grads]
            for t, g, m_, v_ in zip(leaves, grads, mu, nu):
                g = g * scale
                m_.mul_(o["b1"]).add_((1 - o["b1"]) * g)
                v_.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                delta = (m_ / b1c) / (torch.sqrt(v_ / b2c) + o["eps"]) \
                    + o["weight_decay"] * t
                # stored in the configuration's type, as the program stores it
                t.copy_((t - lr * delta).to(p0[0].dtype).float())
                t.grad = None
        out["loss"].append(loss)
    with torch.no_grad():
        out["change"] = [float((t - h.to(device).float()).norm())
                         for t, h in zip(leaves, p0)]
    del leaves, tree, mu, nu
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers of a side ``prog`` against the reference."""
    med_g = statistics.median(ref["grad"])
    med_c = statistics.median(ref["change"])
    med_raw = statistics.median(ref["grad_raw"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                       ref["loss"]))
    grad_gap = max(abs(a - b) / max(b, med_g)
                   for a, b in zip(prog["grad"], ref["grad"]))
    change_gap = max(abs(a - b) / max(b, med_c)
                     for a, b, raw in zip(prog["change"], ref["change"],
                                          ref["grad_raw"])
                     if raw >= 1e-3 * med_raw)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def check(torch, config, mix, like, p0, batches, prog, limits, device,
          mode: str = "program") -> dict:
    from portbench.harness.cell import reference
    R = reference(config["reference"])
    ref = reference_steps(torch, R, config, mix, like, p0, batches, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if mode == "control":
        prog = reference_steps(torch, R, config, mix, like, p0, batches,
                               device, precision="control")
    elif mode == "fault_half_batch":
        prog = reference_steps(torch, R, config, mix, like, p0, batches,
                               device, rows="half")
    nums = compare(prog, ref)
    med_raw = statistics.median(ref["grad_raw"])
    left_out = sum(raw < 1e-3 * med_raw for raw in ref["grad_raw"])
    print(f"portbench: {left_out} of {len(ref['grad_raw'])} leaves left out "
          f"of the change (gradient under 1e-3 of the median leaf's)",
          file=sys.stderr)
    return {k: [v, limits[k]] for k, v in nums.items()}
