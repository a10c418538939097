"""An offline batch of completions through ``ServeEngine`` (paged, the hand
attention kernels), greedy.

Set-up draws the weights on the card, builds the engine, submits the first
``slots`` requests and ``queued`` more, and runs one tick: it admits every
slot (chunked prefill through kernel 6, the first use of kernels 5 and 6
building them in a fresh checkout) and decodes once.  The window keeps at
least ``queued`` requests waiting and calls ``step()`` until ``--seconds``
have passed.  ``tokens_per_s`` is every output token sampled in the window,
each request's first token included, over the window's seconds.

``correct``: once the window has closed and the engine is freed, a sample
of the finished requests drawn from the seed, with the one that served the
most tokens in it, goes through the plain reference
(``reference/dense_lm.py``) once each, prompt and served tokens together;
``token_gap`` is the widest gap by which a served token's reference logit
lies below the reference's best at its position.
"""
from __future__ import annotations

import math

import numpy as np

from portbench.counts import lm as LC
from portbench.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.harness import lm as H
from portbench.harness.session import spans_by_name, tracer_spans
from portbench.harness.weights import derive_seed
from portbench.traffic import generator as G

SLICE_S = 5.0


def run(s, config: dict, mix: dict, limits: dict, mode: str = "program"
        ) -> dict:
    torch = s.torch
    from repro_torch.models.attention import RunOpts
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving.engine import Request, ServeEngine

    e = mix["engine"]
    cfg = H.model_config(config)
    params = H.weights(torch, cfg, s.seed, s.device)
    s.note("weights drawn")
    eng = ServeEngine(cfg, params, slots=e["slots"],
                      cache_capacity=e["cache_capacity"],
                      num_blocks=e.get("num_blocks"),
                      prefill_chunk=e["prefill_chunk"],
                      opts=RunOpts(use_kernels=True), paged=e["paged"],
                      block_size=e["block_size"], device=s.device)
    source = G.lm_requests(mix, s.seed, config["vocab_size"])
    reqs = []

    def submit():
        tokens, max_new = next(source)
        r = Request(rid=f"r{len(reqs)}", tokens=tokens,
                    max_new_tokens=max_new, deadline_ms=e["deadline_ms"])
        eng.submit(r)
        reqs.append(r)

    for _ in range(e["slots"] + mix["queued"]):
        submit()
    s.note("engine built")
    eng.step()
    s.note(f"{e['slots']} requests admitted")
    tracer = None
    if s.trace:
        tracer = SpanTracer(sample_every=1, max_events=2_000_000)
        eng.attach_obs(tracer=tracer)

    n_at = {}
    s.start_window()
    for r in reqs:
        n_at[r.rid] = len(r.generated)
    ticks = 0
    # output tokens of each SLICE_S seconds of the window (decoded, and
    # the first token of each admission), for the spread of a window's
    # parts against the spread between runs
    slices = [0]
    while True:
        while len(eng.queue) < mix["queued"]:
            submit()
            n_at[reqs[-1].rid] = 0
        queued = len(eng.queue)
        with s.span("step"):
            decoded = eng.step()
        ticks += 1
        i = int(s.elapsed() // SLICE_S)
        slices += [0] * (i + 1 - len(slices))
        slices[i] += decoded + queued - len(eng.queue)
        if s.window_over(ticks):
            break
    window_s = s.end_window()
    s.note(f"window closed: {ticks} ticks, output tokens a {SLICE_S:g} s "
           f"slice {slices}")
    program_spans = tracer_spans(tracer)
    trace = s.read_trace(program_spans)
    if trace:
        s.note("trace read")

    tokens = sum(len(r.generated) - n_at.get(r.rid, 0) for r in reqs)
    counts = _work(config, reqs, n_at)
    counts["ticks"] = ticks
    finished = list(eng.finished)
    # a request cut short of its output length (the ring was full)
    truncated = sum(1 for r in finished if r.truncated)
    del eng
    if s.cuda:
        torch.cuda.empty_cache()
    checks = check(torch, config, params, finished, s.seed, mix, limits,
                   s.device, mode=mode)
    s.note("reference compared")
    record = {"spans": spans_by_name(program_spans),
              "bench_spans": spans_by_name(s.spans), "trace": trace,
              "window_s": window_s, "counts": counts}
    return {"attempted": counts["admitted"] + counts["running"],
            "failed": truncated,
            "e2e": {"tokens_per_s": tokens / window_s},
            "record": record, "checks": checks}


def _work(config: dict, reqs, n_at: dict) -> dict:
    """The window's work from the requests' states at its two edges:
    prompts prefilled, tokens decoded with the keys each attended, the
    attention's least bytes and operations, the model's operations."""
    admitted = prompt_tokens = running = 0
    attn_bound_s = model_flops = 0.0
    for r in reqs:
        n0, n1 = n_at.get(r.rid, 0), len(r.generated)
        if n1 == n0:
            continue
        S = int(np.shape(r.tokens)[0])
        if n0 == 0:
            admitted += 1
            prompt_tokens += S
            f, b = LC.prefill_attention(config, S)
            attn_bound_s += max(b / HBM_BYTES_PER_S, f / BF16_FLOPS)
            model_flops += sum(LC.forward_flops(config, p, p == S - 1)
                               for p in range(S))
        else:
            running += 1
        # the n-th served token (n >= 2) comes from a decode at position
        # S + n - 2
        for n in range(max(n0, 1) + 1, n1 + 1):
            keys = LC.keys_seen(config, S + n - 2)
            attn_bound_s += max(
                LC.decode_attention_bytes(config, keys) / HBM_BYTES_PER_S,
                LC.attention_flops(config, keys) / BF16_FLOPS)
            model_flops += LC.forward_flops(config, S + n - 2, True)
    return {"admitted": admitted, "running": running,
            "prompt_tokens": prompt_tokens, "attn_bound_s": attn_bound_s,
            "model_flops": model_flops}


def _sample(finished, seed: int, k: int):
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.generated), r.rid))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng(derive_seed(seed, "check"))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def check(torch, config: dict, params, finished, seed: int, mix: dict,
          limits: dict, device, mode: str = "program") -> dict:
    """{"token_gap": [value, limit]}.  ``mode="control"`` reads instead the
    gap of the token the lower precision puts first at each position."""
    from portbench.harness.cell import reference
    R = reference(config["reference"])
    sample = _sample(finished, seed, mix["check"]["requests"])
    worst = -math.inf if sample else math.inf
    with torch.no_grad():
        for r in sample:
            S = int(np.shape(r.tokens)[0])
            out = [int(t) for t in r.generated]
            seq = torch.as_tensor(np.concatenate(
                [np.asarray(r.tokens, np.int64), np.asarray(out[:-1],
                                                            np.int64)]),
                device=device)
            ref = R.logits(config, params, seq)[S - 1:]
            if mode == "control":
                chosen = R.logits(config, params, seq,
                                  "control")[S - 1:].argmax(dim=-1)
            else:
                chosen = torch.as_tensor(out, device=device)
            gap = ref.amax(dim=-1) - ref.gather(1, chosen[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            del ref
    return {"token_gap": [worst, limits["token_gap"]]}
