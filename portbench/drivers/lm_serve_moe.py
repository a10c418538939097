"""``lm_serve``'s offline batch of completions through ``ServeEngine``
(paged, greedy), for a DeepSeek-V2 configuration: multi-head latent
attention, whose latents live in the engine's block pool, and a mixture of
experts.

The loop, ``tokens_per_s`` and ``correct`` are ``lm_serve``'s (its
``check`` and ``_sample``, with the reference the configuration names),
with three changes:

- the port's ``ModelConfig`` comes from the file's own keys, the MLA, MoE
  and YaRN sizes included (:func:`model_config`); the configuration's
  ``deployment`` says whether routing is dropless;
- the weights are drawn with each expert's fan-in: a stack of experts
  ``(E, in, out)`` is scaled by ``1/sqrt(in)`` (:func:`weights`);
- work is counted by ``counts/mla_moe.py`` (active parameters, absorbed
  attention a key), and the engine's MoE counters are read at the
  window's edges (``ServeEngine.stats``: copies routed, expert rows
  computed, copies dropped).

``correct`` also holds ``moe_dropped``: the copies dropped in the window
(limit 0; a dropless configuration's tokens do not depend on their batch).
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np

from portbench.counts import mla_moe as MC
from portbench.drivers import lm_serve
from portbench.harness.session import spans_by_name, tracer_spans
from portbench.harness.weights import draw_tree
from portbench.traffic import generator as G

#: published routing this port computes; a configuration that states
#: another is refused
ROUTING = {"scoring_func": "softmax", "topk_method": "greedy",
           "hidden_act": "silu", "moe_layer_freq": 1, "n_group": 1,
           "topk_group": 1, "routed_scaling_factor": 1,
           "attention_bias": False}


def model_config(config: dict):
    """The port's ``ModelConfig`` of the file: the registry's arch with
    every size the file states."""
    import repro_torch.configs  # noqa: F401  (registers the archs)
    from repro_torch.config import MLAConfig, RopeScaling, get_arch
    bad = {k: config.get(k) for k, v in ROUTING.items()
           if config.get(k) != v}
    if bad:
        raise SystemExit(f"the port computes {ROUTING}; the file states "
                         f"{bad}")
    base = get_arch(config["arch"])
    rs = config.get("rope_scaling")
    moe = dataclasses.replace(
        base.moe, num_experts=config["n_routed_experts"],
        top_k=config["num_experts_per_tok"],
        num_shared_experts=config["n_shared_experts"],
        expert_ff=config["moe_intermediate_size"],
        first_dense_layers=config["first_k_dense_replace"],
        norm_topk_prob=config["norm_topk_prob"],
        capacity_factor=(None if config["deployment"]["dropless"]
                         else base.moe.capacity_factor))
    cfg = dataclasses.replace(
        base, d_model=config["hidden_size"],
        d_ff=config["intermediate_size"],
        num_layers=config["num_hidden_layers"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        head_dim=config["qk_nope_head_dim"] + config["qk_rope_head_dim"],
        vocab_size=config["vocab_size"], rope_theta=config["rope_theta"],
        norm_eps=config["rms_norm_eps"],
        tie_embeddings=config["tie_word_embeddings"],
        param_dtype=config["dtype"], compute_dtype=config["dtype"],
        mla=MLAConfig(q_lora_rank=config["q_lora_rank"] or 0,
                      kv_lora_rank=config["kv_lora_rank"],
                      qk_nope_dim=config["qk_nope_head_dim"],
                      qk_rope_dim=config["qk_rope_head_dim"],
                      v_head_dim=config["v_head_dim"]),
        moe=moe,
        rope_scaling=None if not rs else RopeScaling(
            factor=rs["factor"],
            original_max_position=rs["original_max_position_embeddings"],
            beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
            mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"]))
    from portbench.harness.cell import reference
    want = reference(config["reference"]).PORT_FORM
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise SystemExit(f"the port's {config['arch']} is {got}; the "
                         f"reference computes {want}")
    return cfg


def weights(torch, cfg, seed: int, device):
    """``harness/weights.draw_tree`` with each matrix's fan-in its input
    width (an expert stack's per expert).  MLA's latent norm scale is a
    bare 1-D leaf, which ``draw_tree`` draws as a bias (0.02 n); it is
    made the norm's 1 + 0.05 n of the same draw."""
    from repro_torch.models import transformer as T
    tree = draw_tree(torch, T.abstract_params(cfg), seed, device,
                     getattr(torch, cfg.param_dtype),
                     fan_in=lambda path, shape: shape[-2])
    for layer in tree["layers"]:
        layer["attn"]["kv_norm"].mul_(0.05 / 0.02).add_(1.0)
    return tree


def run(s, config: dict, mix: dict, limits: dict, mode: str = "program"
        ) -> dict:
    torch = s.torch
    from repro_torch.models.attention import RunOpts
    from repro_torch.obs.tracing import SpanTracer
    from repro_torch.serving.engine import Request, ServeEngine

    e = mix["engine"]
    cfg = model_config(config)
    params = weights(torch, cfg, s.seed, s.device)
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
    stats0 = eng.stats()
    s.start_window()
    for r in reqs:
        n_at[r.rid] = len(r.generated)
    ticks = 0
    while True:
        while len(eng.queue) < mix["queued"]:
            submit()
            n_at[reqs[-1].rid] = 0
        with s.span("step"):
            eng.step()
        ticks += 1
        if s.window_over(ticks):
            break
    window_s = s.end_window()
    stats1 = eng.stats()
    s.note(f"window closed: {ticks} ticks; engine counts at its edges "
           f"{stats0} -> {stats1}")
    program_spans = tracer_spans(tracer)
    trace = s.read_trace(program_spans)
    if trace:
        s.note("trace read")

    tokens = sum(len(r.generated) - n_at.get(r.rid, 0) for r in reqs)
    counts = _work(config, reqs, n_at)
    counts["ticks"] = ticks
    for k in ("moe_routed_copies", "moe_expert_rows", "moe_dropped_copies",
              "prefill_graph_replays", "prefill_eager_chunks"):
        counts[k] = stats1[k] - stats0[k]
    finished = list(eng.finished)
    truncated = sum(1 for r in finished if r.truncated)
    # the engine and its prefill graphs refer to each other: collect the
    # pair, so that its latent pool is freed before the reference runs
    del eng
    gc.collect()
    if s.cuda:
        torch.cuda.empty_cache()
    checks = lm_serve.check(torch, config, params, finished, s.seed, mix,
                            limits, s.device, mode=mode)
    checks["moe_dropped"] = [float(counts["moe_dropped_copies"]),
                             limits["moe_dropped"]]
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
    prompts prefilled, tokens decoded, the model's operations
    (``counts/mla_moe.py``)."""
    admitted = prompt_tokens = running = 0
    model_flops = 0.0
    for r in reqs:
        n0, n1 = n_at.get(r.rid, 0), len(r.generated)
        if n1 == n0:
            continue
        S = int(np.shape(r.tokens)[0])
        if n0 == 0:
            admitted += 1
            prompt_tokens += S
            model_flops += sum(MC.forward_flops(config, p, p == S - 1)
                               for p in range(S))
        else:
            running += 1
        # the n-th served token (n >= 2) comes from a decode at position
        # S + n - 2
        for n in range(max(n0, 1) + 1, n1 + 1):
            model_flops += MC.forward_flops(config, S + n - 2, True)
    return {"admitted": admitted, "running": running,
            "prompt_tokens": prompt_tokens, "model_flops": model_flops}
