"""deepseek-v2-lite in the port (CPU, fp32, a small size) against the
benchmark's plain reference, ``portbench/reference/deepseek_v2.py``.

The model is the published configuration file's, made small: layer 0 dense
and two MoE layers of 8 experts top-3 with 2 shared, MLA of 4 heads
(latent 16, nope 8, rope 8, v 8), YaRN on (factor 40 over 4096, beta 32/1,
mscale 0.707 on both), raw top-k gates, dropless; the port's config comes
from that file through the benchmark's driver
(``drivers/lm_serve_moe.model_config``) and the weights from its seeded
draw, so the reference and the port read the same tensors.  Logits are
compared, not sampled tokens.  Tolerances:

- ``FP32`` (atol 2e-5 on logits of magnitude ~4): both sides compute in
  fp32; the port's absorbed MLA and its batched expert products sum in
  other orders than the reference's expanded attention and expert-by-
  expert loop, a few fp32 spacings of the logits.
- Equalities that hold exactly (routing counts, tokens of the two
  layouts) are asserted exactly.
"""
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers import lm_serve_moe as D
from portbench.harness.session import tracer_spans
from portbench.reference import deepseek_v2 as R
from repro_torch.config import get_arch, yarn_mscale
from repro_torch.core.clock import (PREFILL, TICK, TOKEN, VirtualClock,
                                    WallClock)
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import (_rope_freqs, apply_rope, rope_freqs,
                                       yarn_correction_range)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import SpanTracer
from repro_torch.serving import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(rtol=0, atol=2e-5)
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
ENGINE = dict(slots=3, cache_capacity=64, prefill_chunk=8, block_size=4)
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=8, n_routed_experts=8, num_experts_per_tok=3,
             n_shared_experts=2, moe_intermediate_size=32,
             intermediate_size=128, num_hidden_layers=3, vocab_size=256,
             dtype="float32")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _published() -> dict:
    return json.loads((ROOT / "portbench" / "configs"
                       / "deepseek-v2-lite.json").read_text())


@pytest.fixture(scope="module")
def model():
    conf = dict(_published(), **SMALL)
    cfg = D.model_config(conf)
    params = D.weights(torch, cfg, 2 ** 31 + 29, torch.device("cpu"))
    return conf, cfg, params


class _Recording(ServeEngine):
    """An engine that keeps the logits of every token it samples, with the
    request and the index of the served token they decided."""

    def __init__(self, cfg, params, **kw):
        self.seen = []                   # (rid, served index, logits)
        super().__init__(cfg, params, sample=self._keep, device="cpu",
                         clock=VirtualClock(RATES), **kw)

    def _keep(self, logits):
        if logits.ndim == 1:             # a prefill chunk: its last token
            self._chunk = logits.clone()
        else:
            for slot, req in enumerate(self.active):
                if req is not None:
                    self.seen.append((req.rid, len(req.generated),
                                      logits[slot].clone()))
        return torch.argmax(logits, dim=-1)

    def _prefill_loop(self, slot, req):
        first = super()._prefill_loop(slot, req)
        self.seen.append((req.rid, 0, self._chunk))
        return first


def _serve(cfg, params, prompts, max_new=6, **kw):
    eng = _Recording(cfg, params, **dict(ENGINE, **kw))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=f"r{i}", tokens=p, max_new_tokens=max_new))
    done = {r.rid: r for r in eng.run()}
    return eng, done


PROMPTS = [np.random.default_rng(1).integers(0, 256, n)
           for n in (23, 5, 37, 1, 16)]


def test_forward_matches_the_reference(model):
    """The port's ``forward`` (expanded MLA, batched dropless experts) over
    two rows of 40 tokens gives the reference's logits at every position,
    row by row."""
    conf, cfg, params = model
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (2, 40)))
    with torch.no_grad():
        got, _, _ = TT.forward(cfg, params, toks)
        for b in range(2):
            torch.testing.assert_close(got[b], R.logits(conf, params,
                                                        toks[b]), **FP32)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_logits_match_the_reference_at_every_served_position(
        model, paged):
    """Chunked prefill (chunks of 8 and below) then decode, three slots
    over five requests: the logits that chose each served token equal the
    reference's full forward over the prompt and the served tokens, at that
    token's position.  The paged engine keeps the latents in the block
    pool (absorbed attention over the gathered blocks); the contiguous
    one in its rings."""
    conf, cfg, params = model
    eng, done = _serve(cfg, params, PROMPTS, paged=paged)
    assert eng.paged is paged
    assert sorted(done) == [f"r{i}" for i in range(5)]
    with torch.no_grad():
        for rid, r in done.items():
            S = len(r.tokens)
            seq = torch.as_tensor(np.concatenate(
                [r.tokens, np.asarray(r.generated[:-1])]))
            ref = R.logits(conf, params, seq)
            mine = [(n, lg) for q, n, lg in eng.seen if q == rid]
            assert sorted(n for n, _ in mine) == list(range(len(r.generated)))
            for n, lg in mine:
                torch.testing.assert_close(lg, ref[S - 1 + n], **FP32)


def test_paged_engine_serves_the_contiguous_engines_tokens(model):
    """The two layouts serve the same tokens, each at logits within FP32
    of the other's, and the paged engine returns every block."""
    conf, cfg, params = model
    paged, got = _serve(cfg, params, PROMPTS, paged=True)
    ring, want = _serve(cfg, params, PROMPTS, paged=False)
    assert {k: r.generated for k, r in got.items()} == {
        k: r.generated for k, r in want.items()}
    key = lambda s: {(q, n): lg for q, n, lg in s}
    a, b = key(paged.seen), key(ring.seen)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], **FP32)
    assert paged.block_pool.used_blocks == 0


def _flood(cfg, p, x, n):
    """``moe_apply`` of x's rows after ``n`` copies of x's first row, which
    all route to its K experts and rank before x's copies there: x's
    part."""
    flood = x[:1, :1].expand(1, n, x.shape[-1])
    y, _ = TM.moe_apply(cfg, p, torch.cat([flood, x], dim=1))
    return y[:, n:]


def test_dropless_rows_do_not_depend_on_their_batch(model):
    """A layer's output for 6 rows alone and after 60 copies of one of them
    (every copy to the same 3 experts): equal within FP32 where the config
    serves dropless (C = N), and no dropped copy is counted; with GShard's
    capacity (1.25) the flood drops the rows' copies and moves them."""
    conf, cfg, params = model
    p = params["layers"][1]["moe"]
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        alone, _ = TM.moe_apply(cfg, p, x)
        torch.testing.assert_close(_flood(cfg, p, x, 60), alone, **FP32)
        capped = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.25))
        dropped = torch.zeros((), dtype=torch.int64)
        from repro_torch.models import observe
        with observe.observing(dropped=dropped):
            moved = _flood(capped, p, x, 60)
        assert (moved - TM.moe_apply(capped, p, x)[0]).abs().max() > 1e-2
        # 66 rows, C = int(3 * 66 * 1.25 / 8) = 30: the flood's 3 experts
        # take 61 copies each (the flood and x's first row)
        assert int(dropped) >= 3 * (61 - 30)
    assert TM.expert_capacity(cfg, 66) == 66
    assert TM.dispatch_sizes(cfg, 66) == (66 * 3, 8 * 66)


def test_a_requests_logits_hold_beside_a_flooding_companion(model):
    """One request served alone, then beside two companions whose prompts
    repeat one token (their prefill chunks and decode rows crowd the same
    experts): its logits at every served position agree within FP32."""
    conf, cfg, params = model
    alone, _ = _serve(cfg, params, PROMPTS[:1], max_new=8)
    crowd = [PROMPTS[0], np.full(37, 5), np.full(30, 5)]
    beside, _ = _serve(cfg, params, crowd, max_new=8)
    want = {n: lg for q, n, lg in alone.seen if q == "r0"}
    got = {n: lg for q, n, lg in beside.seen if q == "r0"}
    assert want.keys() == got.keys() == set(range(8))
    for n in want:
        torch.testing.assert_close(got[n], want[n], **FP32)


def test_yarn_at_the_published_sizes():
    """Rope dim 64, base 1e4, factor 40 over 4096 positions, beta 32/1:
    the ramp runs over frequency indices 10 to 23, the plain frequency at
    and below 10, a fortieth at and above 23, a blend between; MLA's
    softmax scale gains mscale^2 = (0.1 * 0.707 * ln 40 + 1)^2 = 1.58963,
    and cos and sin keep a factor of 1.  The reference's tables agree."""
    cfg = get_arch("deepseek-v2-lite")
    rs = cfg.rope_scaling
    assert yarn_correction_range(64, 1e4, rs) == (10, 23)
    ratio = rope_freqs(64, 1e4, None, rs) / _rope_freqs(64, 1e4, None)
    assert torch.equal(ratio[:11], torch.ones(11))
    torch.testing.assert_close(ratio[23:], torch.full((9,), 1 / 40))
    assert bool(((ratio[11:23] < 1) & (ratio[11:23] > 1 / 40)).all())
    assert bool((ratio[10:24].diff() < 0).all())
    assert TMLA.softmax_scale(cfg) == pytest.approx(1.58963, abs=1e-5)
    assert yarn_mscale(40, 0.707) == pytest.approx(1.26080, abs=1e-5)
    conf = _published()
    assert R.softmax_scale(conf) == pytest.approx(
        TMLA.softmax_scale(cfg) / math.sqrt(192), rel=1e-12)
    pos = torch.arange(0, 5000, 7)
    x = torch.randn(len(pos), 1, 64, generator=torch.Generator()
                    .manual_seed(0))
    cos, sin = R.rope_tables(conf, pos)
    torch.testing.assert_close(apply_rope(x, pos, 1e4, rs),
                               R._rope(x, cos, sin), rtol=0, atol=2e-3)


def test_rope_without_scaling_is_unchanged():
    """No scaling (every other arch): the frequencies are the plain fp32
    formula bit for bit, and the card's kept vectors are keyed apart."""
    for d, theta in ((128, 999999.4420358813), (64, 1e4)):
        exps = torch.arange(0, d, 2, dtype=torch.float32) / d
        want = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
        assert torch.equal(rope_freqs(d, theta), want)
        assert torch.equal(rope_freqs(d, theta, None, None), want)


def test_raw_gates_where_norm_topk_prob_is_false(model):
    """``norm_topk_prob=False``: the layer weighs each expert by its raw
    softmax probability, as the reference's loop does (within FP32);
    renormalised gates (the default) give another output."""
    conf, cfg, params = model
    p = params["layers"][2]["moe"]
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5))
    with torch.no_grad():
        y, _ = TM.moe_apply(cfg, p, x)
        want = R.moe(conf, p, x.reshape(-1, cfg.d_model), "fp32")
        torch.testing.assert_close(y.reshape(-1, cfg.d_model), want, **FP32)
        w, _ = R.routing(conf, p["router"], x.reshape(-1, cfg.d_model))
        assert float(w.sum(-1).max()) < 0.99
        renorm = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, norm_topk_prob=True))
        assert (TM.moe_apply(renorm, p, x)[0] - y).abs().max() > 1e-3


def test_latent_pool_is_paged_state_beside_kv(model):
    """MLA is paged-eligible: each layer's pool holds the latent ``c``
    (blocks, block, kv_lora) and ``k_rope`` (blocks, block, rope) in the
    compute dtype and ``ppos`` -1; a write through the engine's plan and a
    gather give the entries back at their positions."""
    conf, cfg, params = model
    assert TT.paged_eligible(cfg) and TT.paged_eligible(
        get_arch("deepseek-v2-lite"))
    pools = TT.init_paged_caches(cfg, 6, 4, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in pools[0].items()} == {
        "c": ((6, 4, 16), torch.float32), "k_rope": ((6, 4, 8), torch.float32),
        "ppos": ((6, 4), torch.int32)}
    assert all(bool((c["ppos"] == -1).all()) for c in pools)
    pages = {"tbl": torch.tensor([[4, 1, -1]], dtype=torch.int32),
             "len": torch.tensor([2], dtype=torch.int32),
             "reset": torch.tensor([1], dtype=torch.int32)}
    pos = torch.arange(7, dtype=torch.int32)[None]
    c, kr = torch.randn(1, 7, 16), torch.randn(1, 7, 8)
    from repro_torch.models.attention import paged_write_leaves
    paged_write_leaves(pools[0], {"c": c, "k_rope": kr}, pos, pages)
    gc, gk, gp = TMLA.paged_gather_latents(pools[0], pages["tbl"])
    assert gp[0].tolist() == list(range(7)) + [-1] * 5
    assert torch.equal(gc[0, :7], c[0]) and torch.equal(gk[0, :7], kr[0])


def test_mla_and_moe_spans_and_counters(model):
    """A traced drain: every ``decode.forward`` holds one ``mla`` span a
    layer and one ``moe`` span a MoE layer, and so does every eager
    ``prefill.forward``; a dense arch opens neither.  ``stats()`` and the
    metrics' ``serve_moe_*_total`` count N x K copies and E x C = E x N
    rows a MoE layer and forward (10.7 rows a copy at decode's 3 slots
    and K 3 is 8 / 3), and no dropped copy."""
    conf, cfg, params = model
    # on the host's clock, so that nesting is by time
    eng = ServeEngine(cfg, params, device="cpu", clock=WallClock(), **ENGINE)
    tracer, metrics = SpanTracer(), MetricsRegistry()
    eng.attach_obs(metrics=metrics, tracer=tracer)
    for i, p in enumerate(PROMPTS[:3]):
        eng.submit(Request(rid=f"r{i}", tokens=p, max_new_tokens=4))
    eng.run()
    spans = sorted(tracer_spans(tracer), key=lambda s: (s[1], -s[2]))

    def inside(name, outer):
        return [[s for s in spans if s[0] == name and o[1] <= s[1]
                 and s[2] <= o[2]] for o in spans if o[0] == outer]
    for outer in ("decode.forward", "prefill.forward"):
        assert {len(x) for x in inside("mla", outer)} == {cfg.num_layers}
        assert {len(x) for x in inside("moe", outer)} == {cfg.num_layers - 1}
    st = eng.stats()
    chunks = sum(len(p) // 8 + bin(len(p) % 8).count("1")
                 for p in PROMPTS[:3])
    rows = sum(len(p) for p in PROMPTS[:3])     # prefill: a chunk's width
    decodes = len([s for s in spans if s[0] == "decode"])
    n_layers = cfg.num_layers - 1
    assert st["prefill_eager_chunks"] == chunks
    assert st["moe_routed_copies"] == n_layers * 3 * (rows + 3 * decodes)
    assert st["moe_expert_rows"] == n_layers * 8 * (rows + 3 * decodes)
    assert st["moe_dropped_copies"] == 0
    for name in ("routed_copies", "expert_rows"):
        c = metrics.get(f"serve_moe_{name}_total")
        assert c.labels(engine=eng.name).value == st[f"moe_{name}"]
    dense = ServeEngine(get_arch("starcoder2-3b").reduced(),
                        TT.init_params(get_arch("starcoder2-3b").reduced(),
                                       torch.Generator().manual_seed(0),
                                       device="cpu"),
                        device="cpu", **ENGINE)
    assert "moe_routed_copies" not in dense.stats()


def test_capacity_drops_are_counted_on_the_device(model):
    """With GShard's capacity, an engine counts the copies its MoE layers
    dropped in a tensor on the model's device, read only by ``stats()``:
    the count equals the drops of the same rows recomputed by hand."""
    conf, cfg, params = model
    capped = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.25))
    eng = ServeEngine(capped, params, device="cpu", **ENGINE)
    seen = []
    orig = TM.moe_apply

    def spy(c, p, x):
        seen.append((p["router"], x.reshape(-1, x.shape[-1]).clone()))
        return orig(c, p, x)
    TM.moe_apply, TT.moe_mod.moe_apply = spy, spy
    try:
        for i, p in enumerate(PROMPTS):
            eng.submit(Request(rid=f"r{i}", tokens=p, max_new_tokens=5))
        eng.run()
    finally:
        TM.moe_apply = TT.moe_mod.moe_apply = orig
    want = 0
    for router, x in seen:
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        eid = torch.sort(probs, dim=-1, descending=True,
                         stable=True)[1][:, :3]
        load = torch.bincount(eid.reshape(-1), minlength=8)
        C = TM.expert_capacity(capped, x.shape[0])
        want += int((load - C).clamp(min=0).sum())
    assert want > 0
    assert eng.stats()["moe_dropped_copies"] == want
