"""Port parity: repro_torch.serving.ServeEngine vs the reference engine.

Reduced starcoder2-3b (fp32, window 8), the reference's own initialised
parameters converted with ``repro_torch.convert``, and a ``VirtualClock``
at fixed ``TOKEN``/``PREFILL``/``TICK`` rates on both sides, so every
timing field is a deterministic function of the schedule.  One
module-scoped fixture drains one workload (odd prompts that end in a
1-token chunk, both priorities, deadlines under an ESD budget) through
the reference engine (plain path) and the port (plain path, and its
``use_kernels=True`` path, which on the CPU runs the kernels' plain
versions), in both KV layouts.  Token streams, every ``Request`` timing
field, every ``SegmentRecord`` field and ``stats()`` must be equal.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.config import EDAConfig as JEDAConfig
from repro.config import get_arch as jget_arch
from repro.core.clock import VirtualClock as JClock
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.config import EDAConfig, get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.core.engine_core import BlockPoolExhausted
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.serving import Request, ServeEngine

ARCH = "starcoder2-3b"
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8, block_size=4)
TIMING = ("arrival_s", "prefill_done_s", "finish_s", "processing_ms",
          "truncated", "prompt_truncated", "ttft_ms", "turnaround_ms",
          "skip_rate")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload():
    """(rid, prompt, max_new, priority, deadline_ms): odd lengths end in a
    1-token chunk; two deadlines are cut short by the ESD budget."""
    rng = np.random.default_rng(11)
    lens = (5, 23, 12, 9, 17, 3, 30)
    return [(f"r{i}", rng.integers(0, 256, n), 6, i % 2,
             10.0 if i in (2, 5) else 0.0) for i, n in enumerate(lens)]


def _port_stats(ticks):
    """The port's own prefill and decode counts in ``stats()`` on the CPU:
    no graph, every chunk eager, at most ``prefill_chunk`` (8) wide (the
    descending powers of two of each prompt), and every one of the drain's
    ``ticks`` an eager decode."""
    chunks = sum(len(toks) // 8 + bin(len(toks) % 8).count("1")
                 for _, toks, *_ in _workload())
    return {"prefill_graph_replays": 0, "prefill_eager_chunks": chunks,
            "prefill_graphs": 0, "decode_graph_replays": 0,
            "decode_eager_ticks": ticks}


def _summary(eng, done, caches):
    reqs = [(r.rid, list(r.generated), *[getattr(r, f) for f in TIMING])
            for r in done]
    recs = [dataclasses.asdict(r) for r in eng.ledger.records]
    return reqs, recs, eng.stats(), caches


@pytest.fixture(scope="module")
def drained():
    """{(layout, side): (requests, ledger records, stats)}."""
    jc, tc = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jp = JT.init_params(jc, jax.random.key(0))
    tp = convert.transformer_from_jax(jax.tree.map(np.asarray, jp), tc,
                                      device="cpu")
    out = {}
    for paged in (True, False):
        j = JServeEngine(jc, jp, paged=paged, clock=JClock(rates=RATES),
                         eda=JEDAConfig(esd=2.0), **ENGINE)
        for rid, toks, mx, pr, dl in _workload():
            j.submit(JRequest(rid=rid, tokens=toks, max_new_tokens=mx,
                              priority=pr, deadline_ms=dl))
        done = j.run()
        out[paged, "ref"] = _summary(j, done, convert.caches_from_jax(
            jax.tree.map(np.asarray, j.caches), tc, device="cpu"))
        for use_kernels in (False, True):
            t = ServeEngine(tc, tp, paged=paged, clock=VirtualClock(RATES),
                            eda=EDAConfig(esd=2.0), device="cpu",
                            opts=RunOpts(use_kernels=use_kernels), **ENGINE)
            for rid, toks, mx, pr, dl in _workload():
                t.submit(Request(rid=rid, tokens=toks, max_new_tokens=mx,
                                 priority=pr, deadline_ms=dl))
            out[paged, use_kernels] = _summary(t, t.run(), t.caches)
            t.ledger.check()
    return out


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_matches_reference(drained, paged, use_kernels):
    want_reqs, want_recs, want_stats, want_caches = drained[paged, "ref"]
    got_reqs, got_recs, got_stats, got_caches = drained[paged, use_kernels]
    assert [r[:2] for r in got_reqs] == [r[:2] for r in want_reqs]
    assert got_reqs == want_reqs
    assert got_recs == want_recs
    assert got_stats == dict(want_stats, **_port_stats(want_stats["ticks"]))
    assert len(got_reqs) == len(_workload())
    assert any(r[2 + TIMING.index("truncated")] for r in got_reqs)
    if use_kernels:
        return
    # the plain path leaves the caches as the reference does, retired
    # slots included: they keep advancing their position and (contiguous)
    # writing their own row, which the next admission overwrites; a paged
    # pool holds one block past the reference's, the sink, which holds no
    # position
    for got, want in zip(got_caches, want_caches):
        for name, w in want.items():
            g = got[name][:len(w)]
            if w.dtype == torch.int32:
                assert torch.equal(g, w), name
            else:
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        if paged:
            assert len(got["ppos"]) == len(want["ppos"]) + 1
            assert bool((got["ppos"][-1] == -1).all())


def test_paged_pool_drains(drained):
    """Every block is back in the pool after the drain.  (The two layouts'
    tokens differ for prompts past the window: the clipped contiguous ring
    drops in-window context at chunk boundaries, the paged ring does not,
    in the reference as here.)"""
    paged = drained[True, True]
    assert paged[2]["kv_blocks_used"] == 0
    assert paged[2]["kv_blocks_free"] == ENGINE["slots"] * 3


@functools.cache
def _params():
    return TT.init_params(get_arch(ARCH).reduced(),
                          torch.Generator().manual_seed(0), device="cpu")


def _engine(**kw):
    """A port engine on the CPU with the port's own random weights."""
    cfg = get_arch(ARCH).reduced()
    args = dict(ENGINE, clock=VirtualClock(RATES), device="cpu")
    args.update(kw)
    return cfg, ServeEngine(cfg, _params(), **args)


def test_overflow_reject_and_truncate():
    cfg, eng = _engine()
    long = np.arange(45) % cfg.vocab_size
    with pytest.raises(ValueError, match="exceeds cache_capacity-1"):
        eng.submit(Request(rid="x", tokens=long, max_new_tokens=2))
    _, eng = _engine(overflow="truncate")
    req = Request(rid="x", tokens=long, max_new_tokens=2)
    eng.submit(req)
    assert req.prompt_truncated and len(req.tokens) == 39
    assert list(req.tokens) == list(long[-39:])
    (done,) = eng.run()
    # the prefill's token, then one decode takes slot_pos to capacity-1
    assert len(done.generated) == 2
    with pytest.raises(ValueError):
        _engine(overflow="drop")


def test_block_pool_backpressure():
    """A small pool admits what fits, re-queues the rest at the front of
    its class (``BlockPoolExhausted`` never escapes), and a request that
    can never fit is rejected at submit."""
    cfg, eng = _engine(num_blocks=4)
    rng = np.random.default_rng(2)
    for i in range(4):
        eng.submit(Request(rid=f"b{i}", tokens=rng.integers(0, 256, 9),
                           max_new_tokens=3))
    eng.step()
    assert sum(r is not None for r in eng.active) == 1   # 3 blocks each
    assert len(eng.queue) == 3 and eng.block_pool.used_blocks == 3
    done = eng.run()
    assert [r.rid for r in done] == ["b0", "b1", "b2", "b3"]
    assert all(len(r.generated) == 3 for r in done)
    assert eng.block_pool.used_blocks == 0
    with pytest.raises(BlockPoolExhausted):
        eng.block_pool.alloc(5, "x")
    # the window clips a request to 3 table columns: 2 blocks never do
    _, tiny = _engine(num_blocks=2)
    with pytest.raises(ValueError, match="grow num_blocks"):
        tiny.submit(Request(rid="big", tokens=rng.integers(0, 256, 30),
                            max_new_tokens=8))


def test_deadline_budget_truncates():
    """ESD 4 at 50 ms/token: a 400 ms deadline affords 2 tokens."""
    cfg, eng = _engine(eda=EDAConfig(esd=4.0))
    eng.token_cost_ms.update(50.0)
    eng.submit(Request(rid="t", tokens=np.arange(9), max_new_tokens=8,
                       deadline_ms=400.0))
    (r,) = eng.run()
    assert r.truncated and len(r.generated) <= 3 and r.skip_rate > 0.5
    cfg, eng = _engine(eda=EDAConfig(esd=0.0))
    eng.submit(Request(rid="f", tokens=np.arange(9), max_new_tokens=8,
                       deadline_ms=1.0))
    (r,) = eng.run()
    assert not r.truncated and len(r.generated) == 8


def test_evacuate_and_adopt_keep_seniority():
    """Evacuation rewinds actives (prefill lost), returns their blocks and
    hands back queued requests; the adopter rebases arrival by the age."""
    cfg, eng = _engine(slots=1)
    rng = np.random.default_rng(4)
    for i in range(3):
        eng.submit(Request(rid=f"e{i}", tokens=rng.integers(0, 256, 6),
                           max_new_tokens=4, priority=i % 2))
    eng.step()
    eng.step()
    orphans = eng.evacuate()
    assert [r.rid for r, _ in orphans] == ["e0", "e2", "e1"]
    assert eng.block_pool.used_blocks == 0 and not eng.has_work()
    assert orphans[0][0].generated == [] and orphans[0][0].lane == -1
    _, other = _engine(slots=2)
    other.clock.advance(1.0)
    for req, age in orphans:
        other.adopt_request(req, age)
        assert req.arrival_s == pytest.approx(1.0 - age)
    done = other.run()
    assert sorted(r.rid for r in done) == ["e0", "e1", "e2"]
    assert all(len(r.generated) == 4 and r.ttft_ms > 0 for r in done)


def test_retire_emits_events_and_metrics():
    from repro_torch.events.envelope import DEADLINE_MISS, TOKEN_DONE
    from repro_torch.obs.metrics import MetricsRegistry

    class Emitter:
        def __init__(self):
            self.events = []

        def emit(self, rid, kind, value, **kw):
            self.events.append((rid, kind, value))

    cfg, eng = _engine(eda=EDAConfig(esd=4.0))
    eng.emitter = Emitter()
    eng.attach_obs(metrics=MetricsRegistry())
    eng.token_cost_ms.update(50.0)
    eng.submit(Request(rid="a", tokens=np.arange(5), max_new_tokens=3))
    eng.submit(Request(rid="b", tokens=np.arange(7), max_new_tokens=8,
                       deadline_ms=400.0))
    eng.run()
    kinds = [(rid, kind) for rid, kind, _ in eng.emitter.events]
    assert ("a", TOKEN_DONE) in kinds and ("b", DEADLINE_MISS) in kinds
    assert ("a", DEADLINE_MISS) not in kinds
    assert "serve_retired_total" in eng.metrics.expose()


def test_insert_row_writes_per_layer_cache_list_in_place():
    """Contiguous admission: ``insert_row`` copies a 1-row prefill cache
    into the slot's row of every layer's tensors, in their own storage."""
    from repro_torch.core.engine_core import insert_row
    cfg = get_arch(ARCH).reduced()
    pool = TT.init_caches(cfg, 3, 16, device="cpu")
    row = TT.init_caches(cfg, 1, 16, device="cpu")
    for i, layer in enumerate(row):
        for name, t in layer.items():
            t.copy_(torch.full_like(t, i + 7))
    ptrs = [{k: t.data_ptr() for k, t in layer.items()} for layer in pool]
    assert insert_row(pool, row, 1) is pool
    for i, layer in enumerate(pool):
        for name, t in layer.items():
            assert t.data_ptr() == ptrs[i][name]
            assert (t[1] == i + 7).all()
            assert (t[0] == t[2]).all() and not (t[0] == i + 7).any()


def test_priority_admission_order():
    cfg, eng = _engine(slots=1)
    rng = np.random.default_rng(5)
    for rid, pr in (("inner-0", 1), ("inner-1", 1), ("outer-0", 0)):
        eng.submit(Request(rid=rid, tokens=rng.integers(0, 256, 6),
                           max_new_tokens=3, priority=pr))
    order = [r.rid for r in eng.run()]
    assert order.index("outer-0") < order.index("inner-1")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_greedy_matches_full_forward(paged):
    """Within the window, the engine's greedy stream equals argmax of a
    full forward over the growing sequence (the kernels' plain path)."""
    from repro_torch.serving.engine import _argmax_sample
    assert int(_argmax_sample(torch.tensor([1.0, 3.0, 3.0]))) == 1  # ties
    cfg, eng = _engine(slots=2, paged=paged, opts=RunOpts(use_kernels=True))
    prompt = np.random.default_rng(6).integers(0, 256, 3)
    eng.submit(Request(rid="g", tokens=prompt, max_new_tokens=4))
    got = eng.run()[0].generated
    seq, want = list(prompt), []
    for _ in range(4):
        logits, _, _ = TT.forward(cfg, _params(),
                                  torch.tensor(seq, dtype=torch.long)[None])
        want.append(int(torch.argmax(logits[0, -1])))
        seq.append(want[-1])
    assert got == want


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "4", "--prompt-len", "9"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "class 0: mean turnaround" in out
