"""Port parity: repro_torch.serving.ServeEngine vs the reference engine on
the recurrent and hybrid stacks.

Reduced recurrentgemma-9b (RG-LRU + window-8 local attention) and reduced
xlstm-350m (mLSTM + sLSTM), fp32, the reference's own initialised
parameters converted with ``repro_torch.convert``, and a ``VirtualClock``
at fixed ``TOKEN``/``PREFILL``/``TICK`` rates on both sides.  Both archs
serve from contiguous caches only: a fresh 1-row ``init_caches`` row per
admission (attention rings and recurrent states, sentinels included),
``insert_row`` of its dict states at batch axis 0.  One module-scoped
fixture drains one workload (odd prompts that end in a 1-token chunk, both
priorities, deadlines under an ESD budget) through the reference (plain
path) and the port (plain path and ``use_kernels=True``, which on the CPU
runs the kernels' plain versions).  Token streams, every ``Request``
timing field, every ``SegmentRecord`` field, ``stats()`` and the final
caches must be equal (caches within rtol 1e-4 / atol 1e-5).
"""
import dataclasses

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
from repro_torch.core.engine_core import insert_row
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.kernels import rglru as rglru_k
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.serving import Request, ServeEngine

ARCHS = ("recurrentgemma-9b", "xlstm-350m")
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8)
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


def _reqs(cls):
    return [cls(rid=rid, tokens=toks, max_new_tokens=mx, priority=pr,
                deadline_ms=dl) for rid, toks, mx, pr, dl in _workload()]


def _port_stats(ticks, n=None):
    """The port's own prefill and decode counts in ``stats()`` on the CPU
    after the first ``n`` prompts: no graph, every chunk eager, at most
    ``prefill_chunk`` (8) wide (the descending powers of two of each
    prompt), and every one of the engine's ``ticks`` an eager decode."""
    chunks = sum(len(toks) // 8 + bin(len(toks) % 8).count("1")
                 for _, toks, *_ in _workload()[:n])
    return {"prefill_graph_replays": 0, "prefill_eager_chunks": chunks,
            "prefill_graphs": 0, "decode_graph_replays": 0,
            "decode_eager_ticks": ticks}


def _summary(eng, done):
    reqs = [(r.rid, list(r.generated), *[getattr(r, f) for f in TIMING])
            for r in done]
    recs = [dataclasses.asdict(r) for r in eng.ledger.records]
    return reqs, recs, eng.stats()


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jc, tc = jget_arch(arch).reduced(), get_arch(arch).reduced()
        jp = JT.init_params(jc, jax.random.key(0))
        out[arch] = (jc, tc, jp, convert.transformer_from_jax(
            jax.tree.map(np.asarray, jp), tc, device="cpu"))
    return out


@pytest.fixture(scope="module")
def drained(models):
    """{(arch, side): (summary, final caches)}."""
    out = {}
    for arch in ARCHS:
        jc, tc, jp, tp = models[arch]
        j = JServeEngine(jc, jp, clock=JClock(rates=RATES),
                         eda=JEDAConfig(esd=2.0), **ENGINE)
        for r in _reqs(JRequest):
            j.submit(r)
        out[arch, "ref"] = _summary(j, j.run()), convert.caches_from_jax(
            jax.tree.map(np.asarray, j.caches), tc, device="cpu")
        for use_kernels in (False, True):
            t = ServeEngine(tc, tp, clock=VirtualClock(RATES),
                            eda=EDAConfig(esd=2.0), device="cpu",
                            opts=RunOpts(use_kernels=use_kernels), **ENGINE)
            assert not t.paged
            for r in _reqs(Request):
                t.submit(r)
            out[arch, use_kernels] = _summary(t, t.run()), t.caches
            t.ledger.check()
    return out


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(drained, arch, use_kernels):
    (want, want_caches) = drained[arch, "ref"]
    (got, got_caches) = drained[arch, use_kernels]
    want_reqs, want_recs, want_stats = want
    got_reqs, got_recs, got_stats = got
    assert [r[:2] for r in got_reqs] == [r[:2] for r in want_reqs]
    assert got_reqs == want_reqs
    assert got_recs == want_recs
    assert got_stats == dict(want_stats, **_port_stats(want_stats["ticks"]))
    assert len(got_reqs) == len(_workload())
    assert any(r[2 + TIMING.index("truncated")] for r in got_reqs)
    # every slot's final state, retired slots included (they keep stepping
    # their own row, which the next admission overwrites)
    for g, w in zip(got_caches, want_caches):
        assert set(g) == set(w)
        for name, t in w.items():
            if t.dtype == torch.int32:
                assert torch.equal(g[name], t), name
            else:
                torch.testing.assert_close(g[name], t, rtol=1e-4, atol=1e-5)


def test_kernel_flag_routes_only_prefill_chunks(models, monkeypatch):
    """With ``use_kernels`` the RG-LRU scan is called once per RG-LRU
    layer for every prefill chunk of two or more tokens, never for a
    1-token chunk or a decode tick; the served mLSTM never calls its
    kernel (cached chunks take the exact step recurrence)."""
    calls = {"rglru": [], "mlstm": []}
    real_r, real_m = rglru_k.rglru_scan, mlstm_k.mlstm_chunkwise
    monkeypatch.setattr(rglru_k, "rglru_scan", lambda *a: calls["rglru"].append(
        a[0].shape[1]) or real_r(*a))
    monkeypatch.setattr(mlstm_k, "mlstm_chunkwise", lambda *a: calls[
        "mlstm"].append(a[0].shape[1]) or real_m(*a))
    chunks = []
    for arch in ARCHS:
        _, tc, _, tp = models[arch]
        eng = ServeEngine(tc, tp, clock=VirtualClock(RATES), device="cpu",
                          opts=RunOpts(use_kernels=True), **ENGINE)
        for r in _reqs(Request):
            eng.submit(r)
        eng.run()
        if arch == ARCHS[0]:
            for _, toks, *_ in _workload():
                n = len(toks)
                while n:                      # descending powers of two <= 8
                    c = min(8, 1 << (n.bit_length() - 1))
                    chunks.append(c)
                    n -= c
    n_rglru = get_arch(ARCHS[0]).reduced().layer_kinds().count("rglru")
    assert sorted(calls["rglru"]) == sorted(c for c in chunks if c > 1
                                            for _ in range(n_rglru))
    assert calls["mlstm"] == []


def test_insert_row_writes_recurrent_states_in_place():
    """Contiguous admission copies a 1-row cache (attention ring, RG-LRU
    ``h``/``conv``, mLSTM ``C``/``n``/``m``, sLSTM ``c``/``n``/``h``/``m``)
    into slot 1 of every layer's tensors at batch axis 0, in their own
    storage."""
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        pool = TT.init_caches(cfg, 3, 16, device="cpu")
        row = TT.init_caches(cfg, 1, 16, device="cpu")
        for i, layer in enumerate(row):
            for t in layer.values():
                t.copy_(torch.full_like(t, i + 7))
        before = [{k: t.clone() for k, t in layer.items()} for layer in pool]
        ptrs = [{k: t.data_ptr() for k, t in layer.items()} for layer in pool]
        assert insert_row(pool, row, 1) is pool
        for i, layer in enumerate(pool):
            for name, t in layer.items():
                assert t.data_ptr() == ptrs[i][name]
                assert (t[1] == i + 7).all(), (arch, name)
                assert torch.equal(t[0], before[i][name][0])
                assert torch.equal(t[2], before[i][name][2])


@pytest.mark.parametrize("arch", ARCHS)
def test_evacuate_and_adopt_match_reference(models, arch):
    """Two ticks, evacuate (actives rewound, state lost), adopt onto a
    second engine whose clock is 1 s ahead, drain: the same orphans, ages,
    token streams and timings as the reference."""
    jc, tc, jp, tp = models[arch]
    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            mk = lambda slots: JServeEngine(jc, jp, clock=JClock(rates=RATES),
                                            **dict(ENGINE, slots=slots))
            R = JRequest
        else:
            mk = lambda slots: ServeEngine(tc, tp, clock=VirtualClock(RATES),
                                           device="cpu",
                                           **dict(ENGINE, slots=slots))
            R = Request
        eng = mk(1)
        for r in _reqs(R)[:3]:
            eng.submit(r)
        eng.step()
        eng.step()
        orphans = eng.evacuate()
        assert not eng.has_work()
        other = mk(2)
        other.clock.advance(1.0)
        for req, age in orphans:
            other.adopt_request(req, age)
        done = other.run()
        out[side] = ([(r.rid, round(a, 9)) for r, a in orphans],
                     _summary(other, done))
    orphans, (reqs, recs, stats) = out["ref"]
    assert out["port"] == (orphans, (reqs, recs, dict(
        stats, **_port_stats(stats["ticks"], 3))))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_each_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--prompt-len", "9"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    assert "class 0: mean turnaround" in capsys.readouterr().out


def test_recurrent_archs_serve_contiguous_only(models):
    """``paged=None`` picks contiguous caches for both archs;
    ``paged=True`` is refused, as by the reference."""
    for arch in ARCHS:
        _, tc, _, tp = models[arch]
        assert not ServeEngine(tc, tp, device="cpu").paged
        with pytest.raises(ValueError, match="not paged-eligible"):
            ServeEngine(tc, tp, paged=True, device="cpu")
