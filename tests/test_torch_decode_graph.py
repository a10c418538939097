"""The paged decode tick's graph form, on the CPU.

A paged ``ServeEngine`` on the card replays its decode forward from one
CUDA graph at B = ``slots`` (``serving.engine.DecodeGraph``), captured at
its first admission after the prefill graphs.  What the graph holds that
the eager tick did not: a write plan that sends a retired slot's entry
into the pool's sink block instead of compacting it away
(``attention.paged_decode_plan``), static inputs filled by one upload a
tick, and the tick counts.  These tests hold each to the eager path.  The
capture's two CUDA steps (the side-stream warm-up and the recording) are
replaced by stand-ins that run the forward eagerly, so the engine's own
capture and replay code runs here; the capture and the replays on the card
are in ``tests/test_torch_cuda.py``.
"""
import gc
import json
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers import lm_serve_moe as D
from repro_torch.config import get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.models import attention as attn
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.probes import jit_cache_entries
from repro_torch.obs.tracing import SpanTracer
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving import engine as serving

ROOT = Path(__file__).resolve().parents[1]
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
# reduced starcoder2-3b's window of 8 over blocks of 4: a ring of 3
# columns that every request past 12 tokens wraps; 3 slots for 7
# requests, so slots retire and are admitted again mid-drain
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8, block_size=4)
LENS = (5, 23, 12, 9, 17, 3, 30)
# deepseek-v2-lite's published file made small (``test_torch_dsv2_lite``)
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=8, n_routed_experts=8, num_experts_per_tok=3,
             n_shared_experts=2, moe_intermediate_size=32,
             intermediate_size=128, num_hidden_layers=3, vocab_size=256,
             dtype="float32")
ARCHS = ["dense", "mla_moe"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{"dense": reduced starcoder2-3b, "mla_moe": small deepseek-v2-lite}
    as (cfg, params) on the CPU."""
    cfg = get_arch("starcoder2-3b").reduced()
    conf = dict(json.loads((ROOT / "portbench" / "configs"
                            / "deepseek-v2-lite.json").read_text()), **SMALL)
    mcfg = D.model_config(conf)
    return {"dense": (cfg, TT.init_params(
                cfg, torch.Generator().manual_seed(0), device="cpu")),
            "mla_moe": (mcfg, D.weights(torch, mcfg, 2 ** 31 + 29,
                                        torch.device("cpu")))}


class _EagerGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    forward it holds and leaves its output in the static output."""

    def __init__(self, forward, out):
        self.forward, self.out = forward, out

    def replay(self):
        self.out.copy_(self.forward())


@pytest.fixture
def stand_in_capture(monkeypatch):
    """The capture's CUDA steps replaced: the warm-up runs each forward
    eagerly, the recording runs it once more and keeps it as an
    :class:`_EagerGraph`."""
    def warm_up(eng, forwards):
        with eng.observing():
            for f in forwards:
                f()

    def record(eng, forward, pool):
        with eng.observing():
            out = forward()
        return _EagerGraph(forward, out), out, {}

    monkeypatch.setattr(serving, "_warm_up", warm_up)
    monkeypatch.setattr(serving, "_record", record)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")


def _engine(models, arch, graphs=False, **kw):
    """An engine on the CPU; ``graphs``: with the card's prefill and
    decode graphs (captured through the stand-ins)."""
    cfg, params = models[arch]
    args = dict(ENGINE, clock=VirtualClock(RATES), device="cpu", paged=True)
    args.update(kw)
    eng = ServeEngine(cfg, params, **args)
    if graphs:
        eng._graphs = serving.PrefillGraphs(eng)
        eng._decode = serving.DecodeGraph(eng)
    return eng


def _submit(eng, vocab=256):
    rng = np.random.default_rng(3)
    for i, n in enumerate(LENS):
        eng.submit(Request(rid=f"r{i}", tokens=rng.integers(0, vocab, n),
                           max_new_tokens=6, priority=i % 2))


def _drain(eng, before_tick=None):
    """Run ``eng`` over :data:`LENS` tick by tick; returns each request's
    tokens and the number of ticks that decoded."""
    _submit(eng)
    decoded = 0
    while eng.has_work():
        if before_tick is not None:
            before_tick(eng)
        decoded += bool(eng.step())
    return {r.rid: r.generated for r in eng.finished}, decoded


@pytest.mark.parametrize("seed", range(4))
def test_decode_plan_leaves_the_write_plans_pool(seed):
    """Random pool geometries, slots of recycled blocks (stale positions
    and K/V) at positions that wrap their rings, and retired slots (a -1
    table row): ticks written through ``paged_decode_plan`` leave ``kp``,
    ``vp`` and ``ppos`` of every block bit for bit as ``paged_write_plan``
    (with its reset of nothing) leaves them, and the sink holds no
    position."""
    rng = np.random.default_rng(seed)
    nb, bs = int(rng.integers(12, 40)), int(rng.choice([1, 2, 4, 8, 16]))
    hkv, d = int(rng.integers(1, 4)), int(rng.choice([4, 8]))
    B, cols = int(rng.integers(3, 9)), int(rng.integers(1, 4))
    tbl = np.full((B, cols), -1, np.int32)
    tlen = np.ones((B,), np.int32)
    free = list(rng.permutation(nb))
    live = rng.random(B) < 0.6
    live[0], live[-1] = True, False
    for b in np.flatnonzero(live):
        tlen[b] = int(rng.integers(1, cols + 1))
        tbl[b, :tlen[b]] = [free.pop() for _ in range(tlen[b])]
    pos = rng.integers(0, 4 * cols * bs, B).astype(np.int32)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    stale = {"kp": randn(nb + 1, bs, hkv, d), "vp": randn(nb + 1, bs, hkv, d),
             "ppos": torch.from_numpy(
                 rng.integers(-1, 500, (nb + 1, bs)).astype(np.int32))}
    stale["ppos"][nb] = -1
    eager = {k: t[:nb].clone() for k, t in stale.items()}
    graph = {k: t.clone() for k, t in stale.items()}
    pages = {"tbl": torch.from_numpy(tbl), "len": torch.from_numpy(tlen)}
    for tick in range(2 * cols * bs + 1):
        p = torch.from_numpy(pos + tick)[:, None]
        k, v = randn(B, 1, hkv, d), randn(B, 1, hkv, d)
        attn.paged_write(eager, k, v, p, dict(
            pages, reset=torch.zeros(B, dtype=torch.int32)))
        attn.paged_write(graph, k, v, p, dict(
            pages, plan=attn.paged_decode_plan(p, pages, nb, bs)))
        for name in stale:
            assert torch.equal(graph[name][:nb], eager[name]), (name, tick)
        assert bool((graph["ppos"][nb] == -1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_the_sink_stays_unread_and_empty(models, arch):
    """A drain with slots retiring and admitted again: with the sink's
    features poisoned (NaN) before every tick, the engine serves the
    tokens of an unpoisoned one; after every tick the sink holds no
    position and no table names it; it is the pool's one block past the
    ``BlockPool``'s."""
    want, _ = _drain(_engine(models, arch))
    eng = _engine(models, arch)
    sink = eng.sink
    assert sink == eng.num_blocks == eng.block_pool.num_blocks
    assert all(len(c["ppos"]) == sink + 1 for c in eng.caches)

    def poison(e):
        for c in e.caches:
            assert bool((c["ppos"][sink] == -1).all())
            for name, t in c.items():
                if t.is_floating_point():
                    t[sink] = float("nan")
        assert not (e._tbl == sink).any()

    got, _ = _drain(eng, poison)
    poison(eng)
    assert got == want


@pytest.mark.parametrize("arch,use_kernels", [
    ("dense", False), ("dense", True), ("mla_moe", False)],
    ids=["dense-plain", "dense-kernels", "mla_moe"])
def test_graph_path_serves_the_eager_engines_tokens_and_pool(
        models, stand_in_capture, arch, use_kernels):
    """The engine through its capture and replays (stand-in graphs)
    against the eager engine, same weights and prompts, through
    admissions and retirements: the same token streams; the same pool
    (every position, the sink's included, and the features at every live
    entry: an empty entry may hold a capture's warm-up values); every
    decode tick a replay, captured once at the first admission; the eager
    engine's every tick eager."""
    out = {}
    for graphs in (False, True):
        eng = _engine(models, arch, graphs,
                      opts=RunOpts(use_kernels=use_kernels))
        tokens, decoded = _drain(eng)
        out[graphs] = tokens, decoded, eng.caches, eng.stats()
        if graphs:
            assert eng._decode.graph is not None
    (tokens, decoded, caches, stats), (want, want_decoded, want_caches,
                                       want_stats) = out[True], out[False]
    assert tokens == want and decoded == want_decoded
    for got, ref in zip(caches, want_caches):
        assert torch.equal(got["ppos"], ref["ppos"])
        live = ref["ppos"] >= 0
        for name, t in ref.items():
            if t.is_floating_point():
                assert torch.equal(got[name][live], t[live]), name
    assert (stats["decode_graph_replays"], stats["decode_eager_ticks"]) == (
        decoded, 0)
    assert (want_stats["decode_graph_replays"],
            want_stats["decode_eager_ticks"]) == (0, decoded)
    assert stats["prefill_eager_chunks"] == 0 and stats["kv_blocks_used"] == 0


def test_decode_counts_and_the_graphs_signature(models, stand_in_capture,
                                                monkeypatch):
    """The first admission captures the prefill widths and the decode
    graph, one ``GRAPH_SIGNATURES`` entry each (the decode graph's keyed
    ``("decode", slots)``), counted by ``jit_cache_entries`` and never
    again after; with metrics attached, the replays are counted in
    ``serve_decode_graph_replays_total`` and no eager tick is."""
    monkeypatch.setattr(serving, "GRAPH_SIGNATURES", set())
    eng = _engine(models, "dense", graphs=True)
    eng.attach_obs(metrics=MetricsRegistry())
    _submit(eng)
    before = jit_cache_entries()
    eng.step()
    cpu = torch.device("cpu")
    assert serving.GRAPH_SIGNATURES == {
        eng.graph_signature(cpu, k)
        for k in eng._graphs.widths + [("decode", eng.slots)]}
    assert jit_cache_entries() == before + len(eng._graphs.widths) + 1
    entries = jit_cache_entries()
    while eng.has_work():
        eng.step()
    assert jit_cache_entries() == entries
    st = eng.stats()
    counter = eng.metrics.get("serve_decode_graph_replays_total")
    assert counter.labels(engine=eng.name).value == st[
        "decode_graph_replays"] > 0
    assert "serve_decode_eager_ticks_total" not in eng.metrics
    assert st["decode_eager_ticks"] == 0


def test_a_dropped_engine_frees_its_pool_without_the_collector(
        models, stand_in_capture):
    """An engine that captured its graphs and served, dropped while the
    cyclic garbage collector is off, is freed at once with its pool: its
    graphs refer to it weakly, so no cycle runs through it (one left to
    the collector could destroy its graphs inside another engine's
    capture, which invalidates that capture on the card)."""
    eng = _engine(models, "mla_moe", graphs=True)
    _drain(eng)
    assert eng._decode.graph is not None and eng._graphs.graphs
    refs = [weakref.ref(eng)] + [weakref.ref(t) for c in eng.caches
                                 for t in c.values()]
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engines_off_the_card_decode_every_tick_eagerly(models, paged):
    """On the CPU, paged or contiguous, no decode graph is made: every tick
    decodes eagerly, in ``stats()`` and in the engine's counters."""
    eng = _engine(models, "dense", paged=paged,
                  opts=RunOpts(use_kernels=True))
    eng.attach_obs(metrics=MetricsRegistry())
    _, decoded = _drain(eng)
    assert eng._decode is None
    st = eng.stats()
    assert (st["decode_graph_replays"], st["decode_eager_ticks"]) == (
        0, decoded)
    counter = eng.metrics.get("serve_decode_eager_ticks_total")
    assert counter.labels(engine=eng.name).value == decoded
    assert "serve_decode_graph_replays_total" not in eng.metrics


def test_upload_packs_the_engine_state_in_one_buffer(models,
                                                     stand_in_capture):
    """After the capture the static table is all -1 (every warm-up entry
    went to the sink); an upload fills the four inputs, each starting on
    64 bytes, with the slots' last tokens, positions, table rows and ring
    lengths; a replay tick's spans are the eager tick's, ``decode.forward``
    marked ``graph=1``, with no ``mla`` or ``moe`` span inside."""
    eng = _engine(models, "mla_moe", graphs=True)
    tracer = SpanTracer()
    eng.attach_obs(tracer=tracer)
    _submit(eng)
    g = eng._decode
    eng._graphs.capture()
    g.capture(eng._graphs.pool)
    assert bool((g.parts(g.buf)[2] == -1).all())
    eng.step()
    assert all(o % 16 == 0 for o in g.offsets)
    g.upload()
    tok, pos, tbl, tlen = g.parts(g.buf)
    assert tok.tolist() == eng.slot_last.tolist()
    assert pos.tolist() == eng.slot_pos.tolist()
    assert torch.equal(tbl, torch.from_numpy(eng._tbl))
    assert tlen.tolist() == eng._tbl_len.tolist()
    for c in eng.caches:
        assert bool((c["ppos"][eng.sink] == -1).all())
    n = len(tracer.spans())
    eng.step()
    names = [(e["name"], e.get("args", {}).get("graph"))
             for e in tracer.spans()[n:]]
    assert ("decode.forward", 1) in names
    assert {"decode", "decode.upload", "decode.read", "commit"} <= {
        name for name, _ in names}
    assert not {"mla", "moe"} & {name for name, _ in names}
