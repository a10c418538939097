"""The paged prefill chunk's graph form, on the CPU.

A paged ``ServeEngine`` on the card replays each prefill chunk from a CUDA
graph (``serving.engine.PrefillGraphs``).  A graph replays the kernels its
capture recorded; what differs from the eager chunk is what it may hold:
a write plan that takes every entry and resets nothing
(``attention.paged_decode_plan``), with the recycled blocks invalidated
once ahead of the first chunk (``attention.invalidate_blocks``), RoPE's
kept frequencies, static inputs, and the chunk counts.  These tests hold
each of those to the eager path.  A stand-in graph whose replay runs the
forward it holds drives the engine through the graph path here; the
capture and the replays run on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.config import get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.kernels import attention_common as ac
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.engine import PrefillGraphs

RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
# reduced starcoder2-3b's window of 8 over blocks of 4: a ring of 3
# columns (12 entries) and chunks of at most 8, so these prompts take
# every width (1, 2, 4, 8) and those past 12 tokens wrap the ring
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8, block_size=4)
LENS = (5, 23, 12, 9, 17, 3, 30)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _model():
    cfg = get_arch("starcoder2-3b").reduced()
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def _chunks(lens, top=8):
    """Chunks of the engine's descending powers of two up to ``top``."""
    return sum(n // top + bin(n % top).count("1") for n in lens)


def _drain(eng):
    rng = np.random.default_rng(3)
    for i, n in enumerate(LENS):
        eng.submit(Request(rid=f"r{i}", tokens=rng.integers(0, 256, n),
                           max_new_tokens=6, priority=i % 2))
    return {r.rid: r.generated for r in eng.run()}


class _EagerGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    forward it holds and leaves its token in the static output."""

    def __init__(self, forward, out):
        self.forward, self.out = forward, out

    def replay(self):
        self.out.copy_(self.forward())


def _with_eager_graphs(eng):
    """``eng`` with :class:`_EagerGraph` in place of each capture, made as
    ``PrefillGraphs.capture`` makes the graphs (borrowed blocks, one
    forward a width before the capture)."""
    g = PrefillGraphs(eng)
    blocks = eng.block_pool.alloc(-(-g.widths[-1] // eng.block_size),
                                  g.OWNER)
    g.static_inputs(blocks)
    for w in g.widths:
        out = g.forward(w)
        g.graphs[w] = (_EagerGraph(functools.partial(g.forward, w), out),
                       out, {})
    eng.block_pool.free(blocks[::-1], g.OWNER)
    eng._graphs = g
    return eng


@pytest.mark.parametrize("seed", range(4))
def test_chunk_plan_after_invalidation_leaves_the_write_plans_pool(seed):
    """Random pool geometries, a slot of recycled blocks that still hold a
    former owner's positions and K/V, a prompt that wraps the slot's ring:
    invalidating the slot's blocks once and writing every chunk through
    the graphs' plan (``paged_decode_plan``) leaves ``kp``, ``vp`` and
    ``ppos`` bit for bit as ``paged_write_plan`` does with the reset on the
    first chunk, the pool's sink block included (every entry lands)."""
    rng = np.random.default_rng(seed)
    nb, bs = int(rng.integers(8, 40)), int(rng.choice([1, 2, 4, 8, 16]))
    hkv, d = int(rng.integers(1, 4)), int(rng.choice([4, 8]))
    cols = int(rng.integers(2, 8))
    ring = int(rng.integers(1, cols + 1))
    blocks = rng.choice(nb, ring, replace=False)
    tbl = np.full((1, cols), -1, np.int32)
    tbl[0, :ring] = blocks

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    # one block past the table's reach, the sink (block nb), empty
    stale = {"kp": randn(nb + 1, bs, hkv, d), "vp": randn(nb + 1, bs, hkv, d),
             "ppos": torch.from_numpy(
                 rng.integers(-1, 500, (nb + 1, bs)).astype(np.int32))}
    stale["ppos"][nb] = -1
    eager = {k: t.clone() for k, t in stale.items()}
    graph = {k: t.clone() for k, t in stale.items()}
    pages = {"tbl": torch.from_numpy(tbl),
             "len": torch.tensor([ring], dtype=torch.int32)}
    attn.invalidate_blocks(graph, torch.from_numpy(blocks).long())
    S = int(rng.integers(2 * ring * bs, 3 * ring * bs + 1))
    top = 1 << ((ring * bs).bit_length() - 1)
    c0 = 0
    while c0 < S:
        w = top
        while w > S - c0:
            w //= 2
        pos = torch.arange(c0, c0 + w, dtype=torch.int32)[None]
        k, v = randn(1, w, hkv, d), randn(1, w, hkv, d)
        attn.paged_write(eager, k, v, pos, dict(
            pages, reset=torch.tensor([int(c0 == 0)], dtype=torch.int32)))
        attn.paged_write(graph, k, v, pos, dict(
            pages, plan=attn.paged_decode_plan(pos, pages, nb, bs)))
        for name in stale:
            assert torch.equal(graph[name], eager[name]), (name, c0, w)
        c0 += w


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_graph_path_serves_the_eager_engines_tokens_and_pool(use_kernels):
    """The engine through the graph path (stand-in graphs) against the
    eager engine, same weights and prompts: the same token streams, the
    same pool (every position, and K/V at every live entry: an empty
    entry may hold a borrowed block's warm-up values), every chunk a
    replay; the eager engine counts every chunk eager."""
    cfg, params = _model()
    out = {}
    for graphs in (False, True):
        eng = ServeEngine(cfg, params, clock=VirtualClock(RATES),
                          opts=RunOpts(use_kernels=use_kernels),
                          device="cpu", **ENGINE)
        if graphs:
            _with_eager_graphs(eng)
        out[graphs] = (_drain(eng), eng.caches, eng.stats())
    (tokens, caches, stats), (want, want_caches, want_stats) = (out[True],
                                                                out[False])
    assert tokens == want
    for got, ref in zip(caches, want_caches):
        assert torch.equal(got["ppos"], ref["ppos"])
        live = ref["ppos"] >= 0
        assert torch.equal(got["kp"][live], ref["kp"][live])
        assert torch.equal(got["vp"][live], ref["vp"][live])
    n = _chunks(LENS)
    assert (stats["prefill_graph_replays"], stats["prefill_eager_chunks"],
            stats["prefill_graphs"]) == (n, 0, 4)
    assert (want_stats["prefill_graph_replays"],
            want_stats["prefill_eager_chunks"],
            want_stats["prefill_graphs"]) == (0, n, 0)
    assert stats["kv_blocks_used"] == 0


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (128, 999999.44),
                                            (256, 1e5)])
def test_rope_freqs_are_the_expressions_values(head_dim, theta):
    """``rope_freqs`` gives bit for bit the frequencies of its expression:
    ``theta`` uploaded as an fp32 scalar, raised to ``2i / head_dim``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    want = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
    for device in (None, "cpu", torch.device("cpu")):
        got = layers.rope_freqs(head_dim, theta, device)
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_forward_keeps_a_plan_it_is_given(monkeypatch):
    """``forward`` writes the new K/V where a given plan says, and computes
    no plan of its own."""
    cfg, params = _model()
    caches = TT.init_paged_caches(cfg, 8, 4, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("forward computed a plan")

    monkeypatch.setattr(attn, "paged_write_plan", refuse)
    pos = torch.arange(4, dtype=torch.int32)[None]
    pages = {"tbl": torch.tensor([[2, 5, 7]], dtype=torch.int32),
             "len": torch.tensor([3], dtype=torch.int32),
             # block 6, which the table does not hold
             "plan": {"reset": None, "src": None,
                      "dst": torch.arange(24, 28), "pos": pos.reshape(-1)}}
    TT.forward(cfg, params, torch.tensor([[1, 2, 3, 4]]), positions=pos,
               caches=caches, pages=pages, opts=RunOpts())
    for c in caches:
        assert c["ppos"][6].tolist() == [0, 1, 2, 3]
        assert int((c["ppos"] >= 0).sum()) == 4


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engines_off_the_card_run_every_chunk_eagerly(paged):
    """On the CPU, paged or contiguous, no graph is made: every chunk runs
    eagerly, in ``stats()`` and in the engine's counters."""
    cfg, params = _model()
    eng = ServeEngine(cfg, params, clock=VirtualClock(RATES), paged=paged,
                      opts=RunOpts(use_kernels=True), device="cpu", **ENGINE)
    eng.attach_obs(metrics=MetricsRegistry())
    _drain(eng)
    assert eng._graphs is None
    st = eng.stats()
    n = _chunks(LENS)
    assert (st["prefill_graph_replays"], st["prefill_eager_chunks"],
            st["prefill_graphs"]) == (0, n, 0)
    counter = eng.metrics.get("serve_prefill_eager_chunks_total")
    assert counter.labels(engine=eng.name).value == n
    assert "serve_prefill_graph_replays_total" not in eng.metrics


def test_graph_widths_follow_the_chunk_the_ring_and_the_pool():
    """One graph a power of two up to the widest chunk any admission can
    take: ``prefill_chunk``, the capacity, the ring's entries and the
    pool's, whichever is smallest."""
    cfg, params = _model()
    wide = dataclasses.replace(cfg, window=4096)

    def widths(c, **kw):
        args = dict(slots=1, cache_capacity=3072, prefill_chunk=128,
                    block_size=16, device="cpu")
        args.update(kw)
        return PrefillGraphs(ServeEngine(c, params, **args)).widths

    assert widths(cfg, **ENGINE) == [1, 2, 4, 8]
    assert widths(wide) == [1, 2, 4, 8, 16, 32, 64, 128]
    assert widths(wide, num_blocks=4) == [1, 2, 4, 8, 16, 32, 64]
    assert widths(wide, prefill_chunk=100) == [1, 2, 4, 8, 16, 32, 64]
    assert widths(wide, cache_capacity=20) == [1, 2, 4, 8, 16]


def test_counters_a_graph_holds_stay_alive_and_replays_count(monkeypatch):
    """``reserve_counters`` sizes both ticket buffers for an engine's
    largest calls, which then leave them in place; a larger call replaces
    a buffer but keeps the old one alive.  ``add_launches`` moves the
    launch counts both ways."""
    monkeypatch.setattr(ac, "_COUNTERS", {})
    monkeypatch.setattr(ac, "_REPLACED", [])
    cpu = torch.device("cpu")
    # starcoder2-3b's heads (24 over 2), 256 decode rows, 128-token chunks
    ac.reserve_counters(cpu, 24, 2, torch.bfloat16, decode_rows=256,
                        flash_tokens=128)
    dec, flash = ac.decode_counters(cpu), ac.flash_counters(cpu)
    assert dec.numel() == 256 * 2 and flash.numel() == 256
    assert ac.decode_counters(cpu, 512) is dec
    assert ac.flash_counters(cpu, 2 * 128 * 12 // 64) is flash
    assert ac._REPLACED == []
    bigger = ac.decode_counters(cpu, 513)
    assert bigger.numel() == 513 and ac._REPLACED[0] is dec
    before = kops.launches()
    kops.add_launches({"paged_flash": 30, "paged_decode": 2})
    after = kops.launches()
    kops.add_launches({"paged_flash": -30, "paged_decode": -2})
    assert after == dict(before, paged_flash=before["paged_flash"] + 30,
                         paged_decode=before["paged_decode"] + 2)
    assert kops.launches() == before
