"""The token engine's phase spans (``serving/engine.py``) on the CPU.

A tiny ``ServeEngine`` (reduced starcoder2-3b, fp32, window 8) drains a few
requests with a ``SpanTracer`` attached, on the paged and on the contiguous
path.  Every ``decode`` holds one ``decode.upload``, ``decode.forward`` and
``decode.read`` and is followed by ``commit`` inside its ``tick``; every
admission's ``prefill`` holds its uploads, one ``prefill.forward`` per chunk
of the descending power-of-two split, and ends in ``prefill.read``.  Under a
``VirtualClock`` the trace repeats across runs and the spans only read the
clock; unsampled ticks record nothing; the names reach the benchmark's
``tracer_spans`` as they are.
"""
import numpy as np
import pytest
import torch

from portbench.harness.session import tracer_spans
from repro_torch.config import get_arch
from repro_torch.core.clock import (PREFILL, TICK, TOKEN, VirtualClock,
                                    WallClock)
from repro_torch.models import transformer as TT
from repro_torch.obs.tracing import NULL_TRACER, SpanTracer
from repro_torch.serving import Request, ServeEngine

RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
PROMPTS = (23, 5, 12, 9, 17, 1)
# the largest chunk: ``prefill_chunk`` on the paged path (16-entry blocks,
# so a slot's ring never caps it); the window's 8-entry ring contiguous
CAP = {True: 16, False: 8}
DECODE = ("decode.upload", "decode.forward", "decode.read")
# rounding of a span's start and length to the nanosecond, in microseconds
NS = 2e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg = get_arch("starcoder2-3b").reduced()
    return cfg, TT.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def _drain(model, paged, clock, tracer=None):
    cfg, params = model
    eng = ServeEngine(cfg, params, slots=2, cache_capacity=64,
                      prefill_chunk=16, paged=paged, block_size=16,
                      clock=clock, device="cpu")
    if tracer is not None:
        eng.attach_obs(tracer=tracer)
    rng = np.random.default_rng(3)
    for i, n in enumerate(PROMPTS):
        eng.submit(Request(rid=f"r{i}", tokens=rng.integers(0, 256, n),
                           max_new_tokens=4 + i % 3))
    done = eng.run()
    return eng, {r.rid: list(r.generated) for r in done}


def _split(n, cap):
    out = []
    while n:
        c = cap
        while c > n:
            c //= 2
        out.append(c)
        n -= c
    return out


def _end(ev):
    return ev["ts"] + ev["dur"]


def _inside(ev, parent):
    return (ev["ts"] >= parent["ts"] - NS
            and _end(ev) <= _end(parent) + NS)


@pytest.fixture(scope="module", params=[True, False], ids=["paged", "dense"])
def traced(request, model):
    """(paged, the wall-clock drain's complete spans in the order they
    closed)."""
    tracer = SpanTracer()
    _drain(model, request.param, WallClock(), tracer)
    return request.param, tracer.spans()


def test_every_decode_holds_its_three_phases_then_a_commit(traced):
    paged, spans = traced
    names = [e["name"] for e in spans]
    decodes = [i for i, n in enumerate(names) if n == "decode"]
    assert decodes and names.count("commit") == len(decodes)
    for i in decodes:
        # spans close innermost first: the three phases, decode, commit,
        # then the tick
        assert tuple(names[i - 3: i]) == DECODE
        assert names[i + 1: i + 3] == ["commit", "tick"]
        dec, commit, tick = spans[i], spans[i + 1], spans[i + 2]
        phases = spans[i - 3: i]
        assert all(_inside(p, dec) for p in phases)
        assert all(a["ts"] + a["dur"] <= b["ts"] + NS
                   for a, b in zip(phases, phases[1:]))
        assert _inside(dec, tick) and _inside(commit, tick)
        assert commit["ts"] >= _end(dec) - NS


def test_every_prefill_holds_one_forward_per_chunk_and_ends_in_read(traced):
    paged, spans = traced
    names = [e["name"] for e in spans]
    prefills = [i for i, n in enumerate(names) if n == "prefill"]
    assert len(prefills) == len(PROMPTS)
    start = 0
    for i in prefills:
        pre, inner = spans[i], spans[start:i]
        # the spans between the previous tick's close and this prefill's
        # are this admission's own
        inner = [e for e in inner if e["name"].startswith("prefill.")]
        widths = [e["args"]["tokens"] for e in inner
                  if e["name"] == "prefill.forward"]
        assert widths == _split(pre["args"]["tokens"], CAP[paged])
        kinds = [e["name"] for e in inner]
        # the prompt's upload, (paged: each chunk's reset upload) and the
        # chunk's forward, the first token's read last
        per_chunk = (["prefill.upload", "prefill.forward"] if paged
                     else ["prefill.forward"])
        assert kinds == (["prefill.upload"] + per_chunk * len(widths)
                         + ["prefill.read"])
        assert all(_inside(e, pre) for e in inner)
        assert all(_end(e) <= inner[-1]["ts"] + NS for e in inner[:-1])
        start = i + 1


def test_the_split_example():
    assert _split(23, 16) == [16, 4, 2, 1]
    assert _split(23, 8) == [8, 8, 4, 2, 1]


class _CountingClock(VirtualClock):
    def __init__(self, rates):
        super().__init__(rates)
        self.reads = 0

    def now_s(self):
        self.reads += 1
        return super().now_s()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_virtual_clock_trace_repeats_and_the_spans_only_read(model, paged):
    runs = []
    for _ in range(2):
        tracer, clock = SpanTracer(), _CountingClock(RATES)
        _, streams = _drain(model, paged, clock, tracer)
        runs.append((tracer.to_chrome(), streams, clock.now_s(),
                     clock.charged, clock.reads))
    assert runs[0] == runs[1]
    chrome, streams, now, charged, reads = runs[0]
    names = {e["name"] for e in chrome["traceEvents"] if e["ph"] == "X"}
    assert set(DECODE) | {"commit", "prefill.upload", "prefill.forward",
                          "prefill.read"} <= names
    # no instant on the token shell (TTFT stays on the request)
    assert not [e for e in chrome["traceEvents"] if e["ph"] == "i"]
    # the same drain untraced: same tokens and charges, and each span the
    # tracer recorded read the clock twice (``tick`` reuses end_tick's read)
    clock = _CountingClock(RATES)
    eng, plain = _drain(model, paged, clock)
    assert eng.tracer is NULL_TRACER
    assert (plain, clock.now_s(), clock.charged) == (streams, now, charged)
    spans = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    n_ticks = sum(e["name"] == "tick" for e in spans)
    assert reads - clock.reads == 2 * (len(spans) - n_ticks)


def test_unsampled_ticks_record_nothing(model):
    """``sample_every`` routes every tick but the first through
    ``NULL_TRACER``: only tick 0's admissions and decode are recorded."""
    tracer = SpanTracer(sample_every=10_000)
    eng, _ = _drain(model, True, VirtualClock(RATES), tracer)
    assert eng.ticks > 2
    names = [e["name"] for e in tracer.spans()]
    assert names.count("tick") == 1 and names.count("decode") == 1
    assert names.count("commit") == 1 and names.count("prefill") == 2
    assert names.count("prefill.read") == 2


def test_the_names_reach_the_benchmark_unchanged(model):
    tracer = SpanTracer()
    _drain(model, True, WallClock(), tracer)
    got = tracer_spans(tracer)
    want = tracer.spans()
    assert [n for n, _, _ in got] == [e["name"] for e in want]
    assert {n for n, _, _ in got} == {"tick", "commit", "prefill", "decode",
                                      "prefill.upload", "prefill.forward",
                                      "prefill.read", *DECODE}
    assert all(s <= t for _, s, t in got)
