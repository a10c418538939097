"""Port parity: the VLM family (internvl2-2b) vs the reference (CPU, fp32).

Reduced internvl2-2b (2 layers, d_model 64, 4 patches) on the reference's
own initialised parameters, converted with ``repro_torch.convert``; inputs
from numpy seeds, the reference's functions under ``jax.jit``.  The patch
path (``patches @ patch_proj.w`` written over the first ``num_patches``
embeddings when the prompt is that long), logits and every cache leaf are
held to TIGHT (2e-5: matrix products summed in another order); a prompt
shorter than the patches keeps its token embeddings bit for bit; served
streams, timings and ledger records exactly (a ``VirtualClock`` on both
sides), through the paged pool (the default: the VLM is paged-eligible)
and contiguous rings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import TIGHT
from repro.config import EDAConfig as JEDAConfig
from repro.config import get_arch as jget_arch
from repro.core.clock import VirtualClock as JClock
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.config import EDAConfig, get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.models.param import P
from repro_torch.serving import Request, ServeEngine

ARCH = "internvl2-2b"
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8, block_size=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TIGHT))


@pytest.fixture(scope="module")
def model():
    """Reduced internvl2-2b: the reference's parameters, and the port's
    converted from them."""
    jc, tc = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    assert repr(jc) == repr(tc) and tc.num_patches == 4
    jp = JT.init_params(jc, jax.random.key(0))
    return jc, tc, jp, convert.transformer_from_jax(_np(jp), tc, device="cpu")


@pytest.mark.parametrize("S", [7, 3], ids=["S>=patches", "S<patches"])
def test_embed_inputs_with_patches(model, S):
    """The projected patches replace the first 4 embeddings of a 7-token
    prompt (TIGHT; the rest bit for bit the token embeddings); a 3-token
    chunk is shorter than the patches and keeps its token embeddings."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(S).integers(0, jc.vocab_size, (2, S))
    patches = _rand((2, jc.num_patches, jc.d_model), 1)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    want = jax.jit(lambda p, t, q, x: JT._embed_inputs(
        jc, p, t, q, {"patches": x}))(jp, jnp.asarray(toks, jnp.int32),
                                      jnp.asarray(pos), jnp.asarray(patches))
    got = TT._embed_inputs(tc, tp, torch.from_numpy(toks),
                           torch.from_numpy(pos),
                           {"patches": torch.from_numpy(patches)})
    _close(got, want)
    plain = TT._embed_inputs(tc, tp, torch.from_numpy(toks),
                             torch.from_numpy(pos), {})
    n = jc.num_patches if S >= jc.num_patches else 0
    assert torch.equal(got[:, n:], plain[:, n:])
    if n:
        proj = torch.from_numpy(patches) @ tp["patch_proj"]["w"]
        assert torch.equal(got[:, :n], proj)


def test_forward_prefill_decode_with_patches(model):
    """``forward`` with patches (plain and ``use_kernels``), then
    ``prefill`` of 9 tokens with patches and 4 greedy ``decode_step``s:
    logits at TIGHT, every cache leaf through ``caches_from_jax`` at TIGHT
    (positions exact)."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 9))
    patches = _rand((2, jc.num_patches, jc.d_model), 3)
    jx = {"patches": jnp.asarray(patches)}
    tx = {"patches": torch.from_numpy(patches)}
    jl, _, _ = jax.jit(lambda p, t, e: JT.forward(jc, p, t, extras=e))(
        jp, jnp.asarray(toks, jnp.int32), jx)
    for use_kernels in (False, True):
        tl, _, _ = TT.forward(tc, tp, torch.from_numpy(toks), extras=tx,
                              opts=RunOpts(use_kernels=use_kernels))
        _close(tl, jl)
    jl, jcaches = jax.jit(lambda p, t, e: JT.prefill(
        jc, p, t, extras=e, cache_capacity=16))(
            jp, jnp.asarray(toks, jnp.int32), jx)
    tl, tcaches = TT.prefill(tc, tp, torch.from_numpy(toks), extras=tx,
                             cache_capacity=16)
    _close(tl, jl)
    jdecode = jax.jit(lambda p, c, t, i: JT.decode_step(jc, p, c, t, i))
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jcaches = jdecode(jp, jcaches, jnp.asarray(nxt),
                              jnp.asarray(9 + step, jnp.int32))
        tl, tcaches = TT.decode_step(tc, tp, tcaches, torch.from_numpy(nxt),
                                     9 + step)
        _close(tl, jl)
    want = convert.caches_from_jax(_np(jcaches), tc, device="cpu")
    for got_layer, want_layer in zip(tcaches, want):
        assert set(got_layer) == set(want_layer) == {"k", "v", "pos"}
        assert torch.equal(got_layer["pos"], want_layer["pos"])
        _close(got_layer["k"], want_layer["k"].numpy())
        _close(got_layer["v"], want_layer["v"].numpy())


def test_paged_chunk_with_patches(model):
    """One 8-token paged prefill chunk with patches through a 3-column
    block table (blocks 2, 0, 5 of 6, reset): logits at TIGHT, the pool's
    K/V at TIGHT and its positions exactly."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (1, 8))
    patches = _rand((1, jc.num_patches, jc.d_model), 5)
    pages = {"tbl": np.array([[2, 0, 5]], np.int32),
             "len": np.array([3], np.int32), "reset": np.array([1], np.int32)}
    jcaches = JT.init_paged_caches(jc, 6, 4)
    jl, jnew, _ = jax.jit(lambda p, c, t, e, g: JT.forward(
        jc, p, t, caches=c, extras=e, pages=g))(
            jp, jcaches, jnp.asarray(toks, jnp.int32),
            {"patches": jnp.asarray(patches)},
            {k: jnp.asarray(v) for k, v in pages.items()})
    tcaches = convert.caches_from_jax(_np(jcaches), tc, device="cpu")
    tl, tnew, _ = TT.forward(tc, tp, torch.from_numpy(toks), caches=tcaches,
                             extras={"patches": torch.from_numpy(patches)},
                             pages={k: torch.from_numpy(v)
                                    for k, v in pages.items()})
    _close(tl, jl)
    for got, want in zip(tnew, convert.caches_from_jax(_np(jnew), tc,
                                                        device="cpu")):
        assert torch.equal(got["ppos"], want["ppos"])
        _close(got["kp"], want["kp"].numpy())
        _close(got["vp"], want["vp"].numpy())


def _numel(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))


def test_convert_carries_patch_proj(model):
    """``patch_proj.w`` arrives bit for bit; the converted tree has the
    port's own shapes; parameter counts agree, at reduced size and (shapes
    only, nothing allocated) at full size: internvl2-2b's 1893.34 M."""
    jc, tc, jp, tp = model
    assert np.array_equal(tp["patch_proj"]["w"].numpy(),
                          np.asarray(jp["patch_proj"]["w"]))
    assert tp["patch_proj"]["w"].shape == (tc.d_model, tc.d_model)
    own = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(tp)
    assert _numel(tp) == _numel(jp)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(
        TT.model_param_tree(get_arch(ARCH)),
        is_leaf=lambda x: isinstance(x, P)))
    assert n == _numel(JT.abstract_params(jget_arch(ARCH))) == 1_893_341_184


def _summary(eng, done):
    reqs = [(r.rid, list(r.generated), r.ttft_ms, r.turnaround_ms,
             r.truncated) for r in done]
    return reqs, [dataclasses.asdict(r) for r in eng.ledger.records]


@pytest.fixture(scope="module")
def vlm_drained(model):
    """Reduced internvl2-2b through the reference's engine and the port's
    (plain and ``use_kernels=True``), paged and contiguous, under a
    VirtualClock (no patches: neither engine passes extras)."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(13)
    work = [(f"r{i}", rng.integers(0, 256, n), 6, i % 2)
            for i, n in enumerate((5, 23, 12, 9, 17, 3, 30))]
    out = {}
    for paged in (True, False):
        j = JServeEngine(jc, jp, paged=paged, clock=JClock(rates=RATES),
                         eda=JEDAConfig(), **ENGINE)
        for rid, toks, mx, pr in work:
            j.submit(JRequest(rid=rid, tokens=toks, max_new_tokens=mx,
                              priority=pr))
        out[paged, "ref"] = _summary(j, j.run())
        for use_kernels in (False, True):
            t = ServeEngine(tc, tp, paged=paged, clock=VirtualClock(RATES),
                            eda=EDAConfig(), device="cpu",
                            opts=RunOpts(use_kernels=use_kernels), **ENGINE)
            for rid, toks, mx, pr in work:
                t.submit(Request(rid=rid, tokens=toks, max_new_tokens=mx,
                                 priority=pr))
            out[paged, use_kernels] = _summary(t, t.run())
            t.ledger.check()
            assert t.paged == paged
            if paged:
                assert t.block_pool.used_blocks == 0
    return out


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_vlm_engine_matches_reference(vlm_drained, paged, use_kernels):
    """Greedy streams, timings and ledger records equal the reference
    engine's in both KV layouts; the default layout is paged, as in the
    reference."""
    jc, tc = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    assert TT.paged_eligible(tc) and JT.paged_eligible(jc)
    want_reqs, want_recs = vlm_drained[paged, "ref"]
    got_reqs, got_recs = vlm_drained[paged, use_kernels]
    assert len(got_reqs) == 7
    assert got_reqs == want_reqs
    assert got_recs == want_recs
