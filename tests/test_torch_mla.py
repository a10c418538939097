"""Port parity: repro_torch.models.mla (and the MLA + MoE stack of
deepseek-v2-236b) vs the reference (CPU, fp32).

``mla_apply`` runs on the reference's own initialised parameters
(converted with ``repro_torch.convert``) at reduced deepseek-v2-236b
(kv_lora 16, nope 8, rope 8, v 8, 4 heads), with and without the q LoRA.
Its three branches are held against the reference's: the expanded
prefill (with ``fill_cache`` padded to ``cache_capacity``, to S + 64 by
default, and unpadded when S exceeds the capacity), the contiguous decode
(a scalar ``cache_index``: a chunk at ``cache_index % cap``, clamped to
``cap - S``) and the continuous-batching decode (a 1-D ``cache_index``:
one ring row per batch row).  The reference's functions run under ``jax.jit``.
Outputs are held to TIGHT (2e-5): both run the same fp32 einsums, summed
in another order by the two libraries;
cache writes are copies and positions are exact.  The serving comparison
is exact on tokens and on every timing and ledger field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import EDAConfig as JEDAConfig
from repro.config import get_arch as jget_arch
from repro.core.clock import VirtualClock as JClock
from repro.models import mla as JMLA
from repro.models import transformer as JT
from repro.models.param import init_tree as jinit_tree
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.config import EDAConfig, get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.models import mla as TMLA
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.serving import Request, ServeEngine

TIGHT = dict(rtol=2e-5, atol=2e-5)
ARCH = "deepseek-v2-236b"
RATES = {TOKEN: 0.002, PREFILL: 0.0005, TICK: 0.0001}
ENGINE = dict(slots=3, cache_capacity=40, prefill_chunk=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(**kw):
    j = dataclasses.replace(jget_arch(ARCH).reduced(), **kw)
    t = dataclasses.replace(get_arch(ARCH).reduced(), **kw)
    assert repr(j) == repr(t)
    return j, t


def _lora_cfgs(q_lora):
    jc, tc = _cfgs()
    if q_lora:
        return jc, tc
    return (dataclasses.replace(jc, mla=dataclasses.replace(jc.mla,
                                                            q_lora_rank=0)),
            dataclasses.replace(tc, mla=dataclasses.replace(tc.mla,
                                                            q_lora_rank=0)))


def _mla_params(jc, seed=0):
    jp = jinit_tree(JMLA.mla_params(jc), jax.random.key(seed), "float32")
    return jp, convert._tensors(_np(jp), torch.device("cpu"))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TIGHT))


def _jmla(jc, **static):
    """The reference's ``mla_apply`` under ``jax.jit`` (its op-by-op first
    call compiles every primitive: seconds per test)."""
    def run(p, x, pos, cache=None, index=None):
        return JMLA.mla_apply(jc, p, x, positions=pos, cache=cache,
                              cache_index=index, **static)
    return jax.jit(run)


def _cache_equal(t, j):
    assert set(t) == set(j) == {"c", "k_rope", "pos"}
    for name in ("c", "k_rope"):
        _close(t[name], j[name])
    assert np.array_equal(t["pos"].numpy(), np.asarray(j["pos"]))


def _filled(jc, jp, B, cap, seed):
    """A latent cache the reference's prefill filled (positions 0..cap/2-1,
    then -1 padding), as numpy, and the port's copy."""
    x = _rand((B, cap // 2, jc.d_model), seed=seed)
    pos = np.tile(np.arange(cap // 2, dtype=np.int32), (B, 1))
    _, cache = _jmla(jc, fill_cache=True, cache_capacity=cap)(
        jp, jnp.asarray(x), jnp.asarray(pos))
    cache = {k: np.array(v) for k, v in cache.items()}    # writable
    return cache, {k: torch.as_tensor(np.array(v)) for k, v in cache.items()}


@pytest.mark.parametrize("q_lora,S,cap", [
    (True, 7, 16), (True, 12, 8), (False, 5, None), (False, 7, 16)],
    ids=["q_lora-padded", "q_lora-S_over_cap", "dense_q-default_cap",
         "dense_q-padded"])
def test_mla_prefill_matches_reference(q_lora, S, cap):
    """The expanded branch: y, and ``fill_cache``'s latents padded to
    ``cache_capacity`` (S + 64 without one; unpadded past it)."""
    jc, tc = _lora_cfgs(q_lora)
    jp, tp = _mla_params(jc)
    x = _rand((2, S, jc.d_model), seed=S)
    pos = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    jy, jcache = _jmla(jc, fill_cache=True, cache_capacity=cap)(
        jp, jnp.asarray(x), jnp.asarray(pos))
    ty, tcache = TMLA.mla_apply(tc, tp, torch.as_tensor(x),
                                positions=torch.as_tensor(pos),
                                fill_cache=True, cache_capacity=cap)
    _close(ty, jy)
    _cache_equal(tcache, _np(jcache))
    assert tcache["c"].shape[1] == max(cap or S + 64, S)
    ty2, none = TMLA.mla_apply(tc, tp, torch.as_tensor(x),
                               positions=torch.as_tensor(pos))
    assert none is None and torch.equal(ty2, ty)


@pytest.mark.parametrize("S,index", [(1, 9), (3, 8), (4, 14), (2, 35)],
                         ids=["step", "chunk", "clamped", "wrapped"])
def test_mla_contiguous_decode_matches_reference(S, index):
    """A scalar ``cache_index``: the chunk lands at ``index % cap``, its
    start clamped to ``cap - S`` (``dynamic_update_slice``); the absorbed
    attention reads every slot with 0 <= pos <= the query's."""
    jc, tc = _cfgs()
    jp, tp = _mla_params(jc, seed=1)
    cap = 16
    jcache, tcache = _filled(jc, jp, 2, cap, seed=2)
    x = _rand((2, S, jc.d_model), seed=3)
    pos = np.tile(np.arange(index, index + S, dtype=np.int32), (2, 1))
    jy, jnew = _jmla(jc)(jp, jnp.asarray(x), jnp.asarray(pos),
                         jax.tree.map(jnp.asarray, jcache),
                         jnp.asarray(index, jnp.int32))
    ty, tnew = TMLA.mla_apply(tc, tp, torch.as_tensor(x),
                              positions=torch.as_tensor(pos), cache=tcache,
                              cache_index=index)
    _close(ty, jy)
    _cache_equal(tnew, _np(jnew))
    assert tnew is tcache                        # written in place


def test_mla_per_row_decode_matches_reference():
    """A 1-D ``cache_index``: one ring row per batch row at
    ``cache_index[b] % cap``; a row whose slot still holds another
    position (wrapped) and a row at position 0 with an empty ring."""
    jc, tc = _cfgs()
    jp, tp = _mla_params(jc, seed=4)
    cap = 16
    jcache, tcache = _filled(jc, jp, 3, cap, seed=5)
    for name in jcache:                          # row 2: an empty ring
        jcache[name][2] = -1 if name == "pos" else 0
        tcache[name][2] = -1 if name == "pos" else 0
    index = np.array([8, 21, 0], np.int32)      # 21 % 16 overwrites pos 5
    x = _rand((3, 1, jc.d_model), seed=6)
    jy, jnew = _jmla(jc)(jp, jnp.asarray(x), jnp.asarray(index[:, None]),
                         jax.tree.map(jnp.asarray, jcache),
                         jnp.asarray(index))
    ty, tnew = TMLA.mla_apply(tc, tp, torch.as_tensor(x),
                              positions=torch.as_tensor(index[:, None]),
                              cache=tcache,
                              cache_index=torch.as_tensor(index))
    _close(ty, jy)
    _cache_equal(tnew, _np(jnew))
    assert int(tnew["pos"][1, 5]) == 21 and int(tnew["pos"][2, 0]) == 0


def _stack(layers):
    jc, tc = _cfgs(num_layers=layers)
    assert TT.plan_layers(tc) == JT.plan_layers(jc)
    jp = JT.init_params(jc, jax.random.key(0))
    tp = convert.transformer_from_jax(_np(jp), tc, device="cpu")
    assert "moe" not in tp["layers"][0] and "moe" in tp["layers"][1]
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 9))
    return jc, tc, jp, tp, toks


@pytest.mark.parametrize("layers", [2, 4])
def test_deepseek_forward_matches_reference(layers):
    """Reduced deepseek (layer 0 dense, then MoE; at 4 layers a stacked
    MLA + MoE segment that ``convert`` unstacks): forward logits and the
    summed aux at TIGHT."""
    jc, tc, jp, tp, toks = _stack(layers)
    jl, _, jaux = jax.jit(lambda p, t: JT.forward(jc, p, t))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, _, taux = TT.forward(tc, tp, torch.as_tensor(toks))
    _close(tl, jl)
    _close(taux, jaux)
    assert float(taux) > 0


def test_deepseek_prefill_decode_match_reference():
    """Reduced deepseek at 4 layers: ``prefill`` logits and latent caches,
    then two ``decode_step``s' logits and caches, the caches through
    ``caches_from_jax`` (a stacked segment's caches unstacked)."""
    jc, tc, jp, tp, toks = _stack(4)
    jl, jcaches = jax.jit(lambda p, t: JT.prefill(jc, p, t,
                                                  cache_capacity=16))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, tcaches = TT.prefill(tc, tp, torch.as_tensor(toks),
                             cache_capacity=16)
    _close(tl, jl)
    for t, j in zip(tcaches, convert.caches_from_jax(_np(jcaches), tc,
                                                     device="cpu")):
        _cache_equal(t, {k: v.numpy() for k, v in j.items()})
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    jdecode = jax.jit(lambda p, c, t, i: JT.decode_step(jc, p, c, t, i))
    for step in range(2):
        jl, jcaches = jdecode(jp, jcaches, jnp.asarray(nxt),
                              jnp.asarray(9 + step, jnp.int32))
        tl, tcaches = TT.decode_step(tc, tp, tcaches, torch.as_tensor(nxt),
                                     9 + step)
        _close(tl, jl)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    for t, j in zip(tcaches, convert.caches_from_jax(_np(jcaches), tc,
                                                     device="cpu")):
        _cache_equal(t, {k: v.numpy() for k, v in j.items()})


def test_mla_caches_are_latent_rings_and_contiguous_only():
    """``init_caches`` gives each layer ``{"c", "k_rope", "pos"}`` with
    ``pos`` -1 (the leaf-name rule), the reference's shapes.  The reference
    serves MLA contiguously only; the port also pages it: each layer's
    pool holds the latent ``c`` and ``k_rope`` in the compute dtype beside
    ``ppos`` -1, and the engine serves it paged by default (contiguous
    when asked)."""
    jc, tc = _cfgs()
    TT.check_supported(get_arch(ARCH))
    t = TT.init_caches(tc, 2, 12, device="cpu")
    j = _np(JT.init_caches(jc, 2, 12))
    for tl, jl in zip(t, convert.caches_from_jax(j, tc, device="cpu")):
        assert {k: (tuple(v.shape), v.dtype) for k, v in tl.items()} == {
            k: (tuple(v.shape), v.dtype) for k, v in jl.items()}
        assert torch.equal(tl["pos"], jl["pos"])
        assert torch.all(tl["pos"] == -1)
    assert TT.paged_eligible(tc) and not JT.paged_eligible(jc)
    m, dt = tc.mla, getattr(torch, tc.compute_dtype)
    pools = TT.init_paged_caches(tc, 4, 4, device="cpu")
    assert len(pools) == tc.num_layers
    for pool in pools:
        assert {k: (tuple(v.shape), v.dtype) for k, v in pool.items()} == {
            "c": ((4, 4, m.kv_lora_rank), dt),
            "k_rope": ((4, 4, m.qk_rope_dim), dt),
            "ppos": ((4, 4), torch.int32)}
        assert torch.all(pool["ppos"] == -1)
    params = TT.init_params(tc, torch.Generator().manual_seed(0),
                            device="cpu")
    assert ServeEngine(tc, params, device="cpu", **ENGINE).paged
    assert not ServeEngine(tc, params, device="cpu", paged=False,
                           **ENGINE).paged


@pytest.fixture(scope="module")
def deepseek_drained():
    """Reduced deepseek through the reference's engine and the port's
    (plain and ``use_kernels=True``), contiguous (the port would page MLA
    by default; the reference's engine cannot), under a VirtualClock."""
    jc, tc = _cfgs()
    jp = JT.init_params(jc, jax.random.key(0))
    tp = convert.transformer_from_jax(_np(jp), tc, device="cpu")
    rng = np.random.default_rng(12)
    work = [(f"r{i}", rng.integers(0, 256, n), 5, i % 2)
            for i, n in enumerate((5, 13, 9, 3, 17))]
    out = {}
    j = JServeEngine(jc, jp, clock=JClock(rates=RATES), eda=JEDAConfig(),
                     **ENGINE)
    for rid, toks, mx, pr in work:
        j.submit(JRequest(rid=rid, tokens=toks, max_new_tokens=mx,
                          priority=pr))
    out["ref"] = _summary(j, j.run())
    for use_kernels in (False, True):
        t = ServeEngine(tc, tp, clock=VirtualClock(RATES), eda=EDAConfig(),
                        device="cpu", opts=RunOpts(use_kernels=use_kernels),
                        paged=False, **ENGINE)
        for rid, toks, mx, pr in work:
            t.submit(Request(rid=rid, tokens=toks, max_new_tokens=mx,
                             priority=pr))
        out[use_kernels] = _summary(t, t.run())
        t.ledger.check()
        assert not t.paged
    return out


def _summary(eng, done):
    reqs = [(r.rid, list(r.generated), r.ttft_ms, r.turnaround_ms,
             r.truncated) for r in done]
    return reqs, [dataclasses.asdict(r) for r in eng.ledger.records]


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_deepseek_contiguous_engine_matches_reference(deepseek_drained,
                                                      use_kernels):
    """Greedy streams, timings and ledger records equal the reference's:
    contiguous latent rings, chunked prefill through the scalar-index
    branch, decode through the per-row branch."""
    want_reqs, want_recs = deepseek_drained["ref"]
    got_reqs, got_recs = deepseek_drained[use_kernels]
    assert len(got_reqs) == 5
    assert [r[:2] for r in got_reqs] == [r[:2] for r in want_reqs]
    assert got_reqs == want_reqs
    assert got_recs == want_recs
