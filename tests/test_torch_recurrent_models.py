"""Port parity: repro_torch.models.{rglru,ssm} and the recurrent and hybrid
stacks of repro_torch.models.transformer vs the reference (CPU, fp32).

Reduced recurrentgemma-9b (RG-LRU + window-8 local attention) and reduced
xlstm-350m (mLSTM + sLSTM), the reference's own initialised parameters
converted with ``repro_torch.convert``; inputs from numpy seeds.  Outputs
and every cache leaf are held to rtol 1e-4 / atol 1e-5 (matrix products
and scans sum in another order); integer positions exactly.  Each
reference behaviour the port keeps is pinned by name: the RG-LRU block's
four branches (a 1-token step never reaches the scan kernel), the mLSTM
block's three branches, its k/sqrt(Dh) before a q/sqrt(Dh) (two scalings),
the unread ``cfg.mlstm_chunk``, and the sLSTM's two starts (m = 0 without
a cache, m = -1e30 from a served cache's sentinels).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MLAConfig as JMLAConfig
from repro.config import get_arch as jget_arch
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.config import ATTN, MLSTM, RGLRU, SLSTM, MLAConfig, get_arch
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.kernels import rglru as rglru_k
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts

TOL = dict(rtol=1e-4, atol=1e-5)
RG, XL = "recurrentgemma-9b", "xlstm-350m"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    j = dataclasses.replace(jget_arch(arch).reduced(), **kw)
    t = dataclasses.replace(get_arch(arch).reduced(), **kw)
    assert repr(j) == repr(t)
    return j, t


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _close_tree(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])


def _tree_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _block_params(jcfg, tcfg, init_fn, seed):
    """The reference's initialised block parameters, as numpy and torch."""
    from repro.models.param import init_tree
    jp = init_tree(init_fn(jcfg), jax.random.key(seed), "float32")
    return jp, _tree_t(jp)


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["train", "fill_cache", "cache_chunk",
                                  "cache_step"])
def test_rglru_block_matches_reference(case, monkeypatch):
    """All four branches, plain and kernel path; h0 is folded into step 0
    of a cached chunk, and a 1-token cached input takes one recurrence
    step without calling the scan kernel."""
    jc, tc = _cfgs(RG)
    jp, tp = _block_params(jc, tc, JR.rglru_params, 1)
    S = 1 if case == "cache_step" else 7
    x = _rand((2, S, 64), 2)
    cache = None
    if case.startswith("cache"):
        cache = {"h": _rand((2, 64), 3), "conv": _rand((2, 3, 64), 4)}
    want_y, want_c = JR.rglru_block_apply(
        jc, jp, jnp.asarray(x), cache=None if cache is None else
        jax.tree.map(jnp.asarray, cache), fill_cache=case == "fill_cache")
    calls = []
    real = rglru_k.rglru_scan
    monkeypatch.setattr(rglru_k, "rglru_scan",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for use_kernel in (False, True):
        y, c = TR.rglru_block_apply(
            tc, tp, torch.from_numpy(x),
            cache=None if cache is None else _tree_t(cache),
            fill_cache=case == "fill_cache", use_kernel=use_kernel)
        _close(y, want_y)
        if want_c is None:
            assert c is None
        else:
            _close_tree(c, want_c)
            assert c["h"].dtype == torch.float32 and c["h"].is_contiguous()
    assert calls == ([] if case == "cache_step" else [(2, S, 64)])


# ---------------------------------------------------------------------------
# mLSTM / sLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["step", "cached_chunk", "parallel_fill"])
def test_mlstm_block_matches_reference(case, monkeypatch):
    """S == 1 with a cache is one step; S > 1 with a cache is the exact
    step recurrence (never the kernel); no cache is the parallel form (the
    kernel with ``use_kernel``), with the final state rebuilt by a step
    scan from the empty state under ``fill_cache``."""
    jc, tc = _cfgs(XL)
    jp, tp = _block_params(jc, tc, JS.mlstm_params, 5)
    S = 1 if case == "step" else 9
    x = _rand((2, S, 64), 6)
    cache = None
    if case != "parallel_fill":
        H, Dh = 4, 32
        cache = {"C": _rand((2, H, Dh, Dh), 7, 0.1),
                 "n": _rand((2, H, Dh), 8, 0.1), "m": _rand((2, H), 9)}
    want_y, want_c = JS.mlstm_block_apply(
        jc, jp, jnp.asarray(x), cache=None if cache is None else
        jax.tree.map(jnp.asarray, cache), fill_cache=case == "parallel_fill")
    calls = []
    real = mlstm_k.mlstm_chunkwise
    monkeypatch.setattr(mlstm_k, "mlstm_chunkwise",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for use_kernel in (False, True):
        y, c = TS.mlstm_block_apply(
            tc, tp, torch.from_numpy(x),
            cache=None if cache is None else _tree_t(cache),
            fill_cache=case == "parallel_fill", use_kernel=use_kernel)
        _close(y, want_y)
        _close_tree(c, want_c)
    assert calls == ([(2, S, 4, 32)] if case == "parallel_fill" else [])


def test_mlstm_scales_k_and_q_and_ignores_mlstm_chunk(monkeypatch):
    """The block divides k by sqrt(Dh) and the parallel form divides q by
    sqrt(Dh) again (scores carry 1/Dh), as the reference does; the kernel
    is called without a chunk (128, ``DEFAULT_CHUNK``) and
    ``cfg.mlstm_chunk`` changes nothing."""
    jc, tc = _cfgs(XL)
    jp, tp = _block_params(jc, tc, JS.mlstm_params, 10)
    x = torch.from_numpy(_rand((1, 6, 64), 11))
    seen = {}

    def spy(q, k, v, i_gate, f_gate, **kw):
        seen.update(q=q, k=k, kw=kw)
        return TS.mlstm_parallel(q, k, v, i_gate, f_gate)

    monkeypatch.setattr(mlstm_k, "mlstm_chunkwise", spy)
    y, _ = TS.mlstm_block_apply(tc, tp, x, use_kernel=True)
    u = x @ tp["w_up"]
    k_raw = (u @ tp["wk"]).reshape(1, 6, 4, 32)
    torch.testing.assert_close(seen["k"] * math.sqrt(32), k_raw, rtol=1e-6,
                               atol=1e-6)
    assert seen["kw"] == {}
    want, _ = JS.mlstm_block_apply(jc, jp, jnp.asarray(x.numpy()))
    _close(y, want)
    # with the k scaling dropped the output moves: the quirk is load-bearing
    q, v = seen["q"], (u @ tp["wv"]).reshape(1, 6, 4, 32)
    ig = u @ tp["wi"] + tp["bi"]
    fg = u @ tp["wf"] + tp["bf"]
    once = TS.mlstm_parallel(q, k_raw, v, ig, fg)
    twice = TS.mlstm_parallel(q, seen["k"], v, ig, fg)
    assert (once - twice).abs().max() > 1e-3
    tc8 = dataclasses.replace(tc, mlstm_chunk=3)
    y8, _ = TS.mlstm_block_apply(tc8, tp, x, use_kernel=True)
    assert torch.equal(y8, y)


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_slstm_mixer_matches_reference(cached):
    """Without a cache the scan starts from ``init_slstm_state`` (m = 0);
    from a served cache it starts from ``init_caches``' sentinels
    (m = -1e30, n = 1): both match the reference, and they differ."""
    jc, tc = _cfgs(XL)
    jp, tp = _block_params(jc, tc, JS.slstm_params, 12)
    x = _rand((2, 5, 64), 13)
    jcache = None
    tcache = None
    if cached:
        jcache = JT.init_caches(jc, 2, 8)[0]["b1"]
        tcache = TT.init_caches(tc, 2, 8, device="cpu")[1]
        assert (tcache["m"] == torch.tensor(-1e30)).all()
        assert (tcache["n"] == 1).all()
        _close_tree(tcache, jcache)
    want_h, want_c = JS.slstm_mixer_apply(jc, jp, jnp.asarray(x),
                                          cache=jcache, fill_cache=True)
    h, c = TS.slstm_mixer_apply(tc, tp, torch.from_numpy(x), cache=tcache,
                                fill_cache=True)
    _close(h, want_h)
    _close_tree(c, want_c)
    _close(TS.slstm_ffn_apply(tp, h), JS.slstm_ffn_apply(jp, want_h))
    other, _ = TS.slstm_mixer_apply(
        tc, tp, torch.from_numpy(x),
        cache=None if cached else TT.init_caches(tc, 2, 8, device="cpu")[1])
    assert (other - h).abs().max() > 1e-4


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """{arch: (jax cfg, port cfg, jax params, port params)}; recurrentgemma
    at pattern (R, R, A) x 2 so its period of three positions is stacked."""
    out = {}
    for arch, kw in ((RG, dict(num_layers=6, block_pattern=(RGLRU, RGLRU,
                                                             ATTN))),
                     (XL, {})):
        jc, tc = _cfgs(arch, **kw)
        jp = JT.init_params(jc, jax.random.key(0))
        out[arch] = jc, tc, jp, convert.transformer_from_jax(_np(jp), tc,
                                                             device="cpu")
    return out


def _compare_caches(tcaches, jcaches, cfg):
    want = convert.caches_from_jax(_np(jcaches), cfg, device="cpu")
    assert len(tcaches) == len(want) == cfg.num_layers
    for got, w in zip(tcaches, want):
        assert set(got) == set(w)
        for name in w:
            if w[name].dtype == torch.int32:
                assert torch.equal(got[name], w[name]), name
            else:
                _close(got[name], w[name].numpy())


@pytest.mark.parametrize("arch", [RG, XL])
def test_forward_prefill_decode_match_reference(models, arch):
    """``forward`` with filled caches, ``prefill`` and three
    ``decode_step``s: logits and every cache leaf, on the plain and the
    kernel path (the kernels' plain versions on the CPU)."""
    jc, tc, jp, tp = models[arch]
    toks = np.random.default_rng(1).integers(0, 256, (2, 11)).astype(np.int32)
    jl, jcache, _ = JT.forward(jc, jp, jnp.asarray(toks), fill_cache=True,
                               cache_capacity=16)
    jpl, jpc = JT.prefill(jc, jp, jnp.asarray(toks), cache_capacity=16)
    steps = []
    nxt = np.argmax(np.asarray(jpl)[:, -1], axis=-1)[:, None]
    for i in range(3):
        jdl, jpc = JT.decode_step(jc, jp, jpc, jnp.asarray(nxt),
                                  jnp.int32(11 + i))
        steps.append((nxt, jdl, jpc))
        nxt = np.argmax(np.asarray(jdl)[:, -1], axis=-1)[:, None]
    for use_kernels in (False, True):
        opts = RunOpts(use_kernels=use_kernels)
        tl, tcache, _ = TT.forward(tc, tp, torch.from_numpy(toks),
                                   fill_cache=True, cache_capacity=16,
                                   opts=opts)
        _close(tl, jl)
        _compare_caches(tcache, jcache, tc)
        tpl, tpc = TT.prefill(tc, tp, torch.from_numpy(toks),
                              cache_capacity=16, opts=opts)
        _close(tpl, jpl)
        for i, (tok, jdl, jdc) in enumerate(steps):
            tdl, tpc = TT.decode_step(tc, tp, tpc, torch.from_numpy(tok),
                                      11 + i, opts=opts)
            _close(tdl, jdl)
        _compare_caches(tpc, jdc, tc)


def test_init_caches_carry_the_reference_sentinels():
    """Per kind and leaf: int positions -1, every ``m`` -1e30, the sLSTM's
    2-D ``n`` 1, the mLSTM's 3-D ``n`` 0, the rest 0; dtypes as the
    reference's (RG-LRU ``conv`` in the compute dtype)."""
    for arch in (RG, XL):
        jc, tc = _cfgs(arch)
        want = convert.caches_from_jax(_np(JT.init_caches(jc, 3, 16)), tc,
                                       device="cpu")
        got = TT.init_caches(tc, 3, 16, device="cpu")
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for name in w:
                assert g[name].dtype == w[name].dtype, name
                assert torch.equal(g[name], w[name]), name
        jb, tb = _cfgs(arch, compute_dtype="bfloat16")
        want = JT.init_caches(jb, 3, 16)
        got = TT.init_caches(tb, 3, 16, device="cpu")
        blocks = [blk for seg in want for _, blk in sorted(seg.items())]
        assert [{n: str(t.dtype).split(".")[-1] for n, t in layer.items()}
                for layer in got] == [{n: str(a.dtype) for n, a in blk.items()}
                                      for blk in blocks]


def test_convert_unstacks_both_period_plans():
    """``convert`` unstacks multi-position periods in layer order:
    recurrentgemma-9b's (R,R,A) x 12 + (R) x 2 and xlstm-350m's
    (7 x M + S) x 3, on trees whose leaves carry their layer index."""
    for arch in (RG, XL):
        cfg = get_arch(arch)
        plan = TT.plan_layers(cfg)
        assert plan == JT.plan_layers(jget_arch(arch))
        segs, layer = [], 0
        for sig, repeats in plan:
            ids = np.arange(layer, layer + repeats * len(sig)).reshape(
                repeats, len(sig))
            seg = {f"b{j}": {"kind": np.array([sig[j][0]] * repeats),
                             "id": ids[:, j]} for j in range(len(sig))}
            if repeats == 1:
                seg = jax.tree.map(lambda a: a[0], seg)
            segs.append(seg)
            layer += repeats * len(sig)
        layers = convert._unstack(segs, cfg)
        assert [int(t["id"]) for t in layers] == list(range(cfg.num_layers))
        assert [str(t["kind"]) for t in layers] == list(cfg.layer_kinds())
    assert [len(s) for s, _ in TT.plan_layers(get_arch(RG))] == [3, 1]
    assert TT.plan_layers(get_arch(XL)) == [(((MLSTM, False),) * 7
                                             + ((SLSTM, False),), 3)]


def test_supported_kinds_and_layouts():
    """RG-LRU, mLSTM and sLSTM stacks are accepted and contiguous-only;
    as encoder-decoder and VLM families their caches take the reference's
    shapes (cross K/V on the attention layers only); an unknown layer kind
    raises.  An RG-LRU stack with MLA attention is accepted, as the
    reference accepts it: its attention layers hold latent caches of the
    reference's shapes."""
    for arch in (RG, XL):
        cfg = get_arch(arch).reduced()
        TT.check_supported(cfg)
        assert not TT.paged_eligible(cfg)
        assert not JT.paged_eligible(jget_arch(arch).reduced())
        with pytest.raises(ValueError, match="paged KV cache unsupported"):
            TT.init_paged_caches(cfg, 4, 4, device="cpu")
    base = get_arch(RG).reduced()
    shapes = lambda caches: [{k: (tuple(v.shape), v.dtype)
                              for k, v in c.items()} for c in caches]
    for family in ("vlm", "encdec"):
        fam = dataclasses.replace(base, family=family)
        jfam = dataclasses.replace(jget_arch(RG).reduced(), family=family)
        got = TT.init_caches(fam, 1, 8, device="cpu")
        want = convert.caches_from_jax(jax.tree.map(
            np.asarray, JT.init_caches(jfam, 1, 8)), fam, device="cpu")
        assert shapes(got) == shapes(want)
        assert [("cross_k" in c) for c in got] == [
            family == "encdec" and kind == ATTN for kind in fam.layer_kinds()]
    with pytest.raises(NotImplementedError, match="layer kind"):
        TT.init_caches(dataclasses.replace(base, block_pattern=(RGLRU, "x")),
                       1, 8, device="cpu")
    mla = dataclasses.replace(base, attention="mla", mla=MLAConfig())
    jmla = dataclasses.replace(jget_arch(RG).reduced(), attention="mla",
                               mla=JMLAConfig())
    TT.check_supported(mla)
    got = TT.init_caches(mla, 1, 8, device="cpu")
    want = convert.caches_from_jax(jax.tree.map(
        np.asarray, JT.init_caches(jmla, 1, 8)), mla, device="cpu")
    assert [{k: (tuple(v.shape), v.dtype) for k, v in c.items()}
            for c in got] == [{k: (tuple(v.shape), v.dtype)
                               for k, v in c.items()} for c in want]
    assert not TT.paged_eligible(mla) and not JT.paged_eligible(jmla)
