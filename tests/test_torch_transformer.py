"""Port parity: repro_torch.models.{layers,attention,transformer} vs the
reference (CPU, fp32).

Inputs come from numpy seeds; the reference's own initialised parameters
are converted with ``repro_torch.convert`` (its scanned layer stacks
unstacked into per-layer dicts).  Matrix products and softmax sums run in
another order in the two frameworks, so real-valued outputs are held to
rtol 1e-4, atol 1e-5; cache writes (pure copies) and positions are exact.

Each place where a port could diverge silently is pinned by name: tanh
GELU, the population variance, RoPE on split halves, the ``mode="drop"``
scatters (reset sentinel, -1 columns, negative positions), the
``dynamic_update_slice`` clamp, the ring-clipped sliding window (window 8
at reduced size) and the dense path's uniform weights on a fully masked
row.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.config import MLAConfig, MoEConfig, get_arch
from repro_torch.kernels import attention_common as ac
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "starcoder2-3b"


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


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches(norm):
    """fp32 inside, cast back; layernorm's variance is the population
    variance (``jnp.var``, ``correction=0``)."""
    jc, tc = _cfgs(norm=norm)
    p = {"scale": _rand((64,), 1) + 1, "bias": _rand((64,), 2)}
    x = _rand((2, 5, 64), 3, scale=3.0) + 1.0
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = JL.apply_norm(jc, p, jnp.asarray(x, jdt))
        got = TL.apply_norm(tc, tp, torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        _close(got, want, rtol=1e-2 if tdt == torch.bfloat16 else 1e-5,
               atol=1e-2 if tdt == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu_mlp"])
def test_mlp_matches(mlp):
    """GELU is ``jax.nn.gelu``'s tanh approximation, not torch's erf."""
    jc, tc = _cfgs(mlp=mlp, mlp_bias=True)
    p = {k: {"w": _rand((64, 128) if k != "wo" else (128, 64), i, 0.1),
             "b": _rand((128,) if k != "wo" else (64,), 10 + i, 0.1)}
         for i, k in enumerate(("wi", "wg", "wo"))}
    x = _rand((2, 3, 64), 5)
    tp = {k: {n: torch.from_numpy(a) for n, a in d.items()}
          for k, d in p.items()}
    _close(TL.apply_mlp(tc, tp, torch.from_numpy(x)),
           JL.apply_mlp(jc, p, jnp.asarray(x)))
    z = torch.from_numpy(_rand((1000,), 6, 3.0))
    _close(TL.gelu(z), jax.nn.gelu(jnp.asarray(z.numpy())), rtol=1e-6,
           atol=1e-6)
    assert (TL.gelu(z) - torch.nn.functional.gelu(z)).abs().max() > 1e-5


def test_embed_unembed_tie_and_softcap():
    for tie, cap in ((True, 0.0), (False, 5.0)):
        jc, tc = _cfgs(tie_embeddings=tie, logit_softcap=cap)
        p = {"tokens": _rand((256, 64), 1, 0.5)}
        if not tie:
            p["unembed"] = _rand((64, 256), 2, 0.5)
        tp = {k: torch.from_numpy(v) for k, v in p.items()}
        toks = np.random.default_rng(0).integers(0, 256, (2, 7)).astype(np.int32)
        e_j = JL.embed_tokens(jc, p, jnp.asarray(toks))
        e_t = TL.embed_tokens(tc, tp, torch.from_numpy(toks))
        _close(e_t, e_j, rtol=0, atol=0)
        _close(TL.unembed(tc, tp, e_t), JL.unembed(jc, p, e_j))


def test_rope_and_sinusoidal_match():
    """RoPE rotates the split halves [:D/2] and [D/2:], frequencies in
    fp32; an interleaved-pairs rotation would differ."""
    x = _rand((2, 6, 4, 16), 1)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 30, 31, 1000]], np.int32)
    for theta in (1e4, 1e5):
        _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    _close(TL.sinusoidal_positions(torch.from_numpy(pos), 32),
           JL.sinusoidal_positions(jnp.asarray(pos), 32))
    # a half-split rotation leaves x[..., 0] paired with x[..., D/2]
    xt = torch.zeros(1, 1, 1, 16)
    xt[..., 0] = 1.0
    out = TL.apply_rope(xt, torch.tensor([[1]]), 1e4)
    assert out[..., 8].abs() > 0.5 and out[..., 1] == 0


# ---------------------------------------------------------------------------
# cache writes
# ---------------------------------------------------------------------------


def test_paged_write_and_gather_exact():
    """Reset of recycled blocks (the reference's ``nb`` sentinel), drops
    (position < 0, a -1 column, a retired row) and the block-granular ring
    wrap all land exactly where the reference's ``mode="drop"`` scatter
    puts them.  No two entries of one write share a pool slot (the engine
    keeps a chunk within the ring), so the scatter order cannot matter."""
    jc, tc = _cfgs()
    nb, bs, H, D = 6, 4, tc.num_kv_heads, tc.head_dim
    rng = np.random.default_rng(0)
    cache = {"kp": _rand((nb, bs, H, D), 1), "vp": _rand((nb, bs, H, D), 2),
             "ppos": rng.integers(-1, 20, (nb, bs)).astype(np.int32)}
    steps = [  # (positions (B,S), tbl, len, reset)
        (np.array([[0, 1, 2, 3, 4, 5], [0, 1, -1, 3, 4, 5]]),
         np.array([[2, 0, -1], [5, 1, -1]]), np.array([2, 2]),
         np.array([1, 1])),
        (np.array([[6, 7, 8, 9, 10, 11], [6, 7, 8, 9, 10, 11]]),
         np.array([[2, 0, -1], [-1, -1, -1]]), np.array([2, 1]),
         np.array([0, 0])),
    ]
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    for pos, tbl, tlen, reset in steps:
        k, v = _rand((2, 6, H, D), 3), _rand((2, 6, H, D), 4)
        jp = {"tbl": jnp.asarray(tbl, jnp.int32), "len": jnp.asarray(tlen),
              "reset": jnp.asarray(reset)}
        tp = {"tbl": torch.from_numpy(tbl.astype(np.int32)),
              "len": torch.from_numpy(tlen), "reset": torch.from_numpy(reset)}
        jcache = JA.paged_write(jcache, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos, jnp.int32), jp)
        out = TA.paged_write(tcache, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(pos.astype(np.int32)), tp)
        assert out is tcache                       # in place
        for name in cache:
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))
        for got, want in zip(TA.paged_gather(tcache, tp),
                             JA.paged_gather(jcache, jp)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_write_cache_exact_with_clamp():
    """Per-row decode writes one entry per row (the reference rewrites the
    cache through a one-hot); a chunk past the ring's end is clamped to
    ``cap - S`` as ``dynamic_update_slice`` clamps."""
    jc, tc = _cfgs()
    cap, H, D = 8, tc.num_kv_heads, tc.head_dim
    jcache = JA.init_cache(jc, 2, 16)            # ring clipped to window 8
    tcache = TA.init_cache(tc, 2, 16, device="cpu")
    assert tcache["k"].shape[1] == cap
    writes = [(np.arange(5), 0), (np.arange(5, 8), 5), (np.arange(6, 10), 6),
              (np.array([10]), np.array([10, 3])),
              (np.array([11]), np.array([19, 4]))]
    for i, (pos, idx) in enumerate(writes):
        S = len(pos)
        k, v = _rand((2, S, H, D), 10 + i), _rand((2, S, H, D), 20 + i)
        p = np.stack([pos, pos + 1]).astype(np.int32)
        jidx = jnp.asarray(idx, jnp.int32) if np.ndim(idx) else jnp.int32(idx)
        tidx = torch.from_numpy(idx) if np.ndim(idx) else idx
        jcache = JA._write_cache(jc, jcache, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(p), jidx)
        TA._write_cache(tc, tcache, torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(p), tidx)
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(tcache[name].numpy(),
                                          np.asarray(jcache[name]))


def test_dense_path_softmaxes_masked_rows_uniform():
    """The model's plain path (``use_kernels=False``) keeps the reference's
    ``dot_attention``: a row with no valid key gets uniform weights (the
    mean of V); the kernels' plain versions give 0 there."""
    q, k, v = _rand((1, 2, 4, 16), 1), _rand((1, 5, 2, 16), 2), _rand(
        (1, 5, 2, 16), 3)
    qp = np.array([[3, 4]], np.int32)
    kvp = np.array([[-1, -1, -1, -1, -1]], np.int32)
    args_t = [torch.from_numpy(a) for a in (q, k, v, qp, kvp)]
    want = JA.dot_attention(*[jnp.asarray(a) for a in (q, k, v, qp, kvp)],
                            causal=True)
    got = TA.dot_attention(*args_t, causal=True)
    _close(got, want)
    mean_v = torch.from_numpy(v).mean(1).repeat_interleave(2, 1)
    _close(got[0, 0], mean_v[0].numpy())
    kernel_plain = TA.dot_attention(*args_t, causal=True,
                                    opts=RunOpts(use_kernels=True))
    assert torch.equal(kernel_plain, torch.zeros_like(kernel_plain))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    jp = JT.init_params(jc, jax.random.key(0))
    return jc, tc, jp, convert.transformer_from_jax(_np(jp), tc, device="cpu")


def _compare_caches(tcaches, jcaches, cfg):
    for got, want in zip(tcaches, convert.caches_from_jax(_np(jcaches), cfg,
                                                          device="cpu")):
        for name in want:
            if want[name].dtype == torch.int32:
                assert torch.equal(got[name], want[name]), name
            else:
                _close(got[name], want[name].numpy())


@pytest.mark.parametrize("mode", ["train", "contiguous_decode",
                                  "paged_decode"])
def test_forward_matches_reference(model, mode):
    """Reduced starcoder2-3b (window 8): logits and caches after a prompt
    chunk and decode steps that run the ring past the window."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab_size, (2, 13)).astype(np.int32)
    if mode == "train":
        jl, jcache, _ = JT.forward(jc, jp, jnp.asarray(toks), fill_cache=True,
                                   cache_capacity=16)
        tl, tcache, _ = TT.forward(tc, tp, torch.from_numpy(toks),
                                   fill_cache=True, cache_capacity=16)
        _close(tl, jl)
        _compare_caches(tcache, jcache, tc)
        # prefill + one decode_step on the filled cache (ring clipped to 8)
        jl, jcache = JT.prefill(jc, jp, jnp.asarray(toks), cache_capacity=16)
        tl, tcache = TT.prefill(tc, tp, torch.from_numpy(toks),
                                cache_capacity=16)
        _close(tl, jl)
        nxt = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None]
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt),
                                    jnp.int32(13))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt),
                                    13)
        _close(tl, jl)
        _compare_caches(tcache, jcache, tc)
        return
    steps = [(toks[:, :5], np.arange(5))] + [
        (toks[:, i: i + 1], np.array([i])) for i in range(5, 13)]

    def run(jax_side, opts=None):
        """The steps through one side; yields (logits, caches) per step."""
        if mode == "paged_decode":
            cache = JT.init_paged_caches(jc, 6, 4)
            pages = dict(tbl=np.array([[4, 1, 3], [0, 5, 2]], np.int32),
                         len=np.array([3, 3], np.int32),
                         reset=np.array([1, 1], np.int32))
        else:
            cache = JT.init_caches(jc, 2, 16)
        if not jax_side:
            cache = convert.caches_from_jax(_np(cache), tc, device="cpu")
        arr = jnp.asarray if jax_side else torch.from_numpy
        for x, pos in steps:
            p = np.tile(pos.astype(np.int32), (2, 1))
            kw = {} if jax_side else {"opts": opts}
            if mode == "paged_decode":
                kw["pages"] = {k: arr(v) for k, v in pages.items()}
                pages["reset"] = np.zeros(2, np.int32)
            else:
                kw["cache_index"] = int(pos[0]) if len(pos) > 1 else arr(p[:, 0])
            logits, cache, _ = (JT if jax_side else TT).forward(
                jc if jax_side else tc, jp if jax_side else tp, arr(x),
                positions=arr(p), caches=cache, **kw)
            yield logits, cache

    want = list(run(True))
    for use_kernels in (False, True):
        for (tl, tcache), (jl, jcache) in zip(
                run(False, RunOpts(use_kernels=use_kernels)), want):
            _close(tl, jl)
            _compare_caches(tcache, jcache, tc)


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                        tree)


def test_unported_architectures_raise():
    """The encoder-decoder and VLM families build params and caches of the
    reference's shapes (an encoder-decoder's attention layers carry
    ``cross_k``/``cross_v``); an unknown layer kind still raises; MoE and
    MLA are ported (``test_torch_moe.py``, ``test_torch_mla.py``), as are
    the recurrent kinds (``test_torch_recurrent_models.py``); paged
    eligibility matches the reference's rule, MLA aside (the port pages
    its latents)."""
    base = get_arch(ARCH).reduced()
    for family in ("encdec", "vlm"):
        cfg = dataclasses.replace(base, family=family)
        jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), family=family)
        TT.check_supported(cfg)
        got = TT.init_caches(cfg, 1, 8, device="cpu")
        want = convert.caches_from_jax(_np(JT.init_caches(jcfg, 1, 8)), cfg,
                                       device="cpu")
        assert _shapes(got) == _shapes(want)
        assert ("cross_k" in got[0]) == (family == "encdec")
        own = TT.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        conv = convert.transformer_from_jax(
            _np(JT.init_params(jcfg, jax.random.key(0))), cfg, device="cpu")
        assert _shapes(own) == _shapes(conv)
        assert TT.paged_eligible(cfg) == JT.paged_eligible(jcfg)
    bad = dataclasses.replace(base, block_pattern=("bogus",))
    with pytest.raises(NotImplementedError, match="layer kind"):
        TT.check_supported(bad)
    with pytest.raises(NotImplementedError, match="layer kind"):
        TT.init_params(bad, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="layer kind"):
        TT.init_caches(bad, 1, 8, device="cpu")
    for cfg in (dataclasses.replace(base, moe=MoEConfig(num_experts=4,
                                                        top_k=2,
                                                        expert_ff=32)),
                dataclasses.replace(base, attention="mla",
                                    mla=MLAConfig(kv_lora_rank=16,
                                                  qk_nope_dim=8,
                                                  qk_rope_dim=8,
                                                  v_head_dim=8))):
        TT.check_supported(cfg)
        TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        TT.init_caches(cfg, 1, 8, device="cpu")
        # the port pages MLA's latents too; the reference pages no MLA
        assert TT.paged_eligible(cfg) == (JT.paged_eligible(cfg)
                                          or cfg.attention == "mla")
    assert TT.paged_eligible(base) and JT.paged_eligible(jget_arch(ARCH))
    assert TT.plan_layers(get_arch(ARCH)) == JT.plan_layers(jget_arch(ARCH))
    # the port's own initialiser gives the reference's tree, unstacked
    jc, tc = _cfgs()
    want = _np(JT.init_params(jc, jax.random.key(0)))
    got = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    conv = convert.transformer_from_jax(want, tc, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(got) == shapes(conv)
    assert ac.NEG_INF == TA.NEG_INF == JA.NEG_INF
