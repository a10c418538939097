"""Port parity: the encoder-decoder family (whisper-base) vs the reference
(CPU, fp32).

The flash kernel's non-causal form, which the encoder's self-attention
(q_pos = kv_pos = 0..T-1) and cross-attention (every position 0) run on
the card, is held here through its plain version
(``flash_attention_plain``) and the kernel's split arithmetic
(``split_partials_plain`` + ``merge_partials_plain`` at the kernel's own
split and 64-row tiles) against the reference's golden
(``repro.kernels.ref``) and its Pallas flash kernel in interpret mode, at
TIGHT (2e-5).  The model is reduced whisper-base (2 encoder and 2 decoder
layers, d_model 64, 16 encoder frames) on the reference's own initialised
parameters, converted with ``repro_torch.convert``; inputs come from numpy
seeds, and the reference's functions run under ``jax.jit``.  Logits and
every cache leaf are held to TIGHT (matrix products and softmax sums run
in another order); served streams, timings and ledger records exactly (a
``VirtualClock`` on both sides).  The kernels themselves run only on the
card (``test_torch_cuda.py``).
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
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.param import init_tree as jinit_tree
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.config import EDAConfig, get_arch
from repro_torch.core.clock import PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.kernels import attention_common as ac
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.models.param import P
from repro_torch.serving import Request, ServeEngine

ARCH = "whisper-base"
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


def _cfgs(**kw):
    j = dataclasses.replace(jget_arch(ARCH).reduced(), **kw)
    t = dataclasses.replace(get_arch(ARCH).reduced(), **kw)
    assert repr(j) == repr(t)
    return j, t


def _rand(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TIGHT))


@pytest.fixture(scope="module")
def model():
    """Reduced whisper-base: the reference's parameters, and the port's
    converted from them."""
    jc, tc = _cfgs()
    jp = JT.init_params(jc, jax.random.key(0))
    return jc, tc, jp, convert.transformer_from_jax(_np(jp), tc, device="cpu")


# ---------------------------------------------------------------------------
# the flash kernel's non-causal form (its plain version and split arithmetic)
# ---------------------------------------------------------------------------

ar = lambda B, n: np.tile(np.arange(n, dtype=np.int32), (B, 1))
zeros = lambda B, n: np.zeros((B, n), np.int32)

# name: (B, S, C, Hq, Hkv, D, q_pos, kv_pos); no C is a multiple of 64
FLASH_CASES = {
    "encoder arange S=C=70 D16 G2": (2, 70, 70, 4, 2, 16, ar, ar),
    "cross zeros S1 C100 D64": (2, 1, 100, 8, 8, 64, zeros, zeros),
    "cross zeros S9 C100 D16": (2, 9, 100, 4, 4, 16, zeros, zeros),
    "encoder arange S=C=130 D64": (1, 130, 130, 2, 2, 64, ar, ar),
}


def _flash_inputs(B, S, C, Hq, Hkv, D, qp, kp, seed):
    return dict(q=_rand((B, S, Hq, D), seed), k=_rand((B, C, Hkv, D), seed + 1),
                v=_rand((B, C, Hkv, D), seed + 2), q_pos=qp(B, S),
                kv_pos=kp(B, C))


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_plain_not_causal_matches_goldens(name):
    """``flash_attention_plain(causal=False)``, and the routed CPU call
    (``ops.flash_attention``: S = 1 and not causal stays on flash, as the
    reference routes it), against the reference's golden and its Pallas
    flash kernel in interpret mode, at TIGHT; no kernel is launched."""
    c = _flash_inputs(*FLASH_CASES[name], seed=list(FLASH_CASES).index(name))
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    j = {n: jnp.asarray(a) for n, a in c.items()}
    args = ("q", "k", "v", "q_pos", "kv_pos")
    kops.reset_launches()
    got = fa_k.flash_attention_plain(*(t[a] for a in args), causal=False)
    routed = kops.flash_attention(*(t[a] for a in args), causal=False)
    assert torch.equal(got, routed)
    assert not any(kops.launches().values())
    for what, want in {
            "ref": ref.flash_attention_ref(*(j[a] for a in args),
                                           causal=False),
            "pallas flash": jops.flash_attention(*(j[a] for a in args),
                                                 causal=False,
                                                 interpret=True)}.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT,
                                   err_msg=f"{name} vs {what}")
    # not causal: a query sees keys after its own position (arange rows)
    causal = fa_k.flash_attention_plain(*(t[a] for a in args), causal=True)
    assert torch.equal(got, causal) == (FLASH_CASES[name][6] is zeros)


@pytest.mark.parametrize("kind", ["encoder", "cross"])
def test_split_merge_not_causal_at_the_kernels_split(kind):
    """The kernel's arithmetic at whisper-base's 1500 encoder keys (one
    row, one kv head, D 16): the keys cut as ``flash_split`` cuts them (6
    splits of 256 for the encoder's 24 row tiles, as at B 8 x 8 heads on
    the card, where the grid is already full), partials merged in split
    order, rows in 64-row tiles; the encoder (S = C = 1500, positions
    0..1499) and cross-attention (S 1 and 9, every position 0) against the
    reference's golden at TIGHT."""
    C, D = 1500, 16
    assert ac.flash_split(8, C, 1, 8, C, rows=64) == (24, 256, 6)
    shapes = [C] if kind == "encoder" else [1, 9]
    for S in shapes:
        pos = ar if kind == "encoder" else zeros
        c = _flash_inputs(1, S, C, 1, 1, D, pos, pos, seed=S)
        t = {n: torch.from_numpy(a) for n, a in c.items()}
        T_, keys, splits = ac.flash_split(1, S, 1, 1, C, rows=64)
        m, l, acc = ac.split_partials_plain(
            t["q"], t["k"], t["v"], t["q_pos"], t["kv_pos"],
            split_keys=keys, causal=False, rows=64)
        assert m.shape == (1, 1, T_, splits, 64) and splits > 1
        assert bool((l.amax(-1) > 0).all())       # every split live
        got = ac.untile_rows_plain(ac.merge_partials_plain(m, l, acc), S, 1)
        want = ref.flash_attention_ref(
            *(jnp.asarray(c[a]) for a in ("q", "k", "v", "q_pos", "kv_pos")),
            causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


# ---------------------------------------------------------------------------
# the model's pieces
# ---------------------------------------------------------------------------


def test_cross_attention_matches_reference():
    """``encode_cross_kv`` and ``cross_attn_apply`` (S 1 and 5 decoder
    queries over 16 encoder rows), plain and with ``use_kernels`` (the
    flash kernel's plain version on the CPU), at TIGHT."""
    jc, tc = _cfgs()
    jp = jinit_tree(JA.cross_attn_params(jc), jax.random.key(3), "float32")
    tp = convert._tensors(_np(jp), torch.device("cpu"))
    enc = _rand((2, jc.encoder_seq, jc.d_model), 4)
    jkv = JA.encode_cross_kv(jc, jp, jnp.asarray(enc))
    tkv = TA.encode_cross_kv(tc, tp, torch.from_numpy(enc))
    for n in ("k", "v"):
        _close(tkv[n], jkv[n])
        assert tkv[n].shape == (2, 16, tc.num_kv_heads, tc.head_dim)
    for S in (1, 5):
        x = _rand((2, S, jc.d_model), 5 + S)
        want = jax.jit(lambda p, x, kv: JA.cross_attn_apply(jc, p, x, kv))(
            jp, jnp.asarray(x), jkv)
        for use_kernels in (False, True):
            got = TA.cross_attn_apply(tc, tp, torch.from_numpy(x), tkv,
                                      opts=RunOpts(use_kernels=use_kernels))
            _close(got, want)


def test_encode_and_forward_with_frames(model):
    """``encode`` (sinusoidal positions, the non-causal stack, its final
    norm) and ``forward`` with frames (the encoder run inside it), at
    TIGHT, plain and with ``use_kernels``."""
    jc, tc, jp, tp = model
    frames = _rand((2, jc.encoder_seq, jc.d_model), 6)
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 9))
    jenc = jax.jit(lambda p, f: JT.encode(jc, p, f))(jp, jnp.asarray(frames))
    jl, _, _ = jax.jit(lambda p, t, f: JT.forward(
        jc, p, t, extras={"frames": f}))(jp, jnp.asarray(toks, jnp.int32),
                                         jnp.asarray(frames))
    for use_kernels in (False, True):
        opts = RunOpts(use_kernels=use_kernels)
        _close(TT.encode(tc, tp, torch.from_numpy(frames), opts=opts), jenc)
        tl, caches, _ = TT.forward(tc, tp, torch.from_numpy(toks),
                                   extras={"frames": torch.from_numpy(frames)},
                                   opts=opts)
        _close(tl, jl)
        assert caches is None


def _leaves_close(tcaches, jcaches, cfg):
    want = convert.caches_from_jax(_np(jcaches), cfg, device="cpu")
    assert len(tcaches) == len(want) == cfg.num_layers
    for got_layer, want_layer in zip(tcaches, want):
        assert set(got_layer) == set(want_layer) == {
            "k", "v", "pos", "cross_k", "cross_v"}
        for name in want_layer:
            if name == "pos":
                assert torch.equal(got_layer[name], want_layer[name])
            else:
                _close(got_layer[name], want_layer[name].numpy())


def test_prefill_with_frames_then_decode_every_cache_leaf(model):
    """``prefill`` of 7 tokens with frames (capacity 16), then 4 greedy
    ``decode_step``s without them (the cross K/V read from the cache):
    logits at TIGHT and every cache leaf, ``cross_k``/``cross_v``
    included, through ``caches_from_jax`` at TIGHT (positions exact)."""
    jc, tc, jp, tp = model
    frames = _rand((2, jc.encoder_seq, jc.d_model), 8)
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, (2, 7))
    jl, jcaches = jax.jit(lambda p, t, f: JT.prefill(
        jc, p, t, extras={"frames": f}, cache_capacity=16))(
            jp, jnp.asarray(toks, jnp.int32), jnp.asarray(frames))
    tl, tcaches = TT.prefill(tc, tp, torch.from_numpy(toks),
                             extras={"frames": torch.from_numpy(frames)},
                             cache_capacity=16)
    _close(tl, jl)
    _leaves_close(tcaches, jcaches, tc)
    jdecode = jax.jit(lambda p, c, t, i: JT.decode_step(jc, p, c, t, i))
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jcaches = jdecode(jp, jcaches, jnp.asarray(nxt),
                              jnp.asarray(7 + step, jnp.int32))
        tl, tcaches = TT.decode_step(tc, tp, tcaches, torch.from_numpy(nxt),
                                     7 + step)
        _close(tl, jl)
    _leaves_close(tcaches, jcaches, tc)


def test_cached_cross_kv_wins_over_frames(model):
    """A cache that holds ``cross_k`` is read even when frames are passed
    (the reference's precedence): a decode step given other frames equals
    the reference's and, bit for bit, the same step without them; the
    cached cross K/V stay the prefill's."""
    jc, tc, jp, tp = model
    fa, fb = (_rand((1, jc.encoder_seq, jc.d_model), s) for s in (10, 11))
    toks = np.random.default_rng(12).integers(0, jc.vocab_size, (1, 5))
    jl, jcaches = jax.jit(lambda p, t, f: JT.prefill(
        jc, p, t, extras={"frames": f}, cache_capacity=8))(
            jp, jnp.asarray(toks, jnp.int32), jnp.asarray(fa))
    nxt = np.array([[3]], np.int32)
    jstep, _ = jax.jit(lambda p, c, t, f: JT.decode_step(
        jc, p, c, t, jnp.asarray(5, jnp.int32), extras={"frames": f}))(
            jp, jcaches, jnp.asarray(nxt), jnp.asarray(fb))
    out = {}
    for name, extras in (("other frames", {"frames": torch.from_numpy(fb)}),
                         ("none", None)):
        _, tcaches = TT.prefill(tc, tp, torch.from_numpy(toks),
                                extras={"frames": torch.from_numpy(fa)},
                                cache_capacity=8)
        cross = [c["cross_k"].clone() for c in tcaches]
        out[name], tcaches = TT.decode_step(tc, tp, tcaches,
                                            torch.from_numpy(nxt), 5,
                                            extras=extras)
        assert all(torch.equal(c["cross_k"], k)
                   for c, k in zip(tcaches, cross))
    _close(out["other frames"], jstep)
    assert torch.equal(out["other frames"], out["none"])


def _numel(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))


def test_convert_round_trip_and_param_counts(model):
    """``transformer_from_jax`` unstacks the encoder's stacked segment
    with ``encoder_plan`` (one per layer) and carries its final norm and
    the decoder layers' ``ln_cross``/``cross``: every leaf equals the
    reference's, the tree has the port's own shapes, and the parameter
    counts agree, at reduced size and (shapes only, nothing allocated) at
    full size: whisper-base's 70.70 M."""
    jc, tc, jp, tp = model
    assert TT.encoder_plan(tc) == JT.encoder_plan(jc)
    assert TT.encoder_plan(get_arch(ARCH)) == JT.encoder_plan(
        jget_arch(ARCH))
    enc = jp["encoder"]["segments"][0]["b0"]
    for r in range(jc.num_encoder_layers):
        for got, want in zip(jax.tree.leaves(tp["encoder"]["layers"][r]),
                             jax.tree.leaves(jax.tree.map(
                                 lambda a: np.asarray(a)[r], enc))):
            assert np.array_equal(got.numpy(), want)
    seg = jp["segments"][0]["b0"]
    assert np.array_equal(tp["layers"][1]["cross"]["wq"]["w"].numpy(),
                          np.asarray(seg["cross"]["wq"]["w"])[1])
    assert np.array_equal(tp["encoder"]["final_norm"]["scale"].numpy(),
                          np.asarray(jp["encoder"]["final_norm"]["scale"]))
    own = TT.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(tp)
    assert _numel(tp) == _numel(jp)
    full, jfull = get_arch(ARCH), jget_arch(ARCH)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(
        TT.model_param_tree(full), is_leaf=lambda x: isinstance(x, P)))
    assert n == _numel(JT.abstract_params(jfull)) == 70_695_424


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _summary(eng, done):
    reqs = [(r.rid, list(r.generated), r.ttft_ms, r.turnaround_ms,
             r.truncated) for r in done]
    return reqs, [dataclasses.asdict(r) for r in eng.ledger.records]


@pytest.fixture(scope="module")
def whisper_drained(model):
    """Reduced whisper-base through the reference's engine and the port's
    (plain and ``use_kernels=True``), contiguous (the default: an
    encoder-decoder is not paged-eligible), under a VirtualClock.  Neither
    engine passes frames: every slot cross-attends to its cache's zero
    cross K/V rows."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(11)
    work = [(f"r{i}", rng.integers(0, 256, n), 6, i % 2)
            for i, n in enumerate((5, 23, 12, 9, 17, 3, 30))]
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
                        **ENGINE)
        assert not t.paged
        for rid, toks, mx, pr in work:
            t.submit(Request(rid=rid, tokens=toks, max_new_tokens=mx,
                             priority=pr))
        out[use_kernels] = _summary(t, t.run())
        t.ledger.check()
        assert all(not c["cross_k"].any() for c in t.caches)
    return out


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_whisper_engine_matches_reference(whisper_drained, use_kernels):
    """Greedy streams, timings and ledger records equal the reference
    engine's."""
    want_reqs, want_recs = whisper_drained["ref"]
    got_reqs, got_recs = whisper_drained[use_kernels]
    assert len(got_reqs) == 7
    assert got_reqs == want_reqs
    assert got_recs == want_recs


def test_whisper_engine_refuses_paged(model):
    """``paged=True`` raises in both engines: cross K/V ride in the
    per-slot cache dicts."""
    jc, tc, jp, tp = model
    assert not TT.paged_eligible(tc) and not JT.paged_eligible(jc)
    with pytest.raises(ValueError, match="paged-eligible"):
        JServeEngine(jc, jp, paged=True, **ENGINE)
    with pytest.raises(ValueError, match="paged-eligible"):
        ServeEngine(tc, tp, paged=True, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="paged KV cache unsupported"):
        TT.init_paged_caches(tc, 4, 4, device="cpu")


def test_sinusoidal_positions_built_on_the_positions_device():
    """The frequencies are built on the positions' device: on the CPU the
    result is bit for bit the former host-built table's, and it holds
    against the reference within 1e-6 at the reduced width (positions <
    64) and 1e-4 at whisper-base's (d 512, the encoder's 1500 positions).
    It is not bit-identical to the reference: XLA's fp32 exp, sin and cos
    differ from torch's in the last bit (26 of the 256 frequencies at d
    512), and a frequency 1 ulp off moves the angle at position 1499 by up
    to ~6e-5."""
    for dim, n, atol in ((64, 64, 1e-6), (512, 1500, 1e-4)):
        pos = np.tile(np.arange(n, dtype=np.int32), (2, 1))
        got = TL.sinusoidal_positions(torch.from_numpy(pos), dim)
        half = dim // 2
        host = torch.exp(-torch.log(torch.tensor(10_000.0))
                         * torch.arange(half, dtype=torch.float32) / half)
        ang = torch.from_numpy(pos)[..., None].float() * host
        assert torch.equal(got, torch.cat([torch.sin(ang), torch.cos(ang)],
                                          dim=-1))
        want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), dim))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
        assert got.dtype == torch.float32 and got.shape == (2, n, dim)
