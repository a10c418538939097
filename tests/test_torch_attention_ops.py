"""Port parity: the attention kernels' plain versions vs the reference.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version.  Held here against the reference's ``kernels.ref`` goldens (fp32
TIGHT, bf16 LOOSE, from ``tests/kernel_harness.py``) over GQA and MHA,
ragged lengths, trailing -1 table columns and a window, and against the
reference's Pallas kernels in interpret mode on one tiny case each (B <= 2,
M <= 4, bs 8, D 16: interpret mode is slow).  Inputs are made with numpy
from a seed and handed to both packages.  The hand kernels themselves run
only on the card: ``test_torch_cuda.py`` holds them against these plain
versions there, and ``chip_smoke.py`` does the same at the main path's
shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import LOOSE, TIGHT
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as pa_k

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, TIGHT),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, LOOSE)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, lens, S, Hq, Hkv, D, bs, M, tail_cols=0):
    """numpy arrays: a shuffled block pool holding row b's positions
    0..lens[b]-1 (garbage values everywhere else, garbage positions in the
    three unreferenced blocks, -1 past each row's length), the same KV as
    a contiguous cache, and S queries per row at its last S positions."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    ncols = [max(1, -(-L // bs)) for L in lens]
    assert max(ncols) + tail_cols <= M
    nb = sum(ncols) + 3
    perm = rng.permutation(nb)
    kp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    ppos = rng.integers(0, max(lens) + 4, (nb, bs)).astype(np.int32)
    tbl = np.full((B, M), -1, np.int32)
    C = max(ncols) * bs
    k = np.zeros((B, C, Hkv, D), np.float32)
    v = np.zeros((B, C, Hkv, D), np.float32)
    kv_pos = np.full((B, C), -1, np.int32)
    take = 0
    for b, L in enumerate(lens):
        blocks = perm[take: take + ncols[b]]
        take += ncols[b]
        tbl[b, :ncols[b]] = blocks
        for p in range(ncols[b] * bs):
            blk, off = blocks[p // bs], p % bs
            if p < L:
                kp[blk, off] = k[b, p] = rng.normal(size=(Hkv, D))
                vp[blk, off] = v[b, p] = rng.normal(size=(Hkv, D))
            ppos[blk, off] = kv_pos[b, p] = p if p < L else -1
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    q_pos = np.stack([np.arange(L - S, L) for L in lens]).astype(np.int32)
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, ppos=ppos, tbl=tbl, q_pos=q_pos,
                kv_pos=kv_pos)


def _both(c, dtype):
    """The case as JAX arrays and torch tensors, floats in ``dtype``."""
    _, jdt, tdt, _ = DTYPES[dtype]
    j, t = {}, {}
    for name, a in c.items():
        if a.dtype == np.float32:
            j[name] = jnp.asarray(a, jdt)
            t[name] = torch.from_numpy(a).to(tdt)
        else:
            j[name], t[name] = jnp.asarray(a), torch.from_numpy(a)
    return j, t


def _close(got, want, tol):
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# (lens, Hq, Hkv, bs, M, window, tail_cols): GQA and MHA, ragged lengths
# (shorter than a block, block-aligned, one token), a window, trailing -1
GEOMETRIES = [
    ([5, 8, 1, 17], 4, 2, 8, 4, 0, 0),
    ([16, 8], 4, 4, 8, 4, 0, 2),
    ([23, 9, 30], 8, 1, 16, 3, 8, 1),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 3], ids=["decode", "prefill"])
def test_paged_plain_matches_ref(dtype, S):
    tol = DTYPES[dtype][3]
    for g, (lens, Hq, Hkv, bs, M, w, tc) in enumerate(GEOMETRIES):
        lens = [max(L, S) for L in lens]
        j, t = _both(_case(g, lens, S, Hq, Hkv, 16, bs, M, tc), dtype)
        want = ref.paged_attention_ref(j["q"], j["kp"], j["vp"], j["ppos"],
                                       j["tbl"], j["q_pos"], causal=True,
                                       window=w)
        plain = (pa_k.paged_decode_attention_plain if S == 1
                 else pa_k.paged_flash_attention_plain)
        kw = {} if S == 1 else {"causal": True}
        got = plain(t["q"], t["kp"], t["vp"], t["ppos"], t["tbl"], t["q_pos"],
                    window=w, **kw)
        _close(got, want, tol)
        # the wrapper on CPU tensors is the plain version
        _close(tops.paged_attention(t["q"], t["kp"], t["vp"], t["ppos"],
                                    t["tbl"], t["q_pos"], window=w), want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 3], ids=["decode", "prefill"])
def test_contiguous_plain_matches_ref(dtype, S):
    tol = DTYPES[dtype][3]
    for g, (lens, Hq, Hkv, bs, M, w, tc) in enumerate(GEOMETRIES):
        lens = [max(L, S) for L in lens]
        j, t = _both(_case(g, lens, S, Hq, Hkv, 16, bs, M, tc), dtype)
        want = ref.flash_attention_ref(j["q"], j["k"], j["v"], j["q_pos"],
                                       j["kv_pos"], causal=True, window=w)
        if S == 1:
            got = dec_k.decode_attention_plain(t["q"], t["k"], t["v"],
                                               t["q_pos"], t["kv_pos"],
                                               window=w)
        else:
            got = fa_k.flash_attention_plain(t["q"], t["k"], t["v"],
                                             t["q_pos"], t["kv_pos"],
                                             causal=True, window=w)
        _close(got, want, tol)
        _close(tops.flash_attention(t["q"], t["k"], t["v"], t["q_pos"],
                                    t["kv_pos"], window=w), want, tol)


def test_fully_masked_rows_give_zero():
    """A row with no valid key: every column -1 (paged) or every position
    -1 (contiguous) gives exactly 0 in every plain version, as the kernels
    and ``ref`` do (the model's dense path gives uniform weights instead;
    ``test_torch_transformer.py`` pins that)."""
    c = _case(7, [6, 13], 2, 4, 2, 16, 8, 3)
    c["tbl"][0] = -1
    c["kv_pos"][0] = -1
    j, t = _both(c, "f32")
    outs = [
        pa_k.paged_flash_attention_plain(t["q"], t["kp"], t["vp"], t["ppos"],
                                         t["tbl"], t["q_pos"]),
        pa_k.paged_decode_attention_plain(t["q"][:, :1], t["kp"], t["vp"],
                                          t["ppos"], t["tbl"],
                                          t["q_pos"][:, :1]),
        fa_k.flash_attention_plain(t["q"], t["k"], t["v"], t["q_pos"],
                                   t["kv_pos"]),
        dec_k.decode_attention_plain(t["q"][:, :1], t["k"], t["v"],
                                     t["q_pos"][:, :1], t["kv_pos"]),
    ]
    for out in outs:
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        assert out[1].abs().sum() > 0
    want = ref.paged_attention_ref(j["q"], j["kp"], j["vp"], j["ppos"],
                                   j["tbl"], j["q_pos"])
    _close(outs[0], want, TIGHT)


# one tiny case per kernel against the Pallas kernel in interpret mode
TINY = dict(lens=[5, 11], Hq=4, Hkv=2, D=16, bs=8, M=3)


@pytest.mark.parametrize("kernel", ["paged_decode", "paged_flash", "flash",
                                    "decode"])
def test_plain_matches_pallas_interpret(kernel):
    S = 1 if "decode" in kernel else 4
    c = _case(11, TINY["lens"], S, TINY["Hq"], TINY["Hkv"], TINY["D"],
              TINY["bs"], TINY["M"])
    j, t = _both(c, "f32")
    w = 4 if kernel in ("paged_flash", "decode") else 0
    if kernel.startswith("paged"):
        want = jops.paged_attention(j["q"], j["kp"], j["vp"], j["ppos"],
                                    j["tbl"], j["q_pos"], causal=True,
                                    window=w, interpret=True)
        plain = (pa_k.paged_decode_attention_plain if S == 1 else
                 pa_k.paged_flash_attention_plain)
        got = plain(t["q"], t["kp"], t["vp"], t["ppos"], t["tbl"],
                    t["q_pos"], window=w)
    elif kernel == "flash":
        want = jops.flash_attention(j["q"], j["k"], j["v"], j["q_pos"],
                                    j["kv_pos"], causal=True, window=w,
                                    interpret=True)
        got = fa_k.flash_attention_plain(t["q"], t["k"], t["v"], t["q_pos"],
                                         t["kv_pos"], window=w)
    else:
        want = jops.decode_attention(j["q"], j["k"], j["v"], j["q_pos"],
                                     j["kv_pos"], window=w, interpret=True)
        got = dec_k.decode_attention_plain(t["q"], t["k"], t["v"],
                                           t["q_pos"], t["kv_pos"], window=w)
    _close(got, want, TIGHT)


def test_ops_route_like_the_reference(monkeypatch):
    """S == 1 and causal goes to decode; S > 1, or S == 1 non-causal, to
    flash; the same for the paged pair."""
    calls = []
    for mod, name in ((fa_k, "flash_attention"), (dec_k, "decode_attention"),
                      (pa_k, "paged_flash_attention"),
                      (pa_k, "paged_decode_attention")):
        monkeypatch.setattr(mod, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    c = _case(3, [9], 2, 4, 2, 16, 8, 2)
    _, t = _both(c, "f32")
    q1, qp1 = t["q"][:, :1], t["q_pos"][:, :1]
    tops.flash_attention(q1, t["k"], t["v"], qp1, t["kv_pos"])
    tops.flash_attention(q1, t["k"], t["v"], qp1, t["kv_pos"], causal=False)
    tops.flash_attention(t["q"], t["k"], t["v"], t["q_pos"], t["kv_pos"])
    tops.paged_attention(q1, t["kp"], t["vp"], t["ppos"], t["tbl"], qp1)
    tops.paged_attention(t["q"], t["kp"], t["vp"], t["ppos"], t["tbl"],
                         t["q_pos"])
    assert calls == ["decode_attention", "flash_attention", "flash_attention",
                     "paged_decode_attention", "paged_flash_attention"]


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    """Bad shapes and dtypes raise before any dispatch; a CPU call is the
    plain version and adds nothing to the launch counts; the card tests
    hold the harness tolerances."""
    import test_torch_cuda
    assert (test_torch_cuda.TIGHT, test_torch_cuda.LOOSE) == (TIGHT, LOOSE)
    c = _case(4, [9, 4], 1, 4, 2, 16, 8, 2)
    _, t = _both(c, "f32")
    tops.reset_launches()
    tops.paged_attention(t["q"], t["kp"], t["vp"], t["ppos"], t["tbl"],
                         t["q_pos"])
    tops.flash_attention(t["q"], t["k"], t["v"], t["q_pos"], t["kv_pos"])
    assert set(tops.launches().values()) == {0}
    with pytest.raises(TypeError):
        fa_k.flash_attention(t["q"].double(), t["k"].double(),
                             t["v"].double(), t["q_pos"], t["kv_pos"])
    with pytest.raises(ValueError):          # Hq not a multiple of Hkv
        fa_k.flash_attention(t["q"][:, :, :3], t["k"], t["v"], t["q_pos"],
                             t["kv_pos"])
    with pytest.raises(ValueError):          # decode takes one token
        dec_k.decode_attention(torch.cat([t["q"]] * 2, 1), t["k"], t["v"],
                               torch.cat([t["q_pos"]] * 2, 1), t["kv_pos"])
    with pytest.raises(ValueError):          # table rows != batch
        pa_k.paged_flash_attention(t["q"], t["kp"], t["vp"], t["ppos"],
                                   t["tbl"][:1], t["q_pos"])
