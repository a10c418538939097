"""The flash kernels' split-and-merge arithmetic, on the CPU.

The flash kernels of ``csrc/attention.cu`` cut each row's keys into splits
(``attention_common.flash_split``), compute an online-softmax partial (m,
l, acc) per split for a tile of query rows that enumerate (position,
group head), and merge the partials in split order.  Here that
arithmetic's plain counterpart (``attention_common.split_partials_plain``
at the kernels' own split and row tile, ``merge_partials_plain``,
``untile_rows_plain``) is held against the reference's flash and paged
prefill goldens (``repro.kernels.ref``) and both of the reference's Pallas
flash kernels in interpret mode, contiguous and paged, fp32 at TIGHT.
Inputs are made with numpy from a seed and handed to both packages.  The
kernels themselves run only on the card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import TIGHT
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import attention_common as ac

D, BS = 16, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layouts(seed, kv_pos, q_pos, dead_cols, Hq, Hkv):
    """One logical KV per row (capacity = kv_pos.shape[1], a multiple of
    BS) as a contiguous cache and as a shuffled block pool, with S =
    q_pos.shape[1] queries per row.  A column in ``dead_cols[b]`` is -1 in
    row b's table, and its entries are empty in the contiguous cache too;
    every other column owns a pool block.  Unreferenced pool blocks hold
    garbage values and positions."""
    rng = np.random.default_rng(seed)
    B, C = kv_pos.shape
    M = C // BS
    kv_pos = kv_pos.copy()
    for b, cols in enumerate(dead_cols):
        for c in cols:
            kv_pos[b, c * BS:(c + 1) * BS] = -1
    k = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
    nb = B * M + 2
    perm = rng.permutation(nb)
    kp = rng.normal(size=(nb, BS, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(nb, BS, Hkv, D)).astype(np.float32)
    ppos = rng.integers(0, C, (nb, BS)).astype(np.int32)
    tbl = np.full((B, M), -1, np.int32)
    take = 0
    for b in range(B):
        for c in range(M):
            if c in dead_cols[b]:
                continue
            blk = perm[take]
            take += 1
            tbl[b, c] = blk
            sl = slice(c * BS, (c + 1) * BS)
            kp[blk], vp[blk], ppos[blk] = k[b, sl], v[b, sl], kv_pos[b, sl]
    S = q_pos.shape[1]
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, ppos=ppos, tbl=tbl,
                q_pos=np.asarray(q_pos, np.int32), kv_pos=kv_pos)


ar = lambda n, lo=0: np.arange(lo, lo + n, dtype=np.int32)
cat = lambda *parts: np.concatenate(parts).astype(np.int32)
empty = lambda n: np.full(n, -1, np.int32)

# name: (Hq, Hkv, kv_pos (B, C), q_pos (B, S), dead table columns per row,
# window, causal)
CASES = {
    # S 2 at G 12; row 1 holds no valid key (exactly 0)
    "s2 g12 masked row": (12, 1, np.stack([cat(ar(200), empty(56)),
                                           empty(256)]),
                          np.stack([ar(2, 198), ar(2, 198)]), [(), ()], 0,
                          True),
    # S 37 at G 1 (MHA) with window 8: splits 0 and 1 hold no key in any
    # row's window
    "s37 g1 window": (2, 2, np.stack([cat(ar(188), empty(4))]),
                      np.stack([ar(37, 151)]), [()], 8, True),
    # S 128 at G 12: 24 row tiles; the first tiles' frontier (positions
    # 72-77) lies wholly before splits 2-4
    "s128 g12 frontier": (12, 1, np.stack([cat(ar(200), empty(120))]),
                          np.stack([ar(128, 72)]), [()], 0, True),
    # a -1 table column (entries 32-47) in the middle of row 0; row 1 short
    "s37 dead column": (8, 2, np.stack([cat(ar(150), empty(42)),
                                        cat(ar(40), empty(152))]),
                        np.stack([ar(37, 113), ar(37, 3)]), [(2,), ()], 0,
                        True),
    # a wrapped ring: 80 positions written into 48 slots (slot p % 48), so
    # slots 0-31 hold 48-79 and 32-47 hold 32-47; window 8
    "s3 wrapped ring": (8, 2, np.stack([cat(ar(32, 48), ar(16, 32))]),
                        np.stack([ar(3, 77)]), [()], 8, True),
    # not causal, windowed: keys after a query inside its window count
    "s5 not causal": (4, 2, np.stack([cat(ar(100), empty(28))]),
                      np.stack([ar(5, 40)]), [()], 8, False),
}


def _flash_plain(t, layout, window, causal, rows):
    """split + merge at the kernels' split and row tile, in (B,S,Hq,D)."""
    if layout == "paged":
        k, v, pos = ac.paged_gather_plain(t["kp"], t["vp"], t["ppos"],
                                          t["tbl"])
    else:
        k, v, pos = t["k"], t["v"], t["kv_pos"]
    B, S, Hq, _ = t["q"].shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    T, split_keys, splits = ac.flash_split(B, S, G, Hkv, k.shape[1],
                                           rows=rows)
    m, l, acc = ac.split_partials_plain(t["q"], k, v, t["q_pos"], pos,
                                        split_keys=split_keys, window=window,
                                        causal=causal, rows=rows)
    assert m.shape == (B, Hkv, T, splits, rows)
    out = ac.untile_rows_plain(ac.merge_partials_plain(m, l, acc), S, G)
    return out, l


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_merge_matches_flash_goldens(name, layout):
    Hq, Hkv, kv_pos, q_pos, dead, window, causal = CASES[name]
    c = _layouts(list(CASES).index(name), kv_pos, q_pos, dead, Hq, Hkv)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    j = {n: jnp.asarray(a) for n, a in c.items()}
    got, l = _flash_plain(t, layout, window, causal, rows=64)
    kw = dict(causal=causal, window=window)
    if layout == "paged":
        wants = {
            "ref": ref.paged_prefill_ref(j["q"], j["kp"], j["vp"], j["ppos"],
                                         j["tbl"], j["q_pos"], **kw),
            "pallas paged flash": jops.paged_attention(
                j["q"], j["kp"], j["vp"], j["ppos"], j["tbl"], j["q_pos"],
                interpret=True, **kw),
        }
    else:
        wants = {
            "ref": ref.flash_attention_ref(j["q"], j["k"], j["v"],
                                           j["q_pos"], j["kv_pos"], **kw),
            "pallas flash": jops.flash_attention(
                j["q"], j["k"], j["v"], j["q_pos"], j["kv_pos"],
                interpret=True, **kw),
        }
    for what, want in wants.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT,
                                   err_msg=f"{name} vs {what}")
    live = l.amax(-1) > 0                          # (B, Hkv, T, splits)
    if name == "s2 g12 masked row":
        assert np.all(got[1].numpy() == 0.0)       # exactly 0
        assert not live[1].any()
    if name == "s37 g1 window":
        assert not live[..., :2].any() and live[..., 2].all()
    if name == "s128 g12 frontier":
        assert live.shape[-1] == 5 and not live[0, 0, 0, 2:].any()


def test_row_tile_of_128_merges_the_same():
    """The bf16 kernels may take 128 rows per block: the tiling changes
    which rows share a ticket, not the result."""
    Hq, Hkv, kv_pos, q_pos, dead, window, causal = CASES["s128 g12 frontier"]
    c = _layouts(7, kv_pos, q_pos, dead, Hq, Hkv)
    t = {n: torch.from_numpy(a) for n, a in c.items()}
    a, _ = _flash_plain(t, "contiguous", window, causal, rows=64)
    b, _ = _flash_plain(t, "paged", window, causal, rows=128)
    torch.testing.assert_close(a, b, **TIGHT)
    want = ac.masked_attention_plain(t["q"], t["k"], t["v"], t["q_pos"],
                                     t["kv_pos"], causal=causal,
                                     window=window)
    torch.testing.assert_close(a, want, **TIGHT)


def test_flash_split_fills_the_card_from_shapes():
    """The split rule at the main paths' shapes: prefill chunks of S = 2..128
    (descending powers of two), starcoder2-3b's heads (G 12, Hkv 2) and
    recurrentgemma-9b's (G 16, Hkv 1), contiguous capacity 2048 and a
    257-column paged table of 16.  Every grid gives each of the 132 SMs a
    block unless the smallest split allowed already does not; splits are
    whole tiles, at most FLASH_MAX_SPLITS, and cover the capacity; no split
    is longer than FLASH_SPLIT_KEYS unless the cap on splits needs it."""
    for G, Hkv in ((12, 2), (16, 1)):
        for capacity in (2048, 257 * 16):
            for S in (2, 4, 8, 16, 32, 64, 128):
                T, keys, splits = ac.flash_split(1, S, G, Hkv, capacity)
                assert T == -(-S * G // 64)
                assert keys % ac.FLASH_TILE == 0
                assert splits <= ac.FLASH_MAX_SPLITS
                assert (splits - 1) * keys < capacity <= splits * keys
                floor = -(-capacity // ac.FLASH_MAX_SPLITS)
                floor = max(ac.FLASH_TILE,
                            -(-floor // ac.FLASH_TILE) * ac.FLASH_TILE)
                assert Hkv * T * splits >= ac.SMS or keys == floor
                assert keys <= max(ac.FLASH_SPLIT_KEYS, floor)
    # a long context: the split grows so the splits stay within the cap
    T, keys, splits = ac.flash_split(1, 128, 12, 2, 65536)
    assert splits == ac.FLASH_MAX_SPLITS and keys == 1024
