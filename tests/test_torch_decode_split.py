"""The decode kernels' split-and-merge arithmetic, on the CPU.

The decode kernels of ``csrc/decode_attention.cu`` cut each row's keys into
splits, compute an online-softmax partial (m, l, acc) per split and merge
the partials in split order.  Here that arithmetic's plain counterpart
(``attention_common.split_partials_plain`` and ``merge_partials_plain``, at
the kernels' own split size) is held against the reference's decode golden
(``repro.kernels.ref``) and both of the reference's Pallas decode kernels
in interpret mode, contiguous and paged, fp32 at TIGHT.  Inputs are made
with numpy from a seed and handed to both packages.  The kernels
themselves run only on the card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import TIGHT
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import attention_common as ac

HQ, HKV, D, BS = 4, 2, 16, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs test files in parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layouts(seed, kv_pos, q_pos, dead_cols):
    """One logical KV per row (capacity = kv_pos.shape[1], a multiple of
    BS) as a contiguous cache and as a shuffled block pool.  A column in
    ``dead_cols[b]`` is -1 in row b's table, and its entries are empty in
    the contiguous cache too; every other column owns a pool block."""
    rng = np.random.default_rng(seed)
    B, C = kv_pos.shape
    M = C // BS
    kv_pos = kv_pos.copy()
    for b, cols in enumerate(dead_cols):
        for c in cols:
            kv_pos[b, c * BS:(c + 1) * BS] = -1
    k = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    nb = B * M + 2
    perm = rng.permutation(nb)
    kp = rng.normal(size=(nb, BS, HKV, D)).astype(np.float32)
    vp = rng.normal(size=(nb, BS, HKV, D)).astype(np.float32)
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
    q = rng.normal(size=(B, 1, HQ, D)).astype(np.float32)
    return dict(q=q, k=k, v=v, kp=kp, vp=vp, ppos=ppos, tbl=tbl,
                q_pos=np.asarray(q_pos, np.int32)[:, None], kv_pos=kv_pos)


def _cases():
    """(name, kv_pos (B, C), q_pos (B,), dead table columns per row,
    window), with C a few of the kernels' splits of K keys."""
    K = ac.SPLIT_KEYS
    ar = lambda n, lo=0: np.arange(lo, lo + n, dtype=np.int32)
    full = lambda *parts: np.concatenate(parts).astype(np.int32)
    empty = lambda n: np.full(n, -1, np.int32)
    return [
        # row 0: its middle split (entries K..2K-1) holds no valid key;
        # row 1: no valid key anywhere (exactly 0)
        ("empty split, masked row", np.stack([
            full(ar(K), empty(K), ar(22, K), empty(K - 22)),
            empty(3 * K)]), [K + 21, 50], [(), ()], 0),
        # window 8: every valid key of row 0 lies in split 2, of row 1 in
        # split 1
        ("window in one split", np.stack([
            full(ar(2 * K + 52), empty(K - 52)),
            full(ar(K + 36), empty(2 * K - 36))]),
         [2 * K + 51, K + 35], [(), ()], 8),
        # capacity 48: a single split
        ("one split", np.stack([full(ar(40), empty(8)), full(ar(48))]),
         [39, 47], [(), ()], 0),
        # a -1 table column in the middle of row 0 (entries 32-47)
        ("dead middle column", np.stack([
            full(ar(2 * K + 22), empty(K - 22)),
            full(ar(70), empty(3 * K - 70))]),
         [2 * K + 21, 69], [(2,), ()], 0),
    ]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_split_merge_matches_decode_goldens(layout):
    for i, (name, kv_pos, q_pos, dead, window) in enumerate(_cases()):
        c = _layouts(i, kv_pos, q_pos, dead)
        t = {n: torch.from_numpy(a) for n, a in c.items()}
        j = {n: jnp.asarray(a) for n, a in c.items()}
        if layout == "paged":
            k, v, pos = ac.paged_gather_plain(t["kp"], t["vp"], t["ppos"],
                                              t["tbl"])
        else:
            k, v, pos = t["k"], t["v"], t["kv_pos"]
        capacity = k.shape[1]
        split_keys, splits = ac.decode_split(capacity)
        assert split_keys == ac.SPLIT_KEYS
        m, l, acc = ac.split_partials_plain(t["q"], k, v, t["q_pos"], pos,
                                            split_keys=split_keys,
                                            window=window)
        assert m.shape[1] == splits == -(-capacity // split_keys)
        got = ac.merge_partials_plain(m, l, acc)[:, None].numpy()
        wants = {
            "ref": ref.decode_attention_ref(j["q"], j["k"], j["v"],
                                            j["q_pos"], j["kv_pos"],
                                            window=window),
            "pallas decode": jops.decode_attention(
                j["q"], j["k"], j["v"], j["q_pos"], j["kv_pos"],
                window=window, interpret=True),
            "pallas paged decode": jops.paged_attention(
                j["q"], j["kp"], j["vp"], j["ppos"], j["tbl"], j["q_pos"],
                window=window, interpret=True),
        }
        for what, want in wants.items():
            np.testing.assert_allclose(got, np.asarray(want), **TIGHT,
                                       err_msg=f"{name} vs {what}")
        if name == "empty split, masked row":
            assert float(l[0, 1].abs().max()) == 0.0     # the empty split
            assert np.all(got[1] == 0.0)                  # exactly 0
        if name == "window in one split":
            assert int((l[0].amax(-1) > 0).sum()) == 1
        if name == "one split":
            assert splits == 1
