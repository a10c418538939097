"""The split halves' decomposition (``downscale``, ``block_sad``), on the CPU.

``csrc/vision_ops.cu`` runs both halves on the ingest's own device code:
``downscale`` is the ingest's model-row blocks with no gate block
(``kernels.vision_ops.downscale_plan`` mirrors its launch), ``block_sad``
the ingest's gate score reading a frame already at gate size, one block a
stream (``sad_plan``).  Their arithmetic in plain PyTorch is
``_resample_rows`` and ``sad_blocks_plain``; here they are held against
the reference's goldens (``repro.kernels.ref``) and its Pallas kernels in
interpret mode (nearest frames bit-exact, box frames and scores within
TIGHT, ``tests/kernel_harness.py``), and against ``ingest_blocks_plain``
bit for bit.  Inputs come from numpy with a seed.  The kernels themselves
run only on the card (``test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import TIGHT
from repro.kernels import ref
from repro.kernels import vision_ops as jvo
from repro_torch.kernels import vision_ops as tvo

EXACT = dict(rtol=0, atol=0)
H100_SMEM = 227 * 1024
INT_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape).astype(dtype)


def _writes(plan, res, C):
    """How often the launch of ``plan`` writes each output element of a
    stream's (res, res * C) rows: thread (x, y) of block (s, gy, z) holds
    unit z * tx + x of rows (gy * ty + y) * rows + k, k < rows."""
    tx, ty = plan["block"]
    _, groups, chunks = plan["grid"]
    per = 4 if plan["model_vec"] else 1
    rows = (np.arange(groups)[:, None, None] * ty
            + np.arange(ty)[None, :, None]) * plan["rows"] \
        + np.arange(plan["rows"])[None, None, :]
    units = (np.arange(chunks)[:, None] * tx + np.arange(tx)[None, :])
    rows, units = rows.reshape(-1), units.reshape(-1)
    rows, units = rows[rows < res], units[units < plan["units"]]
    count = np.zeros((res, res * C), np.int64)
    for e in range(per):
        np.add.at(count, (rows[:, None], units[None, :] * per + e), 1)
    return count


# (name, S, H, W, res, block (tx, ty), rows a thread)
DOWNSCALE = [
    # the gateless engine: the ingest's model blocks exactly
    ("gateless_192", 32, 256, 256, 192, (160, 2), 4),
    # MotionGate.admit at gate size: one block a stream would leave 100
    # SMs idle; rows, then rows of threads, halve until the grid fills
    ("gate_32", 32, 256, 256, 32, (32, 2), 1),
    # the tiers' model resolutions
    ("tier_48", 32, 256, 256, 48, (64, 4), 1),
    ("tier_16", 32, 256, 256, 16, (32, 1), 1),
    # rows of 15 x 3 floats (not 16-byte units): one element a thread
    ("element_path", 4, 20, 20, 15, (64, 1), 1),
]


@pytest.mark.parametrize("case", DOWNSCALE, ids=[c[0] for c in DOWNSCALE])
def test_downscale_plan_fits_the_card(case):
    """The grid covers every output element exactly once, blocks of at
    most MAX_BLOCK_THREADS in whole warps, the card's grid limits and
    32-bit offsets hold, and the grid holds DOWNSCALE_MIN_BLOCKS blocks
    wherever the shapes have that many rows of threads."""
    name, S, H, W, res, block, rows = case
    C = 3
    p = tvo.downscale_plan(S, H, W, C, res)
    assert p["block"] == block and p["rows"] == rows
    tx, ty = block
    assert tx % 32 == 0 and p["threads"] == tx * ty <= tvo.MAX_BLOCK_THREADS
    assert p["grid"][0] == S and p["blocks"] == int(np.prod(p["grid"]))
    assert p["grid"][1] <= 65535 and p["grid"][2] <= 65535
    assert p["model_vec"] == (name != "element_path")
    assert p["flags"] == int(p["model_vec"])
    assert (_writes(p, res, C) == 1).all()
    assert [r for lo, hi in p["model_rows"] for r in range(lo, hi)] == \
        list(range(res))
    most = S * res * p["chunks"]          # one row of threads a block
    assert p["blocks"] >= min(tvo.DOWNSCALE_MIN_BLOCKS, most)
    # 32-bit: source rows and columns, the tables' element offsets
    assert (res + 1) * max(H, W) * C <= INT_MAX and H * W * C <= INT_MAX
    if name == "gateless_192":
        q = tvo.ingest_plan(S, H, W, C, res, 32, 8)
        assert (q["block"], q["rows"], q["model_rows"]) == \
            (p["block"], p["rows"], p["model_rows"])


def test_plans_refuse_what_the_card_cannot_hold():
    """downscale_plan: 32-bit offsets and rows a thread; a given rows a
    thread is kept.  sad_plan: one block a stream, at least GATE_THREADS
    threads and up to a warp a tile, the map within the SMEM_MAX of
    ingest_plan (no longer the 48 KB of a static launch), the kernel's
    channels."""
    assert tvo.downscale_plan(32, 256, 256, 3, 32, rows=2)["rows"] == 2
    with pytest.raises(ValueError, match="32-bit"):
        tvo.downscale_plan(1, 40000, 40000, 3, 64)
    with pytest.raises(ValueError, match="rows"):
        tvo.downscale_plan(1, 64, 64, 3, 32, rows=5)
    p = tvo.sad_plan(32, 32, 32, 3, 8)              # a warp a tile
    assert p == dict(grid=(32,), blocks=32, threads=16 * 32,
                     smem=32 * 32 * 4, tiles=16)
    assert tvo.sad_plan(32, 20, 20, 3, 8)["threads"] == 9 * 32
    assert tvo.sad_plan(32, 16, 16, 3, 8)["threads"] == tvo.GATE_THREADS
    big = tvo.sad_plan(2, 128, 128, 3, 8)           # 64 KB: over 48 KB
    assert big["smem"] == 65536 and big["threads"] == tvo.MAX_BLOCK_THREADS
    assert tvo.sad_plan(1, 20, 30, 3, 8)["tiles"] == 3 * 4
    assert tvo.SMEM_MAX <= H100_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        tvo.sad_plan(1, 250, 250, 3, 8)
    with pytest.raises(ValueError, match="channels"):
        tvo.sad_plan(1, 32, 32, 5, 8)
    with pytest.raises(ValueError, match="block"):
        tvo.sad_plan(1, 32, 32, 3, 0)


# (name, S, H, W, res, dtype, method)
RESAMPLE = [
    ("nearest_f32_192", 2, 256, 256, 192, np.float32, "nearest"),
    ("nearest_u8_32", 2, 256, 256, 32, np.uint8, "nearest"),
    ("box_f32_48", 2, 64, 64, 48, np.float32, "box"),
    ("box_u8_20", 2, 64, 48, 20, np.uint8, "box"),
]


@pytest.mark.parametrize("case", RESAMPLE, ids=[c[0] for c in RESAMPLE])
def test_resample_rows_matches_reference(case):
    """``downscale``'s arithmetic (the model rows') against the golden and
    the Pallas kernel in interpret mode: nearest bit-exact, box (added row
    by row, left to right, then divided) within TIGHT."""
    name, S, H, W, res, dt, method = case
    frames = _np((S, H, W, 3), dt, seed=41)
    got = tvo._resample_rows(tvo.normalize_plain(torch.from_numpy(frames)),
                             res, method).numpy()
    tol = EXACT if method == "nearest" else TIGHT
    assert got.shape == (S, res, res, 3) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(ref.downscale_ref(jnp.asarray(frames), res,
                                          method=method)), **tol)
    np.testing.assert_allclose(
        got, np.asarray(jvo.downscale(jnp.asarray(frames), res, method=method,
                                      interpret=True)), **tol)


@pytest.mark.parametrize("hw", [32, 20, 30], ids=["g32", "g20", "g30"])
def test_sad_blocks_plain_matches_reference(hw):
    """``block_sad``'s arithmetic against the golden and the Pallas kernel
    in interpret mode within TIGHT: the map's channels added in order,
    each tile's columns summed by lanes then a fixed tree; partial edge
    tiles (20 and 30 with block 8) average their valid pixels.  A
    rectangular frame beside each square one, against the golden (the
    Pallas kernel takes square frames only)."""
    for h, w in ((hw, hw), (hw, hw + 4)):
        a, b = _np((3, h, w, 3), seed=42), _np((3, h, w, 3), seed=43)
        got = tvo.sad_blocks_plain(torch.from_numpy(a), torch.from_numpy(b),
                                   8).numpy()
        assert got.shape == (3,) and got.dtype == np.float32
        np.testing.assert_allclose(
            got, np.asarray(ref.block_sad_ref(jnp.asarray(a), jnp.asarray(b),
                                              block=8)), **TIGHT)
        if h == w:
            np.testing.assert_allclose(
                got, np.asarray(jvo.block_sad(jnp.asarray(a), jnp.asarray(b),
                                              block=8, interpret=True)),
                **TIGHT)


@pytest.mark.parametrize("method,dt,shape,m,g", [
    ("nearest", np.float32, (2, 256, 256, 3), 192, 32),
    ("box", np.uint8, (2, 64, 64, 3), 48, 20),
], ids=["nearest_f32", "box_u8"])
def test_split_halves_equal_the_fused_blocks(method, dt, shape, m, g):
    """The split halves' arithmetic is the fused kernel's: the model rows
    at the model and at the gate resolution equal ``ingest_blocks_plain``'s
    frames bit for bit, and ``sad_blocks_plain`` on its gate frame its
    score."""
    frames = torch.from_numpy(_np(shape, dt, seed=44))
    refs = torch.from_numpy(_np((shape[0], g, g, 3), seed=45))
    model, gate, score = tvo.ingest_blocks_plain(
        frames, refs, model_res=m, gate_res=g, block=8, method=method)
    x = tvo.normalize_plain(frames)
    assert torch.equal(tvo._resample_rows(x, m, method), model)
    assert torch.equal(tvo._resample_rows(x, g, method), gate)
    assert torch.equal(tvo.sad_blocks_plain(refs, gate, 8), score)
