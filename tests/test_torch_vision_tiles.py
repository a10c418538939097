"""The ingest and scatter kernels' decomposition, on the CPU.

``csrc/vision_ops.cu`` runs ``ingest_frame`` as one launch: a gate block
per stream (the gate frame, its channel-mean |gate - ref| map in shared
memory, the tiles reduced a warp a tile in a fixed order) beside blocks of
model rows that gather through column maps tabulated once per shape.
``scatter_admit`` runs X blocks a stream, each copying its chunk of the
row in 16-byte units or element by element.
``kernels.vision_ops.ingest_plan`` / ``scatter_plan`` are the host mirrors
of that geometry, ``ingest_tables`` the column maps, and
``ingest_blocks_plain`` / ``scatter_blocks_plain`` the kernels'
arithmetic in plain PyTorch.  Here they are held against the
reference's goldens (``repro.kernels.ref``) and its Pallas kernels in
interpret mode: nearest frames and the scatter bit-exact, box frames and
scores within TIGHT (``tests/kernel_harness.py``).  Inputs come from numpy
with a seed.  The kernels themselves run only on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
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
H100_SMS = 132
H100_SMEM = 227 * 1024


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


# (name, S, H, W, model_res, gate_res, block, dtype, method)
BLOCKS = [
    # the main path's geometry at a small S
    ("main", 2, 256, 256, 192, 32, 8, np.float32, "nearest"),
    # the tiers: model 48 / 32 / 16 under gate 32 (gate rows 8k of 256 are
    # not all among the model's source rows)
    ("tier_48", 2, 256, 256, 48, 32, 8, np.float32, "nearest"),
    ("tier_32", 2, 256, 256, 32, 32, 8, np.uint8, "nearest"),
    ("tier_16", 2, 256, 256, 16, 32, 8, np.float32, "nearest"),
    # box in both input types (g 20, block 8: partial edge tiles)
    ("box_f32", 2, 64, 64, 48, 32, 8, np.float32, "box"),
    ("box_u8", 2, 64, 64, 48, 20, 8, np.uint8, "box"),
    # a uint8 row of 60 bytes, model rows of 15 x 3 floats (the kernel's
    # element path), box
    ("u8_row60_box", 2, 20, 20, 15, 10, 4, np.uint8, "box"),
    # a rectangular frame, more warps than tiles (g 12, block 8: four)
    ("rect_few_tiles", 1, 48, 40, 24, 12, 8, np.float32, "nearest"),
]


@pytest.mark.parametrize("case", BLOCKS, ids=[c[0] for c in BLOCKS])
def test_blocks_ingest_matches_reference(case):
    """The kernel's arithmetic against the golden and the Pallas kernel in
    interpret mode: nearest frames bit-exact, box frames and the score
    (summed per tile by lanes over columns, then a fixed tree) within
    TIGHT."""
    name, S, H, W, m, g, b, dt, method = case
    frames, refs = _np((S, H, W, 3), dt, seed=1), _np((S, g, g, 3), seed=2)
    kw = dict(model_res=m, gate_res=g, block=b, method=method)
    got = tvo.ingest_blocks_plain(torch.from_numpy(frames),
                                  torch.from_numpy(refs), **kw)
    pallas = jvo.ingest_frame(jnp.asarray(frames), jnp.asarray(refs),
                              interpret=True, **kw)
    golden = ref.ingest_frame_ref(jnp.asarray(frames), jnp.asarray(refs), **kw)
    for i, (t, p, r) in enumerate(zip(got, pallas, golden)):
        tol = EXACT if method == "nearest" and i < 2 else TIGHT
        t = t.numpy()
        assert t.shape == np.shape(r) and t.dtype == np.float32
        np.testing.assert_allclose(t, np.asarray(r), **tol)
        np.testing.assert_allclose(t, np.asarray(p), **tol)


def test_ingest_tables_are_the_resampling_indices():
    """The column maps the model blocks gather through: model element e of
    pixel j, channel c starts at source element (j*W//m)*C + c (box: its
    bucket ends at ((j+1)*W//m)*C + c); gate pixel j reads column j*W//g.
    Nearest frames gathered through them equal ``ingest_frame_plain``'s."""
    W, C, m, g = 53, 3, 24, 10
    tab = tvo.ingest_tables(W, C, m, g, "box").numpy()
    e = np.arange(m * C)
    j, c = e // C, e % C
    np.testing.assert_array_equal(tab[:m * C], (j * W // m) * C + c)
    np.testing.assert_array_equal(tab[m * C:2 * m * C],
                                  ((j + 1) * W // m) * C + c)
    np.testing.assert_array_equal(tab[2 * m * C:], np.arange(g + 1) * W // g)
    near = tvo.ingest_tables(W, C, m, g)
    assert near.dtype == torch.int32 and near.numel() == m * C + g + 1
    frames = torch.from_numpy(_np((2, 37, W, C), seed=3))
    rows = frames[:, torch.arange(m) * 37 // m].reshape(2, m, W * C)
    gathered = rows[:, :, near[:m * C].long()].reshape(2, m, m, C)
    want = tvo.ingest_frame_plain(frames, torch.zeros(2, g, g, C),
                                  model_res=m, gate_res=g)[0]
    assert torch.equal(gathered, want)


def test_ingest_plan_fits_the_card():
    """The main path's launch: a gate block a stream beside blocks of model
    rows, a thread holding 16 bytes of four rows, well over one block per
    SM, at least GATE_THREADS threads a block, shared memory within a
    block's 227 KB; rows wider than INGEST_TX units take several chunks;
    the vector path follows the model row's width."""
    p = tvo.ingest_plan(32, 256, 256, 3, 192, 32, 8)
    assert p["block"] == (160, 2) and p["units"] == 144 and p["rows"] == 4
    assert p["grid"] == (32, 1 + 192 // 8, 1) and p["blocks"] >= H100_SMS
    assert p["smem"] == 32 * 32 * 4 <= H100_SMEM and p["model_vec"]
    assert [r for lo, hi in p["model_rows"] for r in range(lo, hi)] == \
        list(range(192))
    for res in (48, 32, 16):
        q = tvo.ingest_plan(32, 256, 256, 3, res, 32, 8, rows=1)
        assert tvo.GATE_THREADS <= q["threads"] <= 512
        assert q["grid"][1] == 1 + -(-res // q["block"][1])
    assert tvo.ingest_plan(32, 256, 256, 3, 16, 32, 8)["block"] == (32, 8)
    wide = tvo.ingest_plan(4, 1080, 1920, 3, 448, 64, 8)
    assert wide["block"] == (256, 1) and wide["chunks"] == 2
    assert not tvo.ingest_plan(1, 30, 30, 3, 15, 13, 8)["model_vec"]
    assert tvo.ingest_plan(1, 30, 30, 3, 15, 13, 8)["flags"] == 0
    with pytest.raises(ValueError, match="shared memory"):
        tvo.ingest_plan(1, 64, 64, 3, 48, 250, 8)
    with pytest.raises(ValueError, match="rows"):
        tvo.ingest_plan(1, 64, 64, 3, 48, 32, 8, rows=5)


# (name, S, pool row shape, refs row shape, pool dtype, admit)
SCATTER = [
    ("main_f32", 4, (48, 48, 3), (32, 32, 3), "float32", [1, 0, 0, 1]),
    ("bf16_pool", 3, (48, 48, 3), (32, 32, 3), "bfloat16", [0, 1, 1]),
    ("null_refs", 4, (16, 16, 3), (1, 1, 3), "bfloat16", [1, 1, 0, 1]),
    ("rows_not_16B", 2, (5, 5, 3), (7, 7, 3), "float32", [1, 0]),
]


@pytest.mark.parametrize("case", SCATTER, ids=[c[0] for c in SCATTER])
def test_blocks_scatter_matches_reference(case):
    """Every block's chunk of every row, 16-byte units where the plan says
    so and elements where it does not (the 1x1x3 null refs, 75-element
    rows), assembles the golden's select bit-exact; the chunks tile each
    row."""
    name, S, bshape, rshape, dt, admit = case
    pool = getattr(torch, dt)
    batch = _np((S,) + bshape, seed=7)
    model = _np((S,) + bshape, seed=8)
    refs, gate = _np((S,) + rshape, seed=9), _np((S,) + rshape, seed=10)
    mask = np.asarray(admit, bool)
    plan = tvo.scatter_plan(S, int(np.prod(bshape)), int(np.prod(rshape)),
                            pool)
    # the null refs (3 elements) and 75- or 147-element rows: element by
    # element; every other row: 16-byte units
    assert plan["refs_vec"] == (name in ("main_f32", "bf16_pool"))
    assert plan["batch_vec"] == (name != "rows_not_16B")
    for units in (plan["batch_units"], plan["refs_units"]):
        chunks = tvo._chunks(units, plan["grid"][0])
        assert chunks[0][0] == 0 and chunks[-1][1] == units
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    got = tvo.scatter_blocks_plain(
        torch.from_numpy(batch).to(pool), torch.from_numpy(model),
        torch.from_numpy(refs), torch.from_numpy(gate),
        torch.from_numpy(mask))
    jbatch = jnp.asarray(batch, jnp.bfloat16 if dt == "bfloat16" else None)
    want = ref.scatter_admit_ref(jbatch, jnp.asarray(model),
                                 jnp.asarray(refs), jnp.asarray(gate),
                                 jnp.asarray(mask))
    assert got[0].dtype == pool
    for t, r in zip(got, want):
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(r, np.float32))


def test_scatter_plan_fills_the_card():
    """At the main path's shapes every thread has at most SCATTER_UNROLL
    16-byte units of the pool row in flight and the grid fills the SMs; a
    bf16 pool row is half as many units."""
    p = tvo.scatter_plan(32, 192 * 192 * 3, 32 * 32 * 3, torch.float32)
    assert p["batch_vec"] and p["refs_vec"] and p["batch_units"] == 27648
    X = p["grid"][0]
    assert X * tvo.SCATTER_UNROLL * tvo.THREADS >= 27648
    assert p["blocks"] >= H100_SMS
    q = tvo.scatter_plan(32, 192 * 192 * 3, 32 * 32 * 3, torch.bfloat16)
    assert q["batch_units"] == 13824 and q["grid"][0] == -(-X // 2)
    n = tvo.scatter_plan(32, 16 * 16 * 3, 3, torch.bfloat16)
    assert n["batch_vec"] and not n["refs_vec"] and n["grid"] == (1, 32)
