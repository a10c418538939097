"""The port's hand-written CUDA kernels on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card: the
kernels have no CPU mode.  This file imports no JAX (the card's machine has
none), so it keeps copies of ``kernel_harness.TIGHT`` and ``LOOSE``; CPU
tests in ``test_torch_vision_ops.py`` and ``test_torch_attention_ops.py``
pin them together.  Run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import get_arch
from repro_torch.core.clock import FRAME, PREFILL, TICK, TOKEN, VirtualClock
from repro_torch.data.synthetic import frame_loop
from repro_torch.kernels import ops as kops
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.kernels import paged_attention as pa_k
from repro_torch.kernels import rglru as rglru_k
from repro_torch.kernels import vision_ops as tvo
from repro_torch.models import transformer as TT
from repro_torch.models.attention import RunOpts
from repro_torch.models.param import tree_leaves, tree_to
from repro_torch.serving import Request, ServeEngine
from repro_torch.streams import INNER, OUTER, VisionServeEngine

TIGHT = dict(rtol=2e-5, atol=2e-5)
LOOSE = dict(rtol=2e-2, atol=2e-2)
MLSTM_TOL = dict(rtol=3e-4, atol=3e-4)   # tests/test_kernels.py's limit


@pytest.fixture(scope="session")
def built():
    """Build the kernel libraries once, in set-up: a build of
    ``attention.cu`` takes tens of seconds, which no test should count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build
    for name in ("vision_ops", "attention", "decode_attention", "recurrent"):
        build.load(name)


@pytest.fixture
def dev(built):
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    """Full fp32 convolutions for the duration of a test: flags are
    threshold decisions that TF32 rounding could flip."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


def _rand(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    return torch.from_numpy(rng.random(shape).astype(dtype))


def _close(got, want, exact):
    got, want = got.cpu(), want.cpu()
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TIGHT)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("method", ["nearest", "box"])
def test_resample_kernels_match_plain(dev, dtype, method):
    """Nearest bit-exact, box and scores TIGHT, at g=20 with block=8."""
    frames = _rand((3, 64, 64, 3), dtype, seed=11).to(dev)
    refs = _rand((3, 20, 20, 3), seed=12).to(dev)
    kw = dict(model_res=48, gate_res=20, block=8, method=method)
    got = tvo.ingest_frame(frames, refs, **kw)
    want = tvo.ingest_frame_plain(frames, refs, **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, exact=method == "nearest" and i < 2)
    _close(tvo.downscale(frames, 16, method=method),
           tvo.downscale_plain(frames, 16, method=method),
           exact=method == "nearest")


@pytest.mark.cuda
def test_block_sad_and_scatter_match_plain(dev):
    a = _rand((3, 30, 30, 3), seed=13).to(dev)
    b = _rand((3, 30, 30, 3), seed=14).to(dev)
    _close(tvo.block_sad(a, b), tvo.block_sad_plain(a, b), exact=False)
    for pool in (torch.float32, torch.bfloat16):
        batch = torch.zeros(3, 48, 48, 3, dtype=pool, device=dev)
        model = _rand((3, 48, 48, 3), seed=15).to(dev)
        admit = torch.tensor([True, False, True], device=dev)
        got = tvo.scatter_admit(batch, model, a, b, admit)
        want = tvo.scatter_admit_plain(batch, model, a, b, admit)
        for g, w in zip(got, want):
            _close(g, w, exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("method", ["nearest", "box"])
def test_downscale_kernel_is_the_ingest_model_rows(dev, dtype, method):
    """``downscale`` at the gateless engine's 192 px, at the gate's 32 px
    and on rows of 15 x 3 values (the element path): against plain
    (nearest bit-exact, box TIGHT), and bitwise equal to its model
    (``_resample_rows``), to a second call and to ``ingest_frame``'s model
    and gate frames of the same inputs."""
    frames = _rand((4, 256, 256, 3), dtype, seed=33).to(dev)
    small = _rand((3, 20, 20, 3), dtype, seed=34).to(dev)
    for f, m, g in ((frames, 192, 32), (small, 15, 13)):
        refs = torch.zeros(f.shape[0], g, g, 3, device=dev)
        fused = tvo.ingest_frame(f, refs, model_res=m, gate_res=g, block=8,
                                 method=method)
        x = tvo.normalize_plain(f)
        for res, want in ((m, fused[0]), (g, fused[1])):
            got = tvo.downscale(f, res, method=method)
            _close(got, tvo.downscale_plain(f, res, method=method),
                   exact=method == "nearest")
            assert torch.equal(got, tvo._resample_rows(x, res, method))
            assert torch.equal(got, tvo.downscale(f, res, method=method))
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [32, 20, 30])
def test_block_sad_kernel_is_the_ingest_score(dev, g):
    """``block_sad`` on ``ingest_frame``'s own gate frame gives its score
    bitwise (nearest and box); against plain within TIGHT and bitwise equal
    to ``sad_blocks_plain`` and to a second call, at partial edge tiles
    (20 and 30 with block 8), on a rectangular frame and on a map over
    48 KB (128 x 128)."""
    frames = _rand((4, 256, 256, 3), seed=35).to(dev)
    refs = _rand((4, g, g, 3), seed=36).to(dev)
    for method in ("nearest", "box"):
        _, gate, score = tvo.ingest_frame(frames, refs, model_res=48,
                                          gate_res=g, block=8, method=method)
        assert torch.equal(tvo.block_sad(refs, gate, 8), score)
    cases = [(refs, gate)] + [
        (_rand(shape, seed=37).to(dev), _rand(shape, seed=38).to(dev))
        for shape in ((3, g, g + 4, 3), (2, 128, 128, 3))]
    for a, b in cases:
        got = tvo.block_sad(a, b, 8)
        _close(got, tvo.block_sad_plain(a, b, 8), exact=False)
        assert torch.equal(got, tvo.sad_blocks_plain(a, b, 8))
        assert torch.equal(got, tvo.block_sad(a, b, 8))


def _off16(x):
    """x's values in a tensor that starts 4 bytes past a 16-byte boundary
    (the kernels' scalar paths)."""
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    return flat[1:].view(x.shape)


def _ingest_agrees(frames, refs, **kw):
    """The kernel against plain (nearest frames bit-exact, the rest TIGHT),
    and bitwise against ingest_blocks_plain and a second call."""
    got = tvo.ingest_frame(frames, refs, **kw)
    want = tvo.ingest_frame_plain(frames, refs, **kw)
    nearest = kw.get("method", "nearest") == "nearest"
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, exact=nearest and i < 2)
    again = tvo.ingest_frame(frames, refs, **kw)
    for a, b, c in zip(got, tvo.ingest_blocks_plain(frames, refs, **kw),
                       again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [48, 32, 16])
def test_ingest_kernel_at_tier_shapes(dev, res):
    """One launch at the tiers' model resolutions under gate 32, whose gate
    source rows are not all among the model's."""
    frames = _rand((4, 256, 256, 3), seed=21).to(dev)
    refs = _rand((4, 32, 32, 3), seed=22).to(dev)
    _ingest_agrees(frames, refs, model_res=res, gate_res=32, block=8)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["nearest", "box"])
def test_ingest_kernel_scalar_paths(dev, method):
    """Model rows that are not 16-byte multiples (15*3 floats) take the
    kernel's element path; uint8 rows of 60 bytes, refs rows of 13*3
    floats and frames or refs that start off a 16-byte boundary are read
    as they are."""
    frames = _rand((3, 20, 20, 3), np.uint8, seed=23).to(dev)
    refs = _rand((3, 13, 13, 3), seed=24).to(dev)
    _ingest_agrees(frames, refs, model_res=15, gate_res=13, block=4,
                   method=method)
    frames = _off16(_rand((2, 64, 64, 3), seed=25).to(dev))
    refs = _off16(_rand((2, 20, 20, 3), seed=26).to(dev))
    _ingest_agrees(frames, refs, model_res=48, gate_res=20, block=8,
                   method=method)


@pytest.mark.cuda
def test_ingest_kernel_at_every_rows_a_thread(dev, monkeypatch):
    """1 to 4 model rows a thread, a last block of fewer rows, and rows
    wider than a block's threads (two chunks a row) give the same frames
    and score bits."""
    frames = _rand((4, 96, 96, 3), seed=27).to(dev)
    refs = _rand((4, 20, 20, 3), seed=28).to(dev)
    for kw in (dict(model_res=72, gate_res=20, block=8),
               dict(model_res=400, gate_res=20, block=8)):
        first = None
        for rows in range(1, tvo.MAX_ROWS_PER_THREAD + 1):
            monkeypatch.setattr(tvo, "ROWS_PER_THREAD", rows)
            _ingest_agrees(frames, refs, **kw)
            got = tvo.ingest_frame(frames, refs, **kw)
            first = first or got
            assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_scatter_kernel_rows_and_null_refs(dev, pool):
    """16-byte rows, the 1x1x3 null refs, 75-element rows and inputs off a
    16-byte boundary: bit-exact to plain and to scatter_blocks_plain, the
    inputs untouched, two calls bitwise equal."""
    admit = torch.tensor([True, False, True, True], device=dev)
    for res, rshape in ((48, (32, 32, 3)), (16, (1, 1, 3)), (5, (7, 7, 3))):
        batch = _rand((4, res, res, 3), seed=29).to(dev).to(pool)
        model = _rand((4, res, res, 3), seed=30).to(dev)
        refs = _rand((4,) + rshape, seed=31).to(dev)
        gate = _rand((4,) + rshape, seed=32).to(dev)
        for b, mo in ((batch, model), (_off16(batch), _off16(model))):
            held = (b.clone(), refs.clone())
            got = tvo.scatter_admit(b, mo, refs, gate, admit)
            for g, w, v, a in zip(
                    got, tvo.scatter_admit_plain(b, mo, refs, gate, admit),
                    tvo.scatter_blocks_plain(b, mo, refs, gate, admit),
                    tvo.scatter_admit(b, mo, refs, gate, admit)):
                assert torch.equal(g, w) and torch.equal(g, v)
                assert torch.equal(g, a)
            assert torch.equal(b, held[0]) and torch.equal(refs, held[1])


@pytest.mark.cuda
def test_staging_buffer_waits_for_its_upload(dev):
    """The staging buffer is pinned and uploaded without blocking, so the
    next class's staging must wait for that upload before it writes, or
    frames still in flight could change under the copy."""
    eng = VisionServeEngine("e", slots=2, frame_res=64, input_res=32,
                            use_kernels=True, use_gate=False, device=dev,
                            generator=torch.Generator().manual_seed(0))
    outer = frame_loop(1, res=64, frames=2)(0)
    eng.open_stream("o", OUTER)
    eng.open_stream("i", INNER)
    eng.push("o", outer)
    eng.push("i", frame_loop(2, res=64, frames=2)(0))
    active = eng.stage_class(OUTER)
    batch, admit = eng._ingest_kernels(eng.batches[OUTER], None, active)
    upload = eng._upload_done
    assert upload is not None
    eng.stage_class(INNER)                 # writes the buffer again
    assert eng._upload_done is None and upload.query()
    lane = eng.streams["o"].lane
    want = tvo.downscale_plain(torch.from_numpy(outer)[None], 32)[0]
    assert admit[lane] and torch.equal(batch[lane].cpu(), want)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(dev, no_tf32):
    """The kernel path on the card and the plain path on the CPU, same
    weights (drawn on the host, then moved) and frames: identical
    per-stream counts and flags."""
    out, params = {}, None
    for device in ("cpu", "cuda"):
        tvo.reset_launches()
        eng = VisionServeEngine(
            "e", slots=4, frame_res=64, input_res=32, use_kernels=True,
            clock=VirtualClock(rates={FRAME: 0.004, TICK: 0.0002}),
            generator=torch.Generator().manual_seed(3), params=params,
            device=device)
        params = (eng.dp, eng.pp)
        for i in range(4):
            eng.open_stream(f"s{i}", OUTER if i % 2 == 0 else INNER)
            at = frame_loop(i, res=64, frames=12)
            for t in range(12):
                eng.push(f"s{i}", at(t))
        eng.drain()
        out[device] = {k: (s.processed, s.gated, s.dropped,
                           list(eng.results[k]))
                       for k, s in eng.streams.items()}
        if device == "cuda":
            assert tvo.LAUNCHES["ingest_frame"] > 0
            assert tvo.LAUNCHES["scatter_admit"] > 0
    assert out["cuda"] == out["cpu"]


# ---------------------------------------------------------------------------
# attention kernels (flash, decode, paged flash, paged decode)
# ---------------------------------------------------------------------------


def _attn_case(seed, lens, S, Hq, Hkv, D, bs, M, dtype, C=None):
    """Contiguous and paged views of the same logical KV.  Row b holds
    positions 0..lens[b]-1 in shuffled pool blocks (garbage values
    elsewhere, garbage positions in unreferenced blocks), its table
    columns past its length are -1, and its S queries sit at its last S
    positions.  The contiguous capacity is C (default: the longest row,
    rounded up to a block)."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    ncols = [max(1, -(-L // bs)) for L in lens]
    nb = sum(ncols) + 3
    perm = rng.permutation(nb)
    kp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    ppos = rng.integers(0, max(lens) + 4, (nb, bs)).astype(np.int32)
    tbl = np.full((B, M), -1, np.int32)
    C = C or max(ncols) * bs
    k = np.zeros((B, C, Hkv, D), np.float32)
    v = np.zeros((B, C, Hkv, D), np.float32)
    kv_pos = np.full((B, C), -1, np.int32)
    take = 0
    for b, L in enumerate(lens):
        blocks = perm[take: take + ncols[b]]
        take += ncols[b]
        tbl[b, :ncols[b]] = blocks
        for p in range(L):
            blk, off = blocks[p // bs], p % bs
            kp[blk, off] = k[b, p] = rng.normal(size=(Hkv, D))
            vp[blk, off] = v[b, p] = rng.normal(size=(Hkv, D))
            ppos[blk, off] = kv_pos[b, p] = p
        for p in range(L, ncols[b] * bs):      # tail entries: empty
            ppos[blocks[p // bs], p % bs] = -1
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    q_pos = np.stack([np.arange(L - S, L) for L in lens]).astype(np.int32)
    t = lambda a: torch.from_numpy(a)
    cast = lambda a: t(a).to(dtype)
    return dict(q=cast(q), k=cast(k), v=cast(v), kp=cast(kp), vp=cast(vp),
                ppos=t(ppos), tbl=t(tbl), q_pos=t(q_pos), kv_pos=t(kv_pos))


def _run_all(c, window, dev):
    """(kernel, plain) outputs of the four kernels on one case."""
    g = {n: x.to(dev) for n, x in c.items()}
    S = c["q"].shape[1]
    out = []
    if S == 1:
        out.append((dec_k.decode_attention(g["q"], g["k"], g["v"], g["q_pos"],
                                           g["kv_pos"], window=window),
                    dec_k.decode_attention_plain(g["q"], g["k"], g["v"],
                                                 g["q_pos"], g["kv_pos"],
                                                 window=window)))
        out.append((pa_k.paged_decode_attention(
            g["q"], g["kp"], g["vp"], g["ppos"], g["tbl"], g["q_pos"],
            window=window), pa_k.paged_decode_attention_plain(
            g["q"], g["kp"], g["vp"], g["ppos"], g["tbl"], g["q_pos"],
            window=window)))
    out.append((fa_k.flash_attention(g["q"], g["k"], g["v"], g["q_pos"],
                                     g["kv_pos"], window=window),
                fa_k.flash_attention_plain(g["q"], g["k"], g["v"], g["q_pos"],
                                           g["kv_pos"], window=window)))
    out.append((pa_k.paged_flash_attention(
        g["q"], g["kp"], g["vp"], g["ppos"], g["tbl"], g["q_pos"],
        window=window), pa_k.paged_flash_attention_plain(
        g["q"], g["kp"], g["vp"], g["ppos"], g["tbl"], g["q_pos"],
        window=window)))
    torch.cuda.synchronize()
    return out


def _check_decode(c, window, dev, tol):
    """Both decode kernels against their plain versions on one case: each
    call is one launch, two calls are bitwise equal, and the ticket
    counters are back at 0 after the calls."""
    from repro_torch.kernels import attention_common as ac
    g = {n: x.to(dev) for n, x in c.items()}
    dense = (g["q"], g["k"], g["v"], g["q_pos"], g["kv_pos"])
    pool = (g["q"], g["kp"], g["vp"], g["ppos"], g["tbl"], g["q_pos"])
    calls = {
        "decode": (dec_k, lambda: dec_k.decode_attention(*dense,
                                                         window=window),
                   lambda: dec_k.decode_attention_plain(*dense,
                                                        window=window)),
        "paged_decode": (pa_k, lambda: pa_k.paged_decode_attention(
            *pool, window=window), lambda: pa_k.paged_decode_attention_plain(
            *pool, window=window)),
    }
    for name, (mod, kern, plain) in calls.items():
        n0 = mod.LAUNCHES[name]
        first, second = kern(), kern()
        torch.cuda.synchronize()
        assert mod.LAUNCHES[name] == n0 + 2
        assert torch.equal(first, second), f"{name}: repeat differs"
        assert not ac.decode_counters(first.device).any()
        torch.testing.assert_close(first.float().cpu(),
                                   plain().float().cpu(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [(4, 1), (4, 4), (24, 2)],
                         ids=["gqa4", "mha", "g12"])
@pytest.mark.parametrize("S", [1, 7])
def test_attention_kernels_match_plain(dev, dtype, heads, S):
    """All four kernels against their plain versions: ragged lengths,
    trailing -1 columns, a window, D = 16 and 128.  The decode kernels
    (128-key splits) also at lengths on and one off a split boundary over
    several splits, and with more splits than live keys: one launch per
    call, repeats bitwise equal, ticket counters back at 0."""
    Hq, Hkv = heads
    D = 128 if Hq == 24 else 16
    tol = TIGHT if dtype == torch.float32 else LOOSE
    for window in (0, 8):
        c = _attn_case(1, [9, 40, 17], S, Hq, Hkv, D, 8, 8, dtype)
        for got, want in _run_all(c, window, dev):
            assert got.dtype == want.dtype == dtype
            torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                                       **tol)
    if S != 1:
        return
    for lens, M, C in (([64, 63, 65, 128, 127, 129, 192], 32, 256),
                       ([9, 1, 30], 64, 512)):
        for window in (0, 70):
            _check_decode(_attn_case(3, lens, 1, Hq, Hkv, D, 8, M, dtype,
                                     C=C), window, dev, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 128])
def test_attention_kernels_at_token_path_shapes(dev, S):
    """fp32 at TIGHT at starcoder2-3b's heads with 257 table columns of 16
    and a row of 1031 keys (a 1000-token prompt and 31 decoded): live
    columns compacted past 32, more than 48 KB of shared memory, more than
    32 key tiles."""
    lens = [1031] if S > 1 else [33, 517, 1000, 1031]
    c = _attn_case(6, lens, S, 24, 2, 128, 16, 257, torch.float32)
    for got, want in _run_all(c, 0, dev):
        torch.testing.assert_close(got.cpu(), want.cpu(), **TIGHT)


@pytest.mark.cuda
def test_attention_kernel_edges(dev):
    """A row whose table is all -1 gives exactly 0; a ring that has wrapped
    masks its stale entries by window; D = 64 with bs 16.  The decode
    kernels also: one split only, a -1 column in the middle of a row, a
    4096-key row at starcoder2-3b's heads and window (33 splits), and a
    wrapped contiguous ring."""
    for S in (3, 1):
        c = _attn_case(2, [5, 70], S, 8, 2, 64, 16, 6, torch.float32)
        c["tbl"][0] = -1
        c["kv_pos"][0] = -1
        for got, want in _run_all(c, 0, dev):
            assert torch.equal(got[0].cpu(), torch.zeros_like(got[0].cpu()))
            torch.testing.assert_close(got.cpu(), want.cpu(), **TIGHT)
    for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
        _check_decode(_attn_case(4, [40, 64], 1, 8, 2, 64, 16, 4, dtype),
                      0, dev, tol)                     # capacity 64: 1 split
        c = _attn_case(5, [70, 100], 1, 8, 2, 64, 16, 8, dtype)
        c["tbl"][0, 2] = -1                            # entries 32-47 of row 0
        c["kv_pos"][0, 32:48] = -1
        _check_decode(c, 0, dev, tol)
        c = _attn_case(6, [4100, 33], 1, 24, 2, 128, 16, 257, dtype, C=4112)
        _check_decode(c, 4096, dev, tol)
    # wrapped ring: positions 0..47 written into 2 columns of 16 (ring len
    # 2), so the pool holds 32..47 and 16..31; window 8 keeps 40..47
    q = torch.randn(1, 1, 8, 64, generator=torch.Generator().manual_seed(0))
    kp = torch.randn(4, 16, 2, 64, generator=torch.Generator().manual_seed(1))
    vp = torch.randn(4, 16, 2, 64, generator=torch.Generator().manual_seed(2))
    ppos = torch.full((4, 16), -1, dtype=torch.int32)
    ppos[2] = torch.arange(32, 48, dtype=torch.int32)
    ppos[1] = torch.arange(16, 32, dtype=torch.int32)
    tbl = torch.tensor([[2, 1, -1]], dtype=torch.int32)
    qp = torch.tensor([[47]], dtype=torch.int32)
    args = [x.to(dev) for x in (q, kp, vp, ppos, tbl, qp)]
    got = kops.paged_attention(*args, window=8)
    want = pa_k.paged_decode_attention_plain(*args, window=8)
    torch.testing.assert_close(got.cpu(), want.cpu(), **TIGHT)
    # the same ring contiguous: slot p % 32 holds position p
    k = torch.cat([kp[2], kp[1]])[None]
    v = torch.cat([vp[2], vp[1]])[None]
    kv_pos = torch.cat([ppos[2], ppos[1]])[None]
    args = [x.to(dev) for x in (q, k, v, qp, kv_pos)]
    got = dec_k.decode_attention(*args, window=8)
    torch.testing.assert_close(got.cpu(), dec_k.decode_attention_plain(
        *args, window=8).cpu(), **TIGHT)


@pytest.mark.cuda
def test_token_engine_on_card_matches_cpu(dev):
    """Reduced starcoder2-3b (fp32), both KV layouts: the kernels on the
    card and the plain versions on the CPU give the same token streams;
    the card run launched all four attention kernels."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch("starcoder2-3b").reduced()
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 23, 12, 9)]
        launches = {}
        for paged in (True, False):
            streams = {}
            for device in ("cuda", "cpu"):
                kops.reset_launches()
                eng = ServeEngine(
                    cfg, params if device == "cpu" else tree_to(params, dev),
                    slots=2, cache_capacity=48,
                    prefill_chunk=8, block_size=4, paged=paged,
                    opts=RunOpts(use_kernels=True), device=device,
                    clock=VirtualClock(rates={TOKEN: 0.002, PREFILL: 0.0005}))
                for i, p in enumerate(prompts):
                    eng.submit(Request(rid=f"r{i}", tokens=p,
                                       max_new_tokens=6, priority=i % 2))
                streams[device] = {r.rid: r.generated for r in eng.run()}
                if device == "cuda":
                    launches.update({k: n for k, n in kops.launches().items()
                                     if n})
            assert streams["cuda"] == streams["cpu"]
        assert set(launches) == {"flash", "decode", "paged_flash",
                                 "paged_decode"}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_attention_kernels_at_head_dim_256(dev):
    """recurrentgemma-9b's heads: D = 256, Hq 16 over one kv head (G 16),
    all four kernels, fp32 TIGHT and bf16 LOOSE, with and without a
    window; more than 48 KB of shared memory at any length.  The decode
    kernels also at lengths on and one off a split boundary, at the
    contiguous capacity of 2048 (32 splits) and recurrentgemma's window."""
    for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
        for S in (1, 9):
            for window in (0, 8):
                c = _attn_case(7, [12, 70], S, 16, 1, 256, 16, 6, dtype)
                for got, want in _run_all(c, window, dev):
                    torch.testing.assert_close(got.float().cpu(),
                                               want.float().cpu(), **tol)
        c = _attn_case(8, [127, 128, 129, 1031], 1, 16, 1, 256, 16, 65, dtype,
                       C=2048)
        for window in (0, 2048, 100):
            _check_decode(c, window, dev, tol)


def _flash_calls(g, window):
    """{name: (module, kernel call, plain call)} of both flash kernels."""
    dense = (g["q"], g["k"], g["v"], g["q_pos"], g["kv_pos"])
    pool = (g["q"], g["kp"], g["vp"], g["ppos"], g["tbl"], g["q_pos"])
    return {
        "flash": (fa_k, lambda: fa_k.flash_attention(*dense, window=window),
                  lambda: fa_k.flash_attention_plain(*dense, window=window)),
        "paged_flash": (pa_k, lambda: pa_k.paged_flash_attention(
            *pool, window=window), lambda: pa_k.paged_flash_attention_plain(
            *pool, window=window)),
    }


def _check_flash(c, window, dev, tol):
    """Both flash kernels against their plain versions on one case: each
    call is one launch, two calls are bitwise equal, and the flash ticket
    counters are back at 0 after the calls."""
    from repro_torch.kernels import attention_common as ac
    g = {n: x.to(dev) for n, x in c.items()}
    for name, (mod, kern, plain) in _flash_calls(g, window).items():
        n0 = mod.LAUNCHES[name]
        first, second = kern(), kern()
        torch.cuda.synchronize()
        assert mod.LAUNCHES[name] == n0 + 2
        assert torch.equal(first, second), f"{name}: repeat differs"
        assert not ac.flash_counters(first.device).any()
        torch.testing.assert_close(first.float().cpu(),
                                   plain().float().cpu(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 16, 128])
def test_flash_kernels_split_at_main_path_shapes(dev, S):
    """The redesigned flash kernels at the main paths' heads: starcoder2-3b
    (D 128, Hq 24 over Hkv 2, G 12; 257 table columns of 16, contiguous
    capacity 2048) and recurrentgemma-9b (D 256, Hq 16 over one kv head,
    G 16, window 2048), a row of 1031 keys beside shorter ones, fp32 at
    TIGHT and bf16 at LOOSE; repeats bitwise equal, counters back at 0."""
    for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
        c = _attn_case(9, [1031, 130, max(S, 40)], S, 24, 2, 128, 16, 257,
                       dtype, C=2048)
        _check_flash(c, 0, dev, tol)
        c = _attn_case(10, [1031, max(S, 300)], S, 16, 1, 256, 16, 129,
                       dtype, C=2048)
        _check_flash(c, 2048, dev, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 16, 128])
def test_flash_kernels_at_128_rows_per_block(dev, S, monkeypatch):
    """The bf16 instances of 128 rows per block (8 warps), which the sweep
    in chip_smoke.py times beside the default 64: the same main-path cases
    within LOOSE, repeats bitwise equal, counters back at 0."""
    from repro_torch.kernels import attention_common as ac
    monkeypatch.setattr(ac, "FLASH_ROWS", 128)
    assert ac.flash_rows(torch.bfloat16) == 128
    c = _attn_case(9, [1031, 130, max(S, 40)], S, 24, 2, 128, 16, 257,
                   torch.bfloat16, C=2048)
    _check_flash(c, 0, dev, LOOSE)
    c = _attn_case(10, [1031, max(S, 300)], S, 16, 1, 256, 16, 129,
                   torch.bfloat16, C=2048)
    _check_flash(c, 2048, dev, LOOSE)


@pytest.mark.cuda
def test_flash_kernels_ignore_garbage_outside_valid_keys(dev):
    """Unreferenced pool blocks, slots past a row's length and a -1 table
    column filled with NaN give output bitwise equal to the same case
    filled with zeros: such keys are never read (zero-filled copies), so
    p = 0 never meets NaN in P V."""
    for dtype, D in ((torch.float32, 64), (torch.bfloat16, 128),
                     (torch.bfloat16, 256)):
        base = _attn_case(11, [150, 70, 40], 37, 24 if D < 256 else 16,
                          2 if D < 256 else 1, D, 16, 12, dtype)
        base["tbl"][0, 2] = -1                         # entries 32-47
        base["kv_pos"][0, 32:48] = -1
        out = {}
        for fill in (0.0, float("nan")):
            c = {n: x.clone() for n, x in base.items()}
            used = torch.zeros(c["kp"].shape[0], dtype=torch.bool)
            used[c["tbl"][c["tbl"] >= 0].long()] = True
            dead = ~used[:, None] | (c["ppos"] < 0)    # (nb, bs)
            c["kp"][dead] = fill
            c["vp"][dead] = fill
            c["k"][c["kv_pos"] < 0] = fill
            c["v"][c["kv_pos"] < 0] = fill
            g = {n: x.to(dev) for n, x in c.items()}
            out[fill == 0.0] = {name: kern() for name, (_, kern, _)
                                in _flash_calls(g, 0).items()}
            if fill == 0.0:
                for name, (_, _, plain) in _flash_calls(g, 0).items():
                    torch.testing.assert_close(
                        out[True][name].float().cpu(),
                        plain().float().cpu(),
                        **(TIGHT if dtype == torch.float32 else LOOSE))
        for name in out[True]:
            assert torch.equal(out[True][name], out[False][name]), name


@pytest.mark.cuda
def test_decode_flash_decode_leave_every_counter_at_zero(dev):
    """decode -> flash -> decode on one device, as in a token tick: every
    ticket counter (decode's and flash's buffers) is 0 after each call, and
    each result equals the same call made alone."""
    from repro_torch.kernels import attention_common as ac
    for dtype in (torch.float32, torch.bfloat16):
        d = {n: x.to(dev) for n, x in _attn_case(
            12, [700, 1031, 64], 1, 24, 2, 128, 16, 65, dtype).items()}
        f = {n: x.to(dev) for n, x in _attn_case(
            13, [1031, 500], 64, 24, 2, 128, 16, 65, dtype).items()}
        dense = lambda c: (c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
        pool = lambda c: (c["q"], c["kp"], c["vp"], c["ppos"], c["tbl"],
                          c["q_pos"])
        alone = {"decode": dec_k.decode_attention(*dense(d)),
                 "paged_decode": pa_k.paged_decode_attention(*pool(d)),
                 "flash": fa_k.flash_attention(*dense(f)),
                 "paged_flash": pa_k.paged_flash_attention(*pool(f))}
        seq = [("decode", lambda: dec_k.decode_attention(*dense(d))),
               ("flash", lambda: fa_k.flash_attention(*dense(f))),
               ("paged_decode", lambda: pa_k.paged_decode_attention(
                   *pool(d))),
               ("paged_flash", lambda: pa_k.paged_flash_attention(*pool(f))),
               ("decode", lambda: dec_k.decode_attention(*dense(d)))]
        for name, call in seq:
            got = call()
            torch.cuda.synchronize()
            assert torch.equal(got, alone[name]), name
            assert not ac.decode_counters(dev).any()
            assert not ac.flash_counters(dev).any()


@pytest.mark.cuda
def test_flash_kernels_refuse_an_unsupported_head_dim(dev):
    """D 32 is not instantiated: both flash wrappers raise on the card
    rather than fall back."""
    c = {n: x.to(dev) for n, x in _attn_case(
        14, [40], 8, 4, 2, 32, 16, 4, torch.bfloat16).items()}
    with pytest.raises(ValueError, match="head dim"):
        fa_k.flash_attention(c["q"], c["k"], c["v"], c["q_pos"], c["kv_pos"])
    with pytest.raises(ValueError, match="head dim"):
        pa_k.paged_flash_attention(c["q"], c["kp"], c["vp"], c["ppos"],
                                   c["tbl"], c["q_pos"])


# ---------------------------------------------------------------------------
# recurrent kernels (RG-LRU scan, chunkwise mLSTM)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,with_h0", [(1, 128, 4096, True),
                                           (2, 37, 1000, False),
                                           (3, 1, 77, True),
                                           (1, 2, 4096, True),
                                           (1, 16, 4096, True),
                                           (1, 64, 4096, True),
                                           (2, 128, 4096, True),
                                           (1, 300, 1000, True)])
def test_rglru_kernel_matches_plain_exactly(dev, B, S, W, with_h0,
                                            monkeypatch):
    """Bit-identical to the plain version (products and sums rounded
    separately) at every channels per block: the main path's chunks (S 2,
    16, 64, 128; W 4096), B 2 with h0, S not a multiple of a stage, W not
    a multiple of the channels per block or of 4 (4-byte copies), one
    step; two calls bitwise equal."""
    rng = np.random.default_rng(B * 1000 + S)
    a = torch.from_numpy(rng.uniform(0.2, 0.999, (B, S, W)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=(B, S, W)).astype(np.float32)).to(dev)
    h0 = (torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32)).to(dev)
          if with_h0 else None)
    want = rglru_k.rglru_scan_plain(a, b, h0)
    for channels in (16, 32, 64):
        monkeypatch.setattr(rglru_k, "CHANNELS_PER_BLOCK", channels)
        rglru_k.reset_launches()
        got = rglru_k.rglru_scan(a, b, h0)
        assert rglru_k.LAUNCHES["rglru_scan"] == 1
        assert torch.equal(got, want), channels
        assert torch.equal(rglru_k.rglru_scan(a, b, h0), got), channels


def _mlstm_inputs(B, S, H, Dh, dtype, dev, seed, i_shift=0.0):
    rng = np.random.default_rng(seed)
    qkv = [torch.from_numpy(rng.normal(size=(B, S, H, Dh)).astype(
        np.float32)).to(dev, dtype) for _ in range(3)]
    ig = torch.from_numpy((rng.normal(size=(B, S, H)) + i_shift).astype(
        np.float32)).to(dev)
    fg = torch.from_numpy((rng.normal(size=(B, S, H)) + 2.0).astype(
        np.float32)).to(dev)
    return (*qkv, ig, fg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Dh,i_shift", [
    (4, 512, 4, 512, 0.0),        # xlstm-350m prefill: BH 16, Dh 512
    (1, 200, 2, 64, 0.0),         # a ragged last chunk
    (2, 37, 3, 48, 0.0),          # one short chunk, Dh not a multiple of 32
    (1, 300, 2, 32, -40.0),       # strongly negative input gate
    (1, 128, 1, 512, 0.0),        # B*H = 1, one whole chunk
    (1, 129, 2, 64, 0.0),         # one row past the chunk boundary
    (2, 20, 1, 20, 0.0),          # Dh*2 bytes not a multiple of 16
])
def test_mlstm_kernel_matches_plain(dev, dtype, B, S, H, Dh, i_shift):
    """The chunkwise kernel against the quadratic plain form: fp32 at
    3e-4 (the reference's limit), bf16 at LOOSE; two calls bitwise equal;
    bf16 gates read in their own type give bitwise the result of fp32
    gates of the same values."""
    x = _mlstm_inputs(B, S, H, Dh, dtype, dev, S + Dh, i_shift)
    mlstm_k.reset_launches()
    got = mlstm_k.mlstm_chunkwise(*x)
    assert mlstm_k.LAUNCHES["mlstm_chunkwise"] == 1
    want = mlstm_k.mlstm_chunkwise_plain(*x)
    assert got.dtype == want.dtype == dtype
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               **(MLSTM_TOL if dtype == torch.float32
                                  else LOOSE))
    assert torch.equal(mlstm_k.mlstm_chunkwise(*x), got)
    gates = [gt.to(torch.bfloat16) for gt in x[3:]]
    assert torch.equal(mlstm_k.mlstm_chunkwise(*x[:3], *gates),
                       mlstm_k.mlstm_chunkwise(*x[:3],
                                               *(gt.float() for gt in gates)))


@pytest.mark.cuda
def test_mlstm_smem_mirror_matches_kernel(dev):
    """``mlstm_smem_bytes`` equals the kernel's own count, and fits the
    card's 227 KB, at every Dh <= 512 and both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        for Dh in range(1, mlstm_k.MAX_HEAD_DIM + 1):
            want = mlstm_k.kernel_smem_bytes(Dh, dtype)
            assert mlstm_k.mlstm_smem_bytes(Dh, dtype) == want
            assert want <= mlstm_k.SMEM_MAX


@pytest.mark.cuda
def test_recurrent_kernels_refuse_what_they_do_not_take(dev):
    """A CUDA tensor the kernel refuses raises; it never falls back."""
    a = torch.rand(1, 4, 8, device=dev)
    with pytest.raises(TypeError):
        rglru_k.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError):
        rglru_k.rglru_scan(a, a.cpu())
    with pytest.raises(ValueError):
        rglru_k.rglru_scan(a[:, :, ::2], a[:, :, ::2])
    x = _mlstm_inputs(1, 4, 1, 640, torch.float32, dev, 0)
    with pytest.raises(ValueError, match="head dim"):
        mlstm_k.mlstm_chunkwise(*x)
    x = _mlstm_inputs(1, 4, 1, 16, torch.float16, dev, 0)
    with pytest.raises(TypeError):
        mlstm_k.mlstm_chunkwise(*x)
    x = _mlstm_inputs(1, 4, 1, 16, torch.float32, dev, 0)
    with pytest.raises(TypeError):
        mlstm_k.mlstm_chunkwise(*x[:3], x[3].half(), x[4].half())
    with pytest.raises(TypeError):
        mlstm_k.mlstm_chunkwise(*x[:3], x[3].bfloat16(), x[4])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_recurrent_engines_on_card_match_cpu(dev, arch):
    """Reduced configs (fp32): the kernels on the card and the plain
    versions on the CPU give the same token streams through ServeEngine,
    and the same ``prefill`` logits; the card runs launched the arch's
    kernels (the RG-LRU scan in served prefill chunks, the mLSTM in
    ``prefill``)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch(arch).reduced()
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 23, 12, 9)]
        streams, logits, launches = {}, {}, {}
        opts = RunOpts(use_kernels=True)
        for device in ("cuda", "cpu"):
            p = params if device == "cpu" else tree_to(params, dev)
            kops.reset_launches()
            eng = ServeEngine(cfg, p, slots=2, cache_capacity=48,
                              prefill_chunk=8, opts=opts, device=device,
                              clock=VirtualClock(rates={TOKEN: 0.002,
                                                        PREFILL: 0.0005}))
            for i, pr in enumerate(prompts):
                eng.submit(Request(rid=f"r{i}", tokens=pr, max_new_tokens=6,
                                   priority=i % 2))
            streams[device] = {r.rid: r.generated for r in eng.run()}
            toks = torch.as_tensor(np.stack([prompts[1][:20], prompts[1][3:]]),
                                   dtype=torch.long, device=device)
            first, caches = TT.prefill(cfg, p, toks, cache_capacity=32,
                                       opts=opts)
            # a 2-token chunk continuing both rows' prefilled state (B 2:
            # the RG-LRU scan takes the cached h as h0)
            pos = torch.tensor([[20, 21]] * 2, dtype=torch.int32,
                               device=device)
            more, _, _ = TT.forward(cfg, p, toks[:, :2], positions=pos,
                                    caches=caches, cache_index=20, opts=opts)
            logits[device] = torch.cat([first, more], dim=1)
            launches[device] = {k: n for k, n in kops.launches().items() if n}
        assert streams["cuda"] == streams["cpu"]
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                                   rtol=1e-3, atol=1e-3)
        want = ({"rglru_scan", "flash", "decode"} if arch.startswith("rec")
                else {"mlstm_chunkwise"})
        assert set(launches["cuda"]) == want and not launches["cpu"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# ---------------------------------------------------------------------------
# the fleet scenarios on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_golden_churn_on_card_equals_the_golden(dev):
    """The port's runner on the card reproduces the committed golden_churn
    digest and counts, through the gate's downscale and block-SAD
    kernels."""
    import json
    import pathlib

    from repro_torch.simulate import get_scenario, run_scenario
    golden = json.loads((pathlib.Path(__file__).parent / "golden"
                         / "fleet_scenario_v1.json").read_text())
    tvo.reset_launches()
    res = run_scenario(get_scenario("golden_churn"), device=dev)
    assert res.violations == []
    assert tvo.LAUNCHES["downscale"] > 0 and tvo.LAUNCHES["block_sad"] > 0
    assert {k: res.summary[k] for k in golden["summary"]} == golden["summary"]
    assert res.trace.counts() == golden["counts"]
    assert len(res.trace) == golden["events"]
    assert res.digest == golden["digest"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pallas_ingest", "mixed_serving"])
def test_warm_kernels_keeps_first_use_builds_flat(dev, name):
    """After ``warm_kernels`` nothing more is built through a run: the
    count ``jit_cache_entries`` reads at the warmup tick, at the end and
    after a second run are one number, and the recompile invariant
    holds."""
    from repro_torch.obs.probes import jit_cache_entries
    from repro_torch.simulate import ScenarioRunner, get_scenario
    s = get_scenario(name)
    runner = ScenarioRunner(s, device=dev)
    warmed = jit_cache_entries()
    assert warmed > 0
    res = runner.run()
    assert res.violations == []
    assert runner._cache_after_warmup == warmed == jit_cache_entries()
    ScenarioRunner(s, device=dev).run()
    assert jit_cache_entries() == warmed


# ---------------------------------------------------------------------------
# the fused fleet tick on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
def test_vision_kernels_on_flattened_rows_equal_per_replica_launches(dev,
                                                                     u8):
    """The fused tick's launches: 4 replicas x 16 slots in one launch of
    each vision kernel give each replica's rows bit for bit as four
    launches of 16 rows do (256 px frames to 192 and 32 px)."""
    R, S, H, m, g = 4, 16, 256, 192, 32
    frames = _rand((R * S, H, H, 3), np.uint8 if u8 else np.float32,
                   seed=0).to(dev)
    refs = _rand((R * S, g, g, 3), seed=1).to(dev)
    admit = torch.from_numpy(
        np.random.default_rng(2).random(R * S) < 0.5).to(dev)

    def per_replica(fn, *args):
        outs = [fn(*(a[r * S:(r + 1) * S].contiguous() for a in args))
                for r in range(R)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return (torch.cat(outs),)

    def same(a, b):
        a = a if isinstance(a, tuple) else (a,)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    def ingest(f, r):
        return tvo.ingest_frame(f, r, model_res=m, gate_res=g, block=8)
    tvo.reset_launches()
    model, small, scores = ingest(frames, refs)
    same((model, small, scores), per_replica(ingest, frames, refs))
    for res in (m, g):
        same(tvo.downscale(frames, res),
             per_replica(lambda f: tvo.downscale(f, res), frames))
    same(tvo.block_sad(refs, small), per_replica(tvo.block_sad, refs, small))
    for pool in (torch.float32, torch.bfloat16):
        batch = _rand((R * S, m, m, 3), seed=3).to(dev).to(pool)
        same(tvo.scatter_admit(batch, model, refs, small, admit),
             per_replica(tvo.scatter_admit, batch, model, refs, small,
                         admit))
    assert all(n > 0 for n in tvo.LAUNCHES.values())


@pytest.mark.cuda
def test_stacked_forward_flags_equal_per_replica_on_card(dev, no_tf32):
    """One grouped convolution a layer (the fused tick's forward) gives
    every replica's flags as its own forward does, on the card; outputs
    within TIGHT.  The detector head is scaled up so hazards fire."""
    from repro_torch.configs.eda_vision import detector_config, pose_config
    from repro_torch.models import vision as V
    R, B = 4, 16
    fired = [0, 0]
    for res in (32, 192):
        dc, pc = detector_config(res), pose_config(res)
        dps, pps = [], []
        for r in range(R):
            gen = torch.Generator().manual_seed(r)
            dp = V.init_detector(dc, gen, "cpu")
            dp["head"]["w"] = dp["head"]["w"] * 100.0
            dps.append(tree_to(dp, dev))
            pps.append(tree_to(V.init_pose(pc, gen, "cpu"), dev))
        frames = _rand((R, B, res, res, 3), seed=res).to(dev)
        flags, det = V.analyse_outer_stacked(dc, V.stack_params(dps), frames)
        dist, kp = V.analyse_inner_stacked(pc, V.stack_params(pps), frames)
        for r in range(R):
            rows = slice(r * B, (r + 1) * B)
            f1, d1 = V.analyse_outer(dc, dps[r], frames[r])
            g1, k1 = V.analyse_inner(pc, pps[r], frames[r])
            assert torch.equal(flags[r], f1) and torch.equal(dist[r], g1)
            for key in ("score", "h", "w"):
                _close(det[key][rows], d1[key], exact=False)
            for key in ("y", "x", "score"):
                _close(kp[key][rows], k1[key], exact=False)
            fired[0] += int(f1.any(dim=1).sum())
            fired[1] += int(g1.sum())
    assert fired[0] > 0 and fired[1] > 0


@pytest.mark.cuda
def test_golden_churn_fused_equals_serial_on_card(dev):
    """The fused tick on the card: the golden digest and summary as the
    serial tick gives them, one fused call for each tick that staged a
    frame, the gates' kernels launched."""
    import json
    import pathlib

    from repro_torch.simulate import ScenarioRunner, get_scenario
    golden = json.loads((pathlib.Path(__file__).parent / "golden"
                         / "fleet_scenario_v1.json").read_text())
    s = get_scenario("golden_churn")
    serial = ScenarioRunner(s, device=dev).run()
    runner = ScenarioRunner(s, device=dev, parallel=True)
    busy = []
    for r in runner.gw.replicas:
        def staged(kind, _stage=r.stage_class):
            active = _stage(kind)
            busy.append(bool(active.any()))
            return active
        r.stage_class = staged
    tick, work = runner.gw.tick, [0]

    def counted_tick(**kw):
        busy.clear()
        out = tick(**kw)
        work[0] += any(busy)
        return out
    runner.gw.tick = counted_tick
    tvo.reset_launches()
    fused = runner.run()
    assert serial.violations == [] and fused.violations == []
    assert tvo.LAUNCHES["downscale"] > 0 and tvo.LAUNCHES["block_sad"] > 0
    assert serial.digest == fused.digest == golden["digest"]
    assert serial.summary == fused.summary
    assert runner.gw._fleet.dispatches == work[0] > 0


# ---------------------------------------------------------------------------
# the MoE and MLA families' heads, layers, and the EDA runtime's pieces
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("heads,window,lens", [
    ((16, 8, 64), 0, [1031, 130, 40]),             # granite: G 2, D 64
    ((36, 4, 128), 4096, [4100, 130, 40]),         # starcoder2-7b: G 9
    ((40, 40, 128), 0, [1031, 130, 40]),           # qwen1.5-32b: G 1
    ((96, 8, 128), 0, [1031, 130, 40])],           # command-r: G 12
    ids=["granite-g2-d64", "starcoder2_7b-g9-w4096", "qwen-g1",
         "command_r-g12"])
def test_attention_kernels_at_new_family_heads(dev, heads, window, lens):
    """All four attention kernels at the new configs' heads against their
    plain versions, fp32 at TIGHT and bf16 at LOOSE: decode (one split per
    128 keys, a row of more than 4096 keys under starcoder2-7b's window)
    and a 16-row flash chunk; then the served shapes, one 128-token chunk
    and 8 decode rows over the engine's 128 table columns of 16 (the
    2048-entry capacity: at D 64 in bf16 the flash block's 48144 dynamic
    bytes and its static arrays pass 48 KB only together); one launch a
    call, repeats bitwise equal, ticket counters back at 0."""
    Hq, Hkv, D = heads
    M = -(-max(lens) // 16)
    for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
        _check_decode(_attn_case(11, lens, 1, Hq, Hkv, D, 16, M, dtype),
                      window, dev, tol)
        _check_flash(_attn_case(12, lens, 16, Hq, Hkv, D, 16, M, dtype),
                     window, dev, tol)
        _check_flash(_attn_case(13, [140], 128, Hq, Hkv, D, 16, 128, dtype,
                                C=2048), window, dev, tol)
        _check_decode(_attn_case(14, [140, 33, 1031, 517, 70, 260, 1000,
                                      90], 1, Hq, Hkv, D, 16, 128, dtype,
                                 C=2048), window, dev, tol)


# card vs CPU of the plain torch layers in fp32 with TF32 off: the two
# reduce d_model-long sums in other orders (about 1e-6 relative)
CARD_CPU = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_moe_apply_on_card_matches_cpu(dev, no_tf32):
    """granite-moe-1b-a400m's MoE layer at full width (32 experts, top 8,
    fp32) on 2 x 64 tokens and on 8 decode rows (the capacity floor):
    the card's routing equals the CPU's (the top-K gap is printed if not)
    and y, aux agree within CARD_CPU; two card calls are bitwise equal."""
    import dataclasses

    from repro_torch.models import moe as TM
    from repro_torch.models.param import init_tree
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m"),
                              param_dtype="float32", compute_dtype="float32")
    p = init_tree(TM.moe_params(cfg), torch.Generator().manual_seed(0))
    pc = tree_to(p, dev)
    for shape in ((2, 64), (8, 1)):
        x = torch.as_tensor(np.random.default_rng(sum(shape)).normal(
            size=shape + (cfg.d_model,)).astype(np.float32))
        logits = x.reshape(-1, cfg.d_model) @ p["router"]
        probs = torch.softmax(logits, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = float((top[:, cfg.moe.top_k - 1] - top[:, cfg.moe.top_k]).min())
        cprobs = torch.softmax(x.to(dev).reshape(-1, cfg.d_model)
                               @ pc["router"], dim=-1).cpu()
        assert torch.equal(TM._top_k(probs, cfg.moe.top_k)[1],
                           TM._top_k(cprobs, cfg.moe.top_k)[1]), (
            f"routes differ; smallest CPU top-{cfg.moe.top_k} gap {gap:.3g}")
        y, aux = TM.moe_apply(cfg, p, x)
        yc, auxc = TM.moe_apply(cfg, pc, x.to(dev))
        yc2, _ = TM.moe_apply(cfg, pc, x.to(dev))
        assert torch.equal(yc, yc2)
        torch.testing.assert_close(yc.cpu(), y, **CARD_CPU)
        torch.testing.assert_close(auxc.cpu(), aux, **CARD_CPU)


@pytest.mark.cuda
def test_mla_apply_on_card_matches_cpu(dev, no_tf32):
    """deepseek-v2-236b's MLA at full width (128 heads, kv_lora 512,
    q_lora 1536, fp32): the expanded prefill with ``fill_cache``, a
    contiguous 4-token chunk and a per-row decode step, card vs CPU within
    CARD_CPU, cache positions equal."""
    import dataclasses

    from repro_torch.models import mla as TMLA
    from repro_torch.models.param import init_tree
    cfg = dataclasses.replace(get_arch("deepseek-v2-236b"),
                              param_dtype="float32", compute_dtype="float32")
    p = init_tree(TMLA.mla_params(cfg), torch.Generator().manual_seed(1))
    pc = tree_to(p, dev)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(2, 24, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(24, dtype=torch.int32).repeat(2, 1)
    y, cache = TMLA.mla_apply(cfg, p, x, positions=pos, fill_cache=True,
                              cache_capacity=40)
    yc, cachec = TMLA.mla_apply(cfg, pc, x.to(dev), positions=pos.to(dev),
                                fill_cache=True, cache_capacity=40)
    torch.testing.assert_close(yc.cpu(), y, **CARD_CPU)
    for name in ("c", "k_rope"):
        torch.testing.assert_close(cachec[name].cpu(), cache[name],
                                   **CARD_CPU)
    assert torch.equal(cachec["pos"].cpu(), cache["pos"])
    x = torch.as_tensor(rng.normal(size=(2, 4, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(24, 28, dtype=torch.int32).repeat(2, 1)
    y, cache = TMLA.mla_apply(cfg, p, x, positions=pos, cache=cache,
                              cache_index=24)
    yc, cachec = TMLA.mla_apply(cfg, pc, x.to(dev), positions=pos.to(dev),
                                cache=cachec, cache_index=24)
    torch.testing.assert_close(yc.cpu(), y, **CARD_CPU)
    x = torch.as_tensor(rng.normal(size=(2, 1, cfg.d_model)).astype(
        np.float32))
    idx = torch.tensor([28, 30], dtype=torch.int32)
    y, cache = TMLA.mla_apply(cfg, p, x, positions=idx[:, None], cache=cache,
                              cache_index=idx)
    yc, cachec = TMLA.mla_apply(cfg, pc, x.to(dev),
                                positions=idx[:, None].to(dev), cache=cachec,
                                cache_index=idx.to(dev))
    torch.testing.assert_close(yc.cpu(), y, **CARD_CPU)
    assert torch.equal(cachec["pos"].cpu(), cache["pos"])


@pytest.mark.cuda
def test_device_prefetch_on_card_equal_and_ordered(dev):
    """``device_prefetch`` (the card by default): every batch arrives on
    the card, in order, equal to its host batch, usable on the consumer's
    stream at once; nested dicts and tuples keep their structure."""
    from repro_torch.data import device_prefetch
    rng = np.random.default_rng(3)
    batches = [{"frames": rng.random((2, 64, 64, 3)).astype(np.float32),
                "ids": (np.full((2,), i, np.int32),)} for i in range(12)]
    seen = []
    for i, b in enumerate(device_prefetch(iter(batches), depth=3)):
        assert b["frames"].device.type == "cuda"
        assert isinstance(b["ids"], tuple)
        total = b["frames"].sum()            # queued on the consumer stream
        seen.append((int(b["ids"][0][0]), b["frames"].cpu(), float(total)))
    assert [s[0] for s in seen] == list(range(12))
    for (_, got, total), want in zip(seen, batches):
        assert np.array_equal(got.numpy(), want["frames"])
        assert total == pytest.approx(float(want["frames"].sum()), rel=1e-5)


@pytest.mark.cuda
def test_real_executor_flags_card_equal_cpu(dev, no_tf32):
    """``examples/torch_eda_dashcam_serve.py``'s executor with one set of
    host-drawn weights: per-frame flags of 128 px clips at 96 px input on
    the card equal the CPU's, and a 2-pair runtime run on the card merges
    every video with flags equal to the CPU's on the same frames."""
    import importlib.util
    import pathlib

    from repro_torch.data import DashCamSource
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "torch_eda_dashcam_serve.py")
    spec = importlib.util.spec_from_file_location("eda_serve", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    src = DashCamSource(granularity_s=1.0, fps=12, res=128, seed=7)
    cpu = ex.RealExecutor(src, res=96, device="cpu")
    card = ex.RealExecutor(src, res=96, device=dev,
                           params=(tree_to(cpu.dp, dev), tree_to(cpu.pp, dev)))
    for i in range(2):
        pair = src.pair(i)
        for stream, clip in (("outer", pair.outer), ("inner", pair.inner)):
            assert np.array_equal(card.flags(stream, clip),
                                  cpu.flags(stream, clip))
    rt = ex.paper_runtime(card, fps=12)
    rt.run(2)
    assert len(rt.results) == 4 and not rt._pending
    for vid, frames in rt.results.items():
        pair = src.pair(int(vid.split("_")[0][1:]))
        stream = "outer" if "_out" in vid else "inner"
        want = cpu.flags(stream, getattr(pair, stream))
        assert {i: r["danger"] for i, r in frames.items()} == {
            i: bool(want[i]) for i in frames}


# ---------------------------------------------------------------------------
# the encoder-decoder and VLM families: the flash kernel's non-causal form
# ---------------------------------------------------------------------------


def _not_causal_case(seed, B, S, C, H, D, positions, dtype):
    """whisper-base's attention inputs: H heads (G 1) of D; the encoder's
    self-attention has q_pos = kv_pos = 0..C-1 (S = C), cross-attention
    every position 0."""
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor(
        rng.normal(size=shape).astype(np.float32)).to(dtype)
    if positions == "arange":
        q_pos = torch.arange(S, dtype=torch.int32).repeat(B, 1)
        kv_pos = torch.arange(C, dtype=torch.int32).repeat(B, 1)
    else:
        q_pos = torch.zeros(B, S, dtype=torch.int32)
        kv_pos = torch.zeros(B, C, dtype=torch.int32)
    return mk(B, S, H, D), mk(B, C, H, D), mk(B, C, H, D), q_pos, kv_pos


@pytest.mark.cuda
@pytest.mark.parametrize("S,positions", [(1500, "arange"), (1, "zeros"),
                                         (128, "zeros")],
                         ids=["encoder-1500", "cross-S1", "cross-S128"])
def test_flash_kernel_not_causal_at_whisper_shapes(dev, S, positions):
    """The flash kernel with ``causal=False`` at whisper-base's shapes (B 2,
    8 heads of 64, G 1, 1500 keys: not a multiple of the 64-key tile): the
    encoder's S = C = 1500 (24 row tiles, the keys in 256-key splits) and
    cross-attention's S 1 and 128 over 1500 keys at position 0; fp32 at
    TIGHT, bf16 at LOOSE against the plain version; one launch a call
    (``ops.flash_attention`` keeps S = 1 on flash when not causal), repeats
    bitwise equal, ticket counters back at 0."""
    from repro_torch.kernels import attention_common as ac
    for dtype, tol in ((torch.float32, TIGHT), (torch.bfloat16, LOOSE)):
        args = [t.to(dev) for t in _not_causal_case(
            15, 2, S, 1500, 8, 64, positions, dtype)]
        n0 = dict(kops.launches())
        first = kops.flash_attention(*args, causal=False)
        second = fa_k.flash_attention(*args, causal=False)
        torch.cuda.synchronize()
        got = kops.launches()
        assert got["flash"] == n0["flash"] + 2
        assert got["decode"] == n0["decode"]
        assert torch.equal(first, second)
        assert not ac.flash_counters(dev).any()
        want = fa_k.flash_attention_plain(*args, causal=False)
        torch.testing.assert_close(first.float().cpu(), want.float().cpu(),
                                   **tol)
        if positions == "arange":        # keys after a query count
            causal = fa_k.flash_attention_plain(*args, causal=True)
            assert not torch.allclose(first.float(), causal.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-2b"])
def test_encdec_and_vlm_on_card_match_cpu(dev, arch):
    """Reduced configs (fp32): ``prefill`` with frames or patches and 4
    teacher-forced ``decode_step``s give card logits within 1e-3 of the
    CPU's (the encoder and cross-attention through the flash kernel's
    non-causal form on the card); ``ServeEngine`` streams equal the CPU's
    in every layout the arch takes (whisper contiguous; internvl2 paged
    and contiguous), and the card runs launched the layout's kernels."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_arch(arch).reduced()
        params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        rng = np.random.default_rng(6)
        key = "frames" if arch == "whisper-base" else "patches"
        n = cfg.encoder_seq if key == "frames" else cfg.num_patches
        extra = torch.as_tensor(rng.normal(size=(2, n, cfg.d_model)).astype(
            np.float32))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)))
        follow = rng.integers(0, cfg.vocab_size, (4, 2, 1))
        opts = RunOpts(use_kernels=True)
        logits = {}
        for device in ("cuda", "cpu"):
            p = params if device == "cpu" else tree_to(params, dev)
            out, caches = TT.prefill(cfg, p, toks.to(device),
                                     extras={key: extra.to(device)},
                                     cache_capacity=16, opts=opts)
            steps = [out]
            for i, t in enumerate(follow):
                out, caches = TT.decode_step(
                    cfg, p, caches, torch.as_tensor(t).to(device), 9 + i,
                    opts=opts)
                steps.append(out)
            logits[device] = torch.cat(steps, dim=1)
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                                   rtol=1e-3, atol=1e-3)
        prompts = [rng.integers(0, cfg.vocab_size, m) for m in (5, 23, 12, 9)]
        for paged in ((True, False) if TT.paged_eligible(cfg) else (False,)):
            streams, launches = {}, {}
            for device in ("cuda", "cpu"):
                p = params if device == "cpu" else tree_to(params, dev)
                kops.reset_launches()
                eng = ServeEngine(cfg, p, slots=2, cache_capacity=48,
                                  prefill_chunk=8, block_size=4, paged=paged,
                                  opts=opts, device=device,
                                  clock=VirtualClock(rates={TOKEN: 0.002,
                                                            PREFILL: 0.0005}))
                for i, pr in enumerate(prompts):
                    eng.submit(Request(rid=f"r{i}", tokens=pr,
                                       max_new_tokens=6, priority=i % 2))
                streams[device] = {r.rid: r.generated for r in eng.run()}
                launches[device] = {k for k, m in kops.launches().items()
                                    if m}
            assert streams["cuda"] == streams["cpu"]
            assert launches["cuda"] == ({"paged_decode", "paged_flash"}
                                        if paged else {"decode", "flash"})
            assert not launches["cpu"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _train_batch(cfg, B, S, seed=0):
    from repro_torch.data import lm_batches
    return {k: torch.as_tensor(v) for k, v in
            next(lm_batches(B, S, cfg.vocab_size, seed=seed, steps=1)).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-3b", "granite-moe-1b-a400m"])
def test_train_step_on_card_matches_cpu(dev, no_tf32, arch):
    """One train step (grad_accum 2, remat full, fp32) on the card and on
    the CPU from one host draw: loss rtol 1e-5, grad norm rtol 1e-4, the
    updated parameters within 0.05 lr; no hand kernel launched."""
    from repro_torch.config import ParallelConfig
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    cfg = get_arch(arch).reduced()
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _train_batch(cfg, 4, 16)
    lr = 1e-3
    step = make_train_step(cfg, ParallelConfig(grad_accum=2, remat="full"),
                           AdamWConfig(lr=lr, warmup_steps=1))
    out = {}
    for device in ("cuda", "cpu"):
        p = tree_to(params, torch.device(device))
        kops.reset_launches()
        p, _, m = step(p, init_opt_state(p),
                       {k: v.to(device) for k, v in batch.items()})
        assert not any(kops.launches().values())
        out[device] = (p, {k: float(v) for k, v in m.items()})
    (pc, mc), (ph, mh) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(mc["loss"], mh["loss"], rtol=1e-5)
    np.testing.assert_allclose(mc["grad_norm"], mh["grad_norm"], rtol=1e-4)
    for a, b in zip(tree_leaves(pc), tree_leaves(ph)):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0.05 * lr)


@pytest.mark.cuda
def test_kernels_refuse_grad_on_card(dev):
    """Given CUDA inputs that require grad under grad mode, each token
    kernel's entry point raises; under ``no_grad`` it launches and equals
    its plain version."""
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, Hq, Hkv, D = 1, 8, 4, 2, 64
    q = torch.randn(B, S, Hq, D, device=dev, generator=g)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=g)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].contiguous()
    kp = k.reshape(S // 4, 4, Hkv, D).contiguous()
    ppos = pos.reshape(S // 4, 4).contiguous()
    tbl = torch.arange(S // 4, dtype=torch.int32, device=dev)[None]
    a = torch.rand(B, S, 32, device=dev, generator=g)
    qm = torch.randn(B, S, 2, 16, device=dev, generator=g)
    gate = torch.randn(B, S, 2, device=dev, generator=g)
    q1, pos1 = q[:, -1:].contiguous(), pos[:, -1:].contiguous()
    calls = {
        "flash": (lambda q: fa_k.flash_attention(q, k, k, pos, pos), q),
        "decode": (lambda q: dec_k.decode_attention(q, k, k, pos1, pos), q1),
        "paged_flash": (lambda q: pa_k.paged_flash_attention(
            q, kp, kp, ppos, tbl, pos), q),
        "paged_decode": (lambda q: pa_k.paged_decode_attention(
            q, kp, kp, ppos, tbl, pos1), q1),
        "rglru_scan": (lambda x: rglru_k.rglru_scan(x, a), a),
        "mlstm_chunkwise": (lambda x: mlstm_k.mlstm_chunkwise(
            x, qm, qm, gate, gate), qm),
    }
    plain = {"flash": lambda q: fa_k.flash_attention_plain(q, k, k, pos, pos),
             "decode": lambda q: dec_k.decode_attention_plain(
                 q, k, k, pos1, pos),
             "paged_flash": lambda q: pa_k.paged_flash_attention_plain(
                 q, kp, kp, ppos, tbl, pos),
             "paged_decode": lambda q: pa_k.paged_decode_attention_plain(
                 q, kp, kp, ppos, tbl, pos1),
             "rglru_scan": lambda x: rglru_k.rglru_scan_plain(x, a),
             "mlstm_chunkwise": lambda x: mlstm_k.mlstm_chunkwise_plain(
                 x, qm, qm, gate, gate)}
    for name, (fn, x) in calls.items():
        kops.reset_launches()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x.clone().requires_grad_())
        assert kops.launches()[name] == 0, name
        with torch.no_grad():
            got = fn(x.clone().requires_grad_())
        assert kops.launches()[name] == 1, name
        tol = MLSTM_TOL if name == "mlstm_chunkwise" else TIGHT
        torch.testing.assert_close(got, plain[name](x), **tol)


# ---------------------------------------------------------------------------
# the multi-device layer on one card (chip_smoke.py phase 19)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_world(dev, tmp_path):
    """A one-rank NCCL process group (a file rendezvous), torn down after
    the test."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
def test_dtensor_train_step_on_a_one_rank_mesh_equals_plain(dev, no_tf32,
                                                             nccl_world):
    """Phase 19 (a) at 2 layers: DTensor parameters, moments and batch on
    a (1, 1) NCCL mesh give the plain step's loss (1e-5) and grad norm
    (1e-4), and no hand kernel launches."""
    import dataclasses
    from repro_torch.config import ParallelConfig, ShapeConfig
    from repro_torch.data import lm_batches
    from repro_torch.sharding import rules
    from repro_torch.sharding.compat import make_device_mesh
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
    cfg = dataclasses.replace(get_arch("starcoder2-3b"), num_layers=2)
    par = ParallelConfig(grad_accum=2)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(
        lm_batches(4, 128, cfg.vocab_size, seed=0, steps=1)).items()}
    kops.reset_launches()
    got = {}
    for side in ("plain", "dtensor"):
        params = TT.init_params(cfg, torch.Generator().manual_seed(0), dev)
        mesh, b = None, batch
        if side == "dtensor":
            mesh = make_device_mesh((1, 1), ("data", "model"))
            params = rules.distribute(params, mesh,
                                      rules.param_pspecs(cfg, par, mesh))
            b = rules.distribute(batch, mesh, rules.batch_pspecs(
                cfg, ShapeConfig("t", 128, 4, "train"), par, mesh))
        step = make_train_step(cfg, par, AdamWConfig(lr=1e-3,
                                                     warmup_steps=1),
                               mesh=mesh)
        _, _, m = step(params, init_opt_state(params), b)
        got[side] = (float(m["loss"]), float(m["grad_norm"]))
    assert not any(kops.launches().values())
    (lp, gp), (ld, gd) = got["plain"], got["dtensor"]
    assert abs(ld - lp) <= 1e-5 * abs(lp) and abs(gd - gp) <= 1e-4 * abs(gp)


@pytest.mark.cuda
def test_hw_h100_matches_the_card(dev):
    """Phase 19 (b): the name, 132 SMs, the capacity within 5 % of the
    datasheet's 80 GB counted in GiB, and at least ``hbm_bytes``."""
    from repro_torch.roofline.analysis import H100_SMS, HW_H100
    prop = torch.cuda.get_device_properties(0)
    assert prop.name == HW_H100.name
    assert prop.multi_processor_count == H100_SMS == 132
    assert abs(prop.total_memory / 2 ** 30 - 80) <= 0.05 * 80
    assert prop.total_memory >= HW_H100.hbm_bytes


@pytest.mark.cuda
def test_collectives_pipeline_and_replica_mesh_on_one_card(dev, nccl_world):
    """Phase 19 (e): ``int8_psum`` on one rank is the int8 rounding of x;
    a one-stage pipeline equals the stack; a one-replica fleet through
    ``shard_map`` equals ``vmap`` and serial; two replicas on one card
    are refused with the card count."""
    from repro_torch.sharding.collectives import int8_psum
    from repro_torch.sharding.compat import make_device_mesh
    from repro_torch.sharding.pipeline import make_pipeline, stage_split
    from repro_torch.simulate import ReplicaSpec, get_scenario, run_scenario
    from repro_torch.streams import FleetStep
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1000, device=dev, generator=g)
    s = x.abs().max() / 127.0
    torch.testing.assert_close(int8_psum(x), torch.round(x / s) * s,
                               rtol=0, atol=0)
    mesh = make_device_mesh((1,), ("stage",))
    ws = torch.randn(2, 16, 16, device=dev, generator=g) * 0.3
    xs = torch.randn(3, 2, 16, device=dev, generator=g)

    def stage_fn(w, h):
        for wi in w:
            h = torch.tanh(h @ wi)
        return h
    got = make_pipeline(stage_fn, mesh)(stage_split(ws, 1), xs)
    torch.testing.assert_close(got, torch.stack([stage_fn(ws, xs[m])
                                                 for m in range(3)]))
    sc = get_scenario("golden_churn", ticks=40,
                      replicas=(ReplicaSpec("r0", slots=4),))
    digests = {mode: run_scenario(sc, device=dev, parallel=mode is not None,
                                  fleet_mode=mode).digest
               for mode in (None, "vmap", "shard_map")}
    assert len(set(digests.values())) == 1, digests
    engines = [VisionServeEngine(f"m{i}", slots=4, frame_res=32,
                                 input_res=16, device=dev,
                                 generator=torch.Generator().manual_seed(i))
               for i in range(2)]
    n = torch.cuda.device_count()
    if n < 2:
        with pytest.raises(ValueError, match=f"only {n} available"):
            FleetStep(engines, mode="shard_map")
