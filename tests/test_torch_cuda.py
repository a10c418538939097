"""The port's hand-written CUDA kernels on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card: the
kernels have no CPU mode.  This file imports no JAX (the card's machine has
none), so it keeps a copy of ``kernel_harness.TIGHT``; a CPU test in
``test_torch_vision_ops.py`` pins the two together.  Run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.clock import FRAME, TICK, VirtualClock
from repro_torch.data.synthetic import frame_loop
from repro_torch.kernels import vision_ops as tvo
from repro_torch.streams import INNER, OUTER, VisionServeEngine

TIGHT = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
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
    weights and frames: identical per-stream counts and flags."""
    out = {}
    for device in ("cuda", "cpu"):
        tvo.reset_launches()
        eng = VisionServeEngine(
            "e", slots=4, frame_res=64, input_res=32, use_kernels=True,
            clock=VirtualClock(rates={FRAME: 0.004, TICK: 0.0002}),
            generator=torch.Generator().manual_seed(3), device=device)
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
