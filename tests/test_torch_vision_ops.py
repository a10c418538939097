"""Port parity: repro_torch.kernels.vision_ops vs the reference suite.

On the CPU each wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode (as its own tests do) and its
``kernels.ref`` goldens.  Inputs are made with numpy from a seed and handed
to all three.  Tolerances come from ``tests/kernel_harness.py``: nearest
resampling in fp32 and uint8 and the scatter (a pure select and cast) are
held bit-exact, everything that sums is held to TIGHT.

This file holds the resampling kernels (``ingest_frame``, ``downscale``);
``test_torch_vision_ops_select.py`` holds ``block_sad``, ``scatter_admit``
and the wrappers' contract.  The hand kernels themselves run only on the
card: ``test_torch_cuda.py`` holds them against the plain versions there,
and ``chip_smoke.py`` does the same at the main path's shapes.
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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape).astype(dtype)


def _check(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **tol)


# (name, S, H, W, model_res, gate_res, block, dtype, method, tol)
INGEST = [
    ("f32_nearest", 2, 64, 64, 48, 32, 8, np.float32, "nearest", EXACT),
    ("f32_box", 2, 64, 64, 48, 32, 8, np.float32, "box", TIGHT),
    ("u8_nearest", 2, 64, 64, 48, 32, 8, np.uint8, "nearest", EXACT),
    ("u8_box", 2, 64, 64, 48, 32, 8, np.uint8, "box", TIGHT),
    ("g20_block8", 2, 64, 64, 48, 20, 8, np.float32, "nearest", EXACT),
    ("odd_30x30_g13", 1, 30, 30, 16, 13, 8, np.float32, "nearest", EXACT),
    ("rect_37x53_box", 3, 37, 53, 24, 10, 4, np.float32, "box", TIGHT),
    ("u8_odd_box", 2, 30, 30, 15, 9, 4, np.uint8, "box", TIGHT),
    ("gate_eq_frame", 1, 32, 32, 32, 32, 8, np.float32, "nearest", EXACT),
]


@pytest.mark.parametrize("case", INGEST, ids=[c[0] for c in INGEST])
def test_ingest_frame_matches_reference(case):
    name, S, H, W, m, g, b, dt, method, tol = case
    frames, refs = _np((S, H, W, 3), dt, seed=1), _np((S, g, g, 3), seed=2)
    kw = dict(model_res=m, gate_res=g, block=b, method=method)
    got = tvo.ingest_frame(torch.from_numpy(frames), torch.from_numpy(refs),
                           **kw)
    pallas = jvo.ingest_frame(jnp.asarray(frames), jnp.asarray(refs),
                              interpret=True, **kw)
    golden = ref.ingest_frame_ref(jnp.asarray(frames), jnp.asarray(refs), **kw)
    for i, (t, p, r) in enumerate(zip(got, pallas, golden)):
        # the score sums in another order: TIGHT, never bit-exact
        out_tol = TIGHT if i == 2 else tol
        _check(t, r, out_tol)
        _check(t, p, out_tol)


DOWNSCALE = [
    ("nearest_48", (2, 64, 64, 3), np.float32, 48, "nearest", EXACT),
    ("box_17_rect", (2, 37, 53, 3), np.float32, 17, "box", TIGHT),
    ("u8_13", (1, 30, 30, 3), np.uint8, 13, "nearest", EXACT),
    ("u8_box_16", (2, 64, 64, 3), np.uint8, 16, "box", TIGHT),
]


@pytest.mark.parametrize("case", DOWNSCALE, ids=[c[0] for c in DOWNSCALE])
def test_downscale_matches_reference(case):
    name, shape, dt, res, method, tol = case
    x = _np(shape, dt, seed=3)
    got = tvo.downscale(torch.from_numpy(x), res, method=method)
    _check(got, ref.downscale_ref(jnp.asarray(x), res, method=method), tol)
    _check(got, jvo.downscale(jnp.asarray(x), res, method=method,
                              interpret=True), tol)


def test_card_tests_use_the_harness_tolerances():
    """``test_torch_cuda.py`` runs where JAX is absent, so it keeps its own
    copy of the harness tolerances; they must not drift."""
    import test_torch_cuda
    assert test_torch_cuda.TIGHT == TIGHT
