"""The chunkwise mLSTM kernel's tiling and rounding, on the CPU.

``csrc/recurrent.cu`` computes the exact chunkwise mLSTM with the state C
split over value tiles, the 1/sqrt(Dh) scale on the fp32 scores, and for
bf16 inputs every fp32 operand of a tensor-core product (the gated panel,
C, V*w) rounded to bf16 hi + lo.  ``kernels.mlstm.mlstm_tiled_plain``
models that arithmetic in plain PyTorch; here it is held against the
reference's golden (``repro.kernels.ref.mlstm_ref``) and the reference's
Pallas chunkwise kernel in interpret mode, fp32 at the reference's mLSTM
limit (3e-4), bf16 inputs at LOOSE.  The launch geometry's host-side
mirrors (grids, shared memory) are checked against the card's limits.
Inputs come from numpy with a seed.  The kernels themselves run only on
the card (``test_torch_cuda.py``, ``chip_smoke.py`` phase 9).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import LOOSE
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.kernels import rglru as rglru_k

MLSTM_TOL = dict(rtol=3e-4, atol=3e-4)    # tests/test_kernels.py's limit


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(B, S, H, Dh, seed, i_shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    ig = (rng.normal(size=(B, S, H)) + i_shift).astype(np.float32)
    fg = (rng.normal(size=(B, S, H)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


def _tiled(case, dtype=torch.float32, **kw):
    q, k, v, ig, fg = (torch.from_numpy(x) for x in case)
    return mlstm_k.mlstm_tiled_plain(*(x.to(dtype) for x in (q, k, v)), ig,
                                     fg, **kw)


def _ref(case, dtype=jnp.float32):
    q, k, v, ig, fg = case
    return np.asarray(ref.mlstm_ref(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                    jnp.asarray(ig), jnp.asarray(fg)),
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("S,Dh", [(1, 32), (37, 48), (128, 32), (129, 48),
                                  (300, 32)])
def test_tiled_model_matches_reference_fp32(S, Dh):
    """fp32: one row, a short chunk, one whole chunk, one row past it and
    three chunks, Dh 32 and 48 (not multiples of the 64-column value
    tile), the state over value tiles of 16 columns."""
    case = _case(2, S, 2, Dh, seed=S + Dh)
    got = _tiled(case, value_cols=16)
    assert got.shape == (2, S, 2, Dh) and got.dtype == torch.float32
    _close(got, _ref(case), MLSTM_TOL)


@pytest.mark.parametrize("S,Dh", [(129, 48), (300, 32)])
def test_tiled_model_bf16_within_loose(S, Dh):
    """bf16 inputs: the panel, C and V*w as bf16 hi + lo, C kept split
    between chunks, the output rounded to bf16: within LOOSE of the
    reference on the same bf16 inputs."""
    case = _case(1, S, 2, Dh, seed=7 * S)
    got = _tiled(case, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, _ref(case, jnp.bfloat16), LOOSE)


def test_tiled_model_matches_interpret_kernel():
    """Against the Pallas chunkwise kernel in interpret mode at its own
    chunk (8 rows, S 20 ragged, padded by the reference's wrapper), Dh 32
    and 48, the model at the same chunk."""
    for Dh in (32, 48):
        case = _case(1, 20, 2, Dh, seed=Dh)
        want = jops.mlstm_chunkwise(*map(jnp.asarray, case), interpret=True,
                                    chunk=8)
        _close(_tiled(case, chunk=8, value_cols=16),
               np.asarray(want, np.float32), MLSTM_TOL)


def test_tiled_model_strongly_negative_input_gate():
    """i = -40: the floor exp(-m) takes the denominator; fp32 and bf16 stay
    finite and follow the reference."""
    case = _case(1, 300, 2, 32, seed=30, i_shift=-40.0)
    got = _tiled(case)
    assert torch.isfinite(got).all()
    _close(got, _ref(case), MLSTM_TOL)
    got = _tiled(case, torch.bfloat16)
    assert torch.isfinite(got.float()).all()
    _close(got, _ref(case, jnp.bfloat16), LOOSE)


def test_tiled_model_fp32_equals_the_plain_form():
    """fp32 (no split): the chunk recurrence and the quadratic form agree
    as closely as fp32 sums in another order do."""
    case = _case(1, 200, 2, 48, seed=11)
    q, k, v, ig, fg = (torch.from_numpy(x) for x in case)
    torch.testing.assert_close(_tiled(case),
                               mlstm_k.mlstm_chunkwise_plain(q, k, v, ig, fg),
                               rtol=1e-4, atol=1e-4)


def test_split_hi_lo_keeps_sixteen_bits():
    """hi + lo of an fp32 value is within 2^-16 of it (relative): the two
    bf16 mma operands carry 16 bits; hi alone carries 8."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=4096).astype(np.float32)) * 10.0
    err = ((mlstm_k.split_hi_lo(x) - x).abs() / x.abs()).max()
    assert float(err) <= 2.0 ** -16
    hi_err = ((x.to(torch.bfloat16).float() - x).abs() / x.abs()).max()
    assert float(hi_err) > 2.0 ** -16


def test_mlstm_shared_memory_fits_every_head_dim():
    """The kernel's shared memory (host mirror) fits one H100 block at every
    Dh <= 512, both dtypes; at Dh 512 bf16: C's 128 KB, n, two q/k stages
    of 128 rows x 144 bytes, the V tile, the gate vectors and n's partial
    sums."""
    for dtype in (torch.float32, torch.bfloat16):
        sizes = [mlstm_k.mlstm_smem_bytes(Dh, dtype)
                 for Dh in range(1, mlstm_k.MAX_HEAD_DIM + 1)]
        assert max(sizes) <= mlstm_k.SMEM_MAX
        assert sizes == sorted(sizes)
    assert mlstm_k.mlstm_smem_bytes(512, torch.bfloat16) == (
        512 * 64 * 4 + 512 * 4 + 2 * 2 * 128 * 144 + 128 * 144
        + 4 * (5 * 128 + 16) + 4 * 2 * 4 * 64)


def test_launch_geometry_fills_the_card():
    """The grids the wrappers launch: the RG-LRU's channel blocks give 128
    blocks at B 1, W 4096 (and cover a W that is not a multiple of the
    channels per block); the mLSTM's value tiles give 128 blocks at
    xlstm-350m's BH 16, Dh 512 (one wave on 132 SMs)."""
    assert rglru_k.rglru_grid(1, 4096) == (128, 1)
    assert rglru_k.rglru_grid(2, 1000) == (32, 2)
    assert rglru_k.rglru_grid(1, 77, 16) == (5, 1)
    assert rglru_k.rglru_smem_bytes() == 32 * 1024
    assert rglru_k.rglru_smem_bytes(64) <= mlstm_k.SMEM_MAX
    gx, gy = mlstm_k.mlstm_grid(4, 4, 512)
    assert (gx, gy) == (8, 16) and gx * gy == 128
    assert mlstm_k.mlstm_grid(2, 3, 48) == (1, 6)
