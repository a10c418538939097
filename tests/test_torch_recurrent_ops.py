"""Port parity: the RG-LRU scan's and the chunkwise mLSTM's plain versions
vs the reference.

On the CPU ``repro_torch.kernels.rglru.rglru_scan`` and
``mlstm.mlstm_chunkwise`` run their plain PyTorch versions.  Held here
against the reference's goldens (``kernels/ref.py``), its Pallas kernels in
interpret mode (tiny shapes: interpret mode is slow) and its recurrent
step form.  fp32 RG-LRU at TIGHT (``tests/kernel_harness.py``); mLSTM at
rtol/atol 3e-4, the reference's own limit for its chunkwise kernel
(``tests/test_kernels.py``); bf16 at LOOSE.  Inputs come from numpy seeds.
The hand kernels run only on the card: ``test_torch_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import LOOSE, TIGHT
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.kernels import mlstm as mlstm_k
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rglru as rglru_k
from repro_torch.models import rglru as TR

MLSTM_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _decay(shape, seed):
    return np.random.default_rng(seed).uniform(0.2, 0.999, shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("B,S,W", [(1, 8, 16), (2, 37, 200)])
def test_rglru_plain_matches_reference(B, S, W, with_h0):
    """The sequential plain version against ``ref.rglru_scan_ref`` and the
    Pallas kernel in interpret mode (blocks of 16 steps x 128 channels, so
    S = 37 and W = 200 are not whole blocks and the carry crosses blocks)."""
    a, b = _decay((B, S, W), 1), _rand((B, S, W), 2)
    h0 = _rand((B, W), 3) if with_h0 else None
    jh0 = None if h0 is None else jnp.asarray(h0)
    got = rglru_k.rglru_scan_plain(*_t(a, b), None if h0 is None
                                   else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    _close(got, ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b), jh0),
           TIGHT)
    _close(got, jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), jh0,
                                interpret=True, block_s=16, block_w=128),
           TIGHT)


def test_rglru_carry_one_scan_equals_two_halves():
    """Scanning the second half from the first half's last h gives the
    full scan's second half: the plain version, the model's doubling scan
    and the CPU wrapper."""
    a, b = _decay((2, 64, 48), 4), _rand((2, 64, 48), 5)
    ta, tb = _t(a, b)
    for scan in (rglru_k.rglru_scan_plain, rglru_k.rglru_scan,
                 TR.rglru_scan):
        full = scan(ta, tb, None)
        second = scan(ta[:, 32:], tb[:, 32:], full[:, 31])
        torch.testing.assert_close(second, full[:, 32:], **TIGHT)


def test_rglru_model_scan_matches_reference_associative_scan():
    """``models.rglru.rglru_scan``'s plain path (log2 S doubling steps)
    against the reference's ``lax.associative_scan``, with h0 folded."""
    a, b, h0 = _decay((2, 45, 32), 6), _rand((2, 45, 32), 7), _rand((2, 32), 8)
    want = JR.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    _close(TR.rglru_scan(*_t(a, b, h0)), want, TIGHT)
    _close(TR.rglru_scan(*_t(a, b, h0), use_kernel=True), want, TIGHT)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_case(B, S, H, Dh, seed=0, i_shift=0.0):
    q, k, v = (_rand((B, S, H, Dh), seed + i) for i in range(3))
    ig = _rand((B, S, H), seed + 3) + i_shift
    fg = _rand((B, S, H), seed + 4) + 2.0
    return q, k, v, ig, fg


@pytest.mark.parametrize("B,S,H,Dh", [(1, 16, 2, 16), (2, 40, 2, 32),
                                      (1, 129, 4, 8)])
def test_mlstm_plain_matches_reference(B, S, H, Dh):
    """The quadratic parallel form against ``ref.mlstm_ref`` (S = 129 is
    one past a 128-row chunk)."""
    case = _mlstm_case(B, S, H, Dh)
    got = mlstm_k.mlstm_chunkwise_plain(*_t(*case))
    assert got.shape == (B, S, H, Dh) and got.dtype == torch.float32
    _close(got, ref.mlstm_ref(*map(jnp.asarray, case)), MLSTM_TOL)


def test_mlstm_plain_matches_interpret_kernel():
    """Against the Pallas chunkwise kernel in interpret mode: Dh 16 and 32,
    chunk 8, S = 20 not a multiple of the chunk (padded by the reference)."""
    for Dh in (16, 32):
        case = _mlstm_case(1, 20, 2, Dh, seed=10)
        want = jops.mlstm_chunkwise(*map(jnp.asarray, case), interpret=True,
                                    chunk=8)
        _close(mlstm_k.mlstm_chunkwise_plain(*_t(*case)), want, MLSTM_TOL)


def test_mlstm_plain_matches_step_sequence():
    """Against the reference's ``mlstm_step`` walked from the empty state
    (C = n = 0, m = -1e30): the parallel and recurrent forms agree."""
    B, S, H, Dh = 1, 24, 2, 16
    q, k, v, ig, fg = _mlstm_case(B, S, H, Dh, seed=20)
    state = {"C": jnp.zeros((B, H, Dh, Dh)), "n": jnp.zeros((B, H, Dh)),
             "m": jnp.full((B, H), -1e30)}
    outs = []
    for t in range(S):
        h, state = JS.mlstm_step(*(jnp.asarray(x[:, t])
                                   for x in (q, k, v, ig, fg)), state)
        outs.append(h)
    _close(mlstm_k.mlstm_chunkwise_plain(*_t(q, k, v, ig, fg)),
           jnp.stack(outs, axis=1), MLSTM_TOL)


def test_mlstm_strongly_negative_input_gate():
    """i = -40: the stabiliser's floor exp(-m) takes over the denominator;
    the plain version follows the reference there too."""
    case = _mlstm_case(1, 33, 2, 16, seed=30, i_shift=-40.0)
    got = mlstm_k.mlstm_chunkwise_plain(*_t(*case))
    assert torch.isfinite(got).all()
    _close(got, ref.mlstm_ref(*map(jnp.asarray, case)), MLSTM_TOL)


def test_mlstm_plain_bf16_loose():
    """bf16 inputs: fp32 inside, bf16 out, within LOOSE of the reference."""
    q, k, v, ig, fg = _mlstm_case(2, 19, 2, 16, seed=40)
    got = mlstm_k.mlstm_chunkwise_plain(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)), *_t(ig, fg))
    assert got.dtype == torch.bfloat16
    want = ref.mlstm_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                         jnp.asarray(ig), jnp.asarray(fg))
    _close(got, want, LOOSE)


# ---------------------------------------------------------------------------
# wrappers on CPU tensors
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    """CPU tensors go to the plain versions without being asked, launch
    nothing, and the wrappers check shapes; ``ops`` counts all six
    token-path kernels."""
    tops.reset_launches()
    a, b = _decay((1, 9, 24), 50), _rand((1, 9, 24), 51)
    h0 = _rand((1, 24), 52)
    ta, tb, th0 = _t(a, b, h0)
    assert torch.equal(tops.rglru_scan(ta, tb, th0),
                       rglru_k.rglru_scan_plain(ta, tb, th0))
    case = _t(*_mlstm_case(1, 10, 2, 8, seed=53))
    assert torch.equal(tops.mlstm_chunkwise(*case),
                       mlstm_k.mlstm_chunkwise_plain(*case))
    launches = tops.launches()
    assert set(launches) == {"flash", "decode", "paged_flash",
                             "paged_decode", "rglru_scan", "mlstm_chunkwise"}
    assert not any(launches.values())
    with pytest.raises(ValueError):
        rglru_k.rglru_scan(ta, tb[:, :5], th0)
    with pytest.raises(ValueError):
        rglru_k.rglru_scan(ta, tb, th0[:, :5])
    with pytest.raises(ValueError):
        mlstm_k.mlstm_chunkwise(case[0], case[1], case[2][:, :3], *case[3:])
    with pytest.raises(ValueError):
        mlstm_k.mlstm_chunkwise(*case[:3], case[3][:, :3], case[4])
    assert mlstm_k.DEFAULT_CHUNK == jops.mlstm_k.DEFAULT_CHUNK == 128
