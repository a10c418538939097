"""Port parity: ``block_sad`` and ``scatter_admit`` vs the reference, and
what the kernel wrappers refuse.

Same method as ``test_torch_vision_ops.py``: numpy inputs from a seed go
through the plain versions (CPU tensors), the reference's Pallas kernels in
interpret mode and its ``kernels.ref`` goldens.  Scores sum in another
order: TIGHT.  The scatter is a select and a cast: bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kernel_harness import TIGHT
from repro.kernels import ref
from repro.kernels import vision_ops as jvo
from repro_torch.kernels import vision_ops as tvo
from test_torch_vision_ops import _check, _np


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("hw", [32, 30, 20], ids=["div", "pad30", "g20"])
def test_block_sad_matches_reference(hw):
    a, b = _np((3, hw, hw, 3), seed=4), _np((3, hw, hw, 3), seed=5)
    got = tvo.block_sad(torch.from_numpy(a), torch.from_numpy(b), block=8)
    _check(got, ref.block_sad_ref(jnp.asarray(a), jnp.asarray(b), block=8),
           TIGHT)
    _check(got, jvo.block_sad(jnp.asarray(a), jnp.asarray(b), block=8,
                              interpret=True), TIGHT)


def test_block_sad_identical_frames_score_zero():
    x = torch.from_numpy(_np((3, 30, 30, 3), seed=6))
    assert torch.equal(tvo.block_sad(x, x, block=8), torch.zeros(3))


SCATTER = [
    ("none", [0, 0, 0, 0], np.float32),
    ("all", [1, 1, 1, 1], np.float32),
    ("mixed", [1, 0, 0, 1], np.float32),
    ("single_lane", [1], np.float32),
    ("bf16_pool", [1, 0, 1], "bfloat16"),
]


@pytest.mark.parametrize("case", SCATTER, ids=[c[0] for c in SCATTER])
def test_scatter_admit_matches_reference(case):
    """A select and a cast: bit-exact, the bf16 pool included (both sides
    round to nearest even)."""
    name, admit, dt = case
    S = len(admit)
    batch = _np((S, 48, 48, 3), seed=7)
    model, refs, gate = (_np((S, 48, 48, 3), seed=8),
                         _np((S, 32, 32, 3), seed=9),
                         _np((S, 32, 32, 3), seed=10))
    jbatch = jnp.asarray(batch, jnp.bfloat16 if dt == "bfloat16" else None)
    tbatch = torch.from_numpy(batch).to(
        torch.bfloat16 if dt == "bfloat16" else torch.float32)
    mask = np.asarray(admit, bool)
    args = (jnp.asarray(model), jnp.asarray(refs), jnp.asarray(gate),
            jnp.asarray(mask))
    want = ref.scatter_admit_ref(jbatch, *args)
    pallas = jvo.scatter_admit(jbatch, *args, interpret=True)
    got = tvo.scatter_admit(tbatch, torch.from_numpy(model),
                            torch.from_numpy(refs), torch.from_numpy(gate),
                            torch.from_numpy(mask))
    assert got[0].dtype == tbatch.dtype
    for t, r, p in zip(got, want, pallas):
        t32 = t.to(torch.float32).numpy()
        np.testing.assert_array_equal(t32, np.asarray(r, np.float32))
        np.testing.assert_array_equal(t32, np.asarray(p, np.float32))


def test_scatter_admit_returns_new_tensors():
    """Copy semantics, as in the reference: the inputs never change, so a
    caller holding a row of the old references keeps it."""
    batch, refs = torch.zeros(2, 4, 4, 3), torch.zeros(2, 2, 2, 3)
    held = refs[0]
    out_b, out_r = tvo.scatter_admit(batch, torch.ones(2, 4, 4, 3), refs,
                                     torch.ones(2, 2, 2, 3),
                                     torch.tensor([True, True]))
    assert out_b.data_ptr() != batch.data_ptr()
    assert float(batch.abs().sum()) == 0 and float(held.abs().sum()) == 0
    assert float(out_r.sum()) == out_r.numel()


# ---------------------------------------------------------------------------
# contract: what the wrappers refuse, and that the CPU path launches nothing
# ---------------------------------------------------------------------------


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros(1, 16, 16, 3)
    r = torch.zeros(1, 8, 8, 3)
    with pytest.raises(TypeError, match="uint8 or float32"):
        tvo.downscale(f.to(torch.bfloat16), 8)
    with pytest.raises(ValueError, match="upsample"):      # model res
        tvo.ingest_frame(f, r, model_res=32, gate_res=8, method="box")
    with pytest.raises(ValueError, match="upsample"):      # gate res
        tvo.ingest_frame(f, torch.zeros(1, 32, 32, 3), model_res=8,
                         gate_res=32, method="box")
    with pytest.raises(ValueError, match="refs"):
        tvo.ingest_frame(f, r, model_res=8, gate_res=4)
    with pytest.raises(ValueError, match="method"):
        tvo.downscale(f, 8, method="bilinear")
    with pytest.raises(TypeError, match="batch"):
        tvo.scatter_admit(torch.zeros(1, 4, 4, 3, dtype=torch.float16),
                          torch.zeros(1, 4, 4, 3), r, r, torch.tensor([True]))


def test_non_cpu_non_cuda_tensor_raises_not_falls_back():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel or raises."""
    f = torch.zeros(1, 16, 16, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tvo.downscale(f, 8)
    with pytest.raises(ValueError, match="different devices"):
        tvo.block_sad(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 3,
                                                           device="meta"))


def test_cpu_path_counts_no_launches():
    tvo.reset_launches()
    f = torch.from_numpy(_np((2, 32, 32, 3)))
    model, gate, score = tvo.ingest_frame(f, torch.zeros(2, 8, 8, 3),
                                          model_res=16, gate_res=8)
    tvo.scatter_admit(torch.zeros(2, 16, 16, 3), model,
                      torch.zeros(2, 8, 8, 3), gate, torch.tensor([1, 0]).bool())
    tvo.block_sad(gate, gate)
    tvo.downscale(f, 4)
    assert tvo.LAUNCHES == {"ingest_frame": 0, "scatter_admit": 0,
                            "downscale": 0, "block_sad": 0}
