"""Port parity: MotionGate vs the reference (CPU).

The gate's host state (thresholds, EWMAs, stats) and its device
references must match the reference's exactly, tick by tick, on both
paths (``use_kernels`` off/on against ``use_pallas`` off/on, Pallas in
interpret mode).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.streams import MotionGate as JMotionGate
from repro_torch.streams import MotionGate


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(n, res, seed):
    """Random frames with a duplicate every third frame (gate fodder)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, res, res, 3)).astype(np.float32)
    x[2::3] = x[1::3][: len(x[2::3])]
    return x


def _gate_state(g):
    return (g.thresh.tolist(), g.has_ref.tolist(),
            [e.value for e in g.skip_ewma], g._since_adapt.tolist(),
            dataclasses.astuple(g.stats))


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_motion_gate_matches_reference_tick_by_tick(kernels):
    kw = dict(init_thresh=0.05, window=4, step=0.01)
    jg = JMotionGate(3, use_pallas=kernels, **kw)
    tg = MotionGate(3, use_kernels=kernels, device="cpu", **kw)
    rng = np.random.default_rng(2)
    frames = None
    for t in range(12):
        # a fresh scene on most ticks, the previous one (a duplicate) on
        # every third: the gate both admits and gates, and the AIMD
        # controller fires (window=4)
        if t % 3 != 2:
            frames = rng.random((3, 64, 64, 3)).astype(np.float32)
        active = rng.random(3) < 0.8
        a = jg.admit(jnp.asarray(frames), active)
        b = tg.admit(torch.from_numpy(frames), active)
        assert a.tolist() == b.tolist()
        assert _gate_state(jg) == _gate_state(tg)
        np.testing.assert_array_equal(tg.refs.numpy(), np.asarray(jg.refs))
    assert tg.stats.gated > 0 and tg.stats.admitted > 0


def test_motion_gate_uint8_frames_gate_like_reference():
    """uint8 frames normalize to [0, 1] before scoring on both paths."""
    a = np.full((1, 64, 64, 3), 100, np.uint8)
    b = np.full((1, 64, 64, 3), 103, np.uint8)        # 3/255 ~ 0.012
    active = np.array([True])
    for kernels in (False, True):
        jg = JMotionGate(1, init_thresh=0.005, use_pallas=kernels)
        tg = MotionGate(1, init_thresh=0.005, use_kernels=kernels,
                        device="cpu")
        for f in (a, b, b):
            assert (tg.admit(torch.from_numpy(f), active).tolist()
                    == jg.admit(jnp.asarray(f), active).tolist())
        assert dataclasses.astuple(tg.stats) == (3, 2, 1)


def test_gate_save_restore_travel_and_no_aliasing():
    """A saved lane keeps its reference and threshold when another stream
    is restored into the lane (torch views would alias; save clones)."""
    seq = _clip(4, 64, seed=3)
    jg, tg = JMotionGate(2, window=2), MotionGate(2, window=2, device="cpu")
    active = np.array([True, True])
    for t in range(2):
        jg.admit(jnp.asarray(seq[2 * t: 2 * t + 2]), active)
        tg.admit(torch.from_numpy(seq[2 * t: 2 * t + 2]), active)
    js, ts = jg.save(0), tg.save(0)
    saved_ref = ts["ref"].clone()
    jg.restore(0, jg.save(1))
    tg.restore(0, tg.save(1))           # lane 0 now holds lane 1's stream
    assert torch.equal(ts["ref"], saved_ref)
    np.testing.assert_array_equal(ts["ref"].numpy(), np.asarray(js["ref"]))
    jg.restore(1, js)
    tg.restore(1, ts)                   # the saved stream travels to lane 1
    assert _gate_state(jg) == _gate_state(tg)
    np.testing.assert_array_equal(tg.refs.numpy(), np.asarray(jg.refs))
    tg.reset(1)
    jg.reset(1)
    assert _gate_state(jg) == _gate_state(tg)
    assert tg.similar().use_kernels is False
    assert MotionGate(2, use_kernels=True, device="cpu").similar().use_kernels
