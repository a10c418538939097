"""Port parity: repro_torch.models vs the reference models (CPU).

Layouts, the detector and the pose model.  Inputs are made with numpy
from a seed and handed to both packages; the reference's own initialised
parameters are converted with ``repro_torch.convert``.  Convolution sums
run in another order in the two frameworks, so real-valued outputs are
held to rtol=1e-4, atol=1e-5; every discrete result (classes, keep masks,
argmax keypoints, flags) must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.eda_vision import detector_config as j_detector_config
from repro.configs.eda_vision import pose_config as j_pose_config
from repro.models import vision as JV
from repro_torch import convert
from repro_torch.configs.eda_vision import detector_config, pose_config
from repro_torch.models import vision as TV

CONV_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(res, seed=0):
    dc, pc = j_detector_config(res), j_pose_config(res)
    dp = JV.init_detector(dc, jax.random.key(seed))
    pp = JV.init_pose(pc, jax.random.key(seed + 1))
    return (dc, dp, convert.detector_from_jax(_np_tree(dp), device="cpu"),
            pc, pp, convert.pose_from_jax(_np_tree(pp), device="cpu"))


def _frames(n, res, seed=0):
    return np.random.default_rng(seed).random((n, res, res, 3)).astype(
        np.float32)


def _assert_close(j, t, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# layout divergences, each named
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [16, 17], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("depthwise", [False, True],
                         ids=["dense", "depthwise"])
def test_same_padding_matches_xla(res, stride, depthwise):
    """XLA "SAME" with stride 2 pads (0, 1) on an even input; conv2d's
    symmetric padding=1 would shift every output.  Even and odd sizes."""
    rng = np.random.default_rng(res * 10 + stride)
    c = 6
    w = rng.normal(size=(3, 3, 1 if depthwise else c, c)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    x = rng.random((2, res, res, c)).astype(np.float32)
    groups = c if depthwise else 1
    want = JV._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), stride=stride, groups=groups)
    tp = TV.from_hwio({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    got = TV._conv(tp, torch.from_numpy(x).permute(0, 3, 1, 2),
                   stride=stride, groups=groups).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    _assert_close(want, got, **CONV_TOL)


def test_hwio_to_oihw_layout():
    """Dense (kh,kw,cin,cout) -> (cout,cin,kh,kw); depthwise (kh,kw,1,c) ->
    (c,1,kh,kw); biases untouched."""
    w = np.arange(3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 4, 5)
    dw = np.arange(3 * 3 * 1 * 7, dtype=np.float32).reshape(3, 3, 1, 7)
    tree = convert.detector_from_jax(
        {"a": {"w": w, "b": np.ones(5, np.float32)}, "d": {"w": dw}},
        device="cpu")
    assert tuple(tree["a"]["w"].shape) == (5, 4, 3, 3)
    assert tree["a"]["w"][2, 1, 0, 2] == w[0, 2, 1, 2]
    assert tuple(tree["d"]["w"].shape) == (7, 1, 3, 3)
    assert tree["d"]["w"][6, 0, 2, 1] == dw[2, 1, 0, 6]
    assert torch.equal(tree["a"]["b"], torch.ones(5))


def test_detector_head_keeps_nhwc_anchor_order():
    """The head output is reshaped in NHWC order: anchor n of cell (y, x)
    must carry the reference's logits and box.  At res 48 (a 3x3 grid) an
    NCHW reshape would keep every shape and scramble the anchors."""
    dc, dp, tdp, *_ = _params(48)
    x = _frames(2, 48, seed=5)
    want = JV.detector_apply(dc, dp, jnp.asarray(x))
    got = TV.detector_apply(detector_config(48), tdp, torch.from_numpy(x))
    assert got["grid"] == want["grid"] == 3
    _assert_close(want["boxes"], got["boxes"], **CONV_TOL)
    _assert_close(want["scores"], got["scores"], **CONV_TOL)


# ---------------------------------------------------------------------------
# detector / pose end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [32, 35], ids=["even", "odd"])
def test_detector_and_decode_match_reference(res):
    dc, dp, tdp, *_ = _params(res, seed=3)
    x = _frames(3, res, seed=res)
    want = JV.detector_apply(dc, dp, jnp.asarray(x))
    got = TV.detector_apply(detector_config(res), tdp, torch.from_numpy(x))
    assert got["grid"] == want["grid"]
    _assert_close(want["scores"], got["scores"], **CONV_TOL)
    _assert_close(want["boxes"], got["boxes"], **CONV_TOL)
    # random weights give near-uniform class scores: threshold at their
    # median so keep/flag have both values to agree on
    thresh = float(np.median(np.asarray(want["scores"])[..., 1:].max(-1)))
    jd = JV.decode_detections(dc, want, score_thresh=thresh)
    td = TV.decode_detections(detector_config(res), got, score_thresh=thresh)
    for k in ("cls", "keep"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    assert 0 < int(td["keep"].sum()) < td["keep"].numel()
    for k in ("score", "cy", "cx", "h", "w"):
        _assert_close(jd[k], td[k], **CONV_TOL)
    np.testing.assert_array_equal(TV.flag_hazards(td).numpy(),
                                  np.asarray(JV.flag_hazards(jd)))


@pytest.mark.parametrize("res", [32, 35], ids=["even", "odd"])
def test_pose_matches_reference(res):
    *_, pc, pp, tpp = _params(res, seed=7)
    x = _frames(4, res, seed=res + 1)
    want = JV.pose_apply(pc, pp, jnp.asarray(x))
    got = TV.pose_apply(pose_config(res), tpp, torch.from_numpy(x))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    _assert_close(want["score"], got["score"], **CONV_TOL)
