"""Port parity: flag rules, the downscale gather, FLOP counts and the
port's own initialisation vs the reference models (CPU).

Same method as ``test_torch_models.py`` (reference parameters converted
with ``repro_torch.convert``, numpy inputs from a seed); every result here
is discrete or exact and must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.eda_vision import detector_config as j_detector_config
from repro.configs.eda_vision import pose_config as j_pose_config
from repro.models import vision as JV
from repro_torch.configs.eda_vision import detector_config, pose_config
from repro_torch.data.synthetic import synth_frames
from repro_torch.models import vision as TV
from test_torch_models import _frames, _params


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_analyse_pipelines_match_reference_on_dashcam_clip():
    """Downscale -> model -> flag on synthetic dash-cam frames at frame
    resolution 64 and model resolution 32: identical flags."""
    dc, dp, tdp, pc, pp, tpp = _params(32, seed=11)
    x = synth_frames(4, 6, res=64)
    jf, jdet = JV.analyse_outer(dc, dp, jnp.asarray(x))
    tf, tdet = TV.analyse_outer(detector_config(32), tdp, torch.from_numpy(x))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tdet["cls"].numpy(), np.asarray(jdet["cls"]))
    jdis, jkp = JV.analyse_inner(pc, pp, jnp.asarray(x))
    tdis, tkp = TV.analyse_inner(pose_config(32), tpp, torch.from_numpy(x))
    np.testing.assert_array_equal(tdis.numpy(), np.asarray(jdis))
    np.testing.assert_array_equal(tkp["y"].numpy(), np.asarray(jkp["y"]))


def test_flag_logic_identical_on_shared_inputs():
    """The flag rules alone, on inputs built to hit both branches often."""
    rng = np.random.default_rng(2)
    B, N, K = 16, 24, 17
    det = {"cls": rng.integers(0, 10, (B, N)),
           "keep": rng.random((B, N)) < 0.5,
           "cy": rng.random((B, N)).astype(np.float32),
           "cx": rng.random((B, N)).astype(np.float32),
           "h": rng.random((B, N)).astype(np.float32),
           "w": rng.random((B, N)).astype(np.float32)}
    want = np.asarray(JV.flag_hazards({k: jnp.asarray(v)
                                       for k, v in det.items()}))
    got = TV.flag_hazards({k: torch.from_numpy(v) for k, v in det.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
    kp = {"y": rng.random((B, K)).astype(np.float32),
          "x": rng.random((B, K)).astype(np.float32),
          "score": rng.random((B, K)).astype(np.float32)}
    want = np.asarray(JV.flag_distraction({k: jnp.asarray(v)
                                           for k, v in kp.items()}))
    got = TV.flag_distraction({k: torch.from_numpy(v) for k, v in kp.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


# ---------------------------------------------------------------------------
# downscale gather, FLOPs, the port's own init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res", [16, 48, 64])
def test_downscale_gather_bit_exact(res):
    x = _frames(2, 64, seed=res)
    want = np.asarray(JV.downscale(jnp.asarray(x), res))
    got = TV.downscale(torch.from_numpy(x), res).numpy()
    assert (got == want).all()


def test_downscale_gather_refuses_box_without_kernels():
    with pytest.raises(ValueError, match="use_kernels"):
        TV.downscale(torch.zeros(1, 16, 16, 3), 8, method="box")


@pytest.mark.parametrize("res", [16, 32, 48, 192])
def test_flops_match_reference(res):
    for jc, tc in ((j_detector_config(res), detector_config(res)),
                   (j_pose_config(res), pose_config(res))):
        assert TV.model_flops(tc) == JV.model_flops(jc)
        assert TV.backbone_flops(tc) == JV.backbone_flops(jc)


def test_port_init_is_seeded_oihw_and_lecun_scaled():
    dc = detector_config(32)
    a = TV.init_detector(dc, torch.Generator().manual_seed(0), device="cpu")
    b = TV.init_detector(dc, torch.Generator().manual_seed(0), device="cpu")
    c = TV.init_detector(dc, torch.Generator().manual_seed(1), device="cpu")
    ref_shapes = jax.tree.map(
        lambda p: p.shape, JV.detector_params(j_detector_config(32)),
        is_leaf=lambda p: hasattr(p, "init"))
    w, wref = a["backbone"]["pw4"]["w"], ref_shapes["backbone"]["pw4"]["w"]
    assert tuple(w.shape) == (wref[3], wref[2], wref[0], wref[1])
    assert torch.equal(w, b["backbone"]["pw4"]["w"])
    assert not torch.equal(w, c["backbone"]["pw4"]["w"])
    fan_in = wref[0] * wref[1] * wref[2]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.05
    assert torch.count_nonzero(a["backbone"]["pw4"]["b"]) == 0
