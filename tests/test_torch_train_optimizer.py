"""Port parity: ``repro_torch.train.optimizer`` vs the reference's
``train/optimizer.py`` (CPU).

The four optimizer tests of ``tests/test_train.py`` on the port; then
``adamw_update`` against the reference's over a random tree of bf16 and
fp32 leaves (a nested list too) for three steps, with fp32 and bf16
moments, at 1e-6; ``schedule_lr`` for cosine, linear and constant at step
0, the end of warmup and the total; ``global_norm``; and the update
landing in the caller's own tensors.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # bare env: vendored deterministic fallback
    from _hypothesis_stub import given, settings, strategies as st

from repro.train import optimizer as JO
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         global_norm, init_opt_state,
                                         schedule_lr)

from torch_train_common import as_f32, clone, flat


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_adamw_first_step_is_lr_sized():
    """After bias correction, |dp| ~ lr for a constant gradient."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, grad_clip=0.0,
                      warmup_steps=0, schedule="constant")
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 0.5)}
    p2, _, _ = adamw_update(cfg, g, clone(p), init_opt_state(p))
    np.testing.assert_allclose((p["w"] - p2["w"]).numpy(), np.full(4, 1e-2),
                               rtol=1e-4)


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0, warmup_steps=0,
                      schedule="constant", weight_decay=0.0)
    p = {"w": torch.zeros(1000)}
    g = {"w": torch.full((1000,), 100.0)}            # huge grads
    _, _, m = adamw_update(cfg, g, p, init_opt_state(p))
    assert float(m["grad_norm"]) > 1000


@given(step=st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_schedule_monotone_warmup_then_decay(step):
    cfg = AdamWConfig(lr=1.0, warmup_steps=100, total_steps=10_000)
    lr = float(schedule_lr(cfg, torch.tensor(step)))
    assert 0.0 <= lr <= 1.0
    if step < 100:
        assert lr <= step / 100 + 1e-6


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


def _random_tree(rng):
    """numpy leaves: fp32 and bf16, a dict and a nested list."""
    bf16 = ml_dtypes.bfloat16
    return {"emb": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((5, 7)).astype(bf16),
                        "b": rng.standard_normal((7,)).astype(np.float32)},
                       {"w": rng.standard_normal((5, 7)).astype(bf16),
                        "b": rng.standard_normal((7,)).astype(bf16)}]}


def _torch(tree):
    from repro_torch.convert import _tensors
    if isinstance(tree, list):
        return [_torch(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return _tensors(tree, torch.device("cpu"))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0, state_dtype=state_dtype)
    jcfg, cfg = JO.AdamWConfig(**kw), AdamWConfig(**kw)
    jp = _random_tree(rng)
    p = _torch(jp)
    jp = jax.tree.map(jnp.asarray, jp)
    js, s = JO.init_opt_state(jp, state_dtype), init_opt_state(p, state_dtype)
    jupd = jax.jit(lambda g, p, s: JO.adamw_update(jcfg, g, p, s))
    for _ in range(3):
        g = _random_tree(rng)
        jp, js, jm = jupd(jax.tree.map(jnp.asarray, g), jp, js)
        p, s, m = adamw_update(cfg, _torch(g), p, s)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        assert int(s["step"]) == int(js["step"])
        for got, want in ((p, jp), (s["mu"], js["mu"]), (s["nu"], js["nu"])):
            want = dict(flat(_torch(jax.tree.map(np.asarray, want))))
            assert sorted(want) == sorted(dict(flat(got)))
            for path, a in flat(got):
                b = want[path]
                assert a.dtype == b.dtype, path
                np.testing.assert_allclose(as_f32(a), as_f32(b), rtol=1e-6,
                                           atol=1e-6, err_msg=path)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in (0, 5, 10, 55, 100, 150):
        got = float(schedule_lr(AdamWConfig(**kw), torch.tensor(step)))
        want = float(JO.schedule_lr(JO.AdamWConfig(**kw), jnp.asarray(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_global_norm_matches_reference():
    tree = _random_tree(np.random.default_rng(3))
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(float(global_norm(_torch(tree))), want,
                               rtol=1e-6)


def test_update_writes_in_place():
    """The update lands in the caller's own tensors (the port's
    ``donate_argnums``), in their dtypes; moments of another dtype than
    the config's are refused."""
    rng = np.random.default_rng(1)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    p = _torch(_random_tree(rng))
    g = _torch(_random_tree(rng))
    s = init_opt_state(p)
    before = clone(p)
    storage = [t.data_ptr() for _, t in flat(p) + flat(s["mu"])]
    p2, s2, _ = adamw_update(cfg, g, p, s)
    assert p2 is p and s2 is s and int(s["step"]) == 1
    assert [t.data_ptr() for _, t in flat(p) + flat(s["mu"])] == storage
    for (path, a), (_, b) in zip(flat(p), flat(before)):
        assert a.dtype == b.dtype and not torch.equal(a, b), path
    with pytest.raises(ValueError, match="state dtype"):
        adamw_update(AdamWConfig(state_dtype="bfloat16"), g, p, s)
