"""The port's checkpoints and train launchers (CPU).

The four checkpoint tests of ``tests/test_train.py`` on the port; the
on-disk format shared with the reference both ways (a bf16 leaf, an int
leaf and a nested list, equal bit for bit); the train launcher killed by
``--kill-at-step`` (exit 42) and resumed to its last step;
``launch.elastic.run_supervised`` restarting the port's trainer once; the
launcher's ``main`` in process (its summary, a resume from its last
checkpoint bit for bit); and ``--set`` of a mesh field refused.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jcheckpoint
from repro_torch.launch import train as launch_train
from repro_torch.launch.elastic import run_supervised
from repro_torch.train import checkpoint

from torch_train_common import flat

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite runs six workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones((4,), dtype=torch.bfloat16)},
            "step": torch.tensor(3, dtype=torch.int32)}


def _assert_equal(a, b):
    for (pa, x), (pb, y) in zip(flat(a), flat(b)):
        assert pa == pb and x.dtype == y.dtype, (pa, pb, x.dtype, y.dtype)
        assert torch.equal(x, y), pa


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, _tree(), keep=2)
    assert checkpoint.all_steps(d) == [4, 5]
    restored, step = checkpoint.restore(d, _tree(), device="cpu")
    assert step == 5
    _assert_equal(restored, _tree())


def test_checkpoint_async_save(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    t = checkpoint.save(d, 1, tree, blocking=False)
    # the snapshot was taken before save returned: in-place writes after
    # it do not reach the file
    tree["params"]["w"].add_(100.0)
    t.join(timeout=30)
    assert not t.is_alive()
    assert checkpoint.latest_step(d) == 1
    restored, _ = checkpoint.restore(d, _tree(), device="cpu")
    _assert_equal(restored, _tree())


def test_checkpoint_crash_consistency(tmp_path):
    """A stale tmp dir (simulated crash) is never visible as a checkpoint."""
    d = str(tmp_path)
    checkpoint.save(d, 1, _tree())
    os.makedirs(os.path.join(d, ".tmp-step_00000002-999"))
    assert checkpoint.all_steps(d) == [1]
    _, step = checkpoint.restore(d, _tree(), device="cpu")
    assert step == 1


def test_restore_casts_dtype(tmp_path):
    d = str(tmp_path)
    checkpoint.save(d, 1, {"w": torch.ones((3,), dtype=torch.bfloat16)})
    like = {"w": torch.empty((3,), dtype=torch.float32, device="meta")}
    restored, _ = checkpoint.restore(d, like, device="cpu")
    assert restored["w"].dtype == torch.float32
    assert torch.equal(restored["w"], torch.ones(3))


def _shared_tree(rng):
    """numpy leaves: bf16, fp32, int32, and a nested list."""
    return {"emb": rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16),
            "layers": [{"w": rng.standard_normal((3, 2)).astype(np.float32)},
                       [rng.standard_normal((2,)).astype(np.float32),
                        rng.integers(-9, 9, (4,)).astype(np.int32)]],
            "step": np.asarray(7, np.int32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def test_checkpoints_cross_between_reference_and_port(tmp_path):
    tree = _shared_tree(np.random.default_rng(0))
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = _to_torch(tree)
    # the reference writes, the port reads
    jcheckpoint.save(str(tmp_path / "ref"), 3, jtree)
    got, step = checkpoint.restore(str(tmp_path / "ref"), ttree, device="cpu")
    assert step == 3
    _assert_equal(got, ttree)
    # the port writes, the reference reads
    checkpoint.save(str(tmp_path / "port"), 4, ttree)
    back, step = jcheckpoint.restore(str(tmp_path / "port"), jtree)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the same file names and manifest entries
    import json
    man = [json.load(open(os.path.join(str(tmp_path / side),
                                       f"step_0000000{s}", "manifest.json")))
           for side, s in (("ref", 3), ("port", 4))]
    assert man[0]["leaves"] == man[1]["leaves"]
    assert sorted(os.listdir(str(tmp_path / "ref" / "step_00000003"))) == \
        sorted(os.listdir(str(tmp_path / "port" / "step_00000004")))


def _train(*args, env):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "12", "--batch", "4", "--seq", "16",
         "--ckpt-every", "2", "--log-every", "4", *args],
        env=env, capture_output=True, text=True, timeout=120)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"      # the suite runs six workers at once
    return env


def test_train_launcher_kill_and_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    first = _train("--ckpt", d, "--kill-at-step", "5", env=_env())
    assert first.returncode == 42, first.stderr[-2000:]
    assert "dying at step 5" in first.stdout
    assert max(checkpoint.all_steps(d), default=0) <= 4
    second = _train("--ckpt", d, "--resume", env=_env())
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed step" in second.stdout
    assert checkpoint.latest_step(d) == 12
    assert "done: 12 steps" in second.stdout


def test_run_supervised_restarts_the_port_trainer(tmp_path, capfd,
                                                  monkeypatch):
    d = str(tmp_path / "ckpt")
    for key in ("PYTHONPATH", "OMP_NUM_THREADS"):
        monkeypatch.setenv(key, _env()[key])
    args = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
            "--steps", "10", "--batch", "4", "--seq", "16", "--ckpt", d,
            "--ckpt-every", "3", "--kill-at-step", "7"]
    rc = run_supervised(args, os.path.join(d, "heartbeat.json"),
                        stall_s=60.0, max_restarts=2)
    out = capfd.readouterr().out
    assert rc == 0, out[-2000:]
    assert "restarts: 1" in out and "dying at step 7" in out
    assert checkpoint.latest_step(d) == 10


def test_train_launcher_main_summary_and_resume(tmp_path):
    d = str(tmp_path / "ckpt")
    args = ["--arch", "starcoder2-3b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt", d, "--ckpt-every", "4",
            "--set", "remat=full", "--log-every", "100"]
    first = launch_train.main(args + ["--steps", "8"])
    assert first["start_step"] == 0
    assert len(first["losses"]) == len(first["grad_norms"]) == 8
    assert len(first["step_s"]) == 8 and min(first["step_s"]) > 0
    assert [c["step"] for c in first["ckpt"]] == [4, 8]
    assert all(c["snapshot_s"] >= 0 and c["write_s"] > 0
               for c in first["ckpt"])
    saved, step = checkpoint.restore(d, {"params": first["params"]},
                                     device="cpu")
    assert step == 8
    _assert_equal(saved["params"], first["params"])
    second = launch_train.main(args + ["--steps", "10", "--resume"])
    assert second["start_step"] == 8 and len(second["losses"]) == 2
    assert [c["step"] for c in second["ckpt"]] == [10]
    assert checkpoint.all_steps(d) == [4, 8, 10]
    assert all(np.isfinite(second["losses"]))


@pytest.mark.parametrize("override", ["fsdp=true", "sp=true",
                                      "compress_grads=true", "remat_x=full"])
def test_train_launcher_refuses_mesh_overrides(override, capsys):
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--reduced", "--device", "cpu", "--steps", "1",
                           "--set", override])
    assert e.value.code == 2
    err = capsys.readouterr().err
    name = override.split("=")[0]
    assert f"--set {name}" in err
    assert ("ROADMAP item 7" in err) == (name != "remat_x")
