"""The harness's control flow on the CPU, at the tiny sizes of
``harness/tiny.py``: each driver's last line has the contract's shape, a
machine without a card and a directory without the program get no result,
and no JAX module is loaded."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import tiny

ROOT = Path(__file__).resolve().parents[1]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _shape(line, names):
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


@pytest.mark.parametrize("workload,e2e", [
    ("serve_sc2_3b_batch", "tokens_per_s"),
    ("train_sc2_3b", "train_tokens_per_s"),
])
def test_dry_run_line_and_correct(workload, e2e):
    line = tiny.run(torch, workload)
    _shape(line, [e2e, "setup_s"])
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


def test_traced_run_reports_the_cells_per_layer_metrics_it_can_read():
    line = tiny.run(torch, "serve_sc2_3b_batch", trace=True)
    # on the CPU no device trace exists: only the host readers find
    # something, and no device metric is written
    assert set(line["metrics"]) == {"serve.decode_tick_ms",
                                    "serve.prefill_ms_per_token", "mfu.serve"}
    assert "busy_s" not in line["device"]


def _cli(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "train_sc2_3b", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _cli(ROOT, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_directory_without_the_program_gets_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_jax_module_and_a_reference_without_the_program():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "import portbench.reference.dense_lm\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n"
        "from portbench.harness import tiny\n"
        "for w in ('serve_sc2_3b_batch', 'train_sc2_3b'):\n"
        "    assert tiny.run(torch, w, seconds=0.2) is not None\n"
        "from portbench.harness.env import forbidden_modules\n"
        "assert not forbidden_modules(), forbidden_modules()\n"
        "assert 'repro_torch' in sys.modules\n"
        "print('ok')\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("ok")
