"""A configuration, a traffic mix, a cell and a per-layer metric are each
added as new files and entries alone: the harness finds them by name."""
import json
import shutil
from pathlib import Path

import torch

from portbench.harness import cell, tiny

ROOT = Path(__file__).resolve().parents[1]


def _copy(tmp: Path) -> dict:
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    return json.loads((tmp / "BENCHMARK.json").read_text())


def test_new_config_mix_cell_and_metric_are_found_by_name(tmp_path):
    bench = _copy(tmp_path)
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "starcoder2-3b.json").read_text())
    conf["name"] = "starcoder2-3b-short-rope"
    conf["rope_theta"] = 10000.0
    (pb / "configs" / "starcoder2-3b-short-rope.json").write_text(
        json.dumps(conf))
    mix = json.loads((pb / "traffic" / "pretrain.json").read_text())
    mix["grad_accum"] = 1
    (pb / "traffic" / "pretrain_no_accum.json").write_text(json.dumps(mix))
    (pb / "limits" / "train_short_rope.json").write_text(
        (pb / "limits" / "train_sc2_3b.json").read_text())
    (pb / "metrics" / "train.steps_per_s.py").write_text(
        "def read(record):\n"
        "    c = record['counts']\n"
        "    return c['steps'] / record['window_s']\n")
    bench["configs"].append(dict(bench["configs"][0],
                                 name="starcoder2-3b-short-rope",
                                 file="portbench/configs/"
                                      "starcoder2-3b-short-rope.json"))
    bench["workloads"].append({"name": "train_short_rope",
                               "config": "starcoder2-3b-short-rope",
                               "traffic": "pretrain_no_accum", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("train_short_rope")
    bench["per_layer"].append({
        "name": "train.steps_per_s", "unit": "1/s", "better": "higher",
        "source": "program_counter", "layer": "train step",
        "moves": "train_tokens_per_s", "workloads": ["train_short_rope"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = cell.load_cell("train_short_rope", tmp_path)
    assert spec["config"]["rope_theta"] == 10000.0
    assert spec["mix"]["grad_accum"] == 1
    assert [m["name"] for m in spec["per_layer"]] == ["train.steps_per_s"]
    assert cell.metric_reader("train.steps_per_s", pb) is not None

    line = tiny.run(torch, "train_short_rope", trace=True, root=tmp_path)
    assert line["correct"], line["checks"]
    assert line["metrics"]["train.steps_per_s"]["value"] > 0
    assert line["metrics"]["train.steps_per_s"]["unit"] == "1/s"
    line = tiny.run(torch, "train_short_rope", root=tmp_path)
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_a_cell_reads_the_per_layer_metrics_that_list_it():
    names = lambda w: {m["name"] for m in cell.load_cell(w)["per_layer"]}
    assert names("train_sc2_3b") == {"mfu.train", "device_idle.train"}
    assert "mfu.train" not in names("serve_sc2_3b_batch")
    # a reader that is missing finds nothing
    assert cell.read_metrics([{"name": "serve.anything", "unit": "ms"}],
                             {}, ROOT / "portbench") == {}


def test_every_named_part_of_the_benchmark_exists():
    bench = cell.benchmark()
    for w in bench["workloads"]:
        spec = cell.load_cell(w["name"])
        assert cell.driver(spec["mix"]["driver"]).run
        assert cell.reference(spec["config"]["reference"])
        assert spec["limits"]
    for m in bench["per_layer"]:
        assert cell.metric_reader(m["name"]) is not None, m["name"]
