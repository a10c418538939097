"""Finding a cell's parts by name.

``BENCHMARK.json`` pairs a configuration with a traffic mix.  Everything
else is found by name: the configuration's file (``configs``' ``file``), the
mix (``traffic/<mix>.json``), its driver (``drivers/<driver>.py``, named by
the mix), the limits (``limits/<cell>.json``), each per-layer metric's reader
(``metrics/<metric>.py``) and the reference (``reference/<name>.py``, named
by the configuration).  A per-layer metric lists the cells it is read in
(``workloads``).  A later cell, mix, configuration or metric is added as new
files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench.harness.env import BENCH_DIR, ROOT


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's spec: its entry, configuration, mix, limits and the
    metrics it reports (end-to-end with ``--trace 0``, per-layer with
    ``--trace 1``)."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"BENCHMARK.json has {sorted(cells)}")
    wl = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[wl["config"]]
    config = load_json(root / entry["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(root / "portbench" / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    per_layer = [m for m in bench["per_layer"]
                 if workload in m["workloads"]]
    return {"workload": wl, "config": config, "mix": mix, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"],
            "bench_dir": root / "portbench"}


def driver(name: str):
    """``drivers/<name>.py``: ``run(session, config, mix, limits)``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def reference(name: str):
    """``reference/<name>.py``, the plain reference a configuration names."""
    return importlib.import_module(f"portbench.reference.{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR
                  ) -> Optional[Callable[[dict], Optional[float]]]:
    """The ``read(record)`` of ``metrics/<name>.py`` (a metric's name may
    hold dots, so the file is loaded by path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], record: dict,
                 bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """Each per-layer metric that its reader finds something for."""
    out = {}
    for m in metrics:
        read = metric_reader(m["name"], bench_dir)
        value = read(record) if read is not None else None
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
