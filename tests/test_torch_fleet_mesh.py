"""The fused fleet tick's ``fleet_mode="shard_map"``: the reference's
single-controller replica mesh on the port (``streams/fleet_step.py``).

On the CPU the mesh is the CPU repeated, one entry per replica (the part
the reference's forced host devices play); each replica is its own group
of one and runs the single-replica program, so the digests are the serial
tick's bit for bit: the committed ``golden_churn`` golden, and
``pallas_ingest`` and ``mixed_serving`` equal to the port's serial runs
and to the reference's ``vmap`` digests (computed once, in a module
fixture outside the tests' time budget), and the 1/2/8-replica sweep.  A
mixed-tier fleet refuses ``shard_map``, as the reference's does.
"""
import json
import pathlib

import pytest
import torch

from repro import simulate as J
from repro_torch.simulate import ScenarioRunner, get_scenario, run_scenario
from repro_torch.streams import resolve_mode

from test_torch_fleet_step import (_mixed_tier_scenario, _sweep_scenario,
                                   assert_bit_identical)

GOLDEN = (pathlib.Path(__file__).resolve().parent / "golden"
          / "fleet_scenario_v1.json")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``vmap`` digests (its fused tick), computed once."""
    return {name: J.run_scenario(J.get_scenario(name), parallel=True,
                                 fleet_mode="vmap").digest
            for name in ("pallas_ingest", "mixed_serving")}


def _mesh_run(s):
    return run_scenario(s, device="cpu", parallel=True,
                        fleet_mode="shard_map")


def test_shard_map_golden_churn_equals_the_committed_golden():
    golden = json.loads(GOLDEN.read_text())
    assert golden["digest"].startswith("f91449dd")
    s = get_scenario(golden["scenario"])
    res = _mesh_run(s)
    assert res.violations == []
    assert {k: res.summary[k] for k in golden["summary"]} == golden["summary"]
    assert res.trace.counts() == golden["counts"]
    assert res.digest == golden["digest"]
    assert_bit_identical(run_scenario(s, device="cpu"), res)


@pytest.mark.parametrize("name", ["pallas_ingest", "mixed_serving"])
def test_shard_map_equals_serial_and_the_reference_vmap(name, reference):
    s = get_scenario(name)
    mesh = _mesh_run(s)
    assert_bit_identical(run_scenario(s, device="cpu"), mesh)
    assert mesh.digest == reference[name]


@pytest.mark.parametrize("n_replicas", [1, 2, 8])
def test_shard_map_replica_count_sweep(n_replicas):
    s = _sweep_scenario(n_replicas)
    runner = ScenarioRunner(s, parallel=True, fleet_mode="shard_map",
                            device="cpu")
    step = runner.gw._fleet
    assert step.mode == "shard_map"
    assert step.mesh == [torch.device("cpu")] * n_replicas
    assert step._members == [[i] for i in range(n_replicas)]
    mesh = runner.run()
    assert_bit_identical(run_scenario(s, device="cpu"), mesh)
    assert step.dispatches > 0


def test_shard_map_refuses_a_mixed_tier_fleet():
    s = _mixed_tier_scenario()
    with pytest.raises(ValueError, match="cannot mix tier geometries"):
        ScenarioRunner(s, parallel=True, fleet_mode="shard_map",
                       device="cpu")
    # without a mode the fleet resolves to vmap on the CPU, as the
    # reference's does off an accelerator
    runner = ScenarioRunner(s, parallel=True, device="cpu")
    assert runner.gw._fleet.mode == "vmap"
    assert resolve_mode(8, device_type="cpu") == "vmap"
