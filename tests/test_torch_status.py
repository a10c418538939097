"""The port's fleet status surface and the city-scale region, fused.

  * ``FleetStatus.from_gateway(...).to_dict()`` equals the reference's,
    snapshot mid-scenario through the fused tick on a flat fleet, a
    tiered fleet and a shrunk region (one replica failed).  ``jit_cache``
    is left out: the port counts its own first-use builds, not JAX's jit
    caches.  ``render()`` runs on each.
  * The ``fleet_fused_dispatches`` gauge and the ``fused_dispatch`` spans
    count the fused calls, and attaching them leaves the golden digest.
  * The shrunk ``city_scale`` of ``tests/test_cells.py``: serial = fused =
    the reference's digest; the full ``city_scale`` likewise (slow).

All on the CPU, one torch thread; the reference's runs sit in a module
fixture, outside the tests' time budget.
"""
import json
import pathlib

import pytest
import torch

from repro import simulate as J
from repro.obs import FleetStatus as JFleetStatus
from repro_torch.obs import FleetStatus, MetricsRegistry, SpanTracer
from repro_torch.simulate import (ScenarioRunner, ScriptedEvent,
                                  city_replicas, get_scenario, run_scenario)

GOLDEN = (pathlib.Path(__file__).resolve().parent / "golden"
          / "fleet_scenario_v1.json")
# (scenario, overrides, tick of the snapshot): a flat fleet, a tiered
# fleet with the director active, a region with one replica failed
SNAPSHOTS = {
    "flat": ("steady_state", dict(ticks=60), 40),
    "tiered": ("traffic_spike", dict(ticks=140), 120),
    "region": ("city_scale", None, 6),
}
# The reference's full city_scale digest, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.simulate import
#   get_scenario, run_scenario; print(run_scenario(get_scenario(
#   'city_scale')).digest)"
CITY_SCALE_DIGEST = ("1d8db5869fd7e6bfae1be965274854c0"
                     "bc4365b3cae9a084180246a05552c75b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shrunk_city(get, **over):
    """``tests/test_cells.py``'s tier-1 city: 4 cells x 2 replicas of 4
    slots, 40-60 vehicles, 12 ticks, a replica failed at 3, restored
    at 9."""
    return get(
        "city_scale",
        replicas=city_replicas(cells=4, per_cell=2, slots=4),
        initial_vehicles=40, max_vehicles=60, ticks=12,
        scripted=(ScriptedEvent(3, "fail_replica", "c0r0"),
                  ScriptedEvent(9, "restore_replica", "c0r0")),
        **over)


def _scenario(get, case):
    name, over, _ = SNAPSHOTS[case]
    return _shrunk_city(get) if over is None else get(name, **over)


def _snapshot(runner_cls, status_cls, scenario, at, **kw):
    snaps = []

    def on_tick(tick, runner):
        if tick == at:
            snaps.append(status_cls.from_gateway(runner.gw))
    runner_cls(scenario, parallel=True, **kw).run(on_tick=on_tick)
    assert len(snaps) == 1
    return snaps[0]


@pytest.fixture(scope="module")
def reference():
    """The reference's fused-tick status snapshots and the shrunk city's
    digest, made once."""
    snaps = {case: _snapshot(J.ScenarioRunner, JFleetStatus,
                             _scenario(J.get_scenario, case),
                             SNAPSHOTS[case][2])
             for case in SNAPSHOTS}
    city = J.run_scenario(_shrunk_city(J.get_scenario)).digest
    return {"snaps": snaps, "city": city}


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_status_equals_the_reference_mid_scenario(case, reference):
    fs = _snapshot(ScenarioRunner, FleetStatus,
                   _scenario(get_scenario, case), SNAPSHOTS[case][2],
                   device="cpu")
    want = reference["snaps"][case].to_dict()
    got = fs.to_dict()
    json.dumps(got)
    for d in (got, want):
        d.pop("jit_cache")
    assert got == want
    assert got["fused_dispatches"] > 0 and got["sessions"] > 0
    if case == "tiered":
        assert got["tiers"] and got["last_scale"] is not None
    if case == "region":
        assert got["cells"] and got["total_replicas"] == 8
        assert any(r["dead"] for r in got["replicas"])
    text = fs.render()
    assert "fleet:" in text and "fused dispatches" in text
    for r in fs.replicas:
        assert r.name in text


def test_fused_dispatch_gauge_and_spans_keep_the_golden_digest():
    golden = json.loads(GOLDEN.read_text())["digest"]
    metrics, tracer = MetricsRegistry(), SpanTracer()
    runner = ScenarioRunner(get_scenario("golden_churn"), parallel=True,
                            metrics=metrics, tracer=tracer, device="cpu")
    res = runner.run()
    assert res.violations == [] and res.digest == golden
    n = runner.gw._fleet.dispatches
    assert n > 0
    assert metrics.get("fleet_fused_dispatches").value == n
    assert "fleet_fused_dispatches" in metrics.expose()
    spans = tracer.spans("fused_dispatch")
    assert len(spans) == n
    assert [s["args"]["dispatch"] for s in spans] == list(range(1, n + 1))
    assert FleetStatus.from_gateway(runner.gw).fused_dispatches == n


def test_shrunk_city_serial_equals_fused_equals_the_reference(reference):
    s = _shrunk_city(get_scenario)
    serial = run_scenario(s, device="cpu")
    fused = run_scenario(s, device="cpu", parallel=True)
    assert serial.violations == [] and fused.violations == []
    assert serial.summary["rebinds"] > 0
    assert serial.trace.of_kind("handoff")
    assert serial.digest == fused.digest == reference["city"]
    assert serial.summary == fused.summary


@pytest.mark.slow
def test_full_city_scale_serial_equals_fused_equals_the_reference():
    s = get_scenario("city_scale")
    serial = run_scenario(s, device="cpu")
    fused = run_scenario(s, device="cpu", parallel=True)
    assert serial.violations == [] and fused.violations == []
    assert serial.digest == fused.digest == CITY_SCALE_DIGEST
