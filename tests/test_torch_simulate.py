"""Port parity: the fleet scenario runner vs the reference's (CPU).

The port's ``repro_torch.simulate`` drives the port's gateway, engines,
gates, scheduler and energy model through the reference's scenario
library on virtual clocks; a run's canonical trace digest must equal the
reference's bit for bit.

  * ``golden_churn`` equals the committed ``tests/golden/
    fleet_scenario_v1.json``: digest, event count, trace counts, summary.
  * ``pallas_ingest`` (the kernel ingest path, plain versions here) and
    ``mixed_serving`` (vision + token replicas) equal the digests the
    reference computes now; their gate decisions, deadline trims and
    virtual-clock costs read no model output, so the port's own weights
    give the reference's digest.
  * The two digests ``chip_smoke.py`` pins for the card equal those
    reference digests, so the card's pins cannot drift from the reference.
  * ``token_failover`` reads the models' flags (its event plane emits
    hazard and distraction events), so it is run with the reference's
    weights carried across (``repro_torch.convert``).
  * Same seed, same digest; another seed, another digest.

The reference's runs are made once, in a module-scoped fixture.
"""
import ast
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import simulate as J
from repro_torch import convert
from repro_torch.simulate import get_scenario, run_scenario

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "fleet_scenario_v1.json"
CHIP_PINS = {"pallas_ingest": "PALLAS_INGEST_DIGEST",
             "mixed_serving": "MIXED_SERVING_DIGEST"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_run(name: str, **overrides):
    """Run the reference's scenario; returns (result, runner) — the runner
    holds the reference's engines and so their weights."""
    runner = J.ScenarioRunner(J.get_scenario(name, **overrides))
    return runner.run(), runner


def ref_weights(runner):
    """The reference runner's weights as the port's injectables:
    ``vision_params(i)`` for vision replica i (its tier's configs) and
    the shared token model's parameters (or None)."""
    vision = [(convert.detector_from_jax(jax.tree.map(np.asarray, e.dp),
                                         device="cpu"),
               convert.pose_from_jax(jax.tree.map(np.asarray, e.pp),
                                     device="cpu"))
              for e in runner.gw.replicas]
    token = None
    if runner.gw.token_replicas:
        e = runner.gw.token_replicas[0]
        token = convert.transformer_from_jax(
            jax.tree.map(np.asarray, e.params), e.cfg, device="cpu")
    return vision.__getitem__, token


def port_run(name: str, weights_of=None, **overrides):
    """The port's run of the named scenario on the CPU, with the
    reference runner's weights when ``weights_of`` is given."""
    kw = {}
    if weights_of is not None:
        kw["vision_params"], kw["token_params"] = ref_weights(weights_of)
    return run_scenario(get_scenario(name, **overrides), device="cpu", **kw)


@pytest.fixture(scope="module")
def reference():
    """name -> (result, runner) of the reference's runs, made once in the
    fixture's set-up (outside the tests' time budget)."""
    runs = {name: ref_run(name) for name in
            ("pallas_ingest", "mixed_serving", "token_failover")}
    return runs.__getitem__


def _chip_pins() -> dict:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    consts = {t.id: node.value.value for node in tree.body
              if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)
              and isinstance(node.value, ast.Constant)}
    return {name: consts[var] for name, var in CHIP_PINS.items()}


def test_golden_churn_equals_the_committed_golden():
    golden = json.loads(GOLDEN.read_text())
    s = get_scenario(golden["scenario"])
    assert (s.seed, s.ticks) == (golden["seed"], golden["ticks"])
    res = run_scenario(s, device="cpu")
    assert res.violations == [], "\n".join(map(str, res.violations))
    assert {k: res.summary[k] for k in golden["summary"]} == golden["summary"]
    assert res.trace.counts() == golden["counts"]
    assert len(res.trace) == golden["events"]
    assert res.digest == golden["digest"]


@pytest.mark.parametrize("name", ["pallas_ingest", "mixed_serving"])
def test_digest_equals_the_reference(name, reference):
    want, _ = reference(name)
    got = port_run(name)
    assert got.violations == [] and want.violations == []
    assert got.trace.canonical() == want.trace.canonical()
    assert got.digest == want.digest
    assert got.summary == want.summary
    if name == "mixed_serving":
        assert got.summary["tok_done"] == got.summary["tok_submitted"] > 0
        assert got.summary["tok_truncated"] > 0     # the ESD path is live


def test_chip_smoke_pins_equal_the_reference(reference):
    pins = _chip_pins()
    for name, digest in pins.items():
        assert digest == reference(name)[0].digest, name


def test_token_failover_with_the_reference_weights(reference):
    want, runner = reference("token_failover")
    got = port_run("token_failover", weights_of=runner)
    assert got.violations == []
    assert got.trace.canonical() == want.trace.canonical()
    assert got.digest == want.digest
    assert got.summary == want.summary
    assert got.summary["tok_done"] == got.summary["tok_submitted"]
    assert got.summary["evt_accepted"] == got.summary["evt_emitted"] > 0
    assert got.trace.counts()["req_rebind"] > 0


def test_same_seed_same_digest_other_seed_other_digest():
    base = get_scenario("golden_churn", ticks=60)
    a = run_scenario(base, device="cpu")
    b = run_scenario(base, device="cpu")
    assert a.digest == b.digest
    assert a.trace.canonical() == b.trace.canonical()
    c = run_scenario(get_scenario("golden_churn", ticks=60, seed=999),
                     device="cpu")
    assert c.digest != a.digest


def test_port_scenarios_are_the_reference_library():
    """Every scenario keeps its reference name and every number; the only
    renamed field is the kernel flag (``use_pallas`` -> ``use_kernels``),
    and only ``pallas_ingest``'s description says so."""
    import dataclasses

    from repro_torch.simulate import SCENARIOS
    assert sorted(SCENARIOS) == sorted(J.SCENARIOS)
    for name, s in SCENARIOS.items():
        mine = repr(dataclasses.replace(s, description=""))
        want = repr(dataclasses.replace(J.SCENARIOS[name], description=""))
        assert mine.replace("use_kernels", "use_pallas") == want, name
        assert s.use_kernels == J.SCENARIOS[name].use_pallas
