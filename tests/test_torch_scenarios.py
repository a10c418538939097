"""The port's scenario library runs clean (CPU).

Every library scenario, capped at 120 ticks as the reference's own tier-1
test caps it (``tests/test_simulate.py``), runs through the port's runner
on the CPU with zero invariant violations: ledger conservation, capacity,
placement, outer priority, gate travel across rebinds, KV blocks, event
idempotency, tier conservation and migration, and no first-use build
after warmup.  ``soak_churn`` (2000 ticks) and ``city_scale`` (10k+
streams) stay out, as they do in the reference's tier 1.
"""
import pytest
import torch

from repro_torch.simulate import SCENARIOS, get_scenario, run_scenario

NAMES = [n for n in sorted(SCENARIOS) if n not in ("soak_churn",
                                                   "city_scale")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_scenario_invariants_hold(name):
    s = get_scenario(name)
    if s.ticks > 120:
        s = get_scenario(name, ticks=120)
    res = run_scenario(s, device="cpu")
    assert res.violations == [], res.trace.tail(5) + "\n" + "\n".join(
        map(str, res.violations))
    assert res.summary["off"] > 0
    assert res.summary["adm"] > 0
    res.ledger.check()
    if s.token_replicas:
        assert res.summary["tok_done"] == res.summary["tok_submitted"]
    if s.events is not None:
        assert res.summary["evt_spool_depth"] == 0
        assert (res.summary["evt_accepted"] == res.summary["evt_emitted"]
                - res.summary["evt_overflow"])
