"""Deterministic fleet-scenario simulation over the port's serving stack.

  scenario    declarative DSL (replicas via HardwareInfo, vehicle
              profiles, churn rates, scripted failures) + the built-in
              scenario library (``SCENARIOS``, the reference's, number
              for number)
  runner      interprets a scenario against the production FleetGateway /
              VisionServeEngine / CapacityScheduler / EnergyModel stack
              on per-replica virtual clocks — no mocks — on the card
              (``device=None``) or the CPU (``device="cpu"``)
  trace       canonical event trace; SHA-256 digest is the run's seed-
              deterministic fingerprint, held against the reference's
  invariants  global checkers: ledger conservation, capacity bounds,
              placement consistency, outer-priority preemption bound,
              gate-state travel across rebinds, zero post-warmup builds

Reproduce a run from its seed:

    PYTHONPATH=src python -c "from repro_torch.simulate import *; \\
        r = run_scenario(get_scenario('golden_churn'), device='cpu'); \\
        print(r.digest, r.summary)"
"""
from repro_torch.simulate.invariants import (InvariantSuite,  # noqa: F401
                                             Violation, jit_cache_sizes)
from repro_torch.simulate.runner import (ScenarioResult,  # noqa: F401
                                         ScenarioRunner, build_fleet,
                                         build_token_replicas, run_scenario,
                                         warm_kernels)
from repro_torch.simulate.scenario import (SCENARIOS,  # noqa: F401
                                           CellPlanSpec, ReplicaSpec,
                                           Scenario, ScriptedEvent,
                                           TokenReplicaSpec, TokenWorkload,
                                           VehicleProfile, city_replicas,
                                           get_scenario, list_scenarios)
from repro_torch.simulate.trace import Event, Trace  # noqa: F401
