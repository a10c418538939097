#!/usr/bin/env python3
"""Run the scenario library through the reference's runner and the port's
(CPU) and print each pair of trace digests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/torch_scenario_parity.py \
        [--ticks 120] [--only NAME ...] [--parallel]

Every scenario runs at most ``--ticks`` ticks (``golden_churn`` always its
whole 150, the pinned length), as the reference's tier-1 test caps them;
``soak_churn`` and ``city_scale`` are left out unless named.  The port is
given the reference runner's weights (``repro_torch.convert``), so the
scenarios whose traces read model outputs (the event plane's hazard and
distraction events) are held too.  ``--parallel`` runs the port's fleet
through its fused fleet tick (``FleetGateway(parallel=True)``) against the
reference's serial runner, whose serial and fused ticks give one digest
(its ``tests/test_fleet_step.py``).  Prints one line a scenario (digests,
violations, seconds on each side, the first differing trace line if any)
and exits non-zero if any pair differs.  Needs JAX: the CPU only.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _weights(runner):
    import jax
    import numpy as np

    from repro_torch import convert
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--parallel", action="store_true",
                    help="the port through its fused fleet tick")
    args = ap.parse_args()
    from repro import simulate as J
    from repro_torch import simulate as P
    names = args.only or [n for n in sorted(J.SCENARIOS)
                          if n not in ("soak_churn", "city_scale")]
    bad = 0
    for name in names:
        over = {}
        if name != "golden_churn" and J.SCENARIOS[name].ticks > args.ticks:
            over["ticks"] = args.ticks
        t0 = time.perf_counter()
        runner = J.ScenarioRunner(J.get_scenario(name, **over))
        want = runner.run()
        t1 = time.perf_counter()
        vision, token = _weights(runner)
        got = P.run_scenario(P.get_scenario(name, **over), device="cpu",
                             parallel=args.parallel,
                             vision_params=vision, token_params=token)
        t2 = time.perf_counter()
        same = got.digest == want.digest
        bad += not same
        line = (f"{name}: ticks {want.scenario.ticks} reference "
                f"{want.digest[:16]} port{' fused' * args.parallel} "
                f"{got.digest[:16]} "
                f"{'equal' if same else 'DIFFER'}; violations "
                f"{len(want.violations)}/{len(got.violations)}; "
                f"{t1 - t0:.1f} s / {t2 - t1:.1f} s")
        if not same:
            for a, b in zip(want.trace.canonical().splitlines(),
                            got.trace.canonical().splitlines()):
                if a != b:
                    line += f"\n  first difference:\n  ref  {a}\n  port {b}"
                    break
        print(line, flush=True)
    print(f"{len(names) - bad} of {len(names)} digests equal", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
