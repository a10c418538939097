"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA cards.

Run one cell of ``BENCHMARK.json`` from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that defines a cell is data or a file found by its name:

- ``configs/<config>.json``: the configuration as it is run (sizes, the
  source, the keys ``reduced`` and the sizes ``assumed``);
- ``traffic/<mix>.json``: the traffic mix, read by ``traffic/generator.py``,
  and the driver (``drivers/<driver>.py``) that serves it;
- ``limits/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/<reference>.py``: the plain PyTorch reference a configuration
  names;
- ``counts/``: the frozen operation and byte counts.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; ``reference/`` imports nothing of ``repro_torch`` either.
"""
