"""Process groups for the port's multi-rank CPU tests.

``run_ranks(tmp_path, world, body)`` starts ``world`` Python processes
(one thread each), each joining one gloo group that rendezvouses through a
``FileStore`` under ``tmp_path`` (no port is fixed: xdist workers run side
by side), and runs ``body`` with ``rank``, ``world``, ``out`` (a directory
for results) and ``torch``/``dist`` in scope (``join=False``: the body joins the group
itself, from ``RANK``/``WORLD_SIZE`` and the store file ``STORE``).  Ranks import torch and the
port only: the reference's side of a comparison runs in the test's own
process, on what the ranks wrote under ``out``.  A rank that fails to
join, raises or runs out of ``timeout`` fails the test.
"""
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PRELUDE = """
import faulthandler, os, sys
faulthandler.dump_traceback_later({dump_s}, exit=True)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
out = os.environ["OUT"]
if {join}:
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.environ["STORE"], world),
        rank=rank, world_size=world)
try:
{body}
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def run_ranks(tmp_path, world, body, timeout=90, join=True):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    script = tmp_path / "rank.py"
    script.write_text(_PRELUDE.format(
        dump_s=max(timeout - 10, 5), join=join,
        body=textwrap.indent(textwrap.dedent(body), "    ")))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1", WORLD_SIZE=str(world), OUT=str(out),
               STORE=str(tmp_path / "store"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{se[-4000:]}"
    return out, [so for so, _ in outs]
