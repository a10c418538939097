"""Elastic supervisor: heartbeat-watched training with restart-from-latest.

The reference's ``launch/elastic.py`` for the port's trainer:

  * spawns ``repro_torch.launch.train`` as a subprocess with a heartbeat
    file,
  * declares the worker dead on (a) process exit with non-zero status or
    (b) heartbeat stall > ``--stall-s`` (a hung worker),
  * restarts it with ``--resume``, from the latest complete checkpoint.

Fault injection for the demo/tests: ``--kill-at-step`` is forwarded to the
child, which hard-exits mid-run; the supervisor restarts it (without the
flag) and training completes.

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch starcoder2-3b \\
        --steps 60 --kill-at-step 25 --ckpt /tmp/eckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def run_supervised(train_args: list, heartbeat_path: str, stall_s: float,
                   max_restarts: int = 3) -> int:
    """Run the trainer with ``train_args`` until it exits 0 (returns 0) or
    has died more than ``max_restarts`` times (returns 1)."""
    env = dict(os.environ)
    restarts = 0
    while True:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train"] + train_args
            + ["--heartbeat", heartbeat_path, "--resume"],
            env=env)
        dead_reason = None
        while proc.poll() is None:
            time.sleep(0.5)
            try:
                with open(heartbeat_path) as f:
                    hb = json.load(f)
                if time.time() - hb["time"] > stall_s:
                    dead_reason = f"heartbeat stall > {stall_s}s"
                    proc.kill()
                    break
            except (FileNotFoundError, json.JSONDecodeError):
                pass
        proc.wait()
        if proc.returncode == 0 and dead_reason is None:
            print(f"[elastic] worker finished cleanly "
                  f"(restarts: {restarts})")
            return 0
        dead_reason = dead_reason or f"exit code {proc.returncode}"
        restarts += 1
        if restarts > max_restarts:
            print(f"[elastic] giving up after {max_restarts} restarts")
            return 1
        print(f"[elastic] worker died ({dead_reason}); "
              f"restart {restarts}/{max_restarts} from latest checkpoint",
              flush=True)
        # subsequent attempts must not re-inject the fault
        train_args = [a for i, a in enumerate(train_args)
                      if not (a == "--kill-at-step"
                              or (i > 0 and train_args[i - 1] == "--kill-at-step"))]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--kill-at-step", type=int, default=0)
    ap.add_argument("--stall-s", type=float, default=60.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="eda-elastic-")
    hb = os.path.join(ckpt, "heartbeat.json")
    train_args = ["--arch", args.arch, "--reduced",
                  "--steps", str(args.steps), "--batch", str(args.batch),
                  "--seq", str(args.seq), "--ckpt", ckpt,
                  "--ckpt-every", str(args.ckpt_every)]
    if args.device:
        train_args += ["--device", args.device]
    if args.kill_at_step:
        train_args += ["--kill-at-step", str(args.kill_at_step)]
    raise SystemExit(run_supervised(train_args, hb, args.stall_s,
                                    args.max_restarts))


if __name__ == "__main__":
    main()
