"""Training launcher, on one device or over the ranks of a process group.

The port's mirror of the reference's ``launch/train.py``: the same flags
plus ``--device`` (the card unless ``cpu`` is asked) and
``--init-method`` (the process group's rendezvous, ``env://`` as
``torchrun`` sets it).  With a world of one (no ``torchrun``, or one rank)
and ``--mesh host --model-parallel 1`` the launcher keeps plain tensors on
its one device.  Otherwise every rank joins one process group (gloo with
``--device cpu``, NCCL on the cards, rank r on card ``LOCAL_RANK``) and
the parameters, Adam moments and batches are DTensors placed by
``repro_torch.sharding.rules`` on the mesh: ``--mesh host`` a (world /
model-parallel, model-parallel) ``("data", "model")`` mesh, ``--mesh
single``/``multi`` the production meshes, which need a world of 256 or 512
ranks and exit naming it otherwise.  A rank that fails to join fails the
run.  Checkpoints gather each leaf whole (rank 0 writes), and
``--resume`` restores them onto this run's mesh, whatever mesh wrote them.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --reduced --model-parallel 2 --steps 4

Fault tolerance: periodic checkpoints (restart-safe via atomic
rename, written on a thread after a host snapshot; one in flight at a
time, and the last step is not written twice: the reference's launcher
starts an async save of its last step and a blocking one beside it, the
two racing on one staging directory), ``--resume`` restores
the latest complete step (the Adam moments restart, as in the reference),
and a heartbeat file lets ``repro_torch.launch.elastic`` supervise and
restart the process.  ``--set key=value`` sets a ``ParallelConfig``
field (``launch.presets.apply_overrides``);
``remat`` stays the reference's default ``none`` unless ``--set
remat=full`` trades a recompute of each layer's forward for its
activations' memory.  ``main`` returns what a caller on the same process
reads back: the final parameters, the loss and gradient norm of every
step, each step's wall seconds (the loss is read every step, which waits
for the card), and each checkpoint's host-snapshot and write seconds.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \\
        --reduced --steps 100 --batch 8 --seq 64 --ckpt /tmp/ckpt --resume \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import torch

from repro_torch.config import ParallelConfig, get_arch
from repro_torch.data import device_prefetch, lm_batches
from repro_torch.device import resolve_device
from repro_torch.launch.presets import apply_overrides
from repro_torch.models import transformer as T
from repro_torch.models.param import tree_map
from repro_torch.train import (AdamWConfig, checkpoint, init_opt_state,
                               make_train_step)


def heartbeat(path: str, step: int) -> None:
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump({"step": step, "time": time.time()}, f)
    os.replace(path + ".tmp", path)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--kill-at-step", type=int, default=0,
                    help="fault-injection: hard-exit at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--init-method", default="env://",
                    help="process-group rendezvous (torchrun sets env://)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = None
    if world > 1 or args.mesh != "host" or args.model_parallel > 1:
        dev, mesh = _join(args, dev, world)
    data_axes = (tuple(a for a in mesh.mesh_dim_names if a != "model")
                 if mesh is not None else ("data",))
    try:
        par = apply_overrides(
            ParallelConfig(data_axes=data_axes, grad_accum=args.grad_accum),
            dict(s.split("=", 1) for s in args.set))
    except ValueError as e:
        ap.error(str(e))
    try:
        return _run(args, cfg, par, dev, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _join(args, dev, world: int):
    """Join the process group and build the run's mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                         production_shape)
    need = {"single": 256, "multi": 512}.get(args.mesh)
    if need is not None and world != need:
        raise SystemExit(f"--mesh {args.mesh} needs a world of {need} ranks "
                         f"(production_shape {production_shape(args.mesh == 'multi')}"
                         f"); this one has {world}")
    if args.mesh == "host" and world % args.model_parallel:
        raise SystemExit(f"--model-parallel {args.model_parallel} does not "
                         f"divide the world of {world} ranks")
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=args.init_method, rank=rank,
                            world_size=world)
    if args.mesh == "host":
        return dev, make_host_mesh(model=args.model_parallel)
    return dev, make_production_mesh(multi_pod=args.mesh == "multi")


def _run(args, cfg, par, dev, mesh) -> dict:
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                          total_steps=args.steps,
                          state_dtype=par.opt_state_dtype)
    rank0 = mesh is None or torch.distributed.get_rank() == 0

    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    pspecs = None
    if mesh is not None:
        from repro_torch.sharding import rules
        pspecs = rules.param_pspecs(cfg, par, mesh)
        params = rules.distribute(params, mesh, pspecs)
    start_step = 0
    if args.resume and args.ckpt and checkpoint.latest_step(args.ckpt) is not None:
        # elastic restore: the saved leaves go onto THIS run's mesh
        shardings = None
        if mesh is not None:
            shardings = {"params": rules.shardings(mesh, pspecs)}
        restored, start_step = checkpoint.restore(
            args.ckpt, {"params": params}, device=dev, shardings=shardings)
        params = restored["params"]
        print(f"[train] resumed step {start_step} from {args.ckpt}")
    params = tree_map(lambda p: p.requires_grad_(), params)
    opt_state = init_opt_state(params, par.opt_state_dtype)  # moments restart

    step_fn = make_train_step(cfg, par, opt_cfg, mesh=mesh)
    batches = lm_batches(args.batch, args.seq, cfg.vocab_size,
                         seed=start_step, steps=args.steps - start_step)
    if mesh is not None:
        from repro_torch.config import ShapeConfig
        bspecs = rules.batch_pspecs(
            cfg, ShapeConfig("cli", args.seq, args.batch, "train"), par, mesh)
        place = lambda b: rules.distribute(b, mesh, bspecs)
    else:
        place = lambda b: b
    out = {"start_step": start_step, "losses": [], "grad_norms": [],
           "step_s": [], "ckpt": []}
    t0 = time.time()
    t_step = time.perf_counter()
    tokens_done = 0
    pending = None                    # the async checkpoint in flight

    def save(step):
        t = time.perf_counter()
        writer = checkpoint.save(args.ckpt, step, {"params": params}, keep=3,
                                 blocking=False)
        out["ckpt"].append({"step": step,
                            "snapshot_s": time.perf_counter() - t})
        return writer, out["ckpt"][-1]

    def join(pending):
        writer, record = pending
        writer.join()
        if not hasattr(writer, "write_s"):
            raise RuntimeError(f"the checkpoint of step {record['step']} "
                               f"was not written (see its thread's error)")
        record["write_s"] = writer.write_s

    for i, batch in enumerate(device_prefetch(batches, device=dev)):
        step = start_step + i
        if args.kill_at_step and step == args.kill_at_step:
            print(f"[train] fault injection: dying at step {step}",
                  flush=True)
            os._exit(42)
        params, opt_state, metrics = step_fn(params, opt_state, place(batch))
        tokens_done += args.batch * args.seq
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        if rank0 and (step % args.log_every == 0 or step == args.steps - 1):
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {out['losses'][-1]:.4f} "
                  f"gnorm {out['grad_norms'][-1]:.3f} "
                  f"tok/s {tokens_done / max(dt, 1e-9):,.0f}", flush=True)
        if rank0:
            heartbeat(args.heartbeat, step)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            if pending is not None:
                join(pending)
            pending = save(step + 1)
        out["step_s"].append(time.perf_counter() - t_step)
        t_step = time.perf_counter()
    if pending is not None:
        join(pending)
    # from what this run saved, not from the disk: every rank takes part
    # in a save, and only rank 0's writes reach the disk
    last = out["ckpt"][-1]["step"] if out["ckpt"] else start_step
    if args.ckpt and last != args.steps:
        join(save(args.steps))
    print(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s")
    out["params"] = params
    return out

if __name__ == "__main__":
    main()
