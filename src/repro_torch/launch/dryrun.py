"""Multi-pod dry-run: one step of every (arch x shape x mesh) cell in a
fake world.

This is the scale proof for hardware we don't have.  A fake process group
(``torch.testing._internal.distributed.fake_pg``) of ``mesh_chips`` ranks
stands in for 256 chips (16 x 16 ``("data", "model")``) or 512 (2 x 16 x 16
``("pod", "data", "model")``), and a ``FakeTensorMode`` makes every tensor
a shape without storage.  Each cell runs one step as this process's rank
would: the train step (parameters, Adam moments and batch DTensors placed
by ``sharding.rules``), prefill, or decode, with ``use_kernels=False`` as
the presets set it.  Any sharding mismatch or op DTensor cannot place
fails the cell.  ``roofline.CountMode`` counts what the rank runs: FLOPs
and bytes of each op on its local shards, and the operand bytes of every
collective, per device as the reference's compiled cost is.  The fake
world is set up in :func:`run_cell` and torn down after it; importing this
module starts nothing (the reference sets ``XLA_FLAGS`` at import).

The reference calibrates its cost by depth (``calibrate_cost``): XLA's
cost analysis counts a scanned layer body once.  The port runs every
layer eagerly and counts each, so its count is linear in depth with
nothing to calibrate (``tests/test_torch_dryrun.py`` holds it exactly
linear).  As in the reference's calibration, the counted train step runs
one microbatch (``grad_accum=1``: accumulation splits the same FLOPs);
the memory model takes the preset's accumulation.  Three-dim meshes run
as their two-dim flattening (``rules.compute_mesh``).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k \\
        --mesh single --out experiments/dryrun
    python -m repro_torch.launch.dryrun --all --mesh both      # 68 cells
    ... --all --mesh both --jobs 8 --cell-timeout 1500         # 8 at a time
    ... --set fsdp=true --set remat=full                       # overrides
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import List, Optional

import torch

from repro_torch.config import (SHAPES, ModelConfig, ParallelConfig,
                                ShapeConfig, cell_skip_reason, get_arch)
from repro_torch.configs import ASSIGNED


def build_cell(cfg: ModelConfig, shape: ShapeConfig, par: ParallelConfig,
               mesh):
    """``(fn, args)``: the cell's step and its inputs, DTensors placed on
    ``mesh`` by the rules (fake tensors: call it under a
    ``FakeTensorMode``).  ``fn(*args)`` runs one step."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import RunOpts
    from repro_torch.sharding import rules
    from repro_torch.train import AdamWConfig, init_opt_state, make_train_step

    pspecs = rules.param_pspecs(cfg, par, mesh)
    params = rules.distribute(T.abstract_params(cfg, device="cpu"), mesh,
                              pspecs)
    bspecs = rules.batch_pspecs(cfg, shape, par, mesh)
    inputs = T.input_specs(cfg, shape, device="cpu")
    attn_specs = None
    if par.attn_batch_sharded:
        sizes = rules.mesh_sizes(mesh)
        msize = sizes[par.model_axis]
        da = tuple(par.data_axes)
        q_heads = par.model_axis if cfg.num_heads % msize == 0 else None
        kv_heads = par.model_axis if cfg.num_kv_heads % msize == 0 else None
        attn_specs = (rules.PartitionSpec(da, None, q_heads, None),
                      rules.PartitionSpec(da, None, kv_heads, None))
    opts = RunOpts(use_kernels=par.use_kernels, remat=par.remat,
                   block_kv=par.block_kv, attn_specs=attn_specs,
                   mxu_bf16=par.mxu_bf16)

    if shape.kind == "train":
        batch = rules.distribute({k: inputs[k] for k in bspecs}, mesh, bspecs)
        state = init_opt_state(params, par.opt_state_dtype)
        step = make_train_step(
            cfg, dataclasses.replace(par, grad_accum=1),
            AdamWConfig(state_dtype=par.opt_state_dtype), mesh=mesh,
            opts=opts)
        return step, (params, state, batch)

    from torch.distributed.tensor.experimental import implicit_replication
    if shape.kind == "prefill":
        batch = rules.distribute(inputs, mesh, bspecs)

        @torch.no_grad()
        def prefill(params, batch):
            extras = {k: v for k, v in batch.items() if k != "tokens"}
            with implicit_replication():
                return T.prefill(cfg, params, batch["tokens"],
                                 extras=extras or None,
                                 cache_capacity=shape.seq_len, opts=opts)
        return prefill, (params, batch)

    caches = rules.distribute(inputs["caches"], mesh, bspecs["caches"])
    tokens = rules.distribute({"t": inputs["tokens"]}, mesh,
                              {"t": bspecs["tokens"]})["t"]

    @torch.no_grad()
    def decode(params, caches, tokens, index):
        with implicit_replication():
            return T.decode_step(cfg, params, caches, tokens, index,
                                 opts=opts)
    # the write offset of the last position: a host int, as the serving
    # engine passes it
    return decode, (params, caches, tokens, shape.seq_len - 1)


def _fake_world(chips: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run's fake world needs a process with "
                           "no process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)


def _teardown() -> None:
    import torch.distributed as dist
    from repro_torch.sharding import rules
    rules.forget_compute_meshes()
    if dist.is_initialized():
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides: dict,
             outdir: Optional[str], *, reduced: bool = False,
             mesh_shape: Optional[tuple] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One cell in a fake world of the mesh's size.  ``reduced`` runs the
    arch's reduced config; ``mesh_shape`` replaces the production shape
    (same axis names), ``cfg`` the registry's config and ``shape`` the
    cell's ``SHAPES`` entry (its name kept for the skip rule: for tests).
    Writes ``<outdir>/<mesh>__<arch>__<shape>.json`` unless ``outdir`` is
    None; returns the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import mesh_chips, production_shape
    from repro_torch.launch.presets import apply_overrides, default_parallel
    from repro_torch.roofline.analysis import (CountMode, analyse_counted,
                                               collective_bytes,
                                               estimate_memory_per_device)
    from repro_torch.sharding import rules
    from repro_torch.sharding.compat import make_device_mesh

    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    multi = mesh_kind == "multi"
    dims, names = production_shape(multi)
    dims = tuple(mesh_shape or dims)
    sizes = dict(zip(names, dims))
    chips = mesh_chips(sizes)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "mesh_shape": list(dims), "chips": chips, "ok": False,
              "skip": None, "error": None}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        result.update(ok=True, skip=skip)
        return _write(result, outdir)

    par = apply_overrides(default_parallel(cfg, shape, multi_pod=multi),
                          overrides)
    result["parallel"] = {k: str(v) for k, v in vars(par).items()}
    tp = sizes["model"]
    dp = math.prod(v for k, v in sizes.items() if k != "model")
    result["memory_analytic"] = estimate_memory_per_device(
        cfg, shape, tp=tp, dp=dp, fsdp=par.fsdp, grad_accum=par.grad_accum,
        remat=par.remat, opt_state_dtype=par.opt_state_dtype)
    t0 = time.time()
    try:
        _fake_world(chips)
        mesh = make_device_mesh(dims, names)
        rules.compute_mesh(mesh)          # its groups, before fake mode
        with FakeTensorMode():
            fn, args = build_cell(cfg, shape, par, mesh)
            t_build = time.time() - t0
            counter = CountMode()
            with counter:
                fn(*args)
        coll = collective_bytes(counter, per_op=True)
        rep = analyse_counted(arch, shape, mesh_kind, chips, counter.cost(),
                              coll, cfg)
        result.update(
            ok=True,
            build_s=round(t_build, 2), step_s=round(time.time() - t0 - t_build, 2),
            cost={"flops": float(counter.flops),
                  "bytes_accessed": float(counter.bytes)},
            collectives=coll,
            collective_bytes=rep.coll_bytes,
            roofline={
                "hw": rep.hw.name,
                "compute_s": rep.compute_s, "memory_s": rep.memory_s,
                "collective_s": rep.collective_s, "dominant": rep.dominant,
                "model_flops": rep.model_flops_,
                "useful_ratio": rep.useful_ratio,
                "roofline_fraction": rep.roofline_fraction,
            },
        )
    except Exception:
        result["error"] = traceback.format_exc(limit=25)
    finally:
        _teardown()
    result["wall_s"] = round(time.time() - t0, 2)
    return _write(result, outdir)


def _name(res) -> str:
    return f"{res['mesh']}__{res['arch']}__{res['shape']}".replace("/", "_")


def _write(result: dict, outdir: Optional[str]) -> dict:
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, _name(result) + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    status = ("SKIP " + result["skip"] if result["skip"]
              else "OK" if result["ok"] else "FAIL")
    dom = result.get("roofline", {}).get("dominant", "")
    print(f"[{result['mesh']:6s}] {result['arch']:24s} {result['shape']:12s} "
          f"{status} {dom}", flush=True)
    if result["error"]:
        print(result["error"], flush=True)
    return result


def _run_jobs(cells, overrides, out, jobs: int, timeout_s: float,
              reduced: bool) -> int:
    """Each cell in a process of its own (its own fake world), ``jobs`` at
    a time; a cell past ``timeout_s`` is killed and written as failed."""
    import subprocess
    import sys
    sets = [a for k, v in overrides.items() for a in ("--set", f"{k}={v}")]
    pending, running, failures = list(cells), [], 0

    def finish(cell, proc, t0):
        nonlocal failures
        mesh, arch, shape = cell
        path = os.path.join(out, _name({"mesh": mesh, "arch": arch,
                                        "shape": shape}) + ".json")
        if proc.returncode is None:
            proc.kill()
            proc.wait()
            _write({"arch": arch, "shape": shape, "mesh": mesh, "ok": False,
                    "skip": None, "wall_s": round(time.time() - t0, 2),
                    "error": f"not done in {timeout_s:.0f} s"}, out)
            failures += 1
            return
        ok = False
        if os.path.exists(path):
            with open(path) as f:
                ok = json.load(f)["ok"]
        failures += 0 if ok else 1

    while pending or running:
        while pending and len(running) < jobs:
            mesh, arch, shape = cell = pending.pop(0)
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--mesh", mesh,
                    "--out", out] + sets + (["--reduced"] if reduced else [])
            running.append((cell, subprocess.Popen(argv), time.time()))
        time.sleep(0.5)
        still = []
        for cell, proc, t0 in running:
            if proc.poll() is not None or time.time() - t0 > timeout_s:
                finish(cell, proc, t0)
            else:
                still.append((cell, proc, t0))
        running = still
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ASSIGNED + ["all"], default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"], default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--reduced", action="store_true",
                    help="each arch's reduced config (a quick check)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells at a time, each in a process of its own")
    ap.add_argument("--cell-timeout", type=float, default=1800.0,
                    help="seconds a cell may take with --jobs > 1")
    ap.add_argument("--set", action="append", default=[],
                    help="ParallelConfig override key=value")
    args = ap.parse_args(argv)

    overrides = dict(s.split("=", 1) for s in getattr(args, "set"))
    archs = ASSIGNED if (args.all or args.arch == "all") else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape == "all") else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(m, a, s) for m in meshes for a in archs for s in shapes]

    if args.jobs > 1:
        failures = _run_jobs(cells, overrides, args.out, args.jobs,
                             args.cell_timeout, args.reduced)
    else:
        failures = 0
        for mesh_kind, arch, shape in cells:
            res = run_cell(arch, shape, mesh_kind, overrides, args.out,
                           reduced=args.reduced)
            failures += 0 if res["ok"] else 1
    print(f"dry-run complete; failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
