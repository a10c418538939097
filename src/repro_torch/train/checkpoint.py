"""Checkpoints with atomic rename, async save and keep-k GC, in the
reference's on-disk format.

Layout (one directory per step, atomic rename on completion):

    <dir>/step_00001200/
        manifest.json        {"step", "time", "leaves": [{"key", "shape",
                             "dtype"}]}, dtypes by numpy name
                             ("bfloat16", "float32", "int32", ...)
        <leaf-key>.npy       one raw uint8 array per tree leaf

A leaf's key is its path (dict keys, then list indices) joined by ``__``,
as the reference's ``_leaf_key`` builds it, and leaves are listed in the
reference's order (dict keys sorted), so either package restores what the
other wrote.  bf16 is read as ``torch.from_numpy(raw).view(torch.bfloat16)``:
numpy has no bf16 of its own, and the card's machine has no ``ml_dtypes``.

  * crash-consistent: writers stage into ``.tmp-...`` and ``rename()``;
    a reader never sees a partial checkpoint, and a restart finds the
    latest complete step (``latest_step``).
  * async: ``save(..., blocking=False)`` copies every leaf to host memory
    (a synchronous ``.cpu()``, a copy for CPU leaves too) before it
    returns, then writes on a thread, so the optimizer may update the
    tensors in place at once.
  * bounded: the ``keep`` newest checkpoints survive GC.
  * elastic: a DTensor leaf is gathered whole on save (every rank takes
    part; rank 0 writes), and ``restore(..., shardings=...)`` places each
    saved leaf onto the run's mesh by a ``sharding.rules.NamedSharding``
    tree, whatever mesh wrote it (the reference's
    ``make_array_from_callback`` restore).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree: Any, path: tuple = (),
             leaf=lambda x: False) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs, dict keys sorted as ``jax.tree_util`` sorts
    them; ``leaf(x)`` stops the descent at ``x``."""
    if leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], path + (k,), leaf)]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, path + (i,), leaf)]
    return [(path, tree)]


def _leaf_key(path: tuple) -> str:
    return "__".join(str(p) for p in path) or "root"


def _rebuild(tree: Any, values: dict, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path + (i,))
                          for i, v in enumerate(tree))
    return values[path]


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         blocking: bool = True) -> threading.Thread:
    """Write one checkpoint of a tree of tensors.  Returns the writer
    thread (joined if blocking); once it has ended, its ``write_s`` holds
    the seconds the write took."""
    # snapshot to host memory NOW: the optimizer writes in place after return
    host = [(path, _whole(t).detach().to("cpu", copy=True))
            for path, t in _flatten(tree)]
    if _rank() != 0:
        # the leaves were gathered whole; one rank writes them
        writer = threading.Thread(target=lambda: None, daemon=True)
        writer.start()
        writer.join()
        writer.write_s = 0.0
        return writer

    def write():
        t0 = time.perf_counter()
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": [], "time": time.time()}
        for path, t in host:
            key = _leaf_key(path)
            raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
            np.save(os.path.join(tmp, key + ".npy"), raw)
            manifest["leaves"].append(
                {"key": key, "shape": list(t.shape),
                 "dtype": _dtype_name(t.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
        writer.write_s = time.perf_counter() - t0

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    if blocking:
        writer.join()
    return writer


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (leaves: anything with
    a torch ``dtype``, e.g. tensors; each restored leaf is cast to it) on
    ``device``, the card unless ``"cpu"`` is asked.  ``shardings``: an
    optional tree like ``tree_like`` of ``sharding.rules.NamedSharding``;
    each leaf is then placed on its mesh, a DTensor holding this rank's
    slice (elastic restore).  ``step`` defaults to the latest complete
    one.  Returns (tree, step)."""
    dev = resolve_device(device)
    shard_of = dict(_flatten(shardings, leaf=_is_sharding)) \
        if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    meta = {m["key"]: m for m in manifest["leaves"]}
    values = {}
    for path, like in _flatten(tree_like):
        key = _leaf_key(path)
        m = meta[key]
        raw = np.load(os.path.join(d, key + ".npy"))
        t = torch.from_numpy(raw).view(getattr(torch, m["dtype"]))
        t = t.reshape(m["shape"]).to(device=dev, dtype=like.dtype)
        if path in shard_of:
            from torch.distributed.tensor import distribute_tensor
            s = shard_of[path]
            t = distribute_tensor(t, s.mesh, s.placements, src_data_rank=None)
        values[path] = t
    return _rebuild(tree_like, values), step


def _is_sharding(x) -> bool:
    return hasattr(x, "mesh") and hasattr(x, "placements")
