"""Lightweight parameter-descriptor system.

Models declare their parameters as trees (nested dicts/lists) of :class:`P`
descriptors; :func:`init_tree` materialises a tree of tensors from them
with one ``torch.Generator``.  Each leaf draws from its own generator on
the target device, seeded from the caller's seed and a hash of the leaf's
path, so adding a parameter never reshuffles the others (the reference
folds the same path hash into its PRNG key).  The numbers differ from the
reference's for the same seed, and between the host's and the card's
generators — parity tests inject the reference's parameters through
``repro_torch.convert`` instead, and card-vs-CPU comparisons draw on the
host and move the tree with :func:`tree_to`.

Sharding specs (``PartitionSpec`` trees) are not ported: the port runs on
one card.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class P:
    """Descriptor for one parameter tensor."""
    shape: tuple
    axes: tuple                      # logical axis name per dim (None ok)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: float = 1.0               # stddev multiplier (normal) / value
    dtype: Optional[str] = None      # override model param dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _leaf_seed(seed: int, path: str) -> int:
    h = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "big")
    return (seed * 0x9E3779B1 + h) % (2 ** 63)


def _fan_in(shape: tuple) -> int:
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


def _init_leaf(p: P, seed: int, path: str, default_dtype: str,
               device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, p.dtype or default_dtype)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.full(p.shape, p.scale, dtype=dtype, device=device)
    if p.init == "embed":
        std = p.scale
    else:  # normal: lecun-style 1/sqrt(fan_in)
        std = p.scale / max(np.sqrt(_fan_in(p.shape)), 1.0)
    g = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    x = torch.randn(p.shape, generator=g, dtype=torch.float32,
                    device=device) * std
    return x.to(device=device, dtype=dtype)


def _map_with_path(tree: Any, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(v, fn, f"{path}/{i}") for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, path)


def init_tree(ptree: Any, generator: torch.Generator,
              default_dtype: str = "float32",
              device: torch.device = torch.device("cpu")) -> Any:
    """Materialise a descriptor tree on ``device``.  ``generator`` supplies
    the base seed (one draw); each leaf then uses its own path-keyed
    generator on ``device``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    return _map_with_path(
        ptree, lambda p, path: _init_leaf(p, seed, path, default_dtype,
                                          device))


def tree_map(fn, *trees: Any) -> Any:
    """``fn`` over the leaves of trees of one structure, in dict order.
    Dicts and lists are nodes; anything else (a tuple too) is a leaf."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree: Any) -> list:
    """The leaves in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_to(tree: Any, device: torch.device) -> Any:
    """The same tree with every tensor leaf on ``device``."""
    return _map_with_path(tree, lambda t, path: t.to(device))
