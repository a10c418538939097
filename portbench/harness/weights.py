"""Weights drawn from the seed on the card, in the type they are served in.

One ``torch.randn`` over a flat buffer holds every leaf; each leaf is a
view of it, scaled in place by its kind (a matrix by ``1/sqrt(fan_in)``, an
embedding table and a bias by 0.02, a norm's scale as ``1 + 0.05 n``).  The
program gets the tree of views; the reference gets the same tensors.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Callable, List, Tuple


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (weights, traffic, sampling) of ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def leaf_kind(path: Tuple[str, ...], shape) -> str:
    key = path[-1]
    if key == "tokens":
        return "embed"
    if key == "scale":
        return "norm"
    if key in ("b", "bias"):
        return "bias"
    if len(shape) >= 2:
        return "matrix"
    return "bias"


def walk(tree: Any, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    else:
        yield path, tree


def rebuild(tree: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)
    return go(tree)


def draw_tree(torch, like: Any, seed: int, device, dtype,
              fan_in: Callable = None) -> Any:
    """A tree shaped as ``like`` (tensors or meta tensors) of values drawn
    from ``seed`` on ``device`` in ``dtype``.  ``fan_in(path, shape)``
    overrides the default ``prod(shape[:-1])`` of a matrix."""
    leaves = list(walk(like))
    sizes = [math.prod(t.shape) for _, t in leaves]
    g = torch.Generator(device=device).manual_seed(derive_seed(seed,
                                                               "weights"))
    flat = torch.randn(sum(sizes), generator=g, dtype=dtype, device=device)
    out = []
    for (path, t), part in zip(leaves, flat.split(sizes)):
        v = part.view(tuple(t.shape))
        kind = leaf_kind(path, t.shape)
        if kind == "norm":
            v.mul_(0.05).add_(1.0)
        elif kind in ("embed", "bias"):
            v.mul_(0.02)
        else:
            fi = (fan_in(path, t.shape) if fan_in is not None
                  else math.prod(t.shape[:-1]))
            v.mul_(1.0 / math.sqrt(max(fi, 1)))
        out.append(v)
    return rebuild(like, out)
