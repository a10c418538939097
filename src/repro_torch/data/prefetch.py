"""Device prefetch: overlap host batch production + host->device copies
with compute.

Counterpart of the reference's ``data/prefetch.py``, the card-side
realisation of the paper's "simultaneous download and analysis": the
background thread of :class:`repro_torch.core.pipeline.DoubleBuffer`
copies batch i+1 to the card while the caller's work on batch i is queued,
as the master's download thread rides under analysis.
"""
from __future__ import annotations

from typing import Any, Iterable, Iterator

import torch

from repro_torch.core.pipeline import DoubleBuffer
from repro_torch.device import resolve_device


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def device_prefetch(batches: Iterable[Any], device=None,
                    depth: int = 2) -> Iterator[Any]:
    """Iterate ``batches`` (trees of dicts, lists and tuples whose leaves
    are tensors or numpy arrays) with lookahead device placement.

    ``device=None`` means the card (``resolve_device``); the reference's
    ``sharding`` argument has no meaning on one card and is not taken.  On
    the card the producer thread pins each batch and copies it with
    ``non_blocking=True`` on a side stream of its own, then records an
    event; before a batch is handed out the consumer's current stream
    waits on that event, and each copied tensor is marked as used by that
    stream (``record_stream``), so the allocator keeps its storage until
    the consumer's queued work is done.  ``device="cpu"`` neither pins nor
    copies: the leaves become tensors (``torch.as_tensor``, sharing a numpy
    array's memory) and are handed out as they are.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return iter(DoubleBuffer(batches, depth=depth,
                                 transform=lambda b: _map(b, torch.as_tensor)))
    side = torch.cuda.Stream(device=dev)

    def put(batch):
        # pinned by the caching host allocator, which holds each pinned
        # block until the copy that reads it has run
        host = _map(batch, lambda a: torch.as_tensor(a).pin_memory())
        with torch.cuda.stream(side):
            out = _map(host, lambda t: t.to(dev, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def hand_out(buf):
        for out, ready in buf:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for t in _leaves(out):
                t.record_stream(consumer)
            yield out

    # the buffer (and its producer thread) starts here, as the reference's
    return hand_out(DoubleBuffer(batches, depth=depth, transform=put))
