"""What a serving engine observes inside a forward of the model: host
spans around a layer's mechanisms (``mla``, ``moe``) and a counter, on the
model's device, of the MoE copies that an expert's capacity dropped.

The engine sets both around its dispatches (:func:`observing`); any other
forward runs with neither.  A span costs the engine's null span outside a
traced tick, and nothing in a CUDA graph's replay, where the Python that
opens it does not run.  The counter is added to in place, so no forward
waits for the card; a graph captured under it adds in every replay.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch

from repro_torch.obs.tracing import NULL_SPAN

#: the current dispatch's span factory (``name -> context manager``) and
#: dropped-copy counter (an int64 scalar tensor), each None when unset
_STATE = {"span": None, "dropped": None}


@contextmanager
def observing(span: Optional[Callable] = None,
              dropped: Optional[torch.Tensor] = None):
    """Route the forwards run inside to ``span`` and ``dropped``."""
    old = dict(_STATE)
    _STATE.update(span=span, dropped=dropped)
    try:
        yield
    finally:
        _STATE.update(old)


def span(name: str):
    """A host span of the dispatch that runs this forward, or the null
    span."""
    make = _STATE["span"]
    return NULL_SPAN if make is None else make(name)


def count_dropped(n: torch.Tensor) -> None:
    """Add ``n`` dropped copies to the dispatch's counter, if it keeps one."""
    sink = _STATE["dropped"]
    if sink is not None:
        sink.add_(n)
