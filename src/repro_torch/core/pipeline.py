"""Simultaneous download + analysis: double-buffered ingest.

Counterpart of the reference's ``core/pipeline.py``, with its sentinel and
error semantics.  The paper's first optimisation overlaps downloading the
next video pair with analysing the current one.  In the event-clock runtime
(``core.runtime``) this overlap is inherent (download times advance on the
pair clock, device availability on each device's own clock).  For *real*
execution this module provides the host-side machinery:

  * :class:`DoubleBuffer` — a lookahead prefetcher running the ingest
    callable on a background thread while the caller consumes the previous
    item (the paper's master download thread).  The producer enqueues one
    sentinel when its source ends or raises; an error is raised at the
    consumer after the items produced before it, and an exhausted buffer
    stays exhausted.
  * :func:`overlapped` — iterator adaptor: ``for item in overlapped(src)``
    guarantees ingest of item i+1 overlaps the loop body of item i.

On the card the same pattern becomes host->device copy overlap:
``repro_torch.data.prefetch`` copies batch i+1 on a side stream inside the
background thread while the caller's work on batch i is queued.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class DoubleBuffer:
    """One-producer one-consumer lookahead buffer (depth configurable)."""

    def __init__(self, source: Iterable[T], depth: int = 2,
                 transform: Optional[Callable[[T], T]] = None) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._transform = transform
        self._err: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True)
        self._thread.start()

    def _produce(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:          # surface in consumer
            self._err = e
        finally:
            self._q.put(_SENTINEL)

    def __iter__(self) -> Iterator[T]:
        return self

    def __next__(self) -> T:
        if self._done:
            # iterator protocol: stay exhausted instead of blocking on the
            # drained queue (the producer only enqueues the sentinel once)
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def overlapped(source: Iterable[T], depth: int = 2,
               transform: Optional[Callable[[T], T]] = None) -> Iterator[T]:
    """``for x in overlapped(gen())`` — ingest overlaps the loop body."""
    return iter(DoubleBuffer(source, depth=depth, transform=transform))
