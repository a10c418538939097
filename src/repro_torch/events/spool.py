"""Bounded per-stream event spool: at-least-once survival across partitions.

One spool buffers one stream's undelivered events on the edge side of the
uplink.  Events move through three states:

    pending   appended by the emitter, not yet handed to the sink
    inflight  handed to the sink, awaiting the (next-pump) ack
    acked     delivered — dropped from the spool

The at-least-once contract lives in the inflight set: when the uplink
partitions, the ack for anything already sent is *lost*, so
:meth:`on_partition` rewinds inflight events back to pending — on
reconnect they are re-sent and the receiver's idempotent dedup
(``events.sink``) rejects the second copy.  Nothing is ever dropped
silently: the spool is bounded, and overflow evicts the OLDEST pending
event with a counted, warned ``overflow_dropped`` (stale alerts are the
least valuable, exactly like the engines' frame backpressure).

Delivery failures (sink unavailable, distinct from a known partition)
back off exponentially: after ``k`` consecutive failures the spool skips
``min(2**k, backoff_cap)`` pump rounds before retrying.
"""
from __future__ import annotations

import warnings
from collections import deque
from typing import Deque, List

from repro_torch.events.envelope import Event


class EventSpool:
    """Bounded FIFO with pending/inflight at-least-once bookkeeping."""

    def __init__(self, cap: int = 64, backoff_cap: int = 16) -> None:
        if cap < 1:
            raise ValueError(f"spool cap must be >= 1, got {cap}")
        self.cap = cap
        self.backoff_cap = backoff_cap
        self.pending: Deque[Event] = deque()
        self.inflight: List[Event] = []
        self.overflow_dropped = 0
        self.appended = 0
        self.fails = 0                  # consecutive delivery failures
        self.next_attempt = 0           # pump round gate (backoff)
        self.closed = False             # stream closed; drain then delete

    @property
    def depth(self) -> int:
        return len(self.pending) + len(self.inflight)

    def append(self, ev: Event) -> None:
        """Buffer one event; bounded — overflow evicts the oldest pending
        event loudly (counted + warned), never the newest."""
        if self.depth >= self.cap:
            if self.pending:
                dropped = self.pending.popleft()
                self.overflow_dropped += 1
                warnings.warn(
                    f"event spool for {dropped.key!r} overflowed (cap "
                    f"{self.cap}): dropped oldest event "
                    f"{dropped.eid} ({dropped.etype})", stacklevel=2)
            else:
                # every buffered event is awaiting an ack: dropping an
                # inflight event would break at-least-once — drop the
                # NEW event instead (still counted, still loud)
                self.overflow_dropped += 1
                warnings.warn(
                    f"event spool for {ev.key!r} overflowed with a full "
                    f"inflight window: dropped new event {ev.eid} "
                    f"({ev.etype})", stacklevel=2)
                return
        self.pending.append(ev)
        self.appended += 1

    # ------------------------------------------------------------------
    # delivery protocol (driven by EventPlane.pump)
    # ------------------------------------------------------------------
    def ack_inflight(self) -> int:
        """The previous pump's sends survived a full round with the uplink
        still up: their acks arrived — forget them."""
        n = len(self.inflight)
        self.inflight.clear()
        return n

    def mark_sent(self, ev: Event) -> None:
        self.inflight.append(ev)

    def on_partition(self) -> int:
        """Uplink lost: acks for anything inflight are gone.  Rewind the
        inflight window to pending (front, original order) so reconnect
        re-sends them — the at-least-once duplicate source the receiver's
        dedup must absorb."""
        n = len(self.inflight)
        for ev in reversed(self.inflight):
            self.pending.appendleft(ev)
        self.inflight.clear()
        return n

    def on_send_failure(self, round_idx: int) -> None:
        """Sink refused transport (not a known partition): exponential
        backoff before the next attempt."""
        self.fails += 1
        self.next_attempt = round_idx + min(2 ** self.fails,
                                            self.backoff_cap)

    def on_send_success(self) -> None:
        self.fails = 0
        self.next_attempt = 0

    def ready(self, round_idx: int) -> bool:
        return round_idx >= self.next_attempt
