"""Delivery sinks: the receiving end of the at-least-once event stream.

The spool guarantees every event is *sent* at least once; the sink
guarantees every event is *counted* at most once, by deduplicating on
the envelope's deterministic ``eid``.  ``deliver`` returns True when the
event was accepted (first copy) and False when it was a duplicate — both
are successful transport; a sink signals transport failure by raising
:class:`SinkUnavailable`, which the pump turns into exponential backoff.

``DedupSink`` is the reference in-memory receiver (the simulator's
"cloud"); ``FlakySink`` fails a scripted number of initial deliveries to
exercise the retry/backoff path deterministically.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.events.envelope import Event


class SinkUnavailable(RuntimeError):
    """Transport failure: the event was NOT received; retry later."""


class DedupSink:
    """Idempotent receiver: accepts each event id exactly once."""

    def __init__(self) -> None:
        self.accepted: Dict[str, Event] = {}
        self.order: List[str] = []       # acceptance order (first copies)
        self.duplicates = 0              # re-deliveries rejected by dedup
        self.attempts = 0                # every deliver() call that landed

    def deliver(self, ev: Event) -> bool:
        self.attempts += 1
        if ev.eid in self.accepted:
            self.duplicates += 1
            return False
        self.accepted[ev.eid] = ev
        self.order.append(ev.eid)
        return True

    @property
    def accepted_count(self) -> int:
        return len(self.accepted)

    def of_type(self, etype: str) -> List[Event]:
        return [self.accepted[eid] for eid in self.order
                if self.accepted[eid].etype == etype]


class FlakySink(DedupSink):
    """Fails the first ``fail_first`` deliveries (raising
    :class:`SinkUnavailable`), then behaves like :class:`DedupSink` —
    a deterministic stand-in for a cold/lossy backend."""

    def __init__(self, fail_first: int = 0) -> None:
        super().__init__()
        self.fail_first = fail_first
        self.failures = 0

    def deliver(self, ev: Event) -> bool:
        if self.failures < self.fail_first:
            self.failures += 1
            raise SinkUnavailable(
                f"sink down ({self.failures}/{self.fail_first})")
        return super().deliver(ev)
