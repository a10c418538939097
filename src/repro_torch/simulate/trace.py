"""Canonical event traces: the simulator's deterministic output format.

Every scenario run emits a :class:`Trace` — an ordered list of events, one
per lifecycle action (join/refuse/leave/depart/fail/restore/rebind) plus
one aggregate event per virtual tick.  The trace serialises to a canonical
text form (one line per event, fields in emission order, floats formatted
``%.6g``) whose SHA-256 digest is the run's fingerprint: same scenario +
same seed ⇒ identical digest, and any behavioural drift in the gateway,
engine, scheduler, gate, or deadline policy changes the digest — which is
exactly what the golden-trace regression test pins.

Floats are formatted (not ``repr``'d) so the canonical form is stable
against representation noise; every float that enters a trace is itself a
deterministic function of the seed (virtual-clock arithmetic, the energy
model, gate thresholds) — wall-clock time never appears in a trace.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        return format(v, ".6g")
    return str(v)


@dataclass(frozen=True)
class Event:
    tick: int
    kind: str
    fields: Tuple[Tuple[str, object], ...]

    def line(self) -> str:
        body = " ".join(f"{k}={_fmt(v)}" for k, v in self.fields)
        return f"{self.tick:06d} {self.kind}" + (f" {body}" if body else "")

    def get(self, key: str, default=None):
        for k, v in self.fields:
            if k == key:
                return v
        return default


class Trace:
    """Append-only event log with a canonical serialisation + digest."""

    def __init__(self) -> None:
        self.events: List[Event] = []

    def emit(self, tick: int, kind: str, **fields) -> Event:
        ev = Event(tick, kind, tuple(fields.items()))
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return dict(sorted(out.items()))

    def canonical(self) -> str:
        return "\n".join(e.line() for e in self.events) + "\n"

    def digest(self) -> str:
        return hashlib.sha256(self.canonical().encode()).hexdigest()

    def tail(self, n: int = 10) -> str:
        return "\n".join(e.line() for e in self.events[-n:])
