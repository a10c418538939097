"""Event/alert plane: engine outputs as a reliable, duplicate-free stream.

See ``plane.py`` for the wiring overview: envelopes (``envelope``), the
bounded at-least-once spools (``spool``), evidence clips (``evidence``)
and the idempotent receivers (``sink``).
"""
from repro_torch.events.envelope import (DEADLINE_MISS, DISTRACTION,
                                         EVENT_TYPES, HAZARD, TOKEN_DONE,
                                         Event, event_id)
from repro_torch.events.evidence import EvidenceRing, clip_digest
from repro_torch.events.plane import EventConfig, EventEmitter, EventPlane
from repro_torch.events.sink import DedupSink, FlakySink, SinkUnavailable
from repro_torch.events.spool import EventSpool

__all__ = [
    "Event", "event_id", "EVENT_TYPES",
    "HAZARD", "DISTRACTION", "DEADLINE_MISS", "TOKEN_DONE",
    "EvidenceRing", "clip_digest",
    "EventConfig", "EventEmitter", "EventPlane",
    "DedupSink", "FlakySink", "SinkUnavailable",
    "EventSpool",
]
