"""Segmentation: split a stream into equal parts, merge results exactly.

The paper splits videos with FFmpeg's segment tool so >=3 devices analyse
concurrently, then ``mergeResults`` recombines per-segment JSON (§3.2.4).
Here a *video* is a frame-indexed array (or an LM token stream); splitting
is an index partition and merging re-bases the frame indices — the property
tests assert ``merge(process(split(v))) == process(v)`` exactly.

Applicability (DESIGN.md §6): splitting one stream across devices requires
frame-independence.  Frame-level models (the paper's detector/pose, and
attention LMs with chunked prefill) qualify; recurrent-state archs
(xlstm / recurrentgemma) do not — their streams pin to one worker group and
rely on early stopping only, which the scheduler enforces via
``splittable=False``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence


@dataclass(frozen=True)
class Segment:
    video_id: str
    index: int                    # segment ordinal within the video
    num_segments: int
    frame_start: int              # first source-frame index
    frame_count: int
    stream: str = "outer"         # outer | inner
    payload: Any = None           # frames array / token slice / None (sim)
    # False for recurrent-state archs whose streams must stay in order on
    # one worker (DESIGN.md §6 arch-applicability)
    splittable: bool = True
    # total frames of the parent video: the ESD deadline references the
    # *video* length, not the segment's (paper §4.2.2, Table 4.4 — segment
    # turnarounds are judged against the 1 s source video)
    video_frames: int = 0

    @property
    def parent_frames(self) -> int:
        return self.video_frames or self.frame_count

    @property
    def segment_id(self) -> str:
        return f"{self.video_id}_{self.index:03d}"


def split_counts(total: int, n: int) -> List[int]:
    """Equal split with remainder spread over the leading segments."""
    base, rem = divmod(total, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def split_video(video_id: str, total_frames: int, n: int, *,
                stream: str = "outer", payload=None) -> List[Segment]:
    if n <= 0:
        raise ValueError(f"num segments must be positive, got {n}")
    n = min(n, total_frames) or 1
    counts = split_counts(total_frames, n)
    segs = []
    start = 0
    for i, c in enumerate(counts):
        part = None
        if payload is not None:
            part = payload[start: start + c]
        segs.append(Segment(video_id, i, n, start, c, stream, part,
                            video_frames=total_frames))
        start += c
    return segs


@dataclass
class SegmentResult:
    segment: Segment
    frames: Dict[int, Any] = field(default_factory=dict)  # local idx -> result
    frames_processed: int = 0

    def rebased(self) -> Dict[int, Any]:
        return {self.segment.frame_start + i: r for i, r in self.frames.items()}


def merge_results(parts: Sequence[SegmentResult]) -> Dict[int, Any]:
    """Recombine per-segment results into video-global frame results.

    Validates coverage: all segments of the same video, disjoint ranges.
    """
    if not parts:
        return {}
    vid = parts[0].segment.video_id
    seen = set()
    merged: Dict[int, Any] = {}
    for p in sorted(parts, key=lambda p: p.segment.index):
        if p.segment.video_id != vid:
            raise ValueError(
                f"merge across videos: {p.segment.video_id} vs {vid}")
        if p.segment.index in seen:
            raise ValueError(f"duplicate segment {p.segment.index} of {vid}")
        seen.add(p.segment.index)
        merged.update(p.rebased())
    expect = set(range(parts[0].segment.num_segments))
    if seen != expect:
        raise ValueError(f"missing segments of {vid}: {sorted(expect - seen)}")
    return merged


def split_tokens(tokens, n: int) -> List[Any]:
    """Chunked-prefill split of an LM token stream (axis 0)."""
    counts = split_counts(len(tokens), n)
    out = []
    start = 0
    for c in counts:
        out.append(tokens[start: start + c])
        start += c
    return out
