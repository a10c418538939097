"""Capacity-aware master/worker scheduler (paper §3.2.5).

Decision tree, verbatim from the paper:

  0 workers   master processes everything locally.
  1 worker    compare capacities; the stronger of (master, worker) takes the
              outer video (hazards outrank distraction), the weaker the inner.
  N workers,  master-strongest-and-free -> master takes the video; otherwise
  no segm.    the free worker with the greatest capacity; if everyone is
              busy, the worker with greatest capacity then shortest queue.
  N workers,  outer -> the strongest device; inner split into equal segments
  + segm.     across the remaining devices (all devices busy simultaneously).

Capacity is a measured EWMA of frames/s (bootstrapped from a static
hardware-info prior — the paper's HW_INFO handshake), so heterogeneity and
transient slowness (stragglers) move placement automatically.  The same
class schedules dash-cam segments onto phones in the evaluation harness and
inference segments onto pod worker groups in ``repro_torch.serving``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

from repro_torch.core.early_stop import EWMA
from repro_torch.core.segmentation import Segment, split_video


@dataclass
class HardwareInfo:
    """Paper §3.2.1 data object (JSON over the HW_INFO message)."""
    cpu_ghz: float = 2.0
    cores: int = 8
    ram_gb: float = 8.0
    free_ram_gb: float = 4.0
    storage_gb: float = 64.0
    free_storage_gb: float = 16.0
    battery_pct: float = 100.0

    def capacity_prior(self) -> float:
        """Static capacity score: aggregate CPU throughput, derated when
        memory or battery is constrained (paper ranks on this at connect)."""
        score = self.cpu_ghz * self.cores
        if self.free_ram_gb < 1.0:
            score *= 0.7
        if self.battery_pct < 15.0:
            score *= 0.5
        return score


@dataclass
class WorkerState:
    name: str
    hw: HardwareInfo = field(default_factory=HardwareInfo)
    is_master: bool = False
    capacity_ewma: EWMA = field(default_factory=lambda: EWMA(alpha=0.3))
    busy_until_ms: float = 0.0
    queue_len: int = 0

    def capacity(self) -> float:
        """frames/s estimate: measured EWMA, else the static prior."""
        return self.capacity_ewma.get(self.hw.capacity_prior())

    def free_at(self, now_ms: float) -> bool:
        return self.busy_until_ms <= now_ms and self.queue_len == 0

    def observe(self, frames: int, processing_ms: float) -> None:
        if processing_ms > 0 and frames > 0:
            self.capacity_ewma.update(1000.0 * frames / processing_ms)


@dataclass(frozen=True)
class Assignment:
    segment: Segment
    worker: str


class CapacityScheduler:
    """The paper's master-side placement logic."""

    def __init__(self, master: WorkerState, workers: Sequence[WorkerState],
                 outer_priority: bool = True) -> None:
        self.master = master
        self.workers = list(workers)
        self.outer_priority = outer_priority

    # ------------------------------------------------------------------
    @property
    def devices(self) -> List[WorkerState]:
        return [self.master] + self.workers

    def by_name(self, name: str) -> WorkerState:
        for d in self.devices:
            if d.name == name:
                return d
        raise KeyError(name)

    def _strongest(self, pool: Sequence[WorkerState]) -> WorkerState:
        return max(pool, key=lambda w: w.capacity())

    def _pick_worker(self, now_ms: float) -> WorkerState:
        """N-worker, no-segmentation branch for one video."""
        free = [w for w in self.workers if w.free_at(now_ms)]
        master_strongest = (self.master.capacity()
                            >= max(w.capacity() for w in self.workers))
        if master_strongest and self.master.free_at(now_ms):
            return self.master
        if free:
            return self._strongest(free)
        if self.master.free_at(now_ms) and not free:
            return self.master
        # everyone busy: greatest capacity, then shortest queue
        return max(self.workers,
                   key=lambda w: (w.capacity(), -w.queue_len))

    # ------------------------------------------------------------------
    def schedule_pair(self, outer: Segment, inner: Segment, now_ms: float,
                      segmentation: bool = False,
                      num_segments: int = 0) -> List[Assignment]:
        """Place one (outer, inner) download pair.  Returns assignments in
        dispatch order (outer first — priority class)."""
        if not self.workers:
            return [Assignment(outer, self.master.name),
                    Assignment(inner, self.master.name)]

        if len(self.workers) == 1:
            w = self.workers[0]
            strong, weak = ((self.master, w)
                            if self.master.capacity() >= w.capacity()
                            else (w, self.master))
            if not self.outer_priority:
                strong, weak = weak, strong
            return [Assignment(outer, strong.name),
                    Assignment(inner, weak.name)]

        if segmentation:
            strongest = self._strongest(self.devices)
            rest = [d for d in self.devices if d.name != strongest.name]
            out = [Assignment(outer, strongest.name)]
            n = num_segments or len(rest)
            if not inner.splittable and n > 1:
                # recurrent-state streams cannot split (DESIGN.md §6):
                # fall back to whole-video placement on the strongest rest
                out.append(Assignment(inner, self._strongest(rest).name))
                return out
            segs = split_video(inner.video_id, inner.frame_count, n,
                               stream=inner.stream, payload=inner.payload)
            rest_sorted = sorted(rest, key=lambda w: -w.capacity())
            for i, s in enumerate(segs):
                out.append(Assignment(s, rest_sorted[i % len(rest)].name))
            return out

        return [Assignment(outer, self._pick_worker(now_ms).name),
                Assignment(inner, self._pick_worker(now_ms).name)]

    # ------------------------------------------------------------------
    def commit(self, a: Assignment, busy_until_ms: float) -> None:
        w = self.by_name(a.worker)
        w.queue_len += 1
        w.busy_until_ms = max(w.busy_until_ms, busy_until_ms)

    def complete(self, a: Assignment, frames: int,
                 processing_ms: float) -> None:
        w = self.by_name(a.worker)
        w.queue_len = max(w.queue_len - 1, 0)
        w.observe(frames, processing_ms)
