"""Per-segment timing decomposition and the turnaround ledger (paper §4.2.1).

The paper decomposes each video's life into six time types measured in ms:

  download    dash cam -> master (simulated 350 ms at 1 s granularity)
  transfer    master -> worker video payload
  return      worker -> master result payload
  processing  frame extraction + inference + result write
  wait        arrival at device -> processing start (queueing + system)
  overhead    residual: turnaround - (sum of the above)

``turnaround`` is download-start -> result-at-master; *near real-time* means
turnaround <= video length.  The ledger reproduces the paper's per-device
averages (Tables 4.2-4.7) and the skip-rate accounting (§4.2.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.sketch import QuantileSketch

MS = float


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), 0.0 for
    an empty series — telemetry stays dependency-free."""
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    rank = (len(xs) - 1) * q / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (rank - lo))


@dataclass
class SegmentRecord:
    video_id: str
    stream: str                     # "outer" | "inner"
    device: str
    download_ms: MS = 0.0
    transfer_ms: MS = 0.0
    return_ms: MS = 0.0
    processing_ms: MS = 0.0
    wait_ms: MS = 0.0
    overhead_ms: MS = 0.0
    turnaround_ms: MS = 0.0
    video_len_ms: MS = 0.0
    esd: float = 0.0
    frames_total: int = 0
    frames_processed: int = 0
    # Explicit skip decomposition (None = producer does not account per
    # cause, e.g. the EDARuntime cost model, where skipped is simply
    # total - processed).  Producers that do account (VisionServeEngine)
    # must satisfy processed + gated + dropped == total — Ledger.check().
    frames_gated: Optional[int] = None      # motion-gate rejects
    frames_dropped: Optional[int] = None    # deadline + backpressure + churn
    frames_deadline_dropped: Optional[int] = None  # subset of dropped
    # time-to-first-result: prompt-prefill TTFT for token workloads, 0.0
    # when the producer does not measure it (vision streams, EDARuntime)
    ttft_ms: MS = 0.0
    is_master: bool = False
    energy_j: float = 0.0

    @property
    def frames_skipped(self) -> int:
        return self.frames_total - self.frames_processed

    @property
    def skip_rate(self) -> float:
        if self.frames_total == 0:
            return 0.0
        return self.frames_skipped / self.frames_total

    @property
    def real_time(self) -> bool:
        return self.turnaround_ms <= self.video_len_ms

    def close(self, turnaround_ms: MS) -> None:
        """Set turnaround and derive overhead as the residual (§4.2.1)."""
        self.turnaround_ms = turnaround_ms
        accounted = (self.download_ms + self.transfer_ms + self.return_ms
                     + self.processing_ms + self.wait_ms)
        self.overhead_ms = max(turnaround_ms - accounted, 0.0)


@dataclass
class DeviceSummary:
    device: str
    is_master: bool
    n: int
    download_ms: MS
    transfer_ms: MS
    return_ms: MS
    processing_ms: MS
    wait_ms: MS
    overhead_ms: MS
    turnaround_ms: MS
    esd: float
    skip_rate: float
    avg_power_mw: float
    energy_j: float
    # mean TTFT over the records that measured one (token workloads);
    # 0.0 for pure-vision devices
    ttft_ms: MS = 0.0

    def row(self) -> dict:
        return {
            "device": self.device + ("*" if self.is_master else ""),
            "download_ms": round(self.download_ms),
            "transfer_ms": round(self.transfer_ms),
            "return_ms": round(self.return_ms),
            "processing_ms": round(self.processing_ms),
            "wait_ms": round(self.wait_ms),
            "overhead_ms": round(self.overhead_ms),
            "turnaround_ms": round(self.turnaround_ms),
            "ttft_ms": round(self.ttft_ms),
            "esd": self.esd,
            "skip_rate": f"{100 * self.skip_rate:.1f}%",
            "avg_power_mw": round(self.avg_power_mw, 1),
            "energy_j": round(self.energy_j, 2),
        }


@dataclass
class _DeviceAgg:
    """Running per-device sums — what ``summarise`` needs, O(devices)."""
    n: int = 0
    is_master: bool = False
    download_ms: MS = 0.0
    transfer_ms: MS = 0.0
    return_ms: MS = 0.0
    processing_ms: MS = 0.0
    wait_ms: MS = 0.0
    overhead_ms: MS = 0.0
    turnaround_ms: MS = 0.0
    video_len_ms: MS = 0.0
    esd: float = 0.0
    frames_total: int = 0
    frames_processed: int = 0
    energy_j: float = 0.0
    ttft_ms: MS = 0.0              # sum over records with a measured TTFT
    ttft_n: int = 0

    def fold(self, r: SegmentRecord) -> None:
        self.n += 1
        self.is_master = self.is_master or r.is_master
        self.download_ms += r.download_ms
        self.transfer_ms += r.transfer_ms
        self.return_ms += r.return_ms
        self.processing_ms += r.processing_ms
        self.wait_ms += r.wait_ms
        self.overhead_ms += r.overhead_ms
        self.turnaround_ms += r.turnaround_ms
        self.video_len_ms += r.video_len_ms
        self.esd = max(self.esd, r.esd)
        self.frames_total += r.frames_total
        self.frames_processed += r.frames_processed
        self.energy_j += r.energy_j
        if r.ttft_ms > 0:
            self.ttft_ms += r.ttft_ms
            self.ttft_n += 1

    def merge(self, o: "_DeviceAgg") -> None:
        self.n += o.n
        self.is_master = self.is_master or o.is_master
        for f in ("download_ms", "transfer_ms", "return_ms",
                  "processing_ms", "wait_ms", "overhead_ms",
                  "turnaround_ms", "video_len_ms", "frames_total",
                  "frames_processed", "energy_j", "ttft_ms", "ttft_n"):
            setattr(self, f, getattr(self, f) + getattr(o, f))
        self.esd = max(self.esd, o.esd)


class Ledger:
    """Collects SegmentRecords; summarises per device like the paper tables.

    Two storage modes share one API:

      * default: every record is kept (``self.records``) — exact
        percentiles, per-record ``check()``, full drill-down;
      * ``aggregate=True``: rows are folded into O(devices) running sums
        + O(buckets) quantile sketches and then DISCARDED — the fleet-
        scale mode (city-scale fleets cannot hold O(frames) host rows).
        Conservation is checked per record at ``add()`` time instead of
        at ``check()`` time, and ``percentiles()`` answers from the
        sketches, within their ``rel_err`` relative-error bound.

    Both modes always feed the sketches, so ``sketch_percentiles()`` and
    cross-ledger ``merge_from()`` (per-replica ledgers -> one fleet view)
    work either way, and sketch-vs-exact parity is testable on the
    default mode (``tests/test_telemetry.py``).
    """

    #: metrics with a streaming quantile sketch (mirrors ``percentiles``)
    SKETCH_METRICS = ("turnaround_ms", "ttft_ms", "skip_rate")

    def __init__(self, *, aggregate: bool = False,
                 rel_err: float = 0.01) -> None:
        self.records: List[SegmentRecord] = []
        self.aggregate = aggregate
        self.rel_err = rel_err
        self.sketches: Dict[str, QuantileSketch] = {
            m: QuantileSketch(rel_err) for m in self.SKETCH_METRICS}
        self.totals: Dict[str, float] = {
            "records": 0, "turnaround_ms": 0.0, "energy_j": 0.0,
            "real_time": 0, "frames_total": 0, "frames_processed": 0,
            "ttft_records": 0}
        self._aggs: Dict[str, _DeviceAgg] = {}

    def __len__(self) -> int:
        return int(self.totals["records"])

    def add(self, rec: SegmentRecord) -> None:
        self.totals["records"] += 1
        self.totals["turnaround_ms"] += rec.turnaround_ms
        self.totals["energy_j"] += rec.energy_j
        self.totals["real_time"] += rec.real_time
        self.totals["frames_total"] += rec.frames_total
        self.totals["frames_processed"] += rec.frames_processed
        # clamp sketch inputs: a conservation-violating record (processed
        # outside [0, total] -> skip_rate outside [0, 1]) must still be
        # *accepted* here so check() can flag it with its proper message,
        # not die inside the nonnegative-only sketch
        self.sketches["turnaround_ms"].add(max(rec.turnaround_ms, 0.0))
        self.sketches["skip_rate"].add(min(max(rec.skip_rate, 0.0), 1.0))
        if rec.ttft_ms > 0:
            self.totals["ttft_records"] += 1
            self.sketches["ttft_ms"].add(rec.ttft_ms)
        self._aggs.setdefault(rec.device, _DeviceAgg()).fold(rec)
        if self.aggregate:
            # the row is about to be dropped — conservation checks run now
            errors = self._record_errors(rec)
            if errors:
                raise AssertionError(
                    "ledger conservation violated:\n  "
                    + "\n  ".join(errors))
        else:
            self.records.append(rec)

    @staticmethod
    def _record_errors(r: SegmentRecord) -> List[str]:
        errors = []
        if not 0 <= r.frames_processed <= r.frames_total:
            errors.append(
                f"{r.video_id}/{r.stream}@{r.device}: processed "
                f"{r.frames_processed} outside [0, {r.frames_total}]")
        if r.frames_gated is None and r.frames_dropped is None:
            return errors                     # no per-cause accounting
        gated = r.frames_gated or 0
        dropped = r.frames_dropped or 0
        ddl = r.frames_deadline_dropped or 0
        if r.frames_processed + gated + dropped != r.frames_total:
            errors.append(
                f"{r.video_id}/{r.stream}@{r.device}: "
                f"processed {r.frames_processed} + gated {gated} "
                f"+ dropped {dropped} != offered {r.frames_total}")
        if ddl > dropped:
            errors.append(
                f"{r.video_id}/{r.stream}@{r.device}: deadline-dropped "
                f"{ddl} exceeds dropped {dropped}")
        return errors

    def check(self) -> None:
        """Frame-conservation assertion over every record.

        For any record: 0 <= processed <= total.  For records carrying the
        explicit skip decomposition (the fleet engine's), every offered
        frame must be accounted exactly once:

            processed + gated + dropped == total
            deadline-dropped <= dropped

        Raises ``AssertionError`` naming every violating stream — this is
        the invariant that makes accounting drift in the serving path fail
        loudly instead of quietly skewing skip-rate tables.  (An
        ``aggregate=True`` ledger ran these checks per record at ``add``
        time; here its record list is empty and the loop is a no-op.)
        """
        errors = []
        for r in self.records:
            errors.extend(self._record_errors(r))
        if errors:
            raise AssertionError(
                "ledger conservation violated:\n  " + "\n  ".join(errors))

    # ------------------------------------------------------------------
    def by_device(self) -> Dict[str, List[SegmentRecord]]:
        out: Dict[str, List[SegmentRecord]] = {}
        for r in self.records:
            out.setdefault(r.device, []).append(r)
        return out

    def summarise(self, wall_s: Optional[float] = None) -> List[DeviceSummary]:
        """Per-device means, built from the running aggregates (identical
        in both storage modes).  ``wall_s``, when given, is the measured
        wall-clock duration of the whole run: average power is then the
        device's total energy over that wall time; otherwise it is the
        paper's per-video metric — energy per video over the video's own
        nominal length."""
        sums = []
        for dev, a in sorted(self._aggs.items()):
            n = a.n
            video_s = (a.video_len_ms / n) / 1000.0
            if wall_s is not None and wall_s > 0:
                power_mw = 1000.0 * a.energy_j / wall_s
            else:
                power_mw = 1000.0 * (a.energy_j / n) / max(video_s, 1e-9)
            sums.append(DeviceSummary(
                device=dev,
                is_master=a.is_master,
                n=n,
                download_ms=a.download_ms / n,
                transfer_ms=a.transfer_ms / n,
                return_ms=a.return_ms / n,
                processing_ms=a.processing_ms / n,
                wait_ms=a.wait_ms / n,
                overhead_ms=a.overhead_ms / n,
                turnaround_ms=a.turnaround_ms / n,
                esd=a.esd,
                skip_rate=((1 - a.frames_processed / a.frames_total)
                           if a.frames_total else 0.0),
                avg_power_mw=power_mw,
                energy_j=a.energy_j,
                ttft_ms=a.ttft_ms / a.ttft_n if a.ttft_n else 0.0,
            ))
        return sums

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        """Tail summaries over the collected records: ``p50/p95/p99`` (by
        default) of turnaround, TTFT and skip rate, keyed
        ``"<metric>_p<q>"``.  TTFT percentiles cover only the records
        whose producer measured a TTFT (token workloads); an empty ledger
        (or no TTFT producers) yields 0.0 — benches surface these rows
        straight into the ``BENCH_*.json`` snapshot.  An aggregate-mode
        ledger keeps no rows and answers from its sketches instead (same
        keys, within ``rel_err``)."""
        if self.aggregate:
            return self.sketch_percentiles(qs)
        series = {
            "turnaround_ms": [r.turnaround_ms for r in self.records],
            "ttft_ms": [r.ttft_ms for r in self.records if r.ttft_ms > 0],
            "skip_rate": [r.skip_rate for r in self.records],
        }
        out: Dict[str, float] = {}
        for metric, values in series.items():
            for q in qs:
                key = f"{metric}_p{q:g}"
                out[key] = percentile(values, q)
        return out

    def sketch_percentiles(self, qs: Sequence[float] = (50, 95, 99)
                           ) -> Dict[str, float]:
        """The sketch-backed twin of :meth:`percentiles` — same keys,
        O(buckets) memory, each value within the sketch's ``rel_err``
        relative-error bound of the exact rank statistic (property-tested
        against :meth:`percentiles` in ``tests/test_telemetry.py``)."""
        return {f"{metric}_p{q:g}": self.sketches[metric].quantile(q)
                for metric in self.SKETCH_METRICS for q in qs}

    def merge_from(self, other: "Ledger") -> "Ledger":
        """Fold another ledger (a replica's, a cell's) into this one:
        sketches merge loss-free, totals and device aggregates sum, and
        record rows concatenate when the source kept them.  This is the
        fleet roll-up path — N per-replica aggregate ledgers merge into
        one fleet ledger whose percentiles match a single global ledger
        within ``rel_err``.  Returns self for chaining."""
        for m in self.SKETCH_METRICS:
            self.sketches[m].merge(other.sketches[m])
        for k, v in other.totals.items():
            self.totals[k] = self.totals.get(k, 0) + v
        for dev, agg in other._aggs.items():
            self._aggs.setdefault(dev, _DeviceAgg()).merge(agg)
        self.records.extend(other.records)
        return self

    def real_time_fraction(self) -> float:
        if not self.totals["records"]:
            return 0.0
        return self.totals["real_time"] / self.totals["records"]

    def mean_turnaround_ms(self) -> float:
        if not self.totals["records"]:
            return 0.0
        return self.totals["turnaround_ms"] / self.totals["records"]

    # ------------------------------------------------------------------
    def table(self, wall_s: Optional[float] = None) -> str:
        rows = [s.row() for s in self.summarise(wall_s)]
        if not rows:
            return "(empty ledger)"
        cols = list(rows[0].keys())
        widths = {c: max(len(c), *(len(str(r[c])) for r in rows)) for c in cols}
        head = " | ".join(c.ljust(widths[c]) for c in cols)
        sep = "-+-".join("-" * widths[c] for c in cols)
        body = "\n".join(" | ".join(str(r[c]).ljust(widths[c]) for c in cols)
                         for r in rows)
        return f"{head}\n{sep}\n{body}"
