"""Mergeable streaming quantile sketch (DDSketch-style log buckets).

The fleet's scaling story (ROADMAP: "from 8 replicas to city scale")
needs percentiles that do NOT require keeping every observation: a
per-frame ledger row per served frame is O(fleet x time) host memory,
and a hierarchical gateway tree can only aggregate telemetry it can
*merge*.  This sketch is the standard answer (Masson et al., "DDSketch:
a fast and fully-mergeable quantile sketch with relative-error
guarantees", VLDB 2019), in pure stdlib Python:

  * values land in logarithmic buckets: bucket ``i`` covers
    ``(gamma^(i-1), gamma^i]`` with ``gamma = (1+alpha)/(1-alpha)``, so
    reporting the bucket's log-midpoint ``2*gamma^i/(gamma+1)`` is
    within relative error ``alpha`` of ANY value in the bucket;
  * quantile queries walk the cumulative bucket counts — every returned
    quantile ``q`` of the observed multiset is within ``alpha`` relative
    error of the exact rank statistic (the guarantee the telemetry
    parity tests assert);
  * two sketches with the same ``alpha`` merge by adding bucket counts —
    ``merge(a, b)`` is *exactly* the sketch of the concatenated streams,
    so per-replica sketches roll up into fleet (and per-cell into
    region) percentiles loss-free relative to one global sketch;
  * memory is O(buckets): ~``log(max/min)/log(gamma)`` occupied buckets
    (a few hundred for ms-scale latencies at alpha=1%), hard-capped at
    ``max_buckets`` by collapsing the lowest buckets into the floor
    bucket (the DDSketch collapse rule — tail quantiles, the ones that
    matter, stay exact-to-alpha).

Values <= ``min_value`` (default 1e-9) land in an exact zero bucket —
skip rates of 0.0 and unmeasured TTFTs must not smear into the log grid.
Only nonnegative values are accepted: every fleet metric (latency ms,
skip rate, energy J) is nonnegative by construction, and rejecting
negatives loudly beats silently folding them to zero.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence


class QuantileSketch:
    """Fixed-relative-error streaming quantiles over nonnegative values."""

    def __init__(self, rel_err: float = 0.01, *, min_value: float = 1e-9,
                 max_buckets: int = 2048) -> None:
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        if max_buckets < 2:
            raise ValueError(f"max_buckets must be >= 2, got {max_buckets}")
        self.rel_err = rel_err
        self.gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._ln_gamma = math.log(self.gamma)
        self.min_value = min_value
        self.max_buckets = max_buckets
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------
    def _key(self, x: float) -> int:
        return math.ceil(math.log(x) / self._ln_gamma)

    def add(self, x: float, count: int = 1) -> None:
        x = float(x)
        if x < 0.0 or math.isnan(x):
            raise ValueError(f"sketch accepts nonnegative values, got {x}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self.count += count
        self.sum += x * count
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)
        if x <= self.min_value:
            self.zero_count += count
            return
        key = self._key(x)
        self.buckets[key] = self.buckets.get(key, 0) + count
        if len(self.buckets) > self.max_buckets:
            self._collapse()

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def _collapse(self) -> None:
        """Fold the lowest buckets into the floor bucket until the cap
        holds.  Low buckets hold the smallest values, so p95/p99 stay
        within the alpha guarantee; only deep-low quantiles coarsen."""
        keys = sorted(self.buckets)
        while len(self.buckets) > self.max_buckets:
            lo = keys.pop(0)
            self.buckets[keys[0]] = (self.buckets.get(keys[0], 0)
                                     + self.buckets.pop(lo))

    # ------------------------------------------------------------------
    # merge (the fleet-aggregation primitive)
    # ------------------------------------------------------------------
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch in place (bucket-count sums).
        Requires identical ``rel_err`` — merging across grids would void
        the error guarantee.  Returns self for chaining."""
        if other.rel_err != self.rel_err:
            raise ValueError(
                f"cannot merge sketches with different rel_err: "
                f"{self.rel_err} != {other.rel_err}")
        for key, n in other.buckets.items():
            self.buckets[key] = self.buckets.get(key, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        for attr, pick in (("min", min), ("max", max)):
            a, b = getattr(self, attr), getattr(other, attr)
            if b is not None:
                setattr(self, attr, b if a is None else pick(a, b))
        if len(self.buckets) > self.max_buckets:
            self._collapse()
        return self

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def _rank_value(self, i: int) -> float:
        """Estimate of the ``i``'th order statistic (0-indexed).  Within
        ``rel_err`` relative error of the true value: the bucket midpoint
        is within ``rel_err`` of anything in the bucket, and clamping to
        the tracked exact [min, max] only ever moves the estimate toward
        the true value (and makes the extreme ranks exact)."""
        if i < self.zero_count:
            return 0.0
        cum = self.zero_count
        for key in sorted(self.buckets):
            cum += self.buckets[key]
            if cum > i:
                est = 2.0 * self.gamma ** key / (self.gamma + 1.0)
                return min(max(est, self.min or 0.0), self.max or est)
        return self.max or 0.0

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 100] (percentile convention).
        0.0 on an empty sketch.

        Uses the same linear-interpolation-between-order-statistics
        convention as ``core.telemetry.percentile`` (numpy's default):
        both adjacent rank estimates are within ``rel_err`` relative
        error of their true order statistics, and a convex combination
        of nonnegative values preserves a shared relative-error bound —
        so the result is within ``rel_err`` of the exact interpolated
        percentile, which is what the ledger parity tests assert."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"q must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * (self.count - 1)
        lo = math.floor(rank)
        hi = min(lo + 1, self.count - 1)
        v_lo = self._rank_value(lo)
        if hi == lo or rank == lo:
            return v_lo
        return v_lo + (self._rank_value(hi) - v_lo) * (rank - lo)

    def quantiles(self, qs: Sequence[float]) -> Dict[float, float]:
        return {q: self.quantile(q) for q in qs}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"QuantileSketch(rel_err={self.rel_err}, count={self.count}, "
                f"buckets={len(self.buckets)}, sum={self.sum:.6g})")

    # ------------------------------------------------------------------
    # serialisation (status surfaces / artifacts)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"rel_err": self.rel_err, "count": self.count,
                "sum": self.sum, "zero_count": self.zero_count,
                "min": self.min, "max": self.max,
                "buckets": {str(k): v for k, v in self.buckets.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "QuantileSketch":
        sk = cls(rel_err=d["rel_err"])
        sk.count = int(d["count"])
        sk.sum = float(d["sum"])
        sk.zero_count = int(d["zero_count"])
        sk.min = d["min"]
        sk.max = d["max"]
        sk.buckets = {int(k): int(v) for k, v in d["buckets"].items()}
        return sk
