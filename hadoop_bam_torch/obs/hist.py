"""Log-bucketed, mergeable latency/size histograms with percentiles
(copy of hadoop_bam_tpu/obs/hist.py).

Flat counters and union-wall timers (utils/metrics.py) answer "how much
work" and "how long did the stage occupy the wall"; a serving system
also needs DISTRIBUTIONS — the p99 a deadline contract is written
against is invisible to both.  This histogram is built for exactly the
three properties the mesh needs:

- **log-bucketed**: bucket boundaries are powers of ``2**(1/4)``
  (~19% relative width), so nine decades of latency (ns to minutes) or
  size (bytes to TB) fit in a small sparse dict with bounded relative
  quantile error;
- **mergeable**: two histograms over the same bucket grid merge by
  bucket-count addition — associative and commutative, so per-host
  histograms allgather and merge into one mesh-wide distribution in any
  order (``tests/test_obs.py`` pins associativity);
- **cheap to record**: one ``math.frexp``-free log, one dict increment,
  no allocation on the hot path.

Quantiles are read as the geometric midpoint of the bucket holding the
rank, which bounds the error at half a bucket (~10%) — plenty for p50/
p95/p99 reporting, and exact min/max ride along for the tails.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

# 2**(1/4) bucket growth: index = round(4 * log2(value))
_LOG2_SCALE = 4.0
# values at or below this clamp into the bottom bucket (1 ns / 1 byte
# grain is far below anything the pipeline measures)
_MIN_VALUE = 1e-9


class Histogram:
    """Sparse log-bucketed histogram of positive values."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    @staticmethod
    def bucket_index(value: float) -> int:
        v = max(float(value), _MIN_VALUE)
        return int(round(_LOG2_SCALE * math.log2(v)))

    @staticmethod
    def bucket_bounds(index: int) -> "tuple[float, float]":
        """(lower, upper) value bounds of one bucket index."""
        half = 0.5 / _LOG2_SCALE
        return (2.0 ** (index / _LOG2_SCALE - half),
                2.0 ** (index / _LOG2_SCALE + half))

    def record(self, value: float, n: int = 1) -> None:
        i = self.bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += n
        self.total += float(value) * n
        v = float(value)
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    # -- reading -------------------------------------------------------------

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` (0..100): the geometric midpoint of
        the bucket containing that rank; 0.0 on an empty histogram.  The
        exact observed min/max clamp the extremes so p0/p100 never report
        outside the recorded range."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(self.count * min(max(p, 0.0), 100.0)
                                / 100.0))
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= rank:
                mid = 2.0 ** (i / _LOG2_SCALE)
                lo = self.min if self.min is not None else mid
                hi = self.max if self.max is not None else mid
                return min(max(mid, lo), hi)
        return self.max or 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        """The reporting tuple every consumer wants: count/mean/p50/p95/
        p99/max."""
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99), "max": self.max or 0.0}

    # -- merging / serialization --------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        """In-place bucket-count merge (associative + commutative — the
        property the mesh-wide allgather reduction depends on)."""
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += other.count
        self.total += other.total
        for attr, pick in (("min", min), ("max", max)):
            a, b = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, b if a is None else
                    (a if b is None else pick(a, b)))
        return self

    @classmethod
    def merged(cls, parts: Iterable["Histogram"]) -> "Histogram":
        out = cls()
        for h in parts:
            out.merge(h)
        return out

    def to_dict(self) -> Dict[str, object]:
        return {"buckets": {str(i): n for i, n in
                            sorted(self.buckets.items())},
                "count": self.count, "total": self.total,
                "min": self.min, "max": self.max}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Histogram":
        h = cls()
        h.buckets = {int(i): int(n)
                     for i, n in dict(d.get("buckets", {})).items()}
        h.count = int(d.get("count", 0))
        h.total = float(d.get("total", 0.0))
        h.min = None if d.get("min") is None else float(d["min"])
        h.max = None if d.get("max") is None else float(d["max"])
        return h
