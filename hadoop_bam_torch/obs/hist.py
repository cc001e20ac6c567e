"""Log-bucketed latency histograms with percentiles (trimmed copy of
hadoop_bam_tpu/obs/hist.py: recording and percentile reads; merging,
serialization and the summary tuple are not ported).

Bucket boundaries are powers of ``2**(1/4)`` (~19% relative width), so
nine decades of latency fit in a small sparse dict; a percentile reads
the geometric midpoint of the bucket holding its rank (error at most
half a bucket), clamped to the exact observed min and max.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

# 2**(1/4) bucket growth: index = round(4 * log2(value))
_LOG2_SCALE = 4.0
# values at or below this clamp into the bottom bucket
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

    def record(self, value: float, n: int = 1) -> None:
        i = self.bucket_index(value)
        self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += n
        v = float(value)
        self.total += v * n
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` (0..100); 0.0 when empty."""
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
