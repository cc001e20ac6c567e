"""Straggler defence: decaying latency tracking -> soft deadlines (copy
of hadoop_bam_tpu/jobs/speculate.py, less ``for_peer_fetch``: no path of
the port fetches from peers).

A span decode is idempotent and free of side effects, so racing two
copies of a slow one is safe (MapReduce's speculative execution).  A
unit is slow when it outlives the job's own soft deadline: the p95 of a
decaying histogram of completed unit durations times
``straggler_multiplier``, floored at ``straggler_min_s``.  Every
``decay_every`` observations the bucket counts halve, so the deadline
follows the recent latency regime; no deadline exists before
``min_samples`` completions (the first units carry warm-up noise).
"""
from __future__ import annotations

import threading
from typing import Optional

from hadoop_bam_torch.obs.hist import Histogram


class UnitLatency:
    """Thread-safe decaying latency histogram with a soft-deadline read.
    One instance per window drive (``iter_windowed``)."""

    def __init__(self, *, multiplier: float = 4.0, min_s: float = 0.5,
                 min_samples: int = 16, decay_every: int = 256):
        self.multiplier = float(multiplier)
        self.min_s = float(min_s)
        self.min_samples = int(min_samples)
        self.decay_every = max(2, int(decay_every))
        self.hist = Histogram()
        self._seen = 0
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, config) -> "UnitLatency":
        return cls(
            multiplier=float(getattr(config, "straggler_multiplier", 4.0)),
            min_s=float(getattr(config, "straggler_min_s", 0.5)))

    def observe(self, seconds: float) -> None:
        with self._lock:
            self.hist.record(max(float(seconds), 0.0))
            self._seen += 1
            if self._seen % self.decay_every == 0:
                self._decay()

    def _decay(self) -> None:
        # halve every bucket (dropping emptied ones); min/max stay as
        # observed extremes (they only clamp percentile reads)
        h = self.hist
        h.buckets = {i: n // 2 for i, n in h.buckets.items() if n // 2}
        h.count = sum(h.buckets.values())
        h.total /= 2.0

    def soft_deadline_s(self) -> Optional[float]:
        """Seconds a unit may run before it counts as a straggler; None
        until enough completions have been observed."""
        with self._lock:
            if self._seen < self.min_samples or not self.hist.count:
                return None
            return max(self.min_s, self.hist.percentile(95)
                       * self.multiplier)
