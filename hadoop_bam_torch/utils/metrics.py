"""Named counters (the counter part of hadoop_bam_tpu/utils/metrics.py).

The resilience layer ticks the reference's counter names, so a test can
read the same name from both packages:

    pipeline.bad_spans, pipeline.transient_retries, pipeline.corrupt_spans,
    pipeline.span_demotions, resilience.demotions, resilience.heals,
    resilience.quarantine_gate_shed, chaos.point_faults,
    chaos.<point>.<kind>, chaos.injected_faults, io.read_retries

Timers, spans, histograms and context scoping are not ported.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict


class Metrics:
    """Thread-safe process-wide counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def get(self, name: str) -> int:
        """One counter, 0 when it never ticked."""
        with self._lock:
            return self.counters.get(name, 0)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """A consistent copy of every counter."""
        with self._lock:
            return {"counters": dict(self.counters)}

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()


METRICS = Metrics()
