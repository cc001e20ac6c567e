"""Admission control + per-request deadlines for the query engine
(copy of hadoop_bam_tpu/query/scheduler.py, less the flight-recorder
snapshot on a missed deadline and the admission-wait histogram: the
port has no obs/flight and no histograms in its metrics yet).

A serving path that accepts unbounded concurrent work degrades for
everyone at once; this module bounds it the way the resilience
layer expects failures to surface:

- shed load (in-flight limit hit with a full wait queue) and blown
  deadlines raise ``TransientIOError`` — the class the retry /
  circuit-breaker machinery already treats as "back off and try again",
  which is exactly what a loaded server wants clients to do;
- misconfiguration (non-positive limits, negative deadlines) raises
  ``PlanError`` — never retried, never quarantined.

Clock and sleep are injectable so tests assert exact behavior without
real time passing (the RetryPolicy convention from utils/resilient.py).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator, Optional

from hadoop_bam_torch.utils.errors import PlanError, TransientIOError
from hadoop_bam_torch.utils.metrics import METRICS


class Deadline:
    """A per-request wall budget.  ``check()`` raises ``TransientIOError``
    once the budget is spent — transient on purpose: the data is fine,
    the request may simply be retried when the system is less loaded.

    The budget is anchored at ``start`` — ENQUEUE time, by default the
    moment the Deadline is built inside ``QueryScheduler.admit`` —
    so admission wait counts against it, matching what the
    ``query.latency_s`` histogram measures end to end.  ``rebudget``
    derives a per-request override Deadline that KEEPS the anchor: a
    request that waited 0.3s for admission has 0.3s less of its own
    budget left, never a fresh one."""

    def __init__(self, seconds: Optional[float],
                 clock: Callable[[], float] = time.monotonic,
                 start: Optional[float] = None):
        if seconds is not None and seconds < 0:
            raise PlanError(f"query deadline must be >= 0, got {seconds}")
        self.seconds = seconds
        self._clock = clock
        self.t_start = clock() if start is None else start
        self._t_end = None if seconds is None else self.t_start + seconds
        self.missed = False      # set once by book_miss()

    def rebudget(self, seconds: Optional[float]) -> "Deadline":
        """A new Deadline with ``seconds`` of budget anchored at THIS
        deadline's enqueue instant (per-request overrides inside an
        admitted batch)."""
        return Deadline(seconds, clock=self._clock, start=self.t_start)

    def remaining(self) -> Optional[float]:
        if self._t_end is None:
            return None
        return self._t_end - self._clock()

    @property
    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0

    def book_miss(self) -> bool:
        """Tick ``query.deadline_misses`` ONCE for this deadline —
        idempotent, so a hard abort (``check`` raising) and the serving
        path's finally-block soft-miss accounting never double-count
        one request."""
        if self.missed:
            return False
        self.missed = True
        METRICS.count("query.deadline_misses")
        # incident-grade: a missed deadline snapshots the flight ring
        # (transition always; disk only when a dump dir is configured)
        from hadoop_bam_torch.obs import flight
        rec = flight.recorder()
        rec.record_transition("deadline", "query.deadline", "missed")
        rec.dump("deadline_miss")
        return True

    def check(self, what: str = "query") -> None:
        if self.expired:
            METRICS.count("query.deadline_exceeded")
            self.book_miss()
            raise TransientIOError(
                f"{what} exceeded its {self.seconds:g}s deadline — "
                f"retry later or raise the deadline "
                f"(config.query_deadline_s)")


class QueryScheduler:
    """Bounded in-flight admission with a bounded wait queue.

    ``admit()`` yields a ``Deadline`` for the admitted request.  When
    ``max_in_flight`` requests are already running and ``queue_depth``
    more are already waiting, admission is REJECTED immediately with
    ``TransientIOError`` (load shedding beats unbounded queueing: a
    queue that grows without bound converts overload into latency for
    every later request).  A waiter whose deadline expires before a slot
    frees also raises ``TransientIOError``."""

    def __init__(self, max_in_flight: int = 8, queue_depth: int = 32,
                 default_deadline_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 shed_retry_after_s: float = 0.1):
        if max_in_flight < 1:
            raise PlanError(
                f"query_max_in_flight must be >= 1, got {max_in_flight}")
        if queue_depth < 0:
            raise PlanError(
                f"query_queue_depth must be >= 0, got {queue_depth}")
        if default_deadline_s is not None and default_deadline_s < 0:
            raise PlanError(
                f"query_deadline_s must be >= 0, got {default_deadline_s}")
        self.max_in_flight = int(max_in_flight)
        self.queue_depth = int(queue_depth)
        self.default_deadline_s = default_deadline_s
        self.shed_retry_after_s = float(shed_retry_after_s)
        self._clock = clock
        self._cond = threading.Condition()
        self._in_flight = 0
        self._waiting = 0

    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._in_flight

    def deadline(self, seconds: Optional[float] = None) -> Deadline:
        return Deadline(self.default_deadline_s if seconds is None
                        else seconds, clock=self._clock)

    @contextlib.contextmanager
    def admit(self, deadline_s: Optional[float] = None) -> Iterator[Deadline]:
        deadline = self.deadline(deadline_s)
        with self._cond:
            if self._in_flight >= self.max_in_flight \
                    and self._waiting >= self.queue_depth:
                METRICS.count("query.rejected")
                # the retry_after hint rides the shed so transports can
                # put a concrete backoff on the wire (never a hang, and
                # never a client guessing)
                raise TransientIOError(
                    f"query admission rejected: {self._in_flight} in "
                    f"flight (limit {self.max_in_flight}) and "
                    f"{self._waiting} queued (limit {self.queue_depth}) "
                    f"— retry with backoff",
                    retry_after_s=self.shed_retry_after_s)
            self._waiting += 1
            try:
                while self._in_flight >= self.max_in_flight:
                    rem = deadline.remaining()
                    if rem is not None and rem <= 0:
                        deadline.check("query admission wait")
                    # bounded waits so an injected clock can expire the
                    # deadline without a real notification arriving
                    self._cond.wait(0.05 if rem is None
                                    else min(0.05, max(rem, 0.001)))
            finally:
                self._waiting -= 1
            self._in_flight += 1
        METRICS.count("query.admitted")
        try:
            yield deadline
        finally:
            with self._cond:
                self._in_flight -= 1
                self._cond.notify()
