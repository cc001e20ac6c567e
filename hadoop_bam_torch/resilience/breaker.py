"""Half-open circuit breakers with decayed failure-rate windows
(copy of hadoop_bam_tpu/resilience/breaker.py).

The reusable state machine every adaptive policy in ``resilience/``
shares (the demotion ladder's plane domains, the quarantine circuit) --
the classic three states:

- CLOSED: traffic flows; failures accumulate in a DECAYED window (an
  old burst of faults ages out instead of counting forever), and the
  breaker OPENS once the windowed failure count crosses the threshold;
- OPEN: traffic is refused (``allow() == False``) until ``cooldown_s``
  elapses, at which point the breaker turns HALF_OPEN;
- HALF_OPEN: a bounded number of PROBE calls are allowed through; one
  recorded success closes the breaker (and clears the window), one
  recorded failure re-opens it and re-arms the cooldown.

Clock is injectable (the ``RetryPolicy`` convention from
``utils/resilient.py``) so tests drive transitions without real time.
All methods are thread-safe: decode pool workers and the driver thread
consult the same breakers.

Counters ``resilience.breaker_open`` / ``resilience.breaker_half_open`` /
``resilience.breaker_closed`` tick on transitions; each transition is
a zero-width ``resilience.breaker_state`` span and a flight-recorder
entry, and an OPEN dumps the flight recorder (when a dump directory is
configured).
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from hadoop_bam_torch.obs import flight
from hadoop_bam_torch.utils.metrics import METRICS

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class DecayingWindow:
    """Exponentially-decayed event counter: ``add()`` records an event
    NOW, ``value()`` reads the count with events older than ``window_s``
    contributing e^-1 or less.  O(1) state (a single decayed
    accumulator), so a registry can hold one per fault domain."""

    def __init__(self, window_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = max(1e-6, float(window_s))
        self._clock = clock
        self._value = 0.0
        self._t_last = clock()

    def _decay(self) -> None:
        now = self._clock()
        dt = max(0.0, now - self._t_last)
        if dt:
            import math
            self._value *= math.exp(-dt / self.window_s)
            self._t_last = now

    def add(self, n: float = 1.0) -> float:
        self._decay()
        self._value += n
        return self._value

    def value(self) -> float:
        self._decay()
        return self._value

    def reset(self) -> None:
        self._value = 0.0
        self._t_last = self._clock()


class CircuitBreaker:
    """The closed/open/half-open state machine (module docstring).

    ``allow()`` is the gate call sites make BEFORE doing work; in
    HALF_OPEN it consumes one of the ``half_open_probes`` probe slots,
    so the caller that gets ``True`` is expected to report the outcome
    with ``record_success`` / ``record_failure``."""

    def __init__(self, failure_threshold: float = 3.0,
                 window_s: float = 30.0, cooldown_s: float = 5.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = ""):
        self.failure_threshold = float(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._window = DecayingWindow(window_s, clock)
        self._opened_at = 0.0
        self._half_open_at = 0.0
        self._probes = 0
        self.opened_total = 0      # times this breaker tripped (tests/health)
        self.healed_total = 0      # half-open probes that closed it

    # -- internals (lock held) ----------------------------------------------

    def _transition(self, state: str) -> None:
        self._state = state
        METRICS.count(f"resilience.breaker_{state}")
        with METRICS.span("resilience.breaker_state",
                          breaker=self.name, state=state):
            pass
        rec = flight.recorder()
        rec.record_transition("breaker", self.name, state)
        if state == OPEN:
            rec.dump(f"breaker_open:{self.name or 'unnamed'}")

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.cooldown_s:
            self._probes = 0
            self._half_open_at = self._clock()
            self._transition(HALF_OPEN)
        elif self._state == HALF_OPEN and \
                self._probes >= self.half_open_probes and \
                self._clock() - self._half_open_at >= self.cooldown_s:
            # an exhausted probe budget whose outcomes were never
            # reported (a probe-taker that died mid-flight) re-arms
            # after another cooldown — the breaker must never wedge in
            # HALF_OPEN with no way forward
            self._probes = 0
            self._half_open_at = self._clock()

    # -- public surface ------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May the caller do the protected work right now?  (Consumes a
        probe slot in HALF_OPEN.)"""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and \
                    self._probes < self.half_open_probes:
                self._probes += 1
                return True
            return False

    def retry_after_s(self) -> float:
        """How long until the next state change could let work through —
        the ``retry_after_s`` hint shed responses carry."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))

    def record_success(self) -> None:
        # successes in CLOSED do not actively drain the window (decay
        # does); in HALF_OPEN — including an OPEN breaker whose cooldown
        # just elapsed — one success IS the passed probe and closes
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self.healed_total += 1
                self._window.reset()
                self._transition(CLOSED)

    def record_failure(self, weight: float = 1.0) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == HALF_OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN)
                self.opened_total += 1
                return
            rate = self._window.add(weight)
            # half-event tolerance: N failures spread over a fraction of
            # the window decay to just under N (2.97 for "3 quick
            # failures"), and a strict >= would quietly turn threshold 3
            # into threshold 4 — windowed mass within half an event of
            # the threshold counts as reaching it
            if self._state == CLOSED and \
                    rate >= self.failure_threshold - 0.5:
                self._opened_at = self._clock()
                self._transition(OPEN)
                self.opened_total += 1

    def force_open(self) -> None:
        """Trip immediately (the quarantine circuit uses this: one
        tripped run IS the threshold)."""
        with self._lock:
            if self._state != OPEN:
                self._opened_at = self._clock()
                self._transition(OPEN)
                self.opened_total += 1
            else:
                self._opened_at = self._clock()

    def failure_rate(self) -> float:
        with self._lock:
            return self._window.value()

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {"state": self._state,
                    "failure_rate": round(self._window.value(), 4),
                    "opened_total": self.opened_total,
                    "healed_total": self.healed_total,
                    "retry_after_s": round(
                        max(0.0, self.cooldown_s
                            - (self._clock() - self._opened_at))
                        if self._state == OPEN else 0.0, 4)}
