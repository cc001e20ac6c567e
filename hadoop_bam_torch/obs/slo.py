"""Declarative SLOs with multi-window burn-rate accounting (copy of
hadoop_bam_tpu/obs/slo.py).

A deadline knob says what ONE request was promised; an SLO says what
the SERVICE promised over time — "99% of requests under 250ms" — and
the operationally useful signal is the BURN RATE: how fast the error
budget (the allowed 1%) is being spent.  One rate over one window is
either too twitchy (pages on a blip) or too slow (a real regression
burns for an hour unseen); the standard fix is multi-window alerting —
a short "fast" window that reacts in minutes paired with a long "slow"
window that confirms sustained burn — and that is what this module
computes, fed entirely from the log-bucketed histograms and counters
the obs layer already records (``obs/hist.py``; no second measurement
path).

Mechanics: the engine periodically snapshots each objective's
(total, bad) event totals — for a latency objective, "bad" is the
histogram mass in buckets strictly above the threshold's bucket; for an
error-rate objective, a (bad counter, total counter) pair.  The burn
rate over a window is::

    burn = (bad_in_window / events_in_window) / (1 - target)

i.e. 1.0 means the budget is being spent exactly at the rate that
exhausts it by the period's end; 14.4 over a 5-minute window is the
classic "2% of a 30-day budget in one hour" page.  Windows with fewer
than ``min_events`` events report 0.0 — a cold tenant's first slow
request must not page anyone.

Consumers: Prometheus series (``prometheus_lines``: one
``hbam_slo_burn_rate{slo=...,window=...}`` gauge per objective/window),
the serve health document, ``hbam top``, and — closing the loop —
``serve/tenancy.py`` sheds BATCH-priority admissions for a tenant whose
fast window is burning (interactive traffic keeps flowing; backfill is
the load that can wait).

Clock is injectable (the ``utils/resilient.py`` convention) so tests
drive the regression-flips-fast-before-slow contract without real time.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from hadoop_bam_torch.obs.hist import Histogram


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declared objective.

    ``kind="latency"``: ``source`` names a Metrics histogram; an event
    is bad when it landed in a bucket strictly above ``threshold_s``'s.
    ``kind="errors"``: ``source`` names the TOTAL counter and
    ``bad_source`` the error counter.
    """

    name: str                        # "latency/<tenant>" etc.
    source: str                      # histogram or total-counter key
    target: float = 0.99             # promised good fraction
    kind: str = "latency"            # "latency" | "errors"
    threshold_s: float = 1.0         # latency objective bound
    bad_source: str = ""             # errors kind: the error counter


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    label: str
    seconds: float
    threshold: float                 # burn rate at/above which it flips


# the classic fast/slow pairing: a fast page window and a slow
# confirmation window (thresholds from the 30d-budget alerting table)
DEFAULT_WINDOWS = (BurnWindow("fast", 300.0, 14.4),
                   BurnWindow("slow", 3600.0, 3.0))

_MAX_OBJECTIVES = 256            # LRU bound (arbitrary tenant strings)


class SloEngine:
    """Objectives + snapshot history + burn computation (module doc)."""

    def __init__(self, windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS,
                 clock: Callable[[], float] = time.monotonic,
                 tick_s: float = 10.0, min_events: int = 64):
        self.windows = tuple(windows)
        self.tick_s = max(0.0, float(tick_s))
        self.min_events = max(1, int(min_events))
        self._clock = clock
        self._lock = threading.Lock()
        self._objectives: "OrderedDict[str, SloObjective]" = OrderedDict()
        # snapshot history: (t, {objective: (total, bad)}); bounded so a
        # long-lived server cannot grow it (the SV801 discipline) — the
        # slow window at the tick cadence needs far fewer than this
        self._snaps: deque = deque(maxlen=4096)
        self._last_tick: Optional[float] = None

    # -- objectives ----------------------------------------------------------

    def add(self, obj: SloObjective) -> SloObjective:
        """Install (or refresh) one objective; LRU-bounded so per-tenant
        objectives over arbitrary tenant strings cannot grow forever."""
        with self._lock:
            if obj.name in self._objectives:
                self._objectives.move_to_end(obj.name)
            else:
                while len(self._objectives) >= _MAX_OBJECTIVES:
                    self._objectives.popitem(last=False)
            self._objectives[obj.name] = obj
            return obj

    def ensure_latency(self, name: str, hist: str, threshold_s: float,
                       target: float) -> SloObjective:
        """Idempotent per-tenant install: an existing objective of this
        name is kept (and LRU-refreshed), not re-declared."""
        with self._lock:
            obj = self._objectives.get(name)
            if obj is not None:
                self._objectives.move_to_end(name)
                return obj
        return self.add(SloObjective(name=name, source=hist,
                                     threshold_s=float(threshold_s),
                                     target=float(target)))

    def objectives(self) -> List[SloObjective]:
        with self._lock:
            return list(self._objectives.values())

    # -- totals from the live metrics ----------------------------------------

    @staticmethod
    def _latency_totals(d: Dict, obj: SloObjective) -> Tuple[int, int]:
        h = dict(d.get("histograms", {})).get(obj.source)
        if not isinstance(h, dict) or "buckets" not in h:
            return 0, 0
        cutoff = Histogram.bucket_index(obj.threshold_s)
        total = 0
        bad = 0
        for idx, n in dict(h["buckets"]).items():
            total += int(n)
            if int(idx) > cutoff:
                bad += int(n)
        return total, bad

    def _totals(self, metrics_dict: Dict,
                objs: Optional[List[SloObjective]] = None
                ) -> Dict[str, Tuple[int, int]]:
        out: Dict[str, Tuple[int, int]] = {}
        counters = dict(metrics_dict.get("counters", {}))
        for obj in (self.objectives() if objs is None else objs):
            if obj.kind == "errors":
                out[obj.name] = (int(counters.get(obj.source, 0)),
                                 int(counters.get(obj.bad_source, 0)))
            else:
                out[obj.name] = self._latency_totals(metrics_dict, obj)
        return out

    @staticmethod
    def _metrics_dict(metrics=None,
                      objs: Optional[List[SloObjective]] = None) -> Dict:
        if isinstance(metrics, dict):
            return metrics
        if metrics is None:
            from hadoop_bam_torch.utils.metrics import base_metrics
            metrics = base_metrics()
        if objs is not None and hasattr(metrics, "hist_dict"):
            # targeted extraction — the admission-path shape: copy only
            # the named objectives' sources instead of serializing the
            # whole instance (to_dict under the Metrics lock is O(all
            # keys) and would run per batch admission)
            counters: Dict[str, int] = {}
            hists: Dict[str, object] = {}
            for obj in objs:
                if obj.kind == "errors":
                    counters[obj.source] = metrics.get(obj.source)
                    counters[obj.bad_source] = metrics.get(
                        obj.bad_source)
                else:
                    hists[obj.source] = metrics.hist_dict(obj.source)
            return {"counters": counters, "histograms": hists}
        return metrics.to_dict()

    # -- ticking + burn ------------------------------------------------------

    def tick(self, metrics=None, now: Optional[float] = None,
             force: bool = False) -> bool:
        """Snapshot the objectives' totals (rate-limited to one per
        ``tick_s`` unless forced).  Callers sprinkle this on request
        completion paths — it is the whole scheduling model, no thread."""
        now = self._clock() if now is None else now
        with self._lock:
            if not force and self._last_tick is not None \
                    and now - self._last_tick < self.tick_s:
                return False
            self._last_tick = now
        objs = self.objectives()
        totals = self._totals(self._metrics_dict(metrics, objs), objs)
        with self._lock:
            self._snaps.append((now, totals))
        return True

    def _baseline(self, name: str, now: float, window_s: float
                  ) -> Optional[Tuple[int, int]]:
        """The snapshot totals at (or just before) the window start —
        newest snapshot old enough to cover the window; the oldest
        available when history is shorter than the window."""
        with self._lock:
            snaps = list(self._snaps)
        best = None
        for t, totals in snaps:
            if name not in totals:
                continue
            if t <= now - window_s:
                best = totals[name]       # newest one old enough wins
            elif best is None:
                return totals[name]       # history shorter than window
        return best

    def burn_rates(self, metrics=None, now: Optional[float] = None,
                   names: Optional[List[str]] = None
                   ) -> Dict[str, Dict[str, float]]:
        """{objective: {window_label: burn}} against the live totals.
        ``names`` restricts the computation (the admission-path shape:
        one tenant's objective, not every objective's histogram)."""
        now = self._clock() if now is None else now
        objs = self.objectives() if names is None else \
            [o for o in self.objectives() if o.name in set(names)]
        live = self._totals(self._metrics_dict(metrics, objs), objs)
        out: Dict[str, Dict[str, float]] = {}
        for obj in objs:
            total, bad = live.get(obj.name, (0, 0))
            budget = max(1e-9, 1.0 - float(obj.target))
            rates: Dict[str, float] = {}
            for w in self.windows:
                base = self._baseline(obj.name, now, w.seconds)
                b_total, b_bad = base if base is not None else (0, 0)
                d_total = total - b_total
                d_bad = bad - b_bad
                if d_total < self.min_events or d_total <= 0:
                    rates[w.label] = 0.0
                else:
                    rates[w.label] = round(
                        (d_bad / d_total) / budget, 4)
            out[obj.name] = rates
        return out

    def burning(self, name: str, metrics=None,
                now: Optional[float] = None) -> Optional[str]:
        """The label of the first window (fast first) whose burn rate
        is at/over its threshold for ``name``; None when healthy or the
        objective is unknown."""
        with self._lock:
            if name not in self._objectives:
                return None
        rates = self.burn_rates(metrics, now=now, names=[name]).get(name)
        if not rates:
            return None
        for w in self.windows:
            if rates.get(w.label, 0.0) >= w.threshold:
                return w.label
        return None

    # -- export --------------------------------------------------------------

    def prometheus_lines(self, metrics=None,
                         now: Optional[float] = None) -> List[str]:
        """``hbam_slo_burn_rate{slo="...",window="..."}`` gauge series
        (appended to the ``prometheus_text`` exposition by the serve
        metrics op and ``hbam top``)."""
        rates = self.burn_rates(metrics, now=now)
        if not rates:
            return []
        lines = ["# TYPE hbam_slo_burn_rate gauge"]
        for name in sorted(rates):
            for w in self.windows:
                lines.append(
                    f'hbam_slo_burn_rate{{slo="{name}",'
                    f'window="{w.label}"}} {rates[name][w.label]}')
        return lines

    def summary(self, metrics=None,
                now: Optional[float] = None) -> Dict[str, object]:
        """Health-surface view: burn rates plus which window (if any)
        is burning per objective."""
        rates = self.burn_rates(metrics, now=now)
        out: Dict[str, object] = {}
        for name, r in rates.items():
            burning = None
            for w in self.windows:
                if r.get(w.label, 0.0) >= w.threshold:
                    burning = w.label
                    break
            out[name] = {"burn": r, "burning": burning}
        return out
