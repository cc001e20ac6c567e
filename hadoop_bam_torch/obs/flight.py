"""Flight recorder: an always-on bounded ring of what JUST happened
(copy of hadoop_bam_tpu/obs/flight.py).

A trace ring (the reference's ``obs/trace.py``, not ported yet) is
opt-in and sized for whole-run export; production incidents need the
opposite shape — a small,
ALWAYS-recording ring whose contents are dumped automatically at the
moment something goes wrong, like an aircraft FDR.  The recorder keeps:

- the last N span completions (name, duration, thread, trace_id,
  trimmed args) fed by ``Metrics.span`` / ``Metrics.add_wall``;
- the last M policy transitions (breaker state flips, decode-plane
  demotions, deadline misses) fed by ``resilience/`` and the query
  scheduler;
- counter snapshots, delta'd against the previous dump, so a dump shows
  what moved since the system was last healthy.

Dumps trigger automatically on: ``CircuitBreaker`` OPEN (including the
quarantine circuit's force-open), a decode-plane demotion, a deadline
miss, and an unhandled serve/CLI error.  They land as redacted JSON in
a rotation-capped directory (config ``flight_dump_dir`` — None keeps
the ring memory-only, which is the default outside ``hbam serve``), and
the latest ring state is also attached to the serve transport's
``{"op": "health"}`` document, so a degraded server hands its recent
history to whoever asks.

Redaction: arg values are stringified and truncated, and values of
keys that look like credentials are dropped — dumps are written for
operators and may leave the machine.

Cost discipline: recording is one ``deque.append`` of a prebuilt tuple
(``maxlen`` deques drop the oldest atomically; no lock on the record
path), so the always-on ring stays inside the ``obs_overhead_pct``
bench bar.  All dump I/O failures are swallowed — the recorder must
never turn an incident into a second incident.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from hadoop_bam_torch.obs.context import current_trace_id

_SECRET_MARKERS = ("secret", "token", "password", "credential", "apikey")
_REDACT_MAX_STR = 160

# span entry: (wall_ts, name, dur_s, thread_name, trace_id, args_or_None)
# transition entry: (wall_ts, kind, name, state, trace_id)


def redact_value(v) -> object:
    """Dump-safe rendering of one arg value: scalars pass through,
    everything else is stringified and truncated."""
    if isinstance(v, (int, float, bool)) or v is None:
        return v
    s = v if isinstance(v, str) else repr(v)
    if len(s) > _REDACT_MAX_STR:
        s = s[:_REDACT_MAX_STR] + f"...(+{len(s) - _REDACT_MAX_STR})"
    return s


def redact_args(args: Optional[dict]) -> Optional[dict]:
    if not args:
        return None
    out = {}
    for k, v in args.items():
        ks = str(k)
        if any(m in ks.lower() for m in _SECRET_MARKERS):
            out[ks] = "[redacted]"
        else:
            out[ks] = redact_value(v)
    return out


class FlightRecorder:
    """The bounded always-on ring (module docstring)."""

    def __init__(self, capacity: int = 512, transitions: int = 128):
        self._spans: deque = deque(maxlen=max(16, int(capacity)))
        self._transitions: deque = deque(maxlen=max(16, int(transitions)))
        self._lock = threading.Lock()         # dump/configure only
        self._dump_dir: Optional[str] = None
        self._dump_cap = 16
        self._last_counters: Dict[str, int] = {}
        self.dumps_written = 0
        self.dump_errors = 0
        self.last_dump_path: Optional[str] = None

    # -- recording (lock-free hot path) --------------------------------------

    def record_span(self, name: str, dur: float,
                    args: Optional[dict] = None,
                    trace_id: Optional[str] = None) -> None:
        if trace_id is None:
            trace_id = current_trace_id()
        self._spans.append((time.time(), name, dur,
                            threading.current_thread().name, trace_id,
                            args))

    def record_transition(self, kind: str, name: str, state: str,
                          trace_id: Optional[str] = None) -> None:
        if trace_id is None:
            trace_id = current_trace_id()
        self._transitions.append((time.time(), kind, name, state,
                                  trace_id))

    # -- configuration --------------------------------------------------------

    def configure(self, dump_dir: Optional[str] = "__keep__",
                  dump_cap: Optional[int] = None) -> None:
        """Set the dump directory (None disables disk dumps) and/or the
        rotation cap.  Called by ``hbam serve`` startup from config; the
        sentinel default leaves the directory unchanged."""
        with self._lock:
            if dump_dir != "__keep__":
                self._dump_dir = dump_dir
            if dump_cap is not None:
                self._dump_cap = max(1, int(dump_cap))

    @property
    def dump_dir(self) -> Optional[str]:
        return self._dump_dir

    # -- reading / dumping ----------------------------------------------------

    def snapshot(self, reason: str = "",
                 error: Optional[str] = None) -> Dict[str, object]:
        """The redacted ring state as one JSON-able document.  Counters
        come from the PROCESS-GLOBAL metrics, not the current context:
        incident dumps fire on serving threads that may be running under
        a client's isolated MetricsContext, and the ops question is
        "what moved in the process", not in one request's view."""
        from hadoop_bam_torch.utils.metrics import base_metrics

        spans = [{"ts": round(ts, 6), "name": n, "dur_s": round(d, 6),
                  "thread": t, "trace": tid,
                  "args": redact_args(a)}
                 for ts, n, d, t, tid, a in list(self._spans)]
        transitions = [{"ts": round(ts, 6), "kind": k, "name": n,
                        "state": s, "trace": tid}
                       for ts, k, n, s, tid in list(self._transitions)]
        counters = dict(base_metrics().snapshot()["counters"])
        with self._lock:
            delta = {k: v - self._last_counters.get(k, 0)
                     for k, v in counters.items()
                     if v != self._last_counters.get(k, 0)}
        doc: Dict[str, object] = {
            "reason": reason,
            "ts": round(time.time(), 6),
            "trace": current_trace_id(),
            "transitions": transitions,
            "spans": spans,
            "counters": counters,
            "counters_delta_since_last_dump": delta,
        }
        if error is not None:
            doc["error"] = redact_value(error)
        return doc

    def stats(self) -> Dict[str, object]:
        """The health-surface summary (cheap; no span payloads)."""
        recent = [{"kind": k, "name": n, "state": s, "trace": tid}
                  for _ts, k, n, s, tid in list(self._transitions)[-8:]]
        return {"spans_buffered": len(self._spans),
                "transitions_buffered": len(self._transitions),
                "dumps_written": self.dumps_written,
                "last_dump": self.last_dump_path,
                "recent_transitions": recent}

    def dump(self, reason: str,
             error: Optional[str] = None) -> Optional[str]:
        """Write one snapshot to the dump directory (rotation-capped);
        returns the path, or None when disk dumping is disabled.  Never
        raises — an incident dump must not become a second incident."""
        if self._dump_dir is None:
            return None
        try:
            doc = self.snapshot(reason=reason, error=error)
            with self._lock:
                os.makedirs(self._dump_dir, exist_ok=True)
                name = (f"flight-{int(time.time() * 1000):013d}-"
                        f"{self.dumps_written:04d}-"
                        f"{_safe_reason(reason)}.json")
                path = os.path.join(self._dump_dir, name)
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
                self.dumps_written += 1
                self.last_dump_path = path
                self._last_counters = dict(doc["counters"])
                self._rotate_locked()
        except Exception:  # noqa: BLE001 — never break the caller
            self.dump_errors += 1
            return None
        from hadoop_bam_torch.utils.metrics import METRICS
        METRICS.count("obs.flight_dumps")
        return path

    def _rotate_locked(self) -> None:
        """Keep at most ``_dump_cap`` dump files (oldest removed first;
        the sortable name encodes the write time)."""
        try:
            names = sorted(n for n in os.listdir(self._dump_dir)
                           if n.startswith("flight-")
                           and n.endswith(".json"))
        except OSError:
            return
        for name in names[:max(0, len(names) - self._dump_cap)]:
            try:
                os.unlink(os.path.join(self._dump_dir, name))
            except OSError:
                pass


def _safe_reason(reason: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(reason))[:48] or "dump"


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-wide flight recorder (always recording)."""
    return _RECORDER


def reset(capacity: int = 512, transitions: int = 128) -> FlightRecorder:
    """Install a pristine recorder (tests): fresh rings, disk dumps off."""
    global _RECORDER
    _RECORDER = FlightRecorder(capacity=capacity, transitions=transitions)
    return _RECORDER
