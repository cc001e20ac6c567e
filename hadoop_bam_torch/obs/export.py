"""Prometheus text exposition of a metrics snapshot (the
``prometheus_text`` of hadoop_bam_tpu/obs/export.py; its snapshot JSON
files wait for the CLI, ROADMAP item 12).

Counters render as ``_total`` counters, timers as seconds + calls
counter pairs, wall spans as gauges, and histograms as native
Prometheus histograms with cumulative ``le`` buckets derived from the
log-bucket grid: the serve transport's ``{"op": "metrics", "format":
"prometheus"}`` answer returns this string verbatim.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

from hadoop_bam_torch.obs.hist import Histogram

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(prefix: str, name: str, suffix: str = "") -> str:
    return f"{prefix}_{_NAME_RE.sub('_', name)}{suffix}"


def _fmt(v: float) -> str:
    return repr(round(float(v), 9))


def prometheus_text(metrics_or_dict, prefix: str = "hbam",
                    labels: Optional[Dict[str, str]] = None) -> str:
    """Render a ``Metrics`` instance (or its ``to_dict`` payload) in the
    Prometheus text exposition format (version 0.0.4)."""
    d = metrics_or_dict if isinstance(metrics_or_dict, dict) \
        else metrics_or_dict.to_dict()
    lab = ""
    if labels:
        lab = "{" + ",".join(f'{k}="{v}"'
                             for k, v in sorted(labels.items())) + "}"
    lines = []
    for k in sorted(d.get("counters", {})):
        n = _prom_name(prefix, k, "_total")
        lines += [f"# TYPE {n} counter",
                  f"{n}{lab} {int(d['counters'][k])}"]
    timer_calls = d.get("timer_calls", {})
    for k in sorted(d.get("timers", {})):
        n = _prom_name(prefix, k, "_seconds_total")
        lines += [f"# TYPE {n} counter",
                  f"{n}{lab} {_fmt(d['timers'][k])}"]
        c = _prom_name(prefix, k, "_calls_total")
        lines += [f"# TYPE {c} counter",
                  f"{c}{lab} {int(timer_calls.get(k, 0))}"]
    for k in sorted(d.get("wall_timers", {})):
        n = _prom_name(prefix, k, "_seconds")
        lines += [f"# TYPE {n} gauge",
                  f"{n}{lab} {_fmt(d['wall_timers'][k])}"]
    for k in sorted(d.get("histograms", {})):
        h = d["histograms"][k]
        if not isinstance(h, dict) or "buckets" not in h:
            continue           # a summary snapshot, not mergeable state
        n = _prom_name(prefix, k)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for idx in sorted(int(i) for i in h["buckets"]):
            cum += int(h["buckets"][str(idx)])
            _, upper = Histogram.bucket_bounds(idx)
            le = f'le="{_fmt(upper)}"'
            sep = "," if labels else ""
            inner = (lab[1:-1] + sep + le) if labels else le
            lines.append(f"{n}_bucket{{{inner}}} {cum}")
        inf = 'le="+Inf"'
        inner = (lab[1:-1] + "," + inf) if labels else inf
        lines.append(f"{n}_bucket{{{inner}}} {int(h.get('count', cum))}")
        lines.append(f"{n}_sum{lab} {_fmt(h.get('total', 0.0))}")
        lines.append(f"{n}_count{lab} {int(h.get('count', cum))}")
    return "\n".join(lines) + "\n"
