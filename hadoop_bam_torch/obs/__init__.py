"""Observability of the port (counterpart of hadoop_bam_tpu/obs/):

- ``hist``: log-bucketed mergeable latency/size histograms with
  p50/p95/p99 (``Metrics.observe`` feeds them; the straggler defence
  reads its soft deadline from one);
- ``context``: ``TraceContext``, the request identity minted at each
  entry point and carried across the decode pool and the serve
  dispatcher by contextvars;
- ``flight``: the always-on bounded flight recorder of span
  completions and policy transitions, dumped on breaker trips,
  demotions, deadline misses and serve errors;
- ``slo``: latency SLOs with multi-window burn rates, read by serve
  admission;
- ``export``: ``prometheus_text``.

Run-scoped isolation lives in ``utils.metrics.MetricsContext``.  The
trace ring (``obs/trace.py``) is not ported yet (ROADMAP item 12): a
span is a wall timer plus a flight-recorder append.
"""
