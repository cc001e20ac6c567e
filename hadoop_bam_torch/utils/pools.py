"""The shared decode pool and context-carrying pool submission (copy of
hadoop_bam_tpu/utils/pools.py, less ``result_with_timeout``: the span
window enforces its own timeout).

``submit`` carries the submitter's ``contextvars`` snapshot to the
worker (a client's ``MetricsContext`` and trace id ride along), records
the ``pool.task_wait_s`` / ``pool.task_run_s`` histograms, and routes
``priority="bg"`` work through the background gate (at most a quarter
of the pool's workers, so serve prefetch never starves foreground
decode).  Two chaos points: ``pool.submit`` fires on the submitter's
thread, where a saturated or failing executor would raise; ``pool.task``
fires on the worker thread before the task runs, where a "delay" fault
wedges a worker mid-task -- the hang ``pool_task_timeout_s`` ends.

``decode_pool`` is the process-wide shared executor (created lazily,
sized once from ``config.decode_pool_workers`` or the CPU count); the
drivers keep their own per-call pools, the serve prefetcher uses this
one.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import contextvars
import os
import threading
import time
from typing import Optional

from hadoop_bam_torch.resilience import chaos

_LOCK = threading.Lock()
_POOL: Optional[cf.ThreadPoolExecutor] = None
_POOL_SIZE = 0


def default_pool_size(config=None) -> int:
    """Worker count for a fresh pool: config.decode_pool_workers when
    set, else the measured sweet spot of 4x CPUs in [4, 32] (decode
    threads block on I/O about as often as they inflate)."""
    n = getattr(config, "decode_pool_workers", None) if config else None
    if n:
        return max(1, int(n))
    return min(32, max(4, (os.cpu_count() or 4) * 4))


def decode_pool(config=None) -> cf.ThreadPoolExecutor:
    """The shared decode executor (created on first call, never torn
    down — idle workers cost nothing, re-creation per driver call cost
    thread spawns + a join on every invocation)."""
    global _POOL, _POOL_SIZE
    with _LOCK:
        if _POOL is None:
            _POOL_SIZE = default_pool_size(config)
            _POOL = cf.ThreadPoolExecutor(
                max_workers=_POOL_SIZE, thread_name_prefix="hbam-decode")
        return _POOL


def decode_pool_size(config=None) -> int:
    """Worker count of the shared pool (creating it if needed): what the
    parallel BGZF writer bounds its deflates in flight by."""
    decode_pool(config)
    return _POOL_SIZE


def _timed_task(fn, t_submit: float, args, kwargs):
    from hadoop_bam_torch.utils.metrics import current_metrics

    m = current_metrics()
    t0 = time.perf_counter()
    # queue wait + run durations as log-bucketed histograms: the pool is
    # SHARED across drivers, so p95 task_wait is the direct saturation
    # signal (a deep wait distribution means the pool, not the device,
    # is the bottleneck) — a flat timer cannot show that
    m.observe("pool.task_wait_s", t0 - t_submit)
    # chaos point ON THE WORKER thread (pool.submit fires on the
    # submitter's): a "delay" fault here wedges a worker mid-task —
    # the exact hang shape the per-future timeout exists to surface
    chaos.fire("pool.task")
    try:
        return fn(*args, **kwargs)
    finally:
        m.observe("pool.task_run_s", time.perf_counter() - t0)


def submit(pool: cf.ThreadPoolExecutor, fn, *args,
           priority: str = "fg", **kwargs) -> cf.Future:
    """Context-carrying, histogram-instrumented submit — what every
    decode-path call site uses instead of bare ``pool.submit``:

    - the submitter's ``contextvars`` context rides along, so work done
      on a pool thread records into the submitter's ``MetricsContext``
      (a bare submit silently falls back to the process-global Metrics
      and two concurrent engine batches smear into each other);
    - per-task queue-wait and run durations land in the
      ``pool.task_wait_s`` / ``pool.task_run_s`` histograms;
    - ``priority="bg"`` routes the task through the background gate:
      at most ``background_limit(pool)`` (a quarter of the workers,
      min 1) background tasks occupy the pool concurrently, so serve
      prefetch can soak idle decode capacity without ever starving
      foreground admission — excess background work queues in FIFO
      order and drains as permits free.
    """
    if priority not in ("fg", "bg"):
        from hadoop_bam_torch.utils.errors import PlanError
        raise PlanError(f"pool priority must be 'fg' or 'bg', "
                        f"got {priority!r}")
    # chaos point: an injected submission failure surfaces HERE — on the
    # submitter's thread, classified TRANSIENT — exactly where a real
    # saturated/failing executor would (no-op unless armed)
    chaos.fire("pool.submit", priority=priority)
    ctx = contextvars.copy_context()
    t_submit = time.perf_counter()
    if priority == "fg":
        return pool.submit(ctx.run, _timed_task, fn, t_submit, args, kwargs)
    fut: cf.Future = cf.Future()
    from hadoop_bam_torch.utils.metrics import METRICS
    METRICS.count("pool.bg_submitted")
    with _BG_LOCK:
        _BG_QUEUE.append((pool, fut, ctx, fn, t_submit, args, kwargs))
    _pump_background()
    return fut


# ---------------------------------------------------------------------------
# background priority gate (serve prefetch rides this)
# ---------------------------------------------------------------------------

_BG_LOCK = threading.Lock()
_BG_QUEUE: "collections.deque" = collections.deque()
_BG_RUNNING = [0]


def background_limit(pool: cf.ThreadPoolExecutor) -> int:
    """Concurrent background tasks allowed in ``pool``: a quarter of the
    workers (min 1), so >= 3/4 of the pool is always free the instant
    foreground decode work arrives."""
    size = int(getattr(pool, "_max_workers", 1) or 1)
    return max(1, size // 4)


def _run_background(fut: cf.Future, ctx, fn, t_submit, args, kwargs) -> None:
    if not fut.set_running_or_notify_cancel():
        return
    try:
        fut.set_result(ctx.run(_timed_task, fn, t_submit, args, kwargs))
    except BaseException as e:  # noqa: BLE001 — crosses the thread
        fut.set_exception(e)


def _pump_background() -> None:
    while True:
        with _BG_LOCK:
            if not _BG_QUEUE:
                return
            pool = _BG_QUEUE[0][0]
            if _BG_RUNNING[0] >= background_limit(pool):
                return
            item = _BG_QUEUE.popleft()
            _BG_RUNNING[0] += 1
        _pool, fut, ctx, fn, t_submit, args, kwargs = item

        def task(fut=fut, ctx=ctx, fn=fn, t_submit=t_submit, args=args,
                 kwargs=kwargs):
            try:
                _run_background(fut, ctx, fn, t_submit, args, kwargs)
            finally:
                with _BG_LOCK:
                    _BG_RUNNING[0] -= 1
                _pump_background()

        try:
            _pool.submit(task)
        except BaseException as e:  # noqa: BLE001 — pool shut down etc.
            # the permit was taken above and `task` will never run its
            # finally: give the permit back, fail the future (so waiters
            # like Prefetcher.drain never hang), and keep pumping — a
            # speculative submit must never wedge the gate or raise into
            # a foreground serve path
            with _BG_LOCK:
                _BG_RUNNING[0] -= 1
            if not fut.cancel():
                try:
                    fut.set_exception(e)
                except Exception:  # noqa: BLE001 — already resolved
                    pass


def cancel_background() -> int:
    """Cancel every QUEUED (not yet running) background task; returns the
    number cancelled.  ``ServeLoop.stop`` / ``Prefetcher`` teardown use
    this so a shutting-down server never keeps decoding regions nobody
    will ask for."""
    cancelled = 0
    with _BG_LOCK:
        while _BG_QUEUE:
            _p, fut, *_rest = _BG_QUEUE.popleft()
            if fut.cancel():
                cancelled += 1
    from hadoop_bam_torch.utils.metrics import METRICS
    if cancelled:
        METRICS.count("pool.bg_cancelled", cancelled)
    return cancelled


def pool_stats() -> dict:
    """Occupancy snapshot of the shared decode pool for the health/
    `hbam top` surfaces: worker count, how many pool threads exist (a
    lazy executor only spawns them under load), and the background
    gate's running/queued depths.  Never materializes the pool."""
    with _LOCK:
        pool, size = _POOL, _POOL_SIZE
    with _BG_LOCK:
        bg_running, bg_queued = _BG_RUNNING[0], len(_BG_QUEUE)
    out = {"workers": size, "threads_live": 0,
           "bg_running": bg_running, "bg_queued": bg_queued}
    if pool is not None:
        out["threads_live"] = len(getattr(pool, "_threads", ()) or ())
        out["queued_tasks"] = getattr(pool, "_work_queue").qsize() \
            if hasattr(pool, "_work_queue") else 0
    return out
