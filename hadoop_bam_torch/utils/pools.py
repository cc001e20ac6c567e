"""Pool submission with the reference's two chaos points (trimmed copy
of hadoop_bam_tpu/utils/pools.py::submit: no shared pool, no background
gate, no queue-wait histograms).

``pool.submit`` fires on the submitter's thread, where a saturated or
failing executor would raise; ``pool.task`` fires on the worker thread
before the task runs, where a "delay" fault wedges a worker mid-task:
the hang the span window's ``pool_task_timeout_s`` exists to end.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Callable

from hadoop_bam_torch.resilience import chaos


def _task(fn: Callable, args, kwargs):
    chaos.fire("pool.task")
    return fn(*args, **kwargs)


def submit(pool: cf.ThreadPoolExecutor, fn: Callable, *args,
           **kwargs) -> cf.Future:
    chaos.fire("pool.submit")
    return pool.submit(_task, fn, args, kwargs)
