"""Coordination across processes, in its single-process forms (trimmed
copy of hadoop_bam_tpu/parallel/distributed.py).

The port runs one process on one card, so the plan broadcast and the
guarded allgather are what a collective of one process returns, with no
collective behind them.  ``serialize_plan`` is the plan's JSON, what the
job journal digests.  ``initialize`` and the ``distributed_*`` pipeline
functions wait in ROADMAP.md (Queue 1 item 12).
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from hadoop_bam_torch.utils.errors import PlanError


def serialize_plan(spans: Sequence, max_bytes: int = 1 << 24) -> bytes:
    """JSON of a span plan, each span tagged with its class; PlanError
    when it would not fit a ``max_bytes`` broadcast buffer."""
    payload = json.dumps(
        [{"k": type(s).__name__, **s.to_dict()} for s in spans]).encode()
    if len(payload) + 8 > max_bytes:
        raise PlanError(f"plan of {len(spans)} spans serializes to "
                        f"{len(payload)} bytes — exceeds the "
                        f"{max_bytes}-byte broadcast buffer; raise "
                        f"max_bytes or plan coarser spans")
    return payload


def guarded_allgather(arr: np.ndarray, what: str,
                      timeout_s: Optional[float] = None) -> np.ndarray:
    """Every process's ``arr`` stacked on a new leading axis: with one
    process, ``arr[None]``."""
    del what, timeout_s
    return np.asarray(arr)[None]


def broadcast_plan(spans: Optional[Sequence], max_bytes: int = 1 << 24,
                   retries: int = 2,
                   timeout_s: Optional[float] = None) -> List:
    """Process 0's plan on every process: with one process, its own."""
    del max_bytes, retries, timeout_s
    if spans is None:
        raise PlanError("broadcast_plan: process 0 must pass its plan")
    return list(spans)
