"""Plan identity (trimmed copy of hadoop_bam_tpu/plan/ir.py).

The reference compiles every driver to a declarative plan,

    Source -> Spans -> TensorOps DAG -> Sink

of frozen dataclasses with a canonical serialization (``PlanIR.to_doc``)
and a content digest (``PlanIR.digest``): canonical sorted-key JSON, path
spellings made absolute, sha256 cut to 24 hex characters, the recipe of
``jobs.journal.plan_digest``.  The port keeps the part a job journal
records: the dataclasses and the digest, so that a journaled cohort join
refuses a resume whose plan compiles differently, and so that the port's
digest of a plan equals the reference's.  The runner that executes a
plan (``execute``, ``hbam explain``) is not ported; drivers call their
feeds directly.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional, Tuple

IR_VERSION = 1

# JSON-able parameter scalar types accepted by op_node / SinkIR.of
_SCALARS = (str, int, float, bool, type(None))


def _norm_value(v):
    """One op / sink parameter in a hashable, JSON-stable form (tuples
    for sequences, scalars as they are)."""
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_norm_value(x) for x in v)
    raise TypeError(
        f"plan IR parameters must be JSON-able scalars/sequences, got "
        f"{type(v).__name__}: {v!r}")


def _params_tuple(params: Dict) -> Tuple[Tuple[str, object], ...]:
    return tuple((k, _norm_value(params[k])) for k in sorted(params))


def _params_doc(params: Tuple[Tuple[str, object], ...]) -> Dict:
    def unroll(v):
        return list(unroll(x) for x in v) if isinstance(v, tuple) else v
    return {k: unroll(v) for k, v in params}


@dataclasses.dataclass(frozen=True)
class SourceIR:
    """What the plan reads: ``role`` "scan" (a whole-file span plan),
    "chunk" (ranges out of a genomic index) or "join" (the k-way cohort
    merge keyed by a manifest)."""
    path: str
    fmt: str
    role: str = "scan"

    def to_doc(self) -> Dict:
        return {"path": os.path.abspath(self.path), "fmt": self.fmt,
                "role": self.role}


@dataclasses.dataclass(frozen=True)
class SpansIR:
    """How the source cuts into decode units; ``auto`` defers to the
    family's planner (the digest then covers the requested grain, not
    the data-dependent cuts)."""
    mode: str = "auto"
    n_spans: Optional[int] = None
    span_bytes: Optional[int] = None

    @classmethod
    def auto(cls, n_spans: Optional[int] = None,
             span_bytes: Optional[int] = None) -> "SpansIR":
        return cls(mode="auto", n_spans=n_spans, span_bytes=span_bytes)

    def to_doc(self) -> Dict:
        doc: Dict = {"mode": self.mode}
        if self.n_spans is not None:
            doc["n_spans"] = int(self.n_spans)
        if self.span_bytes is not None:
            doc["span_bytes"] = int(self.span_bytes)
        return doc


@dataclasses.dataclass(frozen=True)
class TensorOpIR:
    """One node of the (linear) tensor-op DAG."""
    op: str
    params: Tuple[Tuple[str, object], ...] = ()

    def to_doc(self) -> Dict:
        doc: Dict = {"op": self.op}
        if self.params:
            doc["params"] = _params_doc(self.params)
        return doc


def op_node(op: str, **params) -> TensorOpIR:
    """TensorOpIR with keyword params (sorted and normalized, so two
    spellings of one op digest alike)."""
    return TensorOpIR(op=op, params=_params_tuple(params))


@dataclasses.dataclass(frozen=True)
class SinkIR:
    """Where the DAG's output lands ("stats", "tensor_batches", ...)."""
    kind: str
    params: Tuple[Tuple[str, object], ...] = ()

    @classmethod
    def of(cls, kind: str, **params) -> "SinkIR":
        return cls(kind=kind, params=_params_tuple(params))

    def to_doc(self) -> Dict:
        doc: Dict = {"kind": self.kind}
        if self.params:
            doc["params"] = _params_doc(self.params)
        return doc


@dataclasses.dataclass(frozen=True)
class PlanIR:
    """The whole plan; ``digest()`` is the identity a job journal
    records (``jobs.runner.plan_journal_params``)."""
    source: SourceIR
    spans: SpansIR
    ops: Tuple[TensorOpIR, ...]
    sink: SinkIR

    def to_doc(self) -> Dict:
        return {
            "v": IR_VERSION,
            "source": self.source.to_doc(),
            "spans": self.spans.to_doc(),
            "ops": [o.to_doc() for o in self.ops],
            "sink": self.sink.to_doc(),
        }

    def digest(self) -> str:
        """sha256 of the canonical serialization, 24 hex characters."""
        blob = json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:24]
