"""Failure classes of the port (counterpart of hadoop_bam_tpu/utils/errors.py).

The classes and their builtin bases are the reference's, so a corrupt
input raises an exception of the same class name and the same builtin
ancestry in both packages.  The transient class, the circuit breaker and
``classify_error`` stay behind until span retry and quarantine are ported.
"""
from __future__ import annotations


class HBamError(Exception):
    """Base of all classified framework errors."""


class CorruptDataError(HBamError, ValueError):
    """Deterministic data corruption: bad magic, CRC mismatch, malformed
    record chain, impossible field values.  Re-decoding the same bytes can
    never heal it."""


class PlanError(HBamError, ValueError):
    """A planning / user-parameter error (bad split parameters, a span
    larger than the device geometry, an unknown decode plane): the run is
    misconfigured, not the data."""
