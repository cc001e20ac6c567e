"""Failure classes of the port (counterpart of hadoop_bam_tpu/utils/errors.py).

The classes and their builtin bases are the reference's, so a corrupt
input raises an exception of the same class name and the same builtin
ancestry in both packages.  ``classify_error`` maps an exception to the
policy class every boundary consults (span retry, read retry, the
demotion ladder):

- TRANSIENT: may heal on retry (flaky reads, injected chaos);
- CORRUPT: the bytes are bad; re-decoding never heals it;
- PLAN: the run is misconfigured; never retried, skipped or demoted.

One deliberate difference from the reference: a kernel or host library
that fails to build or launch (``BackendError``) and torch's CUDA
runtime errors are PLAN here.  The reference counts unknown exceptions
as CORRUPT, so its demotion ladder would move a failed device kernel's
work to the host planes without a word; the port raises instead.
"""
from __future__ import annotations

import struct
import zlib

import torch

# error-class tags (quarantine manifest entries carry these strings)
TRANSIENT = "transient"
CORRUPT = "corrupt"
PLAN = "plan"


class HBamError(Exception):
    """Base of all classified framework errors."""


class TransientIOError(HBamError, OSError):
    """A read failure that may heal on retry: a flaky filesystem, a
    dropped link, an injected chaos fault.  ``retry_after_s`` is an
    optional backoff hint."""

    def __init__(self, *args, retry_after_s: "float | None" = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class CorruptDataError(HBamError, ValueError):
    """Deterministic data corruption: bad magic, CRC mismatch, malformed
    record chain, impossible field values.  Re-decoding the same bytes can
    never heal it."""


class PlanError(HBamError, ValueError):
    """A planning / user-parameter error (bad split parameters, a span
    larger than the device geometry, an unknown decode plane): the run is
    misconfigured, not the data."""


class CircuitBreakerError(HBamError, RuntimeError):
    """The quarantined-span fraction crossed
    ``config.max_bad_span_fraction``, or a circuit for the file is OPEN:
    the run aborts instead of degrading.  ``retry_after_s`` says when a
    half-open probe will be let through."""

    def __init__(self, *args, retry_after_s: "float | None" = None):
        super().__init__(*args)
        self.retry_after_s = retry_after_s


class BackendError(HBamError, RuntimeError):
    """A hand kernel or the host library failed to build or launch
    (``ops/kernels.py``, ``utils/native.py``): PLAN class, never
    retried, quarantined or demoted."""


# builtins that indicate the environment, not the bytes, failed
_TRANSIENT_BUILTINS = (TimeoutError, ConnectionError, InterruptedError,
                       BlockingIOError)
# deterministic OSErrors: a missing path or a permission wall is PLAN
_PLAN_BUILTINS = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
                  PermissionError)
# builtins raised by the decode stack on bad bytes
_CORRUPT_BUILTINS = (zlib.error, struct.error, ValueError, IndexError,
                     KeyError, UnicodeDecodeError, EOFError, OverflowError)
# torch's errors of the card itself
_CUDA_ERRORS = (torch.OutOfMemoryError,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


def is_backend_fault(exc: BaseException) -> bool:
    """A kernel/library build or launch failure or a CUDA runtime error:
    the port's own machinery failed, not the plane's bytes."""
    if isinstance(exc, (BackendError,) + _CUDA_ERRORS):
        return True
    return type(exc) is RuntimeError and "CUDA" in str(exc)


def classify_error(exc: BaseException) -> str:
    """Map an exception to its failure class: TRANSIENT / CORRUPT / PLAN.

    The reference's rule (taxonomy classes first, then builtins; unknown
    exceptions are CORRUPT), with backend faults (``is_backend_fault``)
    PLAN."""
    if isinstance(exc, PlanError) or is_backend_fault(exc):
        return PLAN
    if isinstance(exc, TransientIOError):
        return TRANSIENT
    if isinstance(exc, CorruptDataError):
        return CORRUPT
    if isinstance(exc, _TRANSIENT_BUILTINS):
        return TRANSIENT
    if isinstance(exc, _PLAN_BUILTINS):
        return PLAN
    if isinstance(exc, OSError):
        return TRANSIENT
    if isinstance(exc, _CORRUPT_BUILTINS):
        return CORRUPT
    return CORRUPT
