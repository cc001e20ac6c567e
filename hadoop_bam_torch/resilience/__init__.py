"""Degrade-and-heal resilience (counterpart of hadoop_bam_tpu/resilience/):

- ``breaker``: the closed/open/half-open ``CircuitBreaker`` with a
  decayed failure window (injectable clock);
- ``domains``: fault domains keyed (subsystem, plane, file), the
  ``DemotionLadder`` (device -> native -> zlib, same results) that heals
  back through half-open probes, and the per-file quarantine circuit;
- ``chaos``: named fault points (``decode.native``, ``device.step``)
  with seed-derived schedules.

Host-local policy only: nothing here touches the card.
"""
from hadoop_bam_torch.resilience.breaker import (       # noqa: F401
    CLOSED, HALF_OPEN, OPEN, CircuitBreaker, DecayingWindow,
)
from hadoop_bam_torch.resilience.domains import (       # noqa: F401
    PLANES, DemotionLadder, FaultDomain, FaultDomainRegistry,
    check_quarantine_gate, decode_ladder, file_ident, quarantine_breaker,
    quarantine_run_ok, registry, reset,
)
from hadoop_bam_torch.resilience import chaos           # noqa: F401
