"""Per-tenant admission quotas + priority classes for the resident server
(copy of hadoop_bam_tpu/serve/tenancy.py).

One tenant flooding the server must degrade THAT tenant, not its
neighbours.  This module layers multi-tenancy onto the PR-5
``QueryScheduler`` — reused unchanged, one instance per tenant:

- each tenant gets its own bounded admission gate
  (``serve_tenant_max_in_flight`` running + ``serve_tenant_queue_depth``
  waiting); a tenant past both sheds ITS OWN load with
  ``TransientIOError`` while every other tenant admits normally;
- admission happens on the SUBMITTING client's thread (backpressure
  lands on the flooder), and the admitted slot is held until the
  dispatcher finishes the request;
- priority classes order the dispatcher's queue: ``interactive``
  requests jump ahead of ``batch`` backfill, so a batch tenant
  saturating its quota cannot push an interactive tenant's p99 past its
  deadline (the isolation contract, pinned in tests/test_serve.py);
- idle tenant gates are LRU-evicted past ``serve_max_tenants`` — a
  long-running server accepting arbitrary tenant strings must not grow
  a scheduler per string forever (the SV801 bound);
- each tenant also carries a half-open ``CircuitBreaker``
  (``resilience/breaker.py``): repeated serving failures for one tenant
  (its files corrupt, its requests chronically deadline-missing) OPEN
  its breaker and the tenant sheds instantly with a ``retry_after_s``
  hint — no decode work spent — while every other tenant serves
  normally; after the cooldown one half-open probe request re-tests,
  and a success heals the tenant.  ``ServeLoop`` records the outcomes.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.query.scheduler import QueryScheduler
from hadoop_bam_torch.resilience.breaker import CircuitBreaker
from hadoop_bam_torch.utils.errors import (
    PlanError, TransientIOError, classify_error, PLAN,
)
from hadoop_bam_torch.utils.metrics import METRICS

# lower sorts first in the dispatch heap
PRIORITIES: Dict[str, int] = {"interactive": 0, "batch": 1}


def priority_rank(priority: str) -> int:
    try:
        return PRIORITIES[priority]
    except KeyError:
        raise PlanError(
            f"unknown priority class {priority!r}; choose from "
            f"{sorted(PRIORITIES)}") from None


class TenantQuotas:
    """The per-tenant gate registry (module docstring)."""

    def __init__(self, config: HBamConfig = DEFAULT_CONFIG,
                 clock: Callable[[], float] = time.monotonic):
        self.max_in_flight = int(
            getattr(config, "serve_tenant_max_in_flight", 4))
        self.queue_depth = int(
            getattr(config, "serve_tenant_queue_depth", 16))
        self.max_tenants = int(getattr(config, "serve_max_tenants", 64))
        self.default_deadline_s: Optional[float] = getattr(
            config, "query_deadline_s", None)
        # SLO shed pressure (obs/slo.py): when ServeLoop installs its
        # engine here, a tenant whose FAST burn window is alight sheds
        # its batch-priority admissions — backfill is the load that can
        # wait while the budget recovers; interactive traffic still
        # admits (and still feeds the breaker on real failures)
        self.slo_engine = None
        self.slo_shed_batch = bool(getattr(config, "slo_shed_batch",
                                           True))
        self._clock = clock
        self._config = config
        self._lock = threading.Lock()
        self._tenants: "OrderedDict[str, QueryScheduler]" = OrderedDict()
        # tenant -> half-open breaker; same LRU life as the scheduler
        # gates (evicting an idle tenant forgets its failure history —
        # acceptable: a returning tenant starts CLOSED)
        self._breakers: "OrderedDict[str, CircuitBreaker]" = OrderedDict()

    def scheduler(self, tenant: str) -> QueryScheduler:
        """This tenant's admission gate (created on first use; idle gates
        LRU-evict past ``max_tenants``)."""
        if not isinstance(tenant, str) or not tenant:
            raise PlanError(f"tenant must be a non-empty string, "
                            f"got {tenant!r}")
        with self._lock:
            sched = self._tenants.get(tenant)
            if sched is not None:
                self._tenants.move_to_end(tenant)
                return sched
            if len(self._tenants) >= self.max_tenants:
                # evict the least-recently-used IDLE gate; busy gates
                # (admitted work outstanding) are skipped — evicting one
                # would orphan its in-flight accounting
                for name in list(self._tenants):
                    if self._tenants[name].in_flight == 0:
                        self._tenants.pop(name)
                        self._breakers.pop(name, None)
                        break
            sched = QueryScheduler(
                self.max_in_flight, self.queue_depth,
                self.default_deadline_s, clock=self._clock,
                shed_retry_after_s=float(getattr(
                    self._config, "serve_shed_retry_after_s", 0.1)))
            self._tenants[tenant] = sched
            return sched

    def breaker(self, tenant: str) -> CircuitBreaker:
        """This tenant's half-open failure breaker (created CLOSED on
        first use, bounded by the same tenant LRU)."""
        with self._lock:
            br = self._breakers.get(tenant)
            if br is None:
                cfg = self._config
                br = CircuitBreaker(
                    failure_threshold=float(getattr(
                        cfg, "breaker_failure_threshold", 3.0)),
                    window_s=float(getattr(cfg, "breaker_window_s", 30.0)),
                    cooldown_s=float(getattr(
                        cfg, "breaker_cooldown_s", 5.0)),
                    half_open_probes=int(getattr(
                        cfg, "breaker_half_open_probes", 1)),
                    clock=self._clock, name=f"tenant/{tenant}")
                while len(self._breakers) >= self.max_tenants:
                    self._breakers.popitem(last=False)
                self._breakers[tenant] = br
            else:
                self._breakers.move_to_end(tenant)
            return br

    def record_outcome(self, tenant: str,
                       exc: Optional[BaseException]) -> None:
        """Feed one finished request's outcome into the tenant breaker.
        PLAN-class failures (the client's malformed request) and
        admission sheds don't count — they prove nothing about whether
        serving this tenant's data works; everything else (corrupt
        files, deadline misses surfacing as TransientIOError from the
        serve path, unknown errors) does."""
        br = self.breaker(tenant)
        if exc is None:
            br.record_success()
            return
        if classify_error(exc) == PLAN:
            return
        br.record_failure()

    def slo_shed_check(self, tenant: str, priority: str) -> None:
        """Shed batch-priority work for a tenant whose fast SLO burn
        window is alight (``obs/slo.py``); interactive work admits."""
        if (self.slo_engine is None or not self.slo_shed_batch
                or priority != "batch"):
            return
        window = self.slo_engine.burning(f"latency/{tenant}")
        if window != "fast":
            return
        METRICS.count("slo.batch_shed")
        retry = float(getattr(self._config, "serve_shed_retry_after_s",
                              0.1))
        raise TransientIOError(
            f"tenant {tenant!r} is burning its latency SLO budget "
            f"({window} window) — batch work shed so interactive "
            f"traffic recovers; retry in {retry:g}s",
            retry_after_s=retry)

    @contextlib.contextmanager
    def admit(self, tenant: str, deadline_s: Optional[float] = None,
              priority: str = "interactive"):
        """The tenant's ``QueryScheduler.admit`` — blocking bounded
        admission on the CALLER's thread, yielding the enqueue-anchored
        ``Deadline``.  Guards the handout window: if the idle-LRU
        eviction dropped this tenant's gate between lookup and
        admission, the admitted slot would live on an orphaned
        scheduler (splitting the tenant's quota across instances), so
        after admitting we re-validate membership — reinstalling the
        gate if it was evicted, or retrying on the replacement a racing
        creator installed.

        The tenant's breaker gates FIRST: an OPEN tenant sheds here —
        before any queueing — with the cooldown remainder as the
        ``retry_after_s`` hint; a HALF_OPEN tenant admits exactly its
        probe budget (the probes' outcomes decide heal vs re-open)."""
        br = self.breaker(tenant)
        if not br.allow():
            METRICS.count("resilience.tenant_shed")
            raise TransientIOError(
                f"tenant {tenant!r} circuit is {br.state} after repeated "
                f"serving failures — retry in {br.retry_after_s():.3g}s",
                retry_after_s=br.retry_after_s() or None)
        self.slo_shed_check(tenant, priority)
        while True:
            sched = self.scheduler(tenant)
            with sched.admit(deadline_s) as deadline:
                with self._lock:
                    live = self._tenants.get(tenant)
                    if live is None:
                        # evicted while idle in the handout window; we
                        # now hold an admitted slot, so it is not idle:
                        # reinstall it as the tenant's one true gate
                        self._tenants[tenant] = sched
                        live = sched
                if live is sched:
                    yield deadline
                    return
            # a racing creator installed a different gate: the slot we
            # took on the orphan is released by the with-exit above;
            # re-admit on the live gate

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            names = list(self._tenants)
            scheds = dict(self._tenants)
            breakers = dict(self._breakers)
        out: Dict[str, Dict[str, float]] = {}
        for name in names:
            row: Dict[str, float] = {"in_flight": scheds[name].in_flight}
            br = breakers.get(name)
            if br is not None:
                row["breaker"] = br.state
            out[name] = row
        return out

    def breaker_states(self) -> Dict[str, dict]:
        """Health-surface snapshot of every tracked tenant breaker."""
        with self._lock:
            breakers = dict(self._breakers)
        return {name: br.snapshot() for name, br in breakers.items()}
