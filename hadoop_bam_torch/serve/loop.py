"""ServeLoop: the long-running multi-tenant region-query server (copy of
hadoop_bam_tpu/serve/loop.py).

``QueryEngine`` answers one batch and returns; ``ServeLoop`` is the
RESIDENT server.  It owns:

- one long-lived ``QueryEngine`` (host chunk LRU + metadata stay warm
  across requests, many client threads feed it safely);
- the device-resident ``DeviceTileCache`` tier above it: a warm query
  whose tiles are resident never touches fetch / inflate / host decode
  and goes straight to the interval-filter step;
- the ``Prefetcher`` (adjacent-window decode at background pool
  priority) and ``TenantQuotas`` (per-tenant admission + priority
  classes), and an ``SloEngine`` over the process-global metrics.

Threading model: clients call ``submit()`` from any thread and get a
``concurrent.futures.Future``; tenant admission blocks (bounded) on the
CLIENT's thread, then the job enters one priority heap.  A single
DISPATCHER thread drains the heap and makes every device call, on one
CUDA stream it owns (the tiles are built and filtered on it), while
decode parallelism lives in the shared pool.  Each job runs under the
SUBMITTER's contextvars snapshot, so a client inside a
``MetricsContext`` gets its own isolated numbers even though the
serving and pool threads are shared.

Spans and metrics: ``serve.request_wall`` / ``serve.tile_build_wall`` /
``serve.filter_wall`` / ``serve.device_resolve_wall`` spans, the
``serve.latency_s`` (enqueue -> result, admission wait included) and
``serve.queue_wait_s`` histograms, ``serve.tile_hits/misses/evictions``,
``serve.prefetch_issued/useful``, ``serve.requests`` and
``query.deadline_misses`` for jobs that finish past their budget.

Deliberate differences: the loop takes ``device=`` where the reference
takes ``mesh=``; a region's match counts add up on the card and come
back in one read per region (the reference reads each tile group's
counts); a device tile build demotes to the host build only on a data
fault (the drivers' rule: the reference demotes every non-PLAN fault);
the serving fleet (``serve_replica_id`` + ``serve_peers``) raises
``PlanError`` until it is ported (ROADMAP Queue 1 item 11a).

Cohort slices: ``submit(..., cohort=True)`` names a cohort manifest JSON
for ``path``, and each region is answered from the joined
``[variants, samples]`` dosage tiles in the same device tile cache
(``cohort.serving.CohortServer``), keyed by the manifest's identity.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import contextvars
import dataclasses
import heapq
import itertools
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.obs import flight
from hadoop_bam_torch.obs.context import ensure_trace
from hadoop_bam_torch.obs.slo import SloEngine
from hadoop_bam_torch.parallel.pipeline import _device_data_fault
from hadoop_bam_torch.plan.executor import select_plane
from hadoop_bam_torch.query.engine import _I32_MAX, QueryEngine
from hadoop_bam_torch.serve.prefetch import Prefetcher
from hadoop_bam_torch.serve.tenancy import TenantQuotas, priority_rank
from hadoop_bam_torch.serve.tiles import (
    DeviceTileCache, TileBuilder, device_build_chunk, tile_filter_step,
    tile_key,
)
from hadoop_bam_torch.utils.errors import (
    PLAN, PlanError, TransientIOError, classify_error,
)
from hadoop_bam_torch.utils.metrics import (
    METRICS, base_metrics, current_metrics,
)


@dataclasses.dataclass
class ServeResult:
    """One served region: the match count is always computed (tile
    path); ``records`` materialize only when asked for.  ``extra``
    carries a projection's aggregates (a cohort slice's ``n_samples`` /
    ``mean_af`` / ``quarantined``)."""
    region: str
    count: int
    n_candidates: int
    tile_hits: int               # chunks served from resident tiles
    tile_misses: int             # chunks that needed a tile build
    records: Optional[List[object]] = None
    extra: Optional[Dict[str, object]] = None


@dataclasses.dataclass(order=True)
class _Job:
    rank: int                    # priority class (lower first)
    seq: int                     # FIFO within a class
    tenant: str = dataclasses.field(compare=False)
    path: str = dataclasses.field(compare=False)
    regions: Sequence[str] = dataclasses.field(compare=False)
    want_records: bool = dataclasses.field(compare=False)
    deadline: object = dataclasses.field(compare=False)
    admission: object = dataclasses.field(compare=False)   # entered CM
    future: cf.Future = dataclasses.field(compare=False)
    ctx: contextvars.Context = dataclasses.field(compare=False)
    t_enqueue: float = dataclasses.field(compare=False)
    # cohort-slice request: ``path`` is a cohort manifest JSON and the
    # regions slice the joined [variants, samples] tensor
    cohort: bool = dataclasses.field(compare=False, default=False)


class ServeLoop:
    """The resident server (module docstring), on ``cuda:0`` unless
    ``device`` says otherwise (RuntimeError without a card: the server
    never moves to the CPU on its own).  Use as a context manager, or
    ``start()`` / ``stop()`` explicitly; ``submit()`` auto-starts."""

    def __init__(self, config: HBamConfig = DEFAULT_CONFIG,
                 engine: Optional[QueryEngine] = None, device=None):
        if config.serve_replica_id and config.serve_peers:
            raise PlanError(
                "serving fleet (serve_replica_id + serve_peers) is not "
                "ported yet: ROADMAP Queue 1 item 11a (serve/fleet.py, "
                "serve/membership.py); leave one of them unset")
        self.config = config
        self.engine = engine if engine is not None else QueryEngine(
            config=config, device=device)
        self.device = self.engine.device
        # the transport's heartbeat / fleet ops answer as the
        # reference's single-replica server does
        self.fleet = None
        self.tiles = DeviceTileCache(int(config.serve_tile_cache_bytes))
        self.tenants = TenantQuotas(config)
        self.prefetcher = Prefetcher(self.engine, config)
        # SLO burn accounting over the server's PROCESS-GLOBAL metrics:
        # client MetricsContexts isolate per-request numbers, so the
        # serving path mirrors its latency observations into
        # base_metrics(), where the metrics transport op reads them
        self.slo = SloEngine(tick_s=float(config.slo_tick_s),
                             min_events=int(config.slo_min_events))
        self.slo_metrics = base_metrics()
        self.slo_latency_s = float(config.slo_latency_s)
        self.slo_target = float(config.slo_target)
        self.slo.ensure_latency("latency/_all", "serve.latency_s",
                                self.slo_latency_s, self.slo_target)
        self.tenants.slo_engine = self.slo
        # tenants with mirrored per-tenant series, LRU-bounded: tenant
        # strings are client input, and without eviction every distinct
        # string would grow the process-global metrics forever
        self._slo_tenants: "OrderedDict[str, bool]" = OrderedDict()
        # flight-recorder disk dumps: configured from this loop's config
        # when set (unset leaves the process-wide recorder as it is)
        if config.flight_dump_dir:
            flight.recorder().configure(
                dump_dir=config.flight_dump_dir,
                dump_cap=int(config.flight_dump_cap))
        self.tile_cap = int(config.serve_tile_records)
        self._builder: Optional[TileBuilder] = None
        self._cohort = None          # cohort.serving.CohortServer, lazy
        self._stream = None          # the dispatcher's CUDA stream
        self._cond = threading.Condition()
        self._heap: List[_Job] = []
        self._seq = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeLoop":
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="hbam-serve",
                    daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
        self.prefetcher.stop()
        # anything still queued will never run: fail it loudly as
        # retryable (a restarting server is a transient condition)
        with self._cond:
            leftovers, self._heap = self._heap, []
        for job in leftovers:
            self._finish_admission(job)
            job.future.set_exception(
                TransientIOError("serve loop stopped before this "
                                 "request was dispatched — retry",
                                 retry_after_s=1.0))
        if self._builder is not None:
            self._builder.close()

    def __enter__(self) -> "ServeLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ------------------------------------------------------

    def submit(self, path: str, regions: Sequence[str], *,
               tenant: str = "default", priority: str = "interactive",
               deadline_s: Optional[float] = None,
               want_records: bool = False,
               cohort: bool = False) -> cf.Future:
        """Enqueue one request (a path + its regions) for serving.

        Blocks (bounded) on THIS thread for tenant admission — the
        backpressure lands on the flooding client — then returns a
        Future of ``[ServeResult, ...]``.  Over-quota tenants shed with
        ``TransientIOError``; bad parameters raise ``PlanError``.

        With ``cohort=True``, ``path`` names a cohort manifest JSON and
        each region is answered from the device-resident joined dosage
        tiles (cohort/serving.py) instead of the per-file index path."""
        if not regions:
            raise PlanError("submit() needs at least one region")
        rank = priority_rank(priority)
        with self._cond:
            if self._stopping:
                # a stopped loop sheds instead of silently resurrecting:
                # restart is an explicit start() by whoever owns it
                raise TransientIOError("serve loop is stopped — retry "
                                       "after it restarts",
                                       retry_after_s=1.0)
        if self._thread is None:
            self.start()
        # request identity: join the transport's trace when one is
        # active, mint one for direct library callers; the contextvars
        # snapshot below carries it to the dispatcher and the pool
        with ensure_trace(op="serve.submit", tenant=tenant,
                          deadline_s=deadline_s):
            # entered HERE (client thread: admission wait + shed happen
            # to the submitter); exited by the dispatcher when done
            admission = self.tenants.admit(tenant, deadline_s,
                                           priority=priority)
            deadline = admission.__enter__()
            job = _Job(rank=rank, seq=next(self._seq), tenant=tenant,
                       path=path, regions=list(regions),
                       want_records=bool(want_records), deadline=deadline,
                       admission=admission, future=cf.Future(),
                       ctx=contextvars.copy_context(),
                       t_enqueue=time.perf_counter(), cohort=bool(cohort))
        with self._cond:
            if self._stopping:
                self._finish_admission(job)
                raise TransientIOError("serve loop is stopping — retry",
                                       retry_after_s=1.0)
            heapq.heappush(self._heap, job)
            self._cond.notify()
        return job.future

    def query(self, path: str, regions: Sequence[str],
              **kwargs) -> List[ServeResult]:
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(path, regions, **kwargs).result()

    def stats(self) -> Dict[str, object]:
        out = {"tiles": self.tiles.stats(),
               "chunks": self.engine.cache.stats(),
               "prefetch": self.prefetcher.stats(),
               "tenants": self.tenants.stats()}
        if self._cohort is not None:
            out["cohort"] = self._cohort.stats()
        return out

    def health(self) -> Dict[str, object]:
        """The degraded-mode diagnosis surface (``{"op": "health"}`` on
        the wire): loop liveness plus every adaptive-policy state —
        tenant breakers, the resilience registry's fault domains,
        registry fault pressure, and whether prefetch auto-paused."""
        from hadoop_bam_torch import resilience
        from hadoop_bam_torch.plan.executor import plane_report
        from hadoop_bam_torch.utils import pools

        reg = resilience.registry()
        with self._cond:
            stopping = self._stopping
            queued = len(self._heap)
        return {
            "status": "stopping" if stopping else "serving",
            "queued": queued,
            "device": str(self.device),
            "plane": plane_report(self.config),
            "fault_pressure": round(reg.fault_pressure(), 4),
            "open_breakers": reg.open_breakers(),
            "domains": reg.states(),
            "tenant_breakers": self.tenants.breaker_states(),
            "prefetch": self.prefetcher.stats(),
            "tiles": self.tiles.stats(),
            "flight": flight.recorder().stats(),
            "slo": self.slo.summary(self.slo_metrics),
            "pool": pools.pool_stats(),
            "fleet": None,
        }

    # -- dispatcher ----------------------------------------------------------

    @staticmethod
    def _finish_admission(job: _Job) -> None:
        try:
            job.admission.__exit__(None, None, None)
        except Exception:  # noqa: BLE001 — release must never mask results
            pass

    def _device_stream(self):
        """The dispatcher's own CUDA stream (a no-op context off the
        card): every tile build and filter runs on it, in order."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._heap and not self._stopping:
                    self._cond.wait(0.1)
                if self._stopping:
                    return
                job = heapq.heappop(self._heap)
            try:
                # run under the SUBMITTER's contextvars snapshot: the
                # client's MetricsContext (and anything the decode pool
                # inherits from here) stays isolated per client
                with self._device_stream():
                    job.ctx.run(self._run_job, job)
            except BaseException as e:  # noqa: BLE001 — keep serving
                if not job.future.done():
                    job.future.set_exception(e)

    def _run_job(self, job: _Job) -> None:
        t_run = time.perf_counter()
        METRICS.observe("serve.queue_wait_s", t_run - job.t_enqueue)
        try:
            with METRICS.span("serve.request_wall", tenant=job.tenant,
                              regions=len(job.regions)):
                results = [self._serve_region(job, region)
                           for region in job.regions]
            # outcome recorded BEFORE the future resolves: a client that
            # saw its request fail and retries at once must find the
            # breaker already fed
            self.tenants.record_outcome(job.tenant, None)
            job.future.set_result(results)
        except BaseException as e:  # noqa: BLE001 — crosses to the client
            # feed the tenant's half-open breaker (PLAN-class rejections
            # are the client's problem and never count)
            self.tenants.record_outcome(job.tenant, e)
            # an unhandled (non-PLAN) serving error is incident-grade:
            # snapshot the flight ring while the request's trace is
            # still the active context
            if classify_error(e) != PLAN:
                flight.recorder().dump("serve_error", error=str(e))
            job.future.set_exception(e)
        finally:
            lat = time.perf_counter() - job.t_enqueue
            METRICS.observe("serve.latency_s", lat)
            # mirror into the process-global metrics the SLO engine and
            # the metrics transport op read, plus the per-tenant series
            # the per-tenant objectives consume
            m = self.slo_metrics
            if current_metrics() is not m:
                m.observe("serve.latency_s", lat)
            self._note_slo_tenant(job.tenant)
            m.observe(f"serve.latency_s.{job.tenant}", lat)
            m.count(f"serve.requests.{job.tenant}")
            self.slo.ensure_latency(
                f"latency/{job.tenant}",
                f"serve.latency_s.{job.tenant}",
                self.slo_latency_s, self.slo_target)
            self.slo.tick(m)
            if job.deadline is not None and job.deadline.expired:
                job.deadline.book_miss()
            self._finish_admission(job)

    def _note_slo_tenant(self, tenant: str) -> None:
        """Track (and LRU-bound) the tenants with mirrored per-tenant
        series; evicting one discards its metric keys.  Dispatcher
        thread only."""
        lru = self._slo_tenants
        if tenant in lru:
            lru.move_to_end(tenant)
            return
        lru[tenant] = True
        cap = max(1, int(self.config.serve_max_tenants))
        while len(lru) > cap:
            old, _ = lru.popitem(last=False)
            self.slo_metrics.discard_series(
                f"serve.latency_s.{old}", f"serve.requests.{old}")

    def _builder_or_make(self) -> TileBuilder:
        if self._builder is None:
            self._builder = TileBuilder(self.device, self.tile_cap,
                                        int(self.config.serve_ring_slots))
        return self._builder

    def _cohort_or_make(self):
        if self._cohort is None:
            from hadoop_bam_torch.cohort.serving import CohortServer
            self._cohort = CohortServer(self.device, self.config)
        return self._cohort

    def _serve_region(self, job: _Job, region: str) -> ServeResult:
        if job.cohort:
            # the cohort plane: joined [variants, samples] tiles in the
            # SAME device cache, keyed by the manifest identity
            return self._cohort_or_make().serve(
                job.path, region, self.tiles,
                want_records=job.want_records, deadline=job.deadline)
        engine = self.engine
        job.deadline.check("serve resolve")
        meta = engine._file_meta(job.path)
        iv, ranges = engine._resolve(meta, region)
        chunks = engine._coalesce(ranges, meta.kind)
        builder = self._builder_or_make()
        rid = meta.ref_names.index(iv.rname)
        iv_dev = builder.put_interval([
            rid, min(iv.start, int(_I32_MAX)), min(iv.end, int(_I32_MAX))])
        # cold-tile plane routing, decided ONCE per request over the
        # serve-tile family.  Records mode always builds from the host
        # chunk (the materializer needs its columns anyway).
        ladder = None
        device_plane = False
        if not job.want_records:
            if self.config.adaptive_planes:
                from hadoop_bam_torch.config import resolve_inflate_backend
                from hadoop_bam_torch.resilience.domains import (
                    decode_ladder,
                )
                ladder = decode_ladder(
                    meta.path, resolve_inflate_backend(self.config),
                    self.config)
            decision = select_plane(self.config, ladder=ladder)
            device_plane = decision.plane == "device"
        n_candidates = 0
        tile_hits = 0
        tile_misses = 0
        # the region's match count adds up on the card: one read at the
        # end instead of one a tile group
        hits_total = torch.zeros((), dtype=torch.int64, device=self.device)
        masks: List[Tuple[Tuple[int, int], List[torch.Tensor]]] = []
        for s, e in chunks:
            job.deadline.check("serve chunk")
            key = tile_key(meta.ident, meta.kind, s, e,
                           builder.n_dev, builder.cap)
            tiles = self.tiles.get(key)
            if tiles is None:
                tile_misses += 1
                value = None
                device_blame = None
                if device_plane:
                    # cold miss on the device plane: the columns unpack
                    # entirely on the card.  None = the chunk declined
                    # (over-wide / over-cap / cut record) and takes the
                    # host build, which is not a device fault; a data
                    # fault (a bad block, a failed read) demotes through
                    # the ladder; anything else (a kernel that fails to
                    # build or launch, a bug) raises, as in the drivers
                    try:
                        tiles = device_build_chunk(
                            builder, meta.ident, meta.path, s, e,
                            self.config)
                    except Exception as exc:  # noqa: BLE001 — demotion
                        if ladder is None or not _device_data_fault(exc) \
                                or not ladder.demotable("device", exc):
                            raise
                        device_blame = exc
                        tiles = None
                    if tiles is not None and ladder is not None:
                        ladder.record_success("device")
                if tiles is None:
                    value = engine._chunk(meta, s, e)
                    # ticks serve.prefetch_useful when the host chunk was
                    # decoded ahead of need
                    self.prefetcher.was_prefetched(
                        engine.chunk_key(meta, s, e))
                    tiles = builder.build(meta.ident, value)
                    if ladder is not None and device_blame is not None:
                        # the host plane decoded the same chunk: the
                        # device failure was plane-local, charge it
                        ladder.confirm_failure("device", device_blame)
                    quarantined = (int(value["n"]) == 0
                                   and int(value["nbytes"]) == 0)
                else:
                    # device builds are never quarantined spans: the
                    # skip_bad_spans knob gates the device plane off
                    quarantined = False
                if not quarantined:
                    self.tiles.put(key, tiles)
                else:
                    # a QUARANTINED chunk (n = 0 and nbytes = 0: a truly
                    # empty chunk accounts >= 64 bytes) serves empty but
                    # is NOT cached, so a healed fault decodes again
                    METRICS.count("serve.tiles_uncached_quarantine")
            else:
                tile_hits += 1
            n_candidates += tiles.n
            keeps: List[torch.Tensor] = []
            with METRICS.span("serve.filter_wall"):
                for g in tiles.groups:
                    keep, hits = tile_filter_step(*g.cols, g.counts, iv_dev)
                    hits_total += hits.sum()
                    if job.want_records:
                        keeps.append(keep)
            if job.want_records and keeps:
                masks.append(((s, e), keeps))
        count = int(hits_total)
        records = None
        if job.want_records:
            records = self._materialize(meta, masks, builder)
        METRICS.count("serve.requests")
        self.prefetcher.note(meta, iv)
        return ServeResult(region=region, count=count,
                           n_candidates=n_candidates,
                           tile_hits=tile_hits, tile_misses=tile_misses,
                           records=records)

    @staticmethod
    def _flat_rows(masks: List[np.ndarray], builder: TileBuilder
                   ) -> np.ndarray:
        """Chunk-local row indices of kept rows, undoing the serial
        group/device packing of ``TileBuilder.build``."""
        rows: List[int] = []
        per_group = builder.n_dev * builder.cap
        for g_idx, k in enumerate(masks):
            for dev in range(builder.n_dev):
                hit = np.flatnonzero(k[dev])
                rows.extend(g_idx * per_group + dev * builder.cap + hit)
        return np.asarray(sorted(rows), dtype=np.int64)

    def _materialize(self, meta, masks, builder: TileBuilder
                     ) -> List[object]:
        """Host record objects for kept rows: the keep masks of every
        chunk come back in one copy, and the host chunk tier has (or
        re-decodes, byte-identically) the materializer state."""
        if not masks:
            return []
        flat = torch.cat([k.reshape(-1) for _, keeps in masks
                          for k in keeps]).cpu().numpy()
        shape = (builder.n_dev, builder.cap)
        size = builder.n_dev * builder.cap
        out: List[object] = []
        at = 0
        for (s, e), keeps in masks:
            host = [flat[at + i * size:at + (i + 1) * size].reshape(shape)
                    for i in range(len(keeps))]
            at += len(keeps) * size
            value = self.engine._chunk(meta, s, e)
            for row in self._flat_rows(host, builder):
                out.append(QueryEngine._materialize(meta, value, int(row)))
        return out
