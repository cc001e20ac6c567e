"""Predictive prefetch: decode the chunks a client is ABOUT to ask for
(copy of hadoop_bam_tpu/serve/prefetch.py).

Rapidgzip's access-layer insight (PAPERS.md) applied to region serving:
a zipf-skewed workload walks hot neighbourhoods, so after serving
``chr20:a-b`` the adjacent windows are disproportionately likely next.
After every served query the dispatcher calls ``note()``, which

1. predicts the next ``serve_prefetch_depth`` same-width windows past
   the served interval (and dedups against the per-file recency ring —
   a window served or predicted moments ago is already warm);
2. resolves the predictions through the in-memory index (cheap, on the
   dispatcher thread) to coalesced chunk ranges;
3. submits the EXPENSIVE part — fetch + inflate + host_decode into the
   host ``ChunkCache`` — to the shared decode pool at BACKGROUND
   priority (``utils.pools.submit(priority="bg")``), so prefetch soaks
   idle decode capacity but can never starve foreground admission.

Device-tile assembly stays on the dispatcher thread (all device calls stay
single-threaded): a later query for a prefetched window finds its chunk
host-decoded and only pays the tile build + transfer — the cheap tail.

Usefulness accounting: ``serve.prefetch_issued`` counts submitted chunk
decodes, ``serve.prefetch_useful`` ticks when a later foreground query
consumes a prefetched chunk; their ratio is the bench row's
``prefetch_hit_rate``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.utils.errors import PlanError, TransientIOError
from hadoop_bam_torch.utils.metrics import METRICS

_MAX_FILES = 64          # per-file recency rings kept (LRU)
_MAX_TRACKED = 1024      # prefetched-chunk provenance entries kept


class Prefetcher:
    """Recency+adjacency predictive prefetch (module docstring).

    ``note()`` runs on the dispatcher thread only; the submitted decode
    closures run on pool threads but touch only the thread-safe
    single-flight ``ChunkCache`` path."""

    def __init__(self, engine, config: HBamConfig = DEFAULT_CONFIG):
        self.engine = engine
        self.enabled = bool(getattr(config, "serve_prefetch", True))
        self.depth = max(0, int(getattr(config, "serve_prefetch_depth", 2)))
        self.recent_window = max(1, int(
            getattr(config, "serve_recent_regions", 16)))
        self.pause_pressure = float(getattr(
            config, "serve_prefetch_pause_pressure", 3.0))
        self.paused_total = 0
        self._config = config
        self._lock = threading.Lock()
        # per-file recency rings: ident -> deque of (rid, beg, end)
        self._recent: "OrderedDict[Tuple, deque]" = OrderedDict()
        # provenance of chunks decoded ahead of need: chunk key ->
        # False while the background decode is queued/running, True once
        # it COMPLETED (bounded LRU).  Only completed prefetches count
        # as useful — a mark consumed while still queued saved nothing
        self._prefetched: "OrderedDict[Tuple, bool]" = OrderedDict()
        self._outstanding: list = []      # live bg futures (drained)
        self.issued = 0
        self.useful = 0

    # -- dispatcher-side hooks ----------------------------------------------

    def was_prefetched(self, chunk_key: Tuple) -> bool:
        """Consume the provenance mark for a chunk a foreground query is
        now using; ticks ``serve.prefetch_useful`` once per chunk — and
        only when the background decode actually COMPLETED first (a
        prefetch the foreground overtook did no useful work and must
        not inflate the bench's prefetch_hit_rate)."""
        with self._lock:
            done = self._prefetched.pop(chunk_key, None)
            if not done:
                return False
            self.useful += 1
        METRICS.count("serve.prefetch_useful")
        return True

    def fault_paused(self) -> bool:
        """Auto-pause under fault pressure: when the resilience
        registry's decayed failure count crosses the config threshold,
        speculative decode is exactly the wrong way to spend pool
        capacity (every prefetched chunk competes with the retries and
        demoted-plane re-decodes that are healing the system) — so
        prediction pauses and resumes by itself as the pressure decays."""
        from hadoop_bam_torch import resilience

        if self.pause_pressure <= 0:
            return False
        if resilience.registry().fault_pressure() < self.pause_pressure:
            return False
        self.paused_total += 1
        METRICS.count("serve.prefetch_paused")
        return True

    def note(self, meta, iv) -> None:
        """Record a served interval and issue adjacent-window prefetch."""
        if not self.enabled or self.depth == 0:
            return
        if self.fault_paused():
            return
        rid = meta.ref_names.index(iv.rname)
        width = max(1, iv.end - iv.start + 1)
        with self._lock:
            ring = self._recent.get(meta.ident)
            if ring is None:
                while len(self._recent) >= _MAX_FILES:
                    self._recent.popitem(last=False)
                ring = self._recent[meta.ident] = deque(
                    maxlen=self.recent_window)
            else:
                self._recent.move_to_end(meta.ident)
            ring.append((rid, iv.start, iv.end))
            seen = list(ring)
        for d in range(1, self.depth + 1):
            beg = iv.end + 1 + (d - 1) * width
            end = beg + width - 1
            if any(r == rid and b <= beg and e >= end for r, b, e in seen):
                continue          # recently served/predicted: warm already
            with self._lock:
                ring.append((rid, beg, end))
            self._prefetch_window(meta, iv.rname, beg, end)

    def _prefetch_window(self, meta, rname: str, beg: int, end: int) -> None:
        from hadoop_bam_torch.utils import pools

        try:
            iv, ranges = self.engine._resolve(meta, f"{rname}:{beg}-{end}")
        except PlanError:
            return                # off the contig end / unindexable: skip
        chunks = self.engine._coalesce(ranges, meta.kind)
        pool = pools.decode_pool(self._config)
        for s, e in chunks:
            key = self.engine.chunk_key(meta, s, e)
            if self.engine.cache.contains(key):
                continue          # already decoded (or being decoded)
            with self._lock:
                if key in self._prefetched:
                    continue
                while len(self._prefetched) >= _MAX_TRACKED:
                    self._prefetched.popitem(last=False)
                self._prefetched[key] = False   # completion flips it
                self.issued += 1
            METRICS.count("serve.prefetch_issued")
            try:
                fut = pools.submit(pool, self._decode_quietly, meta, s, e,
                                   priority="bg")
            except Exception:  # noqa: BLE001 — speculative work only
                # a failed SUBMISSION (pool shutting down, injected
                # pool.submit chaos) must never surface through the
                # foreground serve path — the prediction just stays cold
                METRICS.count("serve.prefetch_errors")
                with self._lock:
                    self._prefetched.pop(key, None)
                continue
            with self._lock:
                self._outstanding.append(fut)
                self._outstanding = [f for f in self._outstanding
                                     if not f.done()]

    def _decode_quietly(self, meta, s: int, e: int) -> None:
        """Pool-side chunk decode into the host cache; speculative work
        never raises into the server (a transient fault just means the
        prediction stays cold)."""
        key = self.engine.chunk_key(meta, s, e)
        try:
            self.engine._chunk(meta, s, e)
        except (TransientIOError, PlanError, OSError, ValueError):
            METRICS.count("serve.prefetch_errors")
            with self._lock:
                self._prefetched.pop(key, None)
        else:
            with self._lock:
                if key in self._prefetched:
                    self._prefetched[key] = True

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout: Optional[float] = 10.0) -> None:
        """Wait for every outstanding prefetch decode (tests + shutdown)."""
        import concurrent.futures as cf
        with self._lock:
            pending = list(self._outstanding)
            self._outstanding = []
        if pending:
            cf.wait(pending, timeout=timeout)

    def stop(self) -> None:
        from hadoop_bam_torch.utils.pools import cancel_background
        cancel_background()
        self.drain(timeout=5.0)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            issued, useful = self.issued, self.useful
        return {"issued": issued, "useful": useful,
                "hit_rate": (useful / issued) if issued else 0.0,
                "paused_total": self.paused_total}
