"""Plane selection (trimmed copy of hadoop_bam_tpu/plan/executor.py).

``select_plane`` is the one predicate table that decides which decode
plane a driver call (or a serve request's cold tile builds) runs on and
why every other plane was rejected:
the device gates of the reference (:176-194) -- the plane was named,
the source has a device plane (``device_capable``: the reference's
``_DEVICE_DAGS`` row, which only the variant driver can fail), no
interval filter, no ``skip_bad_spans``, and the device fault domain's
breaker lets the run through -- and the fused-decode gates
(``_use_fused``, ``_fused_stream_gate``).  No IR: every driver family
the port routes (flagstat, payload, serve tiles, variant stats) passes
its capability, so one decision serves them all.  ``plane_report`` is
the display-only decision of the serve ``health()``.
``run_chunk_columns`` is the reference's
query-chunk runner (``_run_chunk_columns``), called by the query engine
directly until the plan IR is ported, and ``run_cohort_batches`` its
cohort tensor feed (``_run_cohort_batches``), called by
``CohortDataset.tensor_batches``.

One deliberate difference: the reference's fused gate also asks whether
the native library exports the ``hbam_fused_*`` entry points and falls
back to the two-pass path when it does not.  The port builds that
library from the repo's own source, so a library without them is a
build fault: the fused decode raises NativeBuildError
(``utils/native.FusedJob``) instead of running the other path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import (
    DEFAULT_CONFIG, HBamConfig, resolve_inflate_backend,
)
from hadoop_bam_torch.utils.metrics import METRICS


@dataclasses.dataclass(frozen=True)
class PlaneDecision:
    """One driver call's routing: the selected plane, the backend the
    host span decoders take, and why each rejected plane failed."""
    plane: str            # "device" | "native" | "zlib"
    backend: str          # resolve_inflate_backend(config)
    host_backend: str     # what host span decoders pass as backend
    stream_fused: bool    # host spans decode as fused chunk streams
    rejected: Tuple[Tuple[str, str], ...]   # (plane or mode, reason)

    def to_doc(self) -> Dict:
        return {"plane": self.plane,
                "backend": self.backend, "host_backend": self.host_backend,
                "stream_fused": self.stream_fused,
                "rejected": {p: r for p, r in self.rejected}}


def _use_fused(config: Optional[HBamConfig],
               backend: str = "native") -> bool:
    """Does a host span decode on ``backend`` take the fused native
    inflate + walk + pack?  ``config.use_fused_decode`` (default on) and
    a native backend; the span decoders consult it directly, below the
    plan grain, since the demotion ladder moves spans between planes."""
    cfg = config if config is not None else DEFAULT_CONFIG
    return bool(cfg.use_fused_decode) and backend == "native"


def _fused_stream_gate(config: Optional[HBamConfig], intervals) -> bool:
    """May the drivers stream fused chunks into the staging ring?  Fused
    on, no interval filter (the row mask needs the whole span's
    offsets) and no ``skip_bad_spans`` (quarantine is span-granular: a
    streamed span's early chunks are already dispatched when a late one
    turns out corrupt)."""
    cfg = config if config is not None else DEFAULT_CONFIG
    return _use_fused(cfg) and intervals is None and not cfg.skip_bad_spans


def select_plane(config: Optional[HBamConfig], *, intervals=None,
                 ladder=None, device_capable: bool = True) -> PlaneDecision:
    """THE plane-selection table.  ``intervals`` is the parsed interval
    filter (None: no filtering; a serve chunk has none).
    ``device_capable`` is the reference's capability row
    (``_device_capable``): False for a source the device plane does not
    decode (the variant driver passes True for a ``.bcf`` path only,
    its ``VARIANT_DAG`` row).  ``ladder`` is the file's
    ``DemotionLadder`` when adaptive planes are on; its device breaker
    is consulted LAST, only when every other device gate passed, since
    ``allow_plane`` uses up a half-open probe slot."""
    cfg = config if config is not None else DEFAULT_CONFIG
    backend = resolve_inflate_backend(cfg)
    host_backend = "zlib" if backend == "zlib" else "native"
    rejected = []
    fused = _use_fused(cfg, host_backend)
    if not cfg.use_fused_decode:
        rejected.append(("fused", "config.use_fused_decode is off"))
    elif not fused:
        rejected.append(("fused", f"backend {host_backend!r} disables the "
                                  f"native fused sweep"))
    stream = fused and _fused_stream_gate(cfg, intervals)
    if fused and not stream:
        rejected.append(
            ("fused-stream",
             "interval filtering needs the whole span's offsets"
             if intervals is not None
             else "skip_bad_spans needs span-granular quarantine"))
    plane = None
    if backend != "device":
        rejected.append(
            ("device", f"inflate_backend resolved to {backend!r}"))
    elif not device_capable:
        rejected.append(
            ("device", "no device decode plane for this source (token-"
                       "feed families: BAM flagstat/payload/serve-tile, "
                       "BCF variant)"))
    elif intervals is not None:
        rejected.append(
            ("device", "interval filtering needs whole-span offsets "
                       "on the host"))
    elif cfg.skip_bad_spans:
        rejected.append(
            ("device", "skip_bad_spans needs span-granular quarantine"))
    elif ladder is not None and not ladder.allow_plane("device"):
        rejected.append(
            ("device", "device fault-domain breaker is OPEN"))
    else:
        plane = "device"
    if plane is None:
        if backend == "zlib":
            rejected.append(
                ("native", "inflate_backend='zlib' pins the portable "
                           "plane"))
        plane = host_backend
    return PlaneDecision(plane=plane, backend=backend,
                         host_backend=host_backend, stream_fused=stream,
                         rejected=tuple(rejected))


def plane_report(config: Optional[HBamConfig] = None) -> Dict:
    """Display-only plane decision for this config -- the serve
    ``health()`` surface.  Never consumes breaker probes (no ladder) and
    never touches files; the interval gate is approximated by whether
    ``config.bam_intervals`` is set."""
    cfg = config if config is not None else DEFAULT_CONFIG
    intervals = () if cfg.bam_intervals else None
    return select_plane(cfg, intervals=intervals).to_doc()


def run_chunk_columns(span, config: HBamConfig, decode_fn: Callable
                      ) -> Tuple[Dict[str, object], Optional[int]]:
    """One query-engine chunk: ``decode_fn(span)`` under
    ``decode_with_retry``.  Returns the ``(columns, cache cost)`` pair
    ``ChunkCache.get_or_compute`` stores: cost None for a chunk that
    ``skip_bad_spans`` quarantined, which is served empty and not
    cached, so a healed fault decodes again on the next query.
    The ``query.decode_wall`` span, ``query.chunk_fetch_s`` and
    ``query.chunk_bytes`` histograms (cache misses only), and the
    ``query.chunks_decoded`` / ``query.chunks_skipped`` counters."""
    from hadoop_bam_torch.parallel.pipeline import decode_with_retry
    t0 = time.perf_counter()
    with METRICS.span("query.decode_wall", kind="bam"):
        value = decode_with_retry(decode_fn, span, config)
    METRICS.observe("query.chunk_fetch_s", time.perf_counter() - t0)
    if value is None:
        METRICS.count("query.chunks_skipped")
        return ({"rid": np.empty(0, np.int32),
                 "pos1": np.empty(0, np.int32),
                 "end1": np.empty(0, np.int32),
                 "records": [], "n": 0, "nbytes": 0}, None)
    METRICS.observe("query.chunk_bytes", int(value["nbytes"]))
    METRICS.count("query.chunks_decoded")
    return (value, int(value["nbytes"]))


def run_cohort_batches(dataset, geometry=None) -> Iterator[Dict]:
    """The cohort tensor feed: ``dataset.site_chunks()`` (the joined
    chunks) through ``variant_feed`` in fixed-shape tiles whose rows fill
    the device in order, every batch ``cap`` rows, each group copied to
    the dataset's device with its ``n_records``, the copies' event as the
    ring slot's in-flight handle (``_batch_emit``); the copies are timed
    as ``cohort.dispatch_wall``.  A generator, so a ``tensor_batches``
    that is built but never iterated starts no join and opens no
    journal."""
    def gen():
        from hadoop_bam_torch.parallel.pipeline import _batch_emit
        from hadoop_bam_torch.parallel.variant_pipeline import variant_feed

        geom = dataset.geometry if geometry is None else geometry
        dev = dataset.device
        keys, fp, tuples = variant_feed(
            dataset.site_chunks(), 1, geom.tile_records, fixed_shape=True,
            balance=False, pin_memory=dev.type == "cuda")
        if fp is None:
            return
        emit = _batch_emit(dev, keys)

        def timed(tensors, counts):
            with METRICS.wall_timer("cohort.dispatch_wall"):
                return emit(tensors, counts)

        yield from fp.stream(tuples, timed)

    return gen()
