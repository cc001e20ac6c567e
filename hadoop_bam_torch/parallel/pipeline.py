"""The decode pipeline: spans -> host inflate -> device batches -> reduce.

Counterpart of hadoop_bam_tpu/parallel/pipeline.py:

    plan record-aligned spans, once      split/planners.plan_spans_cached
    a file and request (sidecar-snapped
    or guessed; .bai-trimmed intervals)
    inflate + walk each span (threads)   ops/inflate (native C++ or zlib)
    -- the native plane's fused pass     ops/inflate.FusedSpanDecode
    streams chunks of rows
    pack fixed-stride row tiles          FeedPipeline / StagingRing
    copy tiles to the device             pinned memory, non_blocking
    unpack + reduce there                the step functions below
    sum the partial results              DataAxis.sum, then one drain

Drivers: ``flagstat_file`` (projected-row tiles, or ``mode="span"``:
whole inflated spans through the K1 gather kernel) and ``seq_stats_file``
(payload tiles through the K2 stats kernel).  With
``config.inflate_backend="device"`` ("auto" is the native plane) both
drivers run the device decode plane instead: the host only
tokenizes, and LZ77 resolve, record walk, fixed-field unpack and the
reduction run on the card (section "The device decode plane" below).

Every span decodes under the reference's failure policy
(``decode_with_retry``): transient faults retry, corrupt spans demote
along the device -> native -> zlib ladder (resilience/domains.py) and
are quarantined or raised per ``skip_bad_spans``; ``bam_intervals``
filters records on the host planes (``select_plane`` keeps the device
plane off then).  On the native plane each span decodes in one fused
native pass (section "Fused single-pass span decode"), streamed into the
staging ring chunk by chunk unless intervals or ``skip_bad_spans`` need
the whole span; the two-pass path stays as its oracle and runs with
``use_fused_decode=False``, on the zlib plane, for empty spans and for
a final record cut at the span's last block.

Counters (utils/metrics.py): ``pipeline.spans``, ``pipeline.blocks``,
``pipeline.inflated_bytes`` and ``pipeline.records`` of the host planes'
span decodes, as the reference counts them; ``pipeline.fused_tail_
fallbacks``, the fused spans finished by the two-pass path.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import logging
import os
import time
from collections import deque
from typing import (
    Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch

from hadoop_bam_torch.config import (
    DEFAULT_CONFIG, HBamConfig, resolve_inflate_backend,
)
from hadoop_bam_torch.device import DataAxis, data_axis
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bam import BAMError, BamBatch, SAMHeader
from hadoop_bam_torch.formats.bamio import read_bam_header
from hadoop_bam_torch.jobs.speculate import UnitLatency
from hadoop_bam_torch.ops import inflate as inflate_ops
from hadoop_bam_torch.ops.cigar import (
    coverage_diff_from_tiles, window_coverage_from_tiles,
)
from hadoop_bam_torch.ops.flagstat import FLAGSTAT_FIELDS, flagstat_vector
from hadoop_bam_torch.ops.inflate_device import (
    ladder_pow2, records_cap, require_tokenizer, resolve_walk_fields,
    resolve_walk_payload, round_pow2,
)
from hadoop_bam_torch.ops.seq_stats import N_CODES, seq_qual_stats
from hadoop_bam_torch.ops.unpack_bam import (
    ALL_FIELDS, FLAGSTAT_PROJECTION, PREFIX, projection_ranges,
    projection_row_bytes, unpack_fixed_fields, unpack_projected_tile,
)
from hadoop_bam_torch.parallel.staging import (
    FeedPipeline, StagingRing, TileSpec,
)
from hadoop_bam_torch.plan.executor import (
    PlaneDecision, _use_fused, select_plane,
)
from hadoop_bam_torch.resilience import chaos
from hadoop_bam_torch.resilience.domains import (
    DemotionLadder, check_quarantine_gate, decode_ladder, quarantine_run_ok,
)
from hadoop_bam_torch.split.intervals import (
    batch_overlap_mask, parse_intervals,
)
from hadoop_bam_torch.split.bam_guesser import BAMSplitGuesser
from hadoop_bam_torch.split.planners import iter_bam_spans, plan_spans_cached
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.utils import native
from hadoop_bam_torch.utils.errors import (
    CORRUPT, PLAN, TRANSIENT, CorruptDataError, PlanError, TransientIOError,
    classify_error,
)
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.pools import submit as pool_submit
from hadoop_bam_torch.utils.resilient import (
    QuarantineManifest, RetryingByteSource, RetryPolicy, call_with_retry,
    span_retry_policy,
)
from hadoop_bam_torch.utils.seekable import (
    as_byte_source, scoped_byte_source,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DecodeGeometry:
    """Caps of one device's slice of a span batch."""
    bytes_cap: int = 1 << 24       # inflated bytes per span (span mode)
    records_cap: int = 1 << 18     # record offsets per span (span mode)
    tile_records: int = 1 << 18    # records per device per step (tiles)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class PayloadGeometry:
    """Shapes of the seq/qual payload tiles: strides round up to 32
    bytes; reads longer than max_len are truncated on pack (the full
    l_seq stays in the prefix columns)."""
    max_len: int = 160             # bases per read kept on device
    tile_records: int = 1 << 16    # records per device per step
    block_n: int = 256             # bucket rounding of partial tiles
    fixed_shape: bool = False      # True: the final partial batch pads
    #                                to tile_records instead of shrinking
    #                                to a bucket (consumers that
    #                                preallocate by tile_records)

    @property
    def seq_stride(self) -> int:
        return _round_up((self.max_len + 1) // 2, 32)

    @property
    def qual_stride(self) -> int:
        return _round_up(self.max_len, 32)


# ---------------------------------------------------------------------------
# Host stages
# ---------------------------------------------------------------------------

def _fetch_span_raw(src, span: FileVirtualSpan) -> Tuple[bytes, int, int]:
    """One span's compressed bytes: the whole blocks in [start_c, end_c)
    plus the block AT end_c when the span ends inside it.  Returns
    (raw, end_block_size, next_c), next_c being the compressed offset of
    the first block past the fetched bytes."""
    start_c, _ = span.start
    end_c, end_u = span.end
    raw = src.pread(start_c, max(end_c - start_c, 0))
    end_block_size = 0
    if end_u > 0 and end_c < src.size:
        head = src.pread(end_c, bgzf.MAX_BLOCK_SIZE)
        end_block_size = bgzf.parse_block_header(head, 0).block_size
        raw = raw + head[:end_block_size]
    next_c = (end_c + end_block_size) if raw else start_c
    return raw, end_block_size, next_c


def _decode_span_core(source, span: FileVirtualSpan, check_crc: bool,
                      backend: str, packed_walker: Optional[Callable] = None,
                      want_voffs: bool = True):
    """Fetch + inflate one span and walk the records that START inside
    it; the last owned record may extend into following blocks, which
    are fetched as needed.  Returns (data, offs, voffs, rows), unpadded;
    ``rows`` is what ``packed_walker`` packed (else None)."""
    src = as_byte_source(source)
    try:
        return _decode_span_src(src, span, check_crc, backend,
                                packed_walker, want_voffs)
    finally:
        if src is not source:
            src.close()


def _decode_span_src(src, span: FileVirtualSpan, check_crc: bool,
                     backend: str, packed_walker: Optional[Callable],
                     want_voffs: bool):
    start_u = span.start[1]
    end_u = span.end[1]
    METRICS.count("pipeline.spans")
    raw, end_block_size, next_c = _fetch_span_raw(src, span)
    if raw:
        table = inflate_ops.block_table(raw)
        with METRICS.timer("pipeline.inflate"), \
                METRICS.span("bam.inflate_wall", nbytes=len(raw)):
            data, ubase = inflate_ops.inflate_span(raw, table,
                                                   backend=backend)
        METRICS.count("pipeline.blocks", int(table["isize"].size))
        METRICS.count("pipeline.inflated_bytes", int(data.size))
        if check_crc:
            inflate_ops.verify_crcs(raw, table, data, ubase, backend)
        abs_coffs = table["coffset"] + span.start[0]
    else:
        data = np.empty(0, dtype=np.uint8)
        ubase = np.empty(0, dtype=np.int64)
        abs_coffs = np.empty(0, dtype=np.int64)

    def extend_past(tail: int) -> None:
        """Inflate following blocks until the record starting at ``tail``
        is complete (one final concatenate)."""
        nonlocal data, ubase, abs_coffs, next_c
        chunks: List[np.ndarray] = [data]
        new_bases: List[int] = []
        new_coffs: List[int] = []
        cur = data.size

        def fetch_block() -> None:
            nonlocal cur, next_c
            head = src.pread(next_c, bgzf.MAX_BLOCK_SIZE)
            info = bgzf.parse_block_header(head, 0)
            extra = bgzf.inflate_block(head, info, check_crc=check_crc)
            new_bases.append(cur)
            new_coffs.append(next_c)
            chunks.append(np.frombuffer(extra, np.uint8))
            cur += len(extra)
            next_c += info.block_size

        while cur < tail + 4 and next_c < src.size:
            fetch_block()
        if cur >= tail + 4:
            whole = np.concatenate(chunks)
            bs = int.from_bytes(whole[tail:tail + 4].tobytes(), "little",
                                signed=True)
            while cur < tail + 4 + max(bs, 0) and next_c < src.size:
                fetch_block()
        if new_bases:
            ubase = np.concatenate([ubase, np.asarray(new_bases, np.int64)])
            abs_coffs = np.concatenate(
                [abs_coffs, np.asarray(new_coffs, np.int64)])
            data = np.concatenate(chunks)

    # the span may end inside the block at end_c: its first end_u
    # inflated bytes still hold records owned by this span
    end_inflated = int(ubase[-1]) + end_u if end_block_size else data.size
    rows = None
    while True:
        if packed_walker is not None:
            rows, offs, tail = packed_walker(data, start_u, end_inflated)
        else:
            offs, tail = inflate_ops.walk_records(data, start_u, backend)
        if tail < end_inflated and next_c < src.size:
            prev_size = data.size
            extend_past(tail)
            if data.size == prev_size:
                break  # no more bytes to fetch: truncated file
            continue
        break
    keep = int(np.searchsorted(offs, max(end_inflated, 1)))
    offs = offs[:keep]
    if rows is not None:
        rows = rows[:keep]
    METRICS.count("pipeline.records", int(offs.size))
    voffs = _voffsets(offs, ubase, abs_coffs) if want_voffs \
        else np.empty(0, dtype=np.uint64)
    return data, offs, voffs, rows


def _voffsets(offs: np.ndarray, ubase: np.ndarray, abs_coffs: np.ndarray
              ) -> np.ndarray:
    """Inflated-span record offsets -> packed virtual offsets, given each
    block's inflated start and absolute compressed offset; an offset at
    a block's end maps to the next block's start (htsjdk's normal
    form)."""
    if not offs.size:
        return np.empty(0, dtype=np.uint64)
    blk = np.searchsorted(ubase, offs, side="right") - 1
    return (abs_coffs[blk].astype(np.uint64) << np.uint64(16)) | \
        (offs - ubase[blk]).astype(np.uint64)

# ---------------------------------------------------------------------------
# Fused single-pass span decode (ops/inflate.FusedSpanDecode over the
# native hbam_fused_*): native workers inflate runs of
# config.decode_chunk_blocks blocks, and the record walk, the row pack and
# the CRC fold consume those bytes while they are cache-hot, where the
# two-pass path (_decode_span_core) inflates the span to memory and walks
# it again.  The two-pass path stays as the oracle the fused outputs equal
# byte for byte, and runs for use_fused_decode=False, the zlib plane,
# empty spans and a final record cut at the span's last block.
# ---------------------------------------------------------------------------

def _close_stream(item) -> None:
    """``iter_windowed``'s cleanup: join a fused chunk stream's native
    workers; buffered results need nothing."""
    close = getattr(item, "close", None)
    if close is not None:
        close()


def _flatten_span_stream(items) -> Iterator[Tuple[np.ndarray, ...]]:
    """FeedPipeline input from mixed decode results: an array or a tuple
    of arrays is one span's item; a fused chunk stream gives its chunks'
    tuples."""
    for item in items:
        if isinstance(item, np.ndarray):
            yield (item,)
        elif isinstance(item, tuple):
            yield item
        else:
            yield from item


def _stream_window(window: int) -> int:
    """The in-flight window of streamed fused decode: each windowed span
    is a live native job of up to one thread per CPU (the pool task
    only fetches and starts it), so the pool-sized window would
    oversubscribe the host several times over."""
    return min(window, max(2, 2 * (os.cpu_count() or 1)))


def _fused_off(config: Optional[HBamConfig]) -> HBamConfig:
    """``config`` with the fused path off: what a streamed span's
    cut-tail fallback decodes with (the two-pass oracle, not the fused
    decode that just stopped short)."""
    cfg = config if config is not None else DEFAULT_CONFIG
    return dataclasses.replace(cfg, use_fused_decode=False)


def _start_fused_span(src, span: FileVirtualSpan, mode: str, *,
                      sel=None, row_bytes: int = 0,
                      geometry: Optional["PayloadGeometry"] = None,
                      check_crc: bool = False,
                      config: Optional[HBamConfig] = None):
    """Fetch one span and start its fused native job.  The fetch runs on
    the caller's thread, so a transient read fault surfaces inside
    ``decode_with_retry`` even when the chunks are consumed later.
    Returns (dec, end_inflated, next_c, table), or None for an empty
    span (the two-pass path handles those)."""
    raw, end_block_size, next_c = _fetch_span_raw(src, span)
    if not raw:
        return None
    table = inflate_ops.block_table(raw)
    isize = table["isize"]
    total = int(isize.sum())
    end_inflated = (total - int(isize[-1]) + span.end[1]) \
        if end_block_size else total
    cfg = config if config is not None else DEFAULT_CONFIG
    kwargs = {}
    if mode == "rows":
        kwargs = dict(sel=sel, row_stride=row_bytes)
    elif mode == "payload":
        kwargs = dict(max_len=geometry.max_len,
                      seq_stride=geometry.seq_stride,
                      qual_stride=geometry.qual_stride)
    dec = inflate_ops.FusedSpanDecode(
        raw, table, start=span.start[1], stop=end_inflated, mode=mode,
        check_crc=check_crc,
        chunk_blocks=max(1, int(cfg.decode_chunk_blocks)), **kwargs)
    return dec, end_inflated, next_c, table


def _fused_span_counts(dec, table, n: int) -> None:
    """A fused span's counters once it succeeded (the two-pass path
    counts its own; a span that falls back is counted there, once)."""
    METRICS.count("pipeline.spans")
    METRICS.count("pipeline.blocks", int(table["isize"].size))
    METRICS.count("pipeline.inflated_bytes", int(dec.data.size))
    METRICS.count("pipeline.records", n)


def _decode_span_fused(source, span: FileVirtualSpan, mode: str, *,
                       check_crc: bool = False, sel=None, row_bytes: int = 0,
                       geometry: Optional["PayloadGeometry"] = None,
                       want_voffs: bool = True,
                       config: Optional[HBamConfig] = None):
    """One span's fused decode, not streamed: (data, offs, voffs, outs)
    with ``outs`` the mode's rows, (prefix, seq, qual) or None; or None
    when the span needs the two-pass path (empty, or its final owned
    record runs past the span's last block: ``pipeline.fused_tail_
    fallbacks``)."""
    src = as_byte_source(source)
    try:
        started = _start_fused_span(src, span, mode, sel=sel,
                                    row_bytes=row_bytes, geometry=geometry,
                                    check_crc=check_crc, config=config)
        if started is None:
            return None
        dec, end_inflated, next_c, table = started
        try:
            n, tail = dec.run()
        except Exception:
            # the two-pass path counts a span on entry, failed or not
            METRICS.count("pipeline.spans")
            raise
        if tail < end_inflated and next_c < src.size:
            METRICS.count("pipeline.fused_tail_fallbacks")
            return None
    finally:
        if src is not source:
            src.close()
    _fused_span_counts(dec, table, n)
    offs = dec.offsets[:n]
    voffs = _voffsets(offs, dec.ubase, table["coffset"] + span.start[0]) \
        if want_voffs else np.empty(0, dtype=np.uint64)
    if mode == "rows":
        outs = dec.rows[:n]
    elif mode == "payload":
        outs = (dec.prefix[:n], dec.seq[:n], dec.qual[:n])
    else:
        outs = None
    return dec.data, offs, voffs, outs


class _FusedChunkStream:
    """One span's streamed fused decode: iterate it for row-array tuples;
    ``close()`` joins the native workers, whether or not iteration ever
    started."""

    __slots__ = ("_dec", "_gen")

    def __init__(self, dec, gen):
        self._dec = dec
        self._gen = gen

    def __iter__(self):
        return self._gen

    def close(self) -> None:
        self._gen.close()
        self._dec.finish(check=False)


def _iter_fused_span_chunks(src, span: FileVirtualSpan, mode: str, *,
                            sel=None, row_bytes: int = 0,
                            geometry: Optional["PayloadGeometry"] = None,
                            check_crc: bool = False,
                            config: Optional[HBamConfig] = None,
                            fallback_fn: Optional[Callable] = None):
    """Streamed fused decode: fetch the span and start its native job
    now (on the caller's thread, inside the retry boundary), and return
    an iterable of row-array tuples in record order -- ``(rows,)`` in
    mode "rows", ``(prefix, seq, qual)`` in "payload" -- each handed out
    as the native walk publishes it, so staging tiles pack before the
    span's last blocks are inflated.

    A span whose final owned record is cut at its last block finishes
    through ``fallback_fn`` (the two-pass oracle under its own
    ``decode_with_retry``, returning the whole span's tuple): its rows
    past the fused count follow, so the stream equals the buffered
    paths byte for byte.  Corruption raises from the iterator, on the
    consumer's thread, outside ``decode_with_retry``; its counters are
    ticked here as the two-pass path would tick them."""
    started = _start_fused_span(src, span, mode, sel=sel,
                                row_bytes=row_bytes, geometry=geometry,
                                check_crc=check_crc, config=config)
    if started is None:
        METRICS.count("pipeline.spans")     # an empty span, still planned
        return iter(())
    dec, end_inflated, next_c, table = started
    src_size = src.size

    def slices(lo: int, hi: int) -> Tuple[np.ndarray, ...]:
        if mode == "rows":
            return (dec.rows[lo:hi],)
        return (dec.prefix[lo:hi], dec.seq[lo:hi], dec.qual[lo:hi])

    def gen():
        try:
            # the consumption IS the span's host decode (the native
            # waits are inflate + walk work): the reference's
            # host_decode timer and wall, fused_decode the sub-stage
            with METRICS.timer("pipeline.host_decode"), \
                    METRICS.wall_timer("pipeline.host_decode_wall"), \
                    METRICS.timer("pipeline.fused_decode"), \
                    METRICS.span("bam.fused_decode_wall",
                                 nbytes=int(dec.data.size)):
                for lo, hi in dec.chunks():
                    yield slices(lo, hi)
            n, tail = dec.finish()
        except GeneratorExit:
            dec.finish(check=False)
            raise
        except Exception as e:  # noqa: BLE001 -- counters, then re-raised
            METRICS.count("pipeline.spans")
            if classify_error(e) == CORRUPT:
                METRICS.count("pipeline.corrupt_spans")
            raise
        if tail < end_inflated and next_c < src_size:
            METRICS.count("pipeline.fused_tail_fallbacks")
            rest = tuple(a[n:] for a in fallback_fn())
            if rest[0].shape[0]:
                yield rest
        else:
            _fused_span_counts(dec, table, n)

    return _FusedChunkStream(dec, gen())


def decode_span_host(source, span: FileVirtualSpan, geometry: DecodeGeometry,
                     check_crc: bool = False, backend: str = "native",
                     config: Optional[HBamConfig] = None,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Span mode: the span's inflated bytes and its owned record offsets
    (int32), unpadded, from the fused pass in offsets mode on the native
    plane (``config.use_fused_decode``).  Returns (data, offsets,
    voffsets); a span over the geometry's caps raises PlanError (plan
    smaller spans)."""
    got = _decode_span_fused(source, span, "offsets", check_crc=check_crc,
                             config=config) \
        if _use_fused(config, backend) else None
    if got is None:
        got = _decode_span_core(source, span, check_crc, backend)
    data, offs, voffs, _ = got
    g = geometry
    if data.size > g.bytes_cap or offs.size > g.records_cap:
        raise PlanError(
            f"span exceeds geometry: {data.size}B/{offs.size} records vs "
            f"caps {g.bytes_cap}B/{g.records_cap} — plan smaller spans")
    return data, offs.astype(np.int32), voffs


@dataclasses.dataclass
class HostSpanBatch:
    """A decoded span group, stacked for n_dev devices (span mode)."""
    data: np.ndarray       # [n_dev, bytes_cap] uint8
    offsets: np.ndarray    # [n_dev, records_cap] int32
    n_records: np.ndarray  # [n_dev] int32
    voffsets: List[np.ndarray]


def stack_span_group(source, spans: Sequence[FileVirtualSpan], n_dev: int,
                     geometry: DecodeGeometry) -> HostSpanBatch:
    """Decode up to n_dev spans and stack them into the span-mode batch
    shape, zero-padded to the geometry's caps; a missing span is an
    empty shard."""
    outs = [decode_span_host(source, span, geometry)
            for span in list(spans)[:n_dev]]
    data = np.zeros((n_dev, geometry.bytes_cap), dtype=np.uint8)
    offsets = np.zeros((n_dev, geometry.records_cap), dtype=np.int32)
    counts = np.zeros((n_dev,), dtype=np.int32)
    voffs: List[np.ndarray] = [np.empty(0, dtype=np.uint64)] * n_dev
    for i, (d, o, v) in enumerate(outs):
        data[i, :d.size] = d
        offsets[i, :o.size] = o
        counts[i] = o.size
        voffs[i] = v
    return HostSpanBatch(data, offsets, counts, voffs)


def iter_span_groups(spans: Sequence[FileVirtualSpan], n_dev: int
                     ) -> Iterator[List[FileVirtualSpan]]:
    """The plan in groups of n_dev spans (the last may be short)."""
    spans = list(spans)
    for i in range(0, len(spans), n_dev):
        yield spans[i:i + n_dev]


def _interval_mask(data: np.ndarray, offs: np.ndarray, header, intervals
                   ) -> np.ndarray:
    """Row keep-mask of the interval filter: overlap of pos + CIGAR
    reference span with any interval (split/intervals.py)."""
    return batch_overlap_mask(
        BamBatch(data, offs.astype(np.int64), header=header), intervals,
        header)


def decode_span_prefix_host(source, span: FileVirtualSpan,
                            check_crc: bool = False,
                            backend: str = "native",
                            projection: Tuple[str, ...] = ALL_FIELDS,
                            want_voffs: bool = True,
                            intervals=None, header=None,
                            config: Optional[HBamConfig] = None,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Prefix mode: each owned record's projected prefix bytes packed
    densely.  Returns (rows[n, row_bytes] uint8, voffsets[n]).  The
    native plane inflates, walks and packs in the fused pass (two-pass
    with ``use_fused_decode`` off: walk and pack in one C++ pass).  With
    ``intervals``, only records overlapping one of them are kept."""
    row_bytes = projection_row_bytes(projection)
    ranges = projection_ranges(projection)
    got = _decode_span_fused(source, span, "rows", check_crc=check_crc,
                             sel=ranges, row_bytes=row_bytes,
                             want_voffs=want_voffs, config=config) \
        if _use_fused(config, backend) else None
    walker = None
    if got is None and backend == "native":
        def walker(data, start, end_limit):
            stop = min(int(end_limit), data.size)
            cap = max(16, (stop - start) // 36 + 1)
            return native.walk_bam_packed(np.ascontiguousarray(data), start,
                                          cap, ranges, row_bytes, stop=stop)
    data, offs, voffs, rows = got if got is not None else _decode_span_core(
        source, span, check_crc, backend, packed_walker=walker,
        want_voffs=want_voffs)
    if rows is None:
        tile = data[offs[:, None] + np.arange(PREFIX)[None, :]] \
            if offs.size else np.empty((0, PREFIX), np.uint8)
        rows = np.concatenate([tile[:, o:o + w] for o, w in ranges], axis=1)
    if intervals and offs.size:
        keep = _interval_mask(data, offs, header, intervals)
        rows = rows[keep]
        if voffs.size:
            voffs = voffs[keep]
    return rows, voffs


def _pack_payload_numpy(data: np.ndarray, offs: np.ndarray,
                        g: PayloadGeometry):
    """The zlib plane's payload pack: prefix, 4-bit seq and qual rows
    gathered from the inflated span, with the native walker's checks."""
    n = offs.size
    prefix = data[offs[:, None] + np.arange(PREFIX)[None, :]] if n \
        else np.empty((0, PREFIX), np.uint8)
    p32 = prefix.astype(np.int64)
    l_read_name = p32[:, 12]
    n_cigar = p32[:, 16] | (p32[:, 17] << 8)
    l_seq = prefix[:, 20:24].copy().view("<i4")[:, 0].astype(np.int64)
    bs = prefix[:, 0:4].copy().view("<i4")[:, 0].astype(np.int64)
    seq_rel = PREFIX + l_read_name + 4 * n_cigar
    nb = (l_seq + 1) // 2
    if n and ((l_seq < 0) | (seq_rel + nb + l_seq > 4 + bs)).any():
        raise ValueError("malformed BAM record chain")
    use = np.minimum(l_seq, g.max_len)
    last = max(data.size - 1, 0)

    def rows(start, width, length):
        col = np.arange(width)[None, :]
        idx = np.minimum(start[:, None] + col, last)
        return np.where(col < length[:, None], data[idx], 0).astype(np.uint8)

    seq_off = offs + seq_rel
    seq = rows(seq_off, g.seq_stride, (use + 1) // 2)
    qual = rows(seq_off + nb, g.qual_stride, use)
    return prefix, seq, qual


def decode_span_payload_host(source, span: FileVirtualSpan,
                             geometry: PayloadGeometry,
                             check_crc: bool = False,
                             backend: str = "native",
                             want_voffs: bool = False,
                             intervals=None, header=None,
                             config: Optional[HBamConfig] = None):
    """Payload mode: prefix + 4-bit seq + qual packed into dense rows.
    Returns (prefix[n, 36], seq[n, seq_stride], qual[n, qual_stride],
    voffsets[n]).  The native plane packs in the fused pass (two-pass
    with ``use_fused_decode`` off: hbam_walk_bam_payload).  With
    ``intervals``, only records overlapping one of them are kept."""
    g = geometry
    got = _decode_span_fused(source, span, "payload", check_crc=check_crc,
                             geometry=g, want_voffs=want_voffs,
                             config=config) \
        if _use_fused(config, backend) else None
    out: Dict[str, np.ndarray] = {}
    walker = None
    if got is None and backend == "native":
        def walker(data, start, end_limit):
            stop = min(int(end_limit), data.size)
            cap = max(16, (stop - start) // 36 + 1)
            prefix, seq, qual, offs, tail = native.walk_bam_payload(
                np.ascontiguousarray(data), start, cap, g.max_len,
                g.seq_stride, g.qual_stride, stop=stop)
            out["seq"], out["qual"] = seq, qual
            return prefix, offs, tail
    if got is not None:
        data, offs, voffs, (prefix, seq, qual) = got
    else:
        data, offs, voffs, rows = _decode_span_core(
            source, span, check_crc, backend, packed_walker=walker,
            want_voffs=want_voffs)
        if rows is not None:
            n = int(offs.size)
            prefix, seq, qual = rows, out["seq"][:n], out["qual"][:n]
        else:
            prefix, seq, qual = _pack_payload_numpy(data, offs, g)
    n = int(offs.size)
    if intervals and n:
        keep = _interval_mask(data, offs, header, intervals)
        prefix, seq, qual = prefix[keep], seq[keep], qual[keep]
        if voffs.size:
            voffs = voffs[keep]
    return prefix, seq, qual, voffs


# how long a QUEUED candidate's hard-timeout anchor is held, as a
# multiple of pool_task_timeout_s: a backlogged but healthy pool (queue
# waits of a few task durations) never false-fires, and a pool whose
# every worker is wedged (resubmissions never dequeue) still exhausts
# the budget and raises TransientIOError (the reference's value)
_QUEUED_GRACE = 8.0


def iter_windowed(pool: cf.ThreadPoolExecutor, items: Iterable,
                  fn: Callable, window: int,
                  cleanup: Optional[Callable] = None,
                  config: Optional[HBamConfig] = None,
                  what: str = "span decode") -> Iterator:
    """``fn(item)`` on the pool with at most ``window`` futures in
    flight; results in order.  Closing the generator early cancels the
    futures that have not started, hands every result that is or will
    be ready but was never yielded to ``cleanup`` (a fused chunk stream
    holds a live native job: closing it joins the workers), and closes
    ``items`` when it is a generator.

    Submissions go through ``utils/pools.submit`` under
    ``call_with_retry`` (3 retries): a transient submission fault (the
    ``pool.submit`` chaos point) retries briefly.  With a ``config`` the
    wait grows the reference's straggler and hang defence
    (``_iter_windowed``, jobs/speculate.py):

    - with ``config.speculative_decode`` a unit outliving the soft
      deadline (p95 of this drive's decaying latencies x
      ``straggler_multiplier``, floored at ``straggler_min_s``) gets a
      second copy on the pool; the first result wins, and the loser is
      cancelled or reaped through ``cleanup``
      (``jobs.speculative_launched`` / ``jobs.speculative_won``);
    - with ``config.pool_task_timeout_s`` a future outliving it is
      abandoned (a wedged thread cannot be killed, only orphaned) and
      the item resubmitted, once per ``span_retries``; then
      ``TransientIOError`` (``pool.task_timeouts`` /
      ``jobs.timeout_resubmits``).  The deadline covers active waiting
      on a runnable task: time queued behind a healthy backlog, or spent
      running before the consumer reached the entry, does not count
      (``_await``'s two clocks).

    Without a config the wait is the plain blocking ``Future.result()``,
    as in the reference."""
    it = iter(items)
    # entries: [item, future, submit stamp, speculated?]
    dq: "deque[list]" = deque()
    timeout_s = config.pool_task_timeout_s if config is not None else None
    timeout_s = float(timeout_s) if timeout_s else None
    max_resubmits = int(config.span_retries or 0) \
        if timeout_s is not None else 0
    latency = UnitLatency.from_config(config) \
        if config is not None and config.speculative_decode else None
    submit_policy = RetryPolicy(retries=3, backoff_base_s=0.01,
                                backoff_max_s=0.1)

    def _submit(item) -> cf.Future:
        return call_with_retry(lambda: pool_submit(pool, fn, item),
                               submit_policy, what="decode pool submit",
                               counter="pool.submit_retries")

    def _abandon(f: cf.Future) -> None:
        if not f.cancel() and cleanup is not None:
            f.add_done_callback(_reaper(cleanup))

    def _await(entry) -> object:
        if timeout_s is None and latency is None:
            return entry[1].result()
        # candidates: [future, deadline anchor, speculative?, submit
        # stamp, first seen queued].  The deadline anchor starts when
        # this wait begins (a decode that ran while earlier entries were
        # consumed is not stuck) and is refreshed while the future is
        # queued, within _QUEUED_GRACE; the submit stamp feeds the
        # latency histogram (turnaround, which keeps the soft deadline
        # conservative)
        now = time.perf_counter()
        cands = [[entry[1], now, False, entry[2], None]]
        resubmits = 0
        while True:
            for c in list(cands):
                if not c[0].done():
                    continue
                try:
                    out = c[0].result()
                except Exception:  # noqa: BLE001 -- policy boundary
                    # a failed copy while another runs keeps the race;
                    # the last one failing raises (its own retry policy
                    # is spent: resubmitting would repeat the failure)
                    cands.remove(c)
                    if not cands:
                        raise
                    continue
                if latency is not None:
                    latency.observe(time.perf_counter() - c[3])
                if c[2]:
                    METRICS.count("jobs.speculative_won")
                for o in cands:
                    if o is not c:
                        _abandon(o[0])
                return out
            now = time.perf_counter()
            for c in cands:
                if not c[0].running() and not c[0].done():
                    if c[4] is None:
                        c[4] = now
                    if timeout_s is None or \
                            now - c[4] <= timeout_s * _QUEUED_GRACE:
                        c[1] = now
            if timeout_s is not None:
                for c in list(cands):
                    if now - c[1] > timeout_s:
                        METRICS.count("pool.task_timeouts")
                        _abandon(c[0])
                        cands.remove(c)
            if not cands:
                if resubmits >= max_resubmits:
                    raise TransientIOError(
                        f"{what} exceeded the {timeout_s:g}s "
                        f"pool_task_timeout_s deadline {resubmits + 1} "
                        f"time(s) -- worker(s) presumed wedged") from None
                resubmits += 1
                METRICS.count("jobs.timeout_resubmits")
                t = time.perf_counter()
                cands.append([_submit(entry[0]), t, False, t, None])
                now = time.perf_counter()
            soft = latency.soft_deadline_s() if latency is not None \
                else None
            if soft is not None and not entry[3] and len(cands) == 1 \
                    and now - cands[0][1] > soft:
                entry[3] = True
                METRICS.count("jobs.speculative_launched")
                t = time.perf_counter()
                cands.append([_submit(entry[0]), t, True, t, None])
            # sleep until the nearest deadline (or a coarse slice),
            # woken early by any candidate completing
            waits = [0.25]
            if timeout_s is not None:
                waits += [c[1] + timeout_s - now for c in cands]
            if soft is not None and not entry[3]:
                waits += [cands[0][1] + soft - now]
            elif latency is not None and soft is None:
                waits += [float(latency.min_s)]
            cf.wait([c[0] for c in cands], timeout=max(0.005, min(waits)),
                    return_when=cf.FIRST_COMPLETED)

    try:
        for item in it:
            dq.append([item, _submit(item), time.perf_counter(), False])
            if len(dq) >= window:
                break
        while dq:
            entry = dq.popleft()
            for item in it:
                dq.append([item, _submit(item), time.perf_counter(),
                           False])
                break
            yield _await(entry)
    finally:
        for entry in dq:
            _abandon(entry[1])
        if hasattr(it, "close"):
            it.close()


@contextlib.contextmanager
def _decode_pool(config: HBamConfig, name: str = "hbam-decode"):
    """A driver call's thread pool.  It is shut down without waiting:
    a worker the window abandoned under ``pool_task_timeout_s`` may
    still be wedged, and a speculative loser may still run; each hands
    its result to the window's cleanup when it ends (a fused chunk
    stream's native job is closed there), and the call does not wait
    for it, as the reference's shared pool does not."""
    pool = cf.ThreadPoolExecutor(config.pool_size(), thread_name_prefix=name)
    try:
        yield pool
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def _reaper(cleanup: Callable) -> Callable:
    """A done-callback that hands a future's result to ``cleanup``: it
    runs at once for a finished future, and on the worker thread when a
    running one finishes."""
    def reap(f: cf.Future) -> None:
        if f.cancelled():
            return
        try:
            cleanup(f.result())
        except Exception:  # noqa: BLE001 -- best-effort teardown
            pass
    return reap


@contextlib.contextmanager
def _span_stream(pool: cf.ThreadPoolExecutor, spans: Iterable,
                 decode: Callable, window: int, config: HBamConfig):
    """FeedPipeline input of ``decode(span)`` results (arrays, tuples or
    fused chunk streams) decoded on ``pool`` ``window`` spans ahead, the
    window under ``config``'s straggler and hang defence.  On exit the
    stream in hand is closed, then the window: no native job outlives
    it."""
    windowed = iter_windowed(pool, spans, decode, window,
                             cleanup=_close_stream, config=config)
    flat = _flatten_span_stream(windowed)
    try:
        yield flat
    finally:
        flat.close()
        windowed.close()


# compressed span grains the host drivers plan at (the reference's:
# tile flagstat 4 MiB, seq-stats 8 MiB; span mode plans at a bytes_cap
# eighth, the device plane at DEVICE_PLANE_SPAN_BYTES)
FLAGSTAT_SPAN_BYTES = 4 << 20
SEQ_STATS_SPAN_BYTES = 8 << 20
# the index builders' grain (map_file_spans)
INDEX_SPAN_BYTES = 4 << 20


def _plan(path: str, header: Optional[SAMHeader], n_dev: int,
          span_bytes: int, config: HBamConfig = DEFAULT_CONFIG
          ) -> Iterable[FileVirtualSpan]:
    """Spans of about ``span_bytes`` compressed bytes, at least one per
    device, through the plan memo (``plan_spans_cached``): snapped to a
    splitting index, trimmed to a ``.bai``'s chunks under intervals, or
    guessed, and then streamed while later boundaries are guessed.  A
    planned span longer than twice the grain is cut (``_grain_cut``)."""
    with as_byte_source(path) as src:
        size = src.size
    n_spans = max(n_dev, int(np.ceil(size / span_bytes)))
    return _grain_cut(path, header, plan_spans_cached(
        path, header, config, num_spans=n_spans), span_bytes)


def _grain_cut(path, header: Optional[SAMHeader],
               spans: Iterable[FileVirtualSpan], grain: int
               ) -> Iterable[FileVirtualSpan]:
    """The plan with every span whose compressed extent passes
    ``2 * grain`` cut at guessed record starts ``grain`` bytes apart
    (the guesses on one background thread; a piece is at most a grain
    plus one block).  The reference decodes such spans whole: a
    ``.bai``'s merged chunks (a chromosome can be one span of
    gigabytes) and spans snapped to a splitting index sampled more
    coarsely than the grain, which outgrow the host's memory, the span
    mode's ``bytes_cap`` and the device plane's 64 blocks.  A span
    snapped to a finer index is at most a grain plus one sample gap and
    stays as the index made it.  The memo keeps the reference's plan;
    the bytes read are the same.  A plan with no long span is returned
    as it is (a memo hit stays a list)."""
    if isinstance(spans, list) and all(
            s.compressed_size <= 2 * grain for s in spans):
        return spans
    return _iter_grain_cut(path, header, spans, grain)


def _iter_grain_cut(path, header, spans, grain):
    pool = src = guesser = None
    try:
        for span in spans:
            if span.compressed_size <= 2 * grain:
                yield span
                continue
            start, end = span.start_voffset, span.end_voffset
            if guesser is None:
                src = as_byte_source(path)
                if header is None:
                    header, _ = read_bam_header(src)
                guesser = BAMSplitGuesser(src, header)
                pool = cf.ThreadPoolExecutor(1, thread_name_prefix="hbam-plan")
            cuts = [pool.submit(guesser.guess_next_record_start, b)
                    for b in range((start >> 16) + grain, end >> 16, grain)]
            for fut in cuts:
                v = fut.result()
                if v is None or v >= end:
                    break
                if v > start:
                    yield FileVirtualSpan(span.path, start, v)
                    start = v
            yield FileVirtualSpan(span.path, start, end)
    finally:
        if hasattr(spans, "close"):
            spans.close()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if src is not None and src is not path:
            src.close()


def map_file_spans(path: str, fn: Callable) -> List:
    """``fn(data, offsets, voffsets)`` over every span of the whole file
    (the two-pass native host decode, spans guessed at
    ``INDEX_SPAN_BYTES`` with no sidecar read), on the decode pool; the
    results in file order.  What the index builders read their columns
    from."""
    return list(iter_file_spans(path, fn))


def iter_file_spans(path: str, fn: Callable,
                    config: HBamConfig = DEFAULT_CONFIG) -> Iterator:
    """``map_file_spans`` as a stream: each span's result as soon as it
    and every earlier one is ready, at most two windows of spans in
    memory (the host sort's reader)."""
    cfg = config
    with as_byte_source(path) as src:
        size = src.size
    plan = iter_bam_spans(
        path, num_spans=max(1, int(np.ceil(size / INDEX_SPAN_BYTES))),
        config=dataclasses.replace(cfg, use_splitting_index=False))

    def one(span):
        data, offs, voffs, _ = _decode_span_core(src, span, cfg.check_crc,
                                                 cfg.host_backend)
        return fn(data, offs, voffs)

    with _reading(path, cfg) as src, cf.ThreadPoolExecutor(
            cfg.pool_size(), thread_name_prefix="hbam-index") as pool:
        stream = iter_windowed(pool, plan, one, 2 * cfg.pool_size())
        try:
            yield from stream
        finally:
            stream.close()


# ---------------------------------------------------------------------------
# Span failure policy, plane demotion and interval filters
# ---------------------------------------------------------------------------

def parse_config_intervals(config: HBamConfig, header):
    """config.bam_intervals -> the parsed Interval list (None when unset).
    A string that does not parse is a PlanError, as the reference's
    planner makes it (split/planners.py:253-262)."""
    if not config.bam_intervals:
        return None
    try:
        return parse_intervals(config.bam_intervals,
                               header.ref_names if header else None)
    except ValueError as e:
        raise PlanError(f"bad bam_intervals {config.bam_intervals!r}: "
                        f"{e}") from e


def _resilient_source(path, config: HBamConfig):
    """What the decode stages read through: one source a driver call
    (through any installed chaos), or one RetryingByteSource when
    ``config.io_read_retries`` asks for read-level retries (backoff +
    per-read deadline under the span grain).  The reference opens a
    source per span; on an H100 machine one shared descriptor took
    5-10% off the native plane's walls (PERF.md, measured with
    ``chip_smoke.py --turns``)."""
    if not isinstance(path, (str, os.PathLike)):
        return path
    r = int(config.io_read_retries or 0)
    if r <= 0:
        return as_byte_source(path)
    return RetryingByteSource(path, RetryPolicy(
        retries=r,
        backoff_base_s=float(config.retry_backoff_base_s),
        backoff_max_s=float(config.retry_backoff_max_s),
        deadline_s=config.io_read_deadline_s))


@contextlib.contextmanager
def _reading(path, config: HBamConfig):
    """``_resilient_source`` for the length of a driver call.  It is not
    closed here: a task the span window abandoned (``pool_task_timeout_s``,
    or a speculative loser) may still read through it after the call
    returns, and the source closes its descriptor when the last
    reference to it goes (at once when no such task is left)."""
    yield _resilient_source(path, config)


def decode_with_retry(fn: Callable, span: FileVirtualSpan,
                      config: HBamConfig,
                      quarantine: Optional[QuarantineManifest] = None,
                      policy: Optional[RetryPolicy] = None,
                      ladder: Optional[DemotionLadder] = None):
    """The span failure policy (the reference's, fault-classified by
    utils/errors.classify_error):

    - TRANSIENT: re-attempted up to ``config.span_retries`` times with
      jittered exponential backoff (``policy`` injectable);
    - CORRUPT: no re-decode on the same plane;
    - PLAN (backend build/launch and CUDA faults included): raised.

    With a ``ladder`` ``fn`` takes ``(span, plane)``, and a CORRUPT
    failure on plane P re-decodes on the next plane down; P's fault
    domain is charged only when that lower plane succeeds (if every
    plane fails the bytes are bad and no domain is charged).  Once the
    policy is spent, ``skip_bad_spans`` decides: raise, or record the
    span in ``quarantine`` (checking its ``max_bad_span_fraction``
    circuit) and return None.  Counters: ``pipeline.transient_retries``,
    ``pipeline.corrupt_spans``, ``pipeline.span_demotions``, and
    ``pipeline.bad_spans`` on a skip only."""
    if policy is None:
        policy = span_retry_policy(config)
    last: Optional[BaseException] = None
    kind = CORRUPT
    attempts = 0
    transient_tries = 0
    plane = ladder.host_plane() if ladder is not None else None
    blamed: List[Tuple[str, BaseException]] = []
    while attempts <= policy.retries + len(blamed):
        attempts += 1
        try:
            out = fn(span) if ladder is None else fn(span, plane)
            if ladder is not None:
                for bad_plane, exc in blamed:
                    # a lower plane just decoded these bytes: the upper
                    # plane's failure was its own
                    ladder.confirm_failure(bad_plane, exc)
                    METRICS.count("pipeline.span_demotions")
                ladder.record_success(plane)
            return out
        except Exception as e:  # noqa: BLE001 -- policy boundary
            last = e
            kind = classify_error(e)
            if kind == PLAN:
                raise
            if kind != TRANSIENT:
                if ladder is not None:
                    nxt = ladder.next_lower(plane)
                    if nxt is not None and ladder.demotable(plane, e):
                        logger.warning(
                            "span %s failed on the %s plane (%s); "
                            "re-decoding on %s", span, plane, e, nxt)
                        blamed.append((plane, e))
                        plane = nxt
                        continue
                METRICS.count("pipeline.corrupt_spans")
                break
            if transient_tries < policy.retries:
                METRICS.count("pipeline.transient_retries")
                d = policy.delay(transient_tries)
                transient_tries += 1
                policy.sleep(d)
                continue
            break
    if config.skip_bad_spans:
        METRICS.count("pipeline.bad_spans")
        logger.warning("skipping bad span %s after %d attempt(s) [%s]: %s",
                       span, attempts, kind, last)
        if quarantine is not None:
            quarantine.add(span, last, kind, attempts)
            quarantine.check_circuit(config)  # may raise
        return None
    raise last


def _span_policy(decode_fn: Callable, config: HBamConfig,
                 quarantine: Optional[QuarantineManifest],
                 ladder: Optional[DemotionLadder], host_backend: str,
                 empty: Callable) -> Callable:
    """``decode(span)`` of a host plane: ``decode_fn(span, plane)`` under
    ``decode_with_retry`` along ``ladder``; a skipped span gives
    ``empty()``.  The ``decode.native`` chaos point fires inside the
    boundary on the native rung, so its faults retry and demote like
    real ones."""
    def inner(s, plane=None):
        hb = host_backend if plane is None else plane
        if hb == "native":
            chaos.fire("decode.native", span=str(s))
        return decode_fn(s, hb)

    def decode(span):
        out = decode_with_retry(inner, span, config, quarantine=quarantine,
                                ladder=ladder)
        return empty() if out is None else out
    return decode


def _attach_quarantine(result: Dict,
                       quarantine: Optional[QuarantineManifest]) -> Dict:
    """The manifest rides the result dict only when it is not empty, so
    clean runs keep their exact result shape."""
    if quarantine:
        result["quarantine"] = quarantine.to_dicts()
    return result


def _planned(spans: Iterable[FileVirtualSpan], config: HBamConfig,
             quarantine: Optional[QuarantineManifest]
             ) -> Iterable[FileVirtualSpan]:
    """The spans to decode, with ``quarantine.total_spans`` set to the
    plan's length as the reference sets it.  Under ``skip_bad_spans``
    the fraction circuit reads that total while the run goes on, so the
    plan is listed first; otherwise the plan keeps streaming (later
    boundaries are guessed while the first spans decode) and the total
    is set once the last span has been handed out."""
    if quarantine is None or quarantine.total_spans is not None:
        return spans
    if config.skip_bad_spans:
        spans = list(spans)
        quarantine.total_spans = len(spans)
        return spans

    def counted():
        n = 0
        for s in spans:
            n += 1
            yield s
        if quarantine.total_spans is None:
            quarantine.total_spans = n
    return counted()


def _header_for(path: str, header: Optional[SAMHeader],
                config: HBamConfig) -> Optional[SAMHeader]:
    """The header, read when an interval filter needs its reference
    names and the caller gave none."""
    if header is None and config.bam_intervals:
        header, _ = read_bam_header(path)
    return header


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tile -> device; asynchronous from pinned memory on CUDA."""
    return t.to(device, non_blocking=True)


class _CopiesDone:
    """In-flight handle of one dispatch's host->device copies: a CUDA
    event recorded on each device's current stream right after its
    copies.  CPU copies are synchronous and need none."""

    def __init__(self):
        self.events: List[torch.cuda.Event] = []

    def record(self, device: torch.device) -> None:
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            self.events.append(ev)

    def synchronize(self) -> None:
        for ev in self.events:
            ev.synchronize()

    def handle(self) -> "Optional[_CopiesDone]":
        return self if self.events else None


# ---------------------------------------------------------------------------
# Device steps (one device's share; the driver adds them over the axis)
# ---------------------------------------------------------------------------

def flagstat_tile_step(tile: torch.Tensor, count: int,
                       projection: Tuple[str, ...] = FLAGSTAT_PROJECTION
                       ) -> torch.Tensor:
    """[rows, row_bytes] projected tile, ``count`` valid rows -> int32
    [16] flagstat counters (no gather: the host packed the rows)."""
    cols = unpack_projected_tile(tile, projection)
    valid = torch.arange(tile.shape[0], device=tile.device) < count
    return flagstat_vector(cols, valid)


def flagstat_step(data: torch.Tensor, offsets: torch.Tensor,
                  count: int) -> torch.Tensor:
    """Span mode: inflated span bytes + int32 record offsets (``count``
    valid) -> int32 [16] counters, through the K1 gather kernel."""
    cols = unpack_fixed_fields(data, offsets)
    valid = torch.arange(offsets.shape[0], device=offsets.device) < count
    return flagstat_vector(cols, valid)


def _payload_stats_tail(stats: Dict[str, torch.Tensor], valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f64 [2] sums of gc and mean_qual over valid rows, int64 [1 + 16]
    n_reads + base_hist)."""
    w = valid.to(torch.float64)
    fvec = torch.stack([(stats["gc"].to(torch.float64) * w).sum(),
                        (stats["mean_qual"].to(torch.float64) * w).sum()])
    ivec = torch.cat([valid.sum(dtype=torch.int64)[None],
                      stats["base_hist"].to(torch.int64)])
    return fvec, ivec


def seq_stats_step(prefix: torch.Tensor, seq: torch.Tensor,
                   qual: torch.Tensor, count: int, max_len: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Payload tiles -> the stats tail pair.  Lengths come from the
    prefix tile's l_seq column, clipped to max_len (the pack truncates
    there); rows past ``count`` get length 0."""
    l_seq = unpack_projected_tile(prefix[:, 20:24], ("l_seq",))["l_seq"]
    valid = torch.arange(prefix.shape[0], device=prefix.device) < count
    lengths = torch.where(valid, torch.clamp(l_seq, max=max_len),
                          0).to(torch.int32)
    return _payload_stats_tail(seq_qual_stats(seq, qual, lengths), valid)


def read_stats_step(seq: torch.Tensor, qual: torch.Tensor,
                    lengths: torch.Tensor, count
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read payload tiles with explicit per-read lengths (FASTQ, QSEQ,
    FASTA windows; ``tensor_batches``) -> the stats tail pair, through
    the K2 kernel: rows past ``count`` (an int or a 0-d tensor on the
    tiles' device) get length 0."""
    valid = torch.arange(seq.shape[0], device=seq.device) < count
    lengths = torch.where(valid, lengths, 0).to(torch.int32)
    return _payload_stats_tail(seq_qual_stats(seq, qual, lengths), valid)


def unpack_step(data: torch.Tensor, offsets: torch.Tensor,
                count: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A stacked span group (``stack_span_group``) on the device -> the
    12 fixed-field columns and ``valid``, each [n_dev, records_cap], one
    K1 gather per device row: data uint8 [n_dev, bytes_cap], offsets
    int32 [n_dev, records_cap], count int32 [n_dev] (the "mapper" feed
    of the reference's ``make_unpack_step``)."""
    rows = []
    for i in range(data.shape[0]):
        cols = dict(unpack_fixed_fields(data[i], offsets[i]))
        cols["valid"] = torch.arange(offsets.shape[1],
                                     device=offsets.device) < count[i]
        rows.append(cols)
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class _StatTotals:
    """Running device sums of the per-group stats pairs; one drain to the
    host at the end (no synchronisation per group)."""

    def __init__(self):
        self.f: Optional[torch.Tensor] = None
        self.i: Optional[torch.Tensor] = None

    def add(self, fvec: torch.Tensor, ivec: torch.Tensor) -> None:
        self.f = fvec if self.f is None else self.f + fvec
        self.i = ivec if self.i is None else self.i + ivec

    def __bool__(self) -> bool:
        return self.f is not None

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.f.cpu().numpy(), self.i.cpu().numpy()


def _payload_stats_result(totals: _StatTotals) -> Dict[str, object]:
    if not totals:
        return {"n_reads": 0, "mean_gc": 0.0, "mean_qual": 0.0,
                "base_hist": np.zeros(N_CODES, np.int64)}
    tf, ti = totals.drain()
    n = max(float(ti[0]), 1.0)
    return {"n_reads": int(ti[0]), "mean_gc": float(tf[0] / n),
            "mean_qual": float(tf[1] / n), "base_hist": ti[1:]}


# ---------------------------------------------------------------------------
# The device decode plane (token feed)
# ---------------------------------------------------------------------------
# Pool workers fetch each span and run the native Huffman tokenize (the
# bit-serial half of inflate; CRCs folded in when asked).  This thread
# stages the span's token chunk in pinned memory, copies it to the card
# and runs the fused step there: LZ77 resolve + pack (K7+K8), the record
# walk (K9), the fixed-field gather (K1), then the flagstat reduce or the
# payload gather (K10p) and K2.  The inflated bytes never exist on the
# host.  Each chunk's walk scalars (n_all, tail, bad) stay on the card
# until one drain at the end.  Records a chunk cannot finish -- a final
# record cut at the chunk's end, and every block of a span past
# DEVICE_PLANE_MAX_BLOCKS -- go through the host plane's tile path.

# widest token chunk one device step takes: 64 BGZF blocks (~4 MiB
# inflated at the 64 KiB rung); a wider span sends its first 64 blocks
# through the card and the rest through the host fixup
DEVICE_PLANE_MAX_BLOCKS = 64
# compressed span grain the plane plans at when the caller gives no spans
DEVICE_PLANE_SPAN_BYTES = 512 << 10


@dataclasses.dataclass
class _TokenChunk:
    """One span's host-tokenized unit (at most MAX_BLOCKS blocks)."""
    tokens: np.ndarray     # [used, P] u32 LZ77 tokens
    n_tokens: np.ndarray   # [used] i32
    isize: np.ndarray      # [used] i32
    start: int             # walk start (inflated chunk coordinates)
    stop: int              # ownership limit (records starting < stop)
    used: int              # blocks tokenized for the device
    P: int                 # ladder rung (token pad == bytes per block)
    n_blocks: int          # blocks of the whole span (> used: host fixup)
    span: FileVirtualSpan
    ubase: np.ndarray      # [n_blocks + 1] i64 inflated block starts
    abs_coffs: np.ndarray  # [n_blocks] i64 compressed block offsets

    def fixup_span(self, tail: int) -> FileVirtualSpan:
        """The host-decoded remainder: records starting in [tail, span
        end) -- the cut final record, and every block past the chunk of
        an over-wide span."""
        blk = int(np.searchsorted(self.ubase[1:], tail, side="right"))
        blk = min(blk, self.n_blocks - 1)
        u = int(tail - self.ubase[blk])
        start_v = (int(self.abs_coffs[blk]) << 16) | u
        return FileVirtualSpan(self.span.path, start_v,
                               self.span.end_voffset)


def _tokenize_span_tokens(source, span: FileVirtualSpan,
                          check_crc: bool = False) -> Optional[_TokenChunk]:
    """Host half of the device plane for one span: fetch, block table and
    the threaded native tokenize.  DEFLATE, ISIZE and CRC faults raise
    BGZFError here, as the host planes raise them.  None for an empty
    span.  ``source`` is a path (opened here) or an open ByteSource."""
    src = as_byte_source(source)
    try:
        raw, end_block_size, _ = _fetch_span_raw(src, span)
    finally:
        if src is not source:
            src.close()
    if not raw:
        return None
    table = inflate_ops.block_table(raw)
    isize = table["isize"]
    n = int(isize.size)
    used = min(n, DEVICE_PLANE_MAX_BLOCKS)
    src_arr = np.frombuffer(raw, dtype=np.uint8)
    sub = isize[:used]
    P = ladder_pow2(max(16, int(sub.max())))
    try:
        out = native.deflate_tokenize_batch(
            src_arr, table["cdata_off"][:used], table["cdata_len"][:used], P,
            0, with_crc=check_crc)
    except ValueError as e:
        raise bgzf.BGZFError(str(e)) from e
    tokens, n_tokens, out_lens = out[:3]
    if not np.array_equal(out_lens, sub):
        bad = int(np.nonzero(out_lens != sub)[0][0])
        raise bgzf.BGZFError(
            f"ISIZE mismatch in block {bad}: tokenized "
            f"{int(out_lens[bad])}, footer says {int(sub[bad])}")
    if check_crc:
        expect = inflate_ops.footer_crcs(src_arr, table)[:used]
        mism = np.nonzero(out[3] != expect)[0]
        if mism.size:
            raise bgzf.BGZFError(
                f"CRC32 mismatch in block(s) {mism[:8].tolist()}")
    ub = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(isize, out=ub[1:])
    if used == n and end_block_size:
        stop = int(ub[n]) - int(isize[-1]) + span.end[1]
    elif used == n:
        stop = int(ub[n])
    else:
        stop = int(ub[used])
    return _TokenChunk(tokens=tokens, n_tokens=n_tokens, isize=sub,
                       start=span.start[1], stop=stop, used=used, P=P,
                       n_blocks=n, span=span, ubase=ub,
                       abs_coffs=table["coffset"] + span.start[0])


def device_flagstat_step(tokens: torch.Tensor, n_tokens: torch.Tensor,
                         isize: torch.Tensor, start: int, stop: int,
                         P: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token chunk ([B, T] tokens of blocks P bytes wide) -> (int64
    [16] flagstat counters, int32 [3] walk scalars (n_all, tail, bad)):
    resolve, walk, unpack and reduce on the chunk's device; nothing
    returns to the host."""
    cols, valid, n_all, tail, bad = resolve_walk_fields(
        tokens, n_tokens, isize, start, stop, P)
    return (flagstat_vector(cols, valid).to(torch.int64),
            torch.stack([n_all, tail, bad]))


def device_seq_stats_step(tokens: torch.Tensor, n_tokens: torch.Tensor,
                          isize: torch.Tensor, start: int, stop: int,
                          geometry: PayloadGeometry, P: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One token chunk -> the payload stats pair of ``_payload_stats_tail``
    and the int32 [3] walk scalars: resolve, walk, unpack, payload gather
    and K2 on the chunk's ``records_cap`` rows (lengths clipped to
    [0, max_len], 0 on rows past the walk's count)."""
    cols, seq, qual, valid, n_all, tail, bad = resolve_walk_payload(
        tokens, n_tokens, isize, start, stop, geometry.max_len,
        geometry.seq_stride, geometry.qual_stride, P)
    lengths = torch.where(valid, torch.clamp(cols["l_seq"], 0,
                                             geometry.max_len),
                          0).to(torch.int32)
    fvec, ivec = _payload_stats_tail(seq_qual_stats(seq, qual, lengths),
                                     valid)
    return fvec, ivec, torch.stack([n_all, tail, bad])


class _TokenRing:
    """Pinned staging of token chunks: a StagingRing of [B*T] token slots
    (the u32 tokens' bits as int32, which every CUDA copy takes) and [B]
    counts and sizes, grown when a chunk needs more (the old
    slots' copies are waited for first).  A slot goes back to the ring
    once its copies are enqueued; it is leased again only after they
    complete."""

    def __init__(self, pin_memory: bool):
        self.pin_memory = pin_memory
        self.ring: Optional[StagingRing] = None
        self.elems = self.rows = 0

    def _fit(self, elems: int, rows: int) -> StagingRing:
        if self.ring is not None and elems <= self.elems \
                and rows <= self.rows:
            return self.ring
        if self.ring is not None:
            for _ in range(2):        # wait for both slots' copies
                self.ring.lease()
        self.elems, self.rows = max(elems, self.elems), max(rows, self.rows)
        self.ring = StagingRing(
            1, 1, [TileSpec((self.elems,), np.int32),
                   TileSpec((self.rows,), np.int32),
                   TileSpec((self.rows,), np.int32)],
            pin_memory=self.pin_memory)
        return self.ring

    def stage(self, c: _TokenChunk, dev: torch.device
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Copy one chunk to ``dev`` as [B, T] tokens, [B] counts and [B]
        sizes.  B is the chunk's blocks rounded up to a power of two >= 8
        (pad rows have zero counts and sizes, so their tokens are never
        read); T is the longest row's token count rounded up to 256, at
        most P: only the tokens cross the link, not the tokenizer's
        P-wide rows."""
        B, n = round_pow2(c.used, 8), c.used
        T = min(c.P, _round_up(max(int(c.n_tokens.max()), 1), 256))
        ring = self._fit(B * T, B)
        slot = ring.lease()
        try:
            tok, nt, iz = (a.reshape(-1) for a in slot.arrays)
            tok[:n * T].reshape(n, T)[:] = c.tokens[:, :T].view(np.int32)
            nt[:n], nt[n:B] = c.n_tokens, 0
            iz[:n], iz[n:B] = c.isize, 0
            tok_t, nt_t, iz_t = (t.reshape(-1) for t in slot.tensors)
            tokens = torch.empty((B, T), dtype=torch.int32, device=dev)
            tokens[:n].copy_(tok_t[:n * T].view(n, T), non_blocking=True)
            out = (tokens, _copy_to(nt_t[:B], dev), _copy_to(iz_t[:B], dev))
            copies = _CopiesDone()
            copies.record(dev)
            slot.in_flight = copies.handle()
        finally:
            ring.release(slot)
        return out


def _device_plane(path: str, axis: DataAxis, config: HBamConfig,
                  header: Optional[SAMHeader],
                  spans: Optional[Sequence[FileVirtualSpan]], prefetch: int,
                  step: Callable,
                  quarantine: Optional[QuarantineManifest] = None
                  ) -> List[FileVirtualSpan]:
    """Run every span's token chunk through ``step(tokens, n_tokens,
    isize, start, stop, P)`` (which keeps its own totals and returns the
    chunk's int32 [3] walk scalars) and return the spans the host must
    finish.  Each span's fetch + tokenize runs under
    ``decode_with_retry``; the ``device.step`` chaos point fires at each
    chunk's step.  Raises PlanError without the native tokenizer,
    BGZFError for a bad block, CorruptDataError for a malformed record
    chain or a chunk with more records than its capacity."""
    require_tokenizer()
    if spans is None:
        spans = _plan(path, header, axis.n_dev, DEVICE_PLANE_SPAN_BYTES,
                      config)
    ring = _TokenRing(pin_memory=axis.devices[0].type == "cuda")
    pending: List[Tuple[torch.Tensor, _TokenChunk, int]] = []

    def tokenize(span):
        return decode_with_retry(
            lambda s: _tokenize_span_tokens(src, s, config.check_crc),
            span, config, quarantine=quarantine)

    with _reading(path, config) as src, \
            _decode_pool(config, "hbam-tokenize") as pool:
        stream = iter_windowed(pool, spans, tokenize,
                               max(1, prefetch) * config.pool_size(),
                               config=config)
        try:
            for chunk in stream:
                if chunk is None:
                    continue
                chaos.fire("device.step", blocks=chunk.used)
                dev = axis.devices[len(pending) % axis.n_dev]
                walk = step(*ring.stage(chunk, dev), chunk.start, chunk.stop,
                            chunk.P)
                pending.append((walk, chunk,
                                records_cap(round_pow2(chunk.used, 8),
                                            chunk.P)))
        finally:
            stream.close()
    if not pending:
        return []
    # one drain of every chunk's walk scalars (a read per chunk would
    # synchronise the pipeline it exists to overlap)
    walks = torch.stack([w.to(axis.devices[0]) for w, _, _ in pending]
                        ).cpu().numpy()
    fixups = []
    for (n_all, tail, bad), (_, c, cap) in zip(walks, pending):
        if bad:
            raise CorruptDataError(
                f"malformed BAM record chain in span {c.span}")
        if n_all > cap:
            raise CorruptDataError(
                f"record count {int(n_all)} exceeds capacity {cap} in "
                f"span {c.span}")
        if tail < c.stop or c.used < c.n_blocks:
            fixups.append(c.fixup_span(int(tail)))
    return fixups


def _fixup_policy(decode_fn: Callable, config: HBamConfig,
                  quarantine: Optional[QuarantineManifest],
                  empty: Callable) -> Callable:
    """``decode(span)`` of the device plane's host fixups: the native
    plane under ``decode_with_retry``, with no ladder and no chaos point
    (the reference's fixup decode)."""
    def decode(span):
        out = decode_with_retry(lambda s: decode_fn(s, "native"), span,
                                config, quarantine=quarantine)
        return empty() if out is None else out
    return decode


def _device_data_fault(exc: BaseException) -> bool:
    """May a device-plane failure demote?  Only the data faults the
    plane's own checks raise: a bad block or record chain
    (CorruptDataError, BAMError) or a read that failed (TRANSIENT).
    Anything else -- a kernel wrapper refusing its inputs, a device
    mismatch, a CUDA fault, a bug -- is the port's own and raises, since
    moving the work to the host would hide it (a deliberate difference:
    the reference demotes every non-PLAN fault)."""
    if isinstance(exc, (CorruptDataError, BAMError)):
        return True
    return classify_error(exc) == TRANSIENT


def _run_planes(path: str, config: HBamConfig,
                decision: PlaneDecision, ladder: Optional[DemotionLadder],
                device_run: Callable, host_run: Callable):
    """The plane sequence of both drivers: the device plane when
    ``decision`` selected it, demoted to the host planes on a data fault
    (``_device_data_fault``), with the device domain charged only after
    the host run completes (oracle confirmation)."""
    device_blame: Optional[BaseException] = None
    if decision.plane == "device":
        try:
            out = device_run()
            if ladder is not None:
                ladder.record_success("device")
            quarantine_run_ok(path, config)
            return out
        except Exception as e:  # noqa: BLE001 -- plane policy boundary
            if (ladder is None or not _device_data_fault(e)
                    or not ladder.demotable("device", e)):
                raise
            logger.warning("device decode plane failed (%s: %s); "
                           "demoting to the host planes for %s",
                           type(e).__name__, e, path)
            device_blame = e
    out = host_run()
    if device_blame is not None:
        ladder.confirm_failure("device", device_blame)
    return out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _payload_empty(geometry: PayloadGeometry) -> Callable:
    widths = (PREFIX, geometry.seq_stride, geometry.qual_stride)
    return lambda: tuple(np.empty((0, w), np.uint8) for w in widths)


def _payload_specs(geometry: PayloadGeometry) -> List[TileSpec]:
    """The BAM payload tiles: prefix, seq and qual rows."""
    return [TileSpec((w,), np.uint8)
            for w in (PREFIX, geometry.seq_stride, geometry.qual_stride)]


def _read_specs(geometry: PayloadGeometry) -> List[TileSpec]:
    """The read formats' tiles: seq and qual rows, and the lengths."""
    return [TileSpec((geometry.seq_stride,), np.uint8),
            TileSpec((geometry.qual_stride,), np.uint8),
            TileSpec((), np.int32)]


def _payload_groups(spans: Iterable, specs: Sequence[TileSpec],
                    geometry: PayloadGeometry, axis: DataAxis,
                    emit_fn: Callable, config: HBamConfig, prefetch: int,
                    decode: Callable, stream_fused: bool = False,
                    balance: bool = True) -> Iterator:
    """``decode(span)`` -> a tuple of row arrays per ``specs`` (BAM
    payload: prefix, seq, qual; read formats: seq, qual, lengths), or a
    fused chunk stream of such tuples, on the pool, packed into row
    tiles; yields the value of ``emit_fn(tensors, counts)`` for each
    group (the ``FeedPipeline.stream`` contract)."""
    fp = FeedPipeline(axis.n_dev, geometry.tile_records, specs,
                      block_n=geometry.block_n,
                      fixed_shape=geometry.fixed_shape, balance=balance,
                      pin_memory=axis.devices[0].type == "cuda")
    window = max(1, prefetch) * config.pool_size()
    if stream_fused:
        window = _stream_window(window)
    with _decode_pool(config) as pool, \
            _span_stream(pool, spans, decode, window, config) as stream:
        yield from fp.stream(stream, emit_fn)


def _feed_payload(spans: Iterable[FileVirtualSpan],
                  geometry: PayloadGeometry, axis: DataAxis,
                  dispatch_fn: Callable, config: HBamConfig, prefetch: int,
                  decode: Callable, stream_fused: bool = False) -> int:
    """``_payload_groups`` of a stats driver: each group goes to
    ``dispatch_fn(tensors, counts)`` (the ``FeedPipeline.feed``
    contract), the final partial group spread over the devices.
    Returns the number of groups."""
    return sum(1 for _ in _payload_groups(
        spans, _payload_specs(geometry), geometry, axis,
        lambda t, c: (None, dispatch_fn(t, c)), config, prefetch, decode,
        stream_fused))


def iter_payload_tile_groups(path: str, spans: Iterable[FileVirtualSpan],
                             geometry: PayloadGeometry, axis: DataAxis,
                             emit_fn: Callable,
                             config: HBamConfig = DEFAULT_CONFIG,
                             prefetch: int = 2, header=None,
                             quarantine: Optional[QuarantineManifest] = None,
                             balance: bool = True) -> Iterator:
    """Decode spans on the pool under the span failure policy (retry,
    the native -> zlib ladder, quarantine; intervals applied), pack
    (prefix, seq, qual) row tiles and yield the value of
    ``emit_fn(tensors, counts)`` for each group: ``tensors`` are
    [n_dev, rows, w] views of a ring slot, valid until the generator is
    advanced, and ``emit_fn`` returns ``(value, in-flight handle)``
    (``FeedPipeline.stream``).  ``rows`` is ``geometry.tile_records``
    for every full group; the final one shrinks to a bucket unless
    ``geometry.fixed_shape``.  ``balance`` spreads the final group over
    the devices (the stats driver); ``tensor_batches`` passes False and
    keeps the serial order.  On the native plane each span's fused
    decode streams its chunks into the tiles when ``select_plane``
    allows it.  Sheds at the file's quarantine gate first; heals a
    half-open gate once every span is through."""
    intervals = parse_config_intervals(config, header)
    check_quarantine_gate(path, config)
    spans = _planned(spans, config, quarantine)
    decision = select_plane(config, intervals=intervals)
    ladder = decode_ladder(path, decision.backend, config) \
        if config.adaptive_planes else None
    check_crc = config.check_crc

    def payload(span, backend):
        if decision.stream_fused and backend == "native":
            return _iter_fused_span_chunks(
                src, span, "payload", geometry=geometry,
                check_crc=check_crc, config=config,
                fallback_fn=lambda: decode_with_retry(
                    lambda s: decode_span_payload_host(
                        src, s, geometry, check_crc, "native",
                        config=_fused_off(config))[:3],
                    span, config))
        return decode_span_payload_host(
            src, span, geometry, check_crc, backend,
            intervals=intervals, header=header, config=config)[:3]

    policy = _span_policy(payload, config, quarantine, ladder,
                          decision.host_backend, _payload_empty(geometry))

    def decode(span):
        with METRICS.timer("pipeline.host_decode"), \
                METRICS.wall_timer("pipeline.host_decode_wall"), \
                METRICS.span("bam.host_decode_wall"):
            return policy(span)

    with _reading(path, config) as src:
        yield from _payload_groups(
            spans, _payload_specs(geometry), geometry, axis, emit_fn,
            config, prefetch, decode,
            stream_fused=decision.stream_fused, balance=balance)
    quarantine_run_ok(path, config)


def _stats_dispatch(axis: DataAxis, step: Callable,
                    totals: "_StatTotals") -> Callable:
    """Tile groups through K2, ``step(*device tiles, count)`` on each
    device (``seq_stats_step`` or ``read_stats_step``), added into
    ``totals``."""
    def dispatch(tensors, counts):
        parts = []
        copies = _CopiesDone()
        for i, dev in enumerate(axis.devices):
            tiles = [_copy_to(t[i], dev) for t in tensors]
            copies.record(dev)
            parts.append(step(*tiles, int(counts[i])))
        totals.add(axis.sum([p[0] for p in parts]),
                   axis.sum([p[1] for p in parts]))
        return copies.handle()
    return dispatch


def _bam_stats_step(geometry: PayloadGeometry) -> Callable:
    return lambda prefix, seq, qual, n: seq_stats_step(
        prefix, seq, qual, n, geometry.max_len)


def _seq_stats_device(path: str, axis: DataAxis, config: HBamConfig,
                      geometry: PayloadGeometry, header,
                      spans: Optional[Sequence[FileVirtualSpan]],
                      prefetch: int,
                      quarantine: Optional[QuarantineManifest]):
    """seq_stats on the device decode plane: token chunks through
    K7+K8, K9, K1, K10p and K2; cut tails and over-wide spans through
    the host payload path."""
    totals = _StatTotals()

    def step(tokens, n_tokens, isize, start, stop, P):
        fvec, ivec, walk = device_seq_stats_step(
            tokens, n_tokens, isize, start, stop, geometry, P)
        totals.add(fvec.to(axis.devices[0]), ivec.to(axis.devices[0]))
        return walk

    fixups = _device_plane(path, axis, config, header, spans, prefetch,
                           step, quarantine)
    if fixups:
        def payload(span, backend):
            return decode_span_payload_host(src, span, geometry,
                                            config.check_crc, backend,
                                            config=config)[:3]

        with _reading(path, config) as src:
            _feed_payload(fixups, geometry, axis,
                          _stats_dispatch(axis, _bam_stats_step(geometry),
                                          totals), config,
                          prefetch, _fixup_policy(payload, config, quarantine,
                                                  _payload_empty(geometry)))
    return _attach_quarantine(_payload_stats_result(totals), quarantine)


def seq_stats_file(path: str, device=None,
                   config: HBamConfig = DEFAULT_CONFIG,
                   geometry: Optional[PayloadGeometry] = None,
                   header: Optional[SAMHeader] = None,
                   spans: Optional[Sequence[FileVirtualSpan]] = None,
                   prefetch: int = 2,
                   quarantine: Optional[QuarantineManifest] = None
                   ) -> Dict[str, object]:
    """Sequence/quality stats over a whole BAM: mean GC fraction, mean
    per-read quality and the 4-bit base-code histogram, computed by the
    K2 kernel on each device of the axis (``cuda:0`` unless ``device``
    says otherwise).  On the device decode plane the payload tiles are
    cut from the inflated bytes on the card (K7+K8, K9, K1, K10p).

    The reference's sequence: plane selection (``select_plane``, the
    device breaker consulted last), the quarantine gate and the device
    plane when selected, demotion to the host planes on a demotable
    fault, the host run (gate, span policy, ``quarantine_run_ok``), then
    the device blame.  A non-empty ``quarantine`` rides the result."""
    axis = data_axis(device)
    geometry = geometry if geometry is not None else PayloadGeometry()
    spans = list(spans) if spans is not None else None
    header = _header_for(path, header, config)
    intervals = parse_config_intervals(config, header)
    ladder = decode_ladder(path, resolve_inflate_backend(config), config) \
        if config.adaptive_planes else None
    decision = select_plane(config, intervals=intervals, ladder=ladder)
    if decision.plane == "device":
        check_quarantine_gate(path, config)

    def host_run():
        nonlocal quarantine
        host_spans = spans if spans is not None \
            else _plan(path, header, axis.n_dev, SEQ_STATS_SPAN_BYTES,
                         config)
        totals = _StatTotals()
        if quarantine is None:
            quarantine = QuarantineManifest()
        dispatch = _stats_dispatch(axis, _bam_stats_step(geometry), totals)
        for _ in iter_payload_tile_groups(
                path, host_spans, geometry, axis,
                lambda t, c: (None, dispatch(t, c)), config, prefetch,
                header=header, quarantine=quarantine):
            pass
        return _attach_quarantine(_payload_stats_result(totals), quarantine)

    return _run_planes(
        path, config, decision, ladder,
        lambda: _seq_stats_device(path, axis, config, geometry, header,
                                  spans, prefetch, quarantine),
        host_run)


def _owned_copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A ring view -> a tensor on ``device`` that its consumer owns:
    copied asynchronously from pinned memory on CUDA, cloned on the CPU
    (where ``.to`` would hand out the ring's own memory)."""
    if device.type == "cuda":
        return t.to(device, non_blocking=True)
    return t.clone()


def _batch_emit(device: torch.device, names: Sequence[str]) -> Callable:
    """``emit_fn`` of the ``tensor_batches`` feeds: each group's tiles
    under ``names`` plus ``n_records`` (int32 [n_dev]) as tensors on
    ``device``; the in-flight handle covers the copies."""
    def emit(tensors, counts):
        out = {name: _owned_copy(t, device)
               for name, t in zip(names, tensors)}
        out["n_records"] = torch.from_numpy(counts.copy()).to(device)
        copies = _CopiesDone()
        copies.record(device)
        return out, copies.handle()
    return emit


def _read_decode(tiles_of: Callable, geometry: PayloadGeometry,
                 config: HBamConfig,
                 quarantine: Optional[QuarantineManifest] = None
                 ) -> Callable:
    """The read feeds' ``decode``: ``tiles_of(span)`` -> (seq, qual,
    lengths) rows under ``decode_with_retry``; a skipped span gives no
    rows."""
    empty = tuple(np.empty((0,) + spec.shape, spec.dtype)
                  for spec in _read_specs(geometry))

    def decode(span):
        out = decode_with_retry(tiles_of, span, config, quarantine=quarantine)
        return empty if out is None else out
    return decode


def stream_read_tensor_batches(spans, read_span_fn, config: HBamConfig,
                               device=None,
                               geometry: Optional[PayloadGeometry] = None
                               ) -> Iterator[Dict[str, torch.Tensor]]:
    """The tensor-batch generator of the read formats:
    ``read_span_fn(span)`` gives objects with ``.sequence`` /
    ``.quality``, packed by ``fragments_to_payload_tiles``.  Spans
    decode on the pool under the span failure policy; yields
    {seq_packed, qual, lengths, n_records} on ``device``, rows in
    stream order (no balance)."""
    from hadoop_bam_torch.api.read_datasets import fragments_to_payload_tiles

    axis = data_axis(device)
    geometry = geometry if geometry is not None else PayloadGeometry()

    def tiles_of(span):
        return fragments_to_payload_tiles(
            read_span_fn(span), geometry.seq_stride, geometry.qual_stride,
            geometry.max_len)

    yield from _payload_groups(
        spans, _read_specs(geometry), geometry, axis,
        _batch_emit(axis.devices[0], ("seq_packed", "qual", "lengths")),
        config, 2, _read_decode(tiles_of, geometry, config), balance=False)


def pipeline_span_count(path, n_dev: int,
                        config: HBamConfig = DEFAULT_CONFIG) -> int:
    """Spans at the pipeline grain for a whole-file text stats driver:
    min(config.split_size, 4 MiB), so that a file of one 128 MiB job
    grain still overlaps its host tokenize with the dispatches; at least
    one span per device, and one per device when the size is unknown."""
    grain = float(max(1, min(int(config.split_size), 4 << 20)))
    try:
        with scoped_byte_source(path) as src:
            size = src.size
    except Exception:  # noqa: BLE001 -- planning must not fail the driver
        return n_dev
    return max(n_dev, int(np.ceil(size / grain)))


# text read-format extensions of the payload stats drivers
FASTQ_EXTS = (".fastq", ".fq", ".fastq.gz", ".fq.gz")
QSEQ_EXTS = (".qseq", ".qseq.gz")
TEXT_READ_EXTS = FASTQ_EXTS + QSEQ_EXTS


def fastq_seq_stats_file(path: str, device=None,
                         config: HBamConfig = DEFAULT_CONFIG,
                         geometry: Optional[PayloadGeometry] = None,
                         spans=None,
                         quarantine: Optional[QuarantineManifest] = None
                         ) -> Dict[str, object]:
    """GC / quality / base stats over a FASTQ, or a QSEQ (by its
    extension), through K2 on ``cuda:0`` unless ``device`` says
    otherwise: the text twin of ``seq_stats_file``, with the same result
    dict.  Spans are planned at ``pipeline_span_count``'s grain (a
    gzipped file is one span) and tokenized by the vectorized packers,
    or parsed into objects when ``*_filter_failed_qc`` needs the read
    names' filter flag; each decodes under ``decode_with_retry`` (a
    skipped span goes into ``quarantine``, which rides the result when
    not empty)."""
    from hadoop_bam_torch.api.read_datasets import (
        fastq_text_to_payload_tiles, fragments_to_payload_tiles,
        open_fastq, open_qseq, qseq_text_to_payload_tiles,
    )

    axis = data_axis(device)
    geometry = geometry if geometry is not None else PayloadGeometry()
    if path.lower().endswith(QSEQ_EXTS):
        ds = open_qseq(path, device=axis.devices[0], config=config)
        fast_tiles = not config.qseq_filter_failed_qc
        qual_offset = config.qseq_base_quality_encoding.value
        text_to_tiles = qseq_text_to_payload_tiles
    else:
        ds = open_fastq(path, device=axis.devices[0], config=config)
        fast_tiles = not config.fastq_filter_failed_qc
        qual_offset = config.fastq_base_quality_encoding.value
        text_to_tiles = fastq_text_to_payload_tiles
    if spans is None:
        spans = ds.spans(num_spans=pipeline_span_count(path, axis.n_dev,
                                                       config))
    spans = list(spans)
    if quarantine is None:
        quarantine = QuarantineManifest()
    if quarantine.total_spans is None:
        quarantine.total_spans = len(spans)
    totals = _StatTotals()

    def tiles_of(span):
        if fast_tiles:
            return text_to_tiles(ds.read_span_text(span),
                                 geometry.seq_stride, geometry.qual_stride,
                                 geometry.max_len, qual_offset)
        return fragments_to_payload_tiles(
            ds.read_span(span), geometry.seq_stride, geometry.qual_stride,
            geometry.max_len)

    dispatch = _stats_dispatch(axis, read_stats_step, totals)
    for _ in _payload_groups(
            spans, _read_specs(geometry), geometry, axis,
            lambda t, c: (None, dispatch(t, c)), config, 2,
            _read_decode(tiles_of, geometry, config, quarantine)):
        pass
    return _attach_quarantine(_payload_stats_result(totals), quarantine)


def _flagstat_tiles(axis: DataAxis, config: HBamConfig,
                    geometry: DecodeGeometry,
                    spans: Iterable[FileVirtualSpan], prefetch: int,
                    decode: Callable, stream_fused: bool = False
                    ) -> Optional[torch.Tensor]:
    """Projected-row tiles (``decode(span)`` -> rows, or a fused chunk
    stream of ``(rows,)``): 11 bytes per record cross the link."""
    projection = FLAGSTAT_PROJECTION
    row_bytes = projection_row_bytes(projection)
    total: List[Optional[torch.Tensor]] = [None]

    def dispatch(tensors, counts):
        parts = []
        copies = _CopiesDone()
        for i, dev in enumerate(axis.devices):
            tile = _copy_to(tensors[0][i], dev)
            copies.record(dev)
            parts.append(flagstat_tile_step(tile, int(counts[i]), projection)
                         .to(torch.int64))
        vec = axis.sum(parts)
        total[0] = vec if total[0] is None else total[0] + vec
        return copies.handle()

    fp = FeedPipeline(axis.n_dev, geometry.tile_records,
                      [TileSpec((row_bytes,), np.uint8)],
                      pin_memory=axis.devices[0].type == "cuda")
    window = max(1, prefetch) * config.pool_size()
    if stream_fused:
        window = _stream_window(window)
    with _decode_pool(config) as pool, \
            _span_stream(pool, spans, decode, window, config) as stream:
        fp.feed(stream, dispatch)
    return total[0]


def _flagstat_rows(src, config: HBamConfig, intervals=None, header=None,
                   stream_fused: bool = False) -> Callable:
    """``rows(span, backend)``: a span's flagstat-projection rows, or on
    the native plane with ``stream_fused`` its fused chunk stream (the
    cut-tail fallback under its own ``decode_with_retry``)."""
    ranges = projection_ranges(FLAGSTAT_PROJECTION)
    row_bytes = projection_row_bytes(FLAGSTAT_PROJECTION)
    check_crc = config.check_crc

    def rows(span, backend):
        if stream_fused and backend == "native":
            return _iter_fused_span_chunks(
                src, span, "rows", sel=ranges, row_bytes=row_bytes,
                check_crc=check_crc, config=config,
                fallback_fn=lambda: decode_with_retry(
                    lambda s: (decode_span_prefix_host(
                        src, s, check_crc, "native", FLAGSTAT_PROJECTION,
                        want_voffs=False, config=_fused_off(config))[0],),
                    span, config))
        return decode_span_prefix_host(
            src, span, check_crc, backend, FLAGSTAT_PROJECTION,
            want_voffs=False, intervals=intervals, header=header,
            config=config)[0]
    return rows


def _flagstat_empty():
    return np.empty((0, projection_row_bytes(FLAGSTAT_PROJECTION)),
                    np.uint8)


def _flagstat_spans(path: str, axis: DataAxis, config: HBamConfig,
                    geometry: DecodeGeometry,
                    spans: Iterable[FileVirtualSpan], prefetch: int,
                    quarantine: QuarantineManifest
                    ) -> Optional[torch.Tensor]:
    """Span mode: each span's inflated bytes and record offsets go to the
    device whole, padded to the geometry (D = bytes_cap, N = records_cap,
    the reference's static span-batch shapes), and the K1 kernel gathers
    the fixed fields there.  Spans decode under the span failure policy
    and the native -> zlib ladder."""
    g = geometry
    ring = StagingRing(1, 1, [TileSpec((g.bytes_cap,), np.uint8),
                              TileSpec((g.records_cap,), np.int32)],
                       pin_memory=axis.devices[0].type == "cuda")
    parts: List[Optional[torch.Tensor]] = [None] * axis.n_dev
    ladder = decode_ladder(path, config.host_backend, config) \
        if config.adaptive_planes else None

    def span_bytes(span, backend):
        data, offs, _ = decode_span_host(src, span, g, config.check_crc,
                                         backend, config=config)
        return data, offs

    with _reading(path, config) as src, _decode_pool(config) as pool:
        decode = _span_policy(
            span_bytes, config, quarantine, ladder, config.host_backend,
            lambda: (np.empty(0, np.uint8), np.empty(0, np.int32)))
        stream = iter_windowed(pool, spans, decode,
                               max(1, prefetch) * config.pool_size(),
                               config=config)
        try:
            for k, (data, offs) in enumerate(stream):
                n = int(offs.size)
                if not n:
                    continue
                i = k % axis.n_dev
                dev = axis.devices[i]
                slot = ring.lease()
                try:
                    # the geometry's static shapes, zero-padded: padding
                    # offsets read record 0 and are masked by the count
                    buf, obuf = slot.arrays[0][0, 0], slot.arrays[1][0, 0]
                    buf[:data.size] = data
                    buf[data.size:] = 0
                    obuf[:n] = offs
                    obuf[n:] = 0
                    d = _copy_to(slot.tensors[0][0, 0], dev)
                    o = _copy_to(slot.tensors[1][0, 0], dev)
                    copies = _CopiesDone()
                    copies.record(dev)
                    slot.in_flight = copies.handle()
                finally:
                    ring.release(slot)
                vec = flagstat_step(d, o, n).to(torch.int64)
                parts[i] = vec if parts[i] is None else parts[i] + vec
        finally:
            stream.close()
    live = [p for p in parts if p is not None]
    return axis.sum(live) if live else None


def _flagstat_device(path: str, axis: DataAxis, config: HBamConfig,
                     geometry: DecodeGeometry, header,
                     spans: Optional[Sequence[FileVirtualSpan]],
                     prefetch: int,
                     quarantine: Optional[QuarantineManifest]
                     ) -> Optional[torch.Tensor]:
    """flagstat counters on the device decode plane: token chunks that
    the card resolves, walks, unpacks and reduces; cut tails and
    over-wide spans through the host projected-row path."""
    parts: List[torch.Tensor] = []

    def step(tokens, n_tokens, isize, start, stop, P):
        counts, walk = device_flagstat_step(tokens, n_tokens, isize,
                                            start, stop, P)
        counts = counts.to(axis.devices[0])
        parts[:] = [counts + parts[0] if parts else counts]
        return walk

    fixups = _device_plane(path, axis, config, header, spans, prefetch,
                           step, quarantine)
    vec = parts[0] if parts else None
    if fixups:
        with _reading(path, config) as src:
            host = _flagstat_tiles(
                axis, config, geometry, fixups, prefetch,
                _fixup_policy(_flagstat_rows(src, config), config,
                              quarantine, _flagstat_empty))
        if host is not None:
            vec = host if vec is None else vec + host
    return vec


def _flagstat_result(vec: Optional[torch.Tensor],
                     quarantine: Optional[QuarantineManifest]
                     ) -> Dict[str, int]:
    host = np.zeros(len(FLAGSTAT_FIELDS), np.int64) if vec is None \
        else vec.cpu().numpy()
    return _attach_quarantine(
        {k: int(host[i]) for i, k in enumerate(FLAGSTAT_FIELDS)},
        quarantine)


def flagstat_file(path: str, device=None,
                  config: HBamConfig = DEFAULT_CONFIG,
                  geometry: Optional[DecodeGeometry] = None,
                  header: Optional[SAMHeader] = None,
                  spans: Optional[Sequence[FileVirtualSpan]] = None,
                  prefetch: int = 2, mode: str = "tile",
                  quarantine: Optional[QuarantineManifest] = None
                  ) -> Dict[str, int]:
    """samtools-style flagstat over a whole BAM: plan -> inflate -> pack
    -> device reduce, on ``cuda:0`` unless ``device`` says otherwise.

    ``mode="tile"`` (the reference's default driver) ships 11-byte
    projected rows, or, on the device decode plane, token chunks that the
    card resolves, walks and unpacks itself; ``mode="span"`` ships whole
    inflated spans and gathers the fixed fields on the device with the K1
    kernel (the reference's span-mode step), planning smaller spans to
    fit ``geometry.bytes_cap``; it inflates on the host whatever the
    plane, and has no interval filter (PlanError).

    The reference's sequence: the file's quarantine gate, plane
    selection (the device breaker consulted last), the device plane when
    selected, demotion to the host planes on a demotable fault, the host
    run under the span failure policy, the device blame, then
    ``quarantine_run_ok``.  A non-empty ``quarantine`` rides the
    result."""
    axis = data_axis(device)
    geometry = geometry if geometry is not None else DecodeGeometry()
    if mode not in ("tile", "span"):
        raise PlanError(f"unknown flagstat mode {mode!r}")
    if mode == "span" and config.bam_intervals:
        raise PlanError("flagstat mode='span' has no interval filter; use "
                        "mode='tile' with bam_intervals")
    spans = list(spans) if spans is not None else None
    check_quarantine_gate(path, config)
    if mode == "span":
        if spans is None:
            spans = _plan(path, header, axis.n_dev, geometry.bytes_cap // 8,
                          config)
        if quarantine is None:
            quarantine = QuarantineManifest()
        vec = _flagstat_spans(path, axis, config, geometry,
                              _planned(spans, config, quarantine), prefetch,
                              quarantine)
        quarantine_run_ok(path, config)
        return _flagstat_result(vec, quarantine)

    header = _header_for(path, header, config)
    intervals = parse_config_intervals(config, header)
    ladder = decode_ladder(path, resolve_inflate_backend(config), config) \
        if config.adaptive_planes else None
    decision = select_plane(config, intervals=intervals, ladder=ladder)

    def host_run():
        nonlocal quarantine
        host_spans = spans if spans is not None \
            else _plan(path, header, axis.n_dev, FLAGSTAT_SPAN_BYTES,
                         config)
        if quarantine is None:
            quarantine = QuarantineManifest()
        with _reading(path, config) as src:
            vec = _flagstat_tiles(
                axis, config, geometry,
                _planned(host_spans, config, quarantine), prefetch,
                _span_policy(_flagstat_rows(src, config, intervals, header,
                                            decision.stream_fused),
                             config, quarantine, ladder,
                             decision.host_backend, _flagstat_empty),
                stream_fused=decision.stream_fused)
        quarantine_run_ok(path, config)
        return _flagstat_result(vec, quarantine)

    return _run_planes(
        path, config, decision, ladder,
        lambda: _flagstat_result(
            _flagstat_device(path, axis, config, geometry, header, spans,
                             prefetch, quarantine), quarantine),
        host_run)


# ---------------------------------------------------------------------------
# Coverage (K12): per-base aligned depth over a genomic window
# ---------------------------------------------------------------------------

# row layout: the fixed-field projection (offsets from FIXED_FIELDS, the
# one place that owns the BAM field map), then the cigar words
_COVERAGE_PROJECTION = ("refid", "pos", "n_cigar", "flag")
_CIGAR_ROW_HDR = projection_row_bytes(_COVERAGE_PROJECTION)   # 12
# the whole-file plan's grain when the BAM has no .bai (the reference's)
COVERAGE_SPAN_BYTES = 4 << 20
# the widest window one call covers (the reference's cap)
COVERAGE_MAX_WINDOW = 1 << 26


def _cigar_row_bytes(max_cigar: int) -> int:
    return _CIGAR_ROW_HDR + 4 * max_cigar


def decode_span_cigar_rows(source, span: FileVirtualSpan, max_cigar: int,
                           check_crc: bool = False,
                           config: Optional[HBamConfig] = None
                           ) -> np.ndarray:
    """The coverage path's host stage: inflate a span (the fused pass in
    offsets mode on the native plane, else the two-pass path) and pack
    one dense row per record: the (refid, pos, n_cigar, flag) projection
    and the cigar words, zero-padded to ``max_cigar`` ops.

    Ops past ``max_cigar`` are dropped from the row, whose n_cigar field
    keeps the full count, so that the driver raises outside the span
    retry boundary (a user parameter is neither retried nor quarantined
    as corruption)."""
    cfg = config if config is not None else DEFAULT_CONFIG
    host_backend = cfg.host_backend
    got = _decode_span_fused(source, span, "offsets", check_crc=check_crc,
                             want_voffs=False, config=config) \
        if _use_fused(config, host_backend) else None
    if got is None:
        got = _decode_span_core(source, span, check_crc, host_backend,
                                want_voffs=False)
    d, o, _voffs, _ = got
    c = o.size
    rows = np.zeros((c, _cigar_row_bytes(max_cigar)), dtype=np.uint8)
    if c == 0:
        return rows
    o64 = o.astype(np.int64)
    dst = 0
    for src_off, width in projection_ranges(_COVERAGE_PROJECTION):
        rows[:, dst:dst + width] = \
            d[o64[:, None] + np.arange(src_off, src_off + width)]
        dst += width
    nc_off = _CIGAR_ROW_HDR - 4          # n_cigar u16 within the row
    n_cigar = (rows[:, nc_off].astype(np.int64)
               | (rows[:, nc_off + 1].astype(np.int64) << 8))
    cigar_off = o64 + PREFIX + d[o64 + 12].astype(np.int64)
    byte_counts = 4 * np.minimum(n_cigar, max_cigar)
    total_b = int(byte_counts.sum())
    if total_b:
        starts_b = np.cumsum(byte_counts) - byte_counts
        flat_b = (np.arange(total_b, dtype=np.int64)
                  - np.repeat(starts_b, byte_counts))
        row_i = np.repeat(np.arange(c, dtype=np.int64), byte_counts)
        rows[row_i, _CIGAR_ROW_HDR + flat_b] = \
            d[np.repeat(cigar_off, byte_counts) + flat_b]
    return rows


def _coverage_inputs(tile: torch.Tensor, count: int, max_cigar: int):
    """A cigar-row tile [rows, 12 + 4 * max_cigar] -> (cigar words,
    projected columns, row_valid)."""
    cols = unpack_projected_tile(tile[:, :_CIGAR_ROW_HDR],
                                 _COVERAGE_PROJECTION)
    ops4 = tile[:, _CIGAR_ROW_HDR:].reshape(tile.shape[0], max_cigar, 4) \
        .to(torch.int64)
    ops = ops4[..., 0] | (ops4[..., 1] << 8) | (ops4[..., 2] << 16) | \
        (ops4[..., 3] << 24)
    valid = torch.arange(tile.shape[0], device=tile.device) < count
    return ops, cols, valid


def coverage_step(tile: torch.Tensor, count: int, target_refid: int,
                  win_start: int, window: int, max_cigar: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K12 on one device: a cigar-row tile with ``count`` valid rows ->
    the window's diff array (int32 [window + 1 + SPREAD], added into
    ``out``).  The reference's step returns the window's depth per
    dispatch; the driver here adds every dispatch's diff on the card and
    runs one cumsum at the end (the same int32 sums:
    ``coverage_depth_step`` is the per-dispatch form the tests hold it
    against).  Torch ops, no hand kernel (ops/cigar.py)."""
    coverage_step.launches += 1
    ops, cols, valid = _coverage_inputs(tile, count, max_cigar)
    return coverage_diff_from_tiles(ops, cols["pos"], cols["refid"],
                                    cols["flag"], valid, target_refid,
                                    win_start, window, out=out)


coverage_step.launches = 0    # calls (chip_smoke counts the main path's)


def coverage_depth_step(tile: torch.Tensor, count: int, target_refid: int,
                        win_start: int, window: int, max_cigar: int
                        ) -> torch.Tensor:
    """The reference's per-dispatch step (``make_coverage_step``): one
    tile's depth over the window, int32 [window]."""
    ops, cols, valid = _coverage_inputs(tile, count, max_cigar)
    return window_coverage_from_tiles(ops, cols["pos"], cols["refid"],
                                      cols["flag"], valid, target_refid,
                                      win_start, window)


class _PackedCopies:
    """Contiguous pinned buffers for the width-cut tiles: a slice of a
    ring slot is strided, and a strided host tensor would be staged and
    copied synchronously.  Two buffers in turn; a buffer is written again
    only after its last copy's event fired."""

    def __init__(self, nbytes: int, pin_memory: bool):
        self._bufs = [torch.empty(nbytes, dtype=torch.uint8,
                                  pin_memory=pin_memory) for _ in range(2)]
        self._done: List[Optional[_CopiesDone]] = [None, None]
        self._k = 0

    def copy(self, rows: np.ndarray, device: torch.device) -> torch.Tensor:
        """``rows`` (a strided [R, w] view) -> a [R, w] tensor on
        ``device``, copied asynchronously from a packed pinned buffer."""
        k = self._k
        self._k ^= 1
        if self._done[k] is not None:
            self._done[k].synchronize()
            self._done[k] = None
        n, w = rows.shape
        host = self._bufs[k][:n * w].view(n, w)
        host.numpy()[:] = rows
        if device.type != "cuda":
            return host.clone()
        t = host.to(device, non_blocking=True)
        copies = _CopiesDone()
        copies.record(device)
        self._done[k] = copies
        return t


def _coverage_region(region, header: SAMHeader):
    """(target refid, 0-based window start, window) of a region string
    or an Interval, under the reference's checks."""
    from hadoop_bam_torch.split.intervals import Interval, resolve_interval
    if not isinstance(region, Interval):
        region = resolve_interval(region, header.ref_names)
    if region.rname not in header.ref_names:
        raise ValueError(f"region reference {region.rname!r} not in header")
    target_refid = header.ref_names.index(region.rname)
    end = min(region.end, header.ref_lengths[target_refid])
    window = end - region.start + 1
    if window <= 0:
        raise ValueError(f"empty region {region}")
    if window > COVERAGE_MAX_WINDOW:
        raise ValueError(f"region spans {window} bases; cap is 2^26 -- "
                         f"tile larger regions across calls")
    return region, target_refid, region.start - 1, window


def coverage_file(path: str, region, device=None,
                  config: HBamConfig = DEFAULT_CONFIG,
                  header: Optional[SAMHeader] = None,
                  spans: Optional[Sequence[FileVirtualSpan]] = None,
                  max_cigar: int = 64, tile_records: int = 1 << 15,
                  prefetch: int = 2,
                  quarantine: Optional[QuarantineManifest] = None
                  ) -> np.ndarray:
    """Per-base aligned-base depth over a genomic window, on ``cuda:0``
    unless ``device`` says otherwise: plan -> inflate -> pack cigar rows
    -> K12 diff-scatter pileup on the device -> one cumsum.

    ``region`` is a samtools-style string ("chr20:1,000-2,000", 1-based
    inclusive) or an ``Interval``; returns int32 depth, one entry a base
    (at most 2^26 bases).  With a ``.bai`` beside the BAM the plan is the
    index's chunks for the region; without one the whole file streams
    through at 4 MiB spans and rows off the region count nothing.  Spans
    longer than twice that grain are cut (``_grain_cut``, as the other
    drivers do: a .bai chunk can span a chromosome).  Each span decodes
    under ``decode_with_retry`` (quarantined under ``skip_bad_spans``) in
    the span window with ``config``'s straggler and hang defence.  Each
    dispatch ships the tile cut to its pow2 op width (at least 8): a
    record with more than ``max_cigar`` ops raises PlanError
    (``pipeline.dispatch_bytes`` counts what crosses the link)."""
    axis = data_axis(device)
    dev = axis.devices[0]
    if header is None:
        header, _ = read_bam_header(path)
    region, target_refid, win_start, window = _coverage_region(region,
                                                               header)
    if spans is None:
        # the Interval object, not its string form, goes to the planner
        # (contig names may hold ':')
        from hadoop_bam_torch.split.bai import plan_interval_spans
        spans = plan_interval_spans(path, [region], header)
        if spans is None:
            with as_byte_source(path) as src:
                size = src.size
            n_spans = max(axis.n_dev, int(np.ceil(size / COVERAGE_SPAN_BYTES)))
            spans = plan_spans_cached(path, header, config,
                                      num_spans=n_spans)
        spans = _grain_cut(path, header, spans, COVERAGE_SPAN_BYTES)
    check_crc = bool(config.check_crc)
    row_w = _cigar_row_bytes(max_cigar)
    spans = _planned(spans, config, quarantine)
    diff: List[Optional[torch.Tensor]] = [None]
    nc_off = _CIGAR_ROW_HDR - 4
    pin = dev.type == "cuda"
    packed = _PackedCopies(tile_records * row_w, pin)

    def dispatch(tensors, counts):
        tiles = tensors[0].numpy()
        c = int(counts[0])
        mc = 1
        if c:
            nc = (tiles[0, :c, nc_off].astype(np.int32)
                  | (tiles[0, :c, nc_off + 1].astype(np.int32) << 8))
            mc = max(mc, int(nc.max()))
        if mc > max_cigar:
            raise PlanError(
                f"record with {mc} cigar ops exceeds max_cigar={max_cigar}; "
                f"pass a larger max_cigar")
        mc = min(max_cigar, max(8, 1 << (mc - 1).bit_length()))
        w = _cigar_row_bytes(mc)
        METRICS.count("pipeline.dispatch_bytes",
                      tiles.shape[1] * w + int(counts.nbytes))
        t = packed.copy(tiles[0, :, :w], dev)
        diff[0] = coverage_step(t, c, target_refid, win_start, window, mc,
                                out=diff[0])
        return None      # the ring slot was read on the host above

    def decode(span):
        out = decode_with_retry(
            lambda s: decode_span_cigar_rows(src, s, max_cigar, check_crc,
                                             config=config),
            span, config, quarantine=quarantine)
        return out if out is not None else np.zeros((0, row_w), np.uint8)

    fp = FeedPipeline(axis.n_dev, tile_records,
                      [TileSpec((row_w,), np.uint8)], fixed_shape=True,
                      pin_memory=pin)
    window_spans = max(1, prefetch) * config.pool_size()
    with _reading(path, config) as src, _decode_pool(config) as pool, \
            _span_stream(pool, spans, decode, window_spans,
                         config) as stream:
        fp.feed(stream, dispatch)
    if diff[0] is None:
        return np.zeros(window, np.int32)
    depth = torch.cumsum(diff[0][:window], 0, dtype=torch.int32)
    return depth.cpu().numpy()
