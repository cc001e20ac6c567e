"""Span planning (trimmed copy of hadoop_bam_tpu/split/planners.py).

Byte ranges at a target split size become record-aligned virtual spans
(hb/BAMInputFormat.getSplits): snapped to a ``.splitting-bai`` / ``.sbi``
sidecar when one sits next to the BAM (``config.use_splitting_index``),
guessed by the BAM split guesser otherwise; with
``keep_paired_reads_together`` no boundary separates records that share
a query name; empty spans are dropped.  With ``bam_intervals`` and a
``.bai`` / ``.csi`` the plan is the index's chunks instead
(``plan_spans_maybe_intervals``).  ``plan_spans_cached`` plans once per
file and request, as the reference's client computes its splits once per
job.

Guessed plans stream: ``iter_bam_spans`` yields each span as soon as its
end boundary is known, while a background thread guesses the next ones,
so a driver decodes the first spans while later ones are planned; the
memo keeps that stream and stores the plan only once it has ended.

Text formats (QSEQ, FASTQ; ``plan_text_spans`` / ``read_text_span``)
split at plain byte ranges and align to lines at read time.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import threading
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bam import (
    BamBatch, SAMHeader, walk_record_offsets,
)
from hadoop_bam_torch.formats.bamio import read_bam_header
from hadoop_bam_torch.split.bam_guesser import BAMSplitGuesser
from hadoop_bam_torch.split.spans import FileByteSpan, FileVirtualSpan
from hadoop_bam_torch.split.splitting_index import SplittingIndex
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.seekable import (
    as_byte_source, scoped_byte_source,
)


def plan_byte_ranges(size: int, *, num_spans: Optional[int] = None,
                     span_bytes: Optional[int] = None
                     ) -> List[Tuple[int, int]]:
    """Uniform byte ranges; bad split parameters raise PlanError."""
    if num_spans is not None and num_spans <= 0:
        raise PlanError(f"num_spans must be positive, got {num_spans}")
    if span_bytes is not None and span_bytes <= 0:
        raise PlanError(f"span_bytes must be positive, got {span_bytes}")
    if size <= 0:
        return []
    if num_spans is not None:
        num_spans = max(1, min(num_spans, size))
        bounds = np.linspace(0, size, num_spans + 1, dtype=np.int64)
    else:
        sb = span_bytes or DEFAULT_CONFIG.split_size
        bounds = np.arange(0, size + sb, sb, dtype=np.int64)
        bounds[-1] = size
        bounds = np.unique(bounds)
    return [(int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(bounds) - 1)]


# ---------------------------------------------------------------------------
# Text formats: newline-aligned spans
# ---------------------------------------------------------------------------

def plan_text_spans(path: str, *, num_spans: Optional[int] = None,
                    span_bytes: Optional[int] = None) -> List[FileByteSpan]:
    """Plain byte splits; lines are aligned at read time
    (``read_text_span``'s LineRecordReader contract)."""
    with scoped_byte_source(path) as src:
        ranges = plan_byte_ranges(src.size, num_spans=num_spans,
                                  span_bytes=span_bytes)
    return [FileByteSpan(path, s, e) for s, e in ranges]


def read_text_span(source, span: FileByteSpan, *, chunk: int = 1 << 20
                   ) -> bytes:
    """The bytes of every line that *starts* in [span.start, span.end).

    LineRecordReader contract: past offset 0, the (maybe partial) line
    in progress at ``start`` belongs to the span before, so skip to the
    first newline at or after ``start - 1``; read past ``end`` to finish
    the last line."""
    with scoped_byte_source(source) as src:
        start, end = span.start, span.end
        if start > 0:
            probe_off = start - 1
            probe = b""
            while True:
                got = src.pread(probe_off + len(probe), chunk)
                if not got:
                    return b""
                probe += got
                nl = probe.find(b"\n")
                if nl >= 0:
                    start = probe_off + nl + 1
                    break
        if start >= end:
            return b""   # no line starts inside this span
        out = bytearray()
        pos = start
        while pos < end:
            got = src.pread(pos, min(chunk, end - pos))
            if not got:
                break
            out += got
            pos += len(got)
        while not out.endswith(b"\n") and pos < src.size:
            got = src.pread(pos, chunk)
            if not got:
                break
            nl = got.find(b"\n")
            if nl >= 0:
                out += got[:nl + 1]
                break
            out += got
            pos += len(got)
        return bytes(out)


# ---------------------------------------------------------------------------
# BAM
# ---------------------------------------------------------------------------

def iter_bam_spans(path: str, *, num_spans: Optional[int] = None,
                   config: HBamConfig = DEFAULT_CONFIG,
                   header: Optional[SAMHeader] = None,
                   index: Optional[SplittingIndex] = None
                   ) -> Iterator[FileVirtualSpan]:
    """Byte ranges (``num_spans`` of them, else ``config.split_size``
    each) -> record-aligned virtual spans, yielded in order as soon as
    both of a span's boundaries are known.  Boundaries come from
    ``index`` (or the sidecar, with ``config.use_splitting_index``) or
    are guessed on one background thread (each guess inflates a few
    blocks and scans one for plausible records); with
    ``config.keep_paired_reads_together`` each is then moved past its
    query-name group on that thread."""
    src = as_byte_source(path)
    pool = cf.ThreadPoolExecutor(1, thread_name_prefix="hbam-plan")
    try:
        size = src.size
        file_header, first_voffset = read_bam_header(src)
        header = header if header is not None else file_header
        if index is None and config.use_splitting_index:
            index = SplittingIndex.load_for(path)
        ranges = plan_byte_ranges(
            size, num_spans=num_spans,
            span_bytes=None if num_spans else config.split_size)
        end_sentinel = size << 16
        guesser = None if index is not None else \
            BAMSplitGuesser(src, header)

        def boundary(bstart: int) -> int:
            if index is not None:
                v = index.first_record_at_or_after(bstart)
            else:
                g = guesser.guess_next_record_start(bstart)
                v = end_sentinel if g is None else max(g, first_voffset)
            if config.keep_paired_reads_together:
                v = _next_name_group_start(src, path, v, header,
                                           first_voffset, end_sentinel,
                                           index, guesser)
            return v

        bounds = [pool.submit(boundary, b) for b, _ in ranges if b != 0]
        prev = first_voffset if ranges and ranges[0][0] == 0 else None
        for fut in bounds + [None]:
            v = end_sentinel if fut is None else fut.result()
            if prev is not None and prev < v:
                yield FileVirtualSpan(path, prev, v)
            prev = v
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        src.close()


def plan_bam_spans(path: str, *, num_spans: Optional[int] = None,
                   config: HBamConfig = DEFAULT_CONFIG,
                   header: Optional[SAMHeader] = None,
                   index: Optional[SplittingIndex] = None
                   ) -> List[FileVirtualSpan]:
    """``iter_bam_spans`` as a list."""
    return list(iter_bam_spans(path, num_spans=num_spans, config=config,
                               header=header, index=index))


def plan_bam_spans_balanced(path: str, num_spans: int, *,
                            header: Optional[SAMHeader] = None,
                            index: Optional[SplittingIndex] = None,
                            granularity: int = 0,
                            ) -> List[FileVirtualSpan]:
    """Record-balanced spans from a splitting index: the sampled record
    voffsets cut into ``num_spans`` runs of near-equal record count.  The
    cuts are whole virtual offsets, so a span may start inside a BGZF
    block and even a one-block BAM fills every device.  With no sidecar
    an index is built in memory, every record sampled (``granularity``
    0 or below) or every ``granularity``-th."""
    from hadoop_bam_torch.split.splitting_index import build_splitting_index
    del header
    if index is None:
        index = SplittingIndex.load_for(path)
    if index is None:
        index = build_splitting_index(path,
                                      granularity=max(1, granularity))
    samples = index.voffsets[:-1]           # drop the end sentinel
    end_sentinel = index.voffsets[-1]
    if not samples:
        return []
    num_spans = max(1, min(num_spans, len(samples)))
    bounds = np.unique(np.linspace(0, len(samples), num_spans + 1)
                       .astype(np.int64))
    spans: List[FileVirtualSpan] = []
    for i in range(len(bounds) - 1):
        s = samples[int(bounds[i])]
        e = (end_sentinel if i == len(bounds) - 2
             else samples[int(bounds[i + 1])])
        if s < e:
            spans.append(FileVirtualSpan(path, s, e))
    return spans


def _next_name_group_start(src, path: str, boundary: int,
                           header: SAMHeader, first_voffset: int,
                           end_sentinel: int, index, guesser) -> int:
    """Move a boundary forward so it never separates records sharing a
    query name (hb/BAMInputFormat.java keep-paired-reads-together,
    7.9+): read the record just before the boundary (a window of up to
    256 KiB compressed behind it), then walk forward from the boundary
    until the name changes."""
    if boundary <= first_voffset or boundary >= end_sentinel:
        return boundary
    coffset = boundary >> 16
    back_c = max(first_voffset >> 16, coffset - (1 << 18))
    if index is not None:
        back_v = index.first_record_at_or_after(back_c)
    else:
        back_v = guesser.guess_next_record_start(back_c)
        back_v = first_voffset if back_v is None else max(back_v,
                                                          first_voffset)
    prev_name = None
    if back_v < boundary:
        ctx = read_bam_span(src, FileVirtualSpan(path, back_v, boundary),
                            header=header)
        if len(ctx):
            prev_name = ctx.read_name(len(ctx) - 1)
    if prev_name is None:
        return boundary
    fwd_end = min(end_sentinel, (coffset + (1 << 18)) << 16)
    fwd = read_bam_span(src, FileVirtualSpan(path, boundary, fwd_end),
                        header=header)
    for i in range(len(fwd)):
        if fwd.read_name(i) != prev_name:
            return int(fwd.voffsets[i])
    if fwd_end >= end_sentinel:
        return end_sentinel   # the group runs to the end: merge the tail
    return boundary           # a group longer than the window: leave it


def read_bam_span(source, span: FileVirtualSpan,
                  header: Optional[SAMHeader] = None,
                  check_crc: bool = False) -> BamBatch:
    """Every record whose start virtual offset lies in [span.start,
    span.end), with its voffset (hb/BAMRecordReader): the blocks from the
    start block up to the end voffset inflated in one buffer, walked,
    and extended by following blocks while the last record is cut.  The
    end may lie inside a block that does not start there (the name-group
    windows end at plain byte offsets)."""
    src = as_byte_source(source)
    if header is None:
        header, _ = read_bam_header(src)
    start_c, start_u = span.start
    end_c, end_u = span.end
    r = bgzf.BGZFReader(src, check_crc=check_crc)
    r.seek_voffset(span.start_voffset)

    chunks: List[bytes] = []
    block_bases: List[Tuple[int, int]] = []   # (inflated base, coffset)
    total = 0
    coffset = start_c
    while coffset < src.size:
        head = src.pread(coffset, bgzf.MAX_BLOCK_SIZE)
        info = bgzf.parse_block_header(head, 0)
        if coffset > end_c or (coffset == end_c and end_u == 0):
            break
        with METRICS.timer("pipeline.inflate"):
            data = bgzf.inflate_block(head, info, check_crc=check_crc)
        if coffset == start_c and start_u:
            data = data[start_u:]
            block_bases.append((total - start_u, coffset))
        else:
            block_bases.append((total, coffset))
        chunks.append(data)
        total += len(data)
        coffset += info.block_size

    buf = b"".join(chunks)
    end_inflated = len(buf)
    if not (end_c >= coffset and coffset >= src.size):
        for base, c in block_bases:
            if c == end_c:
                end_inflated = base + end_u
                break

    offs = walk_record_offsets(buf, 0, None)
    offs = offs[offs < max(end_inflated, 1)] if len(offs) else offs
    if offs.size:
        last = int(offs[-1])
        bs = int.from_bytes(buf[last:last + 4], "little", signed=True)
        need = last + 4 + bs
        while need > len(buf) and coffset < src.size:
            head = src.pread(coffset, bgzf.MAX_BLOCK_SIZE)
            info = bgzf.parse_block_header(head, 0)
            with METRICS.timer("pipeline.inflate"):
                chunks.append(bgzf.inflate_block(head, info,
                                                 check_crc=check_crc))
            block_bases.append((len(buf), coffset))
            buf = b"".join(chunks)
            coffset += info.block_size
        offs = walk_record_offsets(buf, 0, None)
        offs = offs[offs < end_inflated]
    return BamBatch(np.frombuffer(buf, dtype=np.uint8), offs,
                    header=header,
                    voffsets=_inflated_to_voffsets(offs, block_bases))


def _inflated_to_voffsets(offs: np.ndarray,
                          block_bases: List[Tuple[int, int]]) -> np.ndarray:
    """Inflated-buffer offsets -> packed virtual offsets."""
    if offs.size == 0:
        return np.empty(0, dtype=np.uint64)
    bases = np.asarray([b for b, _ in block_bases], dtype=np.int64)
    coffs = np.asarray([c for _, c in block_bases], dtype=np.int64)
    idx = np.clip(np.searchsorted(bases, offs, side="right") - 1, 0,
                  len(bases) - 1)
    return (coffs[idx].astype(np.uint64) << np.uint64(16)) | \
        (offs - bases[idx]).astype(np.uint64)


def plan_spans_maybe_intervals(path: str, header, config: HBamConfig,
                               num_spans: Optional[int] = None
                               ) -> Iterable[FileVirtualSpan]:
    """``iter_bam_spans``, or, when ``config.bam_intervals`` is set and a
    ``.bai`` / ``.csi`` sits next to the BAM, the index's chunk ranges
    (a list): only file regions that can hold overlapping records are
    read.  A string that does not parse is a PlanError."""
    if config.bam_intervals:
        from hadoop_bam_torch.split.bai import plan_interval_spans
        from hadoop_bam_torch.split.intervals import parse_intervals
        if header is None:
            header, _ = read_bam_header(path)
        try:
            ivs = parse_intervals(config.bam_intervals, header.ref_names)
        except PlanError:
            raise
        except ValueError as e:
            raise PlanError(f"bad bam_intervals "
                            f"{config.bam_intervals!r}: {e}") from e
        spans = plan_interval_spans(path, ivs, header)
        if spans is not None:
            return spans
    return iter_bam_spans(path, num_spans=num_spans, config=config,
                          header=header)


_PLAN_CACHE: "dict[tuple, list]" = {}
_PLAN_CACHE_MAX = 32
_PLAN_LOCK = threading.Lock()
SIDECAR_SUFFIXES = (".splitting-bai", ".sbi", ".bai", ".csi")


def clear_plan_cache() -> None:
    """Forget every memoized plan (a timing run's cold start)."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()


def _stat_sig(p: str):
    try:
        st = os.stat(p)
        return (st.st_size, st.st_mtime_ns)
    except OSError:
        return None


def _plan_key(path, config: HBamConfig, num_spans: Optional[int]):
    """The memo key: the BAM's absolute path, size and mtime, the
    request, the config as a field dict, and the stat of every sidecar
    the planners may read (a rebuilt sidecar replans).  None for a
    source that is not a path."""
    if not isinstance(path, (str, os.PathLike)):
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    path = os.fspath(path)
    return (os.path.abspath(path), st.st_size, st.st_mtime_ns, num_spans,
            repr(sorted(dataclasses.asdict(config).items())),
            tuple(_stat_sig(path + suf) for suf in SIDECAR_SUFFIXES))


def plan_spans_cached(path: str, header, config: HBamConfig,
                      num_spans: Optional[int] = None
                      ) -> Iterable[FileVirtualSpan]:
    """``plan_spans_maybe_intervals`` memoized per file and request (32
    plans).  A hit returns a copy of the stored list.  A miss streams
    the plan as it is made, records the spans as they go out and stores
    the list only once the stream has ended: a plan abandoned part way
    (an exception, a closed generator) is never stored.  A source that
    is not a path is planned every time."""
    key = _plan_key(path, config, num_spans)
    if key is None:
        return plan_spans_maybe_intervals(path, header, config, num_spans)
    with _PLAN_LOCK:
        hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return list(hit)
    return _memo_stream(key, plan_spans_maybe_intervals(
        path, header, config, num_spans))


def _memo_stream(key, plan: Iterable[FileVirtualSpan]
                 ) -> Iterator[FileVirtualSpan]:
    got: List[FileVirtualSpan] = []
    for span in plan:
        got.append(span)
        yield span
    with _PLAN_LOCK:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[key] = got
