"""The decode pipeline: spans -> host inflate -> device batches -> reduce.

Counterpart of hadoop_bam_tpu/parallel/pipeline.py for the first slice:

    plan record-aligned spans            split/planners.plan_bam_spans
    inflate + walk each span (threads)   ops/inflate (native C++ or zlib)
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
Retry/quarantine, interval filters and fused streaming decode are later
slices: a corrupt span raises its error class, on every plane.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
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
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.ops import inflate as inflate_ops
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
from hadoop_bam_torch.split.planners import iter_bam_spans
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.utils import native
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError
from hadoop_bam_torch.utils.seekable import as_byte_source


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
    raw, end_block_size, next_c = _fetch_span_raw(src, span)
    if raw:
        table = inflate_ops.block_table(raw)
        data, ubase = inflate_ops.inflate_span(raw, table, backend=backend)
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
    if offs.size and want_voffs:
        blk = np.searchsorted(ubase, offs, side="right") - 1
        voffs = (abs_coffs[blk].astype(np.uint64) << np.uint64(16)) | \
            (offs - ubase[blk]).astype(np.uint64)
    else:
        voffs = np.empty(0, dtype=np.uint64)
    return data, offs, voffs, rows


def decode_span_host(source, span: FileVirtualSpan, geometry: DecodeGeometry,
                     check_crc: bool = False, backend: str = "native",
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Span mode: the span's inflated bytes and its owned record offsets
    (int32), unpadded.  Returns (data, offsets, voffsets); a span over
    the geometry's caps raises PlanError (plan smaller spans)."""
    data, offs, voffs, _ = _decode_span_core(source, span, check_crc,
                                             backend)
    g = geometry
    if data.size > g.bytes_cap or offs.size > g.records_cap:
        raise PlanError(
            f"span exceeds geometry: {data.size}B/{offs.size} records vs "
            f"caps {g.bytes_cap}B/{g.records_cap} — plan smaller spans")
    return data, offs.astype(np.int32), voffs


def decode_span_prefix_host(source, span: FileVirtualSpan,
                            check_crc: bool = False,
                            backend: str = "native",
                            projection: Tuple[str, ...] = ALL_FIELDS,
                            want_voffs: bool = True,
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Prefix mode: each owned record's projected prefix bytes packed
    densely.  Returns (rows[n, row_bytes] uint8, voffsets[n]).  The
    native plane walks and packs in one C++ pass."""
    row_bytes = projection_row_bytes(projection)
    ranges = projection_ranges(projection)
    walker = None
    if backend == "native":
        def walker(data, start, end_limit):
            stop = min(int(end_limit), data.size)
            cap = max(16, (stop - start) // 36 + 1)
            return native.walk_bam_packed(np.ascontiguousarray(data), start,
                                          cap, ranges, row_bytes, stop=stop)
    data, offs, voffs, rows = _decode_span_core(
        source, span, check_crc, backend, packed_walker=walker,
        want_voffs=want_voffs)
    if rows is None:
        tile = data[offs[:, None] + np.arange(PREFIX)[None, :]] \
            if offs.size else np.empty((0, PREFIX), np.uint8)
        rows = np.concatenate([tile[:, o:o + w] for o, w in ranges], axis=1)
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
                             want_voffs: bool = False):
    """Payload mode: prefix + 4-bit seq + qual packed into dense rows.
    Returns (prefix[n, 36], seq[n, seq_stride], qual[n, qual_stride],
    voffsets[n]).  The native plane packs in one C++ pass
    (hbam_walk_bam_payload)."""
    g = geometry
    out: Dict[str, np.ndarray] = {}
    walker = None
    if backend == "native":
        def walker(data, start, end_limit):
            stop = min(int(end_limit), data.size)
            cap = max(16, (stop - start) // 36 + 1)
            prefix, seq, qual, offs, tail = native.walk_bam_payload(
                np.ascontiguousarray(data), start, cap, g.max_len,
                g.seq_stride, g.qual_stride, stop=stop)
            out["seq"], out["qual"] = seq, qual
            return prefix, offs, tail
    data, offs, voffs, rows = _decode_span_core(
        source, span, check_crc, backend, packed_walker=walker,
        want_voffs=want_voffs)
    n = int(offs.size)
    if rows is not None:
        return rows, out["seq"][:n], out["qual"][:n], voffs
    prefix, seq, qual = _pack_payload_numpy(data, offs, g)
    return prefix, seq, qual, voffs


def iter_windowed(pool: cf.ThreadPoolExecutor, items: Iterable,
                  fn: Callable, window: int) -> Iterator:
    """``fn(item)`` on the pool with at most ``window`` futures in
    flight; results in order.  Closing the generator early cancels the
    futures that have not started and closes ``items`` when it is a
    generator."""
    it = iter(items)
    dq: "deque[cf.Future]" = deque()
    try:
        for item in it:
            dq.append(pool.submit(fn, item))
            if len(dq) >= window:
                break
        while dq:
            fut = dq.popleft()
            nxt = next(it, None)
            if nxt is not None:
                dq.append(pool.submit(fn, nxt))
            yield fut.result()
    finally:
        for f in dq:
            f.cancel()
        if hasattr(it, "close"):
            it.close()


def _plan(path: str, header: Optional[SAMHeader], n_dev: int,
          span_bytes: int) -> Iterator[FileVirtualSpan]:
    """Spans of about ``span_bytes`` compressed bytes, at least one per
    device, yielded while later boundaries are still being guessed."""
    with as_byte_source(path) as src:
        size = src.size
    n_spans = max(n_dev, int(np.ceil(size / span_bytes)))
    return iter_bam_spans(path, num_spans=n_spans, header=header)


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


def _tokenize_span_tokens(src, span: FileVirtualSpan,
                          check_crc: bool = False) -> Optional[_TokenChunk]:
    """Host half of the device plane for one span: fetch, block table and
    the threaded native tokenize.  DEFLATE, ISIZE and CRC faults raise
    BGZFError here, as the host planes raise them.  None for an empty
    span."""
    raw, end_block_size, _ = _fetch_span_raw(src, span)
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
                  step: Callable) -> List[FileVirtualSpan]:
    """Run every span's token chunk through ``step(tokens, n_tokens,
    isize, start, stop, P)`` (which keeps its own totals and returns the
    chunk's int32 [3] walk scalars) and return the spans the host must
    finish.  Raises PlanError without the native tokenizer, BGZFError for
    a bad block, CorruptDataError for a malformed record chain or a chunk
    with more records than its capacity."""
    require_tokenizer()
    if spans is None:
        spans = _plan(path, header, axis.n_dev, DEVICE_PLANE_SPAN_BYTES)
    ring = _TokenRing(pin_memory=axis.devices[0].type == "cuda")
    pending: List[Tuple[torch.Tensor, _TokenChunk, int]] = []
    with as_byte_source(path) as src, cf.ThreadPoolExecutor(
            config.pool_size(), thread_name_prefix="hbam-tokenize") as pool:
        stream = iter_windowed(
            pool, spans,
            lambda s: _tokenize_span_tokens(src, s, config.check_crc),
            max(1, prefetch) * config.pool_size())
        try:
            for chunk in stream:
                if chunk is None:
                    continue
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


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def iter_payload_tile_groups(path: str, spans: Sequence[FileVirtualSpan],
                             geometry: PayloadGeometry, axis: DataAxis,
                             dispatch_fn: Callable,
                             config: HBamConfig = DEFAULT_CONFIG,
                             prefetch: int = 2) -> int:
    """Decode spans on the pool, pack (prefix, seq, qual) row tiles and
    hand each group to ``dispatch_fn(tensors, counts)`` (the FeedPipeline
    contract).  Returns the number of groups."""
    widths = (PREFIX, geometry.seq_stride, geometry.qual_stride)
    backend = config.host_backend

    def decode(span):
        prefix, seq, qual, _ = decode_span_payload_host(
            src, span, geometry, config.check_crc, backend)
        return prefix, seq, qual

    fp = FeedPipeline(axis.n_dev, geometry.tile_records,
                      [TileSpec((w,), np.uint8) for w in widths],
                      block_n=geometry.block_n,
                      pin_memory=axis.devices[0].type == "cuda")
    with as_byte_source(path) as src, cf.ThreadPoolExecutor(
            config.pool_size(), thread_name_prefix="hbam-decode") as pool:
        stream = iter_windowed(pool, spans, decode,
                               max(1, prefetch) * config.pool_size())
        try:
            return fp.feed(stream, dispatch_fn)
        finally:
            stream.close()


def _seq_stats_tiles(path: str, axis: DataAxis, config: HBamConfig,
                     geometry: PayloadGeometry,
                     spans: Sequence[FileVirtualSpan], prefetch: int,
                     totals: "_StatTotals") -> None:
    """Host-plane payload tiles through K2, added into ``totals``."""
    def dispatch(tensors, counts):
        parts = []
        copies = _CopiesDone()
        for i, dev in enumerate(axis.devices):
            prefix, seq, qual = (_copy_to(t[i], dev) for t in tensors)
            copies.record(dev)
            parts.append(seq_stats_step(prefix, seq, qual, int(counts[i]),
                                        geometry.max_len))
        totals.add(axis.sum([p[0] for p in parts]),
                   axis.sum([p[1] for p in parts]))
        return copies.handle()

    iter_payload_tile_groups(path, spans, geometry, axis, dispatch, config,
                             prefetch)


def seq_stats_file(path: str, device=None,
                   config: HBamConfig = DEFAULT_CONFIG,
                   geometry: Optional[PayloadGeometry] = None,
                   header: Optional[SAMHeader] = None,
                   spans: Optional[Sequence[FileVirtualSpan]] = None,
                   prefetch: int = 2) -> Dict[str, object]:
    """Sequence/quality stats over a whole BAM: mean GC fraction, mean
    per-read quality and the 4-bit base-code histogram, computed by the
    K2 kernel on each device of the axis (``cuda:0`` unless ``device``
    says otherwise).  On the device decode plane the payload tiles are
    cut from the inflated bytes on the card (K7+K8, K9, K1, K10p)."""
    axis = data_axis(device)
    geometry = geometry if geometry is not None else PayloadGeometry()
    totals = _StatTotals()
    if resolve_inflate_backend(config) == "device":
        def step(tokens, n_tokens, isize, start, stop, P):
            fvec, ivec, walk = device_seq_stats_step(
                tokens, n_tokens, isize, start, stop, geometry, P)
            totals.add(fvec.to(axis.devices[0]), ivec.to(axis.devices[0]))
            return walk

        spans = _device_plane(path, axis, config, header, spans, prefetch,
                              step)
    elif spans is None:
        spans = _plan(path, header, axis.n_dev, 8 << 20)
    if spans:
        _seq_stats_tiles(path, axis, config, geometry, spans, prefetch,
                         totals)
    return _payload_stats_result(totals)


def _flagstat_tiles(path: str, axis: DataAxis, config: HBamConfig,
                    geometry: DecodeGeometry,
                    spans: Sequence[FileVirtualSpan], prefetch: int
                    ) -> Optional[torch.Tensor]:
    """Projected-row tiles: 11 bytes per record cross the link."""
    projection = FLAGSTAT_PROJECTION
    row_bytes = projection_row_bytes(projection)
    total: List[Optional[torch.Tensor]] = [None]

    def decode(span):
        rows, _ = decode_span_prefix_host(
            src, span, config.check_crc, config.host_backend,
            projection, want_voffs=False)
        return (rows,)

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
    with as_byte_source(path) as src, cf.ThreadPoolExecutor(
            config.pool_size(), thread_name_prefix="hbam-decode") as pool:
        stream = iter_windowed(pool, spans, decode,
                               max(1, prefetch) * config.pool_size())
        try:
            fp.feed(stream, dispatch)
        finally:
            stream.close()
    return total[0]


def _flagstat_spans(path: str, axis: DataAxis, config: HBamConfig,
                    geometry: DecodeGeometry,
                    spans: Sequence[FileVirtualSpan], prefetch: int
                    ) -> Optional[torch.Tensor]:
    """Span mode: each span's inflated bytes and record offsets go to the
    device whole, padded to the geometry (D = bytes_cap, N = records_cap,
    the reference's static span-batch shapes), and the K1 kernel gathers
    the fixed fields there."""
    g = geometry
    ring = StagingRing(1, 1, [TileSpec((g.bytes_cap,), np.uint8),
                              TileSpec((g.records_cap,), np.int32)],
                       pin_memory=axis.devices[0].type == "cuda")
    parts: List[Optional[torch.Tensor]] = [None] * axis.n_dev

    def decode(span):
        data, offs, _ = decode_span_host(src, span, g, config.check_crc,
                                         config.host_backend)
        return data, offs

    with as_byte_source(path) as src, cf.ThreadPoolExecutor(
            config.pool_size(), thread_name_prefix="hbam-decode") as pool:
        stream = iter_windowed(pool, spans, decode,
                               max(1, prefetch) * config.pool_size())
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


def flagstat_file(path: str, device=None,
                  config: HBamConfig = DEFAULT_CONFIG,
                  geometry: Optional[DecodeGeometry] = None,
                  header: Optional[SAMHeader] = None,
                  spans: Optional[Sequence[FileVirtualSpan]] = None,
                  prefetch: int = 2, mode: str = "tile") -> Dict[str, int]:
    """samtools-style flagstat over a whole BAM: plan -> inflate -> pack
    -> device reduce, on ``cuda:0`` unless ``device`` says otherwise.

    ``mode="tile"`` (the reference's default driver) ships 11-byte
    projected rows, or, on the device decode plane, token chunks that the
    card resolves, walks and unpacks itself; ``mode="span"`` ships whole
    inflated spans and gathers the fixed fields on the device with the K1
    kernel (the reference's span-mode step), planning smaller spans to
    fit ``geometry.bytes_cap``; it inflates on the host whatever the
    plane."""
    axis = data_axis(device)
    geometry = geometry if geometry is not None else DecodeGeometry()
    if mode == "tile":
        vec = None
        if resolve_inflate_backend(config) == "device":
            parts: List[torch.Tensor] = []

            def step(tokens, n_tokens, isize, start, stop, P):
                counts, walk = device_flagstat_step(tokens, n_tokens, isize,
                                                    start, stop, P)
                counts = counts.to(axis.devices[0])
                parts[:] = [counts + parts[0] if parts else counts]
                return walk

            spans = _device_plane(path, axis, config, header, spans,
                                  prefetch, step)
            vec = parts[0] if parts else None
        elif spans is None:
            spans = _plan(path, header, axis.n_dev, 4 << 20)
        if spans:
            host = _flagstat_tiles(path, axis, config, geometry, spans,
                                   prefetch)
            if host is not None:
                vec = host if vec is None else vec + host
    elif mode == "span":
        if spans is None:
            spans = _plan(path, header, axis.n_dev, geometry.bytes_cap // 8)
        vec = _flagstat_spans(path, axis, config, geometry, spans, prefetch)
    else:
        raise PlanError(f"unknown flagstat mode {mode!r}")
    host = np.zeros(len(FLAGSTAT_FIELDS), np.int64) if vec is None \
        else vec.cpu().numpy()
    return {k: int(host[i]) for i, k in enumerate(FLAGSTAT_FIELDS)}
