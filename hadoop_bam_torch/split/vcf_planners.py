"""VCF/BCF span planning and span readers (copy of
hadoop_bam_tpu/split/vcf_planners.py), hb/VCFInputFormat.java's splits:

- text ``.vcf``: plain byte splits, lines aligned at read time
  (split/planners.read_text_span);
- ``.vcf.gz`` (BGZF): compressed byte ranges snapped to confirmed BGZF
  block starts; a line that starts exactly on a block boundary belongs
  to the span before when that block's last byte is not a newline, so
  the spans together give each line exactly once;
- ``.bcf`` (BGZF or raw): record-aligned virtual-offset spans from
  ``BCFSplitGuesser``.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bcf import BCFRecordCodec
from hadoop_bam_torch.formats.bcfio import read_bcf_header
from hadoop_bam_torch.formats.vcf import VCFHeader, VcfRecord
from hadoop_bam_torch.split.bcf_guesser import BCFSplitGuesser
from hadoop_bam_torch.split.bgzf_guesser import BGZFSplitGuesser
from hadoop_bam_torch.split.planners import plan_byte_ranges
from hadoop_bam_torch.split.spans import FileByteSpan, FileVirtualSpan
from hadoop_bam_torch.utils.seekable import as_byte_source


# ---------------------------------------------------------------------------
# BGZF-compressed text (.vcf.gz): block-aligned spans
# ---------------------------------------------------------------------------

def plan_bgzf_text_spans(path: str, *, num_spans: Optional[int] = None,
                         span_bytes: Optional[int] = None,
                         config: HBamConfig = DEFAULT_CONFIG
                         ) -> List[FileByteSpan]:
    """Compressed byte ranges snapped to confirmed BGZF block starts."""
    src = as_byte_source(path)
    try:
        size = src.size
        ranges = plan_byte_ranges(size, num_spans=num_spans,
                                  span_bytes=span_bytes if span_bytes
                                  else (None if num_spans else config.split_size))
        guesser = BGZFSplitGuesser(src)
        bounds: List[int] = []
        for (bstart, _bend) in ranges:
            if bstart == 0:
                bounds.append(0)
                continue
            b = guesser.guess_next_block_start(bstart)
            bounds.append(size if b is None else b)
        bounds.append(size)
        spans = []
        for i in range(len(bounds) - 1):
            s, e = bounds[i], bounds[i + 1]
            if s < e:
                spans.append(FileByteSpan(path, s, e))
        return spans
    finally:
        src.close()


def _prev_block_last_byte(src, coffset: int) -> Optional[int]:
    """Final inflated byte of the BGZF block that ends exactly at
    ``coffset`` (None when it cannot be located or is empty)."""
    lo = max(0, coffset - bgzf.MAX_BLOCK_SIZE)
    win = src.pread(lo, coffset - lo + bgzf.HEADER_SIZE)
    arr = np.frombuffer(win[:coffset - lo], dtype=np.uint8)
    for cand in bgzf.find_block_starts_numpy(arr):
        c = lo + int(cand)
        try:
            info = bgzf.parse_block_header(win, int(cand))
        except bgzf.BGZFError:
            continue
        if c + info.block_size == coffset:
            try:
                data = bgzf.inflate_block(win, info, check_crc=False)
            except bgzf.BGZFError:
                continue
            return data[-1] if data else None
    return None


def read_bgzf_text_span(source, span: FileByteSpan) -> bytes:
    """All text lines *starting* within the span's compressed block range.

    A line starts in the span iff its first inflated byte lies in a block
    whose compressed offset is in [span.start, span.end) — with the partial
    line carried over a boundary owned by the previous span."""
    src = as_byte_source(source)
    start, end = span.start, span.end

    chunks: List[bytes] = []
    base_len = 0          # inflated bytes belonging to in-span blocks
    coffset = start
    while coffset < min(end, src.size):
        head = src.pread(coffset, bgzf.MAX_BLOCK_SIZE)
        info = bgzf.parse_block_header(head, 0)
        chunks.append(bgzf.inflate_block(head, info, check_crc=False))
        base_len += len(chunks[-1])
        coffset += info.block_size
    buf = b"".join(chunks)
    # extend past the end until the final in-span line is complete
    while (len(buf) == 0 or not buf.endswith(b"\n")) and coffset < src.size:
        head = src.pread(coffset, bgzf.MAX_BLOCK_SIZE)
        info = bgzf.parse_block_header(head, 0)
        ext = bgzf.inflate_block(head, info, check_crc=False)
        coffset += info.block_size
        if not ext:
            continue
        nl = ext.find(b"\n")
        if nl >= 0:
            buf += ext[:nl + 1]
            break
        buf += ext

    skip_first = False
    if start > 0:
        prev = _prev_block_last_byte(src, start)
        skip_first = prev is not None and prev != 0x0A
    out = bytearray()
    pos = 0
    n = len(buf)
    first = True
    while pos < base_len and pos < n:
        nl = buf.find(b"\n", pos)
        line_end = n if nl < 0 else nl + 1
        if not (first and skip_first):
            out += buf[pos:line_end]
        first = False
        pos = line_end
    return bytes(out)


# ---------------------------------------------------------------------------
# BCF: record-aligned virtual-offset spans
# ---------------------------------------------------------------------------

def plan_bcf_spans(path: str, *, num_spans: Optional[int] = None,
                   config: HBamConfig = DEFAULT_CONFIG,
                   header: Optional[VCFHeader] = None,
                   ) -> List[FileVirtualSpan]:
    """hb/VCFInputFormat BCF path: BCFSplitGuesser-aligned virtual spans."""
    src = as_byte_source(path)
    try:
        size = src.size
        hdr, first_voffset, is_bgzf = read_bcf_header(src)
        if header is None:
            header = hdr
        ranges = plan_byte_ranges(size, num_spans=num_spans,
                                  span_bytes=None if num_spans
                                  else config.split_size)
        guesser = BCFSplitGuesser(src, header, is_bgzf=is_bgzf)
        boundaries: List[int] = []
        for (bstart, _bend) in ranges:
            if bstart == 0:
                boundaries.append(first_voffset)
                continue
            v = guesser.guess_next_record_start(bstart)
            boundaries.append(size << 16 if v is None
                              else max(v, first_voffset))
        boundaries.append(size << 16)
        spans: List[FileVirtualSpan] = []
        for i in range(len(boundaries) - 1):
            s, e = boundaries[i], boundaries[i + 1]
            if s < e:
                spans.append(FileVirtualSpan(path, s, e))
        return spans
    finally:
        src.close()


def read_bcf_span(source, span: FileVirtualSpan,
                  header: Optional[VCFHeader] = None,
                  is_bgzf: Optional[bool] = None) -> List[VcfRecord]:
    """hb/BCFRecordReader semantics: every record whose start virtual offset
    is in [span.start_voffset, span.end_voffset)."""
    src = as_byte_source(source)
    if header is None or is_bgzf is None:
        header, _, is_bgzf = read_bcf_header(src)
    codec = BCFRecordCodec(header)
    out: List[VcfRecord] = []
    if is_bgzf:
        r = bgzf.BGZFReader(src)
        r.seek_voffset(span.start_voffset)
        while True:
            v = r.voffset()
            if v >= span.end_voffset:
                break
            head = r.read(8)
            if len(head) < 8:
                break
            l_shared, l_indiv = struct.unpack("<II", head)
            body = r.read(l_shared + l_indiv)
            rec, _ = codec.decode(head + body, 0)
            out.append(rec)
    else:
        pos = span.start[0]
        end_byte = span.end[0]
        while pos < min(end_byte, src.size):
            head = src.pread(pos, 8)
            if len(head) < 8:
                break
            l_shared, l_indiv = struct.unpack("<II", head)
            body = src.pread(pos + 8, l_shared + l_indiv)
            rec, _ = codec.decode(head + body, 0)
            out.append(rec)
            pos += 8 + l_shared + l_indiv
    return out


def read_bcf_span_bytes(source, span: FileVirtualSpan,
                        is_bgzf: Optional[bool] = None) -> bytes:
    """Raw concatenated record bytes of a BCF span (no decode) — the input
    of the fast column scanner (formats/bcf.py scan_variant_columns)."""
    return read_bcf_span_frames(source, span, is_bgzf)[0]


def read_bcf_span_frames(source, span: FileVirtualSpan,
                         is_bgzf: Optional[bool] = None
                         ) -> Tuple[bytes, np.ndarray]:
    """(concatenated record bytes, per-record start offsets) of a BCF
    span — the input of the columnar decoder
    (formats/bcf_columns.decode_bcf_columns).

    The span's whole inflated range is read in BULK (block-granular,
    not per-record — two tiny ``BGZFReader.read`` calls per record were
    2.5x the columnar decode itself), then the record framing the
    decoder needs comes from one cursor chase over the ``l_shared``/
    ``l_indiv`` prefixes, which also extends the tail record past the
    span end exactly like the per-record reader did: a record belongs
    to the span iff its first byte does.  A record cut off by EOF is
    kept (the decoder raises ``BCFError`` on it, matching the record
    path); a bare header stub at EOF is dropped (the record path never
    emitted it either)."""
    src = as_byte_source(source)
    if is_bgzf is None:
        _, _, is_bgzf = read_bcf_header(src)
    unpack = struct.Struct("<II").unpack_from
    if is_bgzf:
        r = bgzf.BGZFReader(src)
        r.seek_voffset(span.start_voffset)
        buf = bytearray(r.read_to_voffset(span.end_voffset))

        def read_more(k: int) -> bytes:
            return r.read(k)
    else:
        pos0 = span.start[0]
        n_raw = max(0, min(span.end[0], src.size) - pos0)
        buf = bytearray(src.pread(pos0, n_raw) if n_raw else b"")

        def read_more(k: int) -> bytes:
            return src.pread(pos0 + len(buf), k)

    n0 = len(buf)
    starts: List[int] = []
    p = 0
    while p < n0:
        if p + 8 > len(buf):
            buf += read_more(p + 8 - len(buf))
            if p + 8 > len(buf):
                del buf[p:]                     # EOF mid-header stub
                break
        l_shared, l_indiv = unpack(buf, p)
        end = p + 8 + l_shared + l_indiv
        if end > len(buf):
            buf += read_more(end - len(buf))
            if end > len(buf):                  # EOF mid-body: keep the
                starts.append(p)                # partial; decode raises
                break
        starts.append(p)
        p = end
    return bytes(buf), np.asarray(starts, np.int64)
