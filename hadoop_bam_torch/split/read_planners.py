"""Span planning and readers of the read formats: FASTQ, QSEQ, FASTA
(copy of hadoop_bam_tpu/split/read_planners.py), the getSplits /
RecordReader behaviour of hb/FastqInputFormat.java,
hb/QseqInputFormat.java and hb/FastaInputFormat.java:

- FASTQ: plain byte splits, aligned to records at read time by the
  @/+ heuristic (formats/fastq.find_fastq_record_start); a record
  belongs to the span its first byte is in.
- QSEQ: one record a line (split/planners.read_text_span).
- FASTA: splits snapped forward to ``>`` header lines when planned, so
  every span holds whole contigs.
"""
from __future__ import annotations

from typing import List, Optional

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats.fasta import find_sequence_start
from hadoop_bam_torch.formats.fastq import (
    find_fastq_record_start, record_fully_visible,
)
from hadoop_bam_torch.split.planners import plan_byte_ranges
from hadoop_bam_torch.split.spans import FileByteSpan
from hadoop_bam_torch.utils.seekable import (
    as_byte_source, scoped_byte_source,
)

_CHUNK = 1 << 20


def read_fastq_span(source, span: FileByteSpan) -> bytes:
    """Bytes of all FASTQ records *starting* in [span.start, span.end)."""
    with scoped_byte_source(source) as src:
        start, end = span.start, span.end
        size = src.size

        # Window from start-1 (line-start context) extended until it contains
        # a record start past `end` (the stop boundary) or EOF.
        lo = max(0, start - 1)
        buf = bytearray()
        fetch_pos = lo
        first_rel: Optional[int] = None
        stop_rel: Optional[int] = None
        while True:
            got = src.pread(fetch_pos, _CHUNK)
            buf += got
            fetch_pos += len(got)
            at_eof = fetch_pos >= size or not got
            if first_rel is None:
                cand = find_fastq_record_start(buf, start - lo)
                # trust a candidate only once its record is fully in view
                # (a truncated tail can validate a false start) — unless EOF
                if cand is not None and (at_eof
                                         or record_fully_visible(buf, cand)):
                    first_rel = cand
                elif not at_eof:
                    continue
            if first_rel is not None and fetch_pos >= end:
                stop_rel = find_fastq_record_start(buf,
                                                   max(end - lo, first_rel))
                if stop_rel is not None and not at_eof \
                        and not record_fully_visible(buf, stop_rel):
                    stop_rel = None
                    continue  # fetch more before trusting the stop boundary
                if stop_rel is not None or at_eof:
                    break
            if at_eof:
                break
        if first_rel is None or first_rel >= end - lo:
            return b""
        if stop_rel is None:
            out = bytes(buf[first_rel:])
            if not out.endswith(b"\n"):
                out += b"\n"
            return out
        return bytes(buf[first_rel:stop_rel])


def plan_fasta_spans(path: str, *, num_spans: Optional[int] = None,
                     span_bytes: Optional[int] = None,
                     config: HBamConfig = DEFAULT_CONFIG) -> List[FileByteSpan]:
    """Byte ranges snapped forward to ``>`` header-line starts."""
    src = as_byte_source(path)
    try:
        size = src.size
        ranges = plan_byte_ranges(size, num_spans=num_spans,
                                  span_bytes=span_bytes if span_bytes
                                  else (None if num_spans else config.split_size))
        bounds: List[int] = []
        for (bstart, _bend) in ranges:
            if bstart == 0:
                bounds.append(0)
                continue
            # scan forward for "\n>" (whole-file read windows)
            snapped = size
            pos = bstart
            while pos < size:
                win = src.pread(max(0, pos - 1), _CHUNK + 1)
                rel = find_sequence_start(win, pos - max(0, pos - 1))
                if rel is not None:
                    snapped = max(0, pos - 1) + rel
                    break
                pos += _CHUNK
            bounds.append(snapped)
        bounds.append(size)
        spans = []
        for i in range(len(bounds) - 1):
            s, e = bounds[i], bounds[i + 1]
            if s < e:
                spans.append(FileByteSpan(path, s, e))
        return spans
    finally:
        src.close()


def read_fasta_span(source, span: FileByteSpan) -> bytes:
    """Raw bytes of a sequence-aligned FASTA span (whole contigs)."""
    with scoped_byte_source(source) as src:
        out = bytearray()
        pos = span.start
        while pos < span.end:
            got = src.pread(pos, min(_CHUNK, span.end - pos))
            if not got:
                break
            out += got
            pos += len(got)
        return bytes(out)
