"""Span planning (trimmed copy of hadoop_bam_tpu/split/planners.py).

Byte ranges at a target split size become record-aligned virtual spans
through the BAM split guesser; empty spans are dropped.  The slice plans
without sidecar indexes, so a plan equals the reference's plan for the
same file and ``num_spans`` when no sidecar sits next to the BAM.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.formats.bamio import read_bam_header
from hadoop_bam_torch.split.bam_guesser import BAMSplitGuesser
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.seekable import as_byte_source

SPLIT_SIZE = 128 * 1024 * 1024   # the reference's default split size


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
        sb = span_bytes or SPLIT_SIZE
        bounds = np.arange(0, size + sb, sb, dtype=np.int64)
        bounds[-1] = size
        bounds = np.unique(bounds)
    return [(int(bounds[i]), int(bounds[i + 1]))
            for i in range(len(bounds) - 1)]


def plan_bam_spans(path: str, *, num_spans: Optional[int] = None,
                   header: Optional[SAMHeader] = None,
                   split_size: int = SPLIT_SIZE) -> List[FileVirtualSpan]:
    """Byte ranges -> record-aligned virtual spans (hb/BAMInputFormat
    .getSplits, guessed boundaries).  ``num_spans`` wins over
    ``split_size`` when both are given."""
    src = as_byte_source(path)
    try:
        size = src.size
        file_header, first_voffset = read_bam_header(src)
        header = header if header is not None else file_header
        ranges = plan_byte_ranges(
            size, num_spans=num_spans,
            span_bytes=None if num_spans else split_size)
        guesser = BAMSplitGuesser(src, header)
        boundaries: List[int] = []
        for bstart, _bend in ranges:
            if bstart == 0:
                boundaries.append(first_voffset)
                continue
            v = guesser.guess_next_record_start(bstart)
            boundaries.append(size << 16 if v is None
                              else max(v, first_voffset))
        boundaries.append(size << 16)
        return [FileVirtualSpan(path, s, e)
                for s, e in zip(boundaries[:-1], boundaries[1:]) if s < e]
    finally:
        src.close()
