"""Span planning (trimmed copy of hadoop_bam_tpu/split/planners.py).

Byte ranges at a target split size become record-aligned virtual spans
through the BAM split guesser; empty spans are dropped.  The slice plans
without sidecar indexes, so a plan equals the reference's plan for the
same file and ``num_spans`` when no sidecar sits next to the BAM.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, List, Optional, Tuple

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


def iter_bam_spans(path: str, *, num_spans: Optional[int] = None,
                   header: Optional[SAMHeader] = None,
                   split_size: int = SPLIT_SIZE) -> Iterator[FileVirtualSpan]:
    """Byte ranges -> record-aligned virtual spans (hb/BAMInputFormat
    .getSplits, guessed boundaries), yielded in order as soon as both of
    a span's boundaries are known.  One background thread guesses the
    boundaries (each guess inflates a few blocks and scans one for
    plausible records), so a consumer decodes the first spans while the
    later ones are still being planned.  ``num_spans`` wins over
    ``split_size`` when both are given."""
    src = as_byte_source(path)
    pool = cf.ThreadPoolExecutor(1, thread_name_prefix="hbam-plan")
    try:
        size = src.size
        file_header, first_voffset = read_bam_header(src)
        header = header if header is not None else file_header
        ranges = plan_byte_ranges(
            size, num_spans=num_spans,
            span_bytes=None if num_spans else split_size)
        guesser = BAMSplitGuesser(src, header)
        guesses = [pool.submit(guesser.guess_next_record_start, b)
                   for b, _ in ranges if b != 0]
        prev = first_voffset if ranges and ranges[0][0] == 0 else None
        for fut in guesses + [None]:
            if fut is None:
                v = size << 16
            else:
                g = fut.result()
                v = size << 16 if g is None else max(g, first_voffset)
            if prev is not None and prev < v:
                yield FileVirtualSpan(path, prev, v)
            prev = v
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        src.close()


def plan_bam_spans(path: str, *, num_spans: Optional[int] = None,
                   header: Optional[SAMHeader] = None,
                   split_size: int = SPLIT_SIZE) -> List[FileVirtualSpan]:
    """``iter_bam_spans`` as a list."""
    return list(iter_bam_spans(path, num_spans=num_spans, header=header,
                               split_size=split_size))
