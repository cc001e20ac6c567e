"""Genomic interval filtering for BAM reads (copy of
hadoop_bam_tpu/split/intervals.py, less ``filter_batch``).

The reference's ``hadoopbam.bam.intervals`` (hb/BAMInputFormat.java,
upstream 7.7+): a run restricted to ``chr:start-end`` intervals counts
only records whose alignment span (pos + CIGAR reference span) overlaps
one of them.  Spans are filtered at batch granularity with vectorized
overlap tests.

Interval grammar (samtools-style, 1-based inclusive):
``chr`` (whole contig), ``chr:start``, ``chr:start-``, ``chr:start-end``;
multiple intervals comma-separated.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from hadoop_bam_torch.formats.bam import BamBatch, SAMHeader

_MAX_POS = (1 << 31) - 1


class IntervalError(ValueError):
    pass


@dataclass(frozen=True)
class Interval:
    rname: str
    start: int = 1            # 1-based inclusive
    end: int = _MAX_POS       # 1-based inclusive

    def __str__(self) -> str:
        return f"{self.rname}:{self.start}-{self.end}"


_INTERVAL_RE = re.compile(
    r"^(?P<chr>[^:]+?)(?::(?P<start>[\d,]+)(?P<dash>-(?P<end>[\d,]+)?)?)?$")


def parse_interval(text: str) -> Interval:
    m = _INTERVAL_RE.match(text.strip())
    if not m:
        raise IntervalError(f"cannot parse interval {text!r}")
    start = int(m.group("start").replace(",", "")) if m.group("start") else 1
    if m.group("end"):
        end = int(m.group("end").replace(",", ""))
    elif m.group("start") and not m.group("dash"):
        end = start       # "chr:pos" is a single position
    else:
        end = _MAX_POS
    if start < 1 or end < start:
        raise IntervalError(f"bad interval bounds in {text!r}")
    return Interval(m.group("chr"), start, end)


def resolve_interval(text: str,
                     ref_names: Optional[Sequence[str]] = None
                     ) -> Interval:
    """One region with samtools-style resolution against a reference
    dictionary: a verbatim contig name is a whole-contig interval even
    when it contains ':' (GRCh38 ALT/HLA names); otherwise the LONGEST
    known contig name followed by ':range' wins; otherwise the plain
    chr:start-end grammar applies."""
    t = text.strip()
    known = set(ref_names or ())
    if t in known:
        return Interval(t)
    if known and ":" in t:
        best = None
        for n in known:
            if t.startswith(n + ":") and (best is None
                                          or len(n) > len(best)):
                best = n
        if best is not None:
            try:
                rng = parse_interval("x:" + t[len(best) + 1:])
            except IntervalError as e:
                # re-raise naming the user's region, not the synthetic
                # "x:"-prefixed range used for parsing; keep the specific
                # cause (bad syntax vs bad bounds)
                raise IntervalError(
                    f"bad range in interval {t!r} (contig {best!r}): "
                    + str(e).replace(repr("x:" + t[len(best) + 1:]),
                                     "range")) from None
            return Interval(best, rng.start, rng.end)
    return parse_interval(t)


def parse_intervals(text: str,
                    ref_names: Optional[Sequence[str]] = None
                    ) -> List[Interval]:
    """Parse a comma-separated interval list.  When ``ref_names`` is given,
    samtools-style resolution applies: a piece that matches a contig name
    verbatim is a whole-contig interval even if it contains ':' (GRCh38
    ALT/HLA contigs like "HLA-A*01:01" would otherwise misparse)."""
    known = set(ref_names) if ref_names else ()
    out = []
    for t in text.split(","):
        t = t.strip()
        if not t:
            continue
        if t in known:
            out.append(Interval(t))
        else:
            out.append(parse_interval(t))
    return out


def batch_overlap_mask(batch: BamBatch, intervals: Sequence[Interval],
                       header: Optional[SAMHeader] = None) -> np.ndarray:
    """Boolean row mask: does each record's reference span overlap any
    interval?  Fully vectorized; CIGAR spans are computed once per batch."""
    header = header or batch.header
    if header is None:
        raise IntervalError("interval filtering needs a header to resolve "
                            "reference names")
    rid_of = {n: i for i, n in enumerate(header.ref_names)}
    mask = np.zeros(len(batch), dtype=bool)
    if not len(batch):
        return mask
    pos1 = batch.pos.astype(np.int64) + 1          # [SPEC] BAM pos is 0-based
    end1 = pos1 + np.maximum(batch.reference_span(), 1) - 1
    refid = batch.refid
    for iv in intervals:
        rid = rid_of.get(iv.rname)
        if rid is None:
            raise IntervalError(
                f"interval contig {iv.rname!r} is not in the header "
                f"reference dictionary")
        mask |= (refid == rid) & (pos1 <= iv.end) & (end1 >= iv.start)
    return mask

