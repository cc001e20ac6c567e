"""QSEQ (Illumina qseq): the tab-line codec over SequencedFragment (copy
of hadoop_bam_tpu/formats/qseq.py).  Eleven tab-separated fields a line:
machine, run, lane, tile, x, y, index, read, sequence, quality, filter;
``.`` stands for ``N`` in the sequence, and qualities are Illumina
Phred+64 unless the config says otherwise.
"""
from __future__ import annotations

from typing import List

from hadoop_bam_torch.config import BaseQualityEncoding
from hadoop_bam_torch.formats.fastq import (
    FastqError, SequencedFragment, convert_quality,
)

N_FIELDS = 11


def parse_qseq_line(line: str,
                    encoding: BaseQualityEncoding = BaseQualityEncoding.ILLUMINA
                    ) -> SequencedFragment:
    parts = line.rstrip("\n").split("\t")
    if len(parts) != N_FIELDS:
        raise FastqError(f"qseq line has {len(parts)} fields, need {N_FIELDS}")
    (machine, run, lane, tile, x, y, index, read, seq, qual, filt) = parts
    if len(seq) != len(qual):
        raise FastqError(f"qseq SEQ/QUAL length mismatch "
                         f"({len(seq)} vs {len(qual)})")
    q = qual
    if encoding is not BaseQualityEncoding.SANGER:
        q = convert_quality(q, encoding)
    frag = SequencedFragment(
        sequence=seq.replace(".", "N"),
        quality=q,
        instrument=machine or None,
        run_number=int(run) if run else None,
        lane=int(lane) if lane else None,
        tile=int(tile) if tile else None,
        xpos=int(x) if x else None,
        ypos=int(y) if y else None,
        read=int(read) if read else None,
        filter_passed=filt == "1",
        index_sequence=None if index in ("", "0") else index,
    )
    frag.name = (f"{machine}_{run}:{lane}:{tile}:{x}:{y}"
                 f"#{index or 0}/{read or 1}")
    return frag


def format_qseq_line(f: SequencedFragment,
                     encoding: BaseQualityEncoding = BaseQualityEncoding.ILLUMINA
                     ) -> str:
    q = f.quality
    if encoding is not BaseQualityEncoding.SANGER:
        q = convert_quality(q, BaseQualityEncoding.SANGER, encoding)
    return "\t".join([
        f.instrument or "",
        str(f.run_number or 0),
        str(f.lane or 0),
        str(f.tile or 0),
        str(f.xpos or 0),
        str(f.ypos or 0),
        f.index_sequence or "0",
        str(f.read or 1),
        f.sequence.replace("N", "."),
        q,
        # unknown QC status must not be emitted as "failed" — default passed
        "0" if f.filter_passed is False else "1",
    ])


def parse_qseq(text: bytes,
               encoding: BaseQualityEncoding = BaseQualityEncoding.ILLUMINA,
               filter_failed_qc: bool = False) -> List[SequencedFragment]:
    out: List[SequencedFragment] = []
    for line in text.decode("latin-1").splitlines():
        if not line:
            continue
        frag = parse_qseq_line(line, encoding)
        if filter_failed_qc and frag.filter_passed is False:
            continue
        out.append(frag)
    return out
