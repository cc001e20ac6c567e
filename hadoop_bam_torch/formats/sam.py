"""SAM text: the line codec and SAM <-> BAM record conversion (copy of
hadoop_bam_tpu/formats/sam.py).

[SPEC] SAMv1 section 1.4: 11 mandatory tab-separated fields (QNAME FLAG
RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ QUAL) and optional
TAG:TYPE:VALUE fields.  POS/PNEXT are 1-based in SAM, 0-based in BAM.
``SamRecord`` is what ``QueryEngine.query_records`` returns.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from hadoop_bam_torch.formats.bam import (
    BAMError, SAMHeader, encode_record, format_tag, parse_cigar_string,
    tag_from_sam,
)


@dataclass
class SamRecord:
    """One alignment in SAM-field terms (positions 1-based, '*'
    sentinels)."""

    qname: str = "*"
    flag: int = 0
    rname: str = "*"
    pos: int = 0          # 1-based; 0 = unmapped
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: List[Tuple[str, str, object]] = field(default_factory=list)

    def to_line(self) -> str:
        fields = [self.qname, str(self.flag), self.rname, str(self.pos),
                  str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                  str(self.tlen), self.seq, self.qual]
        fields += [format_tag(t) for t in self.tags]
        return "\t".join(fields)

    @classmethod
    def from_line(cls, line: str) -> "SamRecord":
        parts = line.rstrip("\n").split("\t")
        if len(parts) < 11:
            raise BAMError(f"SAM line has {len(parts)} fields, need 11")
        return cls(
            qname=parts[0], flag=int(parts[1]), rname=parts[2],
            pos=int(parts[3]), mapq=int(parts[4]), cigar=parts[5],
            rnext=parts[6], pnext=int(parts[7]), tlen=int(parts[8]),
            seq=parts[9], qual=parts[10],
            tags=[tag_from_sam(t) for t in parts[11:]],
        )

    def to_bam_bytes(self, header: SAMHeader) -> bytes:
        rid = -1 if self.rname == "*" else header.ref_id(self.rname)
        if self.rnext == "=":
            mrid = rid
        elif self.rnext == "*":
            mrid = -1
        else:
            mrid = header.ref_id(self.rnext)
        return encode_record(
            name=self.qname, flag=self.flag, refid=rid, pos=self.pos - 1,
            mapq=self.mapq, cigar=parse_cigar_string(self.cigar),
            mate_refid=mrid, mate_pos=self.pnext - 1, tlen=self.tlen,
            seq=self.seq, qual=self.qual, tags=self.tags)


def read_sam_text(text: str) -> Tuple[SAMHeader, List[SamRecord]]:
    """Parse a whole SAM document (header + alignments)."""
    header_lines: List[str] = []
    records: List[SamRecord] = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("@"):
            header_lines.append(line + "\n")
        else:
            records.append(SamRecord.from_line(line))
    return SAMHeader.from_sam_text("".join(header_lines)), records


def write_sam_text(header: SAMHeader, records) -> str:
    out = [header.to_sam_text()]
    for r in records:
        out.append(r.to_line() + "\n")
    return "".join(out)
