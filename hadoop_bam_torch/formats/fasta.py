"""FASTA: the ReferenceFragment value type and sequence-aligned spans
(trimmed copy of hadoop_bam_tpu/formats/fasta.py).  A reference FASTA
splits at ``>`` header lines; each fragment carries its sequence text,
contig name and 1-based position within the contig.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


class FastaError(ValueError):
    pass


@dataclass
class ReferenceFragment:
    """One chunk of reference sequence — hb/ReferenceFragment.java."""
    sequence: str
    contig: str
    position: int   # 1-based position of sequence[0] within the contig

    def __len__(self) -> int:
        return len(self.sequence)


def parse_fasta(text: bytes, line_fragments: bool = True
                ) -> List[ReferenceFragment]:
    """Parse FASTA text into fragments.

    ``line_fragments=True`` mirrors the reference reader: one fragment per
    sequence line (with running position); False merges whole contigs."""
    out: List[ReferenceFragment] = []
    contig: Optional[str] = None
    position = 1
    merged: List[str] = []
    for raw in text.split(b"\n"):
        line = raw.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if contig is not None and not line_fragments and merged:
                out.append(ReferenceFragment("".join(merged), contig, 1))
            name_parts = line[1:].split()
            if not name_parts:
                raise FastaError("empty contig name in FASTA header")
            contig = name_parts[0].decode()
            position = 1
            merged = []
            continue
        if contig is None:
            raise FastaError("sequence data before any '>' header")
        seq = line.decode()
        if line_fragments:
            out.append(ReferenceFragment(seq, contig, position))
        else:
            merged.append(seq)
        position += len(seq)
    if contig is not None and not line_fragments and merged:
        out.append(ReferenceFragment("".join(merged), contig, 1))
    return out


def find_sequence_start(buf: bytes, offset: int = 0) -> Optional[int]:
    """Offset of the next ``>`` header-line start at or after ``offset`` —
    the split-snapping rule of hb/FastaInputFormat.getSplits."""
    if offset == 0 and buf[:1] == b">":
        return 0
    pos = max(offset - 1, 0)
    while True:
        hit = buf.find(b"\n>", pos)
        if hit < 0:
            return None
        if hit + 1 >= offset:
            return hit + 1
        pos = hit + 1
