"""The units of distributable work (copy of hadoop_bam_tpu/split/spans.py):
``FileVirtualSpan``, a path plus [start, end) virtual offsets (BAM), and
``FileByteSpan``, a path plus a plain [start, end) byte range (FASTQ,
QSEQ, FASTA, text VCF).  Any host can decode any span on its own."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from hadoop_bam_torch.formats.virtual_offset import split_voffset


@dataclass(frozen=True)
class FileVirtualSpan:
    path: str
    start_voffset: int  # packed (coffset << 16 | uoffset), inclusive
    end_voffset: int    # exclusive
    locations: Tuple[str, ...] = ()

    @property
    def start(self) -> Tuple[int, int]:
        return split_voffset(self.start_voffset)

    @property
    def end(self) -> Tuple[int, int]:
        return split_voffset(self.end_voffset)

    @property
    def compressed_size(self) -> int:
        """Compressed bytes from the start block to the end block."""
        return max(0, self.end[0] - self.start[0])

    def to_dict(self) -> dict:
        return {"path": self.path, "start": int(self.start_voffset),
                "end": int(self.end_voffset),
                "locations": list(self.locations)}

    @classmethod
    def from_dict(cls, d: dict) -> "FileVirtualSpan":
        return cls(d["path"], int(d["start"]), int(d["end"]),
                   tuple(d.get("locations", ())))


@dataclass(frozen=True)
class FileByteSpan:
    """A plain byte-range split of a text file; the text readers align it
    to records at read time (split/read_planners.py)."""
    path: str
    start: int
    end: int
    locations: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {"path": self.path, "start": self.start, "end": self.end,
                "locations": list(self.locations)}

    @classmethod
    def from_dict(cls, d: dict) -> "FileByteSpan":
        return cls(d["path"], int(d["start"]), int(d["end"]),
                   tuple(d.get("locations", ())))
