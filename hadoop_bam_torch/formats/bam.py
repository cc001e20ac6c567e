"""BAM binary layout (trimmed copy of hadoop_bam_tpu/formats/bam.py).

[SPEC] SAMv1 section 4.2.  A BAM file is a BGZF stream whose inflated
contents are the header (magic, text, reference dictionary) followed by
records; each record starts with a 36-byte fixed prefix::

    block_size i32 | refID i32 | pos i32 | l_read_name u8 | mapq u8 |
    bin u16 | n_cigar_op u16 | flag u16 | l_seq i32 | next_refID i32 |
    next_pos i32 | tlen i32

then read name, CIGAR, 4-bit packed bases, qualities and tags.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

BAM_MAGIC = b"BAM\x01"
FIXED_RECORD_PREFIX = 36  # bytes from block_size through tlen inclusive
CORE_AFTER_BLOCKSIZE = 32

SEQ_NIBBLE = "=ACMGRSVTWYHKDBN"          # [SPEC] 4-bit base codes

# Flag bits [SPEC] section 1.4
FPAIRED, FPROPER_PAIR, FUNMAP, FMUNMAP = 0x1, 0x2, 0x4, 0x8
FREVERSE, FMREVERSE, FREAD1, FREAD2 = 0x10, 0x20, 0x40, 0x80
FSECONDARY, FQCFAIL, FDUP, FSUPPLEMENTARY = 0x100, 0x200, 0x400, 0x800


class BAMError(ValueError):
    pass


@dataclass
class SAMHeader:
    """SAM/BAM header: raw @-line text plus the binary reference
    dictionary as parallel name/length lists."""

    text: str = ""
    ref_names: List[str] = field(default_factory=list)
    ref_lengths: List[int] = field(default_factory=list)

    @property
    def n_ref(self) -> int:
        return len(self.ref_names)

    def to_bam_bytes(self) -> bytes:
        out = bytearray()
        text = self.text.encode()
        out += BAM_MAGIC
        out += struct.pack("<i", len(text))
        out += text
        out += struct.pack("<i", self.n_ref)
        for name, length in zip(self.ref_names, self.ref_lengths):
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        return bytes(out)

    @classmethod
    def from_bam_bytes(cls, buf: bytes, offset: int = 0
                       ) -> Tuple["SAMHeader", int]:
        """Parse from inflated BAM bytes; returns (header, offset_after)."""
        if buf[offset:offset + 4] != BAM_MAGIC:
            raise BAMError("bad BAM magic")
        p = offset + 4
        (l_text,) = struct.unpack_from("<i", buf, p)
        p += 4
        text = bytes(buf[p:p + l_text]).rstrip(b"\x00").decode()
        p += l_text
        (n_ref,) = struct.unpack_from("<i", buf, p)
        p += 4
        names, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, p)
            p += 4
            names.append(bytes(buf[p:p + l_name - 1]).decode())
            p += l_name
            (l_ref,) = struct.unpack_from("<i", buf, p)
            p += 4
            lengths.append(l_ref)
        return cls(text=text, ref_names=names, ref_lengths=lengths), p

    @classmethod
    def from_sam_text(cls, text: str) -> "SAMHeader":
        names, lengths = [], []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                              if ":" in f)
                if "SN" in fields and "LN" in fields:
                    names.append(fields["SN"])
                    lengths.append(int(fields["LN"]))
        return cls(text=text if text.endswith("\n") or not text
                   else text + "\n", ref_names=names, ref_lengths=lengths)


def walk_record_offsets(buf, start: int = 0, end: Optional[int] = None
                        ) -> np.ndarray:
    """Serial record-boundary walk: offsets of each record's block_size
    field, stopping at the first record cut by the buffer end.  The
    portable walker of the zlib plane; the native plane walks in C++."""
    mv = memoryview(buf)
    n = len(mv) if end is None else end
    offs: List[int] = []
    p = start
    while p + 4 <= n:
        bs = int.from_bytes(mv[p:p + 4], "little", signed=True)
        if bs < CORE_AFTER_BLOCKSIZE:
            raise BAMError(f"bad block_size {bs} at offset {p}")
        if p + 4 + bs > n:
            break  # record truncated at span end (caller handles tail)
        offs.append(p)
        p += 4 + bs
    return np.asarray(offs, dtype=np.int64)
