"""BAM binary layout (trimmed copy of hadoop_bam_tpu/formats/bam.py).

[SPEC] SAMv1 section 4.2.  A BAM file is a BGZF stream whose inflated
contents are the header (magic, text, reference dictionary) followed by
records; each record starts with a 36-byte fixed prefix::

    block_size i32 | refID i32 | pos i32 | l_read_name u8 | mapq u8 |
    bin u16 | n_cigar_op u16 | flag u16 | l_seq i32 | next_refID i32 |
    next_pos i32 | tlen i32

then read name, CIGAR, 4-bit packed bases, qualities and tags.
``BamBatch`` is the columnar view the interval filter, the BAI build
and the planner read.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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


def _gather_le(data: np.ndarray, offs: np.ndarray, nbytes: int, signed: bool
               ) -> np.ndarray:
    """Vectorized little-endian integer gather at arbitrary byte offsets."""
    acc = np.zeros(offs.shape, dtype=np.uint64)
    for i in range(nbytes):
        acc |= data[offs + i].astype(np.uint64) << np.uint64(8 * i)
    if signed:
        bits = 8 * nbytes
        acc = acc.astype(np.int64)
        sign = np.int64(1) << np.int64(bits - 1)
        return (acc ^ sign) - sign if nbytes < 8 else acc
    return acc.astype(np.int64) if nbytes < 8 else acc


class BamBatch:
    """Structure-of-arrays view over the records of one inflated span: the
    part of the reference's ``BamBatch`` (formats/bam.py:219) that the
    interval filter, the BAI build and the planner's name groups read.
    Columns are gathered lazily from the bytes."""

    def __init__(self, data: np.ndarray, offsets: np.ndarray,
                 header: Optional[SAMHeader] = None,
                 voffsets: Optional[np.ndarray] = None):
        self.data = np.asarray(data, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.header = header
        self.voffsets = voffsets   # each record's start virtual offset
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return int(self.offsets.size)

    def _col(self, name: str, off: int, nbytes: int, signed: bool
             ) -> np.ndarray:
        if name not in self._cache:
            self._cache[name] = _gather_le(self.data, self.offsets + off,
                                           nbytes, signed)
        return self._cache[name]

    # fixed fields [SPEC layout offsets]
    @property
    def refid(self): return self._col("refid", 4, 4, True)
    @property
    def pos(self): return self._col("pos", 8, 4, True)
    @property
    def l_read_name(self): return self._col("l_read_name", 12, 1, False)
    @property
    def n_cigar(self): return self._col("n_cigar", 16, 2, False)
    @property
    def l_seq(self): return self._col("l_seq", 20, 4, True)

    def read_name(self, i: int) -> str:
        o = int(self.offsets[i]) + FIXED_RECORD_PREFIX
        return self.data[o:o + int(self.l_read_name[i]) - 1].tobytes(
        ).decode()

    @property
    def cigar_offset(self):
        return self.offsets + FIXED_RECORD_PREFIX + self.l_read_name

    def reference_span(self) -> np.ndarray:
        """Per-record alignment span on the reference (bases consumed by
        M/D/N/=/X CIGAR ops), vectorized over the ragged cigar arrays.
        Records with a '*' CIGAR fall back to l_seq (htsjdk's convention
        for computing an end when no cigar is present)."""
        if "ref_span" in self._cache:
            return self._cache["ref_span"]
        counts = self.n_cigar.astype(np.int64)
        total = int(counts.sum())
        span = np.where(self.l_seq > 0, self.l_seq, 0).astype(np.int64)
        if total:
            firsts = np.cumsum(counts) - counts
            flat = np.arange(total, dtype=np.int64) - np.repeat(firsts,
                                                                counts)
            offs = np.repeat(self.cigar_offset, counts) + 4 * flat
            vals = _gather_le(self.data, offs, 4, False)
            oplen = vals >> 4
            op = vals & 0xF
            consumes = (op == 0) | (op == 2) | (op == 3) | (op == 7) | \
                (op == 8)
            seg = np.repeat(np.arange(counts.size), counts)
            cig_span = np.zeros(counts.size, dtype=np.int64)
            np.add.at(cig_span, seg, (oplen * consumes).astype(np.int64))
            span = np.where(counts > 0, cig_span, span)
        self._cache["ref_span"] = span
        return span
