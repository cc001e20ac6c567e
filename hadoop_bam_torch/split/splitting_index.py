"""Splitting indexes (copy of hadoop_bam_tpu/split/splitting_index.py).

A splitting index samples the virtual offset of every Nth record
(granularity) plus an end sentinel (file size << 16), so a planner snaps
a byte range to exact record starts with a binary search instead of
guessing them (hb/SplittingBAMIndex.java, hb/SplittingBAMIndexer.java).

Two on-disk flavours, both read transparently:

- ``.splitting-bai``: big-endian u64 virtual offsets, the last one the
  end sentinel;
- ``.sbi``: little-endian; magic "SBI\\x01", file_length u64, md5[16],
  uuid[16], total_records u64, granularity u64, n_offsets u64, then the
  offsets.

``build_splitting_index`` takes the record offsets from the port's host
span decode over the whole file (no per-record Python loop), and writes
the same bytes as the reference's record-by-record indexer.
"""
from __future__ import annotations

import bisect
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

SBI_MAGIC = b"SBI\x01"
SPLITTING_BAI_SUFFIX = ".splitting-bai"
SBI_SUFFIX = ".sbi"


@dataclass
class SplittingIndex:
    """Sorted virtual offsets of sampled records + the end sentinel."""

    voffsets: List[int]           # sorted, end sentinel last
    granularity: int = 0          # 0 = unknown (.splitting-bai)
    total_records: int = 0        # 0 = unknown

    @property
    def end_voffset(self) -> int:
        return self.voffsets[-1]

    def first_record_at_or_after(self, file_offset: int) -> int:
        """Smallest sampled voffset whose compressed offset is >=
        ``file_offset``; the end sentinel when there is none."""
        key = file_offset << 16
        i = bisect.bisect_left(self.voffsets, key)
        return self.voffsets[min(i, len(self.voffsets) - 1)]

    def span_bounds(self, byte_start: int, byte_end: int) -> Tuple[int, int]:
        """Snap a plain byte range to (start_voffset, end_voffset)."""
        return (self.first_record_at_or_after(byte_start),
                self.first_record_at_or_after(byte_end))

    def to_splitting_bai_bytes(self) -> bytes:
        return np.asarray(self.voffsets, dtype=">u8").tobytes()

    def to_sbi_bytes(self, file_length: int) -> bytes:
        head = SBI_MAGIC + struct.pack("<Q", file_length) + b"\x00" * 32
        head += struct.pack("<QQQ", self.total_records, self.granularity,
                            len(self.voffsets))
        return head + np.asarray(self.voffsets, dtype="<u8").tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SplittingIndex":
        if raw[:4] == SBI_MAGIC:
            total, gran, n = struct.unpack_from("<QQQ", raw, 44)
            offs = np.frombuffer(raw, dtype="<u8", count=n, offset=68)
            return cls(voffsets=[int(v) for v in offs],
                       granularity=int(gran), total_records=int(total))
        if len(raw) % 8:
            raise ValueError("malformed splitting index")
        offs = np.frombuffer(raw, dtype=">u8")
        return cls(voffsets=[int(v) for v in offs])

    @classmethod
    def load_for(cls, bam_path: str) -> Optional["SplittingIndex"]:
        """The sidecar next to ``bam_path``: ``.splitting-bai`` first,
        then ``.sbi`` (hb/BAMInputFormat.getSplits' order)."""
        for suffix in (SPLITTING_BAI_SUFFIX, SBI_SUFFIX):
            p = bam_path + suffix
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return cls.from_bytes(f.read())
        return None


def build_splitting_index(bam_path: str, granularity: int = 4096
                          ) -> SplittingIndex:
    """Every ``granularity``-th record's virtual offset (from record 0)
    plus the end sentinel, over one host decode of the whole file."""
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    parts = map_file_spans(bam_path, lambda data, offs, voffs: voffs)
    voffs = np.concatenate(parts) if parts else np.empty(0, np.uint64)
    size = os.path.getsize(bam_path)
    sampled = [int(v) for v in voffs[::granularity]]
    return SplittingIndex(voffsets=sampled + [size << 16],
                          granularity=granularity,
                          total_records=int(voffs.size))


def write_splitting_index(bam_path: str, granularity: int = 4096,
                          flavor: str = "splitting-bai") -> str:
    """Build and write a sidecar index; returns the sidecar's path."""
    idx = build_splitting_index(bam_path, granularity)
    if flavor == "sbi":
        out = bam_path + SBI_SUFFIX
        data = idx.to_sbi_bytes(os.path.getsize(bam_path))
    else:
        out = bam_path + SPLITTING_BAI_SUFFIX
        data = idx.to_splitting_bai_bytes()
    with open(out, "wb") as f:
        f.write(data)
    return out
