"""BCF split guesser (copy of hadoop_bam_tpu/split/bcf_guesser.py, the
rebuild of hb/BCFSplitGuesser.java): the next BCF2 record boundary at or
after a file offset, as a virtual offset.  BGZF BCF: candidates are
block starts x in-block offsets, as for BAM; raw BCF: plain byte
offsets (virtual offset ``offset << 16``).  A candidate is accepted when
a chain of MIN_CHAIN records validates (sane lengths, CHROM in the
contig dictionary, POS >= -1, rlen >= 0:
``formats/bcf.plausible_record_start``), or the window or file ends on
a record boundary.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bcf import plausible_record_start
from hadoop_bam_torch.formats.vcf import VCFHeader
from hadoop_bam_torch.formats.virtual_offset import make_voffset
from hadoop_bam_torch.split.bgzf_guesser import BGZFSplitGuesser
from hadoop_bam_torch.utils.seekable import as_byte_source

MIN_CHAIN = 3
INSPECT_BLOCKS = 4
RAW_WINDOW = 1 << 20  # inspection window for uncompressed BCF


class BCFSplitGuesser:

    def __init__(self, source, header: VCFHeader, *, is_bgzf: bool = True):
        self._src = as_byte_source(source)
        self._header = header
        self._n_contigs = max(header.n_contigs, 1)
        self._is_bgzf = is_bgzf
        self._bgzf = BGZFSplitGuesser(self._src) if is_bgzf else None

    def guess_next_record_start(self, offset: int) -> Optional[int]:
        """Smallest confirmed record-start virtual offset at or after byte
        ``offset``; None if none found before EOF."""
        if self._is_bgzf:
            return self._guess_bgzf(offset)
        return self._guess_raw(offset)

    # -- BGZF container ------------------------------------------------------
    def _guess_bgzf(self, offset: int) -> Optional[int]:
        coffset = offset
        while True:
            coffset = self._bgzf.guess_next_block_start(coffset)
            if coffset is None:
                return None
            raw = self._src.pread(coffset, INSPECT_BLOCKS * bgzf.MAX_BLOCK_SIZE)
            blocks, data, first_len = self._inflate_chain(raw)
            if first_len > 0:
                at_eof = (coffset + sum(b.block_size for b in blocks)
                          >= self._src.size)
                u = self._find_record(data, first_len, partial=at_eof)
                if u is not None:
                    return make_voffset(coffset, u)
            if not blocks:
                return None
            coffset += blocks[0].block_size
            if coffset >= self._src.size:
                return None

    def _inflate_chain(self, raw: bytes):
        blocks, chunks = [], []
        off = 0
        while off < len(raw) and len(blocks) < INSPECT_BLOCKS:
            try:
                info = bgzf.parse_block_header(raw, off)
                chunks.append(bgzf.inflate_block(raw, info, check_crc=False))
            except bgzf.BGZFError:
                break
            blocks.append(info)
            off = info.next_coffset
        if not blocks:
            return [], b"", -1
        return blocks, b"".join(chunks), len(chunks[0])

    # -- raw container -------------------------------------------------------
    def _guess_raw(self, offset: int) -> Optional[int]:
        size = self._src.size
        while offset < size:
            data = self._src.pread(offset, RAW_WINDOW)
            at_eof = offset + len(data) >= size
            u = self._find_record(data, len(data), partial=at_eof)
            if u is not None:
                return make_voffset(offset + u, 0)
            if at_eof:
                return None
            # overlap windows so a boundary record isn't missed
            offset += RAW_WINDOW - 64
        return None

    # -- shared chain validation ---------------------------------------------
    def _find_record(self, data: bytes, first_len: int,
                     partial: bool) -> Optional[int]:
        for u in self._plausible_offsets(data, first_len):
            if self._chain_ok(data, int(u), partial):
                return int(u)
        return None

    def _plausible_offsets(self, data: bytes, first_len: int) -> np.ndarray:
        """Vectorized plausibility over every candidate offset in the first
        block (the design shift vs the reference's per-offset decode loop)."""
        b = np.frombuffer(data, dtype=np.uint8)
        n = b.size
        hi = min(first_len, n - 32)
        if hi <= 0:
            return np.empty(0, dtype=np.int64)
        offs = np.arange(hi, dtype=np.int64)

        def u32(shift):
            return (b[offs + shift].astype(np.int64)
                    | (b[offs + shift + 1].astype(np.int64) << 8)
                    | (b[offs + shift + 2].astype(np.int64) << 16)
                    | (b[offs + shift + 3].astype(np.int64) << 24))

        def i32(shift):
            return u32(shift).astype(np.uint32).astype(np.int32).astype(np.int64)

        l_shared = u32(0)
        l_indiv = u32(4)
        chrom = i32(8)
        pos0 = i32(12)
        rlen = i32(16)
        mask = (
            (l_shared >= 24) & (l_shared < (1 << 24))
            & (l_indiv < (1 << 24))
            & (chrom >= 0) & (chrom < self._n_contigs)
            & (pos0 >= -1) & (rlen >= 0)
        )
        return offs[mask]

    def _chain_ok(self, data: bytes, u: int, partial: bool) -> bool:
        """``partial`` means the window reaches EOF: then the chain must end
        exactly at the window end (a valid file ends on a record boundary),
        which kills false positives whose fake record runs past the tail."""
        n = len(data)
        count = 0
        p = u
        while count < MIN_CHAIN:
            if p == n:
                return count >= 1 or partial
            if p + 32 > n:
                return False if partial else count >= 1
            if not plausible_record_start(data, p, self._n_contigs):
                return False
            l_shared, l_indiv = struct.unpack_from("<II", data, p)
            nxt = p + 8 + l_shared + l_indiv
            if nxt > n:
                return False if partial else count >= 1
            p = nxt
            count += 1
        return True
