"""BAM split guesser (copy of hadoop_bam_tpu/split/bam_guesser.py): the next
BAM record boundary at or after an arbitrary file offset, as a virtual
offset.

Starting at a byte offset it locates the next confirmed BGZF block
(BGZFSplitGuesser); within that block's inflated payload every in-block
offset is tested as a record start in one vectorized NumPy pass (fields
plausible against the header's reference dictionary), and the survivors
get a serial chain walk of MIN_CHAIN records.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bam import (
    CORE_AFTER_BLOCKSIZE, FIXED_RECORD_PREFIX, SAMHeader,
)
from hadoop_bam_torch.formats.virtual_offset import make_voffset
from hadoop_bam_torch.split.bgzf_guesser import BGZFSplitGuesser
from hadoop_bam_torch.utils.seekable import as_byte_source

# Plausibility bounds (reference uses similar order-of-magnitude caps; exact
# upstream constants unverifiable — SURVEY.md section 0).
MAX_PLAUSIBLE_BLOCK_SIZE = 1 << 26   # 64 MiB single record cap
MAX_PLAUSIBLE_SEQ_LEN = 1 << 26
MIN_CHAIN = 3                        # consecutive records required to accept
INSPECT_BLOCKS = 4                   # inflated blocks examined per candidate


class BAMSplitGuesser:

    def __init__(self, source, header: SAMHeader):
        self._src = as_byte_source(source)
        self._header = header
        self._bgzf = BGZFSplitGuesser(self._src)
        self._n_ref = header.n_ref
        self._ref_lengths = np.asarray(header.ref_lengths or [0], dtype=np.int64)

    def guess_next_record_start(self, offset: int) -> Optional[int]:
        """Smallest confirmed record-start virtual offset at or after byte
        ``offset``; None if no record is found before EOF."""
        coffset = offset
        confirmed: dict = {}
        while True:
            coffset = self._bgzf.guess_next_block_start(coffset, confirmed)
            if coffset is None:
                return None
            # Inflate an inspection window: the candidate block + a few more
            # (the ones the block confirmation inflated are reused).
            raw = self._src.pread(coffset, INSPECT_BLOCKS * bgzf.MAX_BLOCK_SIZE)
            blocks, data, first_len = self._inflate_chain(raw, coffset,
                                                          confirmed)
            if first_len > 0:
                u = self._find_record_in_block(data, first_len,
                                               partial=len(blocks) < INSPECT_BLOCKS
                                               and coffset + sum(b.block_size for b in blocks) >= self._src.size)
                if u is not None:
                    return make_voffset(coffset, u)
            elif first_len == 0 and blocks:
                # empty block (EOF terminator); step over it
                coffset += blocks[0].block_size
                if coffset >= self._src.size:
                    return None
                continue
            # No record starts in this block: try the next block start.
            if not blocks:
                return None
            coffset += blocks[0].block_size
            if coffset >= self._src.size:
                return None

    def _inflate_chain(self, raw: bytes, coffset: int, inflated: dict):
        blocks, chunks = [], []
        off = 0
        while off < len(raw) and len(blocks) < INSPECT_BLOCKS:
            try:
                info = bgzf.parse_block_header(raw, off)
                done = inflated.get(coffset + off)
                chunks.append(done if done is not None else
                              bgzf.inflate_block(raw, info, check_crc=False))
            except bgzf.BGZFError:
                break
            blocks.append(info)
            off = info.next_coffset
        if not blocks:
            return [], b"", -1
        return blocks, b"".join(chunks), len(chunks[0])

    def _find_record_in_block(self, data: bytes, first_len: int,
                              partial: bool) -> Optional[int]:
        """Vectorized plausibility over every offset in the first block, then
        serial chain confirmation of survivors.  ``partial``: the inspection
        window reaches EOF, so a chain may legitimately end early."""
        cand = self._plausible_offsets(data, first_len)
        for u in cand:
            if self._chain_ok(data, int(u), partial):
                return int(u)
        return None

    def _plausible_offsets(self, data: bytes, first_len: int) -> np.ndarray:
        b = np.frombuffer(data, dtype=np.uint8)
        n = b.size
        hi = min(first_len, n - FIXED_RECORD_PREFIX)
        if hi <= 0:
            return np.empty(0, dtype=np.int64)
        # block_size at every offset (contiguous slices, no gather); the
        # other fields are read only where it is plausible
        bs = (b[0:hi].astype(np.uint32)
              | (b[1:1 + hi].astype(np.uint32) << 8)
              | (b[2:2 + hi].astype(np.uint32) << 16)
              | (b[3:3 + hi].astype(np.uint32) << 24)).view(np.int32)
        offs = np.flatnonzero((bs >= CORE_AFTER_BLOCKSIZE + 2)  # "x\0"
                              & (bs <= MAX_PLAUSIBLE_BLOCK_SIZE))
        bs = bs[offs].astype(np.int64)

        def i32(shift):
            v = (b[offs + shift].astype(np.uint32)
                 | (b[offs + shift + 1].astype(np.uint32) << 8)
                 | (b[offs + shift + 2].astype(np.uint32) << 16)
                 | (b[offs + shift + 3].astype(np.uint32) << 24))
            return v.astype(np.int32).astype(np.int64)

        def u16(shift):
            return (b[offs + shift].astype(np.int64)
                    | (b[offs + shift + 1].astype(np.int64) << 8))

        refid = i32(4)
        pos = i32(8)
        l_read_name = b[offs + 12].astype(np.int64)
        n_cigar = u16(16)
        l_seq = i32(20)
        mate_refid = i32(24)
        mate_pos = i32(28)

        ref_len = np.where((refid >= 0) & (refid < self._n_ref),
                           self._ref_lengths[np.clip(refid, 0, self._n_ref - 1)],
                           np.int64(2 ** 31 - 1))
        mate_ref_len = np.where((mate_refid >= 0) & (mate_refid < self._n_ref),
                                self._ref_lengths[np.clip(mate_refid, 0, self._n_ref - 1)],
                                np.int64(2 ** 31 - 1))
        min_bs = (CORE_AFTER_BLOCKSIZE + l_read_name + 4 * n_cigar
                  + (l_seq + 1) // 2 + l_seq)
        mask = (
            (refid >= -1) & (refid < self._n_ref)
            & (pos >= -1) & (pos < ref_len)
            & (l_read_name >= 2) & (l_read_name <= 255)
            & (l_seq >= 0) & (l_seq <= MAX_PLAUSIBLE_SEQ_LEN)
            & (mate_refid >= -1) & (mate_refid < self._n_ref)
            & (mate_pos >= -1) & (mate_pos < mate_ref_len)
            & (bs >= min_bs)
        )
        # read name is NUL-terminated exactly at its end and NUL-free before
        name_end = offs + FIXED_RECORD_PREFIX + l_read_name - 1
        ok_end = name_end < n
        name_end_c = np.where(ok_end, name_end, 0)
        mask &= ok_end & (b[name_end_c] == 0)
        return offs[mask]

    def _chain_ok(self, data: bytes, u: int, partial: bool) -> bool:
        """Serially validate a chain of records starting at inflated offset u."""
        n = len(data)
        count = 0
        p = u
        while count < MIN_CHAIN:
            if p + FIXED_RECORD_PREFIX > n:
                # ran out of inspection window mid-prefix
                return count >= 1 if partial else count >= MIN_CHAIN or p == n
            if not self._record_ok(data, p, n):
                return False
            bs = int.from_bytes(data[p:p + 4], "little", signed=True)
            nxt = p + 4 + bs
            if nxt > n:
                # record extends past window: fields were plausible; in
                # partial (EOF) windows that's acceptable evidence
                return True if count >= 1 or partial else True
            p = nxt
            count += 1
            if p == n:
                return True
        return True

    def _record_ok(self, data: bytes, p: int, n: int) -> bool:
        bs = int.from_bytes(data[p:p + 4], "little", signed=True)
        if not (CORE_AFTER_BLOCKSIZE + 2 <= bs <= MAX_PLAUSIBLE_BLOCK_SIZE):
            return False
        refid = int.from_bytes(data[p + 4:p + 8], "little", signed=True)
        pos = int.from_bytes(data[p + 8:p + 12], "little", signed=True)
        l_read_name = data[p + 12]
        n_cigar = int.from_bytes(data[p + 16:p + 18], "little")
        l_seq = int.from_bytes(data[p + 20:p + 24], "little", signed=True)
        mate_refid = int.from_bytes(data[p + 24:p + 28], "little", signed=True)
        mate_pos = int.from_bytes(data[p + 28:p + 32], "little", signed=True)
        if not (-1 <= refid < self._n_ref) or not (-1 <= mate_refid < self._n_ref):
            return False
        if refid >= 0 and not (-1 <= pos < self._header.ref_lengths[refid]):
            return False
        if refid < 0 and pos != -1:
            return False
        if mate_refid >= 0 and not (-1 <= mate_pos < self._header.ref_lengths[mate_refid]):
            return False
        if not (2 <= l_read_name <= 255) or l_seq < 0:
            return False
        min_bs = (CORE_AFTER_BLOCKSIZE + l_read_name + 4 * n_cigar
                  + (l_seq + 1) // 2 + l_seq)
        if bs < min_bs:
            return False
        name_end = p + FIXED_RECORD_PREFIX + l_read_name
        if name_end <= n and data[name_end - 1] != 0:
            return False
        # CIGAR op codes <= 8 [SPEC]
        cig_off = p + FIXED_RECORD_PREFIX + l_read_name
        cig_end = min(cig_off + 4 * n_cigar, n)
        for q in range(cig_off, cig_end - 3, 4):
            v = int.from_bytes(data[q:q + 4], "little")
            if (v & 0xF) > 8:
                return False
        return True
