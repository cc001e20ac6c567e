"""Whole-file BCF reading, BGZF-wrapped or raw (copy of
hadoop_bam_tpu/formats/bcfio.py, reader half): the header and its
first-record virtual offset, and every record of a small file.  BCF
comes in two containers [SPEC]: BGZF-compressed (the default) and raw;
both start with the ``BCF\\2\\2`` magic in the inflated stream.
"""
from __future__ import annotations

from typing import List, Tuple

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bcf import BCFRecordCodec, decode_header
from hadoop_bam_torch.formats.vcf import VCFHeader, VcfRecord
from hadoop_bam_torch.formats.virtual_offset import make_voffset
from hadoop_bam_torch.utils.seekable import as_byte_source


def is_bgzf_bcf(head: bytes) -> bool:
    return bgzf.is_bgzf(head)


def read_bcf_header(source) -> Tuple[VCFHeader, int, bool]:
    """Read the header of a BCF file (either container).

    Returns (header, first-record virtual offset, is_bgzf) — the BCF
    equivalent of hb/util/VCFHeaderReader.java.  For raw streams the
    "virtual offset" is ``byte_offset << 16`` (uoffset always 0)."""
    src = as_byte_source(source)
    head = src.pread(0, bgzf.MAX_BLOCK_SIZE)
    if bgzf.is_bgzf(head):
        r = bgzf.BGZFReader(src)
        size = 1 << 16
        while True:
            r.seek_voffset(0)
            buf = r.read(size)
            try:
                header, after = decode_header(buf, 0)
                break
            except Exception:
                if len(buf) < size:
                    raise
                size *= 4
        # plain inflated offset -> virtual offset (walk the blocks)
        coff, remaining = 0, after
        while True:
            bh = src.pread(coff, bgzf.MAX_BLOCK_SIZE)
            info = bgzf.parse_block_header(bh, 0)
            if remaining < info.isize or (remaining == info.isize
                                          and info.isize > 0):
                if remaining == info.isize:
                    return header, make_voffset(coff + info.block_size, 0), True
                return header, make_voffset(coff, remaining), True
            remaining -= info.isize
            coff += info.block_size
    else:
        buf = head
        while True:
            try:
                header, after = decode_header(buf, 0)
                return header, after << 16, False
            except Exception:
                more = src.pread(len(buf), 1 << 20)
                if not more:
                    raise
                buf += more


def read_bcf(source) -> Tuple[VCFHeader, List[VcfRecord]]:
    """Decode a whole BCF file into (header, records)."""
    src = as_byte_source(source)
    head = src.pread(0, bgzf.MAX_BLOCK_SIZE)
    if bgzf.is_bgzf(head):
        data = bgzf.BGZFReader(src).read_all_from(0)
    else:
        chunks = []
        off = 0
        while True:
            got = src.pread(off, 1 << 22)
            if not got:
                break
            chunks.append(got)
            off += len(got)
        data = b"".join(chunks)
    header, off = decode_header(data, 0)
    codec = BCFRecordCodec(header)
    records: List[VcfRecord] = []
    while off < len(data):
        rec, off = codec.decode(data, off)
        records.append(rec)
    return header, records
