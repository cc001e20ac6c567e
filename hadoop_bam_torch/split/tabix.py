"""Tabix (.tbi) index: build, read and query, for region access into a
BGZF VCF or a BGZF BCF (copy of hadoop_bam_tpu/split/tabix.py).

The same 14/5 bins and 16 KiB linear index as a BAI, BGZF-compressed,
with the text-format block (sequence / begin / end columns, comment
character) and the contig names [hts-specs tabix].  ``build_tabix``
(text) and ``build_bcf_tabix`` (binary, keyed by CHROM, POS and the
record's reference length) write the reference's bytes; they walk the
inflated file a group of blocks at a time and map each record start to
the virtual offset the reference's byte-at-a-time reader reports there,
instead of reading one byte per call.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.split.bai import (
    IncrementalBinningCore, RefIndex, _LINEAR_SHIFT, _METADATA_BIN,
    reg2bins,
)

TBI_MAGIC = b"TBI\x01"
TBI_SUFFIX = ".tbi"
TBX_VCF = 2                      # preset: VCF (seq col 1, begin col 2)
_GROUP_BLOCKS = 1024             # blocks an index build inflates at a time


@dataclass
class TabixIndex:
    names: List[str]
    refs: List[RefIndex]
    fmt: int = TBX_VCF
    col_seq: int = 1
    col_beg: int = 2
    col_end: int = 0
    meta_char: int = ord("#")
    skip: int = 0

    def to_bytes(self) -> bytes:
        nm = b"".join(n.encode() + b"\x00" for n in self.names)
        out = [TBI_MAGIC,
               struct.pack("<8i", len(self.refs), self.fmt, self.col_seq,
                           self.col_beg, self.col_end, self.meta_char,
                           self.skip, len(nm)), nm]
        for ref in self.refs:
            out.append(struct.pack("<i", len(ref.bins)))
            for bin_no in sorted(ref.bins):
                chunks = ref.bins[bin_no]
                out.append(struct.pack("<Ii", bin_no, len(chunks)))
                for beg, end in chunks:
                    out.append(struct.pack("<QQ", beg, end))
            out.append(struct.pack("<i", len(ref.linear)))
            out.append(np.asarray(ref.linear, dtype="<u8").tobytes())
        from hadoop_bam_torch.formats import bgzf
        return bgzf.compress_bytes(b"".join(out))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "TabixIndex":
        from hadoop_bam_torch.formats import bgzf
        if raw[:2] == b"\x1f\x8b":
            raw = bgzf.decompress_bytes(raw)
        if raw[:4] != TBI_MAGIC:
            raise ValueError("not a tabix index (bad magic)")
        (n_ref, fmt, col_seq, col_beg, col_end, meta, skip,
         l_nm) = struct.unpack_from("<8i", raw, 4)
        off = 36
        names = [n.decode() for n in raw[off:off + l_nm].split(b"\x00")
                 if n]
        off += l_nm
        refs: List[RefIndex] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bins: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_no, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = [struct.unpack_from("<QQ", raw, off + 16 * k)
                          for k in range(n_chunk)]
                off += 16 * n_chunk
                if bin_no != _METADATA_BIN:
                    bins[bin_no] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", raw, off))
            off += 8 * n_intv
            refs.append(RefIndex(bins=bins, linear=linear))
        return cls(names=names, refs=refs, fmt=fmt, col_seq=col_seq,
                   col_beg=col_beg, col_end=col_end, meta_char=meta,
                   skip=skip)

    def query(self, rname: str, beg: int, end: int
              ) -> List[Tuple[int, int]]:
        """Merged (start, end) virtual-offset ranges for the 0-based
        half-open region [beg, end) on ``rname``."""
        try:
            rid = self.names.index(rname)
        except ValueError:
            return []
        ref = self.refs[rid]
        win = beg >> _LINEAR_SHIFT
        min_off = ref.linear[win] if win < len(ref.linear) else 0
        chunks: List[Tuple[int, int]] = []
        for bin_no in reg2bins(beg, end):
            for cbeg, cend in ref.bins.get(bin_no, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                if cend > merged[-1][1]:
                    merged[-1] = (merged[-1][0], cend)
            else:
                merged.append((cbeg, cend))
        return merged


class TabixBuilder(IncrementalBinningCore):
    """A tabix index built one coordinate-sorted record at a time (the
    text / BCF sibling of ``split/bai.BAIBuilder``): ``add`` each record,
    ``finalize`` closes the trailing chunk.  It adds contig-name
    interning and the format block to the shared binning rules."""

    def __init__(self, fmt: int = TBX_VCF, col_seq: int = 1,
                 col_beg: int = 2, col_end: int = 0,
                 meta_char: int = ord("#"), skip: int = 0):
        super().__init__()
        self.names: List[str] = []
        self.refs: List[RefIndex] = []
        self._rid_of: Dict[str, int] = {}
        self._fmt_args = dict(fmt=fmt, col_seq=col_seq, col_beg=col_beg,
                              col_end=col_end, meta_char=meta_char,
                              skip=skip)

    def add(self, rname: str, beg0: int, end0: int, voffset: int) -> None:
        """One record: 0-based half-open [beg0, end0) on contig ``rname``,
        starting at packed virtual offset ``voffset``."""
        self._close(voffset)
        rid = self._rid_of.get(rname)
        if rid is None:
            rid = self._rid_of[rname] = len(self.names)
            self.names.append(rname)
            self.refs.append(RefIndex())
        self._observe(rid, beg0, end0, voffset)

    def finalize(self, end_voffset: int) -> TabixIndex:
        self._close(end_voffset)
        return TabixIndex(names=self.names, refs=self.refs,
                          **self._fmt_args)


class _InflatedFile:
    """A BGZF file's block table with each block's place in the inflated
    stream, inflated a group of blocks at a time.

    ``voffsets(p)`` maps inflated positions to the virtual offset that a
    ``BGZFReader`` reading byte by byte reports just before position
    ``p``: inside the block holding byte p - 1, or, at that block's end,
    the start of the block after it."""

    def __init__(self, src):
        from hadoop_bam_torch.ops import inflate as inflate_ops
        self.size = src.size
        self.raw = src.pread(0, self.size)
        self.table = inflate_ops.block_table(self.raw)
        self.coff = self.table["coffset"]
        isize = self.table["isize"].astype(np.int64)
        bsize = np.empty_like(self.coff)
        bsize[:-1] = self.coff[1:] - self.coff[:-1]
        if bsize.size:
            bsize[-1] = self.size - self.coff[-1]
        self.next_coff = self.coff + bsize
        self.ustart = np.zeros(isize.size, np.int64)
        np.cumsum(isize[:-1], out=self.ustart[1:])
        self.uend = self.ustart + isize
        self.total = int(self.uend[-1]) if isize.size else 0

    def position(self, voffset: int) -> int:
        """The inflated position of a virtual offset."""
        coff, u = voffset >> 16, voffset & 0xFFFF
        i = int(np.searchsorted(self.coff, coff))
        if i >= self.coff.size:
            return self.total
        return int(self.ustart[i]) + u

    def voffsets(self, p) -> np.ndarray:
        p = np.asarray(p, np.int64)
        b = np.searchsorted(self.uend, p - 1, side="right")
        b = np.minimum(b, self.uend.size - 1)
        inside = p < self.uend[b]
        return np.where(inside, (self.coff[b] << 16) | (p - self.ustart[b]),
                        self.next_coff[b] << 16).astype(np.uint64)

    def groups(self, start: int = 0) -> Iterator[Tuple[int, bytes]]:
        """(inflated position, bytes) of consecutive pieces of the
        inflated stream from ``start`` on."""
        from hadoop_bam_torch.ops import inflate as inflate_ops
        n = self.coff.size
        first = int(np.searchsorted(self.uend, start, side="right"))
        for g in range(first, n, _GROUP_BLOCKS):
            h = min(n, g + _GROUP_BLOCKS)
            lo = int(self.coff[g])
            hi = int(self.next_coff[h - 1])
            part = {k: v[g:h] for k, v in self.table.items()}
            part["coffset"] = part["coffset"] - lo
            part["cdata_off"] = part["cdata_off"] - lo
            data, _ = inflate_ops.inflate_span(self.raw[lo:hi], part)
            base = int(self.ustart[g])
            cut = max(0, start - base)
            yield base + cut, data[cut:].tobytes()


def _vcf_end1(parts: List[bytes], pos1: int) -> int:
    """The 1-based inclusive end of a VCF line: POS + len(REF) - 1,
    extended by INFO END= [VCF spec]."""
    ref_allele = parts[3] if len(parts) > 3 else b"N"
    end1 = pos1 + max(len(ref_allele), 1) - 1
    if len(parts) > 7 and b"END=" in parts[7]:
        for item in parts[7].split(b";"):
            if item.startswith(b"END="):
                try:
                    end1 = max(end1, int(item[4:]))
                except ValueError:
                    pass
                break
    return end1


def build_tabix(vcf_gz_path: str) -> TabixIndex:
    """The .tbi of a coordinate-sorted BGZF VCF.  A line's chunk starts
    at its first byte's virtual offset and closes at the next line's;
    the walk stops at the first empty line, as the reference's reader
    does."""
    from hadoop_bam_torch.utils.seekable import scoped_byte_source

    with scoped_byte_source(vcf_gz_path) as src:
        f = _InflatedFile(src)
    builder = TabixBuilder()
    starts: List[int] = []
    lines: List[bytes] = []
    end_pos = f.total
    carry, carry_at = b"", 0
    stop = False
    for _at, piece in f.groups():
        buf = carry + piece
        base = carry_at
        nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
        s = 0
        for e in nl.tolist():
            line = buf[s:e]
            if not line:
                end_pos = base + e + 1
                stop = True
                break
            if line[:1] != b"#":
                starts.append(base + s)
                lines.append(line)
            s = e + 1
        if stop:
            break
        carry, carry_at = buf[s:], base + s
    if not stop and carry:
        if carry[:1] != b"#":
            starts.append(carry_at)
            lines.append(carry)
    v0s = f.voffsets(np.asarray(starts, np.int64)).tolist()
    for v0, line in zip(v0s, lines):
        parts = line.split(b"\t", 8)
        pos1 = int(parts[1])
        builder.add(parts[0].decode(), pos1 - 1, _vcf_end1(parts, pos1),
                    v0)
    final_v = (f.size << 16) if not stop \
        else int(f.voffsets(np.asarray([end_pos]))[0])
    return builder.finalize(final_v)


def build_bcf_tabix(bcf_path: str) -> TabixIndex:
    """A tabix-shaped index over a coordinate-sorted BGZF BCF: the same
    bins, linear index and chunks, keyed by each record's CHROM, POS and
    reference length (END - POS + 1, else len(REF)) from the binary
    codec."""
    from hadoop_bam_torch.formats.bcf import BCFRecordCodec, shared_only
    from hadoop_bam_torch.formats.bcfio import read_bcf_header
    from hadoop_bam_torch.utils.errors import PlanError
    from hadoop_bam_torch.utils.seekable import scoped_byte_source

    with scoped_byte_source(bcf_path) as src:
        header, first_voffset, is_bgzf = read_bcf_header(src)
        if not is_bgzf:
            raise PlanError(
                f"{bcf_path} is a raw (non-BGZF) BCF: virtual-offset "
                f"indexing needs the BGZF container")
        f = _InflatedFile(src)
    codec = BCFRecordCodec(header)
    builder = TabixBuilder()
    starts: List[int] = []
    keys: List[Tuple[str, int, int]] = []
    carry, carry_at = b"", f.position(first_voffset)
    for _at, piece in f.groups(carry_at):
        buf = carry + piece
        base = carry_at
        p, n = 0, len(buf)
        while p + 8 <= n:
            l_shared, l_indiv = struct.unpack_from("<II", buf, p)
            end = p + 8 + l_shared + l_indiv
            if end > n:
                break
            rec, _ = codec.decode(shared_only(buf[p:end]), 0)
            beg0 = rec.pos - 1
            starts.append(base + p)
            keys.append((rec.chrom, beg0, beg0 + max(rec.rlen, 1)))
            p = end
        carry, carry_at = buf[p:], base + p
    if len(carry) >= 8:
        # a record cut by the end of the file: the codec's own error
        codec.decode(carry, 0)
    v0s = f.voffsets(np.asarray(starts, np.int64)).tolist()
    for v0, (chrom, beg0, end0) in zip(v0s, keys):
        builder.add(chrom, beg0, end0, v0)
    return builder.finalize(f.size << 16)


def write_tabix(path: str, out_path: Optional[str] = None) -> str:
    """Write a .tbi sidecar for a BGZF VCF (text build) or a BGZF BCF
    (binary build)."""
    out_path = out_path or path + TBI_SUFFIX
    idx = (build_bcf_tabix(path) if path.lower().endswith(".bcf")
           else build_tabix(path))
    with open(out_path, "wb") as f:
        f.write(idx.to_bytes())
    return out_path


def load_tabix_for(path: str) -> Optional[TabixIndex]:
    p = path + TBI_SUFFIX
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return TabixIndex.from_bytes(f.read())
