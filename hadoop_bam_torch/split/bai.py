"""BAI and CSI genomic indexes: build, read and query, for interval
split trimming (trimmed copy of hadoop_bam_tpu/split/bai.py).

With ``bam_intervals`` set and a ``.bai`` (or ``.csi``) next to the BAM,
the planner reads only the index's chunks that can hold overlapping
records (hb/BAMInputFormat.java, 7.7+); the decoders still filter rows
exactly.

Format [SPEC SAMv1 section 5.2]: magic "BAI\\1"; per reference a binning
index (bins over 16 KiB..512 Mbp regions, each holding chunks of (begin,
end) virtual offsets) and a linear index of the smallest virtual offset
overlapping each 16 KiB window.  ``build_bai`` takes refid, pos,
reference span and voffsets from the port's host span decode and builds
the index in ``bai_from_columns`` (vectorized), as the write path's
indexing sink does.  ``BAIBuilder`` takes one record at a time; it and
``split/tabix.TabixBuilder`` share ``IncrementalBinningCore``, the
chunk and linear-index rules both families write.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

BAI_MAGIC = b"BAI\x01"
BAI_SUFFIX = ".bai"
CSI_MAGIC = b"CSI\x01"
CSI_SUFFIX = ".csi"
_LINEAR_SHIFT = 14          # 16 KiB windows
_METADATA_BIN = 37450       # pseudo-bin some writers emit; skipped on read


def reg2bin(beg: int, end: int) -> int:
    """Bin of a 0-based half-open region [SPEC section 5.3]."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """Every bin that may hold records overlapping [beg, end) [SPEC]."""
    end -= 1
    out = [0]
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        out.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return out


def _merge(chunks: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, overlapping or touching (begin, end) ranges merged."""
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    for cbeg, cend in chunks:
        if merged and cbeg <= merged[-1][1]:
            if cend > merged[-1][1]:
                merged[-1] = (merged[-1][0], cend)
        else:
            merged.append((cbeg, cend))
    return merged


@dataclass
class RefIndex:
    bins: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)
    linear: List[int] = field(default_factory=list)  # voffsets, 0 = unset


@dataclass
class BaiIndex:
    refs: List[RefIndex]

    def to_bytes(self) -> bytes:
        out = [BAI_MAGIC, struct.pack("<i", len(self.refs))]
        for ref in self.refs:
            out.append(struct.pack("<i", len(ref.bins)))
            for bin_no in sorted(ref.bins):
                chunks = ref.bins[bin_no]
                out.append(struct.pack("<Ii", bin_no, len(chunks)))
                for beg, end in chunks:
                    out.append(struct.pack("<QQ", beg, end))
            out.append(struct.pack("<i", len(ref.linear)))
            out.append(np.asarray(ref.linear, dtype="<u8").tobytes())
        return b"".join(out)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BaiIndex":
        if raw[:4] != BAI_MAGIC:
            raise ValueError("not a BAI index (bad magic)")
        off = 4
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
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
        return cls(refs=refs)

    def query(self, rid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        """Merged (start, end) virtual-offset ranges that can hold records
        overlapping the 0-based half-open region [beg, end)."""
        if rid < 0 or rid >= len(self.refs):
            return []
        ref = self.refs[rid]
        win = beg >> _LINEAR_SHIFT
        min_off = ref.linear[win] if win < len(ref.linear) else 0
        chunks: List[Tuple[int, int]] = []
        for bin_no in reg2bins(beg, end):
            for cbeg, cend in ref.bins.get(bin_no, ()):
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        return _merge(chunks)


def csi_reg2bins(beg: int, end: int, min_shift: int, depth: int
                 ) -> List[int]:
    """Bins that may overlap [beg, end) in a CSI index of this geometry
    [SPEC CSIv1]: reg2bins generalised."""
    out: List[int] = []
    end -= 1
    s = min_shift + depth * 3
    t = 0
    for level in range(depth + 1):
        out.extend(range(t + (beg >> s), t + (end >> s) + 1))
        s -= 3
        t += 1 << (level * 3)
    return out


@dataclass
class CsiIndex:
    """CSI (.csi): BAI with a configurable bin geometry, stored
    BGZF-compressed; a per-bin ``loffset`` replaces the linear index."""
    min_shift: int
    depth: int
    refs: List[Dict[int, Tuple[int, List[Tuple[int, int]]]]]
    # refs[rid]: bin -> (loffset, chunks)

    def to_bytes(self) -> bytes:
        from hadoop_bam_torch.formats import bgzf
        body = [CSI_MAGIC,
                struct.pack("<iii", self.min_shift, self.depth, 0),
                struct.pack("<i", len(self.refs))]
        for bins in self.refs:
            body.append(struct.pack("<i", len(bins)))
            for bin_no in sorted(bins):
                loffset, chunks = bins[bin_no]
                body.append(struct.pack("<IQi", bin_no, loffset,
                                        len(chunks)))
                for beg, end in chunks:
                    body.append(struct.pack("<QQ", beg, end))
        return bgzf.compress_bytes(b"".join(body))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "CsiIndex":
        from hadoop_bam_torch.formats import bgzf
        if raw[:2] == b"\x1f\x8b":
            raw = bgzf.decompress_bytes(raw)
        if raw[:4] != CSI_MAGIC:
            raise ValueError("not a CSI index (bad magic)")
        min_shift, depth, l_aux = struct.unpack_from("<iii", raw, 4)
        off = 16 + l_aux
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bins: Dict[int, Tuple[int, List[Tuple[int, int]]]] = {}
            for _ in range(n_bin):
                bin_no, loffset, n_chunk = struct.unpack_from("<IQi", raw,
                                                              off)
                off += 16
                chunks = [struct.unpack_from("<QQ", raw, off + 16 * k)
                          for k in range(n_chunk)]
                off += 16 * n_chunk
                if bin_no != _METADATA_BIN:
                    bins[bin_no] = (loffset, chunks)
            refs.append(bins)
        return cls(min_shift=min_shift, depth=depth, refs=refs)

    def _min_offset(self, bins, beg: int) -> int:
        """Smallest virtual offset that can hold records overlapping
        positions >= ``beg``: the loffset of the nearest present bin at
        or before ``beg``, walking previous sibling then parent from the
        leaf bin."""
        bin_no = ((1 << (3 * self.depth)) - 1) // 7 + \
            (beg >> self.min_shift)
        while bin_no:
            entry = bins.get(bin_no)
            if entry is not None:
                return entry[0]
            first_sibling = (((bin_no - 1) >> 3) << 3) + 1
            bin_no = bin_no - 1 if bin_no > first_sibling \
                else (bin_no - 1) >> 3
        entry = bins.get(0)
        return entry[0] if entry is not None else 0

    def query(self, rid: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if rid < 0 or rid >= len(self.refs):
            return []
        bins = self.refs[rid]
        min_off = self._min_offset(bins, beg)
        chunks: List[Tuple[int, int]] = []
        for bin_no in csi_reg2bins(beg, end, self.min_shift, self.depth):
            entry = bins.get(bin_no)
            if entry is None:
                continue
            for cbeg, cend in entry[1]:
                if cend > min_off:
                    chunks.append((max(cbeg, min_off), cend))
        return _merge(chunks)

    @classmethod
    def from_bai(cls, bai: BaiIndex, min_shift: int = 14,
                 depth: int = 5) -> "CsiIndex":
        """A BAI re-expressed as CSI at the same 16 KiB / depth-5
        geometry (BAI bin numbers are CSI bins there).  Each bin's
        loffset is the BAI linear index of the bin's first window (0
        when unset: no pruning, the only safe value)."""
        refs = []
        for ref in bai.refs:
            bins: Dict[int, Tuple[int, List[Tuple[int, int]]]] = {}
            for bin_no, chunks in ref.bins.items():
                level = 0
                while level < depth and \
                        ((1 << (3 * (level + 1))) - 1) // 7 <= bin_no:
                    level += 1
                region_start = (bin_no - ((1 << (3 * level)) - 1) // 7) \
                    << (min_shift + 3 * (depth - level))
                win = region_start >> _LINEAR_SHIFT
                lin = ref.linear[win] if win < len(ref.linear) else 0
                bins[bin_no] = (lin, list(chunks))
            refs.append(bins)
        return cls(min_shift=min_shift, depth=depth, refs=refs)


class IncrementalBinningCore:
    """The chunk and linear-index rules of ``BAIBuilder`` and
    ``split/tabix.TabixBuilder`` (both use the 14/5 bins and 16 KiB
    windows).  Subclasses own ``self.refs`` and call ``_observe`` for
    each mapped record after resolving its reference id.

    A chunk's end is deferred: record i's chunk closes at record i+1's
    start voffset, or at ``finalize``'s end voffset for the last record,
    so every stored end lies on a block boundary or a record start."""

    refs: List[RefIndex]

    def __init__(self):
        self._pending: Optional[Tuple[int, int, int]] = None

    def _close(self, v1: int) -> None:
        if self._pending is None:
            return
        rid, b, v0 = self._pending
        self._pending = None
        chunks = self.refs[rid].bins.setdefault(b, [])
        if chunks and chunks[-1][1] >= v0:          # adjacent: extend
            chunks[-1] = (chunks[-1][0], v1)
        else:
            chunks.append((v0, v1))

    def _observe(self, rid: int, beg: int, end: int, voffset: int) -> None:
        """Open one mapped record's (deferred-end) chunk and fold it into
        the linear index."""
        ref = self.refs[rid]
        self._pending = (rid, reg2bin(beg, end), voffset)
        w0 = beg >> _LINEAR_SHIFT
        w1 = max(end - 1, beg) >> _LINEAR_SHIFT
        if len(ref.linear) <= w1:
            ref.linear.extend([0] * (w1 + 1 - len(ref.linear)))
        for w in range(w0, w1 + 1):
            if ref.linear[w] == 0 or voffset < ref.linear[w]:
                ref.linear[w] = voffset


class BAIBuilder(IncrementalBinningCore):
    """A BAI built one coordinate-sorted record at a time: ``add`` each,
    then ``finalize`` closes the trailing chunk.  ``bai_from_columns``
    writes the same bytes from whole columns."""

    def __init__(self, n_ref: int):
        super().__init__()
        self.refs = [RefIndex() for _ in range(n_ref)]

    def add(self, rid: int, beg: int, end: int, voffset: int) -> None:
        """One record: 0-based half-open [beg, end) on reference ``rid``
        (negative = unmapped: it only closes the previous chunk),
        starting at packed virtual offset ``voffset``."""
        self._close(voffset)
        if rid < 0:
            return
        self._observe(rid, beg, end, voffset)

    def finalize(self, end_voffset: int) -> BaiIndex:
        """Close the trailing chunk at ``end_voffset`` (the end of the
        data) and return the index."""
        self._close(end_voffset)
        return BaiIndex(refs=self.refs)


def _reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """``reg2bin`` over int64 columns."""
    e = end - 1
    return np.select(
        [beg >> 14 == e >> 14, beg >> 17 == e >> 17,
         beg >> 20 == e >> 20, beg >> 23 == e >> 23,
         beg >> 26 == e >> 26],
        [4681 + (beg >> 14), 585 + (beg >> 17), 73 + (beg >> 20),
         9 + (beg >> 23), 1 + (beg >> 26)],
        default=0)


def bai_from_columns(n_ref: int, refid: np.ndarray, beg: np.ndarray,
                     end: np.ndarray, voffsets: np.ndarray,
                     end_voffset: int) -> BaiIndex:
    """The BAI of file-ordered record columns: refid (negative =
    unmapped), 0-based half-open [beg, end) and start voffsets; the last
    record's chunk closes at ``end_voffset``.  The same bytes as feeding
    the rows one by one to the reference's ``BAIBuilder``: each record's
    chunk closes at the next record's start, a chunk extends over a run
    of consecutive mapped records sharing (rid, bin), and each 16 KiB
    window of the linear index keeps the smallest voffset touching it."""
    refid = np.asarray(refid, np.int64)
    beg = np.asarray(beg, np.int64)
    end = np.asarray(end, np.int64)
    voffs = np.asarray(voffsets, np.uint64)
    n = refid.size
    refs = [RefIndex() for _ in range(n_ref)]
    if not n:
        return BaiIndex(refs=refs)

    mapped = refid >= 0
    bins = _reg2bin_vec(beg, end)
    cend = np.empty(n, np.uint64)
    cend[:-1] = voffs[1:]
    cend[-1] = np.uint64(end_voffset)

    prev_mapped = np.zeros(n, bool)
    prev_mapped[1:] = mapped[:-1]
    same = np.zeros(n, bool)
    same[1:] = (refid[1:] == refid[:-1]) & (bins[1:] == bins[:-1])
    new_run = mapped & ~(same & prev_mapped)

    midx = np.flatnonzero(mapped)
    run_of = np.cumsum(new_run)[midx] - 1
    n_runs = int(run_of[-1]) + 1 if midx.size else 0
    run_ids = np.arange(n_runs)
    first = midx[np.searchsorted(run_of, run_ids, side="left")]
    last = midx[np.searchsorted(run_of, run_ids, side="right") - 1]
    for rid, b, v0, v1 in zip(refid[first].tolist(), bins[first].tolist(),
                              voffs[first].tolist(), cend[last].tolist()):
        refs[rid].bins.setdefault(b, []).append((v0, v1))

    unset = np.uint64(0xFFFFFFFFFFFFFFFF)
    for rid in np.unique(refid[mapped]):
        m = mapped & (refid == rid)
        w0 = beg[m] >> _LINEAR_SHIFT
        w1 = np.maximum(end[m] - 1, beg[m]) >> _LINEAR_SHIFT
        lin = np.full(int(w1.max()) + 1, unset, np.uint64)
        v = voffs[m]
        width = w1 - w0
        for k in range(int(width.max()) + 1):
            sel = width >= k
            np.minimum.at(lin, w0[sel] + k, v[sel])
        lin[lin == unset] = 0
        refs[int(rid)].linear = lin.tolist()
    return BaiIndex(refs=refs)


def build_bai(bam_path: str, header=None) -> BaiIndex:
    """The BAI of a coordinate-sorted BAM, from one host decode of the
    whole file: each span's refid, pos, reference span (at least 1) and
    record voffsets, then ``bai_from_columns``.  The last chunk closes at
    the end sentinel (file size << 16), as the reference's last planned
    span ends there."""
    from hadoop_bam_torch.formats.bam import BamBatch
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    if header is None:
        header, _ = read_bam_header(bam_path)

    def columns(data, offs, voffs):
        b = BamBatch(data, offs, header=header)
        pos = b.pos.astype(np.int64)
        return (b.refid.astype(np.int64), pos,
                pos + np.maximum(b.reference_span(), 1), voffs)

    parts = map_file_spans(bam_path, columns)
    cols = [np.concatenate([p[j] for p in parts]) if parts
            else np.empty(0, np.int64) for j in range(4)]
    return bai_from_columns(len(header.ref_names), cols[0], cols[1],
                            cols[2], cols[3],
                            os.path.getsize(bam_path) << 16)


def write_bai(bam_path: str, out_path: Optional[str] = None) -> str:
    out_path = out_path or bam_path + BAI_SUFFIX
    idx = build_bai(bam_path)
    with open(out_path, "wb") as f:
        f.write(idx.to_bytes())
    return out_path


def load_bai_for(bam_path: str):
    """The genomic index next to ``bam_path``: ``.bai`` first, then
    ``.csi`` (both answer the same query)."""
    p = bam_path + BAI_SUFFIX
    if os.path.exists(p):
        with open(p, "rb") as f:
            return BaiIndex.from_bytes(f.read())
    p = bam_path + CSI_SUFFIX
    if os.path.exists(p):
        with open(p, "rb") as f:
            return CsiIndex.from_bytes(f.read())
    return None


def plan_interval_spans(bam_path: str, intervals, header, bai=None):
    """Interval list -> the merged index chunks as FileVirtualSpans (the
    reference's split trimming), or None when no index is found.  The
    decoders still filter rows; this only bounds what is read."""
    from hadoop_bam_torch.split.spans import FileVirtualSpan
    bai = bai or load_bai_for(bam_path)
    if bai is None:
        return None
    rid_of = {n: i for i, n in enumerate(header.ref_names)}
    ranges: List[Tuple[int, int]] = []
    for iv in intervals:
        rid = rid_of.get(iv.rname)
        if rid is None:
            continue
        ranges.extend(bai.query(rid, max(iv.start - 1, 0), iv.end))
    return [FileVirtualSpan(bam_path, beg, end)
            for beg, end in _merge(ranges)]
