"""Synthetic paired-end BAM from a seed, with its expected results.

Builds whole records with vectorized NumPy (fixed 277-byte records:
10-byte read names, one CIGAR op, 151 bases) in chunks, writes them with
``formats.bamio.BamWriter`` and keeps the numbers an oracle needs: the
16 flagstat counters and the seq-stats means and base histogram,
computed from the generating arrays (not by reading the file back).

The mix is WGS-like: ~41% GC with some N bases, Illumina-like qualities
from 2 to 41, and FLAGs that make every flagstat counter non-zero
(proper pairs, unmapped reads and mates, secondary, supplementary,
duplicate and QC-fail reads, mates on the other contig, MAPQ on both
sides of 5).
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from hadoop_bam_torch.formats.bam import (
    FDUP, FMREVERSE, FMUNMAP, FPAIRED, FPROPER_PAIR, FQCFAIL, FREAD1,
    FREAD2, FREVERSE, FSECONDARY, FSUPPLEMENTARY, FUNMAP, SAMHeader,
)
from hadoop_bam_torch.formats.bamio import BamWriter
from hadoop_bam_torch.ops.flagstat import FLAGSTAT_FIELDS

READ_LEN = 151
MAX_LEN = 160                      # PayloadGeometry().max_len
NAME_LEN = 10                      # "r%08d\0"
CONTIGS: Tuple[Tuple[str, int], ...] = (("chr20", 64444167),
                                        ("chr21", 46709983))
# base code [SPEC] -> probability: A, C, G, T, N
_CODES = np.array([1, 2, 4, 8, 15], np.uint8)
_CODE_P = np.array([0.2945, 0.2045, 0.2045, 0.2945, 0.002])

RECORD = np.dtype([
    ("block_size", "<i4"), ("refid", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
    ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
    ("mate_refid", "<i4"), ("mate_pos", "<i4"), ("tlen", "<i4"),
    ("name", "u1", (NAME_LEN,)), ("cigar", "<u4"),
    ("seq", "u1", ((READ_LEN + 1) // 2,)), ("qual", "u1", (READ_LEN,)),
])


@dataclasses.dataclass
class SynthTruth:
    """What the generator knows about the file it wrote; ``regions``
    holds the same numbers over the reads that overlap each region
    string asked for (``write_synthetic_bam(regions=...)``)."""
    n_reads: int
    flagstat: Dict[str, int]
    base_hist: np.ndarray          # int64 [16]
    mean_gc: float
    mean_qual: float
    regions: Dict[str, "SynthTruth"] = dataclasses.field(
        default_factory=dict)
    # with keep_columns: each read's reference and 0-based position, in
    # the file's order (every read is 151M: it covers [pos, pos + 151))
    refid: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None


class _Tally:
    """Running sums of the truth over the reads a row mask keeps."""

    def __init__(self):
        self.n = 0
        self.counters = dict.fromkeys(FLAGSTAT_FIELDS, 0)
        self.hist = np.zeros(16, np.int64)
        self.gc_sum = 0.0
        self.q_sum = 0.0

    def add(self, keep: np.ndarray, codes, qual, cols) -> None:
        use = min(READ_LEN, MAX_LEN)
        self.n += int(keep.sum())
        for key, v in flagstat_oracle(**{k: c[keep] for k, c in
                                         cols.items()}).items():
            self.counters[key] += v
        kept = codes[keep, :use]
        self.hist += np.bincount(kept.reshape(-1), minlength=16)
        gc = np.isin(kept, (2, 4, 6)).sum(1)
        qs = qual[keep, :use].astype(np.int64).sum(1)
        denom = np.float32(max(use, 1))
        self.gc_sum += float((gc.astype(np.float32) / denom)
                             .astype(np.float64).sum())
        self.q_sum += float((qs.astype(np.float32) / denom)
                            .astype(np.float64).sum())

    def truth(self) -> SynthTruth:
        n = max(self.n, 1)
        return SynthTruth(n_reads=self.n, flagstat=self.counters,
                          base_hist=self.hist, mean_gc=self.gc_sum / n,
                          mean_qual=self.q_sum / n)


def region_mask(region: str, refid: np.ndarray, pos: np.ndarray
                ) -> np.ndarray:
    """Reads of the generator's columns that overlap ``region`` (a
    comma-separated list of "name", "name:pos", "name:start-" or
    "name:start-end", 1-based inclusive, as in "chr20:1-100000,chr21"):
    every read is 151M, so its reference span is [pos + 1, pos + 151].
    Parsed and counted here, independent of the port's interval parser
    and of any decode; an unknown name raises ValueError."""
    names = [n for n, _ in CONTIGS]
    lengths = dict(CONTIGS)
    pos1 = pos.astype(np.int64) + 1
    end1 = pos1 + READ_LEN - 1
    keep = np.zeros(refid.shape, bool)
    for item in region.split(","):
        name, _, rng = item.strip().partition(":")
        if name not in lengths:
            raise ValueError(f"unknown contig {name!r} in {region!r}")
        lo, dash, hi = rng.partition("-")
        start = int(lo) if lo else 1
        end = int(hi) if hi else (lengths[name] if dash or not lo
                                  else start)
        keep |= (refid == names.index(name)) & (pos1 <= end) & \
            (end1 >= start)
    return keep


def header(sort_order: str = "unsorted") -> SAMHeader:
    text = f"@HD\tVN:1.6\tSO:{sort_order}\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in CONTIGS)
    return SAMHeader(text=text, ref_names=[n for n, _ in CONTIGS],
                     ref_lengths=[l for _, l in CONTIGS])


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """[SPEC] SAMv1 section 5.3 UCSC bin, vectorized."""
    end = end - 1
    out = np.zeros_like(beg)
    done = np.zeros(beg.shape, bool)
    for shift, first in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        m = ~done & ((beg >> shift) == (end >> shift))
        out[m] = first + (beg[m] >> shift)
        done |= m
    return out


def flagstat_oracle(flag: np.ndarray, refid: np.ndarray,
                    mate_refid: np.ndarray, mapq: np.ndarray
                    ) -> Dict[str, int]:
    """samtools flagstat counters over whole columns, in NumPy."""
    flag = flag.astype(np.int64)

    def has(bit):
        return (flag & bit) != 0

    primary = ~has(FSECONDARY) & ~has(FSUPPLEMENTARY)
    mapped = ~has(FUNMAP)
    paired = has(FPAIRED)
    mate_mapped = ~has(FMUNMAP)
    both = paired & mapped & mate_mapped
    diff = both & (mate_refid != refid) & (refid >= 0) & (mate_refid >= 0)
    masks = [np.ones(flag.shape, bool), primary, has(FSECONDARY),
             has(FSUPPLEMENTARY), has(FDUP), primary & has(FDUP), mapped,
             primary & mapped, paired, paired & has(FREAD1),
             paired & has(FREAD2), paired & has(FPROPER_PAIR) & mapped,
             both, paired & mapped & ~mate_mapped, diff, diff & (mapq >= 5)]
    return {k: int(m.sum()) for k, m in zip(FLAGSTAT_FIELDS, masks)}


def _chunk(rng: np.random.Generator, first_pair: int, n_pairs: int):
    """Records of pairs [first_pair, first_pair + n_pairs), mates adjacent."""
    n = 2 * n_pairs
    rec, cols = _chunk_fields(rng, first_pair, n_pairs)
    codes = _CODES[np.searchsorted(np.cumsum(_CODE_P),
                                   rng.random((n, READ_LEN)), side="right")
                   .clip(max=_CODES.size - 1)]
    cycle = np.arange(READ_LEN)[None, :]
    qual = np.rint(rng.normal(37.0 - 0.04 * cycle, 3.0, (n, READ_LEN)))
    low = rng.random((n, READ_LEN)) < 0.03
    qual = np.where(low, rng.integers(2, 13, (n, READ_LEN)), qual)
    qual = qual.clip(2, 41).astype(np.uint8)
    padded = np.concatenate([codes, np.zeros((n, 1), np.uint8)], 1) \
        if READ_LEN % 2 else codes
    rec["seq"] = (padded[:, 0::2] << 4) | padded[:, 1::2]
    rec["qual"] = qual
    return rec, codes, qual, cols


def _chunk_fields(rng: np.random.Generator, first_pair: int, n_pairs: int):
    """The fixed fields, names and 151M CIGARs of ``_chunk``'s records
    (placement, flags, MAPQ, mates) and its flagstat columns, drawn
    first from ``rng``; bases and qualities are left zero."""
    n = 2 * n_pairs
    lens = np.array([l for _, l in CONTIGS], np.int64)
    pair = first_pair + np.arange(n_pairs)
    contig = rng.integers(0, len(CONTIGS), n_pairs)
    pos1 = rng.integers(0, lens[contig] - 2000)
    insert = rng.integers(200, 600, n_pairs)
    other = rng.random(n_pairs) < 0.015            # mate on the other contig
    contig2 = np.where(other, 1 - contig, contig)
    pos2 = np.where(other, rng.integers(0, lens[contig2] - 2000),
                    pos1 + insert - READ_LEN)
    refid = np.stack([contig, contig2], 1).reshape(-1)
    pos = np.stack([pos1, pos2], 1).reshape(-1)
    unmapped = rng.random(n) < 0.02
    mate_unmapped = unmapped.reshape(-1, 2)[:, ::-1].reshape(-1)
    rev = np.repeat(rng.random(n_pairs) < 0.5, 2)
    first = np.tile([True, False], n_pairs)
    # an unmapped read sits at its mate's place; an unmapped pair nowhere
    mate_ref = refid.reshape(-1, 2)[:, ::-1].reshape(-1)
    mate_pos = pos.reshape(-1, 2)[:, ::-1].reshape(-1)
    refid = np.where(unmapped, np.where(mate_unmapped, -1, mate_ref), refid)
    pos = np.where(unmapped, np.where(mate_unmapped, -1, mate_pos), pos)
    mate_ref = refid.reshape(-1, 2)[:, ::-1].reshape(-1)
    mate_pos = pos.reshape(-1, 2)[:, ::-1].reshape(-1)
    proper = np.repeat(~other & (rng.random(n_pairs) < 0.95), 2) & \
        ~unmapped & ~mate_unmapped
    flag = (FPAIRED + np.where(first, FREAD1, FREAD2)
            + np.where(rev == first, FREVERSE, 0)
            + np.where(rev != first, FMREVERSE, 0)
            + np.where(unmapped, FUNMAP, 0)
            + np.where(mate_unmapped, FMUNMAP, 0)
            + np.where(proper, FPROPER_PAIR, 0))
    u = rng.random((4, n))
    flag = flag + np.where(~unmapped & (u[0] < 0.01), FSECONDARY, 0) \
        + np.where(~unmapped & (u[1] < 0.01), FSUPPLEMENTARY, 0) \
        + np.where(u[2] < 0.03, FDUP, 0) + np.where(u[3] < 0.005, FQCFAIL, 0)
    mapq = np.where(unmapped, 0, np.where(rng.random(n) < 0.08,
                                          rng.integers(0, 5, n),
                                          rng.integers(5, 61, n)))
    tlen = np.where(proper, np.where(first, 1, -1) * np.repeat(insert, 2), 0)

    rec = np.zeros(n, RECORD)
    rec["block_size"] = RECORD.itemsize - 4
    rec["refid"] = refid
    rec["pos"] = pos
    rec["l_read_name"] = NAME_LEN
    rec["mapq"] = mapq
    rec["bin"] = np.where(pos >= 0, _reg2bin(np.maximum(pos, 0),
                                             np.maximum(pos, 0) + READ_LEN),
                          4680)
    rec["n_cigar"] = 1
    rec["flag"] = flag
    rec["l_seq"] = READ_LEN
    rec["mate_refid"] = mate_ref
    rec["mate_pos"] = mate_pos
    rec["tlen"] = tlen
    digits = (np.repeat(pair, 2)[:, None]
              // 10 ** np.arange(7, -1, -1)[None, :]) % 10
    rec["name"][:, 0] = ord("r")
    rec["name"][:, 1:9] = 48 + digits
    rec["cigar"] = (READ_LEN << 4) | 0                 # 151M
    return rec, dict(flag=flag, refid=refid, mate_refid=mate_ref, mapq=mapq)


def write_synthetic_bam(path: str, n_reads: int, seed: int,
                        chunk_pairs: int = 1 << 16,
                        regions: Sequence[str] = (),
                        coordinate_sorted: bool = False,
                        fastq: Optional[str] = None,
                        keep_columns: bool = False) -> SynthTruth:
    """Write ``n_reads`` (even) paired reads to ``path``; return the
    truth, with seq-stats at the default payload geometry's max_len, and
    the truth over the reads overlapping each of ``regions``.  Mates are
    adjacent and pairs at random places; ``coordinate_sorted`` writes
    the same reads ordered by (contig, pos), unplaced reads last, as an
    indexed (``.bai``) BAM must be (held in memory: ~277 B a read).
    ``fastq`` also writes the reads, in the file's order, as the FASTQ
    of ``write_synthetic_reads`` (one generation for both files).
    ``keep_columns`` keeps each read's refid and pos in the truth, in
    the file's order (the query oracle's columns)."""
    if n_reads % 2:
        raise ValueError("n_reads must be even (reads come in pairs)")
    if fastq is not None and coordinate_sorted:
        raise ValueError("fastq= needs the unsorted order")
    rng = np.random.default_rng(seed)
    whole = _Tally()
    by_region = {r: _Tally() for r in regions}
    held, cols_kept = [], []
    order = "coordinate" if coordinate_sorted else "unsorted"
    with BamWriter(path, header(order)) as w, \
            (open(fastq, "wb") if fastq else contextlib.nullcontext()) as fq:
        for p0 in range(0, n_reads // 2, chunk_pairs):
            k = min(chunk_pairs, n_reads // 2 - p0)
            rec, codes, qual, cols = _chunk(rng, p0, k)
            if coordinate_sorted:
                held.append(rec)
            else:
                w.write_raw(rec.tobytes(), rec.size)
                if keep_columns:
                    cols_kept.append(rec[["refid", "pos"]].copy())
            if fq is not None:
                fq.write(_fastq_text(rec, codes, qual))
            whole.add(np.ones(rec.size, bool), codes, qual, cols)
            for r, tally in by_region.items():
                tally.add(region_mask(r, cols["refid"], rec["pos"]), codes,
                          qual, cols)
        if held:
            rec = np.concatenate(held)
            del held
            refid = rec["refid"].astype(np.int64)
            key = (np.where(refid < 0, len(CONTIGS), refid) << 32) + \
                rec["pos"].astype(np.int64) + 1
            rec = rec[np.argsort(key, kind="stable")]
            if keep_columns:
                cols_kept.append(rec[["refid", "pos"]].copy())
            step = 2 * chunk_pairs
            for i in range(0, rec.size, step):
                w.write_raw(rec[i:i + step].tobytes(), rec[i:i + step].size)
    truth = whole.truth()
    truth.regions = {r: t.truth() for r, t in by_region.items()}
    if keep_columns:
        kept = np.concatenate(cols_kept)
        truth.refid = kept["refid"].astype(np.int32)
        truth.pos = kept["pos"].astype(np.int64)
    return truth


_LETTERS = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)   # 4-bit code -> ASCII


def _fastq_text(rec: np.ndarray, codes: np.ndarray, qual: np.ndarray
                ) -> bytes:
    """FASTQ records of a chunk (fixed 317-byte records): ``@`` + the
    BAM read name, the stored bases, ``+``, Phred+33 qualities."""
    n = rec.size
    out = np.empty((n, NAME_LEN + 2 * READ_LEN + 5), np.uint8)
    out[:, 0] = ord("@")
    out[:, 1:NAME_LEN] = rec["name"][:, :NAME_LEN - 1]
    c = NAME_LEN
    out[:, c] = 10
    out[:, c + 1:c + 1 + READ_LEN] = _LETTERS[codes]
    c += 1 + READ_LEN
    out[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    out[:, c + 3:c + 3 + READ_LEN] = qual + 33
    out[:, -1] = 10
    return out.tobytes()


def _qseq_text(rec: np.ndarray, codes: np.ndarray, qual: np.ndarray,
               first_read: int) -> bytes:
    """QSEQ lines of a chunk: machine SYN, run 1, lane 1, tile 1101, x the
    read's 8-digit index, y 0, index 0, read 1 or 2 (the mate), bases
    with '.' for N, Illumina Phred+64 qualities, filter 1."""
    n = rec.size
    head = np.frombuffer(b"SYN\t1\t1\t1101\t", np.uint8)
    idx = first_read + np.arange(n)
    x = 48 + (idx[:, None] // 10 ** np.arange(7, -1, -1)[None, :]) % 10
    letters = _LETTERS[codes]
    letters[codes == 15] = ord(".")
    parts = [np.broadcast_to(head, (n, head.size)), x.astype(np.uint8),
             np.broadcast_to(np.frombuffer(b"\t0\t0\t", np.uint8), (n, 5)),
             (49 + idx % 2)[:, None].astype(np.uint8),
             np.full((n, 1), 9, np.uint8), letters,
             np.full((n, 1), 9, np.uint8), (qual + 64).astype(np.uint8),
             np.broadcast_to(np.frombuffer(b"\t1\n", np.uint8), (n, 3))]
    return np.concatenate(parts, axis=1).tobytes()


def write_synthetic_reads(path: str, n_reads: int, seed: int,
                          fmt: str = "fastq", limit: Optional[int] = None,
                          compress: bool = False,
                          chunk_pairs: int = 1 << 16) -> SynthTruth:
    """Write the reads of ``write_synthetic_bam(path, n_reads, seed)`` as
    FASTQ (``fmt="fastq"``) or QSEQ (``"qseq"``), the first ``limit`` of
    them when given, gzipped with ``compress``: the same records from the
    same seed, bases and qualities as the BAM stores them.  Returns the
    truth over the reads written (its seq-stats equal the BAM's when
    every read is written)."""
    import gzip
    if n_reads % 2:
        raise ValueError("n_reads must be even (reads come in pairs)")
    if fmt not in ("fastq", "qseq"):
        raise ValueError(f"unknown read format {fmt!r}")
    limit = n_reads if limit is None else min(limit, n_reads)
    rng = np.random.default_rng(seed)
    tally = _Tally()
    written = 0
    opener = (lambda: gzip.open(path, "wb", compresslevel=1)) if compress \
        else (lambda: open(path, "wb"))
    with opener() as f:
        for p0 in range(0, n_reads // 2, chunk_pairs):
            if written >= limit:
                break
            k = min(chunk_pairs, n_reads // 2 - p0)
            rec, codes, qual, cols = _chunk(rng, p0, k)
            take = min(rec.size, limit - written)
            rec, codes, qual = rec[:take], codes[:take], qual[:take]
            cols = {c: v[:take] for c, v in cols.items()}
            f.write(_fastq_text(rec, codes, qual) if fmt == "fastq"
                    else _qseq_text(rec, codes, qual, written))
            tally.add(np.ones(take, bool), codes, qual, cols)
            written += take
    return tally.truth()


# GRCh38's chr21 and chr22 lengths
FASTA_CONTIGS: Tuple[Tuple[str, int], ...] = (("chr21", 46709983),
                                              ("chr22", 50818468))


def write_synthetic_fasta(path: str, seed: int,
                          contigs: Sequence[Tuple[str, int]] = FASTA_CONTIGS,
                          width: int = 60,
                          chunk_lines: int = 1 << 16) -> Dict[str, int]:
    """A reference FASTA of random bases (about 41% GC, N at 0.2%) with
    ``contigs`` (name, length) in lines of ``width``; returns {name:
    length}."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for name, length in contigs:
            f.write(f">{name} synthetic\n".encode())
            for l0 in range(0, length, width * chunk_lines):
                m = min(width * chunk_lines, length - l0)
                pick = np.searchsorted(np.cumsum(_CODE_P), rng.random(m),
                                       side="right").clip(max=4)
                body = letters[pick]
                full = m // width
                lines = np.empty((full, width + 1), np.uint8)
                lines[:, :width] = body[:full * width].reshape(full, width)
                lines[:, width] = 10
                f.write(lines.tobytes())
                if m % width:
                    f.write(body[full * width:].tobytes() + b"\n")
    return dict(contigs)


def window_count(length: int, window: int, stride: int = 0) -> int:
    """Windows ``FastaDataset.window_tensor_batches`` cuts from a contig
    of ``length`` bases: one for a contig no longer than the window;
    else a start every ``stride`` up to ``length - window``, plus that
    last start when the stride misses it."""
    stride = stride or window
    if length <= 0:
        return 0
    if length <= window:
        return 1
    last = length - window
    return last // stride + 1 + (1 if last % stride else 0)


def flip_block(src: str, dst: str, near: int) -> int:
    """Write a copy of ``src`` to ``dst`` with 30 bytes of the DEFLATE
    data of one BGZF block XOR-ed with 0xFF: the data block (ISIZE > 0)
    whose compressed offset is nearest ``near``.  Returns that block's
    compressed offset."""
    from hadoop_bam_torch.ops.inflate import block_table
    with open(src, "rb") as f:
        raw = bytearray(f.read())
    table = block_table(bytes(raw))
    data = np.nonzero(table["isize"] > 0)[0]
    i = int(data[np.argmin(np.abs(table["coffset"][data] - near))])
    start = int(table["cdata_off"][i])
    for p in range(start + 10, start + 40):
        raw[p] ^= 0xFF
    with open(dst, "wb") as f:
        f.write(bytes(raw))
    return int(table["coffset"][i])


def record_flags(buf: np.ndarray, total: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(block_size as int64, complete) at every position of ``buf``, with
    the record walk's rules: the little-endian int32 at p (zeros past
    L), complete when p + 4 + bs <= total and 32 <= bs <= L."""
    L = buf.size
    b = np.concatenate([buf, np.zeros(3, np.uint8)]).astype(np.int64)
    bs = b[:L] | b[1:L + 1] << 8 | b[2:L + 2] << 16 | b[3:L + 3] << 24
    bs = np.where(bs >= 1 << 31, bs - (1 << 32), bs)
    pos = np.arange(L)
    return bs, (bs >= 32) & (bs <= L) & (pos + 4 + bs <= total)


def block_size_chain(L: int, sizes, at: int = 0, seed: int = 0,
                     zero_share: float = 0.6) -> Tuple[np.ndarray, int]:
    """An L-byte buffer holding a chain of records from ``at``, record i
    ``sizes[i]`` bytes long (its block_size ``sizes[i] - 4``), and the
    position where the chain's last record ends.  Body bytes are random,
    a ``zero_share`` of them zero, so that many positions off the chain
    also read as a plausible block_size, as in real BAM bytes."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    buf[rng.random(L) < zero_share] = 0
    p = at
    for s in sizes:
        buf[p:p + 4] = np.frombuffer(np.int32(s - 4).tobytes(), np.uint8)
        p += s
    return buf, p


def _fill_sizes(rng: np.random.Generator, room: int, lo: int = 36,
                hi: int = 400):
    """Random record sizes in [lo, hi) summing to at most ``room``."""
    out = []
    while room >= hi:
        out.append(int(rng.integers(lo, hi)))
        room -= out[-1]
    return out


def walk_cases(W: int, seed: int = 0):
    """Inputs for the record walk's edge rules at a tile of W positions
    (the tiled walk's unit of work; ``ops.inflate_device.walk_launch``):
    a list of (name, buf [8W] u8, total, start, stop, R).  Covers records
    longer than a tile, a term in a tile entered by such a jump, dense
    candidates at two phases of ``start``, a chain ending exactly at L,
    ``start`` off the chain, ``stop`` before ``start``, R = 0, records
    starting on tile boundaries, and ``total`` well below L (tiles past
    it hold no candidate), with ``start`` before it and in a tile past
    it."""
    L = 8 * W
    rng = np.random.default_rng(seed)
    cap = L // 36 + 16
    cases = []
    sizes = _fill_sizes(rng, L - 7)
    buf, end = block_size_chain(L, sizes, 7, seed)
    cases.append(("random chain", buf, end, 7, L, cap))
    sizes = [60, 3 * W + 17, 80] + _fill_sizes(rng, L - 3 * W - 170)
    buf, end = block_size_chain(L, sizes, 0, seed + 1)
    cases.append(("record longer than a tile", buf, end, 0, L, cap))
    buf, end = block_size_chain(L, [60, 2 * W + 40], 3, seed + 2)
    buf[end:end + 4] = np.frombuffer(np.int32(5).tobytes(), np.uint8)
    cases.append(("bad term after a long jump", buf, L, 3, L, cap))
    buf, end = block_size_chain(L, [60, 2 * W + 40, 100], 3, seed + 3)
    cases.append(("cut record after a long jump", buf, end - 10, 3, L,
                  cap))
    dense = np.tile(np.array([32, 0, 0, 0], np.uint8), L // 4)
    cases.append(("dense, start 0", dense, L, 0, L, cap))
    cases.append(("dense, start 20", dense, L, 20, L - 3 * W + 5, cap))
    sizes = _fill_sizes(rng, L - 11 - 36)
    sizes.append(L - 11 - sum(sizes))
    buf, end = block_size_chain(L, sizes, 11, seed + 4)
    cases.append(("chain ends at L", buf, L, 11, L, cap))
    sizes = _fill_sizes(rng, L)
    buf, end = block_size_chain(L, sizes, 0, seed + 5)
    complete = record_flags(buf, end)[1]
    off_chain = int(np.nonzero(~complete[W // 2:])[0][0]) + W // 2
    cases.append(("start off the chain", buf, end, off_chain, L, cap))
    nodes = np.cumsum([0] + sizes)
    mid = int(nodes[np.searchsorted(nodes, 2 * W)])
    cases.append(("stop before start", buf, end, mid, W, cap))
    cases.append(("R = 0", buf, end, 0, L, 0))
    sizes = [W - 100, 100, 2 * W, 36] + _fill_sizes(rng, L - 3 * W - 36)
    buf, end = block_size_chain(L, sizes, 0, seed + 6)
    cases.append(("records on tile boundaries", buf, end, 0, L, cap))
    buf, end = block_size_chain(L, [W, 36] + _fill_sizes(rng, L - 2 * W - 36),
                                W, seed + 7)
    cases.append(("start on a tile boundary", buf, end, W, L, cap))
    sizes = _fill_sizes(rng, L - 5)
    buf, end = block_size_chain(L, sizes, 5, seed + 8)
    cut = 2 * W + W // 3
    cases.append(("total well below L", buf, cut, 5, L, cap))
    cases.append(("start in a tile past total", buf, cut, 5 * W + 3, L,
                  cap))
    return cases


PAYLOAD_CASES = ("random", "window at byte 0", "window at byte L - 1",
                 "l_seq above max_len", "int32 wrap")


def _wrap32(a) -> np.ndarray:
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def payload_rows(name: str, L: int, R: int, seed: int = 0):
    """Inputs for the payload gather's edge rules (``PAYLOAD_CASES``): a
    tuple (buf [L] u8, offs, l_seq, l_read_name, n_cigar [R] int32) whose
    rows' seq_off = offs + 36 + l_read_name + 4 * n_cigar land where the
    case says: anywhere, from 20 bytes before byte 0 to 20 after it, or
    with the qual window ending from 20 bytes before L to 20 past it;
    l_seq from max_len + 1 to 2^31 - 1 (MAX_LEN: the default geometry's);
    offsets near 2^31 - 1 and 4 * n_cigar = 2^31, so that the int32 sums
    wrap.  "random" mixes negative and huge lengths with offsets off both
    ends."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    rn = rng.integers(0, 256, R).astype(np.int32)
    nc = rng.integers(0, 9, R).astype(np.int32)
    l_seq = rng.integers(0, MAX_LEN + 1, R).astype(np.int32)
    if name == "random":
        offs = rng.integers(-100, L + 100, R).astype(np.int32)
        l_seq = rng.integers(-5, 400, R).astype(np.int32)
        l_seq[:3] = [(1 << 31) - 1, 0, MAX_LEN + 1][:R]
        return buf, offs, l_seq, rn, nc
    if name == "int32 wrap":
        offs = (1 << 31) - 41 - rng.integers(0, 60, R)
        nc[:R // 2] = 1 << 29
        return buf, _wrap32(offs), l_seq, rn, nc
    if name == "window at byte 0":
        target = np.arange(R) % 41 - 20
    elif name == "window at byte L - 1":
        target = L - (l_seq + 1) // 2 - l_seq + np.arange(R) % 41 - 20
    elif name == "l_seq above max_len":
        l_seq = rng.integers(MAX_LEN + 1, 5000, R).astype(np.int32)
        l_seq[:2] = [(1 << 31) - 1, 1 << 30][:R]
        target = rng.integers(0, L // 2, R)
    else:
        raise ValueError(f"unknown payload case {name!r}")
    return buf, _wrap32(target - 36 - rn - 4 * nc), l_seq, rn, nc


# a record's bytes 4-23, the fields K10i reads [SPEC SAMv1 4.2]
_PREFIX_FIELDS = np.dtype([("refid", "<i4"), ("pos", "<i4"),
                           ("l_read_name", "u1"), ("mapq", "u1"),
                           ("bin", "<u2"), ("n_cigar", "<u2"),
                           ("flag", "<u2"), ("l_seq", "<i4")])


def interval_rows(L: int, R: int, seed: int = 0, cap: int = 64,
                  over: bool = False):
    """Inputs for the interval columns' rules (K10i): (buf [L] u8, offs
    [R] int32, {edge kind: row indices}).  Most rows are records whose
    bytes 4-23 (refid, pos, l_read_name, n_cigar, l_seq) are written into
    ``buf`` at their offsets, 24 bytes apart in a random order, every
    offset residue mod 4 in turn; their CIGAR words are the buffer's
    random bytes (all 16 ops, lengths whose int32 sum wraps); n_cigar 0
    to ``cap`` (0 and ``cap`` on rows of their own, ``cap + 1`` on one
    row with ``over``), l_seq -5 to 399, pos at the int32 edges on four
    rows.  At random rows sit the edge rows: a prefix cut by byte 0 or by
    byte L - 1, past either end, or wrapping int32 ("prefix"); and
    records whose CIGAR is cut by byte L - 1, or ends on it ("cigar").
    The reference clips every index of those to the buffer."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    slots = (L - 1024) // 24
    if slots < R:
        raise ValueError(f"interval_rows: L = {L} holds {slots} of {R} rows")
    offs = (24 * rng.choice(slots, R, replace=False)
            + np.arange(R) % 4).astype(np.int64)
    f = np.zeros(R, _PREFIX_FIELDS)
    f["refid"] = rng.integers(-1, 5, R)
    f["pos"] = rng.integers(-2 ** 31, 2 ** 31, R, dtype=np.int64)
    f["pos"][:4] = [(1 << 31) - 2, (1 << 31) - 1, -1, -2 ** 31][:R]
    f["l_read_name"] = rng.integers(0, 256, R)
    f["n_cigar"] = rng.integers(0, cap + 1, R)
    f["n_cigar"][4:8] = [0, cap, 0, cap][:max(0, R - 4)]
    f["l_seq"] = rng.integers(-5, 400, R)
    if over:
        f["n_cigar"][R // 2] = cap + 1
    # prefixes cut by byte 0 or by byte L - 1, past either end, or
    # wrapping int32
    cut = (-24, -13, -1, L - 23, L - 12, L - 1, L + 40, (1 << 31) - 20,
           (1 << 31) - 40)
    rows = rng.permutation(R)
    edges = {"prefix": rows[:len(cut)][:R // 2],
             "cigar": rows[len(cut):len(cut) + 4][
                 :max(0, R // 2 - len(cut))]}
    offs[edges["prefix"]] = cut[:len(edges["prefix"])]
    # CIGARs of n words ending 2 bytes before, on, 1 and 70 bytes past
    # L - 1, their prefixes 40 bytes apart inside the buffer
    for i, r in enumerate(edges["cigar"]):
        n = max(cap - 10 * i, 1)
        f["n_cigar"][r], f["l_read_name"][r] = n, 3 * i + 1
        offs[r] = L - 4 * min(n, cap) + (-2, 0, 1, 70)[i] - 37 - 3 * i
    raw = f.view(np.uint8).reshape(R, 20)
    for r in range(R):
        lo = int(offs[r]) + 4
        if 0 <= lo and lo + 20 <= L:
            buf[lo:lo + 20] = raw[r]
    return buf, _wrap32(offs), edges


def poison_allocator(dev) -> None:
    """Leave 0xAB in the torch caching allocator's free blocks on ``dev``
    (its large pool and its small one), so that a byte of a later
    ``torch.empty`` tensor that a kernel does not write reads 0xAB, not a
    zero left by an earlier tensor."""
    import torch
    held = [torch.full((256 << 20,), 0xAB, dtype=torch.uint8, device=dev)]
    held += [torch.full((1 << 19,), 0xAB, dtype=torch.uint8, device=dev)
             for _ in range(32)]
    del held


# ---------------------------------------------------------------------------
# Coverage BAM: coordinate-sorted reads with mixed CIGARs, and its pileup
# ---------------------------------------------------------------------------

# op codes [SPEC]: M I D N S H P = X
_M, _I, _D, _N, _S, _H, _EQ, _X = 0, 1, 2, 3, 4, 5, 7, 8
_REF_OPS = (_M, _D, _N, _EQ, _X)
_DEPTH_OPS = (_M, _EQ, _X)
_QUERY_OPS = (_M, _I, _S, _EQ, _X)
_OP_CHARS = "MIDNSHP=X"
_COV_PREFIX = 36 + NAME_LEN              # prefix and read name
_COV_SEQ = (READ_LEN + 1) // 2
_COV_HEAD = np.dtype(RECORD.descr[:13])   # RECORD up to the read name


@dataclasses.dataclass
class CoverageTruth:
    """The generator's own columns of ``write_coverage_bam``'s file, in
    file order: each read's reference, 0-based position and FLAG, and its
    CIGAR as a ragged list (``n_ops`` per read over ``op_len`` /
    ``op_code``; n_ops 0 is a '*' CIGAR)."""
    refid: np.ndarray              # int32 [n]
    pos: np.ndarray                # int64 [n]
    flag: np.ndarray               # int32 [n]
    n_ops: np.ndarray              # int32 [n]
    op_len: np.ndarray             # int64 [total ops]
    op_code: np.ndarray            # uint8 [total ops]

    @property
    def n_reads(self) -> int:
        return int(self.refid.size)

    @property
    def star_cigars(self) -> int:
        return int((self.n_ops == 0).sum())

    @property
    def unmapped(self) -> int:
        return int(((self.flag & FUNMAP) != 0).sum())

    @property
    def max_ops(self) -> int:
        return int(self.n_ops.max())

    def reads_over(self, k: int) -> int:
        return int((self.n_ops > k).sum())

    def on_ref(self, rid: int) -> int:
        return int((self.refid == rid).sum())

    def op_kinds(self) -> str:
        return "".join(_OP_CHARS[c] for c in np.unique(self.op_code))


def _cigar_table(rng: np.random.Generator, n: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """[n, 42] (length, code) tables of the CIGAR classes, one row a
    read, each consuming READ_LEN query bases (zero-length ops are
    dropped by the caller)."""
    L = READ_LEN
    k = 42
    ln = np.zeros((n, k), np.int64)
    code = np.zeros((n, k), np.uint8)
    ln[:, 0] = L                                      # 151M by default
    r = rng.random(n)

    def rows(lo, hi):
        return np.nonzero((r >= lo) & (r < hi))[0]

    def put(idx, parts):
        for j, (length, c) in enumerate(parts):
            ln[idx, j] = length
            code[idx, j] = c
        ln[idx, len(parts):] = 0

    idx = rows(0.850, 0.880)                          # soft clip, either end
    s = rng.integers(1, 40, idx.size)
    left = rng.random(idx.size) < 0.5
    put(idx, [(np.where(left, s, L - s), np.where(left, _S, _M)),
              (np.where(left, L - s, s), np.where(left, _M, _S))])
    idx = rows(0.880, 0.895)                          # hard clips
    h = rng.integers(1, 60, idx.size)
    put(idx, [(h, _H), (np.full(idx.size, L), _M), (h[::-1], _H)])
    idx = rows(0.895, 0.925)                          # 1-10 bp insertion
    i = rng.integers(1, 11, idx.size)
    a = rng.integers(10, L - 20, idx.size)
    put(idx, [(a, _M), (i, _I), (L - a - i, _M)])
    idx = rows(0.925, 0.955)                          # 1-10 bp deletion
    d = rng.integers(1, 11, idx.size)
    a = rng.integers(10, L - 10, idx.size)
    put(idx, [(a, _M), (d, _D), (L - a, _M)])
    idx = rows(0.955, 0.970)                          # =/X runs
    a = rng.integers(5, 70, idx.size)
    b = rng.integers(1, 4, idx.size)
    c = rng.integers(5, 60, idx.size)
    put(idx, [(a, _EQ), (b, _X), (c, _EQ), (np.ones(idx.size), _X),
              (L - a - b - c - 1, _EQ)])
    idx = rows(0.970, 0.985)                          # RNA-seq N skip
    g = rng.integers(50, 5001, idx.size)
    a = rng.integers(20, L - 20, idx.size)
    s = rng.integers(0, 6, idx.size)
    put(idx, [(s, _S), (a - s, _M), (g, _N), (L - a, _M)])
    idx = rows(0.985, 0.997)                          # 9-16 ops
    parts = []
    used = np.zeros(idx.size, np.int64)
    for j in range(7):
        q = rng.integers(5, 15, idx.size)
        parts += [(q, _M), (rng.integers(1, 4, idx.size),
                            (_I, _D, _EQ, _X, _D, _I, _N)[j])]
        used += q + (parts[-1][0] if parts[-1][1] in (_I, _EQ, _X) else 0)
    parts.append((L - used, _M))
    put(idx, parts)
    idx = rows(0.997, 1.0)                            # 33-41 ops
    parts = []
    used = np.zeros(idx.size, np.int64)
    for j in range(20):
        q = rng.integers(2, 5, idx.size)
        op = (_I, _D, _X, _N)[j % 4]
        parts += [(q, _M), (np.ones(idx.size, np.int64), op)]
        used += q + (1 if op in (_I, _X) else 0)
    parts.append((L - used, _M))
    put(idx, parts)
    return ln, code


def write_coverage_bam(path: str, n_reads: int, seed: int,
                       span: int = 10_000_000,
                       chunk: int = 1 << 16) -> CoverageTruth:
    """Write ``n_reads`` (even) paired 151-bp reads piled over
    chr20:1-``span`` as a coordinate-sorted BAM, and return the
    generator's truth (``CoverageTruth``; ``coverage_oracle`` turns it
    into depth).  2,000,000 reads over 10 Mb is about 30x.

    Most reads are 151M.  The rest carry soft and hard clips, 1-10 bp
    insertions and deletions, =/X runs, RNA-seq-like N skips of 50-5,000
    bp, 9-16 ops and 33-41 ops; 3% of the pairs lie on chr21, 2% of the
    reads are unmapped (at their mate's place, most with a '*' CIGAR,
    some keeping one), 0.5% of the pairs are unplaced, and 0.2% of the
    mapped reads have a '*' CIGAR.  Every read holds 151 bases."""
    if n_reads % 2:
        raise ValueError("n_reads must be even (reads come in pairs)")
    rng = np.random.default_rng(seed)
    n_pairs = n_reads // 2
    n = n_reads
    on21 = rng.random(n_pairs) < 0.03
    lens = np.array([l for _, l in CONTIGS], np.int64)
    start_hi = np.minimum(span, lens[on21.astype(int)]) - 12_000
    pos1 = (rng.random(n_pairs) * start_hi).astype(np.int64)
    insert = rng.integers(200, 600, n_pairs)
    refid = np.repeat(on21.astype(np.int32), 2)
    pos = np.stack([pos1, pos1 + insert - READ_LEN], 1).reshape(-1)
    ln, code = _cigar_table(rng, n)
    unmapped = rng.random(n) < 0.02
    unplaced = np.repeat(rng.random(n_pairs) < 0.005, 2)
    unmapped |= unplaced
    star = (unmapped & (rng.random(n) < 0.8)) | unplaced | \
        (~unmapped & (rng.random(n) < 0.002))
    mate = np.arange(n) ^ 1
    # an unmapped read sits at its mate's place; an unplaced pair nowhere
    pos = np.where(unmapped & ~unplaced, pos[mate], pos)
    refid = np.where(unplaced, -1, refid)
    pos = np.where(unplaced, -1, pos)
    ln[star] = 0
    n_ops = (ln > 0).sum(1).astype(np.int32)
    keep = ln > 0
    flat_len = ln[keep]
    flat_code = code[keep]
    first = np.tile([True, False], n_pairs)
    flag = (FPAIRED + np.where(first, FREAD1, FREAD2)
            + np.where(unmapped, FUNMAP, 0)
            + np.where(unmapped[mate], FMUNMAP, 0)
            + np.where(~unmapped & ~unmapped[mate], FPROPER_PAIR, 0)
            + np.where(rng.random(n) < 0.03, FDUP, 0)).astype(np.int32)
    # coordinate order, unplaced reads last
    key = (np.where(refid < 0, len(CONTIGS), refid).astype(np.int64)
           << 32) + pos + 1
    order = np.argsort(key, kind="stable")
    off = np.concatenate([[0], np.cumsum(n_ops)])
    n_ops_s = n_ops[order]
    off_s = np.concatenate([[0], np.cumsum(n_ops_s)])
    src = np.repeat(off[:-1][order], n_ops_s) + (
        np.arange(off_s[-1]) - np.repeat(off_s[:-1], n_ops_s))
    truth = CoverageTruth(refid=refid[order].astype(np.int32),
                          pos=pos[order], flag=flag[order], n_ops=n_ops_s,
                          op_len=flat_len[src], op_code=flat_code[src])
    mate_refid = refid[mate][order]
    mate_pos = pos[mate][order]
    pair = (np.arange(n) // 2)[order]
    ref_span = np.zeros(n, np.int64)
    seg = np.repeat(np.arange(n), n_ops_s)
    np.add.at(ref_span, seg, np.where(np.isin(truth.op_code, _REF_OPS),
                                      truth.op_len, 0))
    with BamWriter(path, header("coordinate")) as w:
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            w.write_raw(_coverage_records(
                rng, truth, lo, hi, off_s, mate_refid[lo:hi],
                mate_pos[lo:hi], pair[lo:hi], ref_span[lo:hi]), hi - lo)
    return truth


def _coverage_records(rng, truth: CoverageTruth, lo: int, hi: int,
                      off_s: np.ndarray, mate_refid, mate_pos, pair,
                      ref_span) -> bytes:
    """Records [lo, hi) of the coverage BAM as concatenated bytes."""
    k = hi - lo
    nc = truth.n_ops[lo:hi].astype(np.int64)
    size = _COV_PREFIX + 4 * nc + _COV_SEQ + READ_LEN
    start = np.concatenate([[0], np.cumsum(size)])
    buf = np.zeros(int(start[-1]), np.uint8)
    pos = truth.pos[lo:hi]
    prefix = np.zeros(k, _COV_HEAD)
    prefix["block_size"] = size - 4
    prefix["refid"] = truth.refid[lo:hi]
    prefix["pos"] = pos
    prefix["l_read_name"] = NAME_LEN
    prefix["mapq"] = np.where(truth.flag[lo:hi] & FUNMAP, 0, 60)
    p0 = np.maximum(pos, 0)
    prefix["bin"] = np.where(pos >= 0, _reg2bin(
        p0, p0 + np.maximum(ref_span, 1)), 4680)
    prefix["n_cigar"] = nc
    prefix["flag"] = truth.flag[lo:hi]
    prefix["l_seq"] = READ_LEN
    prefix["mate_refid"] = mate_refid
    prefix["mate_pos"] = mate_pos
    digits = (pair[:, None] // 10 ** np.arange(7, -1, -1)[None, :]) % 10
    prefix["name"][:, 0] = ord("c")
    prefix["name"][:, 1:9] = 48 + digits
    pb = prefix.view(np.uint8).reshape(k, _COV_PREFIX)
    buf[start[:-1, None] + np.arange(_COV_PREFIX)[None, :]] = pb
    # cigar words
    a, b = off_s[lo], off_s[hi]
    words = ((truth.op_len[a:b] << 4) | truth.op_code[a:b]).astype("<u4")
    row = np.repeat(np.arange(k), nc)
    j = np.arange(b - a) - np.repeat(off_s[lo:hi] - a, nc)
    dst = start[:-1][row] + _COV_PREFIX + 4 * j
    buf[dst[:, None] + np.arange(4)[None, :]] = \
        words.view(np.uint8).reshape(-1, 4)
    # bases and qualities
    codes = _CODES[rng.integers(0, 4, (k, READ_LEN + 1))]
    seq = (codes[:, 0::2] << 4) | codes[:, 1::2]
    at = start[:-1] + _COV_PREFIX + 4 * nc
    buf[at[:, None] + np.arange(_COV_SEQ)[None, :]] = seq
    buf[at[:, None] + _COV_SEQ + np.arange(READ_LEN)[None, :]] = \
        rng.integers(2, 42, (k, READ_LEN), dtype=np.uint8)
    return buf.tobytes()


def coverage_oracle(truth: CoverageTruth, refid: int, win_start: int,
                    window: int) -> np.ndarray:
    """Per-base aligned depth over ``[win_start, win_start + window)``
    (0-based) of reference ``refid``, from the generator's own columns:
    M/=/X bases of reads without FLAG 0x4 on that reference, with D/N
    moving the cursor.  NumPy only (int32 result)."""
    n_ops = truth.n_ops.astype(np.int64)
    seg = np.repeat(np.arange(truth.n_reads), n_ops)
    adv = np.where(np.isin(truth.op_code, _REF_OPS), truth.op_len, 0)
    # each op's reference start: the read's position plus the reference
    # bases of the read's earlier ops
    before = np.cumsum(adv) - adv
    first = np.concatenate([[0], np.cumsum(n_ops)[:-1]])
    has = n_ops > 0
    read_base = np.repeat(before[first[has]], n_ops[has])
    op_start = truth.pos[seg] + before - read_base
    use = np.isin(truth.op_code, _DEPTH_OPS) & \
        (truth.refid[seg] == refid) & ((truth.flag[seg] & FUNMAP) == 0)
    s = np.clip(op_start[use] - win_start, 0, window)
    e = np.clip(op_start[use] + truth.op_len[use] - win_start, 0, window)
    diff = np.bincount(s, minlength=window + 1)[:window + 1] - \
        np.bincount(e, minlength=window + 1)[:window + 1]
    return np.cumsum(diff[:window]).astype(np.int32)


# ---------------------------------------------------------------------------
# A synthetic call set with the genotype layout of the 1000 Genomes
# Project phase 3 integrated release (ALL.chr*.phase3_shapeit2_mvncall_
# integrated_v5a.20130502.genotypes): 2,504 samples, diploid phased GT,
# FORMAT = GT only, INFO AC, AF, AN, NS, DP and VT, written as BCF (BGZF
# and raw) and as a BGZF VCF, with its variant stats
# ---------------------------------------------------------------------------

KG_SAMPLES = 2504
KG_CONTIGS: Tuple[Tuple[str, int], ...] = (("20", 63025520),
                                           ("X", 155270560))
KG_SNP_SHARE = 0.92          # SNPs; the rest are indels
KG_MULTI_SHARE = 0.01        # sites with two ALT alleles
# two additions the release lacks, so that no counter is vacuous
KG_FILTERED_SHARE = 0.02     # sites not PASS (FILTER=LowQual)
KG_MISSING_SHARE = 0.005     # './.' calls
_KG_CHUNK = 2048             # records generated at a time

_T_INT8, _T_INT16, _T_INT32, _T_FLOAT, _T_CHAR = 1, 2, 3, 5, 7
_INT8_EOV = 0x81             # int8 END_OF_VECTOR (-127), haploid pads


def kg_header(n_samples: int = KG_SAMPLES) -> "VCFHeader":
    """The release's header lines (and a LowQual FILTER, the addition),
    with ``n_samples`` sample columns."""
    from hadoop_bam_torch.formats.vcf import VCFHeader
    lines = [
        "##fileformat=VCFv4.1",
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FILTER=<ID=LowQual,Description="Synthetic addition: a site '
        'that failed a filter">',
        "##source=1000GenomesPhase3Pipeline (synthetic genotypes)",
    ] + [f"##contig=<ID={c},assembly=b37,length={n}>"
         for c, n in KG_CONTIGS] + [
        '##INFO=<ID=AC,Number=A,Type=Integer,Description="Total number '
        'of alternate alleles in called genotypes">',
        '##INFO=<ID=AF,Number=A,Type=Float,Description="Estimated allele '
        'frequency in the range (0,1)">',
        '##INFO=<ID=AN,Number=1,Type=Integer,Description="Total number '
        'of alleles in called genotypes">',
        '##INFO=<ID=NS,Number=1,Type=Integer,Description="Number of '
        'samples with data">',
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total read '
        'depth; only low coverage data were counted towards the DP, '
        'exome data were not used">',
        '##INFO=<ID=VT,Number=.,Type=String,Description="indicates what '
        'type of variant the line represents">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    ]
    text = "\n".join(lines) + "\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t" \
        "INFO\tFORMAT\t" + "\t".join(f"HG{96 + i:05d}"
                                     for i in range(n_samples)) + "\n"
    return VCFHeader.from_text(text)


def _typed_desc(count: int, typ: int) -> bytes:
    if count < 15:
        return bytes([(count << 4) | typ])
    return bytes([0xF0 | typ]) + _typed_ints([count])


def _typed_ints(vals: Sequence[int]) -> bytes:
    lo, hi = min(vals), max(vals)
    if lo >= -120 and hi <= 127:
        typ, fmt = _T_INT8, "b"
    elif lo >= -32760 and hi <= 32767:
        typ, fmt = _T_INT16, "h"
    else:
        typ, fmt = _T_INT32, "i"
    return _typed_desc(len(vals), typ) + struct.pack(f"<{len(vals)}{fmt}",
                                                     *vals)


def _typed_str(s: str) -> bytes:
    b = s.encode()
    return _typed_desc(len(b), _T_CHAR) + b


def _typed_floats(vals: Sequence[float]) -> bytes:
    return _typed_desc(len(vals), _T_FLOAT) + struct.pack(
        f"<{len(vals)}f", *vals)


def _fmt_f32(v: float) -> str:
    """The shortest text of the f32 the BCF stores."""
    if v == int(v):
        return str(int(v))
    return np.format_float_positional(np.float32(v), unique=True,
                                      trim="0")


@dataclasses.dataclass
class VariantTruth:
    """The stats ``variant_stats_file`` must return over the records the
    generator wrote (``vcf``: over the first ``vcf_records`` of them, the
    BGZF VCF's), and with ``keep_rows`` each record's tile row (chrom,
    pos, flags, dosage [n, n_samples]) and its length on the reference
    (``rlen``: len(REF); no record has INFO END) in file order."""
    n_variants: int
    n_snp: int
    n_pass: int
    n_af: int
    mean_af: float
    sample_callrate: np.ndarray    # float64 [n_samples]
    vcf: Optional["VariantTruth"] = None
    chrom: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    flags: Optional[np.ndarray] = None
    dosage: Optional[np.ndarray] = None
    rlen: Optional[np.ndarray] = None   # each record's length on the reference
    filtered_share: float = 0.0    # the additions, as written
    missing_share: float = 0.0

    def stats(self) -> Dict[str, object]:
        return {"n_variants": self.n_variants, "n_snp": self.n_snp,
                "n_pass": self.n_pass, "n_af": self.n_af,
                "mean_af": self.mean_af,
                "sample_callrate": self.sample_callrate}


class _VariantTally:
    def __init__(self, n_samples: int):
        self.n = self.snp = self.pas = self.n_af = self.miss = 0
        self.sum_af = 0.0
        self.called = np.zeros(n_samples, np.int64)

    def add(self, dose: np.ndarray, flags: np.ndarray) -> None:
        called = dose >= 0
        n_called = called.sum(1)
        alt = np.where(called, dose, 0).sum(1)
        has = n_called > 0
        # the reference's f32 division: sum / (2 x called)
        af = np.float32(alt) / np.float32(2 * np.maximum(n_called, 1))
        self.sum_af += float(af[has].astype(np.float64).sum())
        self.n_af += int(has.sum())
        self.n += dose.shape[0]
        self.snp += int(((flags & 2) != 0).sum())
        self.pas += int(((flags & 1) != 0).sum())
        self.called += called.sum(0)
        self.miss += int((~called).sum())

    def truth(self) -> VariantTruth:
        return VariantTruth(
            n_variants=self.n, n_snp=self.snp, n_pass=self.pas,
            n_af=self.n_af, mean_af=self.sum_af / max(self.n_af, 1),
            sample_callrate=self.called / max(self.n, 1))


def _kg_sites(rng: np.random.Generator, n: int, n_x: int):
    """Per-site columns: contig, 1-based position (sorted within each
    contig), ALT frequency (log-uniform between one allele in 5,008 and
    1/2: skewed rare), SNP / multi-allelic / filtered flags."""
    chrom = np.zeros(n, np.int32)
    chrom[n - n_x:] = 1
    pos = np.empty(n, np.int64)
    for c, (_, length) in enumerate(KG_CONTIGS):
        sel = chrom == c
        pos[sel] = np.sort(rng.integers(60_001, length - 60_000,
                                        int(sel.sum())))
    p = 10.0 ** rng.uniform(np.log10(1 / 5008), np.log10(0.5), n)
    snp = rng.random(n) < KG_SNP_SHARE
    multi = rng.random(n) < KG_MULTI_SHARE
    filtered = rng.random(n) < KG_FILTERED_SHARE
    return chrom, pos, p.astype(np.float32), snp, multi, filtered


def _kg_alleles(rng: np.random.Generator, snp: bool, multi: bool
                ) -> Tuple[str, Tuple[str, ...]]:
    bases = "ACGT"
    r = int(rng.integers(4))
    ref = bases[r]
    if snp:
        alts = [bases[(r + 1 + i) % 4] for i in
                rng.permutation(3)[:2 if multi else 1]]
        return ref, tuple(alts)
    k = int(rng.integers(1, 6))
    tail = "".join(bases[i] for i in rng.integers(0, 4, k))
    if rng.random() < 0.5:                    # deletion
        second = (ref + tail[:-1] if k > 1 else ref + tail + "T",)
        return ref + tail, (ref,) + (second if multi else ())
    return ref, (ref + tail,) + ((ref + tail + "T",) if multi else ())


def write_synthetic_vcf(path: str, n_records: int, seed: int, *,
                        n_samples: int = KG_SAMPLES,
                        x_records: Optional[int] = None,
                        raw_path: Optional[str] = None,
                        vcf_path: Optional[str] = None,
                        vcf_records: int = 0,
                        keep_rows: bool = False) -> VariantTruth:
    """Write ``n_records`` variants with the 1000 Genomes phase 3 layout
    (``kg_header``) as a BGZF BCF at ``path``, the same records as a raw
    BCF at ``raw_path`` and the first ``vcf_records`` as a BGZF VCF at
    ``vcf_path``; return the truth (``VariantTruth``, computed from the
    generating arrays, not by reading the files back).

    The last ``x_records`` (default a tenth) lie on X, where a fixed
    half of the samples (the males) are haploid, their second GT entry
    END_OF_VECTOR; the text VCF's records must all lie on 20.  ALT
    frequencies are skewed rare, ~92% of sites SNPs and the rest indels,
    ~1% with two ALTs; ~2% of sites are not PASS and ~0.5% of calls
    './.' (both additions).  The genotype bytes are built with NumPy a
    chunk of records at a time; only each record's shared block is
    encoded in Python."""
    from hadoop_bam_torch.formats import bgzf
    from hadoop_bam_torch.formats.bcf import encode_header

    n_x = n_records // 10 if x_records is None else int(x_records)
    if vcf_records > n_records - n_x:
        raise ValueError("the text VCF holds diploid records only: "
                         "vcf_records must not reach the X records")
    rng = np.random.default_rng(seed)
    header = kg_header(n_samples)
    strings = header.string_dictionary()
    key = {s: i for i, s in enumerate(strings)}
    S = n_samples
    chrom, pos, p, snp, multi, filtered = _kg_sites(rng, n_records, n_x)
    male = rng.random(S) < 0.5
    whole, text_tally = _VariantTally(S), _VariantTally(S)
    kept = {"chrom": [], "pos": [], "flags": [], "dosage": [], "rlen": []}
    indiv_head = (_typed_ints([key["GT"]]) + _typed_desc(2, _T_INT8))
    l_indiv = len(indiv_head) + 2 * S
    with contextlib.ExitStack() as stack:
        bz = stack.enter_context(bgzf.BGZFWriter(
            stack.enter_context(open(path, "wb"))))
        raw = stack.enter_context(open(raw_path, "wb")) if raw_path \
            else None
        vz = None
        if vcf_path and vcf_records:
            vz = stack.enter_context(bgzf.BGZFWriter(
                stack.enter_context(open(vcf_path, "wb"))))
            vz.write(header.to_text().encode())
        head = encode_header(header)
        bz.write(head)
        if raw is not None:
            raw.write(head)
        for lo in range(0, n_records, _KG_CHUNK):
            hi = min(n_records, lo + _KG_CHUNK)
            m = hi - lo
            hap = (chrom[lo:hi] == 1)[:, None] & male[None, :]   # [m, S]
            alt = rng.random((m, S, 2), dtype=np.float32) \
                < p[lo:hi, None, None]
            allele = alt.astype(np.uint8)
            two = np.flatnonzero(multi[lo:hi])
            if two.size:
                pick = rng.random((two.size, S, 2), dtype=np.float32) < 0.5
                allele[two] += (alt[two] & pick).astype(np.uint8)
            miss = rng.random((m, S), dtype=np.float32) < KG_MISSING_SHARE
            gt = np.empty((m, S, 2), np.uint8)
            gt[..., 0] = (allele[..., 0] + 1) << 1
            gt[..., 1] = ((allele[..., 1] + 1) << 1) | 1
            gt[miss] = 0
            gt[..., 1][hap] = _INT8_EOV
            dose = np.where(
                miss, -1, (allele[..., 0] > 0).astype(np.int8)
                + np.where(hap, 0, allele[..., 1] > 0).astype(np.int8)
            ).astype(np.int8)
            pres = ~miss
            an_c = (pres * np.where(hap, 1, 2)).sum(1)
            ac_c = [(((allele[..., 0] == k) & pres).sum(1)
                     + ((allele[..., 1] == k) & pres & ~hap).sum(1))
                    for k in (1, 2)]
            rec_flags = np.zeros(m, np.uint8)
            rlen = np.zeros(m, np.int32)
            parts, lines = [], []
            for j in range(m):
                i = lo + j
                ref, alts = _kg_alleles(rng, bool(snp[i]), bool(multi[i]))
                is_snp = len(ref) == 1 and all(len(a) == 1 for a in alts)
                rlen[j] = len(ref)
                rec_flags[j] = (0 if filtered[i] else 1) | \
                    (2 if is_snp else 0)
                an = int(an_c[j])
                ac = [int(c[j]) for c in ac_c[:len(alts)]]
                af = [a / max(an, 1) for a in ac]
                dp = int(rng.integers(5000, 30000))
                vt = "SNP" if is_snp else "INDEL"
                vid = f"rs{1000000 + i}" if i % 10 < 7 else "."
                filt = key["LowQual"] if filtered[i] else 0
                shared = struct.pack(
                    "<iiifHHI", int(chrom[i]), int(pos[i]) - 1, len(ref),
                    100.0, 6, 1 + len(alts), S | (1 << 24))
                shared += _typed_str(vid) + _typed_str(ref) + b"".join(
                    _typed_str(a) for a in alts) + _typed_ints([filt])
                shared += (_typed_ints([key["AC"]]) + _typed_ints(ac)
                           + _typed_ints([key["AF"]]) + _typed_floats(af)
                           + _typed_ints([key["AN"]]) + _typed_ints([an])
                           + _typed_ints([key["NS"]]) + _typed_ints([S])
                           + _typed_ints([key["DP"]]) + _typed_ints([dp])
                           + _typed_ints([key["VT"]]) + _typed_str(vt))
                parts.append(struct.pack("<II", len(shared), l_indiv)
                             + shared + indiv_head)
                parts.append(gt[j].tobytes())
                if vz is not None and i < vcf_records:
                    info = (f"AC={','.join(map(str, ac))};AF="
                            + ",".join(_fmt_f32(float(np.float32(a)))
                                       for a in af)
                            + f";AN={an};NS={S};DP={dp};VT={vt}")
                    lines.append(
                        f"{KG_CONTIGS[chrom[i]][0]}\t{pos[i]}\t{vid}\t{ref}"
                        f"\t{','.join(alts)}\t100\t"
                        f"{'LowQual' if filtered[i] else 'PASS'}\t{info}"
                        f"\tGT\t".encode())
            block = b"".join(parts)
            bz.write(block)
            if raw is not None:
                raw.write(block)
            whole.add(dose, rec_flags)
            if lines:
                k = len(lines)
                txt = np.empty((k, S, 4), np.uint8)
                txt[..., 0] = ord("0") + allele[:k, :, 0]
                txt[..., 1] = ord("|")
                txt[..., 2] = ord("0") + allele[:k, :, 1]
                txt[..., 3] = ord("\t")
                txt[miss[:k]] = np.frombuffer(b"./.\t", np.uint8)
                txt[:, -1, 3] = ord("\n")
                vz.write(b"".join(line + row.tobytes()
                                  for line, row in zip(lines, txt)))
                text_tally.add(dose[:k], rec_flags[:k])
            if keep_rows:
                kept["chrom"].append(chrom[lo:hi].copy())
                kept["pos"].append(pos[lo:hi].astype(np.int32))
                kept["flags"].append(rec_flags)
                kept["dosage"].append(dose)
                kept["rlen"].append(rlen)
    truth = whole.truth()
    truth.filtered_share = float(filtered.mean()) if n_records else 0.0
    truth.missing_share = whole.miss / max(1, n_records * S)
    if vcf_path and vcf_records:
        truth.vcf = text_tally.truth()
    if keep_rows:
        for k, v in kept.items():
            setattr(truth, k, np.concatenate(v) if v else None)
    return truth


# K11's edge cases, shared by the CPU parity tests, the card tests and
# chip_smoke.py phase 15 (a): (width, ploidy, n_sample, G group rows)
GT_CASES: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 2, 2504, 64), (2, 2, 2504, 16), (4, 2, 517, 9),
    (1, 1, 300, 33), (2, 3, 300, 7), (4, 3, 300, 5),
    (1, 200, 40, 6),       # saturation past 127 ALT alleles
)
_GT_SPECIAL = {1: (-128, -127), 2: (-32768, -32767),
               4: (-(1 << 31), -(1 << 31) + 1)}


def _gt_body(rng: np.random.Generator, width: int, count: int,
             n_sample: int, G: int) -> bytes:
    """G records' GT data, ``n_sample`` x ``count`` little-endian entries
    ``width`` bytes wide each: phased and unphased ALT / REF alleles (some
    above 127), MISSING, allele value 0 and 1, END_OF_VECTOR tails of
    every length, junk."""
    miss, eov = _GT_SPECIAL[width]
    n = G * n_sample * count
    allele = rng.integers(0, 4, n) * (rng.random(n) < 0.3)
    if count >= 128:
        allele[rng.random(n) < 0.9] = 1          # mostly ALT: saturates
    g = ((allele + 1) << 1) | rng.integers(0, 2, n)
    # MISSING, allele values 0 / 1 and junk, rarer in long vectors so
    # that most of their calls stay whole (and saturate)
    pick = rng.random(n) / (1.0 if count < 128 else 0.025)
    g = np.where(pick < 0.02, miss, g)
    g = np.where((pick >= 0.02) & (pick < 0.04), rng.integers(0, 2, n), g)
    g = np.where((pick >= 0.04) & (pick < 0.05),
                 rng.integers(-(1 << (8 * width - 1)),
                              1 << (8 * width - 1), n), g)
    g = g.reshape(G, n_sample, count)
    tails = rng.integers(0, count + 1, (G, n_sample))
    tails[:, :3] = [0, count, max(count - 1, 0)][:min(3, n_sample)] \
        if n_sample >= 3 else tails[:, :3]
    g = np.where(np.arange(count)[None, None, :]
                 >= count - tails[..., None] * (rng.random((G, n_sample, 1))
                                                < 0.2), eov, g)
    dt = {1: "<i1", 2: "<i2", 4: "<i4"}[width]
    return g.astype(dt).tobytes()


def _gt_edges(offs: np.ndarray, L: int, stride: int) -> np.ndarray:
    """``offs`` (int64) with its last rows (all but two) moved to the
    clip and wrap edges: cut by the buffer's end, past it, before its
    start, and wrapping int32; returned as int32."""
    edge = [L - 1, L - stride // 2, L + 5, -3, -stride - 9, (1 << 31) - 7]
    G = offs.size
    k = min(len(edge), max(0, G - 2))
    if k:
        offs[G - k:] = edge[:k]
    return (((offs + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)


def gt_rows(width: int, count: int, n_sample: int, G: int, seed: int = 0
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """One GT layout group for ``gt_dosage``: (buf u8 [L], gt_off i32
    [G], rows i32 [G], R) with G records' GT data (``_gt_body``); the
    last rows' offsets clip at the buffer's start (negative, wrapping
    int32) and end (past L); rows are a permutation of R >= G tile rows
    (so some rows belong to no group)."""
    rng = np.random.default_rng(seed)
    body = _gt_body(rng, width, count, n_sample, G)
    pad = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    buf = np.frombuffer(pad + body + pad, np.uint8).copy()
    L = buf.size
    stride = width * count * n_sample
    offs = _gt_edges(64 + np.arange(G, dtype=np.int64) * stride, L, stride)
    R = G + 5
    rows = rng.permutation(R)[:G].astype(np.int32)
    return buf, offs, rows, R


# ``variant_unpack``'s cases (a whole span's tile in one launch), shared
# like GT_CASES: (label, GT layout groups [(width, ploidy, n_sample, G)],
# records n, samples_pad).  Every group's last rows sit at the clip and
# wrap edges, as do some records' starts; rows past the groups' are of no
# group.
UNPACK_CASES: Tuple[Tuple[str, Tuple[Tuple[int, int, int, int], ...], int,
                          int], ...] = (
    ("diploid and haploid, n_sample < samples_pad",
     ((1, 2, 300, 20), (1, 1, 300, 12)), 40, 304),
    ("width 2", ((2, 2, 130, 10),), 14, 136),
    ("width 4, two ploidies", ((4, 3, 50, 7), (4, 2, 50, 5)), 15, 56),
    ("saturation", ((1, 200, 40, 6),), 9, 40),
    ("rows of no group only", (), 12, 16),
    ("no pad row or column", ((1, 2, 256, 16),), 16, 256),
    ("the main path's width", ((1, 2, 2504, 60), (1, 1, 2504, 4)), 70,
     2504),
)


def unpack_span(groups, n: int, samples_pad: int, seed: int = 0):
    """One span for ``variant_unpack``: (buf u8 [L], meta, R, s_pad)
    with ``meta`` shaped as ``decode_bcf_cursor_meta``'s (n, starts
    int64 [n], flags uint8 [n], gt_groups [(rows int64, offs int64,
    width, ploidy, n_sample)]).  The buffer holds a random head that the
    starts point into (some at the edges of ``prefix_rows``), then each
    group's GT data (``_gt_body``) after a gap of 1-15 bytes, so the
    groups start at every alignment; the groups take random rows of
    [0, n), the rest are of no group; R = the next power of two >= n,
    at least 8."""
    rng = np.random.default_rng(seed)
    if sum(g[3] for g in groups) > n:
        raise ValueError("more group rows than records")
    head = rng.integers(0, 256, 24 * n + 40, dtype=np.uint8).tobytes()
    parts, at, bases = [head], len(head), []
    for width, count, n_sample, G in groups:
        gap = rng.integers(0, 256, int(rng.integers(1, 16)),
                           dtype=np.uint8).tobytes()
        bases.append(at + len(gap))
        body = _gt_body(rng, width, count, n_sample, G)
        parts += [gap, body]
        at += len(gap) + len(body)
    parts.append(rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
    buf = np.frombuffer(b"".join(parts), np.uint8).copy()
    L = buf.size
    starts = rng.integers(0, len(head) - 16, n).astype(np.int64)
    edge = [0, -1, -8, L - 16, L - 9, L - 1, L, L + 100, (1 << 31) - 10,
            -(1 << 31)]
    k = min(len(edge), n // 2)
    starts[n - k:] = edge[:k]
    rows = rng.permutation(n)
    gt_groups, used = [], 0
    for (width, count, n_sample, G), base in zip(groups, bases):
        stride = width * count * n_sample
        offs = _gt_edges(base + np.arange(G, dtype=np.int64) * stride, L,
                         stride)
        gt_groups.append((np.sort(rows[used:used + G]).astype(np.int64),
                          offs.astype(np.int64), width, count, n_sample))
        used += G
    meta = {"n": n,
            "starts": ((starts + (1 << 31)) & 0xFFFFFFFF) - (1 << 31),
            "flags": rng.integers(0, 4, n, dtype=np.uint8),
            "gt_groups": gt_groups}
    R = 8
    while R < n:
        R <<= 1
    return buf, meta, R, samples_pad


def prefix_rows(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``variant_prefix`` inputs: (buf u8 [L], starts i32 [R]) with
    starts inside the buffer, pads of 0, and starts cut by either end:
    negative, within 16 bytes of L, past L and wrapping int32."""
    rng = np.random.default_rng(seed)
    L = 64 * n + 40
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    starts = rng.integers(0, L - 16, n).astype(np.int64)
    edge = [0, 0, -1, -8, -12, L - 16, L - 9, L - 1, L, L + 100,
            (1 << 31) - 10, -(1 << 31)]
    k = min(len(edge), n)
    starts[n - k:] = edge[:k]
    return buf, starts.astype(np.int32)


# ---------------------------------------------------------------------------
# duplicate marking (prep/): K16a's edge rows and a duplicate-bearing BAM
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_MD_STRIDE = 512                  # a row of the round tile at 151 bp reads

# (name, record fields): "cigar" None is a '*' CIGAR (n_cigar 0); "qual"
# is "random", "ff" (a missing quality string) or "edge" (14/15/16);
# "l_seq_field" overrides the l_seq written (the quality run then leaves
# the record); "lib" is the library column beside the row; a record
# longer than the row (the long CIGAR) is cut at its end
MARKDUP_CASES: Tuple[Tuple[str, Dict], ...] = (
    ("forward 151M", dict(flag=99, pos=10_000, cigar="151M")),
    ("forward 5S146M", dict(flag=99, pos=10_005, cigar="5S146M")),
    ("forward 3H148M", dict(flag=99, pos=10_003, cigar="3H148M")),
    ("forward 2H4S145M", dict(flag=99, pos=10_006, cigar="2H4S145M")),
    ("reverse 146M5S", dict(flag=147, pos=10_300, cigar="146M5S")),
    ("reverse 148M3H", dict(flag=147, pos=10_300, cigar="148M3H")),
    ("reverse 2S144M5H", dict(flag=83, pos=10_300, cigar="2S144M5H")),
    ("both ends 4S140M7S", dict(flag=163, pos=20_000, cigar="4S140M7S")),
    ("all clip 10S5H", dict(flag=0, pos=5_000, cigar="10S5H", l_seq=10)),
    ("all clip reverse", dict(flag=16, pos=5_000, cigar="3H10S5H",
                              l_seq=10)),
    ("no CIGAR", dict(flag=0, pos=7_000, cigar=None, l_seq=50)),
    ("D N I", dict(flag=16, pos=8_000, cigar="10M2D8M3N12M2I7M")),
    ("= X P", dict(flag=0, pos=8_100, cigar="5=1X20M2P9=")),
    ("long CIGAR", dict(flag=16, pos=9_000,
                        cigar="3S" + "4M1I2M1D" * 19 + "9M2H")),
    ("mate unmapped", dict(flag=73, pos=30_000, cigar="151M")),
    ("mate reverse", dict(flag=97, pos=30_100, cigar="151M")),
    ("unpaired reverse", dict(flag=16, pos=30_200, cigar="151M")),
    ("secondary", dict(flag=355, pos=40_000, cigar="151M")),
    ("supplementary", dict(flag=2145, pos=40_000, cigar="5H146M")),
    ("unmapped at its mate", dict(flag=69, pos=40_100, cigar=None)),
    ("unmapped sentinel", dict(flag=77, refid=-1, pos=-1, cigar=None,
                               next_refid=-1, next_pos=-1)),
    ("mate fields -1", dict(flag=1, pos=50_000, cigar="151M",
                            next_refid=-1, next_pos=-1)),
    ("duplicate flag set", dict(flag=1123, pos=50_100, cigar="151M")),
    ("0xFF qualities", dict(flag=99, pos=60_000, cigar="151M", qual="ff")),
    ("qualities 14 / 15 / 16", dict(flag=99, pos=60_100, cigar="151M",
                                    qual="edge")),
    ("pos 0, 5S", dict(flag=99, pos=0, cigar="5S146M")),
    ("pos 2, 4H", dict(flag=0, pos=2, cigar="4H147M")),
    ("pos at the int32 edge, reverse", dict(flag=16, pos=2**31 - 100,
                                            cigar="151M")),
    ("even l_seq", dict(flag=0, pos=61_000, cigar="150M", l_seq=150)),
    ("library past 2^29", dict(flag=99, pos=62_000, cigar="151M",
                               lib=0x3FFFFFFF)),
    ("library 2^32 - 1", dict(flag=99, pos=62_000, cigar="151M",
                              lib=_U32)),
    ("qualities past the row", dict(flag=0, pos=63_000, cigar="151M",
                                    l_seq_field=5_000)),
    ("negative l_seq", dict(flag=0, pos=63_100, cigar="151M",
                            l_seq_field=-3)),
    ("l_seq 2^31 - 1", dict(flag=0, pos=63_200, cigar="151M",
                            l_seq_field=2**31 - 1)),
    ("CIGAR past the row", dict(flag=0, pos=64_000, name_len=200,
                                cigar="1M" * 120, l_seq=8)),
)
# the last (pad) row of ``markdup_rows``: its CIGAR runs past the tile
_MD_TILE_END = dict(flag=0, pos=65_000, name_len=240, cigar="1M" * 100,
                    l_seq=8)


def _cigar_words(cigar: Optional[str]) -> np.ndarray:
    if cigar is None:
        return np.zeros(0, "<u4")
    return np.asarray([(int(n) << 4) | _OP_CHARS.index(op) for n, op in
                       re.findall(r"(\d+)([MIDNSHP=X])", cigar)], "<u4")


def markdup_record(rng: np.random.Generator, *, flag: int, pos: int,
                   cigar: Optional[str], refid: int = 0, l_seq: int = 151,
                   qual: str = "random", next_refid: int = 0,
                   next_pos: int = 10_250, name_len: int = NAME_LEN,
                   l_seq_field: Optional[int] = None) -> bytes:
    """One raw BAM record (block_size first) of a ``MARKDUP_CASES``
    entry."""
    words = _cigar_words(cigar)
    codes = rng.choice(_CODES[:4], l_seq)
    if l_seq % 2:
        codes = np.concatenate([codes, [0]])
    seq = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
    if qual == "ff":
        q = np.full(l_seq, 0xFF, np.uint8)
    elif qual == "edge":
        q = np.resize(np.array([14, 15, 16], np.uint8), l_seq)
    else:
        q = rng.integers(2, 42, l_seq).astype(np.uint8)
    name = b"m" * (name_len - 1) + b"\x00"
    body = struct.pack(
        "<iiBBHHHiiii", refid, pos, name_len, 60, 4680, words.size, flag,
        l_seq if l_seq_field is None else l_seq_field, next_refid, next_pos,
        0) + name + words.tobytes() + seq.tobytes() + q.tobytes()
    return struct.pack("<i", len(body)) + body


def markdup_rows(seed: int = 0, stride: int = _MD_STRIDE, pads: int = 5
                 ) -> Tuple[np.ndarray, np.ndarray, int, Tuple[str, ...]]:
    """K16a's edge rows: every ``MARKDUP_CASES`` record in a row of a
    ``stride``-byte tile (cut at the row's end), then ``pads`` rows of
    random bytes (n_cigar under 256) past ``count``, the last holding a
    record whose CIGAR runs past the tile.  Returns (rows uint8 [R,
    stride], lib uint32 [R], count, case names)."""
    rng = np.random.default_rng(seed)
    count = len(MARKDUP_CASES)
    R = count + pads + 1
    rows = rng.integers(0, 256, (R, stride), dtype=np.uint8)
    rows[:, 17] = 0
    lib = rng.integers(0, 4, R).astype(np.uint32)
    for r, (_name, case) in enumerate(MARKDUP_CASES):
        case = dict(case)
        lib[r] = case.pop("lib", lib[r])
        raw = np.frombuffer(markdup_record(rng, **case), np.uint8)[:stride]
        rows[r] = 0
        rows[r, :raw.size] = raw
    raw = np.frombuffer(markdup_record(rng, **_MD_TILE_END), np.uint8)
    rows[-1] = 0
    rows[-1, :min(raw.size, stride)] = raw[:stride]
    return rows, lib, count, tuple(n for n, _ in MARKDUP_CASES)


# K16a's tiles of other shapes than the round's (name, ``markdup_tile``
# keywords): quality runs longer than the kernel's staged bytes, names
# of Illumina's length (runs ending past a round tile's), tiles smaller
# than a warp, and one whose R is not a multiple of a CTA's batch (a
# tile past the persistent grid's first sweep is ``markdup_tile`` at the
# card's size, chip_smoke phase 17 (a))
MARKDUP_TILES: Tuple[Tuple[str, Dict], ...] = (
    ("reads of 400-600 bases, stride 1024",
     dict(n_rows=300, stride=1024, l_seq=(400, 600))),
    ("30-40-byte names", dict(n_rows=300, name_len=(30, 40))),
    ("R = 1", dict(n_rows=1, pads=0)),
    ("R = 7", dict(n_rows=7, pads=2)),
    ("R = 1,031, stride 128", dict(n_rows=1031, stride=128, l_seq=(10, 40))),
)
_TILE_FLAGS = np.array([99, 147, 83, 163, 0, 16, 73, 97, 1123, 355, 2145, 77])
# a tile record's CIGAR: H S M (I | D | N) M S H, each part but the first M
# present at random; a part's code
_TILE_OPS = np.array([5, 4, 0, 1, 0, 4, 5], np.uint32)


def markdup_tile(n_rows: int, seed: int = 0, stride: int = _MD_STRIDE,
                 l_seq: Tuple[int, int] = (151, 151), pads: int = 3,
                 name_len: Optional[Tuple[int, int]] = None
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """A K16a tile of ``n_rows`` rows, built with array ops (any size):
    ``n_rows - pads`` records of random fields and flags (both strands,
    paired and not, secondary, supplementary, unmapped), l_seq drawn from
    ``l_seq``, l_read_name from ``name_len`` (NUL included; None:
    ``NAME_LEN``), a CIGAR of up to seven ops with soft and hard clips at
    either end and an I, D or N inside, qualities 2-41 with runs of 14 /
    15 / 16 and 0xFF, each record cut at its row's end; then ``pads`` rows
    of random bytes (n_cigar under 256).  Returns (rows uint8 [n_rows,
    stride], lib uint32 [n_rows], count)."""
    rng = np.random.default_rng(seed)
    count = max(n_rows - pads, 0)
    rows = rng.integers(0, 256, (n_rows, stride), dtype=np.uint8)
    rows[:, 17] = 0
    lib = rng.integers(0, 4, n_rows).astype(np.uint32)
    n = count
    ls = rng.integers(l_seq[0], l_seq[1] + 1, n)

    def part(lo, hi, share, cap):
        return np.minimum(rng.integers(lo, hi, n), cap) * (rng.random(n)
                                                           < share)
    hl, ht = part(1, 6, 0.2, 1 << 20), part(1, 6, 0.2, 1 << 20)
    sl, st = part(1, 40, 0.4, ls // 4), part(1, 40, 0.4, ls // 4)
    mid = rng.integers(1, 4, n)                    # I, D or N
    ml = part(1, 5, 0.3, ls // 4)
    m = ls - sl - st - np.where(mid == 1, ml, 0)
    m1 = np.where(ml > 0, m // 2, m)
    lens = np.stack([hl, sl, m1, ml, m - m1, st, ht], 1).astype(np.uint32)
    codes = np.broadcast_to(_TILE_OPS, lens.shape).copy()
    codes[:, 3] = mid
    present = lens > 0
    order = np.argsort(~present, axis=1, kind="stable")
    words = np.take_along_axis((lens << 4) | codes, order, 1)
    n_cigar = present.sum(1)

    nl = (np.full(n, NAME_LEN) if name_len is None
          else rng.integers(name_len[0], name_len[1] + 1, n))
    fixed = np.zeros(n, np.dtype([
        ("block_size", "<i4"), ("refid", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_refid", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")]))
    fixed["refid"] = rng.integers(-1, 25, n)
    fixed["pos"] = rng.integers(-1, 2**31 - 1, n)
    fixed["l_read_name"] = nl
    fixed["mapq"], fixed["bin"] = 60, 4680
    fixed["n_cigar"] = n_cigar
    fixed["flag"] = rng.choice(_TILE_FLAGS, n)
    fixed["l_seq"] = ls
    fixed["next_refid"] = rng.integers(-1, 25, n)
    fixed["next_pos"] = rng.integers(-1, 2**31 - 1, n)
    half = (ls + 1) // 2
    cig0 = 36 + nl
    fixed["block_size"] = cig0 - 4 + 4 * n_cigar + half + ls
    body = rows[:count]
    body[:, :min(36, stride)] = fixed.view(np.uint8).reshape(n, 36)[
        :, :stride]
    cols = np.arange(stride, dtype=np.int32)[None, :]
    name = (cols >= 36) & (cols < cig0[:, None])
    body[...] = np.where(name, np.where(cols < cig0[:, None] - 1, ord("m"),
                                        0), body)
    cig = words.astype("<u4").view(np.uint8).reshape(n, 28)
    at = cols - cig0[:, None]
    body[...] = np.where((at >= 0) & (at < 4 * n_cigar[:, None]),
                         cig[np.arange(n)[:, None], np.clip(at, 0, 27)], body)
    q0 = (cig0 + 4 * n_cigar + half)[:, None]
    qual = rng.integers(2, 42, body.shape, dtype=np.uint8)
    edge = rng.random(n) < 0.2
    qual[edge] = np.resize(np.array([14, 15, 16], np.uint8), (stride,))
    qual[rng.random(n) < 0.05] = 0xFF
    body[...] = np.where((cols >= q0) & (cols < q0 + ls[:, None]), qual, body)
    return rows, lib, count


def rows_kmax(rows: np.ndarray) -> int:
    """The largest n_cigar of a tile's rows (pads included)."""
    return int(rows[:, 16:18].copy().view("<u2").max()) if rows.size else 0


MARKDUP_READ_GROUPS = (("grpA", "libA"), ("grpB", "libA"), ("grpC", "libB"))
MARKDUP_COPY_SHARE = 0.10          # pairs that copy an earlier pair
_RG_LIB = np.array([1, 1, 2])      # library numbers of "rg" mode (sorted LB)


def markdup_header() -> SAMHeader:
    text = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in CONTIGS) + "".join(
        f"@RG\tID:{g}\tLB:{lb}\tSM:s1\n" for g, lb in MARKDUP_READ_GROUPS)
    return SAMHeader(text=text, ref_names=[n for n, _ in CONTIGS],
                     ref_lengths=[l for _, l in CONTIGS])


@dataclasses.dataclass
class MarkdupTruth:
    """The generator's columns of ``write_markdup_bam``'s file in file
    order, and each record's expected duplicate bit by library mode
    (``dup["rg"]``, ``dup["none"]``): the oracle's rule applied to the
    generator's own arrays (signature from the known unclipped ends,
    score from the qualities written), never to the file's bytes."""
    flag: np.ndarray               # int64 [n], as written
    refid: np.ndarray              # int64 [n]
    pos: np.ndarray                # int64 [n]
    dup: Dict[str, np.ndarray]     # library_from -> uint8 [n]
    copy_pairs: int

    @property
    def n_reads(self) -> int:
        return int(self.flag.size)

    def output_order(self) -> np.ndarray:
        """Coordinate order with the input index breaking ties: unmapped
        (refid -1) last, pos + 1 wrapped to 32 bits."""
        hi = np.where(self.refid < 0, _U32, self.refid)
        lo = (self.pos + 1) & _U32
        return np.lexsort((np.arange(hi.size), lo, hi))

    def output_flags(self, library_from: str) -> np.ndarray:
        """Each output record's FLAG, in output order, when duplicates
        are marked (not removed)."""
        d = self.dup[library_from].astype(np.int64)
        return ((self.flag & ~FDUP) | (d << 10))[self.output_order()]


_MD_SEQ = (READ_LEN + 1) // 2
# a record's widest layout: prefix and name, two CIGAR words, bases,
# qualities, the RG tag
_MD_COLS = np.arange(_COV_PREFIX + 8 + _MD_SEQ + READ_LEN + 8)
_MD_AUX = np.frombuffer(b"".join(b"RGZ" + g.encode() + b"\x00"
                                 for g, _ in MARKDUP_READ_GROUPS),
                        np.uint8).reshape(len(MARKDUP_READ_GROUPS), 8)


def _markdup_chunk(rec, codes, qual, cigar, l_seq, drop, rg):
    """Raw record bytes of a chunk of reads, and each read's score: all
    reads laid out at the widest layout (``rec``'s prefix and name, two
    CIGAR words, bases and qualities from column ``drop`` on, an RG
    tag), then the columns each read has kept in row order."""
    n = rec.size
    n_cigar = (cigar[:, 1] != 0).astype(np.int64) + 1
    seq_len = (l_seq + 1) // 2
    cut = np.flatnonzero(drop)                 # forward hard clips
    if cut.size:
        k = np.minimum(np.arange(READ_LEN)[None, :] + drop[cut, None],
                       READ_LEN - 1)
        codes[cut] = np.take_along_axis(codes[cut], k, 1)
        qual[cut] = np.take_along_axis(qual[cut], k, 1)
    tail = np.arange(READ_LEN)[None, :] >= l_seq[:, None]
    codes[tail] = 0
    qual[tail] = 0
    head = np.ascontiguousarray(
        rec.view(np.uint8).reshape(n, RECORD.itemsize)[:, :_COV_PREFIX]
    ).view(_COV_HEAD).reshape(n)
    head["block_size"] = 32 + NAME_LEN + 4 * n_cigar + seq_len + l_seq + 8
    head["n_cigar"] = n_cigar
    head["l_seq"] = l_seq
    c = np.concatenate([codes, np.zeros((n, 1), np.uint8)], 1)
    src = np.concatenate([
        head.view(np.uint8).reshape(n, _COV_PREFIX),
        cigar.astype("<u4").view(np.uint8).reshape(n, 8),
        (c[:, 0:READ_LEN:2] << 4) | c[:, 1:READ_LEN + 1:2], qual,
        _MD_AUX[rg]], 1)
    col = _MD_COLS[None, :]
    o = _COV_PREFIX
    keep = (col < o) | ((col >= o) & (col < o + 4 * n_cigar[:, None]))
    o += 8
    keep |= (col >= o) & (col < o + seq_len[:, None])
    o += _MD_SEQ
    keep |= (col >= o) & (col < o + l_seq[:, None])
    keep |= col >= o + READ_LEN
    score = np.where(qual >= 15, qual, 0).sum(1)
    return src[keep], score


def write_markdup_bam(path: str, n_reads: int, seed: int,
                      chunk_pairs: int = 1 << 15) -> MarkdupTruth:
    """Write ``n_reads`` (even) paired reads with duplicates to ``path``
    and return their truth (``MarkdupTruth``).

    The reads have ``write_synthetic_bam``'s fields (151 bp, the same
    contigs and flag mix, its duplicate flags included, which the
    marking clears and re-derives) with uniform A/C/G/T bases and
    qualities 2-41, each pair in one of three read groups over two
    libraries.  About ``MARKDUP_COPY_SHARE`` of the pairs copy an earlier
    pair: the same strands, 5' ends, mate placement and flags (the 0x400
    bit drawn anew), their own bases, qualities and read group (so the
    same library or the other), and on each mapped read a 5' clip of 1-5
    bases (S or H, with pos moved on the forward strand) three times in
    five; the copy's mate fields follow its own mates."""
    if n_reads % 2:
        raise ValueError("n_reads must be even (reads come in pairs)")
    rng = np.random.default_rng(seed)
    P, n = n_reads // 2, n_reads
    is_copy = rng.random(P) < MARKDUP_COPY_SHARE
    is_copy[0] = False
    originals = np.flatnonzero(~is_copy)
    before = np.searchsorted(originals, np.arange(P))
    src = originals[np.minimum((rng.random(P) * before).astype(np.int64),
                               np.maximum(before - 1, 0))]
    rg = rng.integers(0, len(MARKDUP_READ_GROUPS), P)
    clip = np.where(rng.random(n) < 0.6, rng.integers(1, 6, n), 0)
    hard = rng.random(n) < 0.5
    fdup = rng.random(n) < 0.03
    g = {k: np.zeros(n, np.int64) for k in
         ("flag", "refid", "pos", "mate_ref", "mate_pos", "tlen", "mapq",
          "upos", "score")}
    with BamWriter(path, markdup_header()) as w:
        for p0 in range(0, P, chunk_pairs):
            k = min(chunk_pairs, P - p0)
            rec, _cols = _chunk_fields(rng, p0, k)
            codes = _CODES[:4][rng.integers(0, 4, (2 * k, READ_LEN))]
            qual = rng.integers(2, 42, (2 * k, READ_LEN), dtype=np.uint8)
            gi = 2 * p0 + np.arange(2 * k)
            for key, col in (("flag", "flag"), ("refid", "refid"),
                             ("pos", "pos"), ("mate_ref", "mate_refid"),
                             ("mate_pos", "mate_pos"), ("tlen", "tlen"),
                             ("mapq", "mapq")):
                g[key][gi] = rec[col]
            cp = np.repeat(is_copy[p0:p0 + k], 2)
            si = (2 * np.repeat(src[p0:p0 + k], 2)
                  + np.tile([0, 1], k))[cp]
            ci = gi[cp]
            for key in ("refid", "pos", "mate_ref", "mate_pos", "tlen",
                        "mapq"):
                g[key][ci] = g[key][si]
            g["flag"][ci] = (g["flag"][si] & ~FDUP) \
                | np.where(fdup[ci], FDUP, 0)
            flag = g["flag"][gi]
            mapped = (flag & FUNMAP) == 0
            rev = (flag & FREVERSE) != 0
            c = np.where(cp & mapped, clip[gi], 0)
            h = hard[gi] & (c > 0)
            g["pos"][gi] += np.where(rev, 0, c)
            # a copy's unmapped read sits at its mate's new place, and
            # its mate fields name its own mates
            pos = g["pos"][gi].reshape(-1, 2)
            ref = g["refid"][gi].reshape(-1, 2)
            um = (~mapped & ((flag & FMUNMAP) == 0)).reshape(-1, 2)
            pos = np.where(um, pos[:, ::-1], pos)
            g["pos"][gi] = np.where(cp, pos.reshape(-1), g["pos"][gi])
            pos = g["pos"][gi].reshape(-1, 2)
            g["mate_pos"][gi] = np.where(cp, pos[:, ::-1].reshape(-1),
                                         g["mate_pos"][gi])
            g["mate_ref"][gi] = np.where(cp, ref[:, ::-1].reshape(-1),
                                         g["mate_ref"][gi])
            ref_len = READ_LEN - c
            op = np.where(h, 5, 4)
            clip_w = (c << 4) | op
            m_w = ref_len << 4
            cigar = np.stack([np.where(c == 0, m_w, np.where(rev, m_w,
                                                             clip_w)),
                              np.where(c == 0, 0, np.where(rev, clip_w,
                                                           m_w))], 1)
            l_seq = np.where(h, READ_LEN - c, READ_LEN)
            drop = np.where(h & ~rev, c, 0)
            g["upos"][gi] = np.where(rev, g["pos"][gi] + ref_len - 1 + c,
                                     g["pos"][gi] - c)
            for key, col in (("flag", "flag"), ("refid", "refid"),
                             ("pos", "pos"), ("mate_ref", "mate_refid"),
                             ("mate_pos", "mate_pos"), ("tlen", "tlen"),
                             ("mapq", "mapq")):
                rec[col] = g[key][gi]
            p = g["pos"][gi]
            rec["bin"] = np.where(p >= 0, _reg2bin(np.maximum(p, 0),
                                                   np.maximum(p, 0)
                                                   + ref_len), 4680)
            buf, score = _markdup_chunk(rec, codes, qual, cigar, l_seq, drop,
                                        np.repeat(rg[p0:p0 + k], 2))
            g["score"][gi] = score
            w.write_raw(buf.tobytes(), 2 * k)
    return MarkdupTruth(flag=g["flag"], refid=g["refid"], pos=g["pos"],
                        dup={m: _markdup_truth(g, np.repeat(rg, 2), m)
                             for m in ("none", "rg")},
                        copy_pairs=int(is_copy.sum()))


def _markdup_truth(g: Dict[str, np.ndarray], rg: np.ndarray,
                   mode: str) -> np.ndarray:
    """The expected duplicate bits: among eligible reads (mapped,
    primary) of one signature (refid, unclipped 5' end, library, strand
    and pair bits, raw mate key) every read but the best scored (ties to
    the lowest index) is a duplicate."""
    flag = g["flag"]
    idx = np.flatnonzero((flag & (FUNMAP | FSECONDARY | FSUPPLEMENTARY)) == 0)
    f = flag[idx]
    pair = ((f & FPAIRED) != 0) & ((f & FMUNMAP) == 0)
    lib = _RG_LIB[rg[idx]] if mode == "rg" else np.zeros(idx.size, np.int64)
    keys = [g["refid"][idx] & _U32, (g["upos"][idx] + 1) & _U32,
            (lib << 3) | (np.where(pair, (f >> 5) & 1, 0) << 2)
            | (((f >> 4) & 1) << 1) | pair,
            np.where(pair, (g["mate_ref"][idx] + 1) & _U32, 0),
            np.where(pair, (g["mate_pos"][idx] + 1) & _U32, 0)]
    order = np.lexsort([idx, -g["score"][idx]] + keys[::-1])
    same = np.ones(idx.size - 1 if idx.size else 0, bool)
    for key in keys:
        s = key[order]
        same &= s[1:] == s[:-1]
    dup = np.zeros(flag.size, np.uint8)
    dup[idx[order][1:][same]] = 1
    return dup


# ---------------------------------------------------------------------------
# the cohort plane: single-sample call sets and a manifest, and K17a's
# edge cases
# ---------------------------------------------------------------------------

COHORT_CONTIGS: Tuple[Tuple[str, int], ...] = (("20", 63025520),
                                               ("21", 48129895))
COHORT_PRESENCE = 0.6        # (site, sample) pairs with a record
COHORT_MULTI_SHARE = 0.05    # sites with two ALT alleles
COHORT_SPLIT_SHARE = 0.3     # their records listing only the ALTs called
COHORT_SWAP_SHARE = 0.02     # biallelic records written REF/ALT swapped
COHORT_BADREF_SHARE = 0.005  # records with an indel REF at the site
COHORT_DUP_SHARE = 0.01      # records followed by a same-position copy
COHORT_MISSING_SHARE = 0.01  # './.' calls
COHORT_FORMATS = (".vcf", ".vcf.gz", ".bcf")

# record shapes of the generator
_NORMAL, _REVERSED, _SPLIT, _SWAP, _BADREF = range(5)


@dataclasses.dataclass
class CohortTruth:
    """What harmonizing and joining ``write_cohort``'s files must give:
    one row a joined site in (contig, pos) order, ``dosage`` int8
    [sites, samples] (-1 where a sample has no record, a './.' call or a
    record whose REF cannot map), ``chrom`` (index into ``contigs``) and
    ``pos`` int32, ``n_allele`` int16; with the shapes written, counted
    over the records."""
    manifest: str
    sample_ids: Tuple[str, ...]
    paths: Tuple[str, ...]
    contigs: Tuple[str, ...]
    chrom: np.ndarray
    pos: np.ndarray
    n_allele: np.ndarray
    dosage: np.ndarray
    n_records: int = 0
    n_multi_sites: int = 0
    n_swapped: int = 0
    n_badref: int = 0
    n_split: int = 0
    n_reversed: int = 0
    n_duplicates: int = 0
    n_missing_calls: int = 0

    def slice_count(self, contig: int, beg: int, end: int) -> int:
        """Joined sites on ``contig`` with ``beg <= pos <= end``."""
        return int(((self.chrom == contig) & (self.pos >= beg)
                    & (self.pos <= end)).sum())


def _cohort_header(sample_id: str) -> "VCFHeader":
    from hadoop_bam_torch.formats.vcf import VCFHeader
    text = ("##fileformat=VCFv4.2\n"
            + "".join(f"##contig=<ID={c},length={n}>\n"
                      for c, n in COHORT_CONTIGS)
            + '##FORMAT=<ID=GT,Number=1,Type=String,Description='
              '"Genotype">\n'
            + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + sample_id + "\n")
    return VCFHeader.from_text(text)


def _cohort_sites(rng: np.random.Generator, n_sites: int):
    """Site columns: contig, 1-based position (distinct and sorted within
    each contig), REF base index, ALT base indices (the second -1 but at
    a multi-allelic site), the multi-allelic flag and the ALT
    frequency (log-uniform between 0.005 and 0.5)."""
    chrom = np.zeros(n_sites, np.int32)
    chrom[n_sites // 2:] = 1
    pos = np.empty(n_sites, np.int64)
    for c, (_, length) in enumerate(COHORT_CONTIGS):
        sel = chrom == c
        pos[sel] = 60_001 + np.sort(rng.choice(length - 120_000,
                                               int(sel.sum()), replace=False))
    ref = rng.integers(0, 4, n_sites)
    shift = np.argsort(rng.random((n_sites, 3)), axis=1)[:, :2] + 1
    alt = (ref[:, None] + shift) % 4
    multi = rng.random(n_sites) < COHORT_MULTI_SHARE
    alt[~multi, 1] = -1
    p = 10.0 ** rng.uniform(np.log10(0.005), np.log10(0.5), n_sites)
    return chrom, pos, ref, alt, multi, p


def write_cohort(directory: str, n_samples: int, n_sites: int,
                 seed: int) -> CohortTruth:
    """Write a cohort of ``n_samples`` single-sample call sets over a grid
    of ``n_sites`` sites into ``directory`` (sample ``i`` in
    ``COHORT_FORMATS[i % 3]``: text VCF, BGZF VCF or BGZF BCF) and a
    manifest ``cohort.json``; return the truth (``CohortTruth``),
    computed from the generating arrays, not by reading the files back.

    A sample has a record at a site with probability
    ``COHORT_PRESENCE`` (a site no sample has is not a joined row).
    Diploid genotypes at a log-uniform ALT frequency; at the
    ``COHORT_MULTI_SHARE`` multi-allelic sites a record lists both ALTs,
    in either order, or (``COHORT_SPLIT_SHARE``) only those it calls;
    ``COHORT_SWAP_SHARE`` of biallelic records are written with REF and
    ALT swapped (and their genotype indices with them: same dosage),
    ``COHORT_BADREF_SHARE`` carry an indel REF that cannot map (their
    call is missing), ``COHORT_DUP_SHARE`` are followed by a record at
    the same position with another genotype (the first wins) and
    ``COHORT_MISSING_SHARE`` of calls are './.'.  At each site the first
    sample's record is a plain one and the swapped and indel-REF records
    are fewer than the plain ones, so the site's canonical REF is the
    generator's.  Built with NumPy; only each record's bytes are joined
    in Python."""
    import json
    import os

    from hadoop_bam_torch.formats import bgzf
    from hadoop_bam_torch.formats.bcf import encode_header

    rng = np.random.default_rng(seed)
    S, N = int(n_samples), int(n_sites)
    chrom, pos, ref, alt, multi, p = _cohort_sites(rng, N)
    present = rng.random((N, S)) < COHORT_PRESENCE
    # genotypes: allele 0 REF, 1 the first ALT, 2 the second
    carry = rng.random((N, S, 2)) < p[:, None, None]
    second = rng.random((N, S, 2)) < 0.5
    allele = carry.astype(np.int8) + (carry & second
                                      & multi[:, None, None]).astype(np.int8)
    missing = rng.random((N, S)) < COHORT_MISSING_SHARE
    u = rng.random((N, S))
    shape = np.full((N, S), _NORMAL, np.int8)
    shape[multi[:, None] & (u < 0.5)] = _REVERSED
    shape[multi[:, None] & (u < COHORT_SPLIT_SHARE)] = _SPLIT
    swap = ~multi[:, None] & (rng.random((N, S)) < COHORT_SWAP_SHARE)
    shape[swap] = _SWAP
    shape[rng.random((N, S)) < COHORT_BADREF_SHARE] = _BADREF
    shape[~present] = _NORMAL
    # the first sample with a record at a site writes a plain one, and
    # the swapped and indel REFs stay fewer than the canonical one
    rows = np.flatnonzero(present.any(axis=1))
    first = np.argmax(present, axis=1)[rows]
    shape[rows, first] = np.where(shape[rows, first] >= _SWAP, _NORMAL,
                                  shape[rows, first])
    n_plain = (present & (shape <= _SPLIT)).sum(1)
    for k in (_SWAP, _BADREF):
        over = (present & (shape == k)).sum(1) >= n_plain
        shape[over[:, None] & (shape == k)] = _NORMAL
    dup = present & (rng.random((N, S)) < COHORT_DUP_SHARE)
    dup_gt = rng.integers(0, 2, (N, S, 2)).astype(np.int8)
    phased = rng.random((N, S)) < 0.5
    qual = np.where(rng.random((N, S)) < 0.1, -1,
                    rng.integers(1, 100, (N, S)))

    # the truth
    dose = (allele > 0).sum(2).astype(np.int8)
    dose[missing | (shape == _BADREF)] = -1
    dose[~present] = -1
    # bit k - 1 of listed: the record lists ALT k
    lists_all = (shape == _NORMAL) | (shape == _REVERSED)
    listed = np.where(lists_all, np.where(multi, 3, 1)[:, None], 0)
    calls = (allele == 1).any(2) * 1 + (allele == 2).any(2) * 2
    split = shape == _SPLIT
    listed[split] = np.where(calls[split] == 0, 1, calls[split])
    ref_ok = present & (shape <= _SPLIT)
    union = np.bitwise_or.reduce(np.where(ref_ok, listed, 0), axis=1)
    keep = present.any(axis=1)
    n_allele = (1 + (union & 1) + ((union >> 1) & 1)).astype(np.int16)

    bases = "ACGT"
    ids = tuple(f"HG{96 + i:05d}" for i in range(S))
    os.makedirs(directory, exist_ok=True)
    paths = []
    for s in range(S):
        fmt = COHORT_FORMATS[s % len(COHORT_FORMATS)]
        path = os.path.join(directory, f"{ids[s]}{fmt}")
        paths.append(path)
        header = _cohort_header(ids[s])
        sites = np.flatnonzero(present[:, s])
        recs = []        # (chrom, pos, ref, alts, gt indices, phased, qual)
        for i in sites:
            r, a1, a2 = bases[ref[i]], bases[alt[i, 0]], \
                bases[alt[i, 1]] if multi[i] else ""
            k = shape[i, s]
            g = [int(x) for x in allele[i, s]]
            if k == _NORMAL:
                alts = (a1, a2) if multi[i] else (a1,)
            elif k == _REVERSED:
                alts = (a2, a1)
                g = [{0: 0, 1: 2, 2: 1}[x] for x in g]
            elif k == _SPLIT:
                c = int(calls[i, s])
                alts = {0: (a1,), 1: (a1,), 2: (a2,), 3: (a1, a2)}[c]
                if c == 2:
                    g = [1 if x == 2 else 0 for x in g]
            elif k == _SWAP:
                r, alts = a1, (r,)
                g = [1 - x for x in g]
            else:
                r, alts = r + "T", (r,)
                g = [min(x, 1) for x in g]
            if missing[i, s]:
                g = [None, None]
            q = int(qual[i, s])
            recs.append((int(chrom[i]), int(pos[i]), r, alts, g,
                         bool(phased[i, s]), q))
            if dup[i, s]:
                recs.append((int(chrom[i]), int(pos[i]), r, alts,
                             [min(int(x), len(alts)) for x in dup_gt[i, s]],
                             False, q))
        if fmt == ".bcf":
            _write_cohort_bcf(path, header, recs, bgzf, encode_header)
        else:
            text = header.to_text() + "".join(
                f"{COHORT_CONTIGS[c][0]}\t{ps}\t.\t{r}\t{','.join(al)}\t"
                f"{'.' if q < 0 else q}\tPASS\t.\tGT\t"
                + ("|" if ph else "/").join(
                    "." if x is None else str(x) for x in g) + "\n"
                for c, ps, r, al, g, ph, q in recs)
            if fmt == ".vcf":
                with open(path, "w") as f:
                    f.write(text)
            else:
                with open(path, "wb") as f, bgzf.BGZFWriter(f) as w:
                    w.write(text.encode())
    manifest = os.path.join(directory, "cohort.json")
    with open(manifest, "w") as f:
        json.dump({"samples": [{"id": i, "path": os.path.basename(pth)}
                               for i, pth in zip(ids, paths)]}, f)
    return CohortTruth(
        manifest=manifest, sample_ids=ids, paths=tuple(paths),
        contigs=tuple(c for c, _ in COHORT_CONTIGS),
        chrom=chrom[keep], pos=pos[keep].astype(np.int32),
        n_allele=n_allele[keep], dosage=dose[keep],
        n_records=int(present.sum() + dup.sum()),
        n_multi_sites=int((multi & keep).sum()),
        n_swapped=int((present & (shape == _SWAP)).sum()),
        n_badref=int((present & (shape == _BADREF)).sum()),
        n_split=int((present & split).sum()),
        n_reversed=int((present & (shape == _REVERSED)).sum()),
        n_duplicates=int(dup.sum()),
        n_missing_calls=int((present & missing).sum()))


def _write_cohort_bcf(path: str, header, recs, bgzf, encode_header) -> None:
    """One sample's records as a BGZF BCF (GT the one FORMAT field)."""
    key = {s: i for i, s in enumerate(header.string_dictionary())}
    gt_head = _typed_ints([key["GT"]]) + _typed_desc(2, _T_INT8)
    parts = [encode_header(header)]
    for c, ps, r, alts, g, ph, q in recs:
        shared = struct.pack("<iii", c, ps - 1, len(r)) + (
            struct.pack("<I", 0x7F800001) if q < 0
            else struct.pack("<f", float(q))) + struct.pack(
            "<HHI", 0, 1 + len(alts), 1 | (1 << 24))
        shared += _typed_str(".") + _typed_str(r) + b"".join(
            _typed_str(a) for a in alts) + _typed_ints([0])
        gt = bytes(0 if x is None else ((x + 1) << 1) | (j and ph)
                   for j, x in enumerate(g))
        indiv = gt_head + gt
        parts.append(struct.pack("<II", len(shared), len(indiv)) + shared
                     + indiv)
    with open(path, "wb") as f, bgzf.BGZFWriter(f) as w:
        w.write(b"".join(parts))


# K17a's edge cases, shared by the CPU parity tests, the card tests and
# chip_smoke.py phase 18 (a): name -> (cap, n_samples, samples_pad,
# count, phenotype: "normal" | "nan" | "binary" | None, dosage mix)
_GWAS_SPECS: Dict[str, Tuple[int, int, int, int, Optional[str], str]] = {
    "all-missing rows": (64, 300, 304, 64, "normal", "sparse"),
    "polyploid dosages": (64, 300, 304, 64, "normal", "polyploid"),
    "NaN phenotypes": (64, 517, 520, 64, "nan", "diploid"),
    "n_samples < samples_pad": (64, 517, 528, 64, "normal", "diploid"),
    "count < cap": (64, 300, 304, 37, "binary", "diploid"),
    "no phenotype": (64, 300, 304, 64, None, "diploid"),
    "one sample": (16, 1, 8, 16, "normal", "diploid"),
    "main path tile": (3352, 2504, 2504, 3352, "nan", "diploid"),
    "main path 200 rows": (3352, 2504, 2504, 200, "nan", "diploid"),
}
GWAS_CASES: Tuple[str, ...] = tuple(_GWAS_SPECS)


def gwas_case(name: str, seed: int = 0):
    """One K17a case: ``(dosage int8 [1, cap, samples_pad], count,
    pheno float32 [samples_pad] or None, n_samples)``.  Diploid dosages
    at a per-row ALT frequency with ~10% of calls missing (-1); the
    columns at or past ``n_samples`` and the rows at or past ``count``
    hold other values the step must not read (-1..3).  "all-missing
    rows" has rows with no call, one call and one called phenotyped
    sample; "polyploid dosages" dosages up to 6 and some 127;
    phenotypes standard normal ("normal"), with ~20% NaN ("nan"), or
    0/1 with ~5% NaN ("binary")."""
    cap, S, spad, count, pk, mix = _GWAS_SPECS[name]
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 0.6, cap)[:, None]
    d = ((rng.random((cap, spad)) < p).astype(np.int8)
         + (rng.random((cap, spad)) < p).astype(np.int8))
    if mix == "polyploid":
        d = d + rng.integers(0, 5, (cap, spad)).astype(np.int8)
        d[rng.random((cap, spad)) < 0.01] = 127
    d[rng.random((cap, spad)) < 0.1] = -1
    if mix == "sparse":
        d[:8] = -1                           # nothing called
        d[8:12, 1:] = -1                     # one call
        d[8:12, 0] = np.arange(4) % 3
    d[:, S:] = rng.integers(-1, 4, (cap, spad - S))
    d[count:] = rng.integers(-1, 4, (cap - count, spad))
    pheno = None
    if pk is not None:
        if pk == "binary":
            pheno = (rng.random(spad) < 0.4).astype(np.float32)
            pheno[rng.random(spad) < 0.05] = np.nan
        else:
            pheno = rng.standard_normal(spad).astype(np.float32)
            if pk == "nan":
                pheno[rng.random(spad) < 0.2] = np.nan
        pheno[S:] = rng.standard_normal(spad - S).astype(np.float32)
    return d[None], count, pheno, S


# K17b's cases at the serve's tile (``serve_tile_records`` = 4,096 rows of
# 2,504 samples), shared by the card tests and chip_smoke.py phase 18 (a):
# name -> (live rows, interval: "slice" | "none" | "all")
_SLICE_SPECS: Dict[str, Tuple[int, str]] = {
    "200 rows, a slice": (200, "slice"),
    "200 rows, no row kept": (200, "none"),
    "200 rows, every row kept": (200, "all"),
    "4096 rows, a slice": (4096, "slice"),
    "4096 rows, every row kept": (4096, "all"),
}
SLICE_CASES: Tuple[str, ...] = tuple(_SLICE_SPECS)


def slice_case(name: str, seed: int = 0, cap: int = 4096,
               samples_pad: int = 2504):
    """One K17b case: ``(chrom int32 [1, cap], pos int32 [1, cap], dosage
    int8 [1, cap, samples_pad], count int32 [1], iv int32 [3])`` as the
    serve's tiles hold them: rows sorted by (chrom, pos) over two contigs
    (one for "all"), diploid dosages with ~10% of calls missing and ~5%
    of rows with no call (NaN AF; some fall in every interval), rows past
    the count chrom -1, pos 0 and dosage -1.  "slice" keeps the rows of
    contig 0 from a quarter to a half of the live rows' positions, "none"
    asks for a contig no row has, "all" for every position of contig 0."""
    count, kind = _SLICE_SPECS[name]
    rng = np.random.default_rng(seed)
    chrom = np.full((1, cap), -1, np.int32)
    pos = np.zeros((1, cap), np.int32)
    chrom[0, :count] = 0 if kind == "all" else np.sort(
        rng.integers(0, 2, count))
    for c in (0, 1):
        rows = np.flatnonzero(chrom[0, :count] == c)
        pos[0, rows] = np.sort(rng.integers(1, 60_000_000, rows.size))
    p = rng.uniform(0.0, 0.6, cap)[:, None]
    d = ((rng.random((cap, samples_pad)) < p).astype(np.int8)
         + (rng.random((cap, samples_pad)) < p).astype(np.int8))
    d[rng.random((cap, samples_pad)) < 0.1] = -1
    d[rng.random(cap) < 0.05] = -1
    d[count:] = -1
    on0 = pos[0, :count][chrom[0, :count] == 0]
    if kind == "slice":
        iv = [0, int(np.quantile(on0, 0.25)), int(np.quantile(on0, 0.5))]
    elif kind == "none":
        iv = [7, 1, 2 ** 31 - 1]
    else:
        iv = [0, 1, 2 ** 31 - 1]
    return (chrom, pos, d[None], np.asarray([count], np.int32),
            np.asarray(iv, np.int32))
