"""Read datasets: the FASTQ / QSEQ / FASTA input formats as iterators, and
their device feeds (counterpart of hadoop_bam_tpu/api/read_datasets.py).

    ds = open_fastq("reads.fastq")             # cuda:0
    ds = open_fastq("reads.fastq.gz", device="cpu")
    for frag in ds.records(): ...              # SequencedFragment
    for b in ds.tensor_batches(): ...          # torch tensors on the device
    open_qseq("reads.qseq").tensor_batches()
    open_fasta("ref.fa").window_tensor_batches(window=1024)

Spans follow hb/FastqInputFormat.java, hb/QseqInputFormat.java and
hb/FastaInputFormat.java: plain byte splits aligned to records when
read (FASTQ, QSEQ), or snapped to ``>`` headers when planned (FASTA).
Gzipped FASTQ / QSEQ reads as one span over the inflated text, as
Hadoop reads a file in a codec it cannot split.  The packers below turn
reads into the BAM payload tile layout (4-bit bases two a byte, Phred
bytes), so K2 serves every read format; they are host NumPy code.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.device import resolve_device
from hadoop_bam_torch.formats.fasta import ReferenceFragment, parse_fasta
from hadoop_bam_torch.formats.fastq import (
    FastqError, SequencedFragment, parse_fastq,
)
from hadoop_bam_torch.formats.qseq import parse_qseq
from hadoop_bam_torch.split.planners import plan_text_spans, read_text_span
from hadoop_bam_torch.split.read_planners import (
    plan_fasta_spans, read_fasta_span, read_fastq_span,
)
from hadoop_bam_torch.split.spans import FileByteSpan
from hadoop_bam_torch.utils.seekable import scoped_byte_source


class _SpannedDataset:
    """Span bookkeeping shared by the read datasets, with checkpoint and
    resume (``state_dict`` / ``load_state_dict``)."""

    def __init__(self, path: str, device=None,
                 config: HBamConfig = DEFAULT_CONFIG):
        self.path = path
        self.device = resolve_device(device)
        self.config = config
        self._plan: Optional[List[FileByteSpan]] = None
        self._plan_num_spans: Optional[int] = None
        self._next_span = 0
        self._compressed: Optional[bool] = None

    def read_span(self, span: FileByteSpan) -> List:
        raise NotImplementedError

    def _iter_spans(self, num_spans: Optional[int]) -> Iterator:
        """Resumable iteration, a span at a time (the state is the spans
        delivered).  A call after the plan is exhausted starts over; a
        call after ``load_state_dict`` resumes mid-plan."""
        plan = self.spans(num_spans)
        if self._next_span >= len(plan):
            self._next_span = 0
        while self._next_span < len(plan):
            recs = self.read_span(plan[self._next_span])
            self._next_span += 1
            yield from recs

    def _is_compressed(self) -> bool:
        """gzip (or BGZF) input?  Read as ONE span over the inflated text."""
        if self._compressed is None:
            with scoped_byte_source(self.path) as src:
                self._compressed = src.pread(0, 2) == b"\x1f\x8b"
        return self._compressed

    def _plan_spans(self, num_spans: Optional[int]) -> List[FileByteSpan]:
        if self._is_compressed():
            with scoped_byte_source(self.path) as src:
                return [FileByteSpan(self.path, 0, src.size)]
        return plan_text_spans(self.path, num_spans=num_spans,
                               span_bytes=None if num_spans
                               else self.config.split_size)

    def _span_text(self, span: FileByteSpan, reader) -> bytes:
        """A span's text through ``reader(path, span)``, or the whole
        inflated file for the one span of a compressed input."""
        if span.start == 0 and self._is_compressed():
            import gzip
            with open(self.path, "rb") as f:
                return gzip.decompress(f.read())
        return reader(self.path, span)

    def spans(self, num_spans: Optional[int] = None) -> List[FileByteSpan]:
        """The dataset's byte spans, planned once; another ``num_spans``
        raises ValueError (open a new dataset to re-plan)."""
        if self._plan is not None and num_spans is not None \
                and num_spans != self._plan_num_spans:
            raise ValueError(
                f"span plan already built with num_spans="
                f"{self._plan_num_spans}; open a new dataset to re-plan")
        if self._plan is None:
            self._plan = self._plan_spans(num_spans)
            self._plan_num_spans = num_spans
        return self._plan

    def state_dict(self) -> Dict:
        return {"path": self.path,
                "plan": [s.to_dict() for s in (self._plan or [])],
                "next_span": self._next_span}

    def load_state_dict(self, state: Dict) -> None:
        if state["path"] != self.path:
            raise ValueError(f"state of {state['path']!r}, not of "
                             f"{self.path!r}")
        self._plan = [FileByteSpan.from_dict(d) for d in state["plan"]] \
            or None
        self._next_span = int(state["next_span"])


class FastqDataset(_SpannedDataset):
    """Splittable FASTQ: every span boundary aligned to a record (the
    @/+ heuristic); compressed input reads as one span."""

    def read_span_text(self, span: FileByteSpan) -> bytes:
        """A span's record-aligned text (the whole file when gzipped): the
        input of both the object parse and the vectorized packer."""
        return self._span_text(span, read_fastq_span)

    def read_span(self, span: FileByteSpan) -> List[SequencedFragment]:
        return parse_fastq(self.read_span_text(span),
                           encoding=self.config.fastq_base_quality_encoding,
                           filter_failed_qc=self.config.fastq_filter_failed_qc)

    def records(self, num_spans: Optional[int] = None
                ) -> Iterator[SequencedFragment]:
        return self._iter_spans(num_spans)

    def tensor_batches(self, geometry=None, num_spans: Optional[int] = None
                       ) -> Iterator[Dict]:
        """Read batches on the dataset's device, n_dev = 1:
        ``seq_packed`` uint8 [1, rows, seq_stride] (BAM 4-bit codes, as
        ``BamDataset.tensor_batches``), ``qual`` uint8 [1, rows,
        qual_stride], ``lengths`` int32 [1, rows], ``n_records`` int32
        [1].  ``rows`` is geometry.tile_records except in the final batch,
        which shrinks to the smallest bucket that holds it unless
        ``geometry.fixed_shape``.  Each batch's tensors are the
        consumer's own."""
        from hadoop_bam_torch.parallel.pipeline import (
            stream_read_tensor_batches,
        )
        yield from stream_read_tensor_batches(
            self.spans(num_spans), self.read_span, self.config, self.device,
            geometry)


class QseqDataset(_SpannedDataset):
    """Illumina qseq: one record a line."""

    def read_span_text(self, span: FileByteSpan) -> bytes:
        return self._span_text(span, read_text_span)

    def read_span(self, span: FileByteSpan) -> List[SequencedFragment]:
        return parse_qseq(self.read_span_text(span),
                          encoding=self.config.qseq_base_quality_encoding,
                          filter_failed_qc=self.config.qseq_filter_failed_qc)

    def records(self, num_spans: Optional[int] = None
                ) -> Iterator[SequencedFragment]:
        return self._iter_spans(num_spans)

    def tensor_batches(self, geometry=None, num_spans: Optional[int] = None
                       ) -> Iterator[Dict]:
        """The layout of ``FastqDataset.tensor_batches``."""
        from hadoop_bam_torch.parallel.pipeline import (
            stream_read_tensor_batches,
        )
        yield from stream_read_tensor_batches(
            self.spans(num_spans), self.read_span, self.config, self.device,
            geometry)


class FastaDataset(_SpannedDataset):
    """Reference FASTA: spans hold whole contigs (snapped to '>')."""

    def _plan_spans(self, num_spans: Optional[int]) -> List[FileByteSpan]:
        return plan_fasta_spans(self.path, num_spans=num_spans,
                                config=self.config)

    def read_span(self, span: FileByteSpan) -> List[ReferenceFragment]:
        return parse_fasta(read_fasta_span(self.path, span))

    def fragments(self, num_spans: Optional[int] = None
                  ) -> Iterator[ReferenceFragment]:
        return self._iter_spans(num_spans)

    def window_tensor_batches(self, window: int = 1024, stride: int = 0,
                              geometry=None,
                              num_spans: Optional[int] = None
                              ) -> Iterator[Dict]:
        """Reference windows as device tensors: each contig cut into
        ``window``-base pieces every ``stride`` bases (default: stride =
        window, no overlap; a contig's last full window is always
        included) and packed as the read feeds pack reads, quality rows
        zero.  Yields the ``FastqDataset.tensor_batches`` layout; the
        geometry defaults to ``PayloadGeometry(max_len=window)``."""
        from hadoop_bam_torch.parallel.pipeline import (
            PayloadGeometry, stream_read_tensor_batches,
        )

        stride = stride or window
        if geometry is None:
            geometry = PayloadGeometry(max_len=window)

        def read_windows(span) -> List[SequencedFragment]:
            out: List[SequencedFragment] = []
            # a span holds whole contigs, each contig's fragments in order
            per_contig: Dict[str, List[ReferenceFragment]] = {}
            for frag in self.read_span(span):
                per_contig.setdefault(frag.contig, []).append(frag)
            for frags in per_contig.values():
                seq = "".join(f.sequence for f in frags)
                n = len(seq)
                if not n:
                    continue
                if n <= window:
                    out.append(SequencedFragment(sequence=seq, quality=""))
                    continue
                last = n - window
                starts = list(range(0, last + 1, stride))
                if starts[-1] != last:
                    starts.append(last)   # the final full window
                for off in starts:
                    out.append(SequencedFragment(
                        sequence=seq[off:off + window], quality=""))
            return out

        yield from stream_read_tensor_batches(
            self.spans(num_spans), read_windows, self.config, self.device,
            geometry)


def open_fastq(path: str, device=None,
               config: HBamConfig = DEFAULT_CONFIG) -> FastqDataset:
    """Open a FASTQ (plain or gzipped) for ``cuda:0`` (or ``device``)."""
    return FastqDataset(path, device=device, config=config)


def open_qseq(path: str, device=None,
              config: HBamConfig = DEFAULT_CONFIG) -> QseqDataset:
    """Open a QSEQ (plain or gzipped) for ``cuda:0`` (or ``device``)."""
    return QseqDataset(path, device=device, config=config)


def open_fasta(path: str, device=None,
               config: HBamConfig = DEFAULT_CONFIG) -> FastaDataset:
    """Open a reference FASTA for ``cuda:0`` (or ``device``)."""
    return FastaDataset(path, device=device, config=config)


# ---------------------------------------------------------------------------
# host packers: reads -> payload tiles
# ---------------------------------------------------------------------------

# Unknown/ambiguity characters (IUPAC codes, gaps) map to N (4), never to a
# confident base; 5 is reserved for padding.
_BASE_CODE = np.full(256, 4, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    _BASE_CODE[ord(c)] = i
    _BASE_CODE[ord(c.lower())] = i


# ASCII -> BAM 4-bit base codes [SPEC]: the same nibble alphabet the BAM
# payload tiles use, so one stats kernel (ops/seq_stats.py, K2) serves
# every read format.  Unknown characters map to N (15).
_NIBBLE_CODE = np.full(256, 15, dtype=np.uint8)
for _c, _code in (("=", 0), ("A", 1), ("C", 2), ("M", 3), ("G", 4),
                  ("R", 5), ("S", 6), ("V", 7), ("T", 8), ("W", 9),
                  ("Y", 10), ("H", 11), ("K", 12), ("D", 13), ("B", 14),
                  ("N", 15)):
    _NIBBLE_CODE[ord(_c)] = _code
    _NIBBLE_CODE[ord(_c.lower())] = _code


def _scan_lines(buf: np.ndarray) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Newline scan -> CRLF-safe (starts, ends, synthesized_last) line
    table.  A final line without a terminating newline still counts as a
    line; ``synthesized_last`` marks it so callers can drop only THAT
    line when it is empty (a real empty line must be kept or rejected by
    format-specific rules)."""
    nl = np.flatnonzero(buf == 0x0A)
    synthesized_last = nl.size == 0 or nl[-1] != buf.size - 1
    if synthesized_last:
        nl = np.append(nl, buf.size)
    starts = np.empty(nl.size, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.copy()
    has_cr = (ends > starts) & (buf[np.minimum(ends - 1, buf.size - 1)]
                                == 0x0D)
    ends = ends - has_cr
    return starts, ends, synthesized_last


def _pack_seq_qual_tiles(buf: np.ndarray, seq_starts: np.ndarray,
                         qual_starts: np.ndarray, lengths: np.ndarray,
                         seq_stride: int, qual_stride: int,
                         qual_offset: int,
                         guard_lens: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Gather per-record SEQ/QUAL runs into payload tiles: nibble-code +
    pair-pack the bases, re-base the qualities with the wrong-encoding
    guard (shared by the FASTQ and QSEQ grid tokenizers — their behavior
    must stay byte-identical, so this is one function).

    ``guard_lens`` is the UNTRUNCATED quality-field length per record:
    the object parsers (convert_quality) validate the whole string, not
    just the max_len prefix the tiles keep, so the guard must too."""
    n = lengths.size
    seq = np.zeros((n, seq_stride), dtype=np.uint8)
    qual = np.zeros((n, qual_stride), dtype=np.uint8)
    if qual_offset != 33 and n and guard_lens is not None \
            and guard_lens.size:
        Lg = int(guard_lens.max())
        if Lg:
            colg = np.arange(Lg, dtype=np.int64)[None, :]
            maskg = colg < guard_lens[:, None]
            gg = np.minimum(qual_starts[:, None] + colg, buf.size - 1)
            vals = buf[gg].astype(np.int16) - qual_offset
            # mirror convert_quality: re-based ASCII must stay printable,
            # i.e. Phred in [0, 93], over the FULL field
            bad = maskg & ((vals < 0) | (vals > 93))
            if bad.any():
                raise FastqError(
                    "quality out of range after re-encoding — wrong "
                    "base-quality-encoding config?")
    L = int(lengths.max()) if n else 0
    if not L:
        return seq, qual
    L_even = L + (L & 1)
    col = np.arange(L_even, dtype=np.int64)[None, :]
    mask = col < lengths[:, None]
    g = np.minimum(seq_starts[:, None] + col, buf.size - 1)
    codes = np.where(mask, _NIBBLE_CODE[buf[g]], 0).astype(np.uint8)
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
    ks = min(packed.shape[1], seq_stride)
    seq[:, :ks] = packed[:, :ks]

    gq = np.minimum(qual_starts[:, None] + col[:, :L], buf.size - 1)
    q = np.where(mask[:, :L], buf[gq].astype(np.int16) - qual_offset, 0)
    kq = min(L, qual_stride)
    qual[:, :kq] = np.clip(q, 0, 255).astype(np.uint8)[:, :kq]
    return seq, qual


def fastq_text_to_payload_tiles(text: bytes, seq_stride: int,
                                qual_stride: int, max_len: int,
                                qual_offset: int = 33
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Vectorized FASTQ span -> payload tiles, no per-read Python objects.

    The stats drivers only need (packed bases, qualities, lengths); going
    through parse_fastq costs a SequencedFragment (with run-metadata name
    parsing) per read and dominates the FASTQ pipeline wall clock.  This
    path tokenizes the whole span with NumPy: newline scan -> line table ->
    4-line record grid -> one clamped gather per payload matrix.

    Validation matches parse_fastq's strictness where cheap (4n lines,
    '@'/'+' leads, SEQ/QUAL length equality); it raises the same FastqError.
    """
    buf = np.frombuffer(text, dtype=np.uint8)
    if buf.size == 0:
        return (np.zeros((0, seq_stride), np.uint8),
                np.zeros((0, qual_stride), np.uint8),
                np.zeros((0,), np.int32))
    starts, ends, synthesized_last = _scan_lines(buf)
    # drop only the synthesized final line when empty — a real
    # zero-length final line (legal zero-length read) must be kept
    if synthesized_last and starts[-1] >= ends[-1]:
        starts, ends = starts[:-1], ends[:-1]
    if starts.size % 4:
        raise FastqError(f"FASTQ span has {starts.size} lines (not 4n)")
    n = starts.size // 4
    if n == 0:
        return (np.zeros((0, seq_stride), np.uint8),
                np.zeros((0, qual_stride), np.uint8),
                np.zeros((0,), np.int32))
    s4 = starts.reshape(n, 4)
    e4 = ends.reshape(n, 4)
    if not (buf[s4[:, 0]] == ord("@")).all() \
            or not (buf[s4[:, 2]] == ord("+")).all():
        bad = int(np.flatnonzero((buf[s4[:, 0]] != ord("@"))
                                 | (buf[s4[:, 2]] != ord("+")))[0])
        raise FastqError(f"malformed FASTQ record at line {bad * 4}")
    seq_len = e4[:, 1] - s4[:, 1]
    if not (seq_len == e4[:, 3] - s4[:, 3]).all():
        raise FastqError("SEQ/QUAL length mismatch")
    lengths = np.minimum(seq_len, max_len).astype(np.int32)
    seq, qual = _pack_seq_qual_tiles(buf, s4[:, 1], s4[:, 3], lengths,
                                     seq_stride, qual_stride, qual_offset,
                                     guard_lens=seq_len)
    return seq, qual, lengths


def qseq_text_to_payload_tiles(text: bytes, seq_stride: int,
                               qual_stride: int, max_len: int,
                               qual_offset: int = 64
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Vectorized QSEQ span -> payload tiles (the 11-tab-field twin of
    fastq_text_to_payload_tiles): newline/tab grid -> one gather each for
    the SEQ (field 8; '.' reads as N via the nibble table) and QUAL
    (field 9, Illumina +64 by default) columns.  Validation matches
    parse_qseq: exactly 11 fields, SEQ/QUAL equal length, loud
    wrong-encoding guard."""
    buf = np.frombuffer(text, dtype=np.uint8)
    empty = (np.zeros((0, seq_stride), np.uint8),
             np.zeros((0, qual_stride), np.uint8),
             np.zeros((0,), np.int32))
    if buf.size == 0:
        return empty
    starts, ends, _synth = _scan_lines(buf)
    keep = ends > starts                    # parse_qseq skips empty lines
    starts, ends = starts[keep], ends[keep]
    n = starts.size
    if n == 0:
        return empty

    tabs = np.flatnonzero(buf == 0x09)
    t0 = np.searchsorted(tabs, starts)
    t1 = np.searchsorted(tabs, ends)
    ntab = t1 - t0
    if not (ntab == 10).all():
        bad = int(np.flatnonzero(ntab != 10)[0])
        raise FastqError(f"qseq line has {int(ntab[bad]) + 1} fields, "
                         f"need 11")
    k = np.arange(10, dtype=np.int64)[None, :]
    tabm = tabs[t0[:, None] + k]
    fs = np.concatenate([starts[:, None], tabm + 1], axis=1)
    fe = np.concatenate([tabm, ends[:, None]], axis=1)
    seq_len = fe[:, 8] - fs[:, 8]
    qual_len = fe[:, 9] - fs[:, 9]
    if not (seq_len == qual_len).all():
        raise FastqError("qseq SEQ/QUAL length mismatch")
    lengths = np.minimum(seq_len, max_len).astype(np.int32)
    seq, qual = _pack_seq_qual_tiles(buf, fs[:, 8], fs[:, 9], lengths,
                                     seq_stride, qual_stride, qual_offset,
                                     guard_lens=seq_len)
    return seq, qual, lengths


def ragged_to_payload_tiles(seq_cat: bytes, seq_lens: np.ndarray,
                            qual_cat: bytes, qual_lens: np.ndarray,
                            seq_stride: int, qual_stride: int,
                            max_len: int, qual_offset: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenated ragged sequences/qualities -> payload tiles, fully
    vectorized (the packing half of fastq_text_to_payload_tiles, for
    producers that already hold decoded bytes — e.g. CRAM records).

    ``qual_cat`` holds per-record quality runs of ``qual_lens`` bytes;
    ``qual_offset`` is subtracted (0 when the bytes are already raw
    Phred, 33 for printable ASCII).  Records with no quality simply have
    qual_lens 0 — their tile rows stay zero."""
    n = seq_lens.size
    seq = np.zeros((n, seq_stride), dtype=np.uint8)
    qual = np.zeros((n, qual_stride), dtype=np.uint8)
    lengths = np.minimum(seq_lens, max_len).astype(np.int32)
    if n == 0:
        return seq, qual, lengths
    sbuf = np.frombuffer(seq_cat, dtype=np.uint8)
    qbuf = np.frombuffer(qual_cat, dtype=np.uint8)
    s0 = np.cumsum(seq_lens, dtype=np.int64) - seq_lens
    q0 = np.cumsum(qual_lens, dtype=np.int64) - qual_lens

    L = int(lengths.max())
    if L:
        # uniform read length (the overwhelmingly common case): the
        # concatenated buffer IS the (n, len) matrix — reshape instead
        # of building per-row gather/mask matrices
        if int(seq_lens.min()) == int(seq_lens.max()):
            rl0 = int(seq_lens[0])
            mat = sbuf[:n * rl0].reshape(n, rl0)[:, :L]
            codes = _NIBBLE_CODE[mat]
            if L & 1:
                codes = np.concatenate(
                    [codes, np.zeros((n, 1), np.uint8)], axis=1)
        else:
            L_even = L + (L & 1)
            col = np.arange(L_even, dtype=np.int64)[None, :]
            mask = col < lengths[:, None]
            g = np.minimum(s0[:, None] + col, max(sbuf.size - 1, 0))
            codes = np.where(mask, _NIBBLE_CODE[sbuf[g]], 0
                             ).astype(np.uint8)
        packed = (codes[:, 0::2] << 4) | codes[:, 1::2]
        ks = min(packed.shape[1], seq_stride)
        seq[:, :ks] = packed[:, :ks]

    qlen = np.minimum(qual_lens, max_len).astype(np.int64)
    Lq = int(qlen.max(initial=0))
    if Lq and qbuf.size:
        kq = min(Lq, qual_stride)
        if int(qual_lens.min()) == int(qual_lens.max()):
            ql0 = int(qual_lens[0])
            mat = qbuf[:n * ql0].reshape(n, ql0)[:, :kq]
            if qual_offset:
                qual[:, :kq] = np.clip(
                    mat.astype(np.int16) - qual_offset, 0, 255
                ).astype(np.uint8)
            else:
                qual[:, :kq] = mat
        else:
            colq = np.arange(Lq, dtype=np.int64)[None, :]
            maskq = colq < qlen[:, None]
            gq = np.minimum(q0[:, None] + colq, qbuf.size - 1)
            vals = np.where(maskq, qbuf[gq].astype(np.int16)
                            - qual_offset, 0)
            qual[:, :kq] = np.clip(vals, 0, 255).astype(np.uint8)[:, :kq]
    return seq, qual, lengths


def fragments_to_payload_tiles(frags: List[SequencedFragment],
                               seq_stride: int, qual_stride: int,
                               max_len: int
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """Pack reads into the BAM-payload tile layout (4-bit bases, 2/byte,
    high nibble first; Phred quality bytes) — the FASTQ/QSEQ entry into
    the device payload path.  Returns (seq [n, seq_stride] uint8,
    qual [n, qual_stride] uint8, lengths [n] int32)."""
    n = len(frags)
    seq = np.zeros((n, seq_stride), dtype=np.uint8)
    qual = np.zeros((n, qual_stride), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, f in enumerate(frags):
        l = min(len(f.sequence), max_len)
        lengths[i] = l
        raw = np.frombuffer(f.sequence[:l].encode("latin-1"), np.uint8)
        codes = _NIBBLE_CODE[raw]
        if l % 2:
            codes = np.concatenate([codes, np.zeros(1, np.uint8)])
        packed = (codes[0::2] << 4) | codes[1::2]
        seq[i, :packed.size] = packed
        q = np.frombuffer(f.quality[:l].encode("latin-1"), np.uint8)
        qual[i, :q.size] = q - 33  # quality may be absent (FASTA windows)
    return seq, qual, lengths


def fragments_to_arrays(frags: List[SequencedFragment], max_len: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad/truncate reads into fixed shapes for the device:
    (bases [n, max_len] uint8 codes A0 C1 G2 T3 N4 pad5,
     quals [n, max_len] uint8 Phred values, lengths [n] int32)."""
    n = len(frags)
    bases = np.full((n, max_len), 5, dtype=np.uint8)
    quals = np.zeros((n, max_len), dtype=np.uint8)
    lengths = np.zeros(n, dtype=np.int32)
    for i, f in enumerate(frags):
        l = min(len(f.sequence), max_len)
        lengths[i] = l
        seq = np.frombuffer(f.sequence[:l].encode("latin-1"), dtype=np.uint8)
        bases[i, :l] = _BASE_CODE[seq]
        q = np.frombuffer(f.quality[:l].encode("latin-1"), dtype=np.uint8)
        quals[i, :l] = q - 33
    return bases, quals, lengths
