"""Span inflate + record walk on the host (trimmed copy of
hadoop_bam_tpu/ops/inflate.py).

Three backends for ``inflate_span``:

- ``native``: the C++ library inflates every block of a span at once on
  several threads, and walks records in one pass;
- ``zlib``: Python zlib per block and the Python record walk;
- ``device``: host Huffman tokenize + LZ77 resolve on the card
  (``ops/inflate_device.inflate_span_device``); its walk and CRC checks
  here are the native ones.

All give the same bytes, offsets and error classes for a bad block
(BGZFError).  ``config.resolve_inflate_backend`` picks among them.

``FusedSpanDecode`` is the native plane's single streamed pass (inflate,
walk, pack and CRC fold in one visit of each chunk of blocks); the
two-pass ``inflate_span`` + ``walk_records`` stays as its oracle.
"""
from __future__ import annotations

import zlib
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.utils import native
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError

BACKENDS = ("native", "zlib", "device")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise PlanError(f"unknown inflate backend {backend!r}; "
                        f"expected one of {BACKENDS}")
    return backend


def block_table(raw: bytes, offset: int = 0) -> dict:
    """Parse consecutive BGZF block headers into a columnar table."""
    coffs, cdata_off, cdata_len, isize = [], [], [], []
    p = offset
    n = len(raw)
    while p < n:
        info = bgzf.parse_block_header(raw, p)
        coffs.append(info.coffset)
        cdata_off.append(info.cdata_offset)
        cdata_len.append(info.cdata_size)
        isize.append(info.isize)
        p = info.next_coffset
    return {
        "coffset": np.asarray(coffs, dtype=np.int64),
        "cdata_off": np.asarray(cdata_off, dtype=np.int64),
        "cdata_len": np.asarray(cdata_len, dtype=np.int32),
        "isize": np.asarray(isize, dtype=np.int32),
    }


def inflate_span(raw: bytes, table: Optional[dict] = None,
                 backend: str = "native", n_threads: int = 0, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Inflate all blocks of a compressed span.  Returns (data, ubase):
    the contiguous inflated bytes and each block's start offset in them.
    ``device`` is where the ``device`` backend resolves (``cuda:0`` by
    default)."""
    check_backend(backend)
    if table is None:
        table = block_table(raw)
    if backend == "device":
        from hadoop_bam_torch.ops.inflate_device import inflate_span_device
        return inflate_span_device(raw, table, n_threads=n_threads,
                                   device=device)
    isize = table["isize"]
    ubase = np.zeros(isize.size + 1, dtype=np.int64)
    np.cumsum(isize, out=ubase[1:])
    dst = np.empty(int(ubase[-1]), dtype=np.uint8)
    if backend == "native":
        src = np.frombuffer(raw, dtype=np.uint8)
        try:
            native.inflate_batch(src, table["cdata_off"], table["cdata_len"],
                                 dst, ubase[:-1], isize, n_threads)
        except ValueError as e:
            raise bgzf.BGZFError(str(e)) from e
    else:
        mv = memoryview(raw)
        for i in range(isize.size):
            o, l = int(table["cdata_off"][i]), int(table["cdata_len"][i])
            try:
                out = zlib.decompress(mv[o:o + l], wbits=-15)
            except zlib.error as e:
                raise bgzf.BGZFError(
                    f"corrupt DEFLATE payload in block {i}: {e}") from e
            if len(out) != int(isize[i]):
                raise bgzf.BGZFError(f"ISIZE mismatch in block {i}")
            dst[int(ubase[i]):int(ubase[i + 1])] = np.frombuffer(out,
                                                                 np.uint8)
    return dst, ubase[:-1]


def footer_crcs(src: np.ndarray, table: dict) -> np.ndarray:
    """Each block's expected CRC32, read from its BGZF footer."""
    foot = table["cdata_off"] + table["cdata_len"]
    return (src[foot].astype(np.uint32)
            | (src[foot + 1].astype(np.uint32) << 8)
            | (src[foot + 2].astype(np.uint32) << 16)
            | (src[foot + 3].astype(np.uint32) << 24))


def verify_crcs(raw: bytes, table: dict, data: np.ndarray,
                ubase: np.ndarray, backend: str = "native") -> None:
    """Check every block's CRC32 footer against the inflated bytes."""
    check_backend(backend)
    n = table["isize"].size
    expect = footer_crcs(np.frombuffer(raw, dtype=np.uint8), table)
    if backend != "zlib":
        got = native.crc32_batch(data, ubase, table["isize"])
    else:
        got = np.empty(n, dtype=np.uint32)
        for i in range(n):
            s = int(ubase[i])
            got[i] = zlib.crc32(data[s:s + int(table["isize"][i])]) \
                & 0xFFFFFFFF
    bad = np.nonzero(got != expect)[0]
    if bad.size:
        raise bgzf.BGZFError(f"CRC32 mismatch in block(s) {bad[:8].tolist()}")


def walk_records(data: np.ndarray, start: int = 0, backend: str = "native"
                 ) -> Tuple[np.ndarray, int]:
    """Record-boundary walk over inflated bytes.  Returns (offsets, tail):
    ``tail`` is the offset of the first record cut by the buffer end
    (== len(data) when the walk consumed everything)."""
    check_backend(backend)
    data = np.ascontiguousarray(data)
    if backend != "zlib":
        # min on-wire record = 4-byte block_size + 32-byte core
        return native.walk_bam_records(data, start,
                                       max(16, data.size // 36 + 1))
    from hadoop_bam_torch.formats.bam import walk_record_offsets
    offs = walk_record_offsets(data, start=start)
    if not offs.size:
        return offs, start
    last = int(offs[-1])
    bs = int.from_bytes(data[last:last + 4].tobytes(), "little", signed=True)
    return offs, last + 4 + bs


# ---------------------------------------------------------------------------
# Fused single-pass span decode (native/hbam_native.cpp hbam_fused_*)
# ---------------------------------------------------------------------------

def fused_available() -> bool:
    """Are the native fused decode entry points loadable?"""
    return native.fused_available()


def _raise_fused_error(rc: int, index: int) -> None:
    """A fused rc -> the exception class the two-pass path raises for the
    same corruption: BGZF faults BGZFError, record-chain faults
    CorruptDataError (the two-pass walkers' ValueError classifies the
    same, CORRUPT)."""
    kind = -rc
    if kind == 1:
        raise bgzf.BGZFError(f"corrupt DEFLATE payload in block {index}")
    if kind == 2:
        raise bgzf.BGZFError(f"ISIZE mismatch in block {index}")
    if kind == 3:
        raise bgzf.BGZFError(f"CRC32 mismatch in block(s) [{index}]")
    if kind == 5:
        raise CorruptDataError(
            f"record count exceeds capacity at offset {index}")
    raise CorruptDataError("malformed BAM record chain")


class FusedSpanDecode:
    """One span's fused native inflate + walk + pack (+ CRC fold) job::

        dec = FusedSpanDecode(raw, table, start=s, stop=e, mode="rows",
                              sel=ranges, row_stride=w, check_crc=True)
        for lo, hi in dec.chunks():
            consume(dec.rows[lo:hi])      # packed while cache-hot
        n, tail = dec.finish()

    ``chunks()`` yields ``[row_lo, row_hi)`` as the native walk publishes
    them, so tiles pack before the span's last blocks are inflated.
    After ``finish()``: ``data`` is the inflated span, ``offsets[:n]``
    the record starts, and ``rows`` or ``prefix`` / ``seq`` / ``qual``
    the packed outputs.  Corruption raises what the two-pass path
    raises; closing ``chunks()`` early joins the native workers.

    Modes: ``"offsets"`` (walk only), ``"rows"`` (the ``sel`` ranges of
    each fixed prefix in ``row_stride``-byte rows), ``"payload"``
    (prefix, seq and qual tiles, ``hbam_walk_bam_payload``'s layout)."""

    def __init__(self, raw: bytes, table: Optional[dict] = None, *,
                 start: int = 0, stop: Optional[int] = None,
                 mode: str = "offsets",
                 sel: Optional[Sequence[Tuple[int, int]]] = None,
                 row_stride: int = 0, max_len: int = 0, seq_stride: int = 0,
                 qual_stride: int = 0, check_crc: bool = False,
                 chunk_blocks: int = 32, n_threads: int = 0):
        if table is None:
            table = block_table(raw)
        isize = table["isize"]
        ubase = np.zeros(isize.size + 1, dtype=np.int64)
        np.cumsum(isize, out=ubase[1:])
        total = int(ubase[-1])
        self.data = np.empty(total, dtype=np.uint8)
        self.ubase = ubase[:-1]
        self.stop = total if stop is None else min(int(stop), total)
        self.rows = self.prefix = self.seq = self.qual = None
        src = np.frombuffer(raw, dtype=np.uint8)
        expect = footer_crcs(src, table) if check_crc else None
        cap = max(16, (self.stop - start) // 36 + 1)
        self.offsets = np.empty(cap, dtype=np.int64)
        mode_id = {"offsets": native.FUSED_OFFSETS,
                   "rows": native.FUSED_ROWS,
                   "payload": native.FUSED_PAYLOAD}[mode]
        sel_off = sel_len = out_rows = out_seq = out_qual = None
        if mode == "rows":
            sel_off = np.asarray([o for o, _ in sel], dtype=np.int32)
            sel_len = np.asarray([w for _, w in sel], dtype=np.int32)
            self.rows = out_rows = np.empty((cap, row_stride),
                                            dtype=np.uint8)
        elif mode == "payload":
            # zeroed as the two-pass wrappers zero them: the native pass
            # writes only each row's payload bytes
            self.prefix = out_rows = np.zeros((cap, 36), dtype=np.uint8)
            self.seq = out_seq = np.zeros((cap, seq_stride), dtype=np.uint8)
            self.qual = out_qual = np.zeros((cap, qual_stride),
                                            dtype=np.uint8)
        self.n_blocks = int(isize.size)
        self.n_rows: Optional[int] = None
        self.tail: Optional[int] = None
        if self.n_blocks == 0:
            self._job = None
            self.n_rows, self.tail = 0, int(start)
            return
        self._job = native.FusedJob(
            src, table["cdata_off"], table["cdata_len"], isize, expect,
            self.data, self.ubase, start, self.stop, mode_id, sel_off,
            sel_len, row_stride, out_rows, out_seq, out_qual, max_len,
            seq_stride, qual_stride, self.offsets, chunk_blocks, n_threads)

    def chunks(self) -> Iterator[Tuple[int, int]]:
        """``(row_lo, row_hi)`` as the native walk completes them; raises
        on corruption.  Closing the generator early cancels and joins
        the workers."""
        if self._job is None:
            return
        try:
            while True:
                c = self._job.next_chunk()
                if c is None:
                    if self._job.rc < 0:
                        _raise_fused_error(self._job.rc,
                                           self._job.err_index)
                    return
                yield c
        finally:
            if self.n_rows is None:
                self.finish(check=False)

    def finish(self, check: bool = True) -> Tuple[int, int]:
        """Join the job; returns (n_rows, tail).  ``check=False`` skips
        raising (the cancellation path)."""
        if self._job is not None:
            rc = self._job.finish()
            self.n_rows, self.tail = self._job.n_rows, self._job.tail
            idx = self._job.err_index
            self._job = None
            if check and rc < 0:
                _raise_fused_error(rc, idx)
        return self.n_rows, self.tail

    def run(self) -> Tuple[int, int]:
        """Not streamed: drain every chunk, then finish."""
        for _ in self.chunks():
            pass
        return self.finish()
