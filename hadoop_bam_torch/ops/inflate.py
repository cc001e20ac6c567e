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
"""
from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.utils import native
from hadoop_bam_torch.utils.errors import PlanError

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
