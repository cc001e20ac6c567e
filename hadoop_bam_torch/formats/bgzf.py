"""BGZF block-compression layer (trimmed copy of hadoop_bam_tpu/formats/bgzf.py).

[SPEC] SAMv1 section 4.1: BGZF is a series of gzip members, each with an
FEXTRA subfield ``SI1=66 ('B'), SI2=67 ('C'), SLEN=2`` carrying ``BSIZE``
(total block size minus one); each member inflates to at most 64 KiB and
the file ends with a fixed 28-byte empty block.

The slice keeps the header parse, the single-block inflate, the block
walk and candidate scan (used by the split guessers), the random-access
reader (used by the header read) and a writer that compresses many
blocks per native call.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from hadoop_bam_torch.utils.errors import CorruptDataError
from hadoop_bam_torch.utils.seekable import as_byte_source

GZIP_MAGIC = b"\x1f\x8b\x08\x04"
BGZF_SI1 = 66   # 'B'
BGZF_SI2 = 67   # 'C'
BGZF_SLEN = 2
_BLOCK_HEADER_FMT = "<4sIBBH"  # magic, mtime, xfl, os, xlen
_XTRA_FMT = "<BBHH"            # SI1, SI2, SLEN, BSIZE
HEADER_SIZE = 18
FOOTER_SIZE = 8
MAX_BLOCK_SIZE = 0x10000
MAX_UNCOMPRESSED = 0x10000
# payload per written block, so that worst-case deflate expansion still fits
WRITE_PAYLOAD_SIZE = 0xFF00
# full blocks per native compress call of the writer (~4 MiB of payload)
WRITE_BATCH_BLOCKS = 64

EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BGZFError(CorruptDataError):
    """Malformed BGZF bytes (CORRUPT class; still a ValueError)."""


@dataclass(frozen=True)
class BlockInfo:
    """Metadata of one BGZF block located in a file/buffer."""
    coffset: int        # compressed offset of the block start
    block_size: int     # total compressed size (BSIZE + 1)
    isize: int          # inflated payload length (from the block footer)
    cdata_offset: int   # offset of the DEFLATE payload within the buffer
    cdata_size: int     # DEFLATE payload length

    @property
    def next_coffset(self) -> int:
        return self.coffset + self.block_size


def parse_block_header(buf: bytes, offset: int = 0) -> BlockInfo:
    """Parse one BGZF block header at ``offset`` (without inflating);
    raises BGZFError if the bytes are not a whole BGZF block."""
    if len(buf) - offset < HEADER_SIZE:
        raise BGZFError("truncated BGZF header")
    if buf[offset:offset + 4] != GZIP_MAGIC:
        raise BGZFError("not a BGZF block: bad gzip magic/flags")
    xlen = struct.unpack_from("<H", buf, offset + 10)[0]
    xtra_start = offset + 12
    xtra_end = xtra_start + xlen
    if len(buf) < xtra_end:
        raise BGZFError("truncated FEXTRA")
    bsize = None
    p = xtra_start
    while p + 4 <= xtra_end:
        si1, si2 = buf[p], buf[p + 1]
        slen = struct.unpack_from("<H", buf, p + 2)[0]
        if si1 == BGZF_SI1 and si2 == BGZF_SI2 and slen == BGZF_SLEN:
            bsize = struct.unpack_from("<H", buf, p + 4)[0]
            break
        p += 4 + slen
    if bsize is None:
        raise BGZFError("gzip member without BGZF BC subfield")
    block_size = bsize + 1
    if block_size < xtra_end - offset + FOOTER_SIZE:
        raise BGZFError("BSIZE smaller than header+footer")
    if len(buf) - offset < block_size:
        raise BGZFError("truncated BGZF block body")
    isize = struct.unpack_from("<I", buf, offset + block_size - 4)[0]
    if isize > MAX_UNCOMPRESSED:
        raise BGZFError("ISIZE exceeds 64 KiB — not a valid BGZF block")
    return BlockInfo(coffset=offset, block_size=block_size, isize=isize,
                     cdata_offset=xtra_end,
                     cdata_size=block_size - (xtra_end - offset)
                     - FOOTER_SIZE)


def inflate_block(buf: bytes, info: Optional[BlockInfo] = None,
                  offset: int = 0, check_crc: bool = True) -> bytes:
    """Inflate one BGZF block; verifies ISIZE and, by default, CRC32."""
    if info is None:
        info = parse_block_header(buf, offset)
    raw = bytes(buf[info.cdata_offset:info.cdata_offset + info.cdata_size])
    try:
        data = zlib.decompress(raw, wbits=-15)
    except zlib.error as e:
        raise BGZFError(f"corrupt DEFLATE payload at coffset "
                        f"{info.coffset}: {e}") from e
    if len(data) != info.isize:
        raise BGZFError(f"ISIZE mismatch: {len(data)} != {info.isize}")
    if check_crc:
        crc = struct.unpack_from("<I", buf,
                                 info.coffset + info.block_size - 8)[0]
        if zlib.crc32(data) & 0xFFFFFFFF != crc:
            raise BGZFError("BGZF block CRC32 mismatch")
    return data


def _frame_block(payload: bytes, cdata: Optional[bytes], level: int) -> bytes:
    """Wrap one raw-DEFLATE payload into a BGZF block (Python zlib when
    ``cdata`` is None; stored when the compressed form would not fit)."""
    if cdata is None:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
    if HEADER_SIZE + len(cdata) + FOOTER_SIZE > MAX_BLOCK_SIZE:
        co = zlib.compressobj(0, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
    block_size = HEADER_SIZE + len(cdata) + FOOTER_SIZE
    if block_size > MAX_BLOCK_SIZE:
        raise BGZFError("deflated block exceeds 64 KiB — reduce payload size")
    header = struct.pack(_BLOCK_HEADER_FMT, GZIP_MAGIC, 0, 0, 255, 6) + \
        struct.pack(_XTRA_FMT, BGZF_SI1, BGZF_SI2, BGZF_SLEN, block_size - 1)
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                         len(payload))
    return header + cdata + footer


def deflate_blocks(payloads: List[bytes], level: int = 6) -> List[bytes]:
    """Build complete BGZF blocks around each payload (<= 64 KiB each),
    compressed by one threaded native call for the whole list."""
    for p in payloads:
        if len(p) > MAX_UNCOMPRESSED:
            raise BGZFError("payload exceeds 64 KiB BGZF limit")
    if not payloads:
        return []
    from hadoop_bam_torch.utils import native
    cdatas = native.deflate_batch(payloads, level)
    return [_frame_block(p, c, level) for p, c in zip(payloads, cdatas)]


def deflate_block(payload: bytes, level: int = 6) -> bytes:
    """One complete BGZF block around ``payload`` (<= 64 KiB): the bytes
    ``deflate_blocks`` makes of it, compressed on the calling thread."""
    if len(payload) > MAX_UNCOMPRESSED:
        raise BGZFError("payload exceeds 64 KiB BGZF limit")
    from hadoop_bam_torch.utils import native
    (cdata,) = native.deflate_batch([payload], level, n_threads=1)
    return _frame_block(payload, cdata, level)


def scan_blocks(buf: bytes, offset: int = 0,
                limit: Optional[int] = None) -> List[BlockInfo]:
    """Walk consecutive BGZF blocks from a known block start."""
    out: List[BlockInfo] = []
    end = len(buf) if limit is None else min(len(buf), limit)
    while offset < end:
        info = parse_block_header(buf, offset)
        out.append(info)
        offset = info.next_coffset
    return out


def find_block_starts_numpy(buf: np.ndarray) -> np.ndarray:
    """Vectorized candidate scan for BGZF block starts: every offset whose
    bytes match the gzip magic and whose XLEN / BC subfield layout is
    consistent.  Candidates still need confirmation by inflating."""
    b = np.frombuffer(buf, dtype=np.uint8) \
        if not isinstance(buf, np.ndarray) else buf
    n = b.size
    if n < HEADER_SIZE:
        return np.empty(0, dtype=np.int64)
    hits = (b[:-3] == 0x1F) & (b[1:-2] == 0x8B) & (b[2:-1] == 0x08) & \
        (b[3:] == 0x04)
    cand = np.nonzero(hits)[0]
    cand = cand[cand + HEADER_SIZE <= n]
    if cand.size:
        xlen = b[cand + 10].astype(np.int32) | \
            (b[cand + 11].astype(np.int32) << 8)
        si_ok = (b[cand + 12] == BGZF_SI1) & (b[cand + 13] == BGZF_SI2) & \
                (b[cand + 14] == BGZF_SLEN) & (b[cand + 15] == 0)
        standard = (xlen == 6) & si_ok
        nonstandard = (xlen > 6) & (xlen < 256)
        cand = cand[standard | nonstandard]
    return cand.astype(np.int64)


class BGZFReader:
    """Random-access reader over a BGZF source: seek by virtual offset,
    read inflated bytes across block boundaries."""

    def __init__(self, source, check_crc: bool = False):
        self._src = as_byte_source(source)
        self._check_crc = check_crc
        self._block_coffset = -1
        self._block_data = b""
        self._uoffset = 0
        self._next_coffset = 0

    def voffset(self) -> int:
        """The current position as a packed virtual offset (the start of
        the next block once a block is read to its end)."""
        coff = self._block_coffset if self._block_coffset >= 0 \
            else self._next_coffset
        if self._uoffset == len(self._block_data) \
                and self._block_coffset >= 0:
            return self._next_coffset << 16
        return (coff << 16) | self._uoffset

    def seek_voffset(self, v: int) -> None:
        coffset, uoffset = v >> 16, v & 0xFFFF
        self._load_block(coffset)
        if uoffset > len(self._block_data):
            raise BGZFError("virtual offset beyond block payload")
        self._uoffset = uoffset

    def _load_block(self, coffset: int) -> bool:
        if coffset == self._block_coffset:
            self._uoffset = 0
            return True
        if coffset >= self._src.size:
            self._block_coffset = -1
            self._block_data = b""
            self._uoffset = 0
            self._next_coffset = coffset
            return False
        head = self._src.pread(coffset, MAX_BLOCK_SIZE)
        info = parse_block_header(head, 0)
        self._block_data = inflate_block(head, info,
                                         check_crc=self._check_crc)
        self._block_coffset = coffset
        self._next_coffset = coffset + info.block_size
        self._uoffset = 0
        return True

    def read(self, n: int) -> bytes:
        """Read exactly n inflated bytes (fewer only at EOF)."""
        out = bytearray()
        while n > 0:
            avail = len(self._block_data) - self._uoffset
            if avail == 0:
                if not self._load_block(self._next_coffset):
                    break
                if len(self._block_data) == 0:  # EOF/empty block
                    continue
                avail = len(self._block_data)
            take = min(avail, n)
            out += self._block_data[self._uoffset:self._uoffset + take]
            self._uoffset += take
            n -= take
        return bytes(out)

    def read_to_voffset(self, v_end: int) -> bytes:
        """The inflated bytes from the current position up to ``v_end``
        (exclusive), never past it."""
        out = bytearray()
        c_end, u_end = v_end >> 16, v_end & 0xFFFF
        while self.voffset() < v_end:
            if self._block_coffset == c_end:
                out += self.read(u_end - self._uoffset)
                break
            avail = len(self._block_data) - self._uoffset
            got = self.read(avail if avail > 0 else 1)
            if not got:
                break
            out += got
        return bytes(out)

    def read_all_from(self, voffset: int = 0) -> bytes:
        self.seek_voffset(voffset)
        chunks = [self.read(1 << 20)]
        while chunks[-1]:
            chunks.append(self.read(1 << 20))
        return b"".join(chunks)


class BGZFWriter:
    """Streaming BGZF writer.  Payload is cut into WRITE_PAYLOAD_SIZE
    blocks, as the reference writer cuts it; full blocks are compressed
    WRITE_BATCH_BLOCKS at a time (one threaded native call each)."""

    def __init__(self, sink, level: int = 6, write_eof: bool = True):
        self._sink = sink
        self._level = level
        self._write_eof = write_eof
        self._buf = bytearray()
        self._closed = False

    def write(self, data: bytes) -> None:
        self._buf += data
        if len(self._buf) >= WRITE_BATCH_BLOCKS * WRITE_PAYLOAD_SIZE:
            self._flush_blocks(len(self._buf) // WRITE_PAYLOAD_SIZE
                               * WRITE_PAYLOAD_SIZE)

    def _flush_blocks(self, n: int) -> None:
        payloads = [bytes(self._buf[i:min(i + WRITE_PAYLOAD_SIZE, n)])
                    for i in range(0, n, WRITE_PAYLOAD_SIZE)]
        del self._buf[:n]
        for block in deflate_blocks(payloads, self._level):
            self._sink.write(block)

    def close(self) -> None:
        if self._closed:
            return
        if self._buf:
            self._flush_blocks(len(self._buf))
        if self._write_eof:
            self._sink.write(EOF_BLOCK)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def compress_bytes(data: bytes, level: int = 6, write_eof: bool = True
                   ) -> bytes:
    """One-shot: BGZF-compress ``data`` into a sequence of blocks."""
    import io
    sink = io.BytesIO()
    with BGZFWriter(sink, level=level, write_eof=write_eof) as w:
        w.write(data)
    return sink.getvalue()


def decompress_bytes(data: bytes, check_crc: bool = True) -> bytes:
    """One-shot: inflate a whole BGZF byte string."""
    return b"".join(inflate_block(data, info, check_crc=check_crc)
                    for info in scan_blocks(data))


def is_bgzf(head: bytes) -> bool:
    """Does ``head`` start with a BGZF block header?  (format sniffing)"""
    try:
        parse_block_header(head[:MAX_BLOCK_SIZE], 0)
        return True
    except BGZFError:
        return False
