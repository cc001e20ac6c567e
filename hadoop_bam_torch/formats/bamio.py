"""Whole-file BAM helpers (trimmed copy of hadoop_bam_tpu/formats/bamio.py):
the header read every driver starts from, and a writer for fixtures."""
from __future__ import annotations

from typing import Tuple

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.formats.virtual_offset import make_voffset
from hadoop_bam_torch.utils.errors import CorruptDataError
from hadoop_bam_torch.utils.seekable import as_byte_source


class BamWriter:
    """Streaming BAM writer: header, then pre-encoded record bytes, then
    the BGZF EOF block.  ``write_header`` / ``write_eof`` off make the
    headerless, unterminated parts a sharded write concatenates."""

    def __init__(self, sink, header: SAMHeader, *, level: int = 6,
                 write_header: bool = True, write_eof: bool = True):
        self._own = isinstance(sink, str)
        self._sink = open(sink, "wb") if self._own else sink
        self.header = header
        self._w = bgzf.BGZFWriter(self._sink, level=level,
                                  write_eof=write_eof)
        self.records_written = 0
        if write_header:
            self._w.write(header.to_bam_bytes())

    def write_record_bytes(self, rec: bytes) -> None:
        self._w.write(rec)
        self.records_written += 1

    def write_raw(self, data: bytes, n_records: int) -> None:
        """Append already-concatenated record bytes (the bulk path)."""
        self._w.write(data)
        self.records_written += n_records

    def close(self) -> None:
        self._w.close()
        if self._own:
            self._sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bam_header(source) -> Tuple[SAMHeader, int]:
    """Read the header; returns (header, first-record virtual offset)."""
    src = as_byte_source(source)
    try:
        return _read_header(src)
    finally:
        if src is not source:
            src.close()


def _read_header(src) -> Tuple[SAMHeader, int]:
    r = bgzf.BGZFReader(src)
    size = 1 << 16
    while True:
        r.seek_voffset(0)
        buf = r.read(size)
        try:
            header, after = SAMHeader.from_bam_bytes(buf, 0)
            break
        except Exception as e:  # noqa: BLE001 — any parse failure of the buffer
            if len(buf) < size:  # EOF — really malformed
                raise CorruptDataError(
                    f"malformed BAM header: {type(e).__name__}: {e}") from e
            size *= 4
    # the plain offset after the header becomes a virtual offset by walking
    # the (few) header blocks again
    remaining = after
    coff = 0
    while True:
        head = src.pread(coff, bgzf.MAX_BLOCK_SIZE)
        info = bgzf.parse_block_header(head, 0)
        if remaining < info.isize or (remaining == info.isize
                                      and info.isize > 0):
            if remaining == info.isize:
                return header, make_voffset(coff + info.block_size, 0)
            return header, make_voffset(coff, remaining)
        remaining -= info.isize
        coff += info.block_size
