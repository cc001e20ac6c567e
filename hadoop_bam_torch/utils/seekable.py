"""Positioned byte sources (trimmed copy of hadoop_bam_tpu/utils/seekable.py).

Every host layer reads through ``pread(offset, size) -> bytes`` plus
``size``, so local files and in-memory buffers are interchangeable.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Union

# Resilience hook (utils/resilient.py): while chaos is installed for some
# path, every path-opened source goes through this wrapper.  None = the
# plain fast path.
_SOURCE_WRAPPER: Optional[Callable[["ByteSource"], "ByteSource"]] = None


class ByteSource:
    """Interface: stateless positioned reads."""

    size: int

    def pread(self, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileByteSource(ByteSource):
    """Positioned reads over a local file via os.pread (thread-safe: many
    decode threads share one descriptor)."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = os.fspath(path)
        self._fd = -1  # set first so __del__ is safe if os.open raises
        self._fd = os.open(self.path, os.O_RDONLY)
        self.size = os.fstat(self._fd).st_size

    def pread(self, offset: int, size: int) -> bytes:
        if offset >= self.size or size <= 0:
            return b""
        return os.pread(self._fd, size, offset)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):
        try:
            self.close()
        except OSError:
            pass


class BytesByteSource(ByteSource):
    """Over an in-memory buffer."""

    def __init__(self, data: bytes):
        self._data = data
        self.size = len(data)

    def pread(self, offset: int, size: int) -> bytes:
        return self._data[offset:offset + size]


def as_byte_source(obj) -> ByteSource:
    if isinstance(obj, ByteSource):
        return obj
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return BytesByteSource(bytes(obj))
    if isinstance(obj, (str, os.PathLike)):
        src = FileByteSource(obj)
        return _SOURCE_WRAPPER(src) if _SOURCE_WRAPPER is not None else src
    raise TypeError(f"cannot make a ByteSource from {type(obj)!r}")


class scoped_byte_source:
    """``with scoped_byte_source(obj) as src``: closes ``src`` on exit only
    when this call opened it (an open ByteSource passes through and stays
    the caller's)."""

    def __init__(self, obj):
        self._owned = not isinstance(obj, ByteSource)
        self.src = as_byte_source(obj)

    def __enter__(self) -> ByteSource:
        return self.src

    def __exit__(self, *exc):
        if self._owned:
            self.src.close()
