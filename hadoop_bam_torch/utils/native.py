"""Build + load the host C++ decode library (ctypes).

Counterpart of hadoop_bam_tpu/utils/native.py.  It compiles the same
source, ``native/hbam_native.cpp``, as it stands, but into this package's
own build directory (``hadoop_bam_torch/_build/``), and it never degrades
quietly: when the native plane is asked for and ``g++`` fails, ``load()``
raises with the compiler's message.  The zlib plane (``ops/inflate.py``)
is the explicit alternative, chosen by ``config.inflate_backend``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from hadoop_bam_torch.utils.errors import BackendError

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_ROOT), "native", "hbam_native.cpp")
BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
_SO = os.path.join(BUILD_DIR, "libhbam_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(BackendError):
    """The host C++ library could not be built or loaded."""


def _compile() -> None:
    """g++ into a process-unique temp name, then an atomic rename: test
    workers that build at the same time never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
            _SRC, "-o", tmp]
    errors = []
    # libdeflate when the host has it (~2x zlib inflate), else plain zlib.
    # A host can link libdeflate and still lack its runtime library, so a
    # build counts only once it loads.
    for extra in (["-DHBAM_USE_LIBDEFLATE", "-lz", "-ldeflate"], ["-lz"]):
        try:
            subprocess.run(base + extra, check=True, capture_output=True,
                           text=True, timeout=300)
            ctypes.CDLL(tmp)
        except FileNotFoundError as e:
            raise NativeBuildError(f"g++ not found: {e}") from e
        except subprocess.CalledProcessError as e:
            errors.append(e.stderr[-2000:])
            continue
        except OSError as e:
            errors.append(str(e))
            continue
        os.replace(tmp, _SO)
        return
    raise NativeBuildError("building native/hbam_native.cpp failed:\n"
                           + "\n".join(errors))


def load() -> ctypes.CDLL:
    """Load the native library, compiling it first when the build is
    missing or older than the source.  Raises NativeBuildError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            raise NativeBuildError(f"native source missing: {_SRC}")
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _compile()
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            raise NativeBuildError(f"cannot load {_SO}: {e}") from e
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.hbam_inflate_batch.restype = ctypes.c_int
        lib.hbam_inflate_batch.argtypes = [
            u8p, i64p, i32p, ctypes.c_int32, u8p, i64p, i32p, ctypes.c_int32]
        lib.hbam_walk_bam_records.restype = ctypes.c_int64
        lib.hbam_walk_bam_records.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
        lib.hbam_walk_bam_packed.restype = ctypes.c_int64
        lib.hbam_walk_bam_packed.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32, u8p, i64p, ctypes.c_int64, i64p]
        lib.hbam_walk_bam_payload.restype = ctypes.c_int64
        lib.hbam_walk_bam_payload.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            u8p, u8p, u8p, i64p, ctypes.c_int64, i64p]
        lib.hbam_crc32_batch.restype = ctypes.c_int
        lib.hbam_crc32_batch.argtypes = [
            u8p, i64p, i32p, ctypes.c_int32, u32p, ctypes.c_int32]
        lib.hbam_deflate_batch.restype = ctypes.c_int
        lib.hbam_deflate_batch.argtypes = [
            u8p, i64p, i32p, ctypes.c_int32, u8p, i64p, i32p, i32p,
            ctypes.c_int32, ctypes.c_int32]
        lib.hbam_deflate_tokenize_batch.restype = ctypes.c_int
        lib.hbam_deflate_tokenize_batch.argtypes = [
            u8p, i64p, i32p, ctypes.c_int32, u32p, ctypes.c_int64,
            i32p, i32p, u32p, ctypes.c_int32]
        if hasattr(lib, "hbam_fused_start"):
            lib.hbam_fused_start.restype = ctypes.c_void_p
            lib.hbam_fused_start.argtypes = [
                u8p, i64p, i32p, i32p, u32p, ctypes.c_int32,
                u8p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
                u8p, u8p, u8p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i64p, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32]
            lib.hbam_fused_next.restype = ctypes.c_int
            lib.hbam_fused_next.argtypes = [ctypes.c_void_p, i64p, i64p]
            lib.hbam_fused_finish.restype = ctypes.c_int
            lib.hbam_fused_finish.argtypes = [
                ctypes.c_void_p, i64p, i64p, i64p]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _threads(n_items: int, n_threads: int) -> int:
    if n_threads > 0:
        return n_threads
    return max(1, min(n_items, os.cpu_count() or 1))


def inflate_batch(src: np.ndarray, cdata_off: np.ndarray,
                  cdata_len: np.ndarray, dst: np.ndarray,
                  dst_off: np.ndarray, isize: np.ndarray,
                  n_threads: int = 0) -> None:
    """Inflate every block of a span into ``dst`` (threaded); raises
    ValueError naming the first corrupt block."""
    lib = load()
    rc = lib.hbam_inflate_batch(
        _ptr(src, ctypes.c_uint8), _ptr(cdata_off, ctypes.c_int64),
        _ptr(cdata_len, ctypes.c_int32), len(cdata_off),
        _ptr(dst, ctypes.c_uint8), _ptr(dst_off, ctypes.c_int64),
        _ptr(isize, ctypes.c_int32), _threads(len(cdata_off), n_threads))
    if rc:
        raise ValueError(f"native inflate failed at block {rc - 1000}")


def walk_bam_records(buf: np.ndarray, start: int, cap: int
                     ) -> tuple[np.ndarray, int]:
    """Record walk; returns (offsets, tail_offset)."""
    lib = load()
    out = np.empty(cap, dtype=np.int64)
    tail = np.zeros(1, dtype=np.int64)
    n = lib.hbam_walk_bam_records(
        _ptr(buf, ctypes.c_uint8), buf.size, start,
        _ptr(out, ctypes.c_int64), cap, _ptr(tail, ctypes.c_int64))
    if n < 0:
        raise ValueError("malformed BAM record chain")
    if n > cap:
        raise ValueError(f"record count {n} exceeds capacity {cap}")
    return out[:n], int(tail[0])


def walk_bam_packed(buf: np.ndarray, start: int, cap: int,
                    sel: "list[tuple[int, int]]", row_stride: int,
                    stop: Optional[int] = None,
                    ) -> tuple[np.ndarray, np.ndarray, int]:
    """Single-pass walk + columnar row pack: ``sel`` (src_offset, length)
    ranges of each record's fixed prefix packed back to back into
    ``row_stride``-byte rows; the walk stops at the first record starting
    at or past ``stop``.  Returns (rows[n, row_stride], offsets[n], tail)."""
    lib = load()
    if stop is None:
        stop = buf.size
    sel_off = np.asarray([o for o, _ in sel], dtype=np.int32)
    sel_len = np.asarray([l for _, l in sel], dtype=np.int32)
    rows = np.empty((cap, row_stride), dtype=np.uint8)
    offs = np.empty(cap, dtype=np.int64)
    tail = np.zeros(1, dtype=np.int64)
    n = lib.hbam_walk_bam_packed(
        _ptr(buf, ctypes.c_uint8), buf.size, start, stop,
        _ptr(sel_off, ctypes.c_int32), _ptr(sel_len, ctypes.c_int32),
        len(sel), row_stride, _ptr(rows, ctypes.c_uint8),
        _ptr(offs, ctypes.c_int64), cap, _ptr(tail, ctypes.c_int64))
    if n < 0:
        raise ValueError("malformed BAM record chain")
    if n > cap:
        raise ValueError(f"record count {n} exceeds capacity {cap}")
    return rows[:n], offs[:n], int(tail[0])


def walk_bam_payload(buf: np.ndarray, start: int, cap: int, max_len: int,
                     seq_stride: int, qual_stride: int,
                     stop: Optional[int] = None,
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, int]:
    """Single-pass walk + prefix/seq/qual tile pack.  Returns
    (prefix[n, 36], seq[n, seq_stride], qual[n, qual_stride], offsets[n],
    tail); rows are zero past each read's payload."""
    lib = load()
    if stop is None:
        stop = buf.size
    prefix = np.zeros((cap, 36), dtype=np.uint8)
    seq = np.zeros((cap, seq_stride), dtype=np.uint8)
    qual = np.zeros((cap, qual_stride), dtype=np.uint8)
    offs = np.empty(cap, dtype=np.int64)
    tail = np.zeros(1, dtype=np.int64)
    n = lib.hbam_walk_bam_payload(
        _ptr(buf, ctypes.c_uint8), buf.size, start, stop,
        max_len, seq_stride, qual_stride,
        _ptr(prefix, ctypes.c_uint8), _ptr(seq, ctypes.c_uint8),
        _ptr(qual, ctypes.c_uint8), _ptr(offs, ctypes.c_int64), cap,
        _ptr(tail, ctypes.c_int64))
    if n < 0:
        raise ValueError("malformed BAM record chain")
    if n > cap:
        raise ValueError(f"record count {n} exceeds capacity {cap}")
    return prefix[:n], seq[:n], qual[:n], offs[:n], int(tail[0])


def crc32_batch(data: np.ndarray, off: np.ndarray, length: np.ndarray,
                n_threads: int = 0) -> np.ndarray:
    """CRC32 of each ``data[off[i]:off[i] + length[i]]`` range."""
    lib = load()
    n = len(off)
    out = np.empty(n, dtype=np.uint32)
    lib.hbam_crc32_batch(
        _ptr(data, ctypes.c_uint8), _ptr(off, ctypes.c_int64),
        _ptr(length, ctypes.c_int32), n, _ptr(out, ctypes.c_uint32),
        _threads(n, n_threads))
    return out


_TOKENIZE_FAULTS = {
    1: "truncated stream", 2: "malformed stream",
    3: "token capacity exceeded (caller's tok_stride too small)",
    4: "back-reference before stream start"}


def deflate_tokenize_batch(src: np.ndarray, cdata_off: np.ndarray,
                           cdata_len: np.ndarray, tok_stride: int,
                           n_threads: int = 0, with_crc: bool = False
                           ) -> tuple:
    """Huffman-decode many raw DEFLATE streams into LZ77 token rows
    (copies left unresolved): the host half of the device decode plane
    (``ops/inflate_device.py``).  A token with bit 31 set is a copy
    (length in bits 16-24, distance - 1 in bits 0-15), else a literal
    byte.  Returns (tokens [B, tok_stride] u32, n_tokens [B] i32,
    out_lens [B] i32), plus ``crcs [B] u32`` (each block's inflated
    CRC32, folded in while tokenizing) with ``with_crc``.  Raises
    ValueError naming the first failing block and why."""
    lib = load()
    n = len(cdata_off)
    tokens = np.empty((n, tok_stride), dtype=np.uint32)
    n_tokens = np.zeros(n, dtype=np.int32)
    out_lens = np.zeros(n, dtype=np.int32)
    crcs = np.zeros(n, dtype=np.uint32) if with_crc else None
    rc = lib.hbam_deflate_tokenize_batch(
        _ptr(src, ctypes.c_uint8), _ptr(cdata_off, ctypes.c_int64),
        _ptr(cdata_len, ctypes.c_int32), n,
        _ptr(tokens, ctypes.c_uint32), tok_stride,
        _ptr(n_tokens, ctypes.c_int32), _ptr(out_lens, ctypes.c_int32),
        None if crcs is None else _ptr(crcs, ctypes.c_uint32),
        _threads(n, n_threads))
    if rc:
        kind = (rc - 1000) // 1000000
        block = (rc - 1000) % 1000000
        raise ValueError(
            f"deflate tokenize failed at block {block}: "
            f"{_TOKENIZE_FAULTS.get(kind, f'error {kind}')}")
    if with_crc:
        return tokens, n_tokens, out_lens, crcs
    return tokens, n_tokens, out_lens


def deflate_batch(payloads: "list[bytes]", level: int = 6,
                  n_threads: int = 0) -> "list[Optional[bytes]]":
    """Raw-DEFLATE many payloads at once (threaded).  An entry is None
    where the compressed form would not fit ``len(payload) + 64`` bytes;
    the caller compresses that block another way."""
    lib = load()
    n = len(payloads)
    src = np.frombuffer(b"".join(payloads), dtype=np.uint8)
    src_len = np.asarray([len(p) for p in payloads], dtype=np.int32)
    src_off = np.zeros(n, dtype=np.int64)
    np.cumsum(src_len[:-1], out=src_off[1:])
    cap = np.maximum(src_len + 64, 256).astype(np.int32)
    dst_off = np.zeros(n, dtype=np.int64)
    np.cumsum(cap[:-1], out=dst_off[1:])
    dst = np.empty(int(cap.sum(dtype=np.int64)), dtype=np.uint8)
    out_len = np.zeros(n, dtype=np.int32)
    rc = lib.hbam_deflate_batch(
        _ptr(src, ctypes.c_uint8), _ptr(src_off, ctypes.c_int64),
        _ptr(src_len, ctypes.c_int32), n, _ptr(dst, ctypes.c_uint8),
        _ptr(dst_off, ctypes.c_int64),
        _ptr(cap, ctypes.c_int32),
        _ptr(out_len, ctypes.c_int32), level, _threads(n, n_threads))
    if rc:
        # the zlib build reports an output that did not fit as a failure
        return [None] * n
    return [dst[int(o):int(o) + int(l)].tobytes() if l > 0 else None
            for o, l in zip(dst_off, out_len)]


def fused_available() -> bool:
    """Does the library export the fused span-decode entry points
    (``hbam_fused_start`` / ``_next`` / ``_finish``)?"""
    return hasattr(load(), "hbam_fused_start")


# fused pack modes (HbamFusedJob::mode in native/hbam_native.cpp)
FUSED_OFFSETS, FUSED_ROWS, FUSED_PAYLOAD = 0, 1, 2


# fused jobs started and not yet joined (``live_jobs``): the span window
# closes a losing or abandoned copy's job through its cleanup, and the
# tests hold that no job outlives a driver call
_LIVE_LOCK = threading.Lock()
_LIVE = [0]


def live_jobs() -> int:
    """Fused native jobs whose workers have not been joined yet."""
    with _LIVE_LOCK:
        return _LIVE[0]


class FusedJob:
    """One running ``hbam_fused_*`` span decode: native workers inflate
    runs of ``chunk_blocks`` blocks while the record walk and pack follow
    the contiguous inflated frontier.  Holds every borrowed array until
    the workers are joined, which happens exactly once (``finish``,
    ``close``, or garbage collection as a last resort).  Reports raw
    (rc, err_index) pairs; ``ops/inflate.py`` maps them to exceptions.
    One consumer; not thread-safe.

    Raises NativeBuildError when the library lacks the fused entry
    points: the port builds it from the repo's source, so that is a
    build fault, not a reason to run another path."""

    def __init__(self, src: np.ndarray, cdata_off: np.ndarray,
                 cdata_len: np.ndarray, isize: np.ndarray,
                 expect_crc: Optional[np.ndarray], dst: np.ndarray,
                 ubase: np.ndarray, start: int, stop: int, mode: int,
                 sel_off: Optional[np.ndarray], sel_len: Optional[np.ndarray],
                 row_stride: int, out_rows: Optional[np.ndarray],
                 out_seq: Optional[np.ndarray],
                 out_qual: Optional[np.ndarray], max_len: int,
                 seq_stride: int, qual_stride: int, out_off: np.ndarray,
                 chunk_blocks: int, n_threads: int = 0):
        self._h = None
        lib = load()
        if not hasattr(lib, "hbam_fused_start"):
            raise NativeBuildError(
                f"{_SO} lacks the fused decode entry points "
                f"(hbam_fused_start/next/finish) of {_SRC}")
        self._lib = lib
        n_blocks = len(cdata_off)
        if n_threads <= 0:
            n_threads = min(-(-n_blocks // max(1, chunk_blocks)),
                            os.cpu_count() or 1)
        self._keep = (src, cdata_off, cdata_len, isize, expect_crc, dst,
                      ubase, sel_off, sel_len, out_rows, out_seq, out_qual,
                      out_off)

        def opt(a, ctype):
            return None if a is None else _ptr(a, ctype)

        self._h = lib.hbam_fused_start(
            _ptr(src, ctypes.c_uint8), _ptr(cdata_off, ctypes.c_int64),
            _ptr(cdata_len, ctypes.c_int32), _ptr(isize, ctypes.c_int32),
            opt(expect_crc, ctypes.c_uint32), n_blocks,
            _ptr(dst, ctypes.c_uint8), _ptr(ubase, ctypes.c_int64),
            int(dst.size), int(start), int(stop), int(mode),
            opt(sel_off, ctypes.c_int32), opt(sel_len, ctypes.c_int32),
            0 if sel_off is None else len(sel_off), int(row_stride),
            opt(out_rows, ctypes.c_uint8), opt(out_seq, ctypes.c_uint8),
            opt(out_qual, ctypes.c_uint8), int(max_len), int(seq_stride),
            int(qual_stride), _ptr(out_off, ctypes.c_int64),
            int(out_off.size), int(chunk_blocks), int(n_threads))
        if not self._h:
            raise ValueError("fused decode rejected its arguments")
        with _LIVE_LOCK:
            _LIVE[0] += 1
        self.rc = 0
        self.tail = int(start)
        self.n_rows = 0
        self.err_index = -1

    def next_chunk(self) -> "Optional[tuple[int, int]]":
        """Block until the walk publishes the next row range: (row_lo,
        row_hi), or None once the decode is complete.  On an error the
        workers are joined and None comes back with ``rc < 0``."""
        if self._h is None:
            return None
        lo = np.zeros(1, dtype=np.int64)
        hi = np.zeros(1, dtype=np.int64)
        rc = self._lib.hbam_fused_next(
            self._h, _ptr(lo, ctypes.c_int64), _ptr(hi, ctypes.c_int64))
        if rc == 1:
            return int(lo[0]), int(hi[0])
        if rc < 0:
            self.finish()
        return None

    def finish(self) -> int:
        """Join the workers and free the job (idempotent).  Returns the
        final rc (0 or -kind) and sets ``tail``, ``n_rows`` and
        ``err_index``."""
        if self._h is None:
            return self.rc
        tail = np.zeros(1, dtype=np.int64)
        n_rows = np.zeros(1, dtype=np.int64)
        err_index = np.zeros(1, dtype=np.int64)
        rc = self._lib.hbam_fused_finish(
            self._h, _ptr(tail, ctypes.c_int64),
            _ptr(n_rows, ctypes.c_int64), _ptr(err_index, ctypes.c_int64))
        self._h = None
        with _LIVE_LOCK:
            _LIVE[0] -= 1
        self.rc = int(rc)
        self.tail = int(tail[0])
        self.n_rows = int(n_rows[0])
        self.err_index = int(err_index[0])
        return self.rc

    close = finish

    def __del__(self):   # abandoned: never leave native threads running
        try:
            self.finish()
        except Exception:  # noqa: BLE001 -- interpreter teardown
            pass
