"""ParallelBGZFWriter: BGZF deflates on the shared pool, blocks written
in order (copy of hadoop_bam_tpu/write/parallel_bgzf.py).

The serial ``formats/bgzf.BGZFWriter`` cuts the payload at
``WRITE_PAYLOAD_SIZE`` and deflates each piece into one block.  This
writer keeps that block geometry but runs the deflates on the process's
decode pool (``utils/pools.py``) while one committer thread writes the
finished blocks to the sink in submission order; cutting and deflating
are deterministic, so the bytes equal the serial writer's at the same
level, for any worker count and any split of the ``write()`` calls.

A block's compressed start is known only once every earlier block is
deflated, so callers keep PAYLOAD offsets (``tell_payload_offset``, the
uncompressed bytes accepted) as position tokens and map them to virtual
offsets after ``close()`` with ``resolve_voffsets``: what
``write/indexing.BamIndexingSink`` builds the sidecars from.

A fault in a deflate worker fires the ``write.deflate`` chaos point;
transient faults retry in place (the same bytes), others poison the
writer.  Metrics: ``write.deflate_wall``, ``write.commit_wall``,
``write.bytes_out`` / ``write.blocks_out``.
"""
from __future__ import annotations

import collections
import contextvars
import queue
import threading
from typing import List, Optional

import numpy as np

from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.resilience import chaos
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.resilient import (
    call_with_retry, span_retry_policy,
)

_SENTINEL = object()


class ParallelBGZFWriter:
    """Order-preserving parallel BGZF writer (module docstring).

    ``max_inflight=0`` selects the serial in-line mode: same code path,
    same bytes, no pool and no committer thread.
    """

    def __init__(self, sink, *, level: int = 6, write_eof: bool = True,
                 pool=None, max_inflight: Optional[int] = None,
                 config=None):
        self._sink = sink
        self._level = int(level)
        self._write_eof = write_eof
        self._buf = bytearray()
        self._accepted = 0          # payload bytes accepted by write()
        self._submitted = 0         # payload bytes cut into blocks so far
        self._block_starts: List[int] = []   # payload start per block
        self._block_coffs: List[int] = []    # compressed start per block
        self._coffset = 0           # compressed bytes committed so far
        self.bytes_out = 0
        self.data_end_coffset = 0   # set at close (before the EOF block)
        self._closed = False
        # orders committer-side bookkeeping (_err, _coffset, bytes_out,
        # _block_coffs) against producer-thread readers: _check_err polls
        # _err mid-write, and close/resolve_voffsets read the offsets the
        # committer thread produced.  Never contended on the hot path —
        # the committer is the only writer in flight.
        self._mu = threading.Lock()
        self._err: Optional[BaseException] = None
        if max_inflight is not None and max_inflight < 0:
            raise PlanError(f"max_inflight must be >= 0, "
                            f"got {max_inflight}")
        # deflate-worker fault recovery: transient-classified faults in
        # a worker (an injected write.deflate chaos fault, a wobbly
        # memory allocator) retry in place instead of poisoning the
        # writer — deflate is deterministic, so a healed retry keeps the
        # output byte-identical; corrupt/plan classes still fail fast
        self._retry = span_retry_policy(config)
        serial = max_inflight == 0
        self._pool = None
        self._committer = None
        if not serial:
            if pool is None:
                from hadoop_bam_torch.utils import pools
                pool = pools.decode_pool(config)
                if max_inflight is None:
                    max_inflight = pools.decode_pool_size(config)
            if max_inflight is None:
                max_inflight = int(getattr(pool, "_max_workers", 4) or 4)
            self._pool = pool
            # bound on blocks in flight (submitted, not yet committed):
            # backpressure so a fast producer cannot queue the whole
            # file's payload in the shared pool and starve other work
            self._sem = threading.Semaphore(max(2, 2 * int(max_inflight)))
            self._q: "queue.Queue" = queue.Queue()
            ctx = contextvars.copy_context()
            self._committer = threading.Thread(
                target=ctx.run, args=(self._commit_loop,),
                name="hbam-write-commit", daemon=True)
            self._committer.start()

    # -- producer side -------------------------------------------------------

    def tell_payload_offset(self) -> int:
        """Uncompressed position token of the next byte written; map to a
        packed virtual offset with ``resolve_voffsets`` after close."""
        return self._accepted

    def write(self, data) -> None:
        if self._closed:
            raise PlanError("write after close on ParallelBGZFWriter")
        self._check_err()
        mv = memoryview(data) if not isinstance(data, (bytes, bytearray)) \
            else data
        self._buf += mv
        self._accepted += len(mv)
        while len(self._buf) >= bgzf.WRITE_PAYLOAD_SIZE:
            payload = bytes(self._buf[:bgzf.WRITE_PAYLOAD_SIZE])
            del self._buf[:bgzf.WRITE_PAYLOAD_SIZE]
            self._submit_block(payload)

    def flush(self) -> None:
        """Cut the buffered remainder into a (short) block.  Mid-stream
        flushes change the block geometry away from the serial writer's
        (which only flushes at close), so byte-identity callers must not
        flush until close — close() calls this itself."""
        if self._buf:
            payload = bytes(self._buf)
            self._buf.clear()
            self._submit_block(payload)

    def _submit_block(self, payload: bytes) -> None:
        self._block_starts.append(self._submitted)
        self._submitted += len(payload)
        if self._pool is None:
            self._commit(self._deflate(payload))
            return
        # acquire an in-flight permit BEFORE handing the pool the bytes;
        # poll so a dead committer surfaces as the stored error instead
        # of a silent hang
        while not self._sem.acquire(timeout=0.5):
            self._check_err()
        from hadoop_bam_torch.utils import pools
        self._q.put(pools.submit(self._pool, self._deflate, payload))

    def _deflate(self, payload: bytes) -> bytes:
        def run() -> bytes:
            # chaos point: a fault inside the deflate worker — the
            # schedule decides whether it heals on retry (transient) or
            # poisons the writer (corrupt)
            chaos.fire("write.deflate", nbytes=len(payload))
            return bgzf.deflate_block(payload, self._level)

        with METRICS.span("write.deflate_wall", nbytes=len(payload)):
            return call_with_retry(run, self._retry, what="bgzf deflate",
                                   counter="write.deflate_retries")

    # -- committer side ------------------------------------------------------

    def _commit(self, block: bytes) -> None:
        with METRICS.span("write.commit_wall"):
            with self._mu:
                self._block_coffs.append(self._coffset)
            self._sink.write(block)
        with self._mu:
            self._coffset += len(block)
            self.bytes_out += len(block)
        METRICS.count("write.bytes_out", len(block))
        METRICS.count("write.blocks_out")

    def _commit_loop(self) -> None:
        while True:
            fut = self._q.get()
            if fut is _SENTINEL:
                return
            try:
                block = fut.result()
                with self._mu:
                    poisoned = self._err is not None
                if not poisoned:
                    self._commit(block)
            except BaseException as e:  # noqa: BLE001 — crosses threads
                # keep draining (and releasing permits) so the producer
                # never wedges on the semaphore; the first error wins
                with self._mu:
                    if self._err is None:
                        self._err = e
            finally:
                self._sem.release()

    def _check_err(self) -> None:
        with self._mu:
            err = self._err
        if err is not None:
            raise err

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            if self._err is None:
                self.flush()
        finally:
            # ALWAYS stop the committer — error paths included, or the
            # daemon thread (and its in-flight permits) leak per writer
            if self._committer is not None:
                self._q.put(_SENTINEL)
                self._committer.join()
        with self._mu:
            err, self._err = self._err, None
        if err is not None:
            raise err
        self.data_end_coffset = self._coffset
        # end sentinel: payload positions at exactly end-of-data resolve
        # to the normalized (next-block) virtual offset, matching the
        # serial writer's tell_voffset at a block boundary
        self._block_starts.append(self._submitted)
        with self._mu:
            self._block_coffs.append(self._coffset)
        if self._write_eof:
            with METRICS.span("write.commit_wall"):
                self._sink.write(bgzf.EOF_BLOCK)
            with self._mu:
                self._coffset += len(bgzf.EOF_BLOCK)
                self.bytes_out += len(bgzf.EOF_BLOCK)
            METRICS.count("write.bytes_out", len(bgzf.EOF_BLOCK))

    @property
    def data_end_voffset(self) -> int:
        """Packed virtual offset just past the last record byte (before
        the EOF terminator); only valid after close."""
        return self.data_end_coffset << 16

    def resolve_voffsets(self, payload_offsets) -> np.ndarray:
        """Map payload-offset tokens to packed virtual offsets.  Only
        valid after ``close()`` — earlier, the compressed offsets of
        in-flight blocks are not yet known."""
        if not self._closed:
            raise PlanError("resolve_voffsets before close: compressed "
                            "block offsets are not final yet")
        u = np.asarray(payload_offsets, dtype=np.int64)
        if not self._block_starts:
            return (u.astype(np.uint64) << np.uint64(16))
        starts = np.asarray(self._block_starts, dtype=np.int64)
        coffs = np.asarray(self._block_coffs, dtype=np.int64)
        i = np.searchsorted(starts, u, side="right") - 1
        i = np.clip(i, 0, starts.size - 1)
        base = coffs[i].astype(np.uint64)
        uoff = (u - starts[i]).astype(np.uint64)
        return (base << np.uint64(16)) | uoff

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
