"""Staging ring + the host->device feed pipeline (counterpart of
hadoop_bam_tpu/parallel/staging.py).

- ``StagingRing``: a few preallocated ``[n_dev, cap, w]`` group buffers,
  pinned host tensors when the data axis is on CUDA.  A dispatch copies
  a slot to the card with ``non_blocking=True`` on the current CUDA
  stream and hands back a CUDA event recorded right after the copies;
  ``lease`` waits on that event before it hands the slot out again, so
  the packer can never overwrite a buffer an asynchronous copy is still
  reading.  (The reference blocked on device arrays for the same rule:
  ``committed_device_put`` and ``_block_in_flight``.)  A slot can be
  PINNED out of the ring (``RingSlot.pin``): the serve tile builder
  hands its buffers to a cached tile and the ring mints a replacement.
- ``FeedPipeline``: a packer thread repacks per-span row arrays into ring
  slots (rows written in place; a partial tile zeroes only its own tail)
  while the caller's thread dispatches the previous group: ``feed`` for
  the stats drivers, the ``stream`` generator for ``tensor_batches``.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import queue
import threading
from typing import (
    Callable, Iterable, Iterator, List, Optional, Sequence, Tuple,
)

import numpy as np
import torch


def bucket_cap(count: int, cap: int, block_n: int = 256) -> int:
    """Rows to dispatch for a partial tile of ``count`` records: full
    tiles ship at ``cap``; the final partial tile shrinks to the smallest
    of (~cap/16, ~cap/4, cap) that holds it, rounded up to ``block_n``."""
    for b in (cap // 16, cap // 4):
        b = -(-b // block_n) * block_n
        if b >= block_n and count <= b < cap:
            return b
    return cap


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """Per-record layout of one array in a tile tuple: trailing shape,
    numpy dtype, and the value rows past a device's count hold."""
    shape: Tuple[int, ...]
    dtype: object
    pad: object = 0


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class RingSlot:
    """One leased group buffer set.  ``tensors[j]`` is the host tensor
    [n_dev, cap, *shape] (pinned on CUDA axes) and ``arrays[j]`` its
    numpy view; ``counts`` holds the per-device row counts.
    ``in_flight`` is the handle (anything with ``synchronize()``, a CUDA
    event on the card) of the last copy out of these buffers.

    ``pin()`` transfers the slot's buffers OUT of the ring for good: a
    pinned slot's ``release`` parks it (never requeues it) and the ring
    mints a fresh replacement, so capacity is unchanged while the pinned
    buffers can never be leased and overwritten again.  On the CPU
    ``tensor.to("cpu")`` returns the same tensor, so a serve tile built
    from a slot IS the slot's memory; without the pin a recycled slot
    would rewrite a cached tile.  ``unpin()`` relinquishes a parked slot
    (its buffers then live as long as whatever references them) or,
    before release, cancels the pin so the slot recirculates."""
    __slots__ = ("tensors", "arrays", "counts", "in_flight", "pinned",
                 "parked", "_ring")

    def __init__(self, tensors: List[torch.Tensor], n_dev: int,
                 ring: "StagingRing"):
        self.tensors = tensors
        self.arrays = [t.numpy() for t in tensors]
        self.counts = np.zeros(n_dev, np.int32)
        self.in_flight = None
        self.pinned = False
        self.parked = False
        self._ring = ring

    def pin(self) -> None:
        self.pinned = True

    def unpin(self) -> None:
        self._ring.unpin(self)

    def release(self) -> None:
        self._ring.release(self)


class Cancelled(Exception):
    """The other side of the pipeline stopped; unwind quietly."""


class StagingRing:
    """A ring of ``slots`` preallocated group buffers (two for the feeds:
    one being packed while the other's copy is in flight), leased and
    released.  ``lease`` never returns a slot whose last copy is still
    in flight."""

    def __init__(self, n_dev: int, cap: int, specs: Sequence[TileSpec],
                 pin_memory: bool = False, slots: int = 2):
        self.n_dev, self.cap = int(n_dev), int(cap)
        self.specs = list(specs)
        self.pin_memory = bool(pin_memory)
        self.n_slots = max(2, int(slots))
        self._free: "queue.Queue[RingSlot]" = queue.Queue()
        for _ in range(self.n_slots):
            self._free.put(self._fresh_slot())

    def _fresh_slot(self) -> RingSlot:
        return RingSlot([
            torch.full((self.n_dev, self.cap) + tuple(s.shape), s.pad,
                       dtype=_torch_dtype(s.dtype),
                       pin_memory=self.pin_memory)
            for s in self.specs], self.n_dev, self)

    def lease(self, cancel: Optional[threading.Event] = None) -> RingSlot:
        while True:
            try:
                slot = self._free.get(timeout=0.05)
                break
            except queue.Empty:
                if cancel is not None and cancel.is_set():
                    raise Cancelled()
        if slot.in_flight is not None:
            slot.in_flight.synchronize()
            slot.in_flight = None
        return slot

    def release(self, slot: RingSlot) -> None:
        if slot.pinned:
            # ownership transfer: the buffers leave the ring for good
            # and a fresh replacement keeps the capacity
            slot.parked = True
            self._free.put(self._fresh_slot())
            return
        self._free.put(slot)

    def unpin(self, slot: RingSlot) -> None:
        """Relinquish a pinned slot.  Parked (already released): a
        replacement was minted at release, so this only drops the flags;
        the buffers are never leased again.  Not yet released: cancels
        the pin, and the slot recirculates on release."""
        slot.pinned = False
        slot.parked = False


def _put(q: "queue.Queue", item, cancel: threading.Event) -> None:
    while True:
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            if cancel.is_set():
                raise Cancelled()


_SENTINEL = object()


class FeedPipeline:
    """Group assembly on a packer thread + dispatch on the caller's.

    The span stream yields per-span TUPLES of row arrays in lockstep
    (axis 0 = records; empty spans allowed).  Device ``i`` of a group
    holds rows ``[i*cap, (i+1)*cap)`` of the concatenated stream, and
    the final partial group ships in the smallest bucket that holds it
    (``bucket_cap``), or at ``cap`` with ``fixed_shape``.  With
    ``balance`` (the default: the stats drivers, whose sums do not
    depend on placement) the final partial group spreads evenly over the
    devices; ``tensor_batches`` passes ``balance=False`` and its rows
    fill the devices in order.  At n_dev = 1 both give the same groups.

    ``feed(stream, dispatch_fn)``: ``dispatch_fn(tensors, counts)`` gets
    ``tensors[j]`` as a [n_dev, bucket, *shape] view of a leased slot's
    host tensor; it must start the copies out of it before it returns,
    and return their in-flight handle (or None when the copies were
    synchronous).  The slot goes back to the ring when the call returns.

    ``stream(stream, emit_fn)``: a generator of ``value`` for each
    ``(value, handle) = emit_fn(tensors, counts)``; the views stay valid
    until the consumer advances the generator, and only then does the
    slot go back to the ring.  In both forms the ring waits on the
    handle before the packer writes the slot again."""

    def __init__(self, n_dev: int, cap: int, specs: Sequence[TileSpec],
                 *, block_n: int = 256, fixed_shape: bool = False,
                 balance: bool = True, pin_memory: bool = False):
        self.n_dev, self.cap = int(n_dev), int(cap)
        self.specs = list(specs)
        self.block_n = int(block_n)
        self.fixed_shape = bool(fixed_shape)
        self.balance = bool(balance)
        self.pin_memory = bool(pin_memory)
        self.dispatches = 0

    def _pack_loop(self, stream: Iterable[Tuple[np.ndarray, ...]],
                   q: "queue.Queue", cancel: threading.Event,
                   ring: StagingRing) -> None:
        it = iter(stream)
        parts: "collections.deque[Tuple[np.ndarray, ...]]" = \
            collections.deque()
        have = 0
        exhausted = False

        def pull_until(need: int) -> None:
            nonlocal exhausted, have
            while not exhausted and have < need:
                if cancel.is_set():
                    raise Cancelled()
                try:
                    arrays = tuple(next(it))
                except StopIteration:
                    exhausted = True
                    return
                if arrays[0].shape[0]:
                    parts.append(arrays)
                    have += arrays[0].shape[0]

        while True:
            # one group's worth buffered up front: the tail split
            # depends on the total
            pull_until(self.n_dev * self.cap)
            if not have:
                break
            slot = ring.lease(cancel)
            counts = slot.counts
            counts[:] = 0
            target = self.cap
            if self.balance and exhausted and have < self.n_dev * self.cap:
                target = max(1, -(-have // self.n_dev))
            for dev in range(self.n_dev):
                filled = 0
                while filled < target:
                    if not parts:
                        pull_until(1)
                        if not parts:
                            break
                    head = parts[0]
                    k = min(target - filled, head[0].shape[0])
                    for dst, src in zip(slot.arrays, head):
                        dst[dev, filled:filled + k] = src[:k]
                    if k == head[0].shape[0]:
                        parts.popleft()
                    else:
                        parts[0] = tuple(h[k:] for h in head)
                    filled += k
                    have -= k
                counts[dev] = filled
                if not parts and exhausted:
                    break
            bucket = self.cap if self.fixed_shape else max(
                bucket_cap(int(c), self.cap, self.block_n) for c in counts)
            # zero only rows [count, bucket) per device: rows under the
            # count were just written, rows past the bucket never ship
            for spec, dst in zip(self.specs, slot.arrays):
                for dev in range(self.n_dev):
                    c = int(counts[dev])
                    if c < bucket:
                        dst[dev, c:bucket] = spec.pad
            _put(q, (slot, bucket), cancel)

    def _slots(self, span_stream: Iterable[Tuple[np.ndarray, ...]]
               ) -> Iterator[Tuple[RingSlot, Tuple[torch.Tensor, ...]]]:
        """Leased ``(slot, bucket views)`` pairs; a slot goes back to the
        ring when the generator is advanced or closed."""
        ring = StagingRing(self.n_dev, self.cap, self.specs,
                           pin_memory=self.pin_memory)
        q: "queue.Queue" = queue.Queue(maxsize=1)
        cancel = threading.Event()
        errs: List[BaseException] = []

        def pack() -> None:
            try:
                self._pack_loop(span_stream, q, cancel, ring)
            except Cancelled:
                return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
            try:
                _put(q, _SENTINEL, cancel)
            except Cancelled:
                pass

        # the packer runs under the caller's contextvars snapshot, so
        # what the span stream counts lands in the caller's metrics
        ctx = contextvars.copy_context()
        packer = threading.Thread(target=lambda: ctx.run(pack),
                                  name="hbam-feed-pack", daemon=True)
        self.dispatches = 0
        packer.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                slot, bucket = item
                try:
                    yield slot, tuple(t[:, :bucket] for t in slot.tensors)
                finally:
                    ring.release(slot)
        finally:
            cancel.set()
            packer.join()
        if errs:
            raise errs[0]

    def stream(self, span_stream: Iterable[Tuple[np.ndarray, ...]],
               emit_fn: Callable) -> Iterator:
        """Generator form: yields ``value`` of each group's
        ``(value, handle) = emit_fn(tensors, counts)``; the group's slot
        is released only once the consumer asks for the next value."""
        with contextlib.closing(self._slots(span_stream)) as slots:
            for slot, tensors in slots:
                value, slot.in_flight = emit_fn(tensors, slot.counts)
                self.dispatches += 1
                yield value

    def feed(self, span_stream: Iterable[Tuple[np.ndarray, ...]],
             dispatch_fn: Callable) -> int:
        """Drive the whole stream through ``dispatch_fn``; returns the
        number of dispatched groups."""
        for _ in self.stream(span_stream, lambda tensors, counts: (
                None, dispatch_fn(tensors, counts))):
            pass
        return self.dispatches
