"""k-way streaming merge: the heap core of the mesh sort's spill merge
(copy of hadoop_bam_tpu/split/kmerge.py).

Contracts (tests/test_torch_write.py holds them against the reference):

- **Heap order**: the output is sorted by ``key`` given each input
  stream is sorted by ``key``.  Inputs are streamed: one buffered item
  per live stream, never materialized.
- **Ties** yield in STREAM order (stream 0's item before stream 1's), as
  ``heapq.merge`` does; the mesh sort's byte identity rests on it.
- **Exhausted streams** drop out of the heap without disturbing the
  rest; **empty inputs** (no streams, or all streams empty) yield
  nothing.
"""
from __future__ import annotations

import heapq
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

_IDENT = object()


def _merge_entries(streams: Iterable[Iterable], key: Optional[Callable]
                   ) -> Iterator[Tuple[object, int, object]]:
    """The shared heap core: yield ``(key(item), stream_index, item)``
    in globally sorted order — the key rides along so consumers that
    group on it (``kmerge_grouped``) never recompute it."""
    keyf = (lambda x: x) if key is None else key
    # heap entries are (key, stream_index, item, iterator); the stream
    # index is unique per entry, so comparison never falls through to
    # the item (which may not be orderable)
    heap: List[Tuple[object, int, object, Iterator]] = []
    for si, s in enumerate(streams):
        it = iter(s)
        for item in it:               # at most once: prime the stream
            heap.append((keyf(item), si, item, it))
            break
    heapq.heapify(heap)
    while heap:
        k, si, item, it = heap[0]
        yield k, si, item
        nxt = next(it, _IDENT)
        if nxt is _IDENT:
            heapq.heappop(heap)       # stream exhausted: drop out
        else:
            heapq.heapreplace(heap, (keyf(nxt), si, nxt, it))


def kmerge_indexed(streams: Iterable[Iterable], key: Optional[Callable] = None
                   ) -> Iterator[Tuple[int, object]]:
    """Merge sorted ``streams``; yield ``(stream_index, item)`` in
    globally sorted order (ties in stream-index order).

    The stream index is what the cohort join keys sample columns on:
    a site group knows WHICH sample contributed each record without
    the records carrying it themselves.
    """
    for _k, si, item in _merge_entries(streams, key):
        yield si, item


def kmerge(streams: Iterable[Iterable], key: Optional[Callable] = None
           ) -> Iterator:
    """Merge sorted ``streams`` into one sorted stream of items
    (``heapq.merge`` semantics: stable, streaming, ties in stream
    order).  The mesh-sort spill merge runs on this."""
    for _si, item in kmerge_indexed(streams, key=key):
        yield item


def kmerge_grouped(streams: Iterable[Iterable], key: Callable
                   ) -> Iterator[Tuple[object, List[Tuple[int, object]]]]:
    """Merge sorted ``streams`` and group runs of EQUAL keys: yields
    ``(key, [(stream_index, item), ...])`` with the group's members in
    stream order — the cohort join's unit of work (one joined site =
    every sample's record at one (contig, pos)).

    A stream that emits several items with the same key contributes
    them all to one group (the "duplicate positions within one input"
    case — the consumer decides which wins)."""
    group: List[Tuple[int, object]] = []
    cur = _IDENT
    # the heap core already computed every item's key: group on it
    # instead of paying the key function a second time per record
    for k, si, item in _merge_entries(streams, key):
        if k != cur and group:
            yield cur, group
            group = []
        cur = k
        group.append((si, item))
    if group:
        yield cur, group
