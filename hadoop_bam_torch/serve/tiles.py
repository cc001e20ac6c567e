"""The second cache tier: DEVICE-RESIDENT decoded interval tiles (copy of
hadoop_bam_tpu/serve/tiles.py).

The query engine's ``ChunkCache`` only avoids re-*reading*: a warm query
still decodes candidate rows to columns on the host and copies them to
the card.  This module keeps the decoded ``[n_dev, cap]`` interval
columns (``rid`` / ``pos1`` / ``end1`` + per-device counts) resident on
the device, keyed by ``(file_identity, chunk range, projection)``:

- a TILE HIT skips fetch + inflate + host decode + transfer and goes
  straight to the interval-filter step (``tile_filter_step``, the rest
  of K13): the warm serving path does no host decode at all;
- the budget is in DEVICE bytes, strict LRU, with proactive
  invalidation: putting a tile for a path whose ``file_identity``
  changed purges every tile of the old identity;
- host-built tiles are assembled through a ``StagingRing``
  (``TileBuilder``); a slot whose device copy IS the slot's memory (a
  CPU device: ``tensor.to("cpu")`` returns the same tensor) is PINNED
  out of the ring, so a cached tile is never rewritten by a recycled
  slot (the churn proof in tests/test_torch_serve.py);
- ``device_build_chunk`` builds a cold tile on the device plane: host
  tokenize, then K7+K8, K9 and K10i on the card
  (``ops/inflate_device.resolve_walk_intervals``), so the columns never
  exist on the host.

Counters: ``serve.tile_hits`` / ``serve.tile_misses`` /
``serve.tile_evictions`` / ``serve.tile_invalidations`` /
``serve.tile_oversize`` / ``serve.device_tile_builds``, plus
per-instance ``stats()``.  The port holds one device (``n_dev`` 1): the
reference shards a group over its mesh.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.resilience import chaos
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

# the one projection served today: interval-overlap columns
INTERVAL_PROJECTION = "intervals"


@dataclasses.dataclass
class TileGroup:
    """One device group of a tile set: ``cols`` is the (rid, pos1, end1)
    triple of ``[n_dev, cap]`` int32 device tensors, ``counts`` the
    ``[n_dev]`` int32 per-device row counts (a device tensor), ``n`` the
    live rows in this group."""
    cols: Tuple
    counts: object
    n: int


@dataclasses.dataclass
class TileSet:
    """Every device group of one decoded chunk, plus accounting."""
    groups: List[TileGroup]
    n: int                       # total candidate rows
    nbytes: int                  # device-resident footprint
    ident: Tuple                 # file_identity the tiles decode


def tile_key(ident: Tuple, kind: str, s: int, e: int,
             n_dev: int, cap: int,
             projection: str = INTERVAL_PROJECTION) -> Tuple:
    """(file_identity, region bucket, projection), plus the tile
    geometry: tiles built for one geometry cannot serve another."""
    return (ident, kind, s, e, projection, n_dev, cap)


class DeviceTileCache:
    """Byte-budgeted LRU of device-resident ``TileSet`` values.

    Thread-safe (the dispatcher thread reads and writes it while stats
    readers poll from transport threads); values are built and consumed
    only on the dispatcher thread, so the lock guards the map, not the
    device tensors."""

    def __init__(self, byte_budget: int = 512 << 20):
        if byte_budget <= 0:
            raise PlanError(
                f"serve tile cache byte budget must be positive, got "
                f"{byte_budget}")
        self.byte_budget = int(byte_budget)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, TileSet]" = OrderedDict()
        self._by_path: Dict[str, set] = {}   # abspath -> live keys
        self._ident_of: Dict[str, Tuple] = {}  # abspath -> newest identity
        self._bytes = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._invalidated = 0

    @staticmethod
    def _abspath(key: Hashable) -> str:
        return key[0][0]          # tile_key ident = (abspath, size, mtime)

    def get(self, key: Hashable) -> Optional[TileSet]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._misses += 1
                METRICS.count("serve.tile_misses")
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            METRICS.count("serve.tile_hits")
            return hit

    def put(self, key: Hashable, tiles: TileSet) -> None:
        nbytes = max(0, int(tiles.nbytes))
        path = self._abspath(key)
        with self._lock:
            prev_ident = self._ident_of.get(path)
            if prev_ident is not None and prev_ident != tiles.ident:
                # the file changed on disk: its old tiles can never hit
                # again; purge them now, even when the new tile is
                # rejected as oversize below
                self._purge_path_locked(path)
            if nbytes > self.byte_budget:
                METRICS.count("serve.tile_oversize")
                return
            self._ident_of[path] = tiles.ident
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = tiles
            self._by_path.setdefault(path, set()).add(key)
            self._bytes += nbytes
            while self._bytes > self.byte_budget and len(self._entries) > 1:
                k, v = self._entries.popitem(last=False)
                self._drop_locked(k, v)
                self._evictions += 1
                METRICS.count("serve.tile_evictions")

    def _drop_locked(self, key: Hashable, tiles: TileSet) -> None:
        self._bytes -= tiles.nbytes
        path = self._abspath(key)
        keys = self._by_path.get(path)
        if keys is not None:
            keys.discard(key)
            if not keys:
                self._by_path.pop(path, None)
                self._ident_of.pop(path, None)

    def _purge_path_locked(self, path: str) -> None:
        for k in list(self._by_path.get(path, ())):
            v = self._entries.pop(k, None)
            if v is not None:
                self._drop_locked(k, v)
                self._invalidated += 1
                METRICS.count("serve.tile_invalidations")

    def invalidate_path(self, path: str) -> None:
        """Drop every tile of ``path`` (any identity)."""
        with self._lock:
            self._purge_path_locked(os.path.abspath(path))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_path.clear()
            self._ident_of.clear()
            self._bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "byte_budget": self.byte_budget,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "invalidated": self._invalidated,
                "hit_rate": (self._hits / total) if total else 0.0,
            }


# ---------------------------------------------------------------------------
# device filter step: cached tiles x one query interval (the rest of K13)
# ---------------------------------------------------------------------------

def tile_filter_step(rid: torch.Tensor, pos1: torch.Tensor,
                     end1: torch.Tensor, count: torch.Tensor,
                     iv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1-based inclusive overlap of a cached tile's ``[n_dev, cap]``
    int32 (rid, pos1, end1) columns with ONE interval ``iv = [rid, beg,
    end]`` (an int32 [3] tensor on the tile's device), for rows under
    each device's ``count``.  Returns ``(keep, hits)``: the bool
    ``[n_dev, cap]`` mask and the int32 ``[n_dev]`` match counts.  The
    interval is a runtime argument, so one resident tile serves every
    query that lands on its chunk.  Torch elementwise ops and a row sum,
    no hand kernel (the reference jits the same compares as XLA code)."""
    tile_filter_step.launches += 1
    cap = rid.shape[-1]
    valid = torch.arange(cap, dtype=torch.int32,
                         device=rid.device)[None, :] < count[:, None]
    keep = valid & (rid == iv[0]) & (pos1 <= iv[2]) & (end1 >= iv[1])
    return keep, keep.sum(dim=1, dtype=torch.int32)


tile_filter_step.launches = 0   # calls (chip_smoke counts the main path's)


# ---------------------------------------------------------------------------
# tile assembly through a staging ring with slot pinning
# ---------------------------------------------------------------------------

class TileBuilder:
    """Assembles decoded chunk columns into device ``TileSet`` s through a
    ``StagingRing``.  A group's device copy that IS the slot's memory
    (the CPU: ``tensor.to("cpu")`` returns the same tensor) pins the
    slot, which transfers its buffers out of ring circulation for the
    tile's lifetime (the ring mints a replacement); a real copy (the
    card) records its event on the slot instead, and the ring waits on
    it before leasing the slot again.  Every method runs on ONE thread
    (the serve dispatcher), on that thread's current CUDA stream."""

    def __init__(self, device: torch.device, cap: int, ring_slots: int = 3):
        from hadoop_bam_torch.parallel.pipeline import _TokenRing
        from hadoop_bam_torch.parallel.staging import StagingRing, TileSpec

        self.device = torch.device(device)
        self.n_dev = 1
        self.cap = int(cap)
        if self.cap < 1:
            raise PlanError(f"serve_tile_records must be >= 1, got {cap}")
        cuda = self.device.type == "cuda"
        # rid pads with -1 so a padding row can never match a real
        # reference id even if a bug ever ignored the count mask
        self.specs = [TileSpec((), np.int32, -1),
                      TileSpec((), np.int32, 0),
                      TileSpec((), np.int32, 0)]
        self._ring = StagingRing(self.n_dev, self.cap, self.specs,
                                 pin_memory=cuda,
                                 slots=max(3, int(ring_slots)))
        self._tokens = _TokenRing(pin_memory=cuda)
        self._cancel = threading.Event()
        # interval LRU: hot regions repeat, so the warm path skips even
        # the [3] interval's copy to the card
        self._iv_cache: "OrderedDict[Tuple[int, int, int], torch.Tensor]" = \
            OrderedDict()

    def put_interval(self, iv) -> torch.Tensor:
        """A ``[rid, beg, end]`` int32 interval on the device for the
        filter step (LRU-cached, 256 entries)."""
        key = (int(iv[0]), int(iv[1]), int(iv[2]))
        hit = self._iv_cache.get(key)
        if hit is not None:
            self._iv_cache.move_to_end(key)
            return hit
        dev = torch.tensor(key, dtype=torch.int32).to(self.device)
        while len(self._iv_cache) >= 256:
            self._iv_cache.popitem(last=False)
        self._iv_cache[key] = dev
        return dev

    def build(self, ident: Tuple, cols: Dict[str, object]) -> TileSet:
        """Device tiles from one decoded chunk's host columns (the
        ``rid`` / ``pos1`` / ``end1`` arrays of ``QueryEngine._chunk``).
        Rows pack serially: group g, device d holds rows
        ``[g*n_dev*cap + d*cap, ...+cap)`` of the chunk."""
        from hadoop_bam_torch.parallel.pipeline import _CopiesDone

        n = int(cols["n"])
        host = (np.asarray(cols["rid"], np.int32),
                np.asarray(cols["pos1"], np.int32),
                np.asarray(cols["end1"], np.int32))
        if n == 0:
            # empty chunks cache as an empty TileSet: the lookup still
            # hits (no re-decode), the filter loop has nothing to do
            return TileSet(groups=[], n=0, nbytes=64, ident=ident)
        groups: List[TileGroup] = []
        nbytes = 0
        dev = self.device
        with METRICS.span("serve.tile_build_wall", rows=n):
            per_group = self.n_dev * self.cap
            for base in range(0, n, per_group):
                slot = self._ring.lease(self._cancel)
                counts = slot.counts
                counts[:] = 0
                for d in range(self.n_dev):
                    lo = base + d * self.cap
                    k = max(0, min(self.cap, n - lo))
                    for dst, src in zip(slot.arrays, host):
                        if k:
                            dst[d, :k] = src[lo:lo + k]
                    counts[d] = k
                # pad rows past each device's count (a recycled slot may
                # carry an earlier chunk's rows)
                for spec, dst in zip(self.specs, slot.arrays):
                    for d in range(self.n_dev):
                        c = int(counts[d])
                        if c < self.cap:
                            dst[d, c:] = spec.pad
                tiles = tuple(t.to(dev, non_blocking=True)
                              for t in slot.tensors)
                # counts by device-side fills: a copy from pageable host
                # memory would synchronise the stream every group
                cnt = torch.empty(self.n_dev, dtype=torch.int32, device=dev)
                for d in range(self.n_dev):
                    cnt[d] = int(counts[d])
                if any(t.data_ptr() == s.data_ptr()
                       for t, s in zip(tiles, slot.tensors)):
                    # the tile IS the slot's memory: ownership transfer,
                    # the ring replaces the slot and never leases this
                    # memory again
                    slot.pin()
                else:
                    copies = _CopiesDone()
                    copies.record(dev)
                    slot.in_flight = copies.handle()
                slot.release()
                groups.append(TileGroup(cols=tiles, counts=cnt,
                                        n=int(min(n - base, per_group))))
                nbytes += sum(int(t.nbytes) for t in tiles) + cnt.nbytes
        return TileSet(groups=groups, n=n, nbytes=nbytes + 64, ident=ident)

    def stage_tokens(self, chunk):
        """One token chunk on the device ([B, T] tokens, [B] counts and
        sizes), through the builder's pinned token ring."""
        return self._tokens.stage(chunk, self.device)

    def close(self) -> None:
        self._cancel.set()


def device_build_chunk(builder: TileBuilder, ident: Tuple, path: str,
                       s: int, e: int, config) -> Optional[TileSet]:
    """Cold serve-tile build on the device decode plane: host tokenize
    (native Huffman) -> K7+K8 resolve, K9 walk and the K10i interval
    columns on the card (``resolve_walk_intervals``) -> device tiles.
    The (rid, pos1, end1) columns never exist on the host, and the four
    verdict scalars come back in one copy per chunk.

    Returns None whenever the chunk needs the host build instead: more
    blocks than the plane's chunk, a CIGAR past ``DEVICE_TILE_CIGAR_CAP``
    ops, more records than the walk's capacity, a record cut at the
    buffer's end, or a malformed record chain (the host path then
    decodes it and raises the canonical error if the bytes are bad).
    Declining is not a device fault; BGZF-level corruption raises here
    (in the tokenize), which the serve loop's ladder may demote."""
    from hadoop_bam_torch.ops.inflate_device import (
        require_tokenizer, resolve_walk_intervals,
    )
    from hadoop_bam_torch.parallel.pipeline import _tokenize_span_tokens
    from hadoop_bam_torch.split.spans import FileVirtualSpan

    require_tokenizer()
    chunk = _tokenize_span_tokens(path, FileVirtualSpan(path, s, e),
                                  bool(config.check_crc))
    if chunk is None:
        return TileSet(groups=[], n=0, nbytes=64, ident=ident)
    if chunk.used < chunk.n_blocks:
        return None
    # chaos point at the plane's dispatch boundary: the serve loop's
    # ladder demotes an injected fault here to the host tile build
    chaos.fire("device.step", blocks=int(chunk.used))
    with METRICS.span("serve.device_resolve_wall", blocks=chunk.used):
        tokens, nt, isz = builder.stage_tokens(chunk)
        rid, pos1, end1, n_all, tail, bad, over = resolve_walk_intervals(
            tokens, nt, isz, chunk.start, chunk.stop, chunk.P)
        # ONE fetch of the four verdict scalars per chunk
        n_i, tail_i, bad_i, over_i = torch.stack(
            [n_all, tail, bad, over]).tolist()
    R = int(rid.shape[0])
    if bad_i or over_i or n_i > R or tail_i < chunk.stop:
        return None
    if n_i == 0:
        return TileSet(groups=[], n=0, nbytes=64, ident=ident)
    cap, n_dev = builder.cap, builder.n_dev
    per_group = n_dev * cap
    n_groups = -(-n_i // per_group)
    padded = n_groups * per_group
    with METRICS.span("serve.tile_build_wall", rows=n_i):
        def shard(col: torch.Tensor, fill: int) -> torch.Tensor:
            # the kernel's rows past the walked records already hold the
            # pads (rid -1, pos1 = end1 = 0); extend with the same fills
            # to the group grid (the host builder's TileSpec pads)
            if padded > R:
                col = torch.cat([col, torch.full(
                    (padded - R,), fill, dtype=col.dtype,
                    device=col.device)])
            else:
                col = col[:padded].clone()
            return col.reshape(n_groups, n_dev, cap)

        cols = (shard(rid, -1), shard(pos1, 0), shard(end1, 0))
        counts = np.zeros((n_groups, n_dev), np.int32)
        for g in range(n_groups):
            for d in range(n_dev):
                lo = g * per_group + d * cap
                counts[g, d] = max(0, min(cap, n_i - lo))
        counts_dev = torch.from_numpy(counts).to(builder.device)
        groups = [TileGroup(cols=tuple(c[g] for c in cols),
                            counts=counts_dev[g],
                            n=int(min(n_i - g * per_group, per_group)))
                  for g in range(n_groups)]
        nbytes = sum(int(c.nbytes) for c in cols) + counts_dev.nbytes
    METRICS.count("serve.device_tile_builds")
    return TileSet(groups=groups, n=n_i, nbytes=nbytes + 64, ident=ident)
