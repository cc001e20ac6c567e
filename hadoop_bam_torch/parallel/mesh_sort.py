"""Bucketed coordinate sort of a BAM on the card: the MapReduce shuffle
of the reference's ``sort`` (copy of hadoop_bam_tpu/parallel/mesh_sort.py,
one process on one device).

1. span planning gives each device a record-balanced slice of the file
   (``split/planners.plan_bam_spans_balanced``);
2. each device derives its records' sort keys on the card (the index
   exchange through K1, ``ops/unpack_bam.unpack_fixed_fields``; the
   bytes exchange from the packed rows' heads);
3. keys are range-partitioned into one bucket a device (bounds sampled on
   the host) and exchanged (all_to_all; with one device, the identity);
4. each device sorts its bucket on (key_hi, key_lo, global input index):
   the index makes ties deterministic, so the order is the stable sort's;
5. the host writes bucket 0..n-1 in turn through
   ``write.write_bam_records``: byte-identical to ``utils/sort.sort_bam``.

K15, the reference's XLA step (``_make_sort_step``,
``_make_bytes_sort_step``), is torch ops here (``sort_step``,
``bytes_sort_step``; ``.launches`` counts their calls): keys are held in
int64 and masked to 32 bits, since torch has no uint32 compare, shift or
modulo.  A step's rows arrive in ascending global index (one device:
the send matrix keeps row order, sentinel pads last), so its
(hi, lo, index) sort is one stable sort on a packed int64 (hi, lo) key
with the unmapped sentinel last; ``sort_order`` is the general form for
rows in any order.  Global indices are int32, as in the reference.
``_device_keys``, ``_bucket_pack`` and ``_send_matrices`` take any device
count; the exchange itself runs on one device.

``exchange="index"`` ships keys and global indices only, and the host
gathers record bytes from its decoded spans; ``exchange="bytes"`` ships
the records as fixed-stride rows and applies the permutation on the card.
``round_records`` engages the spill exchange: the plan is cut into
~round_records-record spans, each round ships one span a device, its
bucket-sorted rows spill to framed run files, and a k-way merge a bucket
rebuilds the single-round order, so device memory is bounded by the
round's tile.  ``journal_path`` makes it crash-safe (``jobs/journal.py``).
The int32 global index caps the total at 2^31 - 2 records.

Deliberate differences: one process, so the multi-host branches of the
reference (shard files merged by host 0, collectives under failure
flags) are not reached; ``device`` stands where the reference takes a
mesh; queryname order is ``utils/sort``'s business in both.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.utils.errors import PlanError

_I32_SENTINEL = 2**31 - 1
_U32 = 0xFFFFFFFF
GLOBAL_INDEX_CEILING = 2**31 - 2     # int32 global record indices
_PACK_ROWS = 1 << 16                 # rows a device gather packs at once


def check_global_index_ceiling(n_records: int, where: str) -> None:
    """PlanError when a record count cannot fit the sort's int32 global
    index: a too-large input is a configuration fault, neither retried
    nor quarantined, and the message says what to do instead."""
    if n_records > GLOBAL_INDEX_CEILING:
        raise PlanError(
            f"{where}: {n_records} records exceed the mesh sort's int32 "
            f"global-index ceiling ({GLOBAL_INDEX_CEILING}). The spill "
            f"exchange (round_records=N) bounds device memory but shares "
            f"the same global index: sort the input as <2^31-record "
            f"chunks, then merge the sorted chunks, or run "
            f"utils.sort.sort_bam directly.")


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _keys_of(data: np.ndarray, offs: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """(hi, lo) uint32 coordinate keys from raw record bytes on the host:
    hi = refid (unmapped: 2^32 - 1, last), lo = pos + 1 wrapped to 32
    bits.  Bucket bounds are sampled from them; the step re-derives
    keys on the device."""
    base = offs.astype(np.int64)
    refid = (data[base[:, None] + np.arange(4, 8)]
             .view(np.int32).ravel())
    pos = (data[base[:, None] + np.arange(8, 12)]
           .view(np.int32).ravel())
    hi = np.where(refid < 0, np.uint32(_U32), refid.astype(np.uint32))
    lo = pos.astype(np.uint32) + np.uint32(1)
    return hi, lo


def _sample_bounds(his: List[np.ndarray], los: List[np.ndarray],
                   n_dev: int, max_sample: int = 1 << 16
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """n_dev - 1 lexicographic (hi, lo) bucket bounds from a key sample:
    bucket b takes keys in [bound_{b-1}, bound_b)."""
    hi = np.concatenate(his) if his else np.zeros(0, np.uint32)
    lo = np.concatenate(los) if los else np.zeros(0, np.uint32)
    n = hi.size
    if n > max_sample:
        step = n // max_sample
        hi, lo = hi[::step], lo[::step]
        n = hi.size
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    picks = (np.arange(1, n_dev) * n) // n_dev if n else np.zeros(
        0, np.int64)
    bhi = hi[picks] if n else np.zeros(n_dev - 1, np.uint32)
    blo = lo[picks] if n else np.zeros(n_dev - 1, np.uint32)
    return bhi.astype(np.uint32), blo.astype(np.uint32)


# ---------------------------------------------------------------------------
# K15: the device step, torch ops
# ---------------------------------------------------------------------------

def _device_keys(refid: torch.Tensor, pos: torch.Tensor,
                 valid: torch.Tensor, base: int, R: int):
    """(hi, lo) int64 and gidx int32 device keys, the one definition of
    the key convention for both exchanges: hi = refid, or 2^32 - 1 when
    unmapped or past ``count``; lo = pos + 1 wrapped to 32 bits,
    2^32 - 1 past ``count``; gidx = base + row, the int32 sentinel past
    ``count``."""
    refid = refid.to(torch.int64)
    hi = torch.where(refid < 0, torch.full_like(refid, _U32), refid)
    lo = (pos.to(torch.int64) + 1) & _U32
    pad = torch.full_like(hi, _U32)
    hi = torch.where(valid, hi, pad)
    lo = torch.where(valid, lo, pad)
    gidx = torch.where(valid,
                       base + torch.arange(R, dtype=torch.int32,
                                           device=hi.device),
                       torch.full((R,), _I32_SENTINEL, dtype=torch.int32,
                                  device=hi.device))
    return hi, lo, gidx


def _bucket_pack(hi: torch.Tensor, lo: torch.Tensor, bhi: torch.Tensor,
                 blo: torch.Tensor, R: int):
    """Each row's bucket (how many bounds are <= its key) and the stable
    scatter coordinates of the send matrices: (perm, dest bucket,
    rank within it)."""
    bhi = bhi.to(torch.int64)
    blo = blo.to(torch.int64)
    ge = ((hi[:, None] > bhi[None, :])
          | ((hi[:, None] == bhi[None, :]) & (lo[:, None] >= blo[None, :])))
    bucket = ge.sum(dim=1)
    perm = torch.argsort(bucket, stable=True)
    sb = bucket[perm]
    rank = torch.arange(R, device=hi.device) - torch.searchsorted(
        sb, sb, side="left")
    return perm, sb, rank


def _send_matrices(hi, lo, gidx, perm, sb, rank, n_dev: int, R: int):
    """[n_dev, R] send matrices of the key triple, sentinel-filled so an
    unfilled cell sorts last and drops at write time."""
    idx = (sb, rank)
    send_hi = torch.full((n_dev, R), _U32, dtype=torch.int64,
                         device=hi.device).index_put_(idx, hi[perm])
    send_lo = torch.full((n_dev, R), _U32, dtype=torch.int64,
                         device=hi.device).index_put_(idx, lo[perm])
    send_ix = torch.full((n_dev, R), _I32_SENTINEL, dtype=torch.int32,
                         device=hi.device).index_put_(idx, gidx[perm])
    return send_hi, send_lo, send_ix


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Row b of each device's send matrix goes to device b: on one device,
    the matrix itself."""
    if x.shape[0] != 1:
        raise PlanError(f"the port's sort exchanges on one device, not "
                        f"{x.shape[0]}")
    return x


def key_order(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The stable permutation sorting rows by (hi, lo): one stable sort
    on the packed int64 key (hi - 2^31) << 32 | lo, with hi's sentinel
    2^32 - 1 moved to 2^31 (after every refid, which is below it).  On
    rows in ascending global index, as a step receives them, it is the
    reference's three-key ``lax.sort`` on (hi, lo, index)."""
    h = torch.where(hi == _U32, torch.full_like(hi, 1 << 31), hi)
    return torch.sort(((h - (1 << 31)) << 32) | lo, stable=True).indices


def sort_order(hi: torch.Tensor, lo: torch.Tensor, ix: torch.Tensor
               ) -> torch.Tensor:
    """The permutation sorting rows in any order by (hi, lo, ix), as the
    reference's three-key ``lax.sort``: a stable sort on ix, then
    ``key_order``."""
    first = torch.sort(ix, stable=True).indices
    return first[key_order(hi[first], lo[first])]


def sort_step(data: torch.Tensor, offsets: torch.Tensor, count: int,
              base: int, bhi: torch.Tensor, blo: torch.Tensor
              ) -> torch.Tensor:
    """K15, the index exchange's step on one device: record prefixes
    through K1 (``unpack_fixed_fields``), keys, buckets, the exchange and
    the bucket sort.  data uint8 [D], offsets int32 [R] (padded with
    safe offsets), ``count`` valid rows from global index ``base``; bhi /
    blo the n_dev - 1 bucket bounds.  Returns the bucket's global indices
    in sorted order, int32 [n_dev * R], sentinel-padded."""
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields
    sort_step.launches += 1
    R = offsets.shape[0]
    n_dev = bhi.shape[0] + 1
    cols = unpack_fixed_fields(data, offsets)
    valid = torch.arange(R, device=data.device) < count
    hi, lo, gidx = _device_keys(cols["refid"], cols["pos"], valid, base, R)
    perm, sb, rank = _bucket_pack(hi, lo, bhi, blo, R)
    recv = [_all_to_all(x).reshape(-1) for x in
            _send_matrices(hi, lo, gidx, perm, sb, rank, n_dev, R)]
    return recv[2][key_order(recv[0], recv[1])]


sort_step.launches = 0


def _le_i32(rows: torch.Tensor, col: int) -> torch.Tensor:
    """The little-endian int32 at byte ``col`` of every row."""
    b = rows[:, col:col + 4].to(torch.int64)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return torch.where(v >= 1 << 31, v - (1 << 32), v)


def bytes_sort_step(rows: torch.Tensor, lens: torch.Tensor, count: int,
                    base: int, bhi: torch.Tensor, blo: torch.Tensor):
    """K15, the bytes exchange's step on one device: keys from the packed
    rows' heads (refID at byte 4, pos at 8), buckets, the exchange of
    (keys, index, length, row) and the bucket sort, the permutation
    applied on the card.  rows uint8 [R, stride], lens int32 [R].
    Returns (sorted rows [N, stride], lengths [N], int32 global indices
    [N]), N = n_dev * R, sentinel-padded."""
    bytes_sort_step.launches += 1
    R, stride = rows.shape
    n_dev = bhi.shape[0] + 1
    valid = torch.arange(R, device=rows.device) < count
    hi, lo, gidx = _device_keys(_le_i32(rows, 4), _le_i32(rows, 8), valid,
                                base, R)
    perm, sb, rank = _bucket_pack(hi, lo, bhi, blo, R)
    send = _send_matrices(hi, lo, gidx, perm, sb, rank, n_dev, R)
    send_ln = torch.zeros((n_dev, R), dtype=torch.int32,
                          device=rows.device).index_put_((sb, rank),
                                                         lens[perm])
    send_rows = torch.zeros((n_dev, R, stride), dtype=torch.uint8,
                            device=rows.device).index_put_((sb, rank),
                                                           rows[perm])
    r_hi, r_lo, r_ix = (_all_to_all(x).reshape(-1) for x in send)
    recv_ln = _all_to_all(send_ln).reshape(-1)
    recv_rows = _all_to_all(send_rows).reshape(-1, stride)
    order = key_order(r_hi, r_lo)
    return recv_rows[order], recv_ln[order], r_ix[order]


bytes_sort_step.launches = 0


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def _record_lens(data: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """Each record's byte length (block_size + its own 4 bytes)."""
    base = offs.astype(np.int64)
    return (data[base[:, None] + np.arange(4)].view("<i4").ravel()
            .astype(np.int64) + 4)


def pack_rows(data: torch.Tensor, offs: np.ndarray, lens: np.ndarray,
              records_cap: int, stride: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-padded [records_cap, stride] uint8 rows and int32 lengths of a
    span's records, gathered on ``data``'s device: the fixed-shape unit
    the bytes exchange ships."""
    dev = data.device
    rows = torch.zeros((records_cap, stride), dtype=torch.uint8, device=dev)
    ln = torch.zeros(records_cap, dtype=torch.int32, device=dev)
    n = int(offs.size)
    if not n:
        return rows, ln
    if int(lens.max()) > stride:
        raise ValueError(f"record of {int(lens.max())} bytes exceeds the "
                         f"agreed row stride {stride}")
    offs_t = torch.from_numpy(offs.astype(np.int64)).to(dev)
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    ln[:n] = lens_t
    col = torch.arange(stride, device=dev)
    last = data.shape[0] - 1
    for a in range(0, n, _PACK_ROWS):
        b = min(n, a + _PACK_ROWS)
        idx = (offs_t[a:b, None] + col).clamp_(max=last)
        keep = col[None, :] < lens_t[a:b, None]
        rows[a:b] = torch.where(keep, data[idx], 0)
    return rows, ln


def row_payload(rows: torch.Tensor, lens: torch.Tensor, six: torch.Tensor
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(record bytes, record starts) on the host of the sorted rows that
    hold a record (global index not the sentinel), in order."""
    keep = six != _I32_SENTINEL
    rows, lens = rows[keep], lens[keep].to(torch.int64)
    if not rows.shape[0]:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    col = torch.arange(rows.shape[1], device=rows.device)
    parts = []
    for a in range(0, rows.shape[0], _PACK_ROWS):
        b = min(rows.shape[0], a + _PACK_ROWS)
        parts.append(rows[a:b][col[None, :] < lens[a:b, None]].cpu())
    ln = lens.cpu().numpy()
    return torch.cat(parts).numpy(), np.cumsum(ln) - ln


def _frame_run(rows: np.ndarray, lens: np.ndarray, six: np.ndarray,
               hi: np.ndarray, lo: np.ndarray) -> bytes:
    """One bucket-round's sorted records framed for a spill run: per
    record <u32 hi><u32 lo><i32 gidx><i32 len><len payload bytes>; the
    frame carries the whole key, so the merge never re-derives it."""
    import itertools

    from hadoop_bam_torch.utils.sort import ragged_slices
    k = int(lens.size)
    if not k:
        return b""
    hdr = np.empty((k, 16), np.uint8)
    hdr[:, 0:4] = hi.astype("<u4")[:, None].view(np.uint8)
    hdr[:, 4:8] = lo.astype("<u4")[:, None].view(np.uint8)
    hdr[:, 8:12] = six.astype("<i4")[:, None].view(np.uint8)
    hdr[:, 12:16] = lens.astype("<i4")[:, None].view(np.uint8)
    heads = ragged_slices(hdr.ravel(), np.arange(k, dtype=np.int64) * 16,
                          np.full(k, 16, np.int64))
    bodies = ragged_slices(rows.ravel(),
                           np.arange(k, dtype=np.int64) * rows.shape[1],
                           lens)
    return b"".join(itertools.chain.from_iterable(zip(heads, bodies)))


def _iter_run_frames(path: str):
    """((hi, lo, gidx), payload) frames of one spilled run file."""
    import struct
    head = struct.Struct("<IIii").unpack_from
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    n = len(buf)
    while pos < n:
        hi, lo, gidx, ln = head(buf, pos)
        pos += 16
        yield (hi, lo, gidx), buf[pos:pos + ln]
        pos += ln


def _merge_bucket_runs(run_paths: List[str]) -> Tuple[bytes, np.ndarray]:
    """k-way merge of one bucket's sorted runs by the framed (hi, lo,
    gidx) key on ``split/kmerge.py``'s heap (ties in run order).
    Returns (record bytes, record lengths)."""
    from hadoop_bam_torch.split.kmerge import kmerge

    chunks: List[bytes] = []
    lens: List[int] = []
    for _key, payload in kmerge((_iter_run_frames(p) for p in run_paths),
                                key=lambda kv: kv[0]):
        chunks.append(payload)
        lens.append(len(payload))
    return b"".join(chunks), np.asarray(lens, dtype=np.int64)


def _decode(path: str, span, config: HBamConfig):
    from hadoop_bam_torch.parallel.pipeline import _decode_span_core
    data, offs, _v, _ = _decode_span_core(path, span, config.check_crc,
                                          config.host_backend,
                                          want_voffs=False)
    return data, offs


def _bounds(his, los, n_dev: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    bhi, blo = _sample_bounds(his, los, n_dev)
    return (torch.from_numpy(bhi.astype(np.int64)).to(dev),
            torch.from_numpy(blo.astype(np.int64)).to(dev))


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------

def sort_bam_mesh(input_path: str, output_path: str, *, device=None,
                  config: HBamConfig = DEFAULT_CONFIG,
                  header: Optional[SAMHeader] = None,
                  exchange: Optional[str] = None,
                  round_records: Optional[int] = None,
                  journal_path: Optional[str] = None) -> int:
    """Coordinate-sort a BAM on ``device`` (``cuda:0`` by default);
    byte-identical to ``utils/sort.sort_bam``.  Returns the record count.

    ``exchange`` is "index" (the default) or "bytes" (module docstring);
    ``round_records`` engages the spill exchange (bytes only; device
    memory bounded by the round's tile); ``journal_path`` makes the sort
    crash-safe: the spill exchange resumes at round grain, the resident
    exchanges at job grain (a finished job with a verified output is a
    no-op).  A mismatched input, config fingerprint or parameters
    refuses with PlanError."""
    from hadoop_bam_torch.device import resolve_device
    from hadoop_bam_torch.split.splitting_index import SplittingIndex

    if round_records is not None and exchange is None:
        exchange = "bytes"
    if exchange is None:
        exchange = "index"
    if exchange not in ("index", "bytes"):
        raise ValueError(f"unknown exchange mode {exchange!r}; "
                         f"expected 'index' or 'bytes'")
    if round_records is not None and exchange != "bytes":
        raise ValueError("round_records (the spill exchange) requires "
                         "exchange='bytes'")
    # a sidecar's exact record count refuses an oversized input before
    # anything is planned or decoded
    sidx = SplittingIndex.load_for(input_path)
    if sidx is not None and sidx.total_records > 0:
        check_global_index_ceiling(sidx.total_records, "mesh sort plan")
    dev = resolve_device(device)
    kw = dict(device=dev, config=config, header=header)
    if round_records is not None:
        return _sort_bam_mesh_bytes_spill(
            input_path, output_path, round_records=int(round_records),
            journal_path=journal_path, **kw)
    run = (_sort_bam_mesh_bytes if exchange == "bytes"
           else _sort_bam_mesh_index)
    if journal_path is not None:
        from hadoop_bam_torch.jobs.runner import (
            run_job_level, sort_job_params,
        )
        return run_job_level(
            journal_path, kind="mesh_sort", config=config,
            inputs=[input_path], output=output_path,
            params=sort_job_params(input_path, output_path,
                                   exchange=exchange, round_records=None),
            run=lambda: run(input_path, output_path, **kw))
    return run(input_path, output_path, **kw)


def _sort_bam_mesh_index(input_path: str, output_path: str, *, device,
                         config: HBamConfig,
                         header: Optional[SAMHeader]) -> int:
    """The index exchange: keys and global indices ride the exchange;
    the host applies the permutation to its resident decoded spans."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    from hadoop_bam_torch.utils.sort import _sorted_header, ragged_gather
    from hadoop_bam_torch.write import write_bam_records

    n_dev = 1
    if header is None:
        header, _ = read_bam_header(input_path)
    spans = plan_bam_spans_balanced(input_path, n_dev, header=header)
    raw: List[Tuple[np.ndarray, np.ndarray]] = []
    his: List[np.ndarray] = []
    los: List[np.ndarray] = []
    for s in spans:
        data, offs = _decode(input_path, s, config)
        if data.size > 2**31 - 64:
            raise ValueError(
                f"span inflates to {data.size} bytes: offsets exceed the "
                f"device int32 layout; use utils.sort.sort_bam for inputs "
                f"this large")
        raw.append((data, offs.astype(np.int32)))
        h, l = _keys_of(data, offs)
        his.append(h)
        los.append(l)
    counts = [o.size for _, o in raw]
    total = int(sum(counts))
    bhi, blo = _bounds(his, los, n_dev, device)
    records_cap = _round_up(max(counts, default=1), 8)
    bytes_cap = _round_up(max((d.size for d, _ in raw), default=1), 256)
    data_d = torch.zeros(bytes_cap, dtype=torch.uint8)
    offs_d = torch.zeros(records_cap, dtype=torch.int32)
    if raw:
        data_d[:raw[0][0].size] = torch.from_numpy(raw[0][0])
        offs_d[:counts[0]] = torch.from_numpy(raw[0][1])
    six = sort_step(data_d.to(device), offs_d.to(device),
                    counts[0] if raw else 0, 0, bhi, blo)
    six = six.cpu().numpy()
    del data_d, offs_d

    out_header = _sorted_header(header, by_name=False)

    def bucket_chunks():
        idxs = six[six != _I32_SENTINEL]
        if not idxs.size:
            return
        data, offs = raw[0]
        o = offs.astype(np.int64)[idxs]
        ln = (data[o[:, None] + np.arange(4)].view("<i4").ravel()
              .astype(np.int64) + 4)
        ends = np.cumsum(ln)
        cuts = np.searchsorted(ends, np.arange(8 << 20, int(ends[-1]),
                                               8 << 20), side="right")
        bounds = np.unique(np.concatenate([[0], cuts, [idxs.size]]))
        for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            yield (ragged_gather(data, o[a:b], ln[a:b]),
                   np.cumsum(ln[a:b]) - ln[a:b])

    written = write_bam_records(output_path, out_header, bucket_chunks(),
                                config=config).records
    if written != total:
        raise RuntimeError(
            f"mesh sort wrote {written} of {total} records: the bucket "
            f"exchange lost data; output is invalid")
    return total


def _sort_bam_mesh_bytes(input_path: str, output_path: str, *, device,
                         config: HBamConfig,
                         header: Optional[SAMHeader]) -> int:
    """The bytes exchange in one round: record rows ride the exchange and
    the permutation is applied on the card."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    from hadoop_bam_torch.utils.sort import _sorted_header
    from hadoop_bam_torch.write import write_bam_records

    n_dev = 1
    if header is None:
        header, _ = read_bam_header(input_path)
    spans = plan_bam_spans_balanced(input_path, n_dev, header=header)
    if spans:
        data, offs = _decode(input_path, spans[0], config)
    else:
        data, offs = np.zeros(0, np.uint8), np.zeros(0, np.int64)
    lens = _record_lens(data, offs)
    total = int(offs.size)
    check_global_index_ceiling(total, "mesh sort (post-decode backstop)")
    h, l = _keys_of(data, offs)
    bhi, blo = _bounds([h], [l], n_dev, device)
    records_cap = _round_up(total, 8)
    stride = _round_up(max(int(lens.max()) if total else 0, 36), 64)
    rows, ln = pack_rows(torch.from_numpy(data).to(device) if data.size
                         else torch.zeros(1, dtype=torch.uint8,
                                          device=device),
                         offs, lens, records_cap, stride)
    rows_s, lens_s, six_s = bytes_sort_step(rows, ln, total, 0, bhi, blo)
    del rows, ln

    def chunks():
        payload, starts = row_payload(rows_s, lens_s, six_s)
        if starts.size:
            yield payload, starts

    written = write_bam_records(output_path, _sorted_header(header, False),
                                chunks(), config=config).records
    if written != total:
        raise RuntimeError(
            f"mesh sort wrote {written} of {total} records: the bucket "
            f"exchange lost data; output is invalid")
    return total


def _sort_bam_mesh_bytes_spill(input_path: str, output_path: str, *,
                               device, config: HBamConfig,
                               header: Optional[SAMHeader],
                               round_records: int,
                               journal_path: Optional[str] = None) -> int:
    """The spill exchange; removes the ``.mesh-spill`` run directory
    afterwards, on success or failure, unless ``config.debug_keep_spill``
    asks to keep it.  Under a journal a failure keeps it: the completed
    rounds' runs are what a resume verifies and reuses."""
    ok = False
    try:
        n = _sort_bam_mesh_bytes_spill_impl(
            input_path, output_path, device=device, config=config,
            header=header, round_records=round_records,
            journal_path=journal_path)
        ok = True
        return n
    finally:
        keep = bool(config.debug_keep_spill) \
            or (journal_path is not None and not ok)
        if not keep:
            shutil.rmtree(output_path + ".mesh-spill", ignore_errors=True)


def _spill_plan(input_path: str, header, round_records: int, n_dev: int):
    """Spans of ~``round_records`` records, whole rounds of ``n_dev``,
    from a splitting index fine enough for ~8 samples a span (the sidecar
    when it is, else one built in memory)."""
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    from hadoop_bam_torch.split.splitting_index import (
        SplittingIndex, build_splitting_index,
    )
    index = SplittingIndex.load_for(input_path)
    fine = max(1, round_records // 8)
    if index is None or (index.granularity or 1) > fine:
        index = build_splitting_index(input_path, granularity=fine)
    n_samples = max(1, len(index.voffsets) - 1)
    if index.total_records > 0:
        total_est = index.total_records
        check_global_index_ceiling(total_est, "mesh spill sort plan")
    else:
        total_est = n_samples * max(1, index.granularity)
    want = _round_up(-(-total_est // max(1, round_records)), n_dev)
    return plan_bam_spans_balanced(input_path, want, header=header,
                                   index=index)


def _sort_bam_mesh_bytes_spill_impl(input_path: str, output_path: str, *,
                                    device, config: HBamConfig,
                                    header: Optional[SAMHeader],
                                    round_records: int,
                                    journal_path: Optional[str] = None
                                    ) -> int:
    """Rounds of the bytes exchange with device memory bounded by the
    round's tile.  Round t ships spans [t*n_dev, (t+1)*n_dev); each
    round's bucket-sorted rows spill to a framed run a bucket, and a
    k-way merge a bucket rebuilds the single-round order.  Bucket bounds
    come from round 0's keys (they set balance, never order).

    With a ``journal_path`` the journal records the job identity, the
    plan's digest, round 0's bounds and each finished round's runs with
    size and CRC.  A resumed run verifies them, reuses the bounds, skips
    the finished rounds (``jobs.rounds_skipped`` /
    ``jobs.spans_skipped``), sweeps the in-flight round's partial runs
    and runs only the rest; ``job_done`` records the output's size and
    CRC, so re-running a finished job is a verified no-op."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.utils.metrics import METRICS
    from hadoop_bam_torch.utils.sort import _sorted_header
    from hadoop_bam_torch.write import write_bam_records

    n_dev = 1
    if header is None:
        header, _ = read_bam_header(input_path)

    jr = None
    resume = None
    if journal_path is not None:
        from hadoop_bam_torch.jobs import journal as jj
        from hadoop_bam_torch.jobs.runner import (
            SORT_FINGERPRINT_FIELDS, sort_job_params,
        )
        jr, resume = jj.JobJournal.resume(
            journal_path, kind="mesh_sort_spill",
            inputs=[(os.path.abspath(input_path),
                     jj.file_identity_digest(input_path))],
            output=os.path.abspath(output_path),
            fingerprint=jj.config_fingerprint(config,
                                              SORT_FINGERPRINT_FIELDS),
            config_values=jj.fingerprint_values(config,
                                                SORT_FINGERPRINT_FIELDS),
            params=sort_job_params(input_path, output_path,
                                   exchange="bytes",
                                   round_records=int(round_records),
                                   n_dev=n_dev),
            fsync=bool(config.journal_fsync))
        if resume is not None and resume.done is not None:
            d = resume.done
            if jj.verify_artifact(output_path, d.get("size", -1),
                                  d.get("crc", "")):
                METRICS.count("jobs.jobs_skipped")
                jr.close()
                return int(d.get("records", 0))
            # the output vanished or changed after job_done: rebuild it
            # from the units that still verify

    spans = _spill_plan(input_path, header, round_records, n_dev)
    n_rounds = max(1, -(-len(spans) // n_dev))
    shard_dir = output_path + ".mesh-spill"
    resumed_rounds: dict = {}
    bounds_ev = None
    if jr is not None:
        # the plan's digest is part of the resume contract: a changed
        # sidecar would re-cut spans under the recorded rounds
        pd = jj.plan_digest(spans)
        plan_ev = resume.last_event("plan") if resume is not None else None
        if plan_ev is not None and plan_ev.get("digest") != pd:
            raise PlanError(
                f"refusing to resume {journal_path}: the span plan no "
                f"longer matches the journaled run (journal digest "
                f"{plan_ev.get('digest')!r}, now {pd!r}): the input's "
                f"splitting-index state changed; delete the journal to "
                f"start over")
        if plan_ev is None:
            jr.event("plan", digest=pd, n_spans=len(spans),
                     n_rounds=int(n_rounds))
        if resume is not None:
            bounds_ev = resume.last_event("bounds")
            for t in range(n_rounds):
                u = resume.unit("round", t)
                if u is None:
                    continue
                runs = list(u.get("runs", []))
                if all(jj.verify_artifact(p, s, c) for _b, p, s, c
                       in runs):
                    resumed_rounds[t] = u
            recorded = [p for u in resumed_rounds.values()
                        for _b, p, s, c in u.get("runs", [])]
            # the in-flight round's partial spills are debris, not state
            jj.sweep_unrecorded(shard_dir, recorded,
                                counter="jobs.stale_runs_swept")
            if resumed_rounds and bounds_ev is None:
                raise PlanError(
                    f"refusing to resume {journal_path}: completed rounds "
                    f"are recorded but round 0's bucket bounds are not; "
                    f"delete the journal to start over")
            spans_skipped = sum(
                min((t + 1) * n_dev, len(spans)) - t * n_dev
                for t in resumed_rounds)
            if resumed_rounds:
                METRICS.count("jobs.rounds_skipped", len(resumed_rounds))
                METRICS.count("jobs.spans_skipped", spans_skipped)
            jr.event("resume_plan", rounds_total=int(n_rounds),
                     rounds_skipped=len(resumed_rounds),
                     spans_skipped=int(spans_skipped))
    if not resumed_rounds:
        shutil.rmtree(shard_dir, ignore_errors=True)
    os.makedirs(shard_dir, exist_ok=True)

    bhi = blo = None
    prefix_total = 0
    run_files: dict = {}               # bucket -> [run paths]
    for t in range(n_rounds):
        if t in resumed_rounds:
            # a journal-verified round: its runs are on disk with the
            # recorded size and CRC; nothing is decoded
            u = resumed_rounds[t]
            for b, p, _s, _c in u.get("runs", []):
                run_files.setdefault(int(b), []).append(p)
            prefix_total += int(u.get("round_total", 0))
            continue
        s = t * n_dev
        if s < len(spans):
            data, offs = _decode(input_path, spans[s], config)
        else:
            data, offs = np.zeros(0, np.uint8), np.zeros(0, np.int64)
        lens = _record_lens(data, offs)
        count = int(offs.size)
        max_len = int(lens.max()) if count else 0
        if bhi is None:
            if bounds_ev is not None:
                # a resumed run reuses the journaled bounds: the finished
                # rounds' runs were bucketed under them
                bhi = torch.tensor(bounds_ev["bhi"], dtype=torch.int64,
                                   device=device)
                blo = torch.tensor(bounds_ev["blo"], dtype=torch.int64,
                                   device=device)
            else:
                h, l = _keys_of(data, offs)
                bhi, blo = _bounds([h], [l], n_dev, device)
                if jr is not None:
                    jr.event("bounds", bhi=bhi.tolist(), blo=blo.tolist())
        check_global_index_ceiling(prefix_total + count,
                                   "mesh spill sort (mid-run backstop)")
        base = prefix_total
        prefix_total += count

        records_cap = _round_up(max(count, 1), 1024)
        stride = 1 << max(6, int(max(max_len, 36) - 1).bit_length())
        rows, ln = pack_rows(torch.from_numpy(data).to(device) if data.size
                             else torch.zeros(1, dtype=torch.uint8,
                                              device=device),
                             offs, lens, records_cap, stride)
        del data
        rows_s, lens_s, six_s = bytes_sort_step(rows, ln, count, base,
                                                bhi, blo)
        del rows, ln
        # spill this round's bucket as a framed sorted run (one bucket
        # a device: bucket 0 here)
        keep = six_s != _I32_SENTINEL
        round_runs: List[Tuple[int, str]] = []
        if bool(keep.any()):
            rows_k = rows_s[keep].cpu().numpy()
            lens_k = lens_s[keep].cpu().numpy()
            six_k = six_s[keep].cpu().numpy()
            hi_k, lo_k = _keys_of(rows_k.ravel(),
                                  np.arange(rows_k.shape[0], dtype=np.int64)
                                  * rows_k.shape[1])
            path = os.path.join(shard_dir, f"b{0:05d}-r{t:05d}.run")
            with open(path, "wb") as f:
                f.write(_frame_run(rows_k, lens_k, six_k, hi_k, lo_k))
            run_files.setdefault(0, []).append(path)
            round_runs.append((0, path))
        del rows_s, lens_s, six_s
        if jr is not None:
            # the round's commit record, written once every run landed:
            # a crash mid-round leaves it unrecorded and its partial
            # runs are swept on resume
            jr.unit_done(
                "round", t,
                runs=[[b, os.path.abspath(p), *jj.file_digest(p)]
                      for b, p in round_runs],
                round_total=int(count))

    total = prefix_total

    def bucket_chunks():
        for b in range(n_dev):
            payload, lens = _merge_bucket_runs(run_files.get(b, []))
            if lens.size:
                yield payload, np.cumsum(lens) - lens

    written = write_bam_records(output_path, _sorted_header(header, False),
                                bucket_chunks(), config=config).records
    if written != total:
        raise RuntimeError(
            f"mesh spill sort wrote {written} of {total} records: output "
            f"is invalid")
    if jr is not None:
        size, crc = jj.file_digest(output_path)
        jr.job_done(records=int(written), size=size, crc=crc)
        jr.close()
    return total
