"""QueryEngine: batched random-access region queries over indexed BAMs
(counterpart of hadoop_bam_tpu/query/engine.py: BAM, VCF and BCF).

A request is a BATCH of ``(path, region)`` pairs.  The engine:

1. resolves every region through the file's ``.bai`` / ``.csi``
   (``split/bai.py``) into virtual-offset chunk ranges;
2. coalesces and deduplicates the ranges of all requests on the same
   file (overlapping regions share chunks; small compressed gaps merge,
   so one read and inflate serves neighbours) and decodes each chunk
   once, through the ``ChunkCache``, so later batches reuse it;
3. routes the candidate record columns through the staging
   ``FeedPipeline`` to the device and filters them there with the
   interval-overlap predicate ``overlap_step`` (K13), one vector compare
   per tile group;
4. materializes per-request records (``query_records``) or yields the
   device batches as they are (``tensor_batches``, ``api.query_regions``).

Chunk decodes run under ``decode_with_retry`` (transient faults retry,
corrupt ones fail fast, ``skip_bad_spans`` serves a bad chunk empty);
admission and deadline pressure raise ``TransientIOError``; bad requests
(no index, unknown contig, a container the port cannot query) raise
``PlanError``.  BAM regions resolve through a ``.bai`` / ``.csi``, BGZF
VCF and BGZF BCF regions through a ``.tbi`` (``split/tabix.py``); their
rows go through the same ``overlap_step``.  Deliberate differences: CRAM
files raise ``PlanError`` until the port reads CRAM, and the engine takes
a ``device`` where the reference takes a mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.device import resolve_device
from hadoop_bam_torch.obs.context import ensure_trace
from hadoop_bam_torch.query.cache import ChunkCache, file_identity
from hadoop_bam_torch.query.scheduler import Deadline, QueryScheduler
from hadoop_bam_torch.split.intervals import Interval, resolve_interval
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

_I32_MAX = np.int32(np.iinfo(np.int32).max)
# compressed gap below which neighbouring index ranges coalesce into one
# chunk: one read and inflate then serves both; rows in the gap are
# filtered by the exact device predicate like any other candidate
_COALESCE_GAP_C = 1 << 14


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    path: str
    region: str
    # per-request deadline override (seconds); None = the batch deadline
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class QueryResult:
    request: QueryRequest
    records: List[object]          # SamRecord or VcfRecord
    n_candidates: int = 0          # rows the index surfaced pre-predicate


# tile column order fed through the FeedPipeline (all [] int32 series)
TILE_COLUMNS = ("rid", "pos1", "end1", "iv_rid", "iv_beg", "iv_end", "req")


def overlap_step(rid: torch.Tensor, pos1: torch.Tensor, end1: torch.Tensor,
                 iv_rid: torch.Tensor, iv_beg: torch.Tensor,
                 iv_end: torch.Tensor, req: torch.Tensor, count
                 ) -> torch.Tensor:
    """K13: the 1-based inclusive interval-overlap predicate per row,
    ``rid == iv_rid and pos1 <= iv_end and end1 >= iv_beg``, over
    ``[..., cap]`` int32 columns, for rows under ``count`` (one count a
    leading index) -> bool ``[..., cap]``.  The interval bounds ride the
    tile as per-row columns, so one step serves rows of different
    requests; ``req`` is carried, not read.  Elementwise torch ops, no
    hand kernel (the reference jits the same compares as XLA code)."""
    del req
    overlap_step.launches += 1
    cap = rid.shape[-1]
    count = torch.as_tensor(count, device=rid.device)
    valid = torch.arange(cap, device=rid.device) < count.unsqueeze(-1)
    return valid & (rid == iv_rid) & (pos1 <= iv_end) & (end1 >= iv_beg)


overlap_step.launches = 0     # calls (chip_smoke counts the main path's)


def _sniff_kind(path: str) -> str:
    lower = path.lower()
    if lower.endswith(".bam"):
        return "bam"
    if lower.endswith(".cram"):
        raise PlanError(
            f"cannot region-query {path!r} here: the port reads no CRAM "
            f"yet (ROADMAP Queue 1 item 13a); .bam, .vcf.gz and .bcf "
            f"are supported")
    if lower.endswith(".bcf"):
        return "bcf"
    if lower.endswith((".vcf.gz", ".vcf.bgz")):
        return "vcf"
    raise PlanError(
        f"cannot region-query {path!r}: supported containers are .bam "
        f"(.bai/.csi sidecar), .vcf.gz/.vcf.bgz and .bcf (.tbi sidecar)")


class _BcfRows:
    """A BCF chunk's records, decoded whole only when asked for: the
    overlap columns come from each record's shared part, so a wide call
    set pays the sample columns for the matched rows alone."""

    __slots__ = ("codec", "raws")

    def __init__(self, codec, raws: List[bytes]):
        self.codec = codec
        self.raws = raws

    def __len__(self) -> int:
        return len(self.raws)

    def __getitem__(self, row: int):
        return self.codec.decode(self.raws[row], 0)[0]


class _FileMeta:
    """Header + index of one file identity, resolved once per engine."""

    __slots__ = ("path", "ident", "kind", "header", "ref_names", "index")

    def __init__(self, path: str, ident, kind: str, header, ref_names,
                 index):
        self.path = path
        self.ident = ident
        self.kind = kind
        self.header = header
        self.ref_names = list(ref_names)
        self.index = index


class QueryEngine:
    """Batched random-access region queries (module docstring), on
    ``cuda:0`` unless ``device`` says otherwise (RuntimeError without a
    card: the engine never moves to the CPU on its own)."""

    def __init__(self, config: HBamConfig = DEFAULT_CONFIG,
                 cache: Optional[ChunkCache] = None,
                 scheduler: Optional[QueryScheduler] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else ChunkCache(
            int(config.query_cache_bytes))
        self.scheduler = scheduler if scheduler is not None else \
            QueryScheduler(int(config.query_max_in_flight),
                           int(config.query_queue_depth),
                           config.query_deadline_s)
        # bounded metadata LRU and its lock: many threads may drive one
        # engine, so lookup, insert and evict must be atomic
        self._meta: "collections.OrderedDict[Tuple, _FileMeta]" = \
            collections.OrderedDict()
        self._meta_lock = threading.Lock()

    # -- metadata ------------------------------------------------------------

    def _file_meta(self, path: str) -> _FileMeta:
        ident = file_identity(path)
        with self._meta_lock:
            meta = self._meta.get(ident)
            if meta is not None:
                self._meta.move_to_end(ident)
                return meta
        kind = _sniff_kind(path)
        if kind == "bam":
            from hadoop_bam_torch.formats.bamio import read_bam_header
            from hadoop_bam_torch.split.bai import load_bai_for
            header, _ = read_bam_header(path)
            index = load_bai_for(path)
            if index is None:
                raise PlanError(
                    f"{path} has no .bai/.csi sidecar -- region queries "
                    f"need a genomic index; build one with "
                    f"split.bai.write_bai")
            names = header.ref_names
        else:
            from hadoop_bam_torch.split.tabix import load_tabix_for
            header = self._variant_header(path, kind)
            index = load_tabix_for(path)
            if index is None:
                raise PlanError(
                    f"{path} has no .tbi sidecar -- region queries need a "
                    f"tabix index; build one with split.tabix.write_tabix")
            names = header.contigs
        meta = _FileMeta(path, ident, kind, header, names, index)
        with self._meta_lock:
            # two threads may have built the same meta: the first insert
            # wins so every caller shares one instance
            existing = self._meta.get(ident)
            if existing is not None:
                return existing
            if len(self._meta) >= 64:
                self._meta.pop(next(iter(self._meta)))
            self._meta[ident] = meta
        return meta

    @staticmethod
    def _variant_header(path: str, kind: str):
        from hadoop_bam_torch.formats import bgzf
        from hadoop_bam_torch.utils.seekable import scoped_byte_source
        with scoped_byte_source(path) as src:
            if kind == "bcf":
                from hadoop_bam_torch.formats.bcfio import read_bcf_header
                header, _first, is_bgzf = read_bcf_header(src)
                if not is_bgzf:
                    raise PlanError(
                        f"{path} is a raw (non-BGZF) BCF -- virtual-offset "
                        f"random access needs the BGZF container")
                return header
            from hadoop_bam_torch.formats.vcf import read_vcf_header_text
            r = bgzf.BGZFReader(src)

            def read_chunk(off: int, size: int) -> bytes:
                r.seek_voffset(0)
                r.read(off)           # header-sized positions only
                return r.read(size)
            header, _ = read_vcf_header_text(read_chunk)
            return header

    # -- resolution ----------------------------------------------------------

    def _resolve(self, meta: _FileMeta, region: str
                 ) -> Tuple[Interval, List[Tuple[int, int]]]:
        iv = resolve_interval(region, meta.ref_names)
        if iv.rname not in meta.ref_names:
            raise PlanError(
                f"region contig {iv.rname!r} is not in {meta.path}'s "
                f"reference dictionary")
        if meta.kind == "bam":
            rid = meta.ref_names.index(iv.rname)
            return iv, meta.index.query(rid, iv.start - 1, iv.end)
        return iv, meta.index.query(iv.rname, iv.start - 1, iv.end)

    def _coalesce(self, ranges: Sequence[Tuple[int, int]], kind: str
                  ) -> List[Tuple[int, int]]:
        """Merge overlapping or near-adjacent (start, end) ranges, at most
        ``query_chunk_bytes`` compressed bytes a chunk (one oversized
        range stays one chunk: the index gives no record-aligned interior
        offsets).  Gaps and sizes are compressed bytes: BAM ranges are
        virtual offsets (compressed offset = value >> 16), CRAM container
        ranges raw byte offsets."""
        shift = 0 if kind == "cram" else 16
        cap_c = max(1 << 16, int(self.config.query_chunk_bytes))
        out: List[Tuple[int, int]] = []
        for s, e in sorted(set(ranges)):
            if out:
                ps, pe = out[-1]
                gap_c = (s >> shift) - (pe >> shift)
                size_c = (e >> shift) - (ps >> shift)
                if s <= pe or (gap_c <= _COALESCE_GAP_C
                               and size_c <= cap_c):
                    if e > pe:
                        out[-1] = (ps, e)
                    continue
            out.append((s, e))
        return out

    # -- chunk decode (cache + retry) ---------------------------------------

    def chunk_key(self, meta: _FileMeta, s: int, e: int) -> Tuple:
        return (meta.ident, meta.kind, s, e)

    def _chunk(self, meta: _FileMeta, s: int, e: int) -> Dict[str, object]:
        """Decoded chunk columns, cached by (identity, range) through the
        single-flight cache path: concurrent callers on the same cold
        chunk share one decode."""
        return self.cache.get_or_compute(
            self.chunk_key(meta, s, e),
            lambda: self._compute_chunk(meta, s, e))

    def _compute_chunk(self, meta: _FileMeta, s: int, e: int):
        from hadoop_bam_torch.plan.executor import run_chunk_columns
        return run_chunk_columns(
            FileVirtualSpan(meta.path, s, e), self.config,
            lambda sp: self._decode_chunk(meta, sp))

    def _decode_chunk(self, meta: _FileMeta,
                      span: FileVirtualSpan) -> Dict[str, object]:
        if meta.kind == "vcf":
            return self._decode_vcf_chunk(meta, span)
        if meta.kind == "bcf":
            return self._decode_bcf_chunk(meta, span)
        return self._decode_bam_chunk(meta, span)

    def _decode_bam_chunk(self, meta: _FileMeta,
                          span: FileVirtualSpan) -> Dict[str, object]:
        from hadoop_bam_torch.split.planners import read_bam_span
        with METRICS.timer("pipeline.host_decode"), \
                METRICS.wall_timer("pipeline.host_decode_wall"):
            batch = read_bam_span(meta.path, span, header=meta.header)
            n = len(batch)
            pos1 = batch.pos.astype(np.int64) + 1
            end1 = pos1 + np.maximum(batch.reference_span(), 1) - 1
        return {
            "rid": batch.refid.astype(np.int32),
            "pos1": np.minimum(pos1, _I32_MAX).astype(np.int32),
            "end1": np.minimum(end1, _I32_MAX).astype(np.int32),
            "batch": batch,
            "n": n,
            "nbytes": int(batch.data.nbytes) + 16 * n + 64,
        }

    @staticmethod
    def _variant_columns(meta: _FileMeta, records) -> Dict[str, object]:
        rid_of = {c: i for i, c in enumerate(meta.ref_names)}
        n = len(records)
        rid = np.fromiter((rid_of.get(r.chrom, -1) for r in records),
                          np.int32, n)
        pos1 = np.fromiter((r.pos for r in records), np.int64, n)
        end1 = pos1 + np.fromiter((max(r.rlen, 1) for r in records),
                                  np.int64, n) - 1
        return {
            "rid": rid,
            "pos1": np.minimum(pos1, _I32_MAX).astype(np.int32),
            "end1": np.minimum(end1, _I32_MAX).astype(np.int32),
            "records": records,
            "n": n,
        }

    def _decode_vcf_chunk(self, meta: _FileMeta,
                          span: FileVirtualSpan) -> Dict[str, object]:
        from hadoop_bam_torch.config import ValidationStringency
        from hadoop_bam_torch.formats import bgzf
        from hadoop_bam_torch.formats.vcf import VcfRecord
        from hadoop_bam_torch.utils.seekable import scoped_byte_source
        records: List[VcfRecord] = []
        with METRICS.timer("pipeline.host_decode"), \
                METRICS.wall_timer("pipeline.host_decode_wall"), \
                scoped_byte_source(meta.path) as src:
            r = bgzf.BGZFReader(src)
            r.seek_voffset(span.start_voffset)
            text = r.read_to_voffset(span.end_voffset)
            for line in text.split(b"\n"):
                if not line or line[:1] == b"#":
                    continue
                try:
                    records.append(VcfRecord.from_line(line.decode()))
                except Exception:
                    if (self.config.validation_stringency
                            is ValidationStringency.STRICT):
                        raise
        out = self._variant_columns(meta, records)
        out["nbytes"] = 2 * len(text) + 64
        return out

    def _decode_bcf_chunk(self, meta: _FileMeta,
                          span: FileVirtualSpan) -> Dict[str, object]:
        from hadoop_bam_torch.formats import bgzf
        from hadoop_bam_torch.formats.bcf import BCFRecordCodec, shared_only
        from hadoop_bam_torch.utils.seekable import scoped_byte_source
        codec = BCFRecordCodec(meta.header)
        records, raws = [], []
        nbytes = 0
        with METRICS.timer("pipeline.host_decode"), \
                METRICS.wall_timer("pipeline.host_decode_wall"), \
                scoped_byte_source(meta.path) as src:
            r = bgzf.BGZFReader(src)
            r.seek_voffset(span.start_voffset)
            while r.voffset() < span.end_voffset:
                head = r.read(8)
                if len(head) < 8:
                    break
                l_shared, l_indiv = struct.unpack("<II", head)
                raw = head + r.read(l_shared + l_indiv)
                if len(raw) < 8 + l_shared + l_indiv:
                    codec.decode(raw, 0)     # the codec's truncation error
                records.append(codec.decode(shared_only(raw), 0)[0])
                raws.append(raw)
                nbytes += len(raw)
        out = self._variant_columns(meta, records)
        out["records"] = _BcfRows(codec, raws)
        out["nbytes"] = 2 * nbytes + 64
        return out

    @staticmethod
    def _materialize(meta: _FileMeta, value: Dict[str, object], row: int):
        if meta.kind != "bam":
            return value["records"][row]
        from hadoop_bam_torch.formats.sam import SamRecord
        return SamRecord.from_line(value["batch"].to_sam_line(row))

    # -- serving -------------------------------------------------------------

    def _prepare(self, requests: Sequence[QueryRequest], deadline: Deadline):
        """Resolve + decode: (stream tuples, host refs, per-request
        candidate counts, intervals)."""
        tuples: List[Tuple[np.ndarray, ...]] = []
        refs: List[Tuple[int, _FileMeta, Dict[str, object]]] = []
        cand_counts = [0] * len(requests)
        ivs: List[Optional[Interval]] = [None] * len(requests)
        # per-request deadline overrides keep the batch's enqueue anchor:
        # admission wait counts against them
        req_deadlines = [
            None if r.deadline_s is None
            else deadline.rebudget(r.deadline_s)
            for r in requests]

        def check(i: int, what: str) -> None:
            deadline.check(what)
            if req_deadlines[i] is not None:
                req_deadlines[i].check(f"{what} (request {i})")

        # group by path, in first-appearance order
        by_path: Dict[str, List[int]] = {}
        for i, req in enumerate(requests):
            by_path.setdefault(req.path, []).append(i)

        plans = []           # (req_idx, meta, iv, ranges)
        # ranges accumulate by file identity, not path string: two
        # spellings of one file resolve to one identity
        ranges_by_ident: Dict[Tuple, List[Tuple[int, int]]] = {}
        kind_of_ident: Dict[Tuple, str] = {}
        with METRICS.span("query.resolve_wall", requests=len(requests)):
            for path, req_idxs in by_path.items():
                deadline.check("query resolve")
                meta = self._file_meta(path)
                acc = ranges_by_ident.setdefault(meta.ident, [])
                kind_of_ident[meta.ident] = meta.kind
                for i in req_idxs:
                    METRICS.count("query.requests")
                    check(i, "query resolve")
                    iv, ranges = self._resolve(meta, requests[i].region)
                    ivs[i] = iv
                    plans.append((i, meta, iv, ranges))
                    acc.extend(ranges)
        chunk_sets = {
            ident: self._coalesce(rs, kind_of_ident[ident])
            for ident, rs in ranges_by_ident.items()}

        for i, meta, iv, ranges in plans:
            check(i, "query decode")
            if not ranges:
                continue
            rid = np.int32(meta.ref_names.index(iv.rname))
            iv_beg = np.int32(min(iv.start, int(_I32_MAX)))
            iv_end = np.int32(min(iv.end, int(_I32_MAX)))
            lo = min(s for s, _ in ranges)
            hi = max(e for _, e in ranges)
            for s, e in chunk_sets[meta.ident]:
                if e <= lo or s >= hi:
                    continue             # chunk serves other requests only
                check(i, "query decode")
                value = self._chunk(meta, s, e)
                n = int(value["n"])
                if not n:
                    continue
                cand_counts[i] += n
                METRICS.count("query.rows_scanned", n)
                tuples.append((
                    value["rid"], value["pos1"], value["end1"],
                    np.full(n, rid, np.int32),
                    np.full(n, iv_beg, np.int32),
                    np.full(n, iv_end, np.int32),
                    np.full(n, i, np.int32),
                ))
                refs.append((i, meta, value))
        return tuples, refs, cand_counts, ivs

    def _stream_groups(self, tuples, deadline: Deadline,
                       host_counts: Optional[List[np.ndarray]] = None
                       ) -> Iterator[Dict]:
        """Feed the candidate tuples through the FeedPipeline and yield
        device batches {rid, pos, end, req, keep, n_records}, each a
        ``[n_dev, rows]`` tensor the consumer owns; ``host_counts``
        collects each group's row counts as the host packed them."""
        from hadoop_bam_torch.parallel.pipeline import (
            _CopiesDone, _owned_copy,
        )
        from hadoop_bam_torch.parallel.staging import FeedPipeline, TileSpec

        if not tuples:
            return
        dev = self.device
        fp = FeedPipeline(1, int(self.config.query_tile_records),
                          [TileSpec((), np.int32)] * len(TILE_COLUMNS),
                          block_n=64, pin_memory=dev.type == "cuda")

        def emit(tensors, counts):
            deadline.check("query filter")
            cols = [_owned_copy(t, dev) for t in tensors]
            n = _owned_copy(torch.from_numpy(counts), dev)
            copies = _CopiesDone()
            copies.record(dev)
            if host_counts is not None:
                host_counts.append(counts.copy())
            keep = overlap_step(*cols, n)
            return ({"rid": cols[0], "pos": cols[1], "end": cols[2],
                     "req": cols[6], "keep": keep, "n_records": n},
                    copies.handle())

        with METRICS.span("query.filter_wall"):
            yield from fp.stream(iter(tuples), emit)

    @staticmethod
    def _requests(requests) -> List[QueryRequest]:
        return [r if isinstance(r, QueryRequest) else QueryRequest(*r)
                for r in requests]

    def tensor_batches(self, requests: Sequence[QueryRequest],
                       deadline_s: Optional[float] = None) -> Iterator[Dict]:
        """Device-batch surface (``api.query_regions``): yields
        ``{rid, pos, end, req, keep, n_records}`` groups on the engine's
        device, ``keep`` the K13 overlap mask and ``req`` each row's
        request index."""
        requests = self._requests(requests)
        t0 = time.perf_counter()
        deadline = None
        try:
            # one trace per query batch (joined when a serve transport
            # already minted one)
            with ensure_trace(op="query.batch", deadline_s=deadline_s), \
                    self.scheduler.admit(deadline_s) as deadline:
                tuples, _refs, _counts, _ivs = self._prepare(requests,
                                                             deadline)
                yield from self._stream_groups(tuples, deadline)
        finally:
            # end-to-end batch latency, admission wait included
            METRICS.observe("query.latency_s", time.perf_counter() - t0)
            # one tick per batch whose deadline was missed, whether it
            # aborted mid-serve (check() booked it) or finished late
            if deadline is not None and deadline.expired:
                deadline.book_miss()

    def query_records(self, requests: Sequence[QueryRequest],
                      deadline_s: Optional[float] = None
                      ) -> List[QueryResult]:
        """Exact per-request record lists, index-pruned and filtered on
        the device; file order within a request, request order across
        the batch.  The keep masks come back in one copy at the end."""
        requests = self._requests(requests)
        t_start = time.perf_counter()
        batch_deadline = None
        keeps: List[torch.Tensor] = []
        try:
            with ensure_trace(op="query.batch", deadline_s=deadline_s), \
                    self.scheduler.admit(deadline_s) as deadline:
                batch_deadline = deadline
                tuples, refs, cand_counts, _ivs = self._prepare(requests,
                                                                deadline)
                counts: List[np.ndarray] = []
                for out in self._stream_groups(tuples, deadline, counts):
                    c = counts[-1]
                    keeps += [out["keep"][d, :int(c[d])]
                              for d in range(c.size)]
        finally:
            if batch_deadline is not None and batch_deadline.expired:
                batch_deadline.book_miss()
        mask = torch.cat(keeps).cpu().numpy() if keeps \
            else np.zeros(0, bool)
        results = [QueryResult(req, [], cand_counts[i])
                   for i, req in enumerate(requests)]
        base = 0
        for req_idx, meta, value in refs:
            n = int(value["n"])
            rows = np.flatnonzero(mask[base:base + n])
            base += n
            recs = results[req_idx].records
            for row in rows:
                recs.append(self._materialize(meta, value, int(row)))
        METRICS.count("query.rows_matched",
                      sum(len(r.records) for r in results))
        METRICS.observe("query.latency_s", time.perf_counter() - t_start)
        return results

    def stats(self) -> Dict[str, float]:
        return self.cache.stats()
