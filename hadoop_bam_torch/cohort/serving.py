"""Cohort-slice serving: "this gene across N samples" from resident tiles
(counterpart of hadoop_bam_tpu/cohort/serving.py).

The serve tier's cohort projection: the joined cohort's ``chrom`` /
``pos`` / ``n_allele`` / ``dosage`` columns live as device tiles in the
SAME ``DeviceTileCache`` as region tiles, keyed by the cohort manifest's
identity (every input's ``(abspath, size, mtime_ns)`` digested: rewrite
one sample file and every cached cohort tile self-invalidates).

Request shape on the wire (serve/transport.py)::

    {"id": 7, "cohort": true, "path": "cohort.json",
     "regions": ["chr20:1000000-2000000"], "records": false}

The COLD path runs the whole position join (host work, spanned as
``cohort.join_wall`` and ``pipeline.host_decode_wall``) and parks the
joined tiles on the card; every WARM slice goes straight to the slice
step (K17b): no host decode at all.

K17b (``cohort_slice_step``) is one launch of a hand CUDA kernel
(``csrc/cohort_stats.cu``, entry point ``hbam_cohort_slice``: K17a's
row loop with no phenotype over every column of the tile, whose AF is
each row's ALT allele frequency, with the interval predicate, its hit
count and the AF sum and count over the kept rows in the same launch).
Its plain version ``cohort_slice_plain`` is K17a's plain version's AF
column and ``slice_of_af``'s torch ops.  The AF is computed over the
whole tile on every request, as the reference's step computes it.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.cohort.manifest import CohortManifest, load_manifest
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

COHORT_PROJECTION = "cohort_dosage"

_I32_MAX = int(np.iinfo(np.int32).max)


class _CohortMeta:
    """Resident state of one manifest: ONE ``CohortDataset`` (so the serve
    path shares the quarantine policy and the contig space of the API's
    builds: a header-corrupt sample quarantines here too, and tile chrom
    indices never diverge from the map a slice resolves against), and,
    once built, the tile groups' row counts (so a warm lookup knows every
    key to fetch)."""

    __slots__ = ("path", "dataset", "ident", "group_rows", "n_variants",
                 "file_stat")

    def __init__(self, path: str, dataset, ident, file_stat):
        self.path = path
        self.dataset = dataset
        self.ident = ident
        self.file_stat = file_stat      # the manifest file's (size, mtime)
        self.group_rows: Optional[List[int]] = None
        self.n_variants = 0

    @property
    def manifest(self) -> CohortManifest:
        return self.dataset.manifest

    @property
    def contigs(self) -> List[str]:
        return self.dataset.contigs

    @property
    def cmap(self):
        return self.dataset._cmap

    @property
    def n_samples(self) -> int:
        return self.dataset.n_samples

    @property
    def samples_pad(self) -> int:
        return self.dataset.geometry.samples_pad


def cohort_slice_plain(chrom: torch.Tensor, pos: torch.Tensor,
                       dosage: torch.Tensor, count: torch.Tensor,
                       iv: torch.Tensor):
    """K17b's plain version: K17a's plain version with no phenotype over
    every column of the tile (the tile pads past the cohort's samples
    with -1, as in the reference's step), its AF column through
    ``slice_of_af``."""
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_plain
    af = cohort_gwas_plain(dosage, count, None, dosage.shape[-1])[..., 0]
    return slice_of_af(chrom, pos, count, iv, af)


# K17b's per-stream scratch: a uint32 ticket that is zero between launches
# in the first 16 bytes, then one 16-byte partial a resident CTA of the
# kernel, keyed by (device index, stream handle): launches on one stream
# never overlap
_SLICE_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_SLICE_SCRATCH_LOCK = threading.Lock()


def _new_slice_scratch(dev: torch.device) -> torch.Tensor:
    """A zeroed scratch for K17b's launches on ``dev`` (the current
    device), sized by the kernel's resident CTAs."""
    import ctypes

    from hadoop_bam_torch.ops import kernels
    slots = ctypes.c_int64(0)
    kernels.check_launch("cohort_slice_slots", kernels.kernel(
        "cohort_slice_slots")(ctypes.addressof(slots)))
    return torch.zeros(16 * (1 + slots.value), dtype=torch.uint8, device=dev)


def _slice_scratch(dev: torch.device, stream: int) -> torch.Tensor:
    """The scratch of K17b's launch on ``stream``.  Under CUDA graph
    capture, a new one zeroed in the graph (a memset node before the
    kernel node, in the graph's own memory), so a replay on any stream
    shares no ticket with eager launches and the per-stream scratch is
    never made by a fill that only a replay would run."""
    if torch.cuda.is_current_stream_capturing():
        return _new_slice_scratch(dev)
    key = (dev.index, stream)
    with _SLICE_SCRATCH_LOCK:
        scratch = _SLICE_SCRATCH.get(key)
        if scratch is None:
            scratch = _SLICE_SCRATCH[key] = _new_slice_scratch(dev)
    return scratch


def _check_slice_args(chrom, pos, dosage, iv) -> None:
    if dosage.dtype != torch.int8 or dosage.dim() != 3 \
            or dosage.shape[0] != 1 or dosage.shape[2] % 8:
        raise ValueError(f"dosage must be int8 [1, cap, samples_pad], "
                         f"samples_pad a multiple of 8, got {dosage.dtype} "
                         f"{tuple(dosage.shape)}")
    cap = dosage.shape[1]
    for name, col in (("chrom", chrom), ("pos", pos)):
        if col.dtype != torch.int32 or tuple(col.shape) != (1, cap):
            raise ValueError(f"{name} must be int32 [1, {cap}], got "
                             f"{col.dtype} {tuple(col.shape)}")
    if iv.dtype != torch.int32 or tuple(iv.shape) != (3,):
        raise ValueError(f"iv must be int32 [3], got {iv.dtype} "
                         f"{tuple(iv.shape)}")
    if any(t.device != dosage.device for t in (chrom, pos, iv)):
        raise ValueError("chrom, pos, dosage and iv must share a device")


def cohort_slice_step(chrom: torch.Tensor, pos: torch.Tensor,
                      dosage: torch.Tensor, count: torch.Tensor,
                      iv: torch.Tensor):
    """K17b: the rows of a resident cohort tile (chrom / pos int32 [1,
    cap], dosage int8 [1, cap, samples_pad], count int32 [1]) that
    overlap ONE interval ``iv = [contig, beg, end]`` (int32 [3] on the
    tile's device).  Returns ``(keep, hits, af, af_sum, af_n)``: the
    bool [1, cap] mask, int32 [1] hits, float32 [1, cap] ALT allele
    frequency (over every column of the tile, NaN where nothing is
    called and on rows past the count), and the float32 [1] sum and
    int32 [1] count of the kept rows' defined AFs.

    A CUDA tile is one launch of the kernel (``hbam_cohort_slice`` in
    ``csrc/cohort_stats.cu``) on the current stream, which reads the
    count and the interval from device memory (no host read); captured
    into a CUDA graph, the launch is preceded by the zero fill of its own
    scratch.  A CPU tile takes ``cohort_slice_plain``.  A kernel that
    fails to build or launch raises.  ``cohort_slice_step.launches``
    counts kernel launches."""
    from hadoop_bam_torch.cohort.gwas import _count_tensor
    from hadoop_bam_torch.ops import kernels
    _check_slice_args(chrom, pos, dosage, iv)
    if dosage.device.type == "cpu":
        return cohort_slice_plain(chrom, pos, dosage, count, iv)
    if dosage.device.type != "cuda":
        raise ValueError(f"unsupported device {dosage.device}")
    dev = dosage.device
    _, cap, spad = dosage.shape
    d = dosage.contiguous()
    if d.data_ptr() % 8:
        raise ValueError("dosage must start 8-byte aligned")
    chrom, pos, iv = chrom.contiguous(), pos.contiguous(), iv.contiguous()
    c = _count_tensor(count, dev)
    keep = torch.empty((1, cap), dtype=torch.bool, device=dev)
    af = torch.empty((1, cap), dtype=torch.float32, device=dev)
    sums = torch.empty(3, dtype=torch.int32, device=dev)
    fn = kernels.kernel("cohort_slice")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _slice_scratch(dev, stream)
        rc = fn(chrom.data_ptr(), pos.data_ptr(), d.data_ptr(), cap, spad,
                c.data_ptr(), iv.data_ptr(), af.data_ptr(), keep.data_ptr(),
                sums.data_ptr(), scratch.data_ptr(),
                scratch.numel() // 16 - 1, stream)
    kernels.check_launch("cohort_slice_step", rc)
    cohort_slice_step.launches += 1
    hits, af_n, af_sum = sums.split(1)
    return keep, hits, af, af_sum.view(torch.float32), af_n


cohort_slice_step.launches = 0


def slice_of_af(chrom: torch.Tensor, pos: torch.Tensor,
                count: torch.Tensor, iv: torch.Tensor, af: torch.Tensor):
    """K17b's torch ops on a tile's AF column: ``(keep, hits, af, af_sum,
    af_n)`` as ``cohort_slice_step`` returns them."""
    cap = chrom.shape[-1]
    valid = torch.arange(cap, dtype=torch.int32,
                         device=chrom.device)[None, :] < count[:, None]
    keep = valid & (chrom == iv[0]) & (pos >= iv[1]) & (pos <= iv[2])
    hits = keep.sum(dim=1, dtype=torch.int32)
    in_mean = keep & ~torch.isnan(af)
    af_sum = torch.where(in_mean, af, 0.0).sum(dim=1)
    af_n = in_mean.sum(dim=1, dtype=torch.int32)
    return keep, hits, af, af_sum, af_n


class CohortServer:
    """The serve tier's cohort plane: owns manifest metadata (a bounded
    LRU), builds joined dosage tiles into the shared ``DeviceTileCache``
    and answers slice requests.  Every method runs on the ONE serve
    dispatcher thread, so only the meta map (which stats readers poll)
    takes a lock."""

    def __init__(self, device: torch.device,
                 config: HBamConfig = DEFAULT_CONFIG):
        self.device = device
        self.config = config
        self.n_dev = 1
        self.cap = int(config.serve_tile_records)
        self._lock = threading.Lock()
        self._meta: "OrderedDict[str, _CohortMeta]" = OrderedDict()
        self._meta_cap = max(1, int(config.serve_cohort_manifests))

    # -- metadata ------------------------------------------------------------

    def _meta_for(self, path: str) -> _CohortMeta:
        """The manifest's resident state, checked against its identity on
        every request (rewrite one input and the next slice joins again).
        A manifest file unchanged on disk (size, mtime) is not parsed
        again: its resident copy's inputs are the ones stat'ed."""
        apath = os.path.abspath(path)
        st = os.stat(apath)
        file_stat = (st.st_size, st.st_mtime_ns)
        with self._lock:
            meta = self._meta.get(apath)
        if meta is not None and meta.file_stat == file_stat:
            manifest = meta.manifest
        else:
            manifest = load_manifest(apath)
        ident = manifest.identity()
        with self._lock:
            if meta is not None and meta.ident == ident \
                    and meta.file_stat == file_stat:
                self._meta.move_to_end(apath)
                return meta
        # cold or changed on disk: ONE CohortDataset carries the contig
        # space, geometry and quarantine policy for both the slice
        # resolution and the tile build
        from hadoop_bam_torch.cohort.dataset import CohortDataset

        if meta is not None and manifest is meta.manifest:
            manifest = load_manifest(apath)   # a fresh quarantine record
        meta = _CohortMeta(apath, CohortDataset(manifest, device=self.device,
                                                config=self.config), ident,
                           file_stat)
        with self._lock:
            self._meta[apath] = meta
            self._meta.move_to_end(apath)
            while len(self._meta) > self._meta_cap:
                self._meta.popitem(last=False)
        return meta

    # -- tiles ---------------------------------------------------------------

    def _key(self, meta: _CohortMeta, g: int) -> Tuple:
        from hadoop_bam_torch.serve.tiles import tile_key
        return tile_key(meta.ident, "cohort", g, 0, self.n_dev, self.cap,
                        projection=COHORT_PROJECTION)

    def _build_tiles(self, meta: _CohortMeta) -> List:
        """Run the join and park the cohort on the card: one TileSet a
        ``cap``-row group.  The host buffers are fresh a group (never
        recycled), so a CPU tensor sharing one's memory is safe.

        Chunks stream into the group buffers: slicing never reads the
        qual column (the largest, dropped on arrival), and at most one
        group and one chunk of dosage are held on the host at a time."""
        from hadoop_bam_torch.serve.tiles import TileGroup, TileSet

        ds = meta.dataset
        per_group = self.n_dev * self.cap
        sets: List[TileSet] = []
        group = None                # (chrom, pos, nall, dosage) buffers
        fill = 0                    # rows filled in the open group

        def fresh_group():
            return (np.full((per_group,), -1, np.int32),
                    np.zeros((per_group,), np.int32),
                    np.zeros((per_group,), np.int16),
                    np.full((per_group, meta.samples_pad), -1, np.int8))

        def close_group(bufs, rows: int) -> None:
            shaped = (bufs[0].reshape(1, self.cap),
                      bufs[1].reshape(1, self.cap),
                      bufs[2].reshape(1, self.cap),
                      bufs[3].reshape(1, self.cap, meta.samples_pad),
                      np.asarray([rows], np.int32))
            dev = [torch.from_numpy(a).to(self.device) for a in shaped]
            nbytes = sum(int(a.nbytes) for a in shaped)
            sets.append(TileSet(
                groups=[TileGroup(cols=tuple(dev[:4]), counts=dev[4],
                                  n=rows)],
                n=rows, nbytes=nbytes + 64, ident=meta.ident))

        n = 0
        with METRICS.span("cohort.tile_build_wall"):
            for chunk in ds.site_chunks():
                chunk.pop("qual", None)      # slicing never reads it
                m = int(chunk["chrom"].shape[0])
                taken = 0
                while taken < m:
                    if group is None:
                        group, fill = fresh_group(), 0
                    k = min(per_group - fill, m - taken)
                    group[0][fill:fill + k] = chunk["chrom"][taken:taken + k]
                    group[1][fill:fill + k] = chunk["pos"][taken:taken + k]
                    group[2][fill:fill + k] = \
                        chunk["n_allele"][taken:taken + k]
                    group[3][fill:fill + k] = \
                        chunk["dosage"][taken:taken + k]
                    fill += k
                    taken += k
                    n += k
                    if fill == per_group:
                        close_group(group, fill)
                        group = None
            if group is not None and fill:
                close_group(group, fill)
            elif n == 0:
                # empty cohort: one all-padding group, so warm lookups
                # and the slice loop see a well-formed (empty) tile
                close_group(fresh_group(), 0)
        meta.n_variants = n
        return sets

    def _tiles(self, meta: _CohortMeta, tiles_cache
               ) -> Tuple[List, int, int]:
        """(tile sets, tile_hits, tile_misses): a warm fetch from the
        shared device cache, or one cold build that parks every group."""
        if meta.group_rows is not None:
            sets = []
            for g in range(len(meta.group_rows)):
                t = tiles_cache.get(self._key(meta, g))
                if t is None:
                    sets = None
                    break
                sets.append(t)
            if sets is not None:
                return sets, len(sets), 0
        built = self._build_tiles(meta)
        for g, t in enumerate(built):
            tiles_cache.put(self._key(meta, g), t)
        meta.group_rows = [t.n for t in built]
        METRICS.count("cohort.tile_builds")
        return built, 0, max(1, len(built))

    # -- the slice -----------------------------------------------------------

    def serve(self, path: str, region: str, tiles_cache, *,
              want_records: bool = False, deadline=None):
        """Answer one cohort-slice request; returns a
        ``serve.loop.ServeResult`` (count = variants in the slice,
        ``extra`` the cohort aggregates)."""
        from hadoop_bam_torch.serve.loop import ServeResult
        from hadoop_bam_torch.split.intervals import parse_interval

        if deadline is not None:
            deadline.check("cohort resolve")
        with METRICS.span("cohort.resolve_wall"):
            meta = self._meta_for(path)
        iv = parse_interval(region)
        rid = meta.cmap.get(iv.rname)
        if rid is None:
            raise PlanError(
                f"cohort slice: contig {iv.rname!r} is in no sample "
                f"header of {path!r}")
        sets, tile_hits, tile_misses = self._tiles(meta, tiles_cache)
        iv_dev = torch.tensor([rid, min(iv.start, _I32_MAX),
                               min(iv.end, _I32_MAX)], dtype=torch.int32,
                              device=self.device)
        recs: Optional[List[Dict]] = [] if want_records else None
        with METRICS.span("cohort.slice_wall", region=region):
            # launch every group first and read the sums back once: a
            # read a group would wait on the card a group at a time
            pending = []
            for t in sets:
                if deadline is not None:
                    deadline.check("cohort slice group")
                for g in t.groups:
                    pending.append((g, cohort_slice_step(
                        g.cols[0], g.cols[1], g.cols[3], g.counts, iv_dev)))
            sums = torch.stack([torch.stack([
                hits[0].to(torch.float64), asum[0].to(torch.float64),
                an[0].to(torch.float64)])
                for _g, (_k, hits, _af, asum, an) in pending]).cpu()
            count = int(sums[:, 0].sum())
            af_n = int(sums[:, 2].sum())
            af_sum = float(sums[:, 1].sum())
            if recs is not None:
                for g, (keep, _h, af, _s, _n) in pending:
                    rows = torch.nonzero(keep[0]).flatten()
                    hchrom = g.cols[0][0, rows].cpu().numpy()
                    hpos = g.cols[1][0, rows].cpu().numpy()
                    hnall = g.cols[2][0, rows].cpu().numpy()
                    haf = af[0, rows].cpu().numpy()
                    for j in range(rows.numel()):
                        a = float(haf[j])
                        recs.append({
                            "chrom": meta.contigs[int(hchrom[j])],
                            "pos": int(hpos[j]),
                            "n_allele": int(hnall[j]),
                            "af": None if np.isnan(a) else round(a, 6)})
        METRICS.count("cohort.slice_requests")
        extra = {
            "n_samples": meta.n_samples,
            "mean_af": (round(af_sum / af_n, 6) if af_n else None),
        }
        if meta.manifest.quarantined:
            extra["quarantined"] = sorted(meta.manifest.quarantined)
        if recs is not None:
            recs.sort(key=lambda r: (r["chrom"], r["pos"]))
        return ServeResult(region=region, count=count,
                           n_candidates=meta.n_variants,
                           tile_hits=tile_hits, tile_misses=tile_misses,
                           records=recs, extra=extra)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"manifests": len(self._meta)}
