"""write_bam_records: the parallel write path's front door (trimmed copy
of hadoop_bam_tpu/write/api.py: the BAM writer and the sharded
concatenation; the BCF writer waits in ROADMAP.md).

Sorted record chunks (the mesh sort's buckets, ``utils/sort.sort_bam``'s
runs) go to a BGZF BAM through ``ParallelBGZFWriter``, with the index
sidecars built in the same pass and published atomically: data first,
then sidecars, so a reader racing the rename may see a BAM without its
sidecar but never a fresh sidecar beside stale data.

Settings (``config.py``): ``write_compress_level``,
``write_parallel_workers`` (deflates in flight; 0 = serial in-line),
``write_index_kinds`` ("auto" / "none" / a comma list),
``splitting_index_granularity``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.write.indexing import (
    BamIndexingSink, resolve_index_kinds,
)
from hadoop_bam_torch.write.parallel_bgzf import ParallelBGZFWriter

_TMP_SUFFIX = ".hbam-write-tmp"


@dataclasses.dataclass
class WriteResult:
    path: str
    records: int
    bytes_out: int
    sidecars: Dict[str, str]        # suffix -> sidecar path


def _writer_inflight(config: HBamConfig) -> Optional[int]:
    n = getattr(config, "write_parallel_workers", None)
    return None if n is None else int(n)


# every sidecar a reader may resolve for each container is purged on
# overwrite, not only the kinds rewritten: a stale index beside fresh
# data would send readers to the old file's offsets
_PURGE_SUFFIXES = {
    "bam": (".bai", ".csi", ".sbi", ".splitting-bai"),
    "bcf": (".tbi", ".csi"),
}


def _publish(tmp_path: str, path: str, sidecar_blobs: Dict[str, bytes],
             container: str) -> Dict[str, str]:
    """Atomic publication: (1) write each fresh sidecar to its own temp
    file (an I/O failure aborts here, before anything is visible); (2)
    unlink every sidecar a reader could resolve; (3) rename the data into
    place; (4) rename the sidecars after it."""
    side_tmps: list = []
    sidecars: Dict[str, str] = {}
    try:
        for suffix, blob in sorted(sidecar_blobs.items()):
            side_tmp = path + suffix + _TMP_SUFFIX
            side_tmps.append((suffix, side_tmp))
            with open(side_tmp, "wb") as f:
                f.write(blob)
        for suffix in _PURGE_SUFFIXES.get(container, ()):
            with contextlib.suppress(OSError):
                os.unlink(path + suffix)
        os.replace(tmp_path, path)
        for suffix, side_tmp in side_tmps:
            os.replace(side_tmp, path + suffix)
            sidecars[suffix] = path + suffix
    except BaseException:
        for _suffix, side_tmp in side_tmps:
            with contextlib.suppress(OSError):
                os.unlink(side_tmp)
        raise
    return sidecars


def write_bam_records(path: str, header, chunks: Iterable[Tuple],
                      *, config: HBamConfig = DEFAULT_CONFIG,
                      index_kinds: Optional[Sequence[str]] = None,
                      pool=None) -> WriteResult:
    """Write a BAM from record-aligned byte chunks.

    ``chunks`` yields ``(data, offsets)``: ``data`` a uint8 array (or
    bytes) of whole raw BAM records in file order, ``offsets`` each
    record's int64 start in ``data``.  The stream must be
    coordinate-sorted when a genomic index kind is asked for.  The bytes
    equal streaming the same records through a serial BGZF writer at
    the same level."""
    from hadoop_bam_torch.formats.bam import BamBatch

    kinds = tuple(index_kinds) if index_kinds is not None \
        else resolve_index_kinds(config, "bam")
    sink_idx = BamIndexingSink(
        len(header.ref_names), kinds,
        granularity=int(config.splitting_index_granularity)) \
        if kinds else None
    tmp_path = path + _TMP_SUFFIX
    records = 0
    try:
        with open(tmp_path, "wb") as sink:
            w = ParallelBGZFWriter(
                sink, level=int(config.write_compress_level),
                max_inflight=_writer_inflight(config), pool=pool,
                config=config)
            with w:
                w.write(header.to_bam_bytes())
                for data, offs in chunks:
                    arr = np.frombuffer(data, dtype=np.uint8) \
                        if isinstance(data, (bytes, bytearray, memoryview)) \
                        else np.asarray(data, dtype=np.uint8)
                    offs = np.asarray(offs, dtype=np.int64)
                    if sink_idx is not None and offs.size:
                        batch = BamBatch(arr, offs, header=header)
                        pos0 = batch.pos.astype(np.int64)
                        end0 = pos0 + np.maximum(batch.reference_span(),
                                                 1).astype(np.int64)
                        sink_idx.observe(
                            batch.refid.astype(np.int64), pos0, end0,
                            w.tell_payload_offset() + offs)
                    records += int(offs.size)
                    w.write(arr)
        size = os.path.getsize(tmp_path)
        blobs = sink_idx.finalize(w.resolve_voffsets, w.data_end_voffset,
                                  size) if sink_idx is not None else {}
        sidecars = _publish(tmp_path, path, blobs, "bam")
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp_path)
        raise
    METRICS.count("write.records", records)
    return WriteResult(path=path, records=records, bytes_out=w.bytes_out,
                       sidecars=sidecars)


def write_bam_shards_concat(parts: Sequence[str], path: str, header,
                            *, config: HBamConfig = DEFAULT_CONFIG,
                            index_kinds: Optional[Sequence[str]] = None
                            ) -> WriteResult:
    """Re-block headerless record parts into one continuous BGZF stream
    through ``write_bam_records``: the bytes equal writing the same
    records through one streaming writer, and the sidecars ride along.
    Each part is read through the byte-source layer with the span retry
    policy (a transient fault retries with backoff, counted as
    ``write.part_read_retries``) and its records walked by the host
    library's walker."""
    from hadoop_bam_torch.ops import inflate as inflate_ops
    from hadoop_bam_torch.utils.resilient import (
        call_with_retry, span_retry_policy,
    )
    from hadoop_bam_torch.utils.seekable import as_byte_source

    policy = span_retry_policy(config)

    def read_part(p: str) -> bytes:
        with as_byte_source(p) as src:
            return src.pread(0, src.size)

    def chunks() -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for p in parts:
            raw = call_with_retry(lambda p=p: read_part(p), policy,
                                  what=f"shard part read {p}",
                                  counter="write.part_read_retries")
            if not raw:
                continue
            data, _ = inflate_ops.inflate_span(
                raw, inflate_ops.block_table(raw))
            if not data.size:
                continue
            yield data, inflate_ops.walk_records(data)[0]

    return write_bam_records(path, header, chunks(), config=config,
                             index_kinds=index_kinds)
