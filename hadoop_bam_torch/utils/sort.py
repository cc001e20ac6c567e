"""The host coordinate sort of a BAM (trimmed copy of
hadoop_bam_tpu/utils/sort.py): decode, cut bounded runs, sort each,
spill, k-way merge, write.  It is the oracle the mesh sort
(``parallel/mesh_sort.py``) is held to, byte for byte.

Coordinate order [SPEC]: (refid with unmapped last, pos), ties in input
order.  A run is sorted with NumPy (a stable lexsort of its key columns)
and its bytes gathered in slices; runs past the first spill to BAM files
that ``_iter_bam_run`` streams back into a heap merge.  Output goes
through ``write.write_bam_records`` (pooled deflate, co-written
sidecars), as the reference's coordinate output does.  Queryname order
waits in ROADMAP.md.
"""
from __future__ import annotations

import heapq
import os
import re
import tempfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bam import SAMHeader

_UNMAPPED = 1 << 40
_OUT_CHUNK = 8 << 20            # bytes of sorted records a write chunk


def coordinate_key(rec: bytes) -> Tuple[int, int]:
    """(refid, pos) of raw record bytes; unmapped (refid -1) last."""
    refid = int.from_bytes(rec[4:8], "little", signed=True)
    pos = int.from_bytes(rec[8:12], "little", signed=True)
    return (_UNMAPPED if refid < 0 else refid, pos)


def _iter_bam_run(path: str) -> Iterator[bytes]:
    """Stream raw record bytes from a spilled BAM run file."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.utils.seekable import as_byte_source

    src = as_byte_source(path)
    try:
        _, first = read_bam_header(src)
        r = bgzf.BGZFReader(src)
        r.seek_voffset(first)
        while True:
            head = r.read(4)
            if len(head) < 4:
                return
            bs = int.from_bytes(head, "little", signed=True)
            body = r.read(bs)
            if len(body) < bs:
                raise ValueError(f"truncated run file {path}")
            yield head + body
    finally:
        src.close()


def _sorted_header(header: SAMHeader, by_name: bool) -> SAMHeader:
    so = "queryname" if by_name else "coordinate"
    text = header.text
    if "@HD" in text:
        text = re.sub(r"(@HD[^\n]*?)\tSO:\S*", r"\1", text, count=1)
        text = re.sub(r"(@HD[^\n]*)", rf"\1\tSO:{so}", text, count=1)
    else:
        text = f"@HD\tVN:1.6\tSO:{so}\n" + text
    return type(header)(text=text, ref_names=header.ref_names,
                        ref_lengths=header.ref_lengths)


def ragged_slices(data: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Memoryviews of ``data[starts[i]:starts[i] + lens[i]]``, in order."""
    mv = memoryview(np.ascontiguousarray(data)).cast("B")
    starts = np.asarray(starts, np.int64)
    ends = starts + np.asarray(lens, np.int64)
    return map(mv.__getitem__, map(slice, starts.tolist(), ends.tolist()))


def ragged_gather(data: np.ndarray, starts: np.ndarray, lens: np.ndarray
                  ) -> np.ndarray:
    """The bytes ``data[starts[i]:starts[i] + lens[i]]`` for every i,
    concatenated (one join of slices: a per-byte index array would move
    eight bytes of index for each byte gathered)."""
    return np.frombuffer(b"".join(ragged_slices(data, starts, lens)),
                         np.uint8)


class _Run:
    """Decoded records of one run: whole spans concatenated, each
    record's start, length and coordinate key."""

    def __init__(self):
        self.datas: List[np.ndarray] = []
        self.starts: List[np.ndarray] = []
        self.n = 0
        self.nbytes = 0

    def add(self, data: np.ndarray, offs: np.ndarray) -> None:
        self.datas.append(data)
        self.starts.append(offs.astype(np.int64) + self.nbytes)
        self.n += int(offs.size)
        self.nbytes += int(data.size)

    def sorted_chunks(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(record bytes, record offsets) in coordinate order, about
        ``_OUT_CHUNK`` bytes at a time."""
        if not self.n:
            return
        data = np.concatenate(self.datas)
        starts = np.concatenate(self.starts)
        self.datas, self.starts = [], []
        col = starts[:, None] + np.arange(12)
        fixed = data[col].view("<i4").reshape(-1, 3)
        lens = fixed[:, 0].astype(np.int64) + 4
        refid = fixed[:, 1].astype(np.int64)
        key_hi = np.where(refid < 0, _UNMAPPED, refid)
        order = np.lexsort((fixed[:, 2], key_hi))
        ends = np.cumsum(lens[order])
        cuts = np.searchsorted(ends, np.arange(_OUT_CHUNK, int(ends[-1]),
                                               _OUT_CHUNK), side="right")
        bounds = np.unique(np.concatenate([[0], cuts, [order.size]]))
        for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            sel = order[a:b]
            ln = lens[sel]
            yield (ragged_gather(data, starts[sel], ln),
                   np.cumsum(ln) - ln)


def sort_bam(input_path: str, output_path: str, *,
             config: HBamConfig = DEFAULT_CONFIG,
             run_records: int = 1_000_000,
             tmp_dir: Optional[str] = None) -> int:
    """Coordinate-sort a BAM with memory bounded by ``run_records``
    records a run (spilled to ``tmp_dir``, a fresh temporary directory
    by default, removed afterwards); returns the record count.  The
    output and its sidecars equal the reference's ``sort_bam``."""
    from hadoop_bam_torch.formats.bamio import BamWriter, read_bam_header
    from hadoop_bam_torch.parallel.pipeline import iter_file_spans
    from hadoop_bam_torch.write import write_bam_records

    header, _ = read_bam_header(input_path)
    out_header = _sorted_header(header, by_name=False)
    own_tmp = tmp_dir is None
    runs: List[str] = []
    total = 0
    run = _Run()

    def spill() -> None:
        nonlocal run
        p = os.path.join(work, f"run-{len(runs):05d}.bam")
        with BamWriter(p, header, level=1) as w:
            for data, offs in run.sorted_chunks():
                w.write_raw(data.tobytes(), int(offs.size))
        runs.append(p)
        run = _Run()

    work = tempfile.mkdtemp(prefix="hbam_sort_") if own_tmp else tmp_dir
    try:
        for data, offs in iter_file_spans(
                input_path, lambda data, offs, _v: (data, offs), config):
            run.add(data, offs)
            total += int(offs.size)
            if run.n >= run_records:
                spill()
        if not runs:
            chunks = run.sorted_chunks()
        else:
            if run.n:
                spill()

            def chunks():
                merged = heapq.merge(
                    *(((coordinate_key(r), r) for r in _iter_bam_run(p))
                      for p in runs), key=lambda kv: kv[0])
                buf: List[bytes] = []
                offs: List[int] = []
                pos = 0
                for _k, rec in merged:
                    buf.append(rec)
                    offs.append(pos)
                    pos += len(rec)
                    if pos >= _OUT_CHUNK:
                        yield b"".join(buf), np.asarray(offs, np.int64)
                        buf, offs, pos = [], [], 0
                if buf:
                    yield b"".join(buf), np.asarray(offs, np.int64)
            chunks = chunks()
        write_bam_records(output_path, out_header, chunks, config=config)
    finally:
        for p in runs:
            try:
                os.unlink(p)
            except OSError:
                pass
        if own_tmp:
            try:
                os.rmdir(work)
            except OSError:
                pass
    return total
