"""The duplicate-marking pipeline: read -> sort exchange -> markdup ->
indexed write as one journaled run (copy of hadoop_bam_tpu/prep/
pipeline.py, one process on one device).

The sort half is the spill bytes exchange of ``parallel/mesh_sort.py``
(its plan, bucket bounds, framed spill runs and per-bucket k-way
merge), with K16a's signature columns computed in the same step from
the rows already on the card (``prep/markdup.fused_sort_markdup_step``).
The duplicate bits then ride a columns-only exchange (K16b, 7 words a
record), and the flag patch is applied record by record between the
spill merge and the output's deflate.

Journal grains (``jobs/``), one a stage:

- ``round``: each sort round's spilled runs and its signature-column
  sidecar (size and CRC verified on resume; a partial round is swept);
- ``markdup``: the duplicate bitmap over global record indices;
- ``shard``: the written output.  At one device there is one bucket,
  so the merge streams straight into the output and its sidecars; the
  reference's per-bucket parts and their concatenation
  (``write/sharded.py``, ``write_bam_shards_concat``) wait for more
  than one device.

A SIGKILL at any stage boundary resumes byte-identically: finished
rounds are not decoded again, a finished bitmap is not exchanged again,
a committed output is not deflated again (``jobs.rounds_skipped`` /
``jobs.markdup_skipped`` / ``jobs.shards_skipped``).

The semantics are ``prep.oracle``'s, byte for byte.  Deliberate
differences from the reference: ``device`` stands where it takes a mesh
(n_dev = 1, so one bucket, written without a part); the journal's params
carry no compiled plan's digest (the plan IR is not ported).
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError

DEFAULT_ROUND_RECORDS = 1_000_000
_SIG = ("k0", "k1", "k2", "k3", "k4", "score", "gidx")


def markdup_bam_mesh(input_path: str, output_path: str, *, device=None,
                     config: HBamConfig = DEFAULT_CONFIG,
                     header: Optional[SAMHeader] = None,
                     remove_duplicates: bool = False,
                     library_from: str = "none",
                     round_records: Optional[int] = None,
                     journal_path: Optional[str] = None) -> int:
    """Mark duplicates in ``input_path`` and write the coordinate-sorted
    result to ``output_path`` on ``device`` (``cuda:0`` by default).
    Returns the number of records written; the bytes are
    ``oracle.markdup_bam_oracle``'s with the same options.

    The spilled runs, the column sidecars and the duplicate bitmap
    live in ``<output>.mkdup-spill``, removed on success and
    on failure without a journal (with one, the finished units are the
    resume state and stay)."""
    from hadoop_bam_torch.device import resolve_device

    if round_records is None:
        round_records = DEFAULT_ROUND_RECORDS
    if int(round_records) <= 0:
        raise PlanError(f"round_records must be positive, got "
                        f"{round_records}")
    dev = resolve_device(device)
    ok = False
    try:
        n = _markdup_bam_mesh_impl(
            input_path, output_path, device=dev, config=config,
            header=header, remove_duplicates=bool(remove_duplicates),
            library_from=library_from, round_records=int(round_records),
            journal_path=journal_path)
        ok = True
        return n
    finally:
        keep = bool(config.debug_keep_spill) \
            or (journal_path is not None and not ok)
        if not keep:
            shutil.rmtree(output_path + ".mkdup-spill", ignore_errors=True)


def mkdup_job_params(input_path: str, output_path: str, *,
                     remove_duplicates: bool, library_from: str,
                     round_records: int, n_dev: int = 1) -> dict:
    """A duplicate-marking job's journal params (the reference's, less
    the compiled plan's digest); both paths absolute, so a relative
    spelling resumes from the journal's own params."""
    return {"input": os.path.abspath(input_path),
            "output": os.path.abspath(output_path),
            "remove_duplicates": bool(remove_duplicates),
            "library_from": library_from,
            "round_records": int(round_records),
            "n_dev": int(n_dev)}


def _resume_units(resume, jj, n_rounds: int, shard_dir: str):
    """The rounds and the bitmap of a prior attempt whose files still
    verify; everything else in the spill directory is swept."""
    rounds = {}
    for t in range(n_rounds):
        u = resume.unit("round", t)
        if u is None:
            continue
        cols = u.get("cols")
        if all(jj.verify_artifact(p, s, c) for _b, p, s, c
               in u.get("runs", [])) \
                and cols is not None and jj.verify_artifact(*cols):
            rounds[t] = u
    mu = resume.unit("markdup", 0)
    if mu is not None and not jj.verify_artifact(
            mu.get("path", ""), mu.get("size", -1), mu.get("crc", "")):
        mu = None
    recorded = [p for u in rounds.values() for _b, p, _s, _c in u["runs"]]
    recorded += [u["cols"][0] for u in rounds.values()]
    if mu is not None:
        recorded.append(mu["path"])
    # the in-flight round's partial spills are debris, not state
    jj.sweep_unrecorded(shard_dir, recorded,
                        counter="jobs.stale_runs_swept")
    return rounds, mu


def _markdup_bam_mesh_impl(input_path: str, output_path: str, *, device,
                           config: HBamConfig,
                           header: Optional[SAMHeader],
                           remove_duplicates: bool, library_from: str,
                           round_records: int,
                           journal_path: Optional[str]) -> int:
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.prep.oracle import library_map
    from hadoop_bam_torch.utils.metrics import METRICS

    n_dev = 1
    if header is None:
        header, _ = read_bam_header(input_path)
    rg_to_lib = library_map(header, library_from)

    jr = resume = jj = None
    if journal_path is not None:
        from hadoop_bam_torch.jobs import journal as jj
        from hadoop_bam_torch.jobs.runner import SORT_FINGERPRINT_FIELDS
        jr, resume = jj.JobJournal.resume(
            journal_path, kind="mkdup",
            inputs=[(os.path.abspath(input_path),
                     jj.file_identity_digest(input_path))],
            output=os.path.abspath(output_path),
            fingerprint=jj.config_fingerprint(config,
                                              SORT_FINGERPRINT_FIELDS),
            config_values=jj.fingerprint_values(config,
                                                SORT_FINGERPRINT_FIELDS),
            params=mkdup_job_params(
                input_path, output_path,
                remove_duplicates=remove_duplicates,
                library_from=library_from, round_records=round_records,
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

    spans = ms._spill_plan(input_path, header, round_records, n_dev)
    n_rounds = max(1, -(-len(spans) // n_dev))
    shard_dir = output_path + ".mkdup-spill"
    resumed: dict = {}
    markdup_unit = None
    bounds_ev = None
    if jr is not None:
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
            resumed, markdup_unit = _resume_units(resume, jj, n_rounds,
                                                  shard_dir)
            if resumed and bounds_ev is None:
                raise PlanError(
                    f"refusing to resume {journal_path}: finished rounds "
                    f"are recorded but round 0's bucket bounds are not; "
                    f"delete the journal to start over")
            spans_skipped = sum(min((t + 1) * n_dev, len(spans)) - t * n_dev
                                for t in resumed)
            if resumed:
                METRICS.count("jobs.rounds_skipped", len(resumed))
                METRICS.count("jobs.spans_skipped", spans_skipped)
            jr.event("resume_plan", rounds_total=int(n_rounds),
                     rounds_skipped=len(resumed),
                     spans_skipped=int(spans_skipped))
    if not resumed and markdup_unit is None:
        shutil.rmtree(shard_dir, ignore_errors=True)
    os.makedirs(shard_dir, exist_ok=True)

    # ---------------- stage 1: the fused sort exchange + columns ------
    with METRICS.span("prep.sort_wall"):
        run_files, col_files, total = _sort_stage(
            input_path, spans, n_rounds, shard_dir, device=device,
            config=config, rg_to_lib=rg_to_lib, resumed=resumed,
            bounds_ev=bounds_ev, jr=jr, jj=jj)

    # ---------------- stage 2: the duplicate-group exchange -----------
    with METRICS.span("prep.markdup_wall"):
        if markdup_unit is not None:
            dup_bits = np.fromfile(markdup_unit["path"], np.uint8)
            if dup_bits.size != total:
                raise CorruptDataError(
                    f"the journaled duplicate bitmap covers "
                    f"{dup_bits.size} records but the plan decodes "
                    f"{total}: the spill state is inconsistent; delete the "
                    f"journal to start over")
            METRICS.count("jobs.markdup_skipped")
        else:
            dup_bits = _duplicate_bitmap(col_files, total, device)
            dpath = os.path.join(shard_dir, "dupbits.u8")
            with open(dpath, "wb") as f:
                f.write(dup_bits.tobytes())
            if jr is not None:
                size, crc = jj.file_digest(dpath)
                jr.unit_done("markdup", 0, path=os.path.abspath(dpath),
                             size=size, crc=crc,
                             n_dups=int(dup_bits.sum()), total=int(total))
        n_dups = int(dup_bits.sum())
        METRICS.count("prep.duplicates_marked", n_dups)

    # ---------------- stage 3: the patched merge and the write --------
    with METRICS.span("prep.write_wall"):
        written = _write_stage(output_path, header, run_files, dup_bits,
                               config=config,
                               remove_duplicates=remove_duplicates,
                               resume=resume, jj=jj)
        expected = total - (n_dups if remove_duplicates else 0)
        if written != expected:
            raise CorruptDataError(
                f"duplicate marking wrote {written} of {expected} records: "
                f"the output is invalid")

    if jr is not None:
        size, crc = jj.file_digest(output_path)
        jr.unit_done("shard", 0, path=os.path.abspath(output_path),
                     size=size, crc=crc, records=int(written))
        jr.job_done(records=int(written), size=size, crc=crc)
        jr.close()
    return written


def _sort_stage(input_path, spans, n_rounds, shard_dir, *, device, config,
                rg_to_lib, resumed, bounds_ev, jr, jj):
    """Stage 1: each round decodes its span, joins the library column,
    runs the fused step, spills its bucket as a framed sorted run and its
    eligible records' signature columns as ``cols-rNNNNN.npz``.  Returns
    (bucket -> run paths, column sidecars in round order, records)."""
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.prep.markdup import (
        fused_sort_markdup_step, host_kmax, host_row_bytes,
    )
    from hadoop_bam_torch.prep.oracle import library_column
    bhi = blo = None
    prefix_total = 0
    run_files: dict = {}
    col_files: List[str] = []
    for t in range(n_rounds):
        if t in resumed:
            # a journal-verified round: its files are on disk with the
            # recorded size and CRC; nothing is decoded
            u = resumed[t]
            for b, p, _s, _c in u["runs"]:
                run_files.setdefault(int(b), []).append(p)
            col_files.append(u["cols"][0])
            prefix_total += int(u.get("round_total", 0))
            continue
        if t < len(spans):
            data, offs = ms._decode(input_path, spans[t], config)
        else:
            data, offs = np.zeros(0, np.uint8), np.zeros(0, np.int64)
        lens = ms._record_lens(data, offs)
        libs = library_column(data, offs, lens, rg_to_lib)
        count = int(offs.size)
        max_len = int(lens.max()) if count else 0
        kmax = host_kmax(data, offs)
        row_bytes = host_row_bytes(data, offs)
        if bhi is None:
            if bounds_ev is not None:
                # the finished rounds' runs were bucketed under these
                bhi = torch.tensor(bounds_ev["bhi"], dtype=torch.int64,
                                   device=device)
                blo = torch.tensor(bounds_ev["blo"], dtype=torch.int64,
                                   device=device)
            else:
                h, l = ms._keys_of(data, offs)
                bhi, blo = ms._bounds([h], [l], 1, device)
                if jr is not None:
                    jr.event("bounds", bhi=bhi.tolist(), blo=blo.tolist())
        ms.check_global_index_ceiling(prefix_total + count,
                                      "duplicate marking (mid-run backstop)")
        base = prefix_total
        prefix_total += count

        records_cap = ms._round_up(max(count, 1), 1024)
        stride = 1 << max(6, int(max(max_len, 36) - 1).bit_length())
        kpow = 0 if kmax == 0 else 1 << (kmax - 1).bit_length()
        rows, ln = ms.pack_rows(torch.from_numpy(data).to(device) if data.size
                                else torch.zeros(1, dtype=torch.uint8,
                                                 device=device),
                                offs, lens, records_cap, stride)
        del data
        lib = torch.zeros(records_cap, dtype=torch.uint32)
        lib[:count] = torch.from_numpy(libs)
        (rows_s, lens_s, six_s), (cols, elig) = fused_sort_markdup_step(
            rows, ln, count, base, lib.to(device), bhi, blo, kpow, row_bytes)
        del rows, ln

        # the sort half: the bucket's sorted rows as a framed run
        keep = six_s != ms._I32_SENTINEL
        round_runs: List[Tuple[int, str]] = []
        if bool(keep.any()):
            rows_k = rows_s[keep].cpu().numpy()
            lens_k = lens_s[keep].cpu().numpy()
            six_k = six_s[keep].cpu().numpy()
            hi_k, lo_k = ms._keys_of(
                rows_k.ravel(),
                np.arange(rows_k.shape[0], dtype=np.int64) * rows_k.shape[1])
            path = os.path.join(shard_dir, f"b{0:05d}-r{t:05d}.run")
            with open(path, "wb") as f:
                f.write(ms._frame_run(rows_k, lens_k, six_k, hi_k, lo_k))
            run_files.setdefault(0, []).append(path)
            round_runs.append((0, path))
        del rows_s, lens_s, six_s

        # the markdup half: eligible records' columns, 28 B a record
        # (selected on the host: torch indexes no uint32 tensor on CUDA)
        el = elig[:count].cpu().numpy().astype(bool)
        parts = dict(zip(_SIG[:6], cols[:, :count].cpu().numpy()[:, el]))
        parts["gidx"] = (base + np.flatnonzero(el)).astype(np.int32)
        cpath = os.path.join(shard_dir, f"cols-r{t:05d}.npz")
        with open(cpath, "wb") as f:
            np.savez(f, **parts)
        col_files.append(cpath)
        if jr is not None:
            # the round's commit record, written once its files landed
            jr.unit_done(
                "round", t,
                runs=[[b, os.path.abspath(p), *jj.file_digest(p)]
                      for b, p in round_runs],
                cols=[os.path.abspath(cpath), *jj.file_digest(cpath)],
                round_total=int(count))
    return run_files, col_files, prefix_total


def _duplicate_bitmap(col_files: List[str], total: int,
                      device) -> np.ndarray:
    """Stage 2: every round's eligible columns through K16b; one uint8
    duplicate bit a global record index."""
    from hadoop_bam_torch.parallel.mesh_sort import _I32_SENTINEL, _round_up
    from hadoop_bam_torch.prep.markdup import markdup_exchange_step
    sig = {n: [] for n in _SIG}
    for cpath in col_files:
        with np.load(cpath) as z:
            for n in _SIG:
                sig[n].append(z[n])
    m = int(sum(a.size for a in sig["gidx"]))
    dup_bits = np.zeros(total, np.uint8)
    if not m:
        return dup_bits
    cap = _round_up(m, 1024)

    def padded(name, dtype):
        out = torch.zeros(cap, dtype=dtype)
        out[:m] = torch.from_numpy(np.concatenate(sig[name]))
        return out.to(device)

    args = [padded(n, torch.uint32) for n in _SIG[:6]]
    six, dup = markdup_exchange_step(*args, padded("gidx", torch.int32), m)
    six, dup = six.cpu().numpy(), dup.cpu().numpy()
    dup_bits[six[(six != _I32_SENTINEL) & (dup == 1)]] = 1
    return dup_bits


def _write_stage(output_path, header, run_files, dup_bits, *, config,
                 remove_duplicates, resume, jj) -> int:
    """Stage 3: a k-way merge of the bucket's runs with the flag patched,
    streamed into the output with its sidecars.  At one device the
    output is the one part, so a journaled ``("shard", 0)`` unit that
    still verifies against it skips the write.  Returns the records
    written."""
    from hadoop_bam_torch.parallel.mesh_sort import _iter_run_frames
    from hadoop_bam_torch.split.kmerge import kmerge
    from hadoop_bam_torch.utils.metrics import METRICS
    from hadoop_bam_torch.utils.sort import _sorted_header
    from hadoop_bam_torch.write import write_bam_records
    if resume is not None:
        u = resume.unit("shard", 0)
        if u is not None and jj.verify_artifact(
                output_path, u.get("size", -1), u.get("crc", "")):
            METRICS.count("jobs.shards_skipped")
            return int(u.get("records", 0))

    def chunks():
        buf: List[bytes] = []
        offsets: List[int] = []
        pos = 0
        for (_hi, _lo, gidx), payload in kmerge(
                (_iter_run_frames(p) for p in run_files.get(0, [])),
                key=lambda kv: kv[0]):
            dup = int(dup_bits[gidx])
            if remove_duplicates and dup:
                continue
            flag = int.from_bytes(payload[18:20], "little")
            nf = (flag & ~0x400) | (0x400 if dup else 0)
            if nf != flag:
                payload = payload[:18] + nf.to_bytes(2, "little") \
                    + payload[20:]
            buf.append(payload)
            offsets.append(pos)
            pos += len(payload)
            if pos >= (8 << 20):
                yield b"".join(buf), np.asarray(offsets, np.int64)
                buf, offsets, pos = [], [], 0
        if buf:
            yield b"".join(buf), np.asarray(offsets, np.int64)

    return write_bam_records(output_path, _sorted_header(header, False),
                             chunks(), config=config).records
