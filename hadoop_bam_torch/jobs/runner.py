"""Job-level resume policy (trimmed copy of hadoop_bam_tpu/jobs/runner.py):
which config fields a job kind's resume contract fingerprints, the
job-grain idempotence wrapper, and ``resume_job``, which re-drives the
job a journal describes: the mesh sort's kinds, duplicate marking and
the journaled cohort join (resumed a chunk at a time).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Sequence

from hadoop_bam_torch.jobs import journal as jj
from hadoop_bam_torch.obs.context import ensure_trace
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

# the config fields that change a sort's published bytes (or the units
# its journal indexes); observability and scheduling knobs stay out, so
# changing them never strands a resumable journal
SORT_FINGERPRINT_FIELDS = (
    "write_compress_level", "write_header", "write_terminator",
    "write_index_kinds", "splitting_index_granularity",
)
# the join's: the chunk cut (the units the journal indexes) and the
# quarantine policy (which columns come out sentinel)
COHORT_FINGERPRINT_FIELDS = (
    "cohort_chunk_sites", "cohort_quarantine_inputs",
    "cohort_max_quarantine_fraction",
)


def plan_journal_params(plan, extra: Optional[Dict] = None) -> Dict:
    """Journal params carrying a compiled plan's digest (``plan.digest()``),
    so a resume whose plan compiles differently refuses in the params
    match instead of mis-joining units."""
    out = dict(extra or {})
    out["plan_digest"] = plan.digest()
    return out


def sort_job_params(input_path: str, output_path: str, *,
                    exchange: Optional[str],
                    round_records: Optional[int],
                    n_dev: Optional[int] = None) -> Dict:
    """A sort's journal params.  The spill sort's carry ``n_dev``: its
    round units are cut per device position, so a resume on another
    device count must refuse.  Both paths are absolute, so a relative
    spelling resumes from the journal's own params."""
    out = {"input": os.path.abspath(input_path),
           "output": os.path.abspath(output_path),
           "exchange": exchange,
           "round_records": (None if round_records is None
                             else int(round_records))}
    if n_dev is not None:
        out["n_dev"] = int(n_dev)
    return out


def run_job_level(journal_path: str, *, kind: str, config,
                  inputs: Sequence[str], output: str, params: Dict,
                  run: Callable[[], int],
                  fingerprint_fields: Sequence[str] = SORT_FINGERPRINT_FIELDS
                  ) -> int:
    """Idempotence at job grain for a job that is one unit of work: a
    journal whose ``job_done`` matches the (verified) output makes the
    re-run a no-op; anything else runs ``run()`` and commits its result.
    A mismatched identity, fingerprint or params refuses (PlanError)."""
    output = os.path.abspath(output)
    with ensure_trace(op=f"job.{kind}"):
        jr, state = jj.JobJournal.resume(
            journal_path, kind=kind,
            inputs=[(os.path.abspath(p), jj.file_identity_digest(p))
                    for p in inputs],
            output=output,
            fingerprint=jj.config_fingerprint(config, fingerprint_fields),
            config_values=jj.fingerprint_values(config,
                                                fingerprint_fields),
            params=params,
            fsync=bool(getattr(config, "journal_fsync", True)))
        with jr:
            if state is not None and state.done is not None:
                d = state.done
                if jj.verify_artifact(output, d.get("size", -1),
                                      d.get("crc", "")):
                    METRICS.count("jobs.jobs_skipped")
                    return int(d.get("records", 0))
            n = int(run())
            size, crc = jj.file_digest(output)
            jr.job_done(records=n, size=size, crc=crc)
            return n


def resume_job(journal_path: str, config=None, device=None) -> Dict:
    """Re-drive the job a journal describes; every check (input identity,
    fingerprint, plan digest, each unit's artifacts) happens inside the
    pipeline as it re-opens the journal, so resuming a resume is the same
    path.  The config's fingerprinted fields come from the journal's
    header, so a job run with non-default settings resumes as it ran.
    Returns {kind, output, records}; a cohort join {kind, output (None),
    chunks, sites, quarantined}."""
    from hadoop_bam_torch.config import DEFAULT_CONFIG

    config = DEFAULT_CONFIG if config is None else config
    state = jj.JobJournal.replay(journal_path)
    kind = state.kind
    params = dict(state.header.get("params", {}))
    recorded = {k: v for k, v in dict(state.header.get("config",
                                                       {})).items()
                if hasattr(config, k)}
    if recorded:
        config = dataclasses.replace(config, **recorded)
    with ensure_trace(op=f"job.resume.{kind}"):
        if kind in ("mesh_sort_spill", "mesh_sort"):
            from hadoop_bam_torch.parallel.mesh_sort import sort_bam_mesh
            n = sort_bam_mesh(
                params["input"], params["output"], device=device,
                config=config, exchange=params.get("exchange"),
                round_records=params.get("round_records"),
                journal_path=journal_path)
            return {"kind": kind, "output": params["output"], "records": n}
        if kind == "mkdup":
            from hadoop_bam_torch.prep.pipeline import markdup_bam_mesh
            missing = [k for k in ("input", "output") if k not in params]
            if missing:
                raise PlanError(
                    f"journal {journal_path} records a 'mkdup' job without "
                    f"its {missing} params: no duplicate-marking run of "
                    f"the port wrote it")
            n = markdup_bam_mesh(
                params["input"], params["output"], device=device,
                config=config,
                remove_duplicates=bool(params.get("remove_duplicates",
                                                  False)),
                library_from=params.get("library_from", "none"),
                round_records=params.get("round_records"),
                journal_path=journal_path)
            return {"kind": kind, "output": params["output"], "records": n}
        if kind == "cohort_join":
            from hadoop_bam_torch.cohort.dataset import open_cohort
            manifest = params.get("manifest")
            if not manifest:
                raise PlanError(
                    f"journal {journal_path} records a 'cohort_join' job "
                    f"over an inline manifest (or without its manifest "
                    f"param): only manifest-file joins resume from the "
                    f"journal alone; resume through "
                    f"open_cohort(..., journal_path=...)")
            ds = open_cohort(manifest, device=device, config=config,
                             journal_path=journal_path)
            sites = chunks = 0
            for chunk in ds.site_chunks():
                sites += int(chunk["pos"].shape[0])
                chunks += 1
            return {"kind": kind, "output": None, "chunks": chunks,
                    "sites": sites,
                    "quarantined": sorted(ds.manifest.quarantined)}
    raise PlanError(
        f"journal {journal_path} records job kind {kind!r}, which the port "
        f"cannot resume (resumable kinds: mesh_sort_spill, mesh_sort, "
        f"mkdup, cohort_join)")
