"""CohortDataset: the [variants, samples] tensor surface over a manifest
(copy of hadoop_bam_tpu/cohort/dataset.py).

The cohort twin of ``api.vcf_dataset.VcfDataset``: where that class
tiles ONE file's variants, this one streams k single-sample files
through the position join (cohort/join.py) and tiles the JOINED columns
onto the card through the same ``variant_feed`` / ``FeedPipeline``
machinery (``plan.executor.run_cohort_batches``), so the sentinel pads
(-1 dosage / NaN qual), ring-slot reuse and the in-flight copy rule are
inherited, not re-implemented.

Deliberate difference: the dataset takes ``device=`` where the
reference takes a mesh (``cuda:0`` unless the caller names another;
RuntimeError without a card), and its batches carry a leading device
axis of 1.
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Union

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.cohort.join import (
    _JoinState, build_contig_space, guarded_sites, iter_joined_chunks,
    iter_sample_sites,
)
from hadoop_bam_torch.cohort.manifest import CohortManifest, as_manifest
from hadoop_bam_torch.device import resolve_device
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

_CHUNK_KEYS = ("chrom", "pos", "n_allele", "dosage", "qual")


class CohortDataset:
    """Tiled access to a cohort of single-sample VCF/BCF files.

    ``tensor_batches`` yields dicts of tensors on the dataset's device::

        chrom    int32  [1, cap]
        pos      int32  [1, cap]
        n_allele int16  [1, cap]
        dosage   int8   [1, cap, samples_pad]   (-1 missing)
        qual     float32[1, cap, samples_pad]   (NaN missing)
        n_records int32 [1]

    Rows past ``n_records`` carry the sentinels (dosage -1, qual NaN, 0
    elsewhere).  Column ``j`` is ``manifest.samples[j]``; a sample whose
    input quarantined mid-join is sentinel-filled from the fault onward
    and listed in ``self.manifest.quarantined``.
    """

    def __init__(self, source: Union[str, CohortManifest, List[str]],
                 device=None, config: HBamConfig = DEFAULT_CONFIG,
                 journal_path: Optional[str] = None):
        from hadoop_bam_torch.api.vcf_dataset import VcfDataset
        from hadoop_bam_torch.parallel.variant_pipeline import (
            VariantGeometry,
        )
        from hadoop_bam_torch.resilience import file_ident, registry
        from hadoop_bam_torch.utils.errors import (
            CorruptDataError, PLAN, classify_error,
        )

        self.device = resolve_device(device)
        self.config = config
        self.journal_path = journal_path
        self._journal_live = False     # one journaled join at a time
        self.manifest = as_manifest(source)
        quarantine = bool(config.cohort_quarantine_inputs)
        # header reads: a MISSING path is configuration (PLAN, raises); a
        # file whose header bytes are corrupt is data: under the
        # quarantine policy its column goes sentinel before the join
        # starts (the slot is kept as None so sample indices stay put)
        self._datasets: List = []
        for s in self.manifest.samples:
            try:
                self._datasets.append(VcfDataset(s.path, self.device,
                                                 config))
            except Exception as e:  # noqa: BLE001 — classified below
                if classify_error(e) == PLAN or not quarantine:
                    raise
                registry().domain("cohort", "input", file_ident(s.path),
                                  config=config).record_failure(e)
                self.manifest.record_quarantine(
                    s.sample_id, f"{type(e).__name__}: {e}")
                METRICS.count("cohort.samples_quarantined")
                self._datasets.append(None)
        n_dead = sum(1 for d in self._datasets if d is None)
        max_frac = float(config.cohort_max_quarantine_fraction)
        if n_dead / max(1, self.manifest.n_samples) > max_frac:
            raise CorruptDataError(
                f"cohort build: {n_dead}/{self.manifest.n_samples} "
                f"sample inputs quarantined at header read — over the "
                f"cohort_max_quarantine_fraction={max_frac} circuit")
        self.contigs = build_contig_space(
            [ds.header for ds in self._datasets if ds is not None])
        self._cmap = {c: i for i, c in enumerate(self.contigs)}
        self.geometry = VariantGeometry(n_samples=self.manifest.n_samples)

    @property
    def n_samples(self) -> int:
        return self.manifest.n_samples

    @property
    def sample_ids(self) -> List[str]:
        return self.manifest.sample_ids

    def contig_index(self, name: str) -> int:
        return self._cmap.get(name, -1)

    # -- host-side joined columns (the serve tier and oracle surface) -------

    def site_chunks(self) -> Iterator[Dict[str, np.ndarray]]:
        """Stream the joined cohort as host column chunks (up to
        ``config.cohort_chunk_sites`` rows each): the input of the
        tensor feed and of the serve tier's tile builder.

        With a ``journal_path`` the join is crash-safe (jobs/): every
        chunk persists to ``<journal>.chunks/chunk-NNNNN.npz`` and
        commits a journaled unit (size, CRC, last site key); a resumed
        join replays the verified chunks from disk, then continues the
        live merge past the last committed key.  Input records are still
        re-streamed for the continuation (a k-way merge needs its
        cursors), so the savings are the join / harmonize / pack work
        and, on a finished job, the whole decode.  A quarantine caused
        by a transient fault may heal on resume: the journaled chunks
        keep their sentinel columns, the live suffix carries real data,
        recorded as ``quarantine`` events either way."""
        if self.journal_path is not None and self._journal_live:
            # refused BEFORE the streams are built: building them resets
            # every sample's span cursor under the live iteration
            raise PlanError(
                f"a journaled join over {self.journal_path} is already "
                f"in progress on this dataset — close (exhaust) the "
                f"prior site_chunks() iterator before starting another")
        state = _JoinState(self.manifest.n_samples,
                           float(self.config.cohort_max_quarantine_fraction))
        # header-time casualties count toward the fraction circuit
        state.quarantined = sum(1 for d in self._datasets if d is None)
        streams = []
        for ds, sample in zip(self._datasets, self.manifest.samples):
            if ds is None:
                streams.append(iter(()))   # quarantined at header read
                continue
            # every join starts from the file's first span: records()
            # only starts over after an exhausted iteration, and a join
            # abandoned mid-stream would otherwise resume mid-file
            ds._next_span = 0
            sites = iter_sample_sites(ds.records(), self._cmap)
            streams.append(guarded_sites(
                sites, sample.sample_id, sample.path, self.manifest,
                state, self.config))
        if self.journal_path is None:
            return iter_joined_chunks(self.manifest, streams,
                                      self.geometry.samples_pad,
                                      self.config)
        return self._journaled_chunks(streams)

    def _journaled_chunks(self, streams) -> Iterator[Dict[str,
                                                          np.ndarray]]:
        """``iter_joined_chunks`` under the journal (``site_chunks``):
        replay verified chunks, sweep the in-flight chunk's debris,
        continue past the last committed key, commit each fresh chunk
        before handing it on."""
        from hadoop_bam_torch.jobs import journal as jj
        from hadoop_bam_torch.jobs.runner import (
            COHORT_FINGERPRINT_FIELDS, plan_journal_params,
        )

        chunks_dir = os.path.abspath(self.journal_path) + ".chunks"

        def load(u):
            with np.load(u["path"]) as z:
                return {kk: z[kk] for kk in _CHUNK_KEYS}

        def gen():
            # the journal open, the lock and the replay happen at the
            # first next(): a generator that is never started runs no
            # body, so eager setup would leave the dataset locked with
            # an open journal
            if self._journal_live:
                raise PlanError(
                    f"a journaled join over {self.journal_path} is "
                    f"already in progress on this dataset")
            self._journal_live = True
            jr = None
            try:
                anchor, _k, digest = self.manifest.identity()
                jr, state = jj.JobJournal.resume(
                    self.journal_path, kind="cohort_join",
                    inputs=[(anchor or "<inline-manifest>", digest)],
                    output=None,
                    fingerprint=jj.config_fingerprint(
                        self.config, COHORT_FINGERPRINT_FIELDS),
                    config_values=jj.fingerprint_values(
                        self.config, COHORT_FINGERPRINT_FIELDS),
                    # the plan digest rides the params: a resume whose
                    # plan compiles differently (another manifest
                    # identity, other join knobs) refuses
                    params=plan_journal_params(self.plan(), {
                        "manifest":
                            (os.path.abspath(self.manifest.path)
                             if self.manifest.path else None)}),
                    fsync=bool(self.config.journal_fsync))
                replayed = []
                if state is not None:
                    while True:
                        u = state.unit("chunk", len(replayed))
                        if u is None or not jj.verify_artifact(
                                u.get("path", ""), u.get("size", -1),
                                u.get("crc", "")):
                            break
                        replayed.append(u)
                    jj.sweep_unrecorded(
                        chunks_dir, [u["path"] for u in replayed],
                        counter="jobs.stale_chunks_swept")
                # a finished job with every chunk intact: pure replay,
                # the input streams are never touched
                replay_only = (state is not None
                               and state.done is not None
                               and int(state.done.get("chunks", -1))
                               == len(replayed))
                last_key = None
                for u in replayed:
                    METRICS.count("jobs.chunks_replayed")
                    last_key = (int(u.get("key_hi", 0)),
                                int(u.get("key_lo", 0)))
                    yield load(u)
                if replay_only:
                    METRICS.count("jobs.jobs_skipped")
                    return
                if replayed:
                    METRICS.count("jobs.cohort_resumes")
                os.makedirs(chunks_dir, exist_ok=True)
                seen_q = set(self.manifest.quarantined)
                i = len(replayed)
                for chunk in iter_joined_chunks(
                        self.manifest, streams,
                        self.geometry.samples_pad, self.config,
                        skip_through_key=last_key):
                    for sid in sorted(set(self.manifest.quarantined)
                                      - seen_q):
                        # observability, not replayed state: a
                        # deterministic fault fires again on resume, a
                        # transient one heals
                        jr.event("quarantine", sample=sid)
                        seen_q.add(sid)
                    # absolute: the unit verifies from any cwd
                    path = os.path.join(chunks_dir, f"chunk-{i:05d}.npz")
                    np.savez(path, **chunk)
                    size, crc = jj.file_digest(path)
                    jr.unit_done(
                        "chunk", i, path=path, size=size, crc=crc,
                        sites=int(chunk["pos"].shape[0]),
                        # group keys strictly increase, so the last
                        # row's (chrom, pos) is the chunk's high mark
                        key_hi=int(chunk["chrom"][-1]),
                        key_lo=int(chunk["pos"][-1]))
                    i += 1
                    yield chunk
                jr.job_done(chunks=i)
            finally:
                self._journal_live = False
                if jr is not None:
                    jr.close()

        return gen()

    # -- the tensor feed -----------------------------------------------------

    def plan(self):
        """This cohort's plan (``plan.builders.cohort_plan``): the
        identity the journal records."""
        from hadoop_bam_torch.plan import builders
        return builders.cohort_plan(self.manifest, self.config,
                                    geometry=self.geometry)

    def tensor_batches(self, geometry=None) -> Iterator[Dict]:
        """Joined tensor batches on the dataset's device (class
        docstring), through ``plan.executor.run_cohort_batches``.  Lazy:
        no join work and no journal open until the first batch is asked
        for.  ``geometry`` re-tiles the feed only: the join (and the
        journal's plan digest) keeps ``self.geometry``."""
        from hadoop_bam_torch.plan.executor import run_cohort_batches
        return run_cohort_batches(self, geometry)

    # -- drivers -------------------------------------------------------------

    def gwas(self, phenotype=None) -> Dict[str, np.ndarray]:
        """Per-variant GWAS columns (cohort/gwas.py): allele frequency,
        call rate, HWE chi-square and, with a phenotype vector, the
        score-test chi-square."""
        from hadoop_bam_torch.cohort.gwas import cohort_gwas
        return cohort_gwas(self, phenotype=phenotype, config=self.config)


def open_cohort(source: Union[str, CohortManifest, List[str]],
                device=None, config: HBamConfig = DEFAULT_CONFIG,
                journal_path: Optional[str] = None) -> CohortDataset:
    """A manifest (path, object or bare path list) as a cohort dataset on
    ``cuda:0`` (or ``device``); ``journal_path`` makes the join
    crash-safe (``site_chunks``)."""
    return CohortDataset(source, device=device, config=config,
                         journal_path=journal_path)
