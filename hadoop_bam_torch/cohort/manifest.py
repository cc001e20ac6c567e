"""Cohort manifests: the named set of single-sample inputs a join runs over
(copy of hadoop_bam_tpu/cohort/manifest.py).

A manifest is a JSON document::

    {"samples": [{"id": "NA00001", "path": "calls/NA00001.bcf"},
                 {"id": "NA00002", "path": "calls/NA00002.vcf.gz"}]}

or, minimally, a bare list of paths (sample ids default to the file
stem).  Relative paths resolve against the manifest file's directory,
so a manifest can travel with its call set.

The manifest's **identity** is what the serve tier keys device-resident
dosage tiles on: the manifest path plus every input's
``(abspath, size, mtime_ns)`` file identity, digested — rewrite any
sample file (or the manifest) and every cached cohort tile derived from
the old identity simply never matches again, the same self-invalidation
contract as ``query.cache.file_identity``.

A malformed or missing manifest is run CONFIGURATION: ``PlanError``,
never retried, never quarantined.  Quarantine is reserved for sample files whose
*bytes* fault mid-join (cohort/join.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

from hadoop_bam_torch.utils.errors import PlanError


def _stat_all(paths: Sequence[str]) -> List[os.stat_result]:
    """``os.stat`` of every (absolute) path, in order, each relative to
    its directory opened once: where the file system resolves a path by
    a round trip a component, thousands of full-path stats are most of
    a warm cohort slice.  A missing input raises FileNotFoundError, as
    its stat would."""
    fds: Dict[str, int] = {}
    try:
        out = []
        for p in paths:
            d, name = os.path.split(p)
            fd = fds.get(d)
            if fd is None:
                fd = fds[d] = os.open(d, os.O_RDONLY | os.O_DIRECTORY)
            out.append(os.stat(name, dir_fd=fd))
        return out
    finally:
        for fd in fds.values():
            os.close(fd)


@dataclasses.dataclass(frozen=True)
class CohortSample:
    """One input of the cohort: a sample id and its single-sample
    VCF/BCF path (any container ``api.dispatch`` recognises)."""
    sample_id: str
    path: str


def _default_id(path: str) -> str:
    base = os.path.basename(path)
    for suffix in (".vcf.gz", ".vcf.bgz", ".vcf", ".bcf"):
        if base.lower().endswith(suffix):
            return base[:-len(suffix)]
    return os.path.splitext(base)[0]


@dataclasses.dataclass
class CohortManifest:
    """The resolved sample set plus (after a build) quarantine records."""

    samples: List[CohortSample]
    path: Optional[str] = None          # manifest file, when loaded from one
    # sample_id -> reason string, recorded by the join when an input
    # quarantines (sentinel-filled column); merged, never reset, so a
    # caller holding the manifest sees every build's casualties
    quarantined: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    @property
    def sample_ids(self) -> List[str]:
        return [s.sample_id for s in self.samples]

    def identity(self) -> Tuple[str, int, str]:
        """(anchor path, n_samples, digest of every input's file
        identity) — the device-tile cache key component.  Raises
        ``FileNotFoundError`` (PLAN class) for a missing input: a bad
        path is configuration."""
        h = hashlib.sha256()
        paths = [os.path.abspath(s.path) for s in self.samples]
        for s, p, st in zip(self.samples, paths, _stat_all(paths)):
            h.update(f"{s.sample_id}\0{p}\0{st.st_size}\0"
                     f"{st.st_mtime_ns}\n".encode())
        anchor = (os.path.abspath(self.path) if self.path
                  else "<inline-manifest>")
        return (anchor, len(self.samples), h.hexdigest()[:32])

    def record_quarantine(self, sample_id: str, reason: str) -> None:
        self.quarantined.setdefault(sample_id, reason)

    def to_dict(self) -> Dict:
        out: Dict = {"samples": [{"id": s.sample_id, "path": s.path}
                                 for s in self.samples]}
        if self.quarantined:
            out["quarantined"] = dict(self.quarantined)
        return out

    @classmethod
    def from_doc(cls, doc: Union[Dict, Sequence],
                 base_dir: Optional[str] = None,
                 path: Optional[str] = None) -> "CohortManifest":
        """Build from a parsed JSON document (dict with "samples", or a
        bare list of path strings / sample dicts)."""
        if isinstance(doc, dict):
            entries = doc.get("samples")
            if entries is None:
                raise PlanError(
                    'cohort manifest object needs a "samples" list')
        else:
            entries = doc
        if not isinstance(entries, (list, tuple)) or not entries:
            raise PlanError("cohort manifest needs a non-empty sample list")
        samples: List[CohortSample] = []
        seen = set()
        for i, e in enumerate(entries):
            if isinstance(e, str):
                spath, sid = e, None
            elif isinstance(e, dict) and "path" in e:
                spath = str(e["path"])
                sid = e.get("id")
            else:
                raise PlanError(
                    f"cohort manifest sample #{i} must be a path string or "
                    f'an object with "path" (and optional "id"), got '
                    f"{type(e).__name__}")
            if base_dir is not None and not os.path.isabs(spath):
                spath = os.path.join(base_dir, spath)
            sid = str(sid) if sid is not None else _default_id(spath)
            if sid in seen:
                raise PlanError(
                    f"cohort manifest sample id {sid!r} appears twice — "
                    f"ids key the [variants, samples] columns and must be "
                    f"unique")
            seen.add(sid)
            samples.append(CohortSample(sample_id=sid, path=spath))
        return cls(samples=samples, path=path)


def load_manifest(path: str) -> CohortManifest:
    """Read and resolve a manifest JSON file (PLAN class on anything
    malformed — a bad manifest is configuration, not data)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise            # already PLAN-classified by the taxonomy
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise PlanError(f"cohort manifest {path!r} is not valid JSON: {e}")
    return CohortManifest.from_doc(doc, base_dir=os.path.dirname(
        os.path.abspath(path)), path=path)


def as_manifest(source: Union[str, CohortManifest, Sequence[str]]
                ) -> CohortManifest:
    """Accept a manifest object, a manifest JSON path, or a bare list of
    sample file paths — every cohort entry point's first line."""
    if isinstance(source, CohortManifest):
        return source
    if isinstance(source, (str, os.PathLike)):
        return load_manifest(os.fspath(source))
    return CohortManifest.from_doc(list(source))
