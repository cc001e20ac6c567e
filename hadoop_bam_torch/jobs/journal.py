"""Durable job journal: append-only, fsync'd, checksummed JSONL (copy of
hadoop_bam_tpu/jobs/journal.py).

A long job (the mesh sort's spill rounds) records which durable
artifacts it finished, so a process killed mid-job resumes instead of
starting over:

- **append-only JSONL**: one JSON object a line, flushed and fsync'd
  after every record, so a committed line survives any process death;
- **checksummed lines**: each record carries a CRC32 of its canonical
  form, so replay tells a torn tail (a half-written last line: expected
  after SIGKILL, dropped) from a corrupted middle (``CorruptDataError``:
  resume refuses);
- **job identity**: the header records the inputs' identity digests
  (abspath, size, mtime_ns), a fingerprint of the output-affecting
  config fields and the job's parameters; resume checks all of them and
  refuses with ``PlanError`` on any mismatch;
- **unit records**: each finished unit (a spill sort's ``round``) with
  its artifacts' size and CRC32, verified, not trusted, on resume.

The journal never holds record data: replaying it is reading KBs of
JSON, and resuming is "verify the artifacts, skip their work".
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError
from hadoop_bam_torch.utils.metrics import METRICS

JOURNAL_SUFFIX = ".hbam-journal"
_VERSION = 1


def journal_path_for(output_path: str) -> str:
    """The default journal location for a job publishing ``output_path``:
    a sibling file, so it lands on the same (shared) filesystem as the
    artifacts it describes."""
    return output_path + JOURNAL_SUFFIX


# ---------------------------------------------------------------------------
# identity + digests
# ---------------------------------------------------------------------------

def file_identity_digest(path: str) -> str:
    """Digest of a file's (abspath, size, mtime_ns) identity — the same
    convention the query cache and cohort manifests key on.  Cheap (one
    stat), and exactly strong enough for the resume contract: a
    rewritten/touched input refuses to resume rather than silently
    merging old rounds with new bytes."""
    from hadoop_bam_torch.query.cache import file_identity

    ident = file_identity(path)
    return hashlib.sha256(repr(tuple(ident)).encode()).hexdigest()[:24]


def file_digest(path: str) -> Tuple[int, str]:
    """(size, crc32 hex) of a file's CONTENT — what unit verification
    uses for the artifacts themselves (spill runs, shard parts, chunk
    files, the published output).  Streamed, so verifying a resumed
    job's artifacts costs one read pass, never a decode."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(1 << 20)
            if not buf:
                break
            crc = zlib.crc32(buf, crc)
            size += len(buf)
    return size, f"{crc & 0xFFFFFFFF:08x}"


def verify_artifact(path: str, size: int, crc: str) -> bool:
    """True iff ``path`` exists with exactly the recorded size + CRC."""
    try:
        if os.path.getsize(path) != int(size):
            return False
    except OSError:
        return False
    got_size, got_crc = file_digest(path)
    return got_size == int(size) and got_crc == str(crc)


def plan_digest(spans) -> str:
    """Digest of a serialized span plan — resumes verify it so a changed
    splitting-index sidecar (which would re-cut spans under the recorded
    units) refuses instead of silently mis-joining.

    Span paths are canonicalized to abspath first: the killed run may
    have named its input relatively while ``jobs.resume_job`` re-plans from
    the journal's absolute params, and the digest must cover span
    GEOMETRY (cuts and offsets), not path spelling — same-file identity
    is already the header's job."""
    from hadoop_bam_torch.parallel.distributed import serialize_plan

    doc = json.loads(serialize_plan(spans, max_bytes=1 << 30).decode())
    for d in doc:
        if isinstance(d.get("path"), str):
            d["path"] = os.path.abspath(d["path"])
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def fingerprint_values(config, fields: Sequence[str]) -> Dict:
    """The named config fields as a JSON-able dict — both the
    fingerprint's input and (recorded in the journal header) what lets
    ``jobs.resume_job`` reconstruct the job's output-affecting config
    instead of refusing whenever the journaled run used non-default
    knobs."""
    vals = {}
    for f in sorted(fields):
        v = getattr(config, f, None)
        vals[f] = v if isinstance(v, (int, float, str, bool,
                                      type(None))) else repr(v)
    return vals


def config_fingerprint(config, fields: Sequence[str]) -> str:
    """Digest of the named config fields — the output-affecting subset a
    job's resume contract depends on.  Deliberately NOT the whole config:
    changing an observability knob must not strand a resumable journal,
    while changing the compression level must."""
    blob = json.dumps(fingerprint_values(config, fields),
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _line_crc(rec: Dict) -> str:
    blob = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    return f"{zlib.crc32(blob.encode()) & 0xFFFFFFFF:08x}"


# ---------------------------------------------------------------------------
# replayed state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JournalState:
    """What a replay reconstructs: the header, the completed units, the
    recorded events, and whether the job finished.  ``good_bytes`` is
    the byte length of the intact prefix — what a resume truncates to
    before appending, so new records never concatenate onto a torn
    final line (which would turn the next replay's 'expected crash
    shape' into mid-file corruption)."""

    header: Dict
    units: Dict[Tuple[str, str], Dict]
    events: List[Dict]
    done: Optional[Dict]
    torn_tail: bool
    lines: int
    good_bytes: int = 0

    def unit(self, kind: str, key) -> Optional[Dict]:
        return self.units.get((str(kind), str(key)))

    def last_event(self, name: str) -> Optional[Dict]:
        for rec in reversed(self.events):
            if rec.get("name") == name:
                return rec
        return None

    @property
    def kind(self) -> str:
        return str(self.header.get("kind", ""))


class JobJournal:
    """One job's append-only journal (module docstring).

    Writers hold the file open in append mode; every ``append`` is one
    ``write + flush + fsync`` so a record either fully exists on disk or
    was never acknowledged.  Records are small (unit metadata, never
    data), so the fsync cadence — once per completed UNIT, not per
    record of work — is what keeps journaling overhead under the bench
    row's <3% bar."""

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = bool(fsync)
        self._f = None
        self._seq = 0

    # -- writing -------------------------------------------------------------

    def _ensure_open(self):
        if self._f is None:
            self._f = open(self.path, "ab")
        return self._f

    def append(self, rec: Dict) -> None:
        rec = dict(rec)
        rec["seq"] = self._seq
        # every journal line carries the active trace id (obs/context),
        # so a resumed job's lines name the RESUMING trace, not the
        # original one
        if "trace" not in rec:
            from hadoop_bam_torch.obs.context import current_trace_id

            tid = current_trace_id()
            if tid is not None:
                rec["trace"] = tid
        rec["c"] = _line_crc(rec)
        line = json.dumps(rec, sort_keys=True,
                          separators=(",", ":")) + "\n"
        f = self._ensure_open()
        f.write(line.encode())
        f.flush()
        if self.fsync:
            os.fsync(f.fileno())
        self._seq += 1
        METRICS.count("jobs.journal_records")

    def start(self, kind: str, *, inputs: Sequence[Tuple[str, str]],
              output: Optional[str], fingerprint: str,
              params: Optional[Dict] = None,
              config_values: Optional[Dict] = None) -> None:
        """The header record — written exactly once, first.
        ``config_values`` (the fingerprinted field values) ride along
        so ``jobs.resume_job`` can reconstruct the job's output-affecting
        config; only the FINGERPRINT participates in matching."""
        rec = {
            "t": "job", "v": _VERSION, "kind": str(kind),
            "inputs": [[p, d] for p, d in inputs],
            "output": output, "fingerprint": str(fingerprint),
            "params": dict(params or {}),
        }
        if config_values is not None:
            rec["config"] = dict(config_values)
        self.append(rec)

    def unit_done(self, kind: str, key, **fields) -> None:
        """One unit of work committed: its durable artifact(s) exist and
        their size+CRC are recorded for verification on resume."""
        self.append({"t": "unit", "k": str(kind), "key": str(key),
                     **fields})

    def event(self, name: str, **fields) -> None:
        """A non-unit fact resume needs (bucket bounds, plan digest,
        quarantine, a resume itself)."""
        self.append({"t": "event", "name": str(name), **fields})

    def job_done(self, **fields) -> None:
        self.append({"t": "done", **fields})

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- replay --------------------------------------------------------------

    @classmethod
    def replay(cls, path: str) -> JournalState:
        """Reconstruct job state from a journal file.

        Tolerates exactly one torn record — the final line, the only one
        a crash can leave half-written under the append+fsync discipline.
        A checksum/parse failure anywhere BEFORE the final line means the
        file is not an honestly-crashed journal (bit rot, truncation in
        the middle, a concurrent writer) and raises ``CorruptDataError``:
        resuming from untrustworthy state is worse than restarting."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raise PlanError(f"no job journal at {path}") from None
        lines = raw.split(b"\n")
        if lines and lines[-1] == b"":
            lines.pop()
        header: Optional[Dict] = None
        units: Dict[Tuple[str, str], Dict] = {}
        events: List[Dict] = []
        done: Optional[Dict] = None
        torn = False
        seq = 0
        good_bytes = 0
        for i, line in enumerate(lines):
            rec = _parse_line(line)
            if rec is None:
                if i == len(lines) - 1:
                    torn = True          # the one expected failure mode
                    break
                raise CorruptDataError(
                    f"job journal {path}: line {i + 1} of {len(lines)} "
                    f"fails its checksum — mid-file corruption, refusing "
                    f"to reconstruct state from it")
            good_bytes += len(line) + 1          # line + its newline
            seq = int(rec.get("seq", seq)) + 1
            t = rec.get("t")
            if t == "job":
                if header is not None:
                    raise CorruptDataError(
                        f"job journal {path}: duplicate header at line "
                        f"{i + 1}")
                header = rec
            elif t == "unit":
                units[(str(rec.get("k")), str(rec.get("key")))] = rec
            elif t == "event":
                events.append(rec)
            elif t == "done":
                done = rec
        if header is None:
            raise CorruptDataError(
                f"job journal {path}: no (intact) header record")
        return JournalState(header=header, units=units, events=events,
                            done=done, torn_tail=torn, lines=len(lines),
                            good_bytes=good_bytes)

    @classmethod
    def resume(cls, path: str, *, kind: str,
               inputs: Sequence[Tuple[str, str]], output: Optional[str],
               fingerprint: str, params: Optional[Dict] = None,
               config_values: Optional[Dict] = None,
               fsync: bool = True
               ) -> Tuple["JobJournal", Optional[JournalState]]:
        """Open ``path`` for a job, resuming when a matching journal
        already exists.

        Returns ``(journal, state)``: ``state`` is None for a fresh job
        (the header was just written), or the replayed state of the
        prior attempt.  A journal for a DIFFERENT job — other kind,
        other inputs (by identity digest), other config fingerprint,
        other params — refuses with ``PlanError``: the caller asked to
        resume something that no longer exists."""
        if not os.path.exists(path):
            j = cls(path, fsync=fsync)
            j.start(kind, inputs=inputs, output=output,
                    fingerprint=fingerprint, params=params,
                    config_values=config_values)
            return j, None
        state = cls.replay(path)
        _check_header(path, state.header, kind=kind, inputs=inputs,
                      output=output, fingerprint=fingerprint,
                      params=params)
        if state.torn_tail:
            # appending onto the half-written final line would weld the
            # new record into one unparseable MID-file line, turning the
            # next replay's "honest crash" into refused corruption —
            # amputate the torn fragment before the first append
            with open(path, "r+b") as f:
                f.truncate(state.good_bytes)
        j = cls(path, fsync=fsync)
        j._seq = state.lines
        METRICS.count("jobs.resumes")
        j.event("resume", prior_units=len(state.units),
                torn_tail=bool(state.torn_tail))
        return j, state


def _parse_line(line: bytes) -> Optional[Dict]:
    """Decode + checksum one journal line; None on any failure (the
    caller decides whether that position tolerates it)."""
    if not line.strip():
        return None
    try:
        rec = json.loads(line.decode())
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(rec, dict):
        return None
    crc = rec.pop("c", None)
    if crc is None or _line_crc(rec) != crc:
        return None
    return rec


def _check_header(path: str, header: Dict, *, kind: str,
                  inputs: Sequence[Tuple[str, str]], output: Optional[str],
                  fingerprint: str, params: Optional[Dict]) -> None:
    def refuse(what: str, want, got) -> None:
        raise PlanError(
            f"refusing to resume {path}: {what} changed since the "
            f"journal was written (journal: {got!r}, now: {want!r}) — "
            f"delete the journal to start the job over")

    if str(header.get("kind")) != str(kind):
        refuse("job kind", kind, header.get("kind"))
    if str(header.get("fingerprint")) != str(fingerprint):
        refuse("config fingerprint (an output-affecting knob)",
               fingerprint, header.get("fingerprint"))
    want_inputs = [[p, d] for p, d in inputs]
    if list(header.get("inputs", [])) != want_inputs:
        refuse("input file identity", want_inputs, header.get("inputs"))
    if header.get("output") != output:
        refuse("output path", output, header.get("output"))
    want_params = dict(params or {})
    if dict(header.get("params", {})) != want_params:
        refuse("job parameters", want_params, header.get("params"))


def sweep_unrecorded(directory: str, recorded: Sequence[str],
                     counter: str = "jobs.stale_artifacts_swept") -> int:
    """Delete files in ``directory`` that no journal unit claims — the
    partial artifacts of the unit that was in flight when the process
    died.  Returns the number removed."""
    keep = {os.path.abspath(p) for p in recorded}
    swept = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for name in names:
        p = os.path.join(directory, name)
        if os.path.abspath(p) in keep or not os.path.isfile(p):
            continue
        try:
            os.unlink(p)
            swept += 1
        except OSError:
            pass
    if swept:
        METRICS.count(counter, swept)
    return swept
