"""The port's crash-safe sort jobs, on the CPU: the four sort-journal
cases of tests/test_jobs.py run on the port's ``sort_bam_mesh`` (a child
process SIGKILLs itself after its Nth committed round, the parent
resumes from the journal), each output byte-identical to the reference's
``sort_bam``; the journal's core semantics against the reference's, and
``resume_job``.
"""
import dataclasses
import os
import random
import signal
import subprocess
import sys
import tempfile
import textwrap

import pytest

from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.jobs import JobJournal as JJournal
from hadoop_bam_tpu.utils.sort import sort_bam as jsort_bam
from hadoop_bam_torch.config import DEFAULT_CONFIG
from hadoop_bam_torch.jobs import (
    JobJournal, file_identity_digest, journal_path_for, resume_job,
)
from hadoop_bam_torch.parallel.mesh_sort import sort_bam_mesh
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError
from hadoop_bam_torch.utils.metrics import MetricsContext

from fixtures import make_header, make_records

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
NOSYNC = dataclasses.replace(DEFAULT_CONFIG, journal_fsync=False)

_SORT_CHILD = """
    import os, signal, sys
    from hadoop_bam_torch.jobs import JobJournal
    kill_after, src, out, jp, rr = (int(sys.argv[1]), sys.argv[2],
                                    sys.argv[3], sys.argv[4],
                                    int(sys.argv[5]))
    orig = JobJournal.unit_done
    n = [0]
    def patched(self, kind, key, **kw):
        orig(self, kind, key, **kw)
        if kind == "round":
            n[0] += 1
            if n[0] >= kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
    JobJournal.unit_done = patched
    import dataclasses
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.parallel.mesh_sort import sort_bam_mesh
    cfg = dataclasses.replace(DEFAULT_CONFIG, journal_fsync=False)
    sort_bam_mesh(src, out, device="cpu", round_records=rr,
                  journal_path=jp, config=cfg)
    raise SystemExit("unreachable: child must have been killed")
"""


def _run_child(*args):
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(textwrap.dedent(_SORT_CHILD))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        return subprocess.run([sys.executable, f.name, *map(str, args)],
                              env=env, timeout=180, capture_output=True,
                              text=True)
    finally:
        os.unlink(f.name)


@pytest.fixture(scope="module")
def sort_fixture(tmp_path_factory):
    """A shuffled BAM and the reference sort's bytes (the uninterrupted
    oracle)."""
    d = tmp_path_factory.mktemp("tjobs_sort")
    header = make_header()
    recs = list(make_records(header, 700, seed=11))
    random.Random(5).shuffle(recs)
    src = str(d / "in.bam")
    with BamWriter(src, header) as w:
        for rec in recs:
            w.write_sam_record(rec)
    oracle = str(d / "oracle.bam")
    n = jsort_bam(src, oracle)
    return {"src": src, "oracle_bytes": open(oracle, "rb").read(),
            "records": n, "round_records": 30}


@pytest.mark.parametrize("kill_after", [1, 2])
def test_sigkill_mid_mesh_sort_resumes_byte_identical(tmp_path,
                                                      sort_fixture,
                                                      kill_after):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    r = _run_child(kill_after, sort_fixture["src"], out, jp,
                   sort_fixture["round_records"])
    assert r.returncode == -signal.SIGKILL, (r.returncode,
                                             r.stderr[-2000:])
    st = JobJournal.replay(jp)
    assert len([u for (k, _), u in st.units.items()
                if k == "round"]) == kill_after
    assert os.path.isdir(out + ".mesh-spill")   # survived the kill
    with MetricsContext() as m:
        n = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                          round_records=sort_fixture["round_records"],
                          journal_path=jp, config=NOSYNC)
    snap = m.snapshot()
    assert n == sort_fixture["records"]
    assert open(out, "rb").read() == sort_fixture["oracle_bytes"]
    assert snap["counters"].get("jobs.rounds_skipped") == kill_after
    assert snap["counters"].get("jobs.spans_skipped", 0) > 0
    ev = JobJournal.replay(jp).last_event("resume_plan")
    assert ev["rounds_skipped"] == kill_after
    assert ev["spans_skipped"] > 0
    assert not os.path.isdir(out + ".mesh-spill")  # cleaned on success


def test_sort_journal_torn_tail_resumes(tmp_path, sort_fixture):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    r = _run_child(2, sort_fixture["src"], out, jp,
                   sort_fixture["round_records"])
    assert r.returncode == -signal.SIGKILL
    raw = open(jp, "rb").read()
    open(jp, "wb").write(raw[:-11])        # tear the final unit record
    assert JobJournal.replay(jp).torn_tail
    with MetricsContext() as m:
        n = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                          round_records=sort_fixture["round_records"],
                          journal_path=jp, config=NOSYNC)
    assert n == sort_fixture["records"]
    assert open(out, "rb").read() == sort_fixture["oracle_bytes"]
    assert m.snapshot()["counters"].get("jobs.rounds_skipped") == 1


def test_sort_resume_refuses_config_fingerprint_mismatch(tmp_path,
                                                         sort_fixture):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    r = _run_child(1, sort_fixture["src"], out, jp,
                   sort_fixture["round_records"])
    assert r.returncode == -signal.SIGKILL
    cfg = dataclasses.replace(NOSYNC, write_compress_level=1)
    with pytest.raises(PlanError, match="fingerprint"):
        sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                      round_records=sort_fixture["round_records"],
                      journal_path=jp, config=cfg)
    with pytest.raises(PlanError, match="parameters"):
        sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                      round_records=29, journal_path=jp, config=NOSYNC)


def test_completed_sort_job_is_verified_noop(tmp_path, sort_fixture):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    n1 = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                       round_records=sort_fixture["round_records"],
                       journal_path=jp, config=NOSYNC)
    mtime = os.stat(out).st_mtime_ns
    with MetricsContext() as m:
        n2 = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                           round_records=sort_fixture["round_records"],
                           journal_path=jp, config=NOSYNC)
    assert (n1, n2) == (sort_fixture["records"],) * 2
    assert m.snapshot()["counters"].get("jobs.jobs_skipped") == 1
    assert os.stat(out).st_mtime_ns == mtime    # untouched
    # a vanished output rebuilds from the journal's done record
    os.unlink(out)
    n3 = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                       round_records=sort_fixture["round_records"],
                       journal_path=jp, config=NOSYNC)
    assert n3 == n1
    assert open(out, "rb").read() == sort_fixture["oracle_bytes"]


@pytest.mark.parametrize("exchange", ["index", "bytes"])
def test_resident_sort_job_level_idempotence(tmp_path, sort_fixture,
                                             exchange):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    n = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                      exchange=exchange, journal_path=jp, config=NOSYNC)
    assert open(out, "rb").read() == sort_fixture["oracle_bytes"]
    with MetricsContext() as m:
        assert sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                             exchange=exchange, journal_path=jp,
                             config=NOSYNC) == n
    assert m.snapshot()["counters"].get("jobs.jobs_skipped") == 1
    assert JobJournal.replay(jp).kind == "mesh_sort"


def test_resume_job_reconstructs_nondefault_config(tmp_path, sort_fixture):
    cfg = dataclasses.replace(NOSYNC, write_compress_level=1)
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    n1 = sort_bam_mesh(sort_fixture["src"], out, device="cpu",
                       round_records=sort_fixture["round_records"],
                       journal_path=jp, config=cfg)
    want = open(out, "rb").read()
    assert want != sort_fixture["oracle_bytes"]    # level 1 != level 6
    os.unlink(out)                                 # force a rebuild
    got = resume_job(jp, config=NOSYNC, device="cpu")
    assert got == {"kind": "mesh_sort_spill", "output": out, "records": n1}
    assert open(out, "rb").read() == want


@pytest.mark.parametrize("kind", ["mkdup", "cohort_join", "other"])
def test_resume_job_refuses_kinds_the_port_lacks(tmp_path, kind):
    """Unknown kinds are refused; a mkdup or cohort_join journal (kinds
    the port resumes, ``test_torch_prep.py`` and
    ``test_torch_cohort.py``) is refused when its params are not a
    duplicate-marking run's or a manifest-file join's."""
    jp, inputs, hdr = _mini_job(tmp_path, kind=kind)
    j, _ = JobJournal.resume(jp, inputs=inputs, **hdr)
    j.close()
    with pytest.raises(PlanError, match=kind):
        resume_job(jp, device="cpu")


# ---------------------------------------------------------------------------
# journal core semantics, against the reference's journal
# ---------------------------------------------------------------------------

def _mini_job(tmp_path, fingerprint="fp", params=None, kind="k"):
    inp = tmp_path / "in.dat"
    inp.write_bytes(b"x" * 1000)
    jp = str(tmp_path / "j.hbam-journal")
    return jp, [(str(inp), file_identity_digest(str(inp)))], {
        "kind": kind, "output": str(tmp_path / "out.dat"),
        "fingerprint": fingerprint, "params": params or {"a": 1}}


def test_journal_lines_and_replay_equal_the_reference(tmp_path):
    from hadoop_bam_tpu.jobs import file_identity_digest as jdigest
    jp, inputs, hdr = _mini_job(tmp_path)
    assert inputs[0][1] == jdigest(inputs[0][0])
    j, st = JobJournal.resume(jp, inputs=inputs, fsync=False, **hdr)
    assert st is None
    j.event("bounds", bhi=[7], blo=[9])
    j.unit_done("round", 0, runs=[["a", "b", 1, "0abc"]], round_total=5)
    j.unit_done("round", 1, runs=[], round_total=3)
    j.job_done(records=8, size=1, crc="00000000")
    j.close()
    mine = open(jp, "rb").read()
    jp2 = str(tmp_path / "ref.hbam-journal")
    k, _ = JJournal.resume(jp2, inputs=inputs, fsync=False, **hdr)
    k.event("bounds", bhi=[7], blo=[9])
    k.unit_done("round", 0, runs=[["a", "b", 1, "0abc"]], round_total=5)
    k.unit_done("round", 1, runs=[], round_total=3)
    k.job_done(records=8, size=1, crc="00000000")
    k.close()
    assert mine == open(jp2, "rb").read()
    for replay in (JobJournal.replay, JJournal.replay):
        st = replay(jp)
        assert st.kind == "k" and st.done["records"] == 8
        assert st.unit("round", 1)["round_total"] == 3
        assert st.last_event("bounds")["bhi"] == [7]
    j2, st2 = JobJournal.resume(jp, inputs=inputs, fsync=False, **hdr)
    assert st2 is not None and len(st2.units) == 2
    j2.close()
    assert JobJournal.replay(jp).last_event("resume") is not None


def test_journal_torn_tail_tolerated_mid_corruption_refused(tmp_path):
    jp, inputs, hdr = _mini_job(tmp_path)
    j, _ = JobJournal.resume(jp, inputs=inputs, fsync=False, **hdr)
    j.unit_done("round", 0, round_total=1)
    j.unit_done("round", 1, round_total=2)
    j.close()
    raw = open(jp, "rb").read()
    open(jp, "wb").write(raw[:-9])
    st = JobJournal.replay(jp)
    assert st.torn_tail and st.unit("round", 0) is not None \
        and st.unit("round", 1) is None
    lines = raw.split(b"\n")
    lines[1] = lines[1].replace(b"round_total", b"round_tXtal")
    open(jp, "wb").write(b"\n".join(lines))
    with pytest.raises(CorruptDataError):
        JobJournal.replay(jp)
    with pytest.raises(PlanError):
        JobJournal.replay(str(tmp_path / "absent.hbam-journal"))
    open(jp, "wb").write(raw)
    with pytest.raises(PlanError, match="job kind"):
        JobJournal.resume(jp, inputs=inputs, fsync=False,
                          **dict(hdr, kind="other"))
