"""The port's duplicate marking against the JAX package's, on the CPU:
the oracle and the pipeline byte-identical to the reference's
``markdup_bam_oracle`` on tests/test_prep.py's fuzz corpus for every
option pair and several round sizes; K16a's plain version equal to the
reference's ``markdup_columns`` (the corpus's rows and
``synth.MARKDUP_CASES``'s wrap cases); the fused step equal to the
reference's on a one-device mesh; K16b's hash, bucket and sorted (index,
duplicate bit) equal to the reference's exchange at 8 devices; error
classes; SIGKILL after each journal grain in a child that imports no
JAX, resumed byte-identically; a finished job a verified no-op; a cold
query served by the co-written ``.bai``; ``resume_job`` on a mkdup
journal; and ``synth.write_markdup_bam``'s truth against the oracle.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.prep import markdup as jmd
from hadoop_bam_tpu.prep import markdup_bam_oracle as jmarkdup_oracle
from hadoop_bam_torch import synth
from hadoop_bam_torch.config import DEFAULT_CONFIG
from hadoop_bam_torch.jobs import JobJournal, journal_path_for, resume_job
from hadoop_bam_torch.parallel import mesh_sort as ms
from hadoop_bam_torch.prep import markdup as md
from hadoop_bam_torch.prep import markdup_bam_mesh, markdup_bam_oracle
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError
from hadoop_bam_torch.utils.metrics import MetricsContext

from test_prep import fuzz_header, make_fuzz_records

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
NOSYNC = dataclasses.replace(DEFAULT_CONFIG, journal_fsync=False)
PAIRS = [(False, "none"), (False, "rg"), (True, "none"), (True, "rg")]


@pytest.fixture(scope="module")
def prep_fixture(tmp_path_factory):
    """test_prep.py's 400-record fuzz BAM and the reference oracle's
    bytes for every option pair."""
    d = tmp_path_factory.mktemp("tprep")
    header = fuzz_header()
    src = str(d / "in.bam")
    with BamWriter(src, header) as w:
        for r in make_fuzz_records(header, 400, seed=7):
            w.write_sam_record(r)
    oracle = {}
    for rm, lf in PAIRS:
        out = str(d / f"oracle_{int(rm)}_{lf}.bam")
        n = jmarkdup_oracle(src, out, config=DEFAULT_CONFIG,
                            remove_duplicates=rm, library_from=lf)
        oracle[(rm, lf)] = {"path": out, "bytes": open(out, "rb").read(),
                            "records": n}
    return {"dir": d, "src": src, "n_input": 400, "oracle": oracle}


# ---------------------------------------------------------------------------
# the oracle and the pipeline against the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rm,lf", PAIRS)
def test_oracle_equals_the_reference(tmp_path, prep_fixture, rm, lf):
    out = str(tmp_path / "o.bam")
    want = prep_fixture["oracle"][(rm, lf)]
    assert markdup_bam_oracle(prep_fixture["src"], out,
                              remove_duplicates=rm,
                              library_from=lf) == want["records"]
    assert open(out, "rb").read() == want["bytes"]
    assert os.path.exists(out + ".bai")


@pytest.mark.parametrize("rr", [47, 150, 1000])
@pytest.mark.parametrize("rm,lf", PAIRS)
def test_pipeline_equals_the_reference_oracle(tmp_path, prep_fixture, rm,
                                              lf, rr):
    """Byte identity for each option pair at round sizes that cut the
    400 records into 9, 3 and 1 rounds: ties break on the global index
    whatever the rounds."""
    out = str(tmp_path / "m.bam")
    before = md.fused_sort_markdup_step.launches
    n = markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                         remove_duplicates=rm, library_from=lf,
                         round_records=rr)
    want = prep_fixture["oracle"][(rm, lf)]
    assert n == want["records"]
    assert open(out, "rb").read() == want["bytes"]
    assert not os.path.isdir(out + ".mkdup-spill")
    assert md.fused_sort_markdup_step.launches - before == -(-400 // rr)


def test_corpus_marks_and_removes_duplicates(prep_fixture):
    """The corpus exercises the policy: duplicates marked, removed, never
    on an ineligible record, and the libraries group differently."""
    from hadoop_bam_torch.parallel.pipeline import map_file_spans

    def flags(path):
        out = []
        for data, offs in map_file_spans(path, lambda d, o, v: (d, o)):
            b = offs.astype(np.int64)
            out.append(data[b[:, None] + np.arange(18, 20)].copy()
                       .view("<u2").ravel())
        return np.concatenate(out).astype(np.int64)

    marked = flags(prep_fixture["oracle"][(False, "none")]["path"])
    n_dup = int(((marked & 0x400) != 0).sum())
    assert n_dup > 0
    assert prep_fixture["oracle"][(True, "none")]["records"] == 400 - n_dup
    assert not ((marked & 0x400) & ((marked & 0x904) != 0)).any()
    assert not (flags(prep_fixture["oracle"][(True, "none")]["path"])
                & 0x400).any()
    assert prep_fixture["oracle"][(False, "rg")]["bytes"] != \
        prep_fixture["oracle"][(False, "none")]["bytes"]


def test_markdup_needs_a_card_unless_told(prep_fixture, tmp_path,
                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        markdup_bam_mesh(prep_fixture["src"], str(tmp_path / "o.bam"))


def test_synthetic_markdup_truth_equals_the_oracles(tmp_path):
    """``synth.write_markdup_bam``'s truth (from its own arrays) equals
    the flags both packages' oracles write, in both library modes, and
    the pipeline over two rounds equals the port's oracle."""
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    src = str(tmp_path / "md.bam")
    truth = synth.write_markdup_bam(src, 6_000, 11)
    assert truth.n_reads == 6_000 and truth.copy_pairs > 200
    for lf in ("none", "rg"):
        want = truth.output_flags(lf)
        assert (want & 0x400).any()
        outs = []
        for oracle in (markdup_bam_oracle, jmarkdup_oracle):
            out = str(tmp_path / f"{oracle.__module__}_{lf}.bam")
            outs.append(out)
            assert oracle(src, out, library_from=lf) == 6_000
            got = np.concatenate([
                d[o.astype(np.int64)[:, None] + np.arange(18, 20)].copy()
                .view("<u2").ravel()
                for d, o in map_file_spans(out, lambda d, o, v: (d, o))])
            assert np.array_equal(got.astype(np.int64), want)
        mesh = str(tmp_path / f"mesh_{lf}.bam")
        markdup_bam_mesh(src, mesh, device="cpu", round_records=3_000,
                         library_from=lf)
        assert open(mesh, "rb").read() == open(outs[0], "rb").read()
    assert int(truth.dup["rg"].sum()) < int(truth.dup["none"].sum())


# ---------------------------------------------------------------------------
# K16a: the columns' plain version against the reference's formulas
# ---------------------------------------------------------------------------

def _jax_columns(rows, valid, lib, kmax):
    import jax.numpy as jnp
    out = jmd.markdup_columns(jnp.asarray(rows), None, jnp.asarray(valid),
                              jnp.asarray(lib), kmax, rows.shape[1])
    cols = np.stack([np.asarray(c).astype(np.uint32) for c in out[:6]])
    return cols, np.asarray(out[6]).astype(np.uint8)


def _check_columns(rows, lib, count, kmax):
    valid = np.arange(rows.shape[0]) < count
    want_cols, want_elig = _jax_columns(rows, valid, lib, kmax)
    got_cols, got_elig = md.markdup_columns_plain(
        torch.from_numpy(rows), torch.from_numpy(valid),
        torch.from_numpy(lib), kmax)
    assert got_cols.dtype == torch.uint32 and got_elig.dtype == torch.uint8
    assert np.array_equal(got_cols.numpy(), want_cols)
    assert np.array_equal(got_elig.numpy(), want_elig)
    # the wrapper on a CPU tensor takes the plain version
    w_cols, w_elig = md.markdup_columns(torch.from_numpy(rows), count,
                                        torch.from_numpy(lib), kmax)
    assert np.array_equal(w_cols.numpy(), want_cols)
    assert np.array_equal(w_elig.numpy(), want_elig)
    return got_cols.numpy(), got_elig.numpy()


@pytest.mark.parametrize("rr", [150, 1000])
def test_k16a_plain_equals_the_reference_on_the_corpus(prep_fixture, rr):
    """The corpus's rows as a round packs them, with a library column of
    every mode."""
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    parts = map_file_spans(prep_fixture["src"], lambda d, o, v: (d, o))
    data = np.concatenate([d for d, _ in parts])
    sizes = np.cumsum([0] + [d.size for d, _ in parts])
    offs = np.concatenate([o + s for (_, o), s in zip(parts, sizes)])
    lens = ms._record_lens(data, offs)
    for a in range(0, offs.size, rr):
        o = offs[a:a + rr]
        R = ms._round_up(o.size, 8)
        rows, _ = ms.pack_rows(torch.from_numpy(data), o, lens[a:a + rr], R,
                               256)
        lib = np.random.default_rng(a).integers(0, 3, R).astype(np.uint32)
        kmax = md.host_kmax(data, o)
        assert kmax == jmd.host_kmax(data, o)
        kpow = 1 << (kmax - 1).bit_length()
        cols, elig = _check_columns(rows.numpy(), lib, o.size, kpow)
        assert elig.any() and not elig[o.size:].any()


@pytest.mark.parametrize("kmax", ["rows", 2, 0])
@pytest.mark.parametrize("seed", [0, 1])
def test_k16a_plain_equals_the_reference_on_the_wrap_cases(seed, kmax):
    """``synth.MARKDUP_CASES``: clips on either end, all-clip, no CIGAR,
    D/N/I/=/X/P, strands, mate unmapped, secondary and supplementary,
    0xFF and 14/15/16 qualities, a clipped read at pos 0 (k1 wraps), the
    unmapped sentinel, pos at the int32 edge, libraries past 2^29,
    quality runs past the row, negative and 2^31 - 1 l_seq, a CIGAR past
    its row and one past the tile; random pad rows."""
    rows, lib, count, names = synth.markdup_rows(seed=seed)
    k = synth.rows_kmax(rows) if kmax == "rows" else kmax
    cols, elig = _check_columns(rows, lib, count, k)
    by = dict(zip(names, range(count)))
    if kmax == "rows":
        # what the cases are for (k1 is the unclipped 5' end + 1)
        assert cols[1, by["pos 0, 5S"]] == (1 - 5) & 0xFFFFFFFF
        assert cols[1, by["forward 5S146M"]] == 10_001
        assert cols[1, by["reverse 146M5S"]] == 10_300 + 146 - 1 + 5 + 1
        assert cols[1, by["all clip 10S5H"]] == 5_000 - 15 + 1
        assert cols[5, by["0xFF qualities"]] == 151 * 255
        assert cols[2, by["library 2^32 - 1"]] >> 3 == (1 << 29) - 1
    for name in ("secondary", "supplementary", "unmapped at its mate",
                 "unmapped sentinel"):
        assert not elig[by[name]]
    assert elig[by["duplicate flag set"]] and elig[by["mate unmapped"]]


@pytest.mark.parametrize("kmax", ["rows", 2, 0])
@pytest.mark.parametrize("case", [n for n, _ in synth.MARKDUP_TILES])
def test_k16a_plain_equals_the_reference_on_the_tiles(case, kmax):
    """``synth.MARKDUP_TILES``: quality runs of 400-600 bases at stride
    1024 (past the kernel's staged bytes), names of 30-40 bytes (runs
    ending past byte 288), R = 1, R = 7 (under a warp), R = 1,031 at
    stride 128 (not a multiple of a CTA's batch); clips at either end,
    both strands, random pads."""
    rows, lib, count = synth.markdup_tile(seed=3,
                                          **dict(synth.MARKDUP_TILES)[case])
    k = synth.rows_kmax(rows) if kmax == "rows" else kmax
    cols, elig = _check_columns(rows, lib, count, k)
    assert not elig[count:].any()
    if case == "30-40-byte names":
        lrn = rows[:count, 12]
        assert lrn.min() >= 30 and lrn.max() <= 40
    if case.startswith("reads of"):
        b = rows[:count]
        assert (b[:, 20:24].copy().view("<i4").ravel() >= 400).all()
        # the quality runs lie in their rows
        assert (cols[5, :count] > 0).all()


def test_k16a_argument_checks():
    rows, lib, count, _ = synth.markdup_rows()
    with pytest.raises(ValueError, match="uint32"):
        md.markdup_columns(torch.from_numpy(rows), count,
                           torch.from_numpy(lib.astype(np.int64)), 4)
    with pytest.raises(ValueError, match="stride"):
        md.markdup_columns(torch.from_numpy(rows[:, :40].copy()), count,
                           torch.from_numpy(lib), 4)
    with pytest.raises(ValueError, match="uint8"):
        md.markdup_columns(torch.from_numpy(rows.astype(np.int16)), count,
                           torch.from_numpy(lib), 4)


def _one_device_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def test_fused_step_equals_the_reference_on_one_device(prep_fixture):
    """The fused sort + columns step over the whole corpus as one round:
    sorted rows, lengths, indices and every column equal to the
    reference's step on a one-device mesh."""
    import jax.numpy as jnp
    from hadoop_bam_tpu.parallel import mesh_sort as jms
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    ((data, offs),) = map_file_spans(prep_fixture["src"],
                                     lambda d, o, v: (d, o))
    n = offs.size
    lens = ms._record_lens(data, offs)
    R, stride = ms._round_up(n, 1024), 256
    rows_np, lens_np = jms._pack_record_rows(data, offs, lens, R, stride)
    lib = np.random.default_rng(5).integers(0, 4, R).astype(np.uint32)
    kmax = md.host_kmax(data, offs)
    step = jmd._make_fused_sort_markdup_step(_one_device_mesh(), R, stride,
                                             kmax)
    empty = jnp.zeros(0, jnp.uint32)
    want = [np.asarray(x)[0] for x in step(
        rows_np[None], lens_np[None], np.asarray([n], np.int32),
        np.asarray([9], np.int32), lib[None], empty, empty)]
    (g_rows, g_lens, g_six), (cols, elig) = md.fused_sort_markdup_step(
        torch.from_numpy(rows_np), torch.from_numpy(lens_np), n, 9,
        torch.from_numpy(lib), torch.zeros(0, dtype=torch.int64),
        torch.zeros(0, dtype=torch.int64), kmax)
    assert np.array_equal(g_rows.numpy(), want[0])
    assert np.array_equal(g_lens.numpy(), want[1])
    assert np.array_equal(g_six.numpy(), want[2])
    assert np.array_equal(cols.numpy(), np.stack(want[3:9]))
    assert np.array_equal(elig.numpy(), want[9])


# ---------------------------------------------------------------------------
# K16b: the signature exchange against the reference's at 8 devices
# ---------------------------------------------------------------------------

def _signature_columns(seed, m):
    """Signature columns with many collisions and every key at its
    extremes, uint32."""
    rng = np.random.default_rng(seed)
    pick = np.array([0, 1, 2, 7, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                    np.uint64)
    cols = [pick[rng.integers(0, 3 if k < 5 else 8, m)].astype(np.uint32)
            for k in range(6)]
    cols[1] = rng.choice(pick, m).astype(np.uint32)
    cols[5] = rng.choice(np.array([0, 15, 255, 38505, 2**32 - 1], np.uint64),
                         m).astype(np.uint32)
    return cols


def test_k16b_hash_and_bucket_equal_the_reference_formula():
    import jax.numpy as jnp
    cols = _signature_columns(3, 4096)
    h = jnp.asarray(cols[0])
    for k in cols[1:5]:
        h = (h ^ jnp.asarray(k)) * jnp.uint32(0x9E3779B1)
    got = md.signature_hash(*(torch.from_numpy(c) for c in cols[:5]))
    assert np.array_equal(got.numpy(), np.asarray(h).astype(np.int64))
    valid = torch.arange(4096) < 3000
    for n_dev in (1, 3, 8):
        want = np.where(valid.numpy(),
                        np.asarray(h % jnp.uint32(n_dev)).astype(np.int64), 0)
        assert np.array_equal(md.signature_bucket(got, valid, n_dev).numpy(),
                              want)


@pytest.mark.parametrize("seed,m", [(0, 400), (1, 3000), (2, 8), (3, 0)])
def test_k16b_exchange_equals_the_reference_at_8_devices(seed, m):
    """Columns sliced over 8 source devices as stage 2 slices them; the
    port's send matrices routed as the all_to_all routes them and its
    receive-side sort give each device the reference's (index, bit)
    rows, pads included."""
    from hadoop_bam_tpu.parallel.mesh import make_mesh
    n_dev, cap = 8, 512
    cols = _signature_columns(seed, m)
    gidx = np.sort(np.random.default_rng(seed).choice(
        10 * max(m, 1), m, replace=False)).astype(np.int32)
    n_per = -(-m // n_dev) if m else 0

    def sliced(a, dtype):
        out = np.zeros((n_dev, cap), dtype)
        for d in range(n_dev):
            part = a[d * n_per:min((d + 1) * n_per, m)]
            out[d, :part.size] = part
        return out

    counts = np.asarray([max(0, min(n_per, m - d * n_per))
                         for d in range(n_dev)], np.int32)
    args = [sliced(c, np.uint32) for c in cols] + [sliced(gidx, np.int32)]
    step = jmd._make_markdup_exchange_step(make_mesh((n_dev,)), cap)
    w_six, w_dup = (np.asarray(x) for x in step(*args, counts))
    sends = [md.exchange_sends(*(torch.from_numpy(a[d]) for a in args),
                               int(counts[d]), n_dev) for d in range(n_dev)]
    for b in range(n_dev):
        keys = [torch.cat([s[0][k][b] for s in sends]) for k in range(6)]
        six = torch.cat([s[1][b] for s in sends])
        g_six, g_dup = md.duplicate_bits(keys, six)
        assert np.array_equal(g_six.numpy(), w_six[b])
        assert np.array_equal(g_dup.numpy(), w_dup[b])
    if m == 400:
        assert w_dup.sum() > 0


def test_k16b_one_device_step_marks_like_the_oracle_rule():
    """The one-device step against a direct evaluation of the rule (the
    best score wins, ties to the lowest index)."""
    m = 5000
    cols = _signature_columns(7, m)
    gidx = (np.arange(m) * 3 + 11).astype(np.int32)
    before = md.markdup_exchange_step.launches
    six, dup = md.markdup_exchange_step(
        *(torch.from_numpy(c) for c in cols), torch.from_numpy(gidx), m)
    assert md.markdup_exchange_step.launches == before + 1
    got = np.zeros(10 * m + 20, np.uint8)
    got[six.numpy()[dup.numpy() == 1]] = 1
    want = np.zeros_like(got)
    groups = {}
    for i in range(m):
        groups.setdefault(tuple(int(c[i]) for c in cols[:5]), []).append(i)
    for members in groups.values():
        best = min(members, key=lambda i: (-int(cols[5][i]), gidx[i]))
        for i in members:
            if i != best:
                want[gidx[i]] = 1
    assert np.array_equal(got, want)
    assert (six.numpy()[m:] == ms._I32_SENTINEL).all()


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def test_byte_flip_same_error_class_both_paths(tmp_path, prep_fixture):
    raw = bytearray(open(prep_fixture["src"], "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = str(tmp_path / "bad.bam")
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    from hadoop_bam_tpu.utils.errors import CorruptDataError as JCorrupt
    with pytest.raises(JCorrupt):
        jmarkdup_oracle(bad, str(tmp_path / "j.bam"))
    with pytest.raises(CorruptDataError):
        markdup_bam_oracle(bad, str(tmp_path / "o.bam"))
    with pytest.raises(CorruptDataError):
        markdup_bam_mesh(bad, str(tmp_path / "m.bam"), device="cpu")
    assert not os.path.exists(tmp_path / "m.bam.mkdup-spill")


def test_misconfiguration_is_plan_error(tmp_path, prep_fixture):
    src = prep_fixture["src"]
    with pytest.raises(PlanError):
        markdup_bam_oracle(src, str(tmp_path / "o.bam"), library_from="lb")
    with pytest.raises(PlanError):
        markdup_bam_mesh(src, str(tmp_path / "m.bam"), device="cpu",
                         library_from="lb")
    with pytest.raises(PlanError):
        markdup_bam_mesh(src, str(tmp_path / "m.bam"), device="cpu",
                         round_records=0)


def test_spill_dir_kept_only_when_asked(tmp_path, prep_fixture,
                                        monkeypatch):
    from hadoop_bam_torch.prep import pipeline as pp
    out = str(tmp_path / "o.bam")

    def boom(*a, **kw):
        raise RuntimeError("injected write failure")
    monkeypatch.setattr(pp, "_write_stage", boom)
    with pytest.raises(RuntimeError, match="injected"):
        markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                         round_records=150)
    assert not os.path.exists(out + ".mkdup-spill")
    assert not os.path.exists(out)
    cfg = dataclasses.replace(DEFAULT_CONFIG, debug_keep_spill=True)
    with pytest.raises(RuntimeError, match="injected"):
        markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                         round_records=150, config=cfg)
    assert os.path.isdir(out + ".mkdup-spill")


# ---------------------------------------------------------------------------
# SIGKILL after each journal grain, then resume
# ---------------------------------------------------------------------------

_MKDUP_CHILD = """
    import os, signal, sys
    from hadoop_bam_torch.jobs import JobJournal
    kill_kind, kill_after = sys.argv[1], int(sys.argv[2])
    src, out, jp, rr = sys.argv[3], sys.argv[4], sys.argv[5], int(sys.argv[6])
    orig = JobJournal.unit_done
    n = [0]
    def patched(self, kind, key, **kw):
        orig(self, kind, key, **kw)
        if kind == kill_kind:
            n[0] += 1
            if n[0] >= kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
    JobJournal.unit_done = patched
    import dataclasses
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.prep import markdup_bam_mesh
    assert "jax" not in sys.modules
    cfg = dataclasses.replace(DEFAULT_CONFIG, journal_fsync=False)
    markdup_bam_mesh(src, out, device="cpu", round_records=rr,
                     journal_path=jp, config=cfg)
    raise SystemExit("unreachable: the child must have been killed")
"""


def _run_child(*args):
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(textwrap.dedent(_MKDUP_CHILD))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        return subprocess.run([sys.executable, f.name, *map(str, args)],
                              env=env, timeout=240, capture_output=True,
                              text=True)
    finally:
        os.unlink(f.name)


# 400 records at 100 a round plan 4 rounds: a kill after round 2 leaves
# rounds on both sides; at one device the write stage's one unit is the
# published output, so a kill after it leaves only the job's end to record
@pytest.mark.parametrize("kill_kind,kill_after", [
    ("round", 2), ("markdup", 1), ("shard", 1)])
def test_sigkill_each_stage_resumes_byte_identical(
        tmp_path, prep_fixture, kill_kind, kill_after):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    rr = 100
    r = _run_child(kill_kind, kill_after, prep_fixture["src"], out, jp, rr)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    st = JobJournal.replay(jp)
    committed = {k: len([u for (kk, _), u in st.units.items() if kk == k])
                 for k in ("round", "markdup", "shard")}
    assert committed[kill_kind] == kill_after
    if kill_kind == "round":
        assert committed["round"] < 4
    assert os.path.isdir(out + ".mkdup-spill")     # survived the kill
    want = prep_fixture["oracle"][(False, "none")]
    if kill_kind == "shard":
        assert open(out, "rb").read() == want["bytes"]
        assert st.done is None
        mtime = os.stat(out).st_mtime_ns
    else:
        assert not os.path.exists(out)
    with MetricsContext() as m:
        n = markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                             round_records=rr, journal_path=jp,
                             config=NOSYNC)
    c = m.snapshot()["counters"]
    assert n == want["records"]
    assert open(out, "rb").read() == want["bytes"]
    if kill_kind == "shard":
        assert os.stat(out).st_mtime_ns == mtime   # not written again
    assert JobJournal.replay(jp).done["records"] == want["records"]
    # every unit the child committed is verified and skipped
    assert c.get("jobs.rounds_skipped", 0) == committed["round"]
    assert (c.get("jobs.spans_skipped", 0) > 0) == bool(committed["round"])
    assert c.get("jobs.markdup_skipped", 0) == committed["markdup"]
    assert c.get("jobs.shards_skipped", 0) == committed["shard"]
    ev = JobJournal.replay(jp).last_event("resume_plan")
    assert ev is not None and ev["rounds_skipped"] == committed["round"]
    assert not os.path.isdir(out + ".mkdup-spill")  # clean on success


def test_completed_job_is_a_verified_noop(tmp_path, prep_fixture):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    want = prep_fixture["oracle"][(False, "none")]
    assert markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                            round_records=90, journal_path=jp,
                            config=NOSYNC) == want["records"]
    mtime = os.stat(out).st_mtime_ns
    with MetricsContext() as m:
        n2 = markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                              round_records=90, journal_path=jp,
                              config=NOSYNC)
    assert n2 == want["records"]
    assert m.snapshot()["counters"].get("jobs.jobs_skipped") == 1
    assert os.stat(out).st_mtime_ns == mtime
    assert open(out, "rb").read() == want["bytes"]


def test_resume_job_redrives_a_mkdup_journal(tmp_path, prep_fixture):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    r = _run_child("round", 1, prep_fixture["src"], out, jp, 100)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    with MetricsContext() as m:
        got = resume_job(jp, config=NOSYNC, device="cpu")
    want = prep_fixture["oracle"][(False, "none")]
    assert got == {"kind": "mkdup", "output": os.path.abspath(out),
                   "records": want["records"]}
    assert m.snapshot()["counters"].get("jobs.rounds_skipped") == 1
    assert open(out, "rb").read() == want["bytes"]
    assert resume_job(jp, device="cpu")["records"] == want["records"]


def test_resume_refuses_other_params(tmp_path, prep_fixture):
    out = str(tmp_path / "out.bam")
    jp = journal_path_for(out)
    r = _run_child("round", 1, prep_fixture["src"], out, jp, 100)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    with pytest.raises(PlanError):
        markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                         round_records=100, journal_path=jp, config=NOSYNC,
                         library_from="rg")


# ---------------------------------------------------------------------------
# the co-written index serves a cold query
# ---------------------------------------------------------------------------

def test_mkdup_output_cold_queries_without_rescan(tmp_path, prep_fixture,
                                                  monkeypatch):
    import hadoop_bam_torch.split.bai as bai_mod
    from hadoop_bam_torch.query import QueryEngine, QueryRequest
    out = str(tmp_path / "cold.bam")
    markdup_bam_mesh(prep_fixture["src"], out, device="cpu",
                     round_records=120)
    assert os.path.exists(out + ".bai")

    def no_rescan(*a, **kw):
        raise AssertionError("build_bai called: the co-written sidecar "
                             "should have served the query")
    monkeypatch.setattr(bai_mod, "build_bai", no_rescan)
    regions = ["chr1:1-5000", "chr2:1-2000", "chr1:999000-1000000"]
    oracle = prep_fixture["oracle"][(False, "none")]["path"]
    got = QueryEngine(device="cpu").query_records(
        [QueryRequest(out, r) for r in regions])
    want = QueryEngine(device="cpu").query_records(
        [QueryRequest(oracle, r) for r in regions])
    for a, b in zip(got, want):
        assert [r.to_line() for r in a.records] == \
            [r.to_line() for r in b.records]
    assert sum(len(r.records) for r in got) > 0
