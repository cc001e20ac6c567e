"""The port's cohort plane against the JAX package's, on the CPU: every
case of tests/test_cohort.py but the CLI verb (the port's CLI waits for
ROADMAP Queue 1 item 12), each run through the port's ``CohortDataset``
/ ``cohort_gwas`` / ``ServeLoop(device="cpu")`` and held to the
reference's on the same files, and to test_cohort.py's independent
oracle join; the cohort cases of tests/test_jobs.py (a child that
SIGKILLs itself after its third committed chunk, then the resume) with
the journal's chunk files compared with the reference's; the plan
digest; K17a's plain version against the JAX GWAS step on every
``synth.GWAS_CASES`` case and K17b's against the JAX slice step; and
``synth.write_cohort``'s truth against both joins.

Fixtures are written with the reference's ``api.writers.open_vcf_writer``
(test_cohort.py's ``_write_sample``).  Each test starts from reset
metrics, resilience registries, chaos and background queues in both
packages."""
import dataclasses
import io
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.cohort import CohortDataset as JCohortDataset
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JCONFIG
from hadoop_bam_tpu.utils import metrics as jmetrics
from hadoop_bam_torch import synth
from hadoop_bam_torch.cohort import (
    CohortDataset, CohortManifest, as_manifest, cohort_gwas,
    cohort_gwas_plain, cohort_gwas_step, load_manifest, open_cohort,
)
from hadoop_bam_torch.config import DEFAULT_CONFIG
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError
from hadoop_bam_torch.utils.metrics import MetricsContext, base_metrics

from test_cohort import (
    _manifest, _np_gwas_reference, _oracle_join, _random_sample_lines,
    _serve_fixture, _write_sample,
)

pytestmark = pytest.mark.cohort

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
COLUMNS = ("chrom", "pos", "n_allele", "dosage", "qual")
GWAS = ("af", "call_rate", "hwe_chi2", "score_chi2")


@pytest.fixture(autouse=True)
def _clean():
    from hadoop_bam_tpu import resilience as jres
    from hadoop_bam_tpu.utils import pools as jpools
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch import resilience as tres
    from hadoop_bam_torch.utils import pools as tpools
    from hadoop_bam_torch.utils import resilient as trs

    def reset():
        for m in (base_metrics(), jmetrics.base_metrics()):
            m.reset()
        for mod in (tres, jres):
            mod.reset()
        for mod in (trs, jrs):
            mod.clear_chaos()
        for mod in (tpools, jpools):
            mod.cancel_background()
    reset()
    yield
    reset()


def _cfg(**kw):
    return dataclasses.replace(DEFAULT_CONFIG, **kw)


def _jcfg(**kw):
    return dataclasses.replace(JCONFIG, **kw)


def _ds(source, **kw):
    return CohortDataset(source, device="cpu", config=_cfg(**kw))


def _collect(ds):
    """Drain the port's tensor_batches into trimmed host columns."""
    parts = {k: [] for k in COLUMNS}
    for out in ds.tensor_batches():
        assert out["dosage"].shape[0] == 1
        c = int(out["n_records"][0])
        for k in COLUMNS:
            parts[k].append(out[k][0, :c].numpy())
    if not any(len(p) for p in parts["pos"]):
        return None
    return {k: np.concatenate(v) for k, v in parts.items()}


def _jcollect(ds):
    from test_cohort import _collect_batches
    return _collect_batches(ds)


def _assert_same(got, want, k=None):
    assert (got is None) == (want is None)
    if got is None:
        return
    for key in COLUMNS:
        g, w = got[key], want[key]
        if k is not None and g.ndim == 2:
            g, w = g[:, :k], w[:, :k]
        assert g.dtype == w.dtype, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def _assert_matches_oracle(paths, got):
    contigs, rows = _oracle_join(paths)
    k = len(paths)
    if got is None:
        assert rows == []
        return
    assert got["chrom"].tolist() == [r[0] for r in rows]
    assert got["pos"].tolist() == [r[1] for r in rows]
    assert got["n_allele"].tolist() == [r[2] for r in rows]
    np.testing.assert_array_equal(got["dosage"][:, :k],
                                  np.stack([r[3] for r in rows]))
    want_q = np.stack([r[4] for r in rows])
    np.testing.assert_array_equal(np.isnan(got["qual"][:, :k]),
                                  np.isnan(want_q))
    np.testing.assert_allclose(np.nan_to_num(got["qual"][:, :k]),
                               np.nan_to_num(want_q), rtol=1e-6)


def _both(paths, **kw):
    """(port dataset, port columns, reference columns) of one cohort."""
    ds = _ds(list(paths), **kw)
    got = _collect(ds)
    want = _jcollect(JCohortDataset(list(paths), _jcfg(**kw)))
    assert ds.contigs == JCohortDataset(list(paths), _jcfg(**kw)).contigs
    _assert_same(got, want)
    return ds, got


# ---------------------------------------------------------------------------
# the join against the reference's and the independent oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_join_matches_reference_and_oracle_randomized(tmp_path, seed):
    rng = random.Random(seed)
    k = rng.randint(2, 6)
    exts = [".vcf", ".vcf.gz", ".bcf"]
    paths = [_write_sample(str(tmp_path / f"s{s}{exts[s % 3]}"), f"s{s}",
                           _random_sample_lines(rng)) for s in range(k)]
    _ds_, got = _both(paths)
    _assert_matches_oracle(paths, got)


def test_join_across_mixed_containers_small(tmp_path):
    p0 = _write_sample(str(tmp_path / "a.vcf"), "a", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1",
        "chr21\t5\t.\tC\tT\t7\tPASS\t.\tGT\t1/1"])
    p1 = _write_sample(str(tmp_path / "b.vcf.gz"), "b", [
        "chr20\t100\t.\tA\tT\t11\tPASS\t.\tGT\t1/1"])
    p2 = _write_sample(str(tmp_path / "c.bcf"), "c", [
        "chr20\t100\t.\tA\tG\t22\tPASS\t.\tGT\t1/1",
        "chr21\t5\t.\tC\tT\t9\tPASS\t.\tGT\t0/1"])
    _ds_, got = _both([p0, p1, p2])
    _assert_matches_oracle([p0, p1, p2], got)
    # chr20:100 joins A->[G, T]: multi-allelic union in sample order
    assert got["n_allele"].tolist() == [3, 2]
    np.testing.assert_array_equal(got["dosage"][0, :3], [1, 2, 2])


# ---------------------------------------------------------------------------
# harmonization edge cases
# ---------------------------------------------------------------------------

def _join_two(tmp_path, lines_a, lines_b):
    pa = _write_sample(str(tmp_path / "ha.vcf"), "ha", lines_a)
    pb = _write_sample(str(tmp_path / "hb.vcf"), "hb", lines_b)
    return _both([pa, pb])


def test_harmonize_ref_alt_swap(tmp_path):
    _ds_, got = _join_two(
        tmp_path, ["chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"],
        ["chr20\t100\t.\tG\tA\t30\tPASS\t.\tGT\t0/0"])
    assert got["n_allele"].tolist() == [2]
    np.testing.assert_array_equal(got["dosage"][0, :2], [1, 2])


def test_harmonize_multiallelic_split_and_reorder(tmp_path):
    _ds_, got = _join_two(
        tmp_path, ["chr20\t100\t.\tA\tG,T\t30\tPASS\t.\tGT\t1/2"],
        ["chr20\t100\t.\tA\tT,G\t30\tPASS\t.\tGT\t1/1"])
    assert got["n_allele"].tolist() == [3]
    np.testing.assert_array_equal(got["dosage"][0, :2], [2, 2])


def test_harmonize_duplicate_positions_first_wins(tmp_path):
    with MetricsContext() as m:
        _ds_, got = _join_two(
            tmp_path,
            ["chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t1/1",
             "chr20\t100\t.\tA\tG\t99\tPASS\t.\tGT\t0/0"],
            ["chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    np.testing.assert_array_equal(got["dosage"][0, :2], [2, 1])
    assert got["qual"][0, 0] == np.float32(30)
    assert m.snapshot()["counters"].get("cohort.duplicate_sites") == 1


def test_harmonize_inconsistent_ref_goes_sentinel(tmp_path):
    with MetricsContext() as m:
        _ds_, got = _join_two(
            tmp_path, ["chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"],
            ["chr20\t100\t.\tAT\tA\t30\tPASS\t.\tGT\t1/1"])
    assert got["n_allele"].tolist() == [2]
    np.testing.assert_array_equal(got["dosage"][0, :2], [1, -1])
    assert m.snapshot()["counters"].get("cohort.harmonize_dropped") == 1


def test_harmonize_missing_and_polyploid(tmp_path):
    _ds_, got = _join_two(
        tmp_path,
        ["chr20\t100\t.\tA\tG\t.\tPASS\t.\tGT\t./.",
         "chr20\t200\t.\tC\tT\t5\tPASS\t.\tGT\t0/1/1"],
        ["chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t1/1"])
    np.testing.assert_array_equal(got["dosage"][0, :2], [-1, 2])
    assert np.isnan(got["qual"][0, 0])
    np.testing.assert_array_equal(got["dosage"][1, :2], [2, -1])


def test_abandoned_join_restarts_from_file_start(tmp_path):
    rng = random.Random(31)
    paths = [_write_sample(str(tmp_path / f"r{s}.vcf"), f"r{s}",
                           _random_sample_lines(rng, n_sites=30))
             for s in range(2)]
    ds = _ds(paths, cohort_chunk_sites=4)
    full = _collect(_ds(paths, cohort_chunk_sites=4))
    it = ds.site_chunks()
    next(it)
    it.close()
    got = _collect(ds)
    np.testing.assert_array_equal(got["pos"], full["pos"])
    assert ds.gwas()["n_variants"] == full["pos"].shape[0]
    _assert_same(full, _jcollect(JCohortDataset(
        paths, _jcfg(cohort_chunk_sites=4))))


def test_sentinel_propagation_through_tensor_batches(tmp_path):
    p = _write_sample(str(tmp_path / "one.vcf"), "one", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    outs = list(_ds([p]).tensor_batches())
    assert len(outs) == 1
    out = outs[0]
    # the reference's keys and dtypes, a leading device axis of 1
    want = {"chrom": torch.int32, "pos": torch.int32,
            "n_allele": torch.int16, "dosage": torch.int8,
            "qual": torch.float32, "n_records": torch.int32}
    assert {k: v.dtype for k, v in out.items()} == want
    cap = out["pos"].shape[1]
    assert out["dosage"].shape == (1, cap, 8)
    assert out["n_records"].tolist() == [1]
    assert (out["dosage"][0, 1:] == -1).all()
    assert torch.isnan(out["qual"][0, 1:]).all()
    assert (out["dosage"][0, 0, 1:] == -1).all()   # padding columns


def test_tensor_batches_are_lazy(tmp_path):
    """A feed (or a journaled join) that is built and never iterated
    starts no join and opens no journal."""
    p = _write_sample(str(tmp_path / "lz.vcf"), "lz", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    jp = str(tmp_path / "lz.hbam-journal")
    ds = CohortDataset([p], device="cpu", config=_cfg(journal_fsync=False),
                       journal_path=jp)
    with MetricsContext() as m:
        feed = ds.tensor_batches()
        chunks = ds.site_chunks()
    assert "cohort.sites" not in m.snapshot()["counters"]
    assert not os.path.exists(jp)
    del feed, chunks
    assert _collect(ds)["pos"].tolist() == [100]
    assert os.path.exists(jp)


# ---------------------------------------------------------------------------
# GWAS: the driver against NumPy and the reference, K17a's plain version
# against the JAX step
# ---------------------------------------------------------------------------

def test_gwas_matches_numpy_and_reference(tmp_path):
    from hadoop_bam_tpu.cohort import cohort_gwas as jgwas

    rng = random.Random(11)
    k = 5
    paths = [_write_sample(str(tmp_path / f"g{s}.vcf"), f"g{s}",
                           _random_sample_lines(rng, n_sites=30))
             for s in range(k)]
    pheno = np.asarray([0.2, 1.5, float("nan"), -0.7, 0.9], np.float32)
    res = _ds(paths).gwas(phenotype=pheno)
    got = _collect(_ds(paths))
    ref = _np_gwas_reference(got["dosage"], k, pheno)
    assert res["n_variants"] == got["dosage"].shape[0] > 0
    for col in GWAS:
        np.testing.assert_allclose(res[col], ref[col], rtol=2e-4,
                                   atol=2e-4, equal_nan=True, err_msg=col)
    want = jgwas(JCohortDataset(paths), phenotype=pheno)
    for key in ("chrom", "pos", "n_allele", "af", "call_rate"):
        np.testing.assert_array_equal(res[key], want[key], err_msg=key)
    for col in ("hwe_chi2", "score_chi2"):
        np.testing.assert_allclose(res[col], want[col], rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=col)
    assert res["sample_ids"] == want["sample_ids"]
    assert res["quarantined"] == want["quarantined"] == {}
    # the functional form over a manifest path, on the CPU
    mp = _manifest(tmp_path, paths)
    again = cohort_gwas(mp, phenotype=pheno, device="cpu")
    np.testing.assert_array_equal(again["af"], res["af"])


def test_gwas_without_phenotype_and_bad_phenotype(tmp_path):
    p = _write_sample(str(tmp_path / "p.vcf"), "p", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    ds = _ds([p])
    res = ds.gwas()
    assert np.isnan(res["score_chi2"]).all()
    with pytest.raises(PlanError):
        ds.gwas(phenotype=np.zeros(3, np.float32))
    from hadoop_bam_tpu.utils.errors import PlanError as JPlanError
    with pytest.raises(JPlanError):
        JCohortDataset([p]).gwas(phenotype=np.zeros(3, np.float32))


def _jax_gwas(d, count, pheno, S):
    import jax

    from hadoop_bam_tpu.cohort.gwas import make_cohort_gwas_step
    from hadoop_bam_tpu.parallel.mesh import make_mesh
    from hadoop_bam_tpu.parallel.variant_pipeline import VariantGeometry

    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    geom = VariantGeometry(tile_records=d.shape[1], n_samples=S)
    step = make_cohort_gwas_step(mesh, geom, pheno is not None)
    y = pheno if pheno is not None else np.full(d.shape[2], np.nan,
                                                np.float32)
    return np.asarray(step(d, np.asarray([count], np.int32), y))


@pytest.mark.parametrize("case", synth.GWAS_CASES)
def test_k17a_plain_matches_the_jax_step(case):
    """AF and call rate (from integer counts) exactly; HWE and score
    within rtol 1e-5, atol 1e-6 (their sums run in another order)."""
    d, count, pheno, S = synth.gwas_case(case)
    want = _jax_gwas(d, count, pheno, S)
    got = cohort_gwas_plain(torch.from_numpy(d), count,
                            None if pheno is None else torch.from_numpy(pheno),
                            S)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-5,
                               atol=1e-6, equal_nan=True)
    assert np.isnan(got[0, count:]).all()
    if pheno is None:
        assert np.isnan(got[..., 3]).all()
    # the wrapper takes the plain version on a CPU tensor, and a tensor
    # count as well as an int
    before = cohort_gwas_step.launches
    again = cohort_gwas_step(torch.from_numpy(d),
                             torch.tensor([count], dtype=torch.int32),
                             None if pheno is None
                             else torch.from_numpy(pheno), S)
    assert cohort_gwas_step.launches == before
    np.testing.assert_array_equal(again.numpy(), got)


def test_k17a_refuses_bad_arguments():
    d = torch.zeros((1, 4, 12), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 8"):
        cohort_gwas_step(d, 4, None, 12)
    with pytest.raises(ValueError):
        cohort_gwas_step(torch.zeros((4, 8), dtype=torch.int8), 4, None, 8)
    with pytest.raises(ValueError):
        cohort_gwas_step(torch.zeros((1, 4, 8), dtype=torch.int8), 4,
                         torch.zeros(16), 8)


@pytest.mark.parametrize("iv", [(0, 1, 200), (0, 150, 100_000),
                                (1, 1, 10), (0, 5, 4)])
def test_k17b_slice_step_matches_the_jax_step(iv):
    """K17b on a serve tile (rows past the count padded with -1, as the
    tile builder pads them) against the reference's slice step: on a CPU
    tile, its plain version ``cohort_slice_plain``."""
    import jax

    from hadoop_bam_tpu.cohort.serving import make_cohort_slice_step
    from hadoop_bam_tpu.parallel.mesh import make_mesh
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_step
    from hadoop_bam_torch.cohort.serving import cohort_slice_step

    rng = np.random.default_rng(5)
    cap, spad, count = 64, 24, 50
    chrom = np.full((1, cap), -1, np.int32)
    pos = np.zeros((1, cap), np.int32)
    chrom[0, :count] = np.sort(rng.integers(0, 2, count))
    pos[0, :count] = np.sort(rng.integers(1, 300, count))
    dosage = rng.integers(-1, 3, (1, cap, spad)).astype(np.int8)
    dosage[0, :count][rng.random((count, spad)) < 0.3] = -1
    dosage[0, 3] = -1                            # nothing called
    dosage[0, count:] = -1
    dosage[0, :, 20:] = -1                       # padding columns
    ivs = np.asarray(iv, np.int32)
    step = make_cohort_slice_step(make_mesh(devices=jax.devices("cpu")[:1]))
    want = [np.asarray(x) for x in step(chrom, pos, dosage,
                                        np.asarray([count], np.int32), ivs)]
    before = (cohort_gwas_step.launches, cohort_slice_step.launches)
    got = [x.numpy() for x in cohort_slice_step(
        *map(torch.from_numpy, (chrom, pos, dosage,
                                np.asarray([count], np.int32), ivs)))]
    # a CPU tile takes K17b's plain version: no kernel launch is counted
    assert (cohort_gwas_step.launches, cohort_slice_step.launches) == before
    for name, g, w in zip(("keep", "hits", "af", "af_sum", "af_n"), got,
                          want):
        assert g.shape == w.shape, name
        if name == "af_sum":
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_k17b_refuses_bad_arguments():
    from hadoop_bam_torch.cohort.serving import cohort_slice_step
    chrom, pos, d, c, iv = map(torch.from_numpy,
                               synth.slice_case("200 rows, a slice",
                                                cap=256, samples_pad=16))
    with pytest.raises(ValueError, match="multiple of 8"):
        cohort_slice_step(chrom, pos, d[..., :12], c, iv)
    with pytest.raises(ValueError, match="chrom"):
        cohort_slice_step(chrom.to(torch.int64), pos, d, c, iv)
    with pytest.raises(ValueError, match="pos"):
        cohort_slice_step(chrom, pos[:, :10], d, c, iv)
    with pytest.raises(ValueError, match="iv"):
        cohort_slice_step(chrom, pos, d, c, iv[:2])
    before = cohort_slice_step.launches
    got = cohort_slice_step(chrom, pos, d, c, iv)
    assert cohort_slice_step.launches == before and got[0].shape == (1, 256)


# ---------------------------------------------------------------------------
# manifests and the plan digest
# ---------------------------------------------------------------------------

def test_manifest_forms_and_plan_errors(tmp_path):
    from hadoop_bam_tpu.cohort import load_manifest as jload

    p = _write_sample(str(tmp_path / "m.vcf"), "m", [])
    mp = tmp_path / "man.json"
    mp.write_text(json.dumps({"samples": [{"id": "m", "path": "m.vcf"}]}))
    man = load_manifest(str(mp))
    assert man.samples[0].path == str(tmp_path / "m.vcf")
    assert man.sample_ids == ["m"] == jload(str(mp)).sample_ids
    assert as_manifest([p]).sample_ids == ["m"]
    assert man.to_dict() == jload(str(mp)).to_dict()
    with pytest.raises(PlanError):
        CohortManifest.from_doc({"nope": []})
    with pytest.raises(PlanError):
        CohortManifest.from_doc([])
    with pytest.raises(PlanError):
        CohortManifest.from_doc([{"path": p}, {"path": p}])
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(PlanError):
        load_manifest(str(bad))
    with pytest.raises(FileNotFoundError):
        load_manifest(str(tmp_path / "absent.json"))


def test_manifest_identity_tracks_inputs(tmp_path):
    from hadoop_bam_tpu.cohort import load_manifest as jload

    p = _write_sample(str(tmp_path / "i.vcf"), "i", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    mp = _manifest(tmp_path, [p])
    i0 = load_manifest(mp).identity()
    assert i0 == load_manifest(mp).identity() == jload(mp).identity()
    os.utime(p, ns=(1, 1))
    assert load_manifest(mp).identity() != i0
    assert i0[0] == os.path.abspath(mp)
    # a missing input (or its directory) is configuration
    for gone in (tmp_path / "gone.vcf", tmp_path / "no_dir" / "x.vcf"):
        with pytest.raises(FileNotFoundError):
            as_manifest([p, str(gone)]).identity()


def test_cohort_plan_digest_equals_the_reference(tmp_path):
    from hadoop_bam_tpu.plan.builders import cohort_plan as jplan
    from hadoop_bam_torch.plan.builders import cohort_plan

    rng = random.Random(4)
    paths = [_write_sample(str(tmp_path / f"d{s}.vcf"), f"d{s}",
                           _random_sample_lines(rng, n_sites=5))
             for s in range(3)]
    mp = _manifest(tmp_path, paths)
    for kw in ({}, {"cohort_chunk_sites": 7}):
        got = cohort_plan(mp, _cfg(**kw))
        want = jplan(mp, _jcfg(**kw))
        assert got.to_doc() == want.to_doc()
        assert got.digest() == want.digest()
    assert _ds(mp).plan().digest() == JCohortDataset(mp).plan().digest()
    # an inline manifest (a bare path list) too
    assert cohort_plan(paths).digest() == jplan(paths).digest()


# ---------------------------------------------------------------------------
# per-input fault domains
# ---------------------------------------------------------------------------

def test_corrupt_input_under_chaos_quarantines(tmp_path):
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch import resilience
    from hadoop_bam_torch.utils import resilient as trs

    good = _write_sample(str(tmp_path / "ok.vcf"), "ok", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1",
        "chr20\t200\t.\tC\tT\t30\tPASS\t.\tGT\t1/1"])
    bad = _write_sample(str(tmp_path / "bad.bcf"), "bad", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t1/1",
        "chr20\t200\t.\tC\tT\t30\tPASS\t.\tGT\t0/1"])
    ds = _ds([good, bad])
    jds = JCohortDataset([good, bad])
    trs.install_chaos_seeded(bad, seed=99, bitflip_rate=1.0)
    jrs.install_chaos_seeded(bad, seed=99, bitflip_rate=1.0)
    try:
        with MetricsContext() as m:
            got = _collect(ds)
        want = _jcollect(jds)
    finally:
        trs.clear_chaos(bad)
        jrs.clear_chaos(bad)
    _assert_same(got, want)
    assert got["pos"].tolist() == [100, 200]
    np.testing.assert_array_equal(got["dosage"][:, 0], [1, 2])
    np.testing.assert_array_equal(got["dosage"][:, 1], [-1, -1])
    assert list(ds.manifest.quarantined) == ["bad"] == \
        list(jds.manifest.quarantined)
    assert ds.manifest.quarantined["bad"].split(":")[0] == \
        jds.manifest.quarantined["bad"].split(":")[0]
    assert m.snapshot()["counters"]["cohort.samples_quarantined"] == 1
    assert any(k.startswith("cohort/input/")
               for k in resilience.registry().states())


def test_out_of_order_input_quarantines_and_strict_raises(tmp_path):
    good = _write_sample(str(tmp_path / "g.vcf"), "g", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    unsorted = _write_sample(str(tmp_path / "u.vcf"), "u", [
        "chr20\t500\t.\tA\tG\t30\tPASS\t.\tGT\t1/1",
        "chr20\t100\t.\tC\tT\t30\tPASS\t.\tGT\t0/1"])
    ds, got = _both([good, unsorted])
    assert list(ds.manifest.quarantined) == ["u"]
    assert 500 in got["pos"].tolist()
    with pytest.raises(CorruptDataError):
        _collect(_ds([good, unsorted], cohort_quarantine_inputs=False))
    with pytest.raises(Exception) as ji:
        _jcollect(JCohortDataset([good, unsorted],
                                 _jcfg(cohort_quarantine_inputs=False)))
    assert type(ji.value).__name__ == "CorruptDataError"


def test_quarantine_fraction_circuit(tmp_path):
    u1 = _write_sample(str(tmp_path / "u1.vcf"), "u1", [
        "chr20\t500\t.\tA\tG\t30\tPASS\t.\tGT\t1/1",
        "chr20\t100\t.\tC\tT\t30\tPASS\t.\tGT\t0/1"])
    u2 = _write_sample(str(tmp_path / "u2.vcf"), "u2", [
        "chr21\t500\t.\tA\tG\t30\tPASS\t.\tGT\t1/1",
        "chr21\t100\t.\tC\tT\t30\tPASS\t.\tGT\t0/1"])
    with pytest.raises(CorruptDataError, match="quarantined"):
        _collect(_ds([u1, u2], cohort_max_quarantine_fraction=0.5))
    with pytest.raises(Exception, match="quarantined"):
        _jcollect(JCohortDataset([u1, u2], _jcfg(
            cohort_max_quarantine_fraction=0.5)))


def test_corrupt_header_quarantines_at_build(tmp_path):
    good = _write_sample(str(tmp_path / "hok.vcf"), "hok", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    broken = _write_sample(str(tmp_path / "hbad.bcf"), "hbad", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t1/1"])
    raw = bytearray(open(broken, "rb").read())
    raw[20:60] = np.random.default_rng(3).integers(
        0, 256, 40, dtype=np.uint8).tobytes()
    with open(broken, "wb") as f:
        f.write(raw)
    ds, got = _both([good, broken], cohort_max_quarantine_fraction=0.6)
    assert "hbad" in ds.manifest.quarantined
    np.testing.assert_array_equal(got["dosage"][:, :2], [[1, -1]])
    with pytest.raises(CorruptDataError):
        _ds([broken], cohort_max_quarantine_fraction=0.4)
    with pytest.raises(Exception):
        _ds([good, broken], cohort_quarantine_inputs=False)


def test_missing_input_is_plan_never_quarantined(tmp_path):
    with pytest.raises(FileNotFoundError):
        _ds([str(tmp_path / "nope.vcf")])


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """With no card, the cohort entry points that were not given
    device="cpu" raise instead of moving to the CPU."""
    p = _write_sample(str(tmp_path / "e.vcf"), "e", [
        "chr20\t100\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        open_cohort([p])
    with pytest.raises(RuntimeError):
        cohort_gwas([p])


# ---------------------------------------------------------------------------
# the generator's truth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_samples,n_sites,seed", [(7, 120, 1),
                                                    (40, 60, 2)])
def test_write_cohort_truth_equals_both_joins(tmp_path, n_samples, n_sites,
                                              seed):
    truth = synth.write_cohort(str(tmp_path), n_samples, n_sites, seed)
    assert truth.n_multi_sites and truth.n_duplicates
    assert truth.n_swapped + truth.n_badref + truth.n_split > 0
    ds = open_cohort(truth.manifest, device="cpu")
    got = _collect(ds)
    assert ds.contigs == list(truth.contigs)
    np.testing.assert_array_equal(got["chrom"], truth.chrom)
    np.testing.assert_array_equal(got["pos"], truth.pos)
    np.testing.assert_array_equal(got["n_allele"], truth.n_allele)
    np.testing.assert_array_equal(got["dosage"][:, :n_samples],
                                  truth.dosage)
    _assert_same(got, _jcollect(JCohortDataset(truth.manifest)))
    assert sorted({os.path.splitext(p)[1] for p in truth.paths}) == \
        [".bcf", ".gz", ".vcf"]


# ---------------------------------------------------------------------------
# cohort-slice serving, against the reference's ServeLoop
# ---------------------------------------------------------------------------

def _loop(**kw):
    from hadoop_bam_torch.serve import ServeLoop
    return ServeLoop(config=_cfg(**kw), device="cpu")


def _jloop(**kw):
    from hadoop_bam_tpu.serve import ServeLoop as JServeLoop
    return JServeLoop(config=_jcfg(**kw))


def test_cohort_slice_serving_warm_bypass(tmp_path):
    man, paths = _serve_fixture(tmp_path)
    contigs, rows = _oracle_join([str(p) for p in paths])
    lo, hi = 1, 150
    want = sum(1 for r in rows if r[0] == 0 and lo <= r[1] <= hi)
    with _jloop() as jl:
        jwarm = jl.query(man, [f"chr20:{lo}-{hi}"], cohort=True,
                         want_records=True)[0]
    with _loop() as loop:
        cold = loop.query(man, [f"chr20:{lo}-{hi}"], cohort=True)[0]
        assert cold.count == want
        assert cold.tile_misses >= 1 and cold.tile_hits == 0
        assert cold.extra["n_samples"] == 3
        with MetricsContext() as m:
            warm = loop.query(man, [f"chr20:{lo}-{hi}"], cohort=True,
                              want_records=True)[0]
        snap = m.snapshot()
        assert warm.count == want == jwarm.count
        assert warm.tile_hits >= 1 and warm.tile_misses == 0
        assert snap["wall_timers"].get("cohort.join_wall", 0.0) == 0.0
        assert snap["wall_timers"].get("pipeline.host_decode_wall",
                                       0.0) == 0.0
        assert warm.records == jwarm.records
        assert len(warm.records) == want
        assert warm.extra == jwarm.extra
        with MetricsContext() as m2:
            other = loop.query(man, ["chr20:151-100000"], cohort=True)[0]
        assert m2.snapshot()["wall_timers"].get("cohort.join_wall",
                                                0.0) == 0.0
        assert other.count == sum(1 for r in rows
                                  if r[0] == 0 and 151 <= r[1] <= 100000)
        assert loop.stats()["cohort"] == {"manifests": 1}


def test_cohort_slice_input_rewrite_invalidates(tmp_path):
    man, paths = _serve_fixture(tmp_path, k=2, n_sites=8)
    with _loop() as loop:
        before = loop.query(man, ["chr20"], cohort=True)[0]
        _write_sample(str(paths[0]), "v0", [
            "chr20\t1\t.\tA\tG\t30\tPASS\t.\tGT\t1/1"])
        after = loop.query(man, ["chr20"], cohort=True)[0]
        assert after.tile_misses >= 1
        assert after.count != before.count or after.n_candidates \
            != before.n_candidates
    contigs, rows = _oracle_join([str(p) for p in paths])
    assert after.count == sum(1 for r in rows if r[0] == 0)


def test_cohort_slice_serves_through_header_corrupt_sample(tmp_path):
    good = _write_sample(str(tmp_path / "sg.vcf"), "sg", [
        "chr20\t10\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    broken = _write_sample(str(tmp_path / "sb.bcf"), "sb", [
        "chr20\t10\t.\tA\tG\t30\tPASS\t.\tGT\t1/1"])
    raw = bytearray(open(broken, "rb").read())
    raw[20:60] = np.random.default_rng(4).integers(
        0, 256, 40, dtype=np.uint8).tobytes()
    with open(broken, "wb") as f:
        f.write(raw)
    man = _manifest(tmp_path, [good, broken], ids=["sg", "sb"])
    with _loop(cohort_max_quarantine_fraction=0.6) as loop:
        res = loop.query(man, ["chr20:1-100"], cohort=True)[0]
    with _jloop(cohort_max_quarantine_fraction=0.6) as jl:
        jres = jl.query(man, ["chr20:1-100"], cohort=True)[0]
    assert res.count == 1 == jres.count
    assert res.extra["n_samples"] == 2
    assert res.extra["quarantined"] == ["sb"] == jres.extra["quarantined"]


def test_cohort_slice_bad_contig_and_quarantine_on_wire(tmp_path):
    from hadoop_bam_torch.serve.transport import handle_stream

    good = _write_sample(str(tmp_path / "w.vcf"), "w", [
        "chr20\t10\t.\tA\tG\t30\tPASS\t.\tGT\t0/1"])
    unsorted = _write_sample(str(tmp_path / "x.vcf"), "x", [
        "chr20\t500\t.\tA\tG\t30\tPASS\t.\tGT\t1/1",
        "chr20\t100\t.\tC\tT\t30\tPASS\t.\tGT\t0/1"])
    man = _manifest(tmp_path, [good, unsorted], ids=["w", "x"])
    with _loop() as loop:
        with pytest.raises(PlanError):
            loop.query(man, ["chrBOGUS:1-2"], cohort=True)
        reqs = (json.dumps({"id": 1, "cohort": True, "path": man,
                            "regions": ["chr20:1-1000"],
                            "records": True}) + "\n"
                + json.dumps({"id": 2, "cohort": True, "path": man,
                              "regions": ["chrBOGUS:1-2"]}) + "\n")
        out = io.StringIO()
        handle_stream(loop, io.StringIO(reqs), out)
    docs = {d["id"]: d for d in
            (json.loads(l) for l in out.getvalue().splitlines())}
    r1 = docs[1]["results"][0]
    assert r1["count"] == 2
    assert r1["n_samples"] == 2
    assert r1["quarantined"] == ["x"]
    assert [r["pos"] for r in r1["records"]] == [10, 500]
    assert docs[2]["kind"] == "plan"


# ---------------------------------------------------------------------------
# the journaled join: kills, resumes and refusals (tests/test_jobs.py's
# cohort cases), chunk files against the reference's
# ---------------------------------------------------------------------------

_COHORT_CHILD = """
    import dataclasses, os, signal, sys
    from hadoop_bam_torch.jobs import JobJournal
    mp, jp = sys.argv[1:3]
    orig = JobJournal.unit_done
    n = [0]
    def patched(self, kind, key, **kw):
        orig(self, kind, key, **kw)
        n[0] += 1
        if n[0] >= 3:
            os.kill(os.getpid(), signal.SIGKILL)
    JobJournal.unit_done = patched
    from hadoop_bam_torch.cohort import open_cohort
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    cfg = dataclasses.replace(DEFAULT_CONFIG, cohort_chunk_sites=11,
                              journal_fsync=False)
    for _ in open_cohort(mp, device="cpu", config=cfg,
                         journal_path=jp).site_chunks():
        pass
    raise SystemExit("unreachable: child must have been killed")
"""


def _run_child(*args):
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(textwrap.dedent(_COHORT_CHILD))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        return subprocess.run([sys.executable, f.name, *map(str, args)],
                              env=env, timeout=180, capture_output=True,
                              text=True)
    finally:
        os.unlink(f.name)


def _cohort_fixture(tmp_path):
    rng = random.Random(17)
    files = []
    for i in range(4):
        p = str(tmp_path / f"s{i}.vcf")
        _write_sample(p, f"s{i}", _random_sample_lines(rng, n_sites=25))
        files.append(p)
    mp = str(tmp_path / "cohort.json")
    with open(mp, "w") as f:
        json.dump({"samples": [{"id": f"s{i}", "path": p}
                               for i, p in enumerate(files)]}, f)
    return mp


def _chunks_of(ds):
    return [{k: v.copy() for k, v in c.items()} for c in ds.site_chunks()]


def _assert_chunks_equal(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        assert list(ca) == list(cb)
        for k in ca:
            assert ca[k].dtype == cb[k].dtype, k
            np.testing.assert_array_equal(ca[k], cb[k])


NOSYNC = dict(cohort_chunk_sites=11, journal_fsync=False)


def test_sigkill_mid_cohort_join_resumes_identical(tmp_path):
    from hadoop_bam_torch.jobs import JobJournal

    mp = _cohort_fixture(tmp_path)
    cfg = _cfg(**NOSYNC)
    oracle = _chunks_of(open_cohort(mp, device="cpu", config=cfg))
    assert len(oracle) > 4
    _assert_chunks_equal(oracle, _chunks_of(JCohortDataset(
        mp, _jcfg(**NOSYNC))))
    jp = str(tmp_path / "cohort.hbam-journal")
    r = _run_child(mp, jp)
    assert r.returncode == -signal.SIGKILL, (r.returncode,
                                             r.stderr[-2000:])
    assert len(JobJournal.replay(jp).units) == 3
    with MetricsContext() as m:
        got = _chunks_of(open_cohort(mp, device="cpu", config=cfg,
                                     journal_path=jp))
    _assert_chunks_equal(oracle, got)
    assert m.snapshot()["counters"].get("jobs.chunks_replayed") == 3
    # a finished job: a third pass is pure replay, no join work at all
    with MetricsContext() as m:
        again = _chunks_of(open_cohort(mp, device="cpu", config=cfg,
                                       journal_path=jp))
    snap = m.snapshot()
    _assert_chunks_equal(oracle, again)
    assert snap["counters"].get("jobs.jobs_skipped") == 1
    assert "cohort.join_wall" not in snap.get("wall_timers", {})


def test_journal_chunks_equal_the_reference(tmp_path):
    """The port's journaled chunk files hold the reference's arrays for
    the same input, and both journals record the same plan digest."""
    from hadoop_bam_torch.jobs import JobJournal

    mp = _cohort_fixture(tmp_path)
    tp, jp = str(tmp_path / "t.hbam-journal"), str(tmp_path / "j.hbam-journal")
    _chunks_of(open_cohort(mp, device="cpu", config=_cfg(**NOSYNC),
                           journal_path=tp))
    _chunks_of(JCohortDataset(mp, _jcfg(**NOSYNC), journal_path=jp))
    ts, js = JobJournal.replay(tp), JobJournal.replay(jp)
    assert ts.header["params"] == js.header["params"]
    assert ts.header["kind"] == js.header["kind"] == "cohort_join"
    tu = [ts.unit("chunk", i) for i in range(len(ts.units))]
    ju = [js.unit("chunk", i) for i in range(len(js.units))]
    assert len(tu) == len(ju) > 4
    for a, b in zip(tu, ju):
        assert (a["sites"], a["key_hi"], a["key_lo"]) == \
            (b["sites"], b["key_hi"], b["key_lo"])
        with np.load(a["path"]) as za, np.load(b["path"]) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k])


def test_concurrent_journaled_joins_refused(tmp_path):
    mp = _cohort_fixture(tmp_path)
    jp = str(tmp_path / "cohort.hbam-journal")
    ds = open_cohort(mp, device="cpu", config=_cfg(**NOSYNC),
                     journal_path=jp)
    it = ds.site_chunks()
    next(it)
    with pytest.raises(PlanError, match="already in progress"):
        ds.site_chunks()
    for _ in it:
        pass
    assert len(_chunks_of(ds)) > 0
    never_started = ds.site_chunks()
    del never_started
    assert len(_chunks_of(ds)) > 0


def test_cohort_resume_refuses_changed_inputs(tmp_path):
    import time

    mp = _cohort_fixture(tmp_path)
    cfg = _cfg(**NOSYNC)
    jp = str(tmp_path / "cohort.hbam-journal")
    _chunks_of(open_cohort(mp, device="cpu", config=cfg, journal_path=jp))
    time.sleep(0.01)
    with open(str(tmp_path / "s1.vcf"), "a") as f:
        f.write("chr21\t99999999\t.\tA\tC\t50\tPASS\t.\tGT:DP\t0/1:9\n")
    with pytest.raises(PlanError, match="input file identity"):
        _chunks_of(open_cohort(mp, device="cpu", config=cfg,
                               journal_path=jp))
    sub = tmp_path / "x2"
    sub.mkdir()
    jp2 = str(tmp_path / "cohort2.hbam-journal")
    mp2 = _cohort_fixture(sub)
    _chunks_of(open_cohort(mp2, device="cpu", config=cfg, journal_path=jp2))
    with pytest.raises(PlanError, match="fingerprint"):
        _chunks_of(open_cohort(mp2, device="cpu",
                               config=_cfg(**dict(NOSYNC,
                                                  cohort_chunk_sites=7)),
                               journal_path=jp2))


def test_resume_job_drives_a_cohort_join(tmp_path):
    """``resume_job`` of a killed journaled join finishes it from the
    journal alone (the chunk size recorded in its header), as the
    reference's does; an inline-manifest join is refused."""
    from hadoop_bam_tpu.jobs import resume_job as jresume
    from hadoop_bam_torch.jobs import JobJournal, resume_job

    mp = _cohort_fixture(tmp_path)
    jp = str(tmp_path / "cohort.hbam-journal")
    r = _run_child(mp, jp)
    assert r.returncode == -signal.SIGKILL, r.stderr[-2000:]
    with MetricsContext() as m:
        got = resume_job(jp, device="cpu")
    assert m.snapshot()["counters"].get("jobs.chunks_replayed") == 3
    jjp = str(tmp_path / "ref.hbam-journal")
    _chunks_of(JCohortDataset(mp, _jcfg(**NOSYNC), journal_path=jjp))
    want = jresume(jjp)
    assert got == want
    assert got["kind"] == "cohort_join" and got["output"] is None
    assert got["chunks"] == len(JobJournal.replay(jp).units) > 4
    assert all(u[0] == "chunk" for u in JobJournal.replay(jp).units)
    # an inline manifest has no path to re-open from the journal
    rng = random.Random(2)
    paths = [_write_sample(str(tmp_path / f"in{i}.vcf"), f"in{i}",
                           _random_sample_lines(rng, n_sites=5))
             for i in range(2)]
    ijp = str(tmp_path / "inline.hbam-journal")
    _chunks_of(open_cohort(paths, device="cpu", config=_cfg(**NOSYNC),
                           journal_path=ijp))
    with pytest.raises(PlanError, match="cohort_join"):
        resume_job(ijp, device="cpu")
