"""The port's batched BAM region queries against the JAX package's, on
the CPU: the BAM cases of tests/test_query.py, each run through both
packages' ``QueryEngine`` on the same file, index and settings.

Records compare line for line (``SamRecord.to_line``) with each other
and with the full-scan oracle; counters, cache stats and error classes
compare exactly.  The VCF and BCF cases are in
tests/test_torch_query_variant.py; the CRAM cases are left out (the port
reads no CRAM yet), and a case of its own shows CRAM raises
``PlanError``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.query import (
    ChunkCache as JChunkCache, QueryEngine as JQueryEngine,
    QueryRequest as JRequest, QueryScheduler as JScheduler,
    file_identity as jfile_identity,
)
from hadoop_bam_tpu.utils import errors as jerr
from hadoop_bam_tpu.utils.metrics import METRICS as JMETRICS
from hadoop_bam_torch.config import config_from_dict
from hadoop_bam_torch.query import (
    ChunkCache, QueryEngine, QueryRequest, QueryScheduler, file_identity,
)
from hadoop_bam_torch.query.engine import overlap_step
from hadoop_bam_torch.utils import errors as terr
from hadoop_bam_torch.utils.metrics import METRICS

from fixtures import make_header, make_records

_BAM_REGIONS = ["chr1:1000-200000", "chr1:500,000-650,000", "chr2",
                "chr2:1-5000", "chr1:999999-1000000"]


def _coord_sorted(header, recs):
    def key(r):
        rid = (header.ref_names.index(r.rname) if r.rname != "*"
               else 1 << 30)
        return (rid, r.pos)
    return sorted(recs, key=key)


def _write_sorted(path, header, n, seed):
    from hadoop_bam_tpu.formats.bamio import BamWriter
    from hadoop_bam_tpu.split.bai import write_bai
    with BamWriter(path, header) as w:
        for r in _coord_sorted(header, make_records(header, n, seed=seed)):
            w.write_sam_record(r)
    write_bai(path)


@pytest.fixture(scope="module")
def indexed_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tquery") / "q.bam")
    header = make_header(2)
    _write_sorted(path, header, 2500, 11)
    return path, header


@pytest.fixture(autouse=True)
def _clean():
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch.utils import resilient as trs
    for rs, m in ((trs, METRICS), (jrs, JMETRICS)):
        rs.clear_chaos()
        m.reset()
    yield
    for rs in (trs, jrs):
        rs.clear_chaos()


def _engines(config=None, **kw):
    """(port engine on the CPU, reference engine) on one config."""
    jcfg = config if config is not None else JAX_CONFIG
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    return (QueryEngine(config=tcfg, device="cpu", **kw.get("t", {})),
            JQueryEngine(config=jcfg, **kw.get("j", {})))


def _lines(results):
    return [[r.to_line() for r in res.records] for res in results]


def _query(engines, path, regions):
    """Both engines' records for ``regions`` (equal), as lines."""
    t, j = engines
    got = t.query_records([QueryRequest(path, r) for r in regions])
    want = j.query_records([JRequest(path, r) for r in regions])
    assert _lines(got) == _lines(want)
    assert [r.n_candidates for r in got] == [r.n_candidates for r in want]
    return _lines(got)


def _bam_oracle(path, header, region):
    from hadoop_bam_tpu.api.dataset import open_bam
    from hadoop_bam_tpu.split.intervals import (
        batch_overlap_mask, resolve_interval,
    )
    iv = resolve_interval(region, header.ref_names)
    want = []
    for batch in open_bam(path).batches():
        m = batch_overlap_mask(batch, [iv], header)
        for i in np.nonzero(m)[0]:
            want.append(batch.to_sam_line(int(i)))
    return want


def _same_error(tfn, jfn):
    """Both calls raise, with the same failure class and class name."""
    with pytest.raises(Exception) as te:
        tfn()
    with pytest.raises(Exception) as je:
        jfn()
    g, w = te.value, je.value
    assert terr.classify_error(g) == jerr.classify_error(w), (g, w)
    assert type(g).__name__ == type(w).__name__, (g, w)
    return g, w


# ---------------------------------------------------------------------------
# equality with the full-scan oracle
# ---------------------------------------------------------------------------

def test_bam_query_matches_full_scan_oracle(indexed_bam):
    path, header = indexed_bam
    lines = _query(_engines(), path, _BAM_REGIONS)
    for region, got in zip(_BAM_REGIONS, lines):
        assert got == _bam_oracle(path, header, region), region
    assert sum(len(x) for x in lines) > 0


def test_tensor_batches_mask_agrees_with_records(indexed_bam):
    from hadoop_bam_tpu.api import query_regions as jquery_regions
    from hadoop_bam_torch.api import query_regions

    path, _header = indexed_bam
    t, j = _engines()
    res = t.query_records([QueryRequest(path, r) for r in _BAM_REGIONS])
    got_masks, want_masks, total = [], [], 0
    for out in query_regions(path, _BAM_REGIONS, engine=t):
        assert isinstance(out["keep"], torch.Tensor)
        assert out["keep"].dtype == torch.bool
        n = out["n_records"].numpy()
        keep = out["keep"].numpy()
        total += int(keep.sum())
        got_masks += [keep[d, :n[d]] for d in range(n.size)]
    for out in jquery_regions(path, _BAM_REGIONS, engine=j):
        n = np.asarray(out["n_records"])
        keep = np.asarray(out["keep"])
        want_masks += [keep[d, :n[d]] for d in range(n.size)]
    np.testing.assert_array_equal(np.concatenate(got_masks),
                                  np.concatenate(want_masks))
    assert total == sum(len(r.records) for r in res) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_overlap_step_matches_reference(seed):
    """K13 against the reference's jitted step on one CPU device, over
    random columns with rows past the count."""
    import jax
    from hadoop_bam_tpu.parallel.mesh import make_mesh
    from hadoop_bam_tpu.query.engine import make_overlap_step
    rng = np.random.default_rng(seed)
    cap = 512
    cols = [rng.integers(-1, 3, (1, cap)).astype(np.int32)]
    cols += [rng.integers(1, 1000, (1, cap)).astype(np.int32)
             for _ in range(2)]
    cols += [rng.integers(-1, 3, (1, cap)).astype(np.int32)]
    cols += [rng.integers(1, 1000, (1, cap)).astype(np.int32)
             for _ in range(2)]
    cols += [rng.integers(0, 9, (1, cap)).astype(np.int32)]
    count = np.array([int(rng.integers(0, cap + 1))], np.int32)
    step = make_overlap_step(make_mesh(devices=jax.devices("cpu")[:1]))
    want = np.asarray(step(*cols, count))
    got = overlap_step(*(torch.from_numpy(c) for c in cols),
                       torch.from_numpy(count)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, count[0]:].sum() == 0


# ---------------------------------------------------------------------------
# coalescing and the cache
# ---------------------------------------------------------------------------

def test_overlapping_requests_share_chunk_decodes(indexed_bam):
    path, _header = indexed_bam
    t, j = _engines()
    batch = ["chr1:10000-60000", "chr1:30000-90000", "chr1:10000-60000"]

    def decoded():
        got = METRICS.get("query.chunks_decoded")
        assert got == JMETRICS.get("query.chunks_decoded")
        return got

    _query((t, j), path, batch)
    first = decoded()
    # three overlapping requests share their chunks
    assert 1 <= first < len(batch)
    # the same batch again, and a hot region on its own: all warm
    _query((t, j), path, batch)
    assert decoded() == first
    _query((t, j), path, ["chr1:10000-60000"])
    before = decoded()
    _query((t, j), path, ["chr1:10000-60000"])
    assert decoded() == before
    assert t.stats()["hits"] > 0
    assert t.stats() == j.stats()


def test_same_file_through_two_path_spellings(indexed_bam):
    path, header = indexed_bam
    rel = os.path.relpath(path)
    assert rel != path and os.path.abspath(rel) == path
    t, j = _engines()
    got = t.query_records([QueryRequest(path, "chr1:1000-200000"),
                           QueryRequest(rel, "chr2:1-300000")])
    want = j.query_records([JRequest(path, "chr1:1000-200000"),
                            JRequest(rel, "chr2:1-300000")])
    assert _lines(got) == _lines(want)
    assert _lines(got)[0] == _bam_oracle(path, header, "chr1:1000-200000")
    assert _lines(got)[1] == _bam_oracle(path, header, "chr2:1-300000")
    assert got[0].records and got[1].records


def test_coalesce_gap_arithmetic_per_kind(indexed_bam):
    t, j = _engines()
    v = lambda c, u=0: (c << 16) | u      # noqa: E731
    cases = [([(v(0), v(4096)), (v(12288), v(16384))], "bam"),
             ([(0, 4096), (1 << 20, (1 << 20) + 4096)], "cram"),
             ([(0, 4096), (12288, 16384)], "cram")]
    for ranges, kind in cases:
        assert t._coalesce(ranges, kind) == j._coalesce(ranges, kind)
    assert t._coalesce(*cases[0]) == [(v(0), v(16384))]
    assert t._coalesce(*cases[1]) == cases[1][0]
    assert t._coalesce(*cases[2]) == [(0, 16384)]


def test_skip_bad_spans_serves_quarantined_chunk_as_empty(indexed_bam):
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch.utils import resilient as trs

    path, header = indexed_bam
    cfg = dataclasses.replace(JAX_CONFIG, skip_bad_spans=True,
                              span_retries=0)
    t, j = _engines(cfg)
    _query((t, j), path, ["chr1:1-2000"])          # metadata warm
    region = "chr2:500000-700000"
    for eng, rs, req, m in ((t, trs, QueryRequest, METRICS),
                            (j, jrs, JRequest, JMETRICS)):
        with rs.chaos_on(path, [rs.FaultSpec("bitflip", at_read=0,
                                             count=64, xor_mask=0xFF)]):
            res = eng.query_records([req(path, region)])
        assert res[0].records == []
        assert m.get("query.chunks_skipped") > 0
    assert METRICS.get("query.chunks_skipped") == \
        JMETRICS.get("query.chunks_skipped")
    # nothing cached for the bad chunk: it heals once the chaos is off
    assert _query((t, j), path, [region])[0] == \
        _bam_oracle(path, header, region)


def test_cache_stats_are_per_instance():
    for cls in (ChunkCache, JChunkCache):
        a, b = cls(1 << 20), cls(1 << 20)
        a.put(("k",), "v", 10)
        a.get(("k",))
        b.get(("absent",))
        assert a.stats()["hits"] == 1 and a.stats()["misses"] == 0
        assert b.stats()["hits"] == 0 and b.stats()["misses"] == 1
    assert ChunkCache(1 << 20).stats() == JChunkCache(1 << 20).stats()


def test_cache_invalidation_on_mtime_change(tmp_path):
    path = str(tmp_path / "inval.bam")
    header = make_header(1)
    _write_sorted(path, header, 400, 1)
    t, j = _engines()
    region = "chr1:1-1000000"
    first = _query((t, j), path, [region])[0]
    assert first
    _write_sorted(path, header, 150, 2)        # replace the file in place
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    second = _query((t, j), path, [region])[0]
    assert second == _bam_oracle(path, header, region)
    assert second != first


def test_chunk_cache_budget_evicts_lru():
    for cls in (ChunkCache, JChunkCache):
        cache = cls(byte_budget=100)
        cache.put(("a",), "A", 60)
        cache.put(("b",), "B", 30)
        assert cache.get(("a",)) == "A"          # b becomes the LRU
        cache.put(("c",), "C", 40)
        assert cache.get(("b",)) is None
        assert cache.bytes_used <= 100
        cache.put(("huge",), "X", 1000)          # over the whole budget
        assert cache.get(("huge",)) is None
        assert cache.stats()["evictions"] >= 1


def test_chunk_cache_single_flight_and_uncached_cost():
    """A compute returning cost None is served, not cached, in both."""
    for cls in (ChunkCache, JChunkCache):
        cache = cls(1 << 20)
        calls = []

        def compute():
            calls.append(1)
            return ("v", None)
        assert cache.get_or_compute(("k",), compute) == "v"
        assert cache.get_or_compute(("k",), compute) == "v"
        assert len(calls) == 2 and len(cache) == 0
        assert cache.get_or_compute(("j",), lambda: ("w", 8)) == "w"
        assert cache.get_or_compute(("j",), compute) == "w"
        assert cache.contains(("j",)) and not cache.contains(("k",))


def test_chunk_cache_rejects_bad_budget():
    _same_error(lambda: ChunkCache(byte_budget=0),
                lambda: JChunkCache(byte_budget=0))


def test_file_identity_changes_with_content(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"one")
    a = file_identity(p)
    assert a == jfile_identity(p)
    p.write_bytes(b"three!")
    st = os.stat(p)
    os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert file_identity(p) != a
    assert file_identity(p) == jfile_identity(p)
    with pytest.raises(FileNotFoundError):
        file_identity(tmp_path / "missing.bin")


# ---------------------------------------------------------------------------
# admission control and deadlines
# ---------------------------------------------------------------------------

def test_admission_rejects_when_saturated():
    for cls, m in ((QueryScheduler, METRICS), (JScheduler, JMETRICS)):
        sched = cls(max_in_flight=1, queue_depth=0)
        before = m.get("query.rejected")
        with sched.admit():
            assert sched.in_flight == 1
            with pytest.raises(Exception) as e:
                with sched.admit():
                    pass
            assert type(e.value).__name__ == "TransientIOError"
            assert e.value.retry_after_s == 0.1
        assert m.get("query.rejected") == before + 1
        with sched.admit():
            pass


def test_admission_wait_deadline_expires_with_injected_clock():
    for cls in (QueryScheduler, JScheduler):
        t = [0.0]

        def clock():
            t[0] += 0.5              # every look at the clock advances it
            return t[0]

        sched = cls(max_in_flight=1, queue_depth=4, default_deadline_s=1.0,
                    clock=clock)
        with sched.admit():
            with pytest.raises(Exception) as e:
                with sched.admit():
                    pass
            assert type(e.value).__name__ == "TransientIOError"


def test_query_deadline_raises_transient(indexed_bam):
    path, _header = indexed_bam
    t = QueryEngine(device="cpu",
                    scheduler=QueryScheduler(default_deadline_s=0.0))
    j = JQueryEngine(scheduler=JScheduler(default_deadline_s=0.0))
    g, _ = _same_error(
        lambda: t.query_records([QueryRequest(path, "chr1:1-100")]),
        lambda: j.query_records([JRequest(path, "chr1:1-100")]))
    assert isinstance(g, terr.TransientIOError)
    assert METRICS.get("query.deadline_exceeded") == 1 == \
        JMETRICS.get("query.deadline_exceeded")
    assert METRICS.get("query.deadline_misses") == \
        JMETRICS.get("query.deadline_misses")


def test_per_request_deadline_override(indexed_bam):
    path, _header = indexed_bam
    t, j = _engines()
    g, _ = _same_error(
        lambda: t.query_records(
            [QueryRequest(path, "chr1:1-100", deadline_s=0.0)]),
        lambda: j.query_records(
            [JRequest(path, "chr1:1-100", deadline_s=0.0)]))
    assert isinstance(g, terr.TransientIOError)


@pytest.mark.parametrize("kw", [{"max_in_flight": 0}, {"queue_depth": -1},
                                {"default_deadline_s": -1.0}])
def test_scheduler_bad_parameters_are_plan_errors(kw):
    g, _ = _same_error(lambda: QueryScheduler(**kw),
                       lambda: JScheduler(**kw))
    assert isinstance(g, terr.PlanError)


def test_query_config_fields_carry_over():
    ref = dataclasses.replace(JAX_CONFIG, query_cache_bytes=1 << 20,
                              query_max_in_flight=2, query_queue_depth=3,
                              query_deadline_s=4.0,
                              query_chunk_bytes=1 << 17,
                              query_tile_records=128)
    cfg = config_from_dict(dataclasses.asdict(ref))
    eng = QueryEngine(config=cfg, device="cpu")
    assert (eng.cache.byte_budget, eng.scheduler.max_in_flight,
            eng.scheduler.queue_depth, eng.scheduler.default_deadline_s) \
        == (1 << 20, 2, 3, 4.0)
    assert (cfg.query_chunk_bytes, cfg.query_tile_records) == \
        (1 << 17, 128)
    d = config_from_dict(dataclasses.asdict(JAX_CONFIG))
    assert (d.query_cache_bytes, d.query_max_in_flight, d.query_queue_depth,
            d.query_deadline_s, d.query_chunk_bytes,
            d.query_tile_records) == (256 << 20, 8, 32, None, 1 << 20, 8192)


# ---------------------------------------------------------------------------
# bad requests
# ---------------------------------------------------------------------------

def test_missing_index_is_plan_error(tmp_path):
    from hadoop_bam_tpu.formats.bamio import BamWriter

    path = str(tmp_path / "noindex.bam")
    header = make_header(1)
    with BamWriter(path, header) as w:
        for r in _coord_sorted(header, make_records(header, 20, seed=5)):
            w.write_sam_record(r)
    t, j = _engines()
    g, _ = _same_error(
        lambda: t.query_records([QueryRequest(path, "chr1:1-100")]),
        lambda: j.query_records([JRequest(path, "chr1:1-100")]))
    assert isinstance(g, terr.PlanError) and "bai" in str(g)


def test_unknown_contig_and_container_are_plan_errors(indexed_bam,
                                                      tmp_path):
    path, _header = indexed_bam
    t, j = _engines()
    g, _ = _same_error(
        lambda: t.query_records([QueryRequest(path, "chrZ:1-100")]),
        lambda: j.query_records([JRequest(path, "chrZ:1-100")]))
    assert "reference dictionary" in str(g)
    other = tmp_path / "x.fastq"
    other.write_text("@r\nACGT\n+\n!!!!\n")
    g, _ = _same_error(
        lambda: t.query_records([QueryRequest(str(other), "chr1:1-100")]),
        lambda: j.query_records([JRequest(str(other), "chr1:1-100")]))
    assert "region-query" in str(g)


@pytest.mark.parametrize("name,item", [("q.vcf.gz", "tbi"),
                                       ("q.bcf", "tbi"),
                                       ("q.cram", "item 13a")])
def test_variant_and_cram_kinds_raise_plan_error(tmp_path, name, item):
    """A VCF or BCF with no ``.tbi`` raises PlanError naming the sidecar,
    as the reference does (tests/test_torch_query_variant.py queries
    them).  CRAM is a deliberate difference: the reference queries it;
    the port raises PlanError naming the roadmap item that brings it."""
    p = tmp_path / name
    if name == "q.cram":
        p.write_bytes(b"\x00" * 64)
    else:
        from hadoop_bam_tpu.api.writers import open_vcf_writer
        from hadoop_bam_tpu.formats.vcf import VCFHeader, VcfRecord
        header = VCFHeader.from_text(
            "##fileformat=VCFv4.2\n##contig=<ID=chr1,length=1000>\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        with open_vcf_writer(str(p), header) as w:
            w.write_record(VcfRecord.from_line(
                "chr1\t5\t.\tA\tC\t.\tPASS\t."))
    with pytest.raises(terr.PlanError, match=item):
        QueryEngine(device="cpu").query_records(
            [QueryRequest(str(p), "chr1:1-100")])


def test_entry_points_need_a_card_unless_told(indexed_bam, monkeypatch):
    from hadoop_bam_torch.api import query_regions
    path, _header = indexed_bam
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        QueryEngine()
    with pytest.raises(RuntimeError):
        query_regions(path, ["chr1:1-100"])


# ---------------------------------------------------------------------------
# faults through the classified retry policy
# ---------------------------------------------------------------------------

def test_transient_chunk_faults_heal_under_retry(indexed_bam):
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch.utils import resilient as trs

    path, header = indexed_bam
    cfg = dataclasses.replace(JAX_CONFIG, span_retries=3,
                              retry_backoff_base_s=0.001,
                              retry_backoff_max_s=0.002)
    t, j = _engines(cfg)
    _query((t, j), path, ["chr1:1-2000"])
    region = "chr2:1-120000"
    got = []
    for eng, rs, req in ((t, trs, QueryRequest), (j, jrs, JRequest)):
        with rs.chaos_on(path, [rs.FaultSpec("transient", at_read=0,
                                             count=2)]):
            got.append(_lines(eng.query_records([req(path, region)])))
    assert got[0] == got[1] == [_bam_oracle(path, header, region)]
    assert METRICS.get("pipeline.transient_retries") == \
        JMETRICS.get("pipeline.transient_retries") > 0


def test_corrupt_chunk_fails_fast(indexed_bam):
    from hadoop_bam_tpu.utils import resilient as jrs
    from hadoop_bam_torch.utils import resilient as trs

    path, _header = indexed_bam
    cfg = dataclasses.replace(JAX_CONFIG, span_retries=3,
                              retry_backoff_base_s=0.001,
                              retry_backoff_max_s=0.002)
    t, j = _engines(cfg)
    _query((t, j), path, ["chr1:1-2000"])
    region = "chr2:200000-400000"
    errs = []
    for eng, rs, req in ((t, trs, QueryRequest), (j, jrs, JRequest)):
        with rs.chaos_on(path, [rs.FaultSpec("bitflip", at_read=0,
                                             count=64, xor_mask=0xFF)]):
            with pytest.raises((jerr.CorruptDataError, ValueError)) as e:
                eng.query_records([req(path, region)])
            errs.append(e.value)
    assert terr.classify_error(errs[0]) == jerr.classify_error(errs[1])
    assert METRICS.get("pipeline.transient_retries") == 0 == \
        JMETRICS.get("pipeline.transient_retries")
