"""The port's span planning against the JAX package's, on the CPU: the
splitting index (``.splitting-bai`` / ``.sbi``), index-snapped and
guessed plans, ``keep_paired_reads_together``, the plan memo, the BAI
and CSI indexes and ``.bai`` interval trimming, on the fixtures of
tests/test_split.py, tests/test_intervals.py and tests/test_write.py.

Plans are compared exactly (``to_dict`` lists); sidecar files byte for
byte; driver results exactly (flagstat counters, n_reads, base_hist),
with mean_gc / mean_qual within rtol 1e-6 (f32 against f64 partial
sums, in other orders).  Every test clears both packages' plan memos
and writes its sidecars next to its own copy of a fixture.
"""
import dataclasses
import os
import random
import shutil

import numpy as np
import pytest

from hadoop_bam_tpu import resilience as jres
from hadoop_bam_tpu.api.dataset import open_bam as jopen
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.formats.sam import SamRecord
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.split import bai as jbai
from hadoop_bam_tpu.split import planners as jpl
from hadoop_bam_tpu.split import splitting_index as jsi
from hadoop_bam_tpu.utils.metrics import METRICS as JMETRICS
from hadoop_bam_torch import resilience as tres
from hadoop_bam_torch.api import open_bam
from hadoop_bam_torch.config import config_from_dict
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bamio import read_bam_header
from hadoop_bam_torch.ops import inflate as inflate_ops
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.split import bai as tbai
from hadoop_bam_torch.split import planners as tpl
from hadoop_bam_torch.split import splitting_index as tsi
from hadoop_bam_torch.split.intervals import parse_intervals
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.seekable import as_byte_source

from fixtures import make_header, make_records

GEOM = jp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)
TGEOM = tp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)


@pytest.fixture(autouse=True)
def _pristine():
    for res in (tres, jres):
        res.reset()
        res.chaos.clear_fault_points()
    tpl.clear_plan_cache()
    jpl._PLAN_CACHE.clear()
    METRICS.reset()
    JMETRICS.reset()
    yield
    tpl.clear_plan_cache()
    jpl._PLAN_CACHE.clear()
    for res in (tres, jres):
        res.reset()


def _write(path, header, recs):
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    return path


@pytest.fixture(scope="module")
def unsorted_bam(tmp_path_factory):
    """3000 records in generation order, with every record's voffset
    (the reference's reader) and name."""
    header = make_header()
    recs = make_records(header, 3000, seed=11)
    path = _write(str(tmp_path_factory.mktemp("plan") / "u.bam"), header,
                  recs)
    voffs = [int(v) for s in jpl.plan_bam_spans(path, num_spans=1)
             for v in jpl.read_bam_span(path, s).voffsets]
    return path, header, recs, voffs


@pytest.fixture(scope="module")
def sorted_bam(tmp_path_factory):
    """4000 coordinate-sorted records (tests/test_intervals.py
    ``_sorted_bam``)."""
    header = make_header()
    recs = make_records(header, 4000, seed=17)
    rid = {name: i for i, name in enumerate(header.ref_names)}
    recs.sort(key=lambda r: (rid.get(r.rname, 1 << 30), r.pos))
    path = _write(str(tmp_path_factory.mktemp("plan") / "s.bam"), header,
                  recs)
    return path, header, recs


def _copy(path, tmp_path, name="c.bam"):
    """The fixture under this test's own directory: sidecars written next
    to it are this test's alone."""
    out = str(tmp_path / name)
    shutil.copyfile(path, out)
    return out


def _d(spans):
    return [s.to_dict() for s in spans]


def _tcfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _si(idx):
    return (idx.voffsets, idx.granularity, idx.total_records)


def _jheader(path):
    from hadoop_bam_tpu.formats.bamio import read_bam_header as jread
    return jread(path)[0]


# ---------------------------------------------------------------------------
# the splitting index (tests/test_split.py:75, :143)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gran", [1, 16, 100, 4096])
def test_splitting_index_build_and_roundtrip(unsorted_bam, gran):
    path, _, recs, voffs = unsorted_bam
    got = tsi.build_splitting_index(path, granularity=gran)
    want = jsi.build_splitting_index(path, granularity=gran)
    assert _si(got) == _si(want)
    assert got.total_records == len(recs)
    assert got.voffsets[:-1] == voffs[::gran]
    assert got.end_voffset == os.path.getsize(path) << 16
    assert got.to_splitting_bai_bytes() == want.to_splitting_bai_bytes()
    assert got.to_sbi_bytes(12345) == want.to_sbi_bytes(12345)
    legacy = tsi.SplittingIndex.from_bytes(want.to_splitting_bai_bytes())
    assert legacy.voffsets == got.voffsets
    sbi = tsi.SplittingIndex.from_bytes(want.to_sbi_bytes(12345))
    assert (sbi.voffsets, sbi.granularity, sbi.total_records) == \
        (got.voffsets, gran, len(recs))
    assert got.span_bounds(0, 1 << 20) == want.span_bounds(0, 1 << 20)


@pytest.mark.parametrize("flavor", ["splitting-bai", "sbi"])
def test_sidecar_writers_byte_identical(unsorted_bam, tmp_path, flavor):
    path, _, _, _ = unsorted_bam
    mine = _copy(path, tmp_path, "t.bam")
    theirs = _copy(path, tmp_path, "j.bam")
    a = tsi.write_splitting_index(mine, granularity=64, flavor=flavor)
    b = jsi.write_splitting_index(theirs, granularity=64, flavor=flavor)
    assert a == mine + "." + flavor and b == theirs + "." + flavor
    assert open(a, "rb").read() == open(b, "rb").read()
    assert _si(tsi.SplittingIndex.load_for(mine)) == \
        _si(jsi.SplittingIndex.load_for(theirs))


def test_load_for_prefers_splitting_bai(unsorted_bam, tmp_path):
    path = _copy(unsorted_bam[0], tmp_path)
    assert tsi.SplittingIndex.load_for(path) is None
    tsi.write_splitting_index(path, granularity=50, flavor="sbi")
    assert tsi.SplittingIndex.load_for(path).granularity == 50
    tsi.write_splitting_index(path, granularity=70)
    assert tsi.SplittingIndex.load_for(path).granularity == 0  # legacy
    assert _si(tsi.SplittingIndex.load_for(path)) == \
        _si(jsi.SplittingIndex.load_for(path))


@pytest.mark.parametrize("num_spans", [1, 2, 7, 16, 64])
@pytest.mark.parametrize("use_index", [False, True])
def test_span_union_exactly_once(unsorted_bam, num_spans, use_index):
    """Every record in exactly one span, with and without an index, and
    the plan equals the reference's."""
    path, header, recs, voffs = unsorted_bam
    tidx = tsi.build_splitting_index(path, granularity=16) \
        if use_index else None
    jidx = jsi.build_splitting_index(path, granularity=16) \
        if use_index else None
    spans = tpl.plan_bam_spans(path, num_spans=num_spans, index=tidx)
    assert _d(spans) == _d(jpl.plan_bam_spans(path, num_spans=num_spans,
                                              index=jidx))
    got_voffs, got_names = [], []
    for span in spans:
        batch = tpl.read_bam_span(path, span)
        got_voffs.extend(int(v) for v in batch.voffsets)
        got_names.extend(batch.read_name(i) for i in range(len(batch)))
    assert got_voffs == voffs
    assert got_names == [r.qname for r in recs]


@pytest.mark.parametrize("flavor", ["splitting-bai", "sbi"])
def test_plan_follows_sidecar(unsorted_bam, tmp_path, flavor):
    path = _copy(unsorted_bam[0], tmp_path)
    tsi.write_splitting_index(path, granularity=50, flavor=flavor)
    sampled = set(tsi.SplittingIndex.load_for(path).voffsets)
    for n in (3, 8, 40):
        spans = tpl.plan_bam_spans(path, num_spans=n)
        assert _d(spans) == _d(jpl.plan_bam_spans(path, num_spans=n))
        assert all(s.start_voffset in sampled for s in spans[1:])
    # use_splitting_index=False guesses, as the reference does
    off = dataclasses.replace(JAX_CONFIG, use_splitting_index=False)
    assert _d(tpl.plan_bam_spans(path, num_spans=8, config=_tcfg(off))) == \
        _d(jpl.plan_bam_spans(path, num_spans=8, config=off))


@pytest.mark.parametrize("split_size", [1 << 12, 1 << 15, 128 << 20])
def test_split_size_plans_equal_reference(unsorted_bam, split_size):
    path = unsorted_bam[0]
    cfg = dataclasses.replace(JAX_CONFIG, split_size=split_size)
    assert _d(tpl.plan_bam_spans(path, config=_tcfg(cfg))) == \
        _d(jpl.plan_bam_spans(path, config=cfg))


# ---------------------------------------------------------------------------
# keep_paired_reads_together (tests/test_intervals.py:120)
# ---------------------------------------------------------------------------

def _paired_bam(path):
    header = make_header()
    recs = []
    for i in range(600):
        for flag in (99, 147):
            recs.append(SamRecord(
                f"pair{i:05d}", flag, "chr1", 1000 + i, 60, "100M",
                "=", 1000 + i, 100, "A" * 100, "I" * 100))
    return _write(path, header, recs), recs


@pytest.mark.parametrize("with_index", [False, True])
def test_keep_paired_reads_together(tmp_path, with_index):
    path, recs = _paired_bam(str(tmp_path / "p.bam"))
    if with_index:
        tsi.write_splitting_index(path, granularity=7)
    jcfg = dataclasses.replace(JAX_CONFIG, keep_paired_reads_together=True,
                               split_size=1 << 16)
    ds = open_bam(path, device="cpu", config=_tcfg(jcfg))
    spans = ds.spans(num_spans=7)
    assert _d(spans) == _d(jopen(path, jcfg).spans(num_spans=7))
    assert len(spans) >= 2
    names = []
    for span in spans:
        b = tpl.read_bam_span(path, span)
        got = [b.read_name(i) for i in range(len(b))]
        names.extend(got)
        assert all(got.count(n) == 2 for n in got), span
    assert names == [r.qname for r in recs]
    # the drivers count every record once
    assert ds.flagstat()["total"] == len(recs)


# ---------------------------------------------------------------------------
# the plan memo (tests/test_split.py:209)
# ---------------------------------------------------------------------------

def test_plan_spans_cached_semantics(tmp_path):
    header = make_header()
    path = _write(str(tmp_path / "c.bam"), header,
                  make_records(header, 800, seed=4))
    cfg = _tcfg(JAX_CONFIG)
    hdr, _ = read_bam_header(path)
    fresh = list(tpl.plan_spans_maybe_intervals(path, hdr, cfg, 4))
    assert _d(fresh) == _d(jpl.plan_spans_maybe_intervals(
        path, _jheader(path), JAX_CONFIG, num_spans=4))
    a = list(tpl.plan_spans_cached(path, hdr, cfg, num_spans=4))
    assert _d(a) == _d(fresh) == _d(jpl.plan_spans_cached(
        path, _jheader(path), JAX_CONFIG, num_spans=4))
    b = tpl.plan_spans_cached(path, hdr, cfg, num_spans=4)
    assert isinstance(b, list) and _d(b) == _d(fresh)    # a hit
    b.clear()                             # a copy: the memo keeps its own
    assert _d(tpl.plan_spans_cached(path, hdr, cfg, num_spans=4)) == \
        _d(fresh)
    c = list(tpl.plan_spans_cached(path, hdr, cfg, num_spans=2))
    assert len(c) <= len(fresh)           # another request, another key
    # a rewritten file plans again
    _write(path, header, make_records(header, 100, seed=5))
    os.utime(path)
    hdr2, _ = read_bam_header(path)
    d = tpl.plan_spans_cached(path, hdr2, cfg, num_spans=4)
    assert not isinstance(d, list)        # a miss streams
    assert _d(d) == _d(tpl.plan_spans_maybe_intervals(path, hdr2, cfg, 4))


def test_rewritten_sidecar_plans_again(unsorted_bam, tmp_path):
    path = _copy(unsorted_bam[0], tmp_path)
    cfg = _tcfg(JAX_CONFIG)
    guessed = list(tpl.plan_spans_cached(path, None, cfg, num_spans=8))
    assert isinstance(tpl.plan_spans_cached(path, None, cfg, num_spans=8),
                      list)
    tsi.write_splitting_index(path, granularity=300)
    snapped = tpl.plan_spans_cached(path, None, cfg, num_spans=8)
    assert not isinstance(snapped, list)
    snapped = list(snapped)
    assert _d(snapped) == _d(jpl.plan_spans_cached(
        path, _jheader(path), JAX_CONFIG, num_spans=8))
    assert len(snapped) < len(guessed)


def test_abandoned_plan_is_never_stored(unsorted_bam, tmp_path,
                                        monkeypatch):
    """A streamed miss stores its plan only once the stream has ended: a
    closed generator or an exception part way stores nothing."""
    path = _copy(unsorted_bam[0], tmp_path)
    cfg = _tcfg(JAX_CONFIG)
    it = tpl.plan_spans_cached(path, None, cfg, num_spans=10)
    next(it)
    it.close()
    assert tpl._PLAN_CACHE == {}
    calls = [0]
    real = tpl.BAMSplitGuesser.guess_next_record_start

    def failing(self, off):
        calls[0] += 1
        if calls[0] == 4:
            raise OSError("injected read failure")
        return real(self, off)

    monkeypatch.setattr(tpl.BAMSplitGuesser, "guess_next_record_start",
                        failing)
    with pytest.raises(OSError):
        list(tpl.plan_spans_cached(path, None, cfg, num_spans=10))
    assert tpl._PLAN_CACHE == {}
    monkeypatch.setattr(tpl.BAMSplitGuesser, "guess_next_record_start",
                        real)
    whole = list(tpl.plan_spans_cached(path, None, cfg, num_spans=10))
    assert len(tpl._PLAN_CACHE) == 1
    # a hit plans nothing: the guesser is never asked again
    monkeypatch.setattr(tpl.BAMSplitGuesser, "guess_next_record_start",
                        lambda self, off: pytest.fail("guessed on a hit"))
    assert _d(tpl.plan_spans_cached(path, None, cfg, num_spans=10)) == \
        _d(whole)


def test_memo_keeps_32_plans(unsorted_bam, tmp_path):
    path = _copy(unsorted_bam[0], tmp_path)
    cfg = _tcfg(JAX_CONFIG)
    for n in range(1, 35):
        list(tpl.plan_spans_cached(path, None, cfg, num_spans=n))
    assert len(tpl._PLAN_CACHE) == tpl._PLAN_CACHE_MAX == 32
    assert not isinstance(tpl.plan_spans_cached(path, None, cfg, 1), list)


def test_non_path_source_is_not_cached(unsorted_bam):
    cfg = dataclasses.replace(_tcfg(JAX_CONFIG), use_splitting_index=False)
    raw = open(unsorted_bam[0], "rb").read()
    got = list(tpl.plan_spans_cached(raw, None, cfg, num_spans=3))
    assert len(got) == 3 and tpl._PLAN_CACHE == {}


def test_drivers_plan_once(unsorted_bam, tmp_path, monkeypatch):
    """A second driver call over an unchanged file hits the memo, and
    gives the same result as the reference's."""
    path = _copy(unsorted_bam[0], tmp_path)
    cfg = _tcfg(JAX_CONFIG)
    first = tp.flagstat_file(path, device="cpu", config=cfg)
    assert len(tpl._PLAN_CACHE) == 1
    monkeypatch.setattr(tpl.BAMSplitGuesser, "guess_next_record_start",
                        lambda self, off: pytest.fail("guessed on a hit"))
    assert tp.flagstat_file(path, device="cpu", config=cfg) == first == \
        jp.flagstat_file(path, config=JAX_CONFIG)


# ---------------------------------------------------------------------------
# BAI and CSI (tests/test_intervals.py:219-315, tests/test_write.py:519)
# ---------------------------------------------------------------------------

def test_reg2bin_and_reg2bins_match_reference():
    rng = random.Random(3)
    for _ in range(500):
        beg = rng.randrange(0, 1 << 29)
        end = beg + rng.choice([1, 2, 151, 1 << 14, 1 << 17, 1 << 21,
                                1 << 26])
        assert tbai.reg2bin(beg, end) == jbai.reg2bin(beg, end)
        assert tbai.reg2bins(beg, end) == jbai.reg2bins(beg, end)
        assert tbai.csi_reg2bins(beg, end, 14, 5) == \
            jbai.csi_reg2bins(beg, end, 14, 5)
    assert tbai.reg2bin(0, 1) == 4681 and tbai.reg2bin(0, 1 << 29) == 0
    b = np.array([0, 5000, 1 << 20], np.int64)
    e = b + np.array([1, 1 << 15, 1 << 27], np.int64)
    np.testing.assert_array_equal(tbai._reg2bin_vec(b, e),
                                  jbai._reg2bin_vec(b, e))


def test_bai_bytes_round_trip_and_query(sorted_bam, tmp_path):
    path = _copy(sorted_bam[0], tmp_path)
    got, want = tbai.build_bai(path), jbai.build_bai(path)
    assert got.to_bytes() == want.to_bytes()
    back = tbai.BaiIndex.from_bytes(want.to_bytes())
    assert back == got
    assert len(back.refs) == len(sorted_bam[1].ref_names)
    for rid in range(3):
        for beg, end in ((0, 1 << 29), (5000, 20000), (1 << 28,
                                                       (1 << 28) + 100)):
            assert back.query(rid, beg, end) == want.query(rid, beg, end)
    assert back.query(0, 1 << 28, (1 << 28) + 100) == []
    assert back.query(7, 0, 100) == [] and back.query(-1, 0, 100) == []
    out = tbai.write_bai(path)
    jout = jbai.write_bai(_copy(path, tmp_path, "j.bam"))
    assert open(out, "rb").read() == open(jout, "rb").read()
    with pytest.raises(ValueError, match="bad magic"):
        tbai.BaiIndex.from_bytes(b"XXXX")


def test_bai_of_unsorted_file_equals_reference(unsorted_bam, tmp_path):
    path = _copy(unsorted_bam[0], tmp_path)
    assert tbai.build_bai(path).to_bytes() == jbai.build_bai(path).to_bytes()


def test_bai_chunk_ends_are_block_aligned(sorted_bam, tmp_path):
    path = _copy(sorted_bam[0], tmp_path)
    header = sorted_bam[1]
    idx = tbai.build_bai(path)
    src = as_byte_source(path)
    n_chunks = 0
    for ref in idx.refs:
        for chunks in ref.bins.values():
            for beg, end in chunks:
                n_chunks += 1
                for c in (beg >> 16, end >> 16):
                    if c < src.size:
                        bgzf.parse_block_header(src.pread(c, 1 << 16), 0)
    assert n_chunks > 0
    ivs = parse_intervals(f"{header.ref_names[0]}:1-100000000",
                          header.ref_names)
    spans = tbai.plan_interval_spans(path, ivs, header, bai=idx)
    assert spans
    for span in spans:
        raw, _, _ = tp._fetch_span_raw(src, span)
        assert int(inflate_ops.block_table(raw)["isize"].sum()) > 0
    src.close()


@pytest.mark.parametrize("seed", range(5))
def test_bai_from_columns_matches_incremental_builder(seed):
    """The port's vectorized build equals the reference's serial
    BAIBuilder byte for byte (tests/test_write.py:519's generator)."""
    rng = random.Random(seed)
    n_ref = rng.randint(1, 4)
    rows = []
    voff = (rng.randrange(1, 1000) << 16) | rng.randrange(100)
    for rid in range(n_ref):
        pos = 0
        for _ in range(rng.randrange(0, 300)):
            pos += rng.randrange(0, 60_000)
            span = rng.choice([1, 50, 151, 20_000, 40_000])
            rows.append((rid, pos, pos + span, voff))
            voff += rng.randrange(1, 90_000)
    for _ in range(rng.randrange(0, 4)):
        rows.append((-1, -1, 0, voff))
        voff += rng.randrange(1, 1000)
    end_v = voff + 37
    cols = np.asarray(rows, np.int64).reshape(-1, 4)
    b = jbai.BAIBuilder(n_ref)
    for rid, beg, end, v in rows:
        b.add(rid, beg, end, v)
    serial = b.finalize(end_v).to_bytes()
    vec = tbai.bai_from_columns(n_ref, cols[:, 0], cols[:, 1], cols[:, 2],
                                cols[:, 3].astype(np.uint64), end_v)
    assert vec.to_bytes() == serial


def test_csi_round_trip_and_query_matches_reference(sorted_bam, tmp_path):
    path = _copy(sorted_bam[0], tmp_path)
    tcsi = tbai.CsiIndex.from_bai(tbai.build_bai(path))
    jcsi = jbai.CsiIndex.from_bai(jbai.build_bai(path))
    assert tcsi == tbai.CsiIndex.from_bytes(tcsi.to_bytes())
    theirs = tbai.CsiIndex.from_bytes(jcsi.to_bytes())
    assert theirs == tcsi
    assert (theirs.min_shift, theirs.depth) == (14, 5)
    for rid in range(3):
        for beg, end in ((0, 30000), (5000, 20000), (100000, 200000),
                         (0, 1 << 29)):
            assert tcsi.query(rid, beg, end) == jcsi.query(rid, beg, end)
    with pytest.raises(ValueError, match="bad magic"):
        tbai.CsiIndex.from_bytes(b"NOPE" + b"\0" * 12)


# ---------------------------------------------------------------------------
# .bai / .csi interval trimming (tests/test_intervals.py:287, :315)
# ---------------------------------------------------------------------------

REGIONS = ("chr1:5000-20000", "chr2", "chr1:1-400000,chr3:100-90000")


@pytest.mark.parametrize("sidecar", ["none", "bai", "csi"])
@pytest.mark.parametrize("region", REGIONS)
def test_interval_plans_equal_reference(sorted_bam, tmp_path, sidecar,
                                        region):
    path = _copy(sorted_bam[0], tmp_path)
    if sidecar == "bai":
        tbai.write_bai(path)
    elif sidecar == "csi":
        with open(path + ".csi", "wb") as f:
            f.write(tbai.CsiIndex.from_bai(tbai.build_bai(path)).to_bytes())
    jcfg = dataclasses.replace(JAX_CONFIG, bam_intervals=region)
    hdr = read_bam_header(path)[0]
    got = list(tpl.plan_spans_maybe_intervals(path, hdr, _tcfg(jcfg), 4))
    want = jpl.plan_spans_maybe_intervals(path, _jheader(path), jcfg, 4)
    assert _d(got) == _d(want)
    assert _d(tpl.plan_spans_cached(path, hdr, _tcfg(jcfg), 4)) == \
        _d(jpl.plan_spans_cached(path, _jheader(path), jcfg, 4))
    size = os.path.getsize(path)
    if sidecar == "none":
        assert sum(s.compressed_size for s in got) >= size - (1 << 16)
    else:
        assert sum(s.compressed_size for s in got) < size
    ds = open_bam(path, device="cpu", config=_tcfg(jcfg))
    assert _d(ds.spans()) == _d(jopen(path, jcfg).spans())


@pytest.mark.parametrize("plane", ["native", "zlib", "device"])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_trimmed_drivers_equal_full_scan_and_reference(
        sorted_bam, tmp_path, plane, driver):
    """Both drivers with intervals and a .bai equal their full scans and
    the reference's, on every plane (the device plane is gated off under
    intervals in both packages); the trimmed run reads fewer bytes."""
    path = _copy(sorted_bam[0], tmp_path)
    jcfg = dataclasses.replace(JAX_CONFIG, bam_intervals=REGIONS[0],
                               inflate_backend=plane)
    tcfg = _tcfg(jcfg)

    def run():
        if driver == "flagstat":
            return (tp.flagstat_file(path, device="cpu", config=tcfg),
                    jp.flagstat_file(path, config=jcfg))
        got = tp.seq_stats_file(path, device="cpu", config=tcfg,
                                geometry=TGEOM)
        want = jp.seq_stats_file(path, config=jcfg, geometry=GEOM)
        np.testing.assert_array_equal(got.pop("base_hist"),
                                      want.pop("base_hist"))
        for k in ("mean_gc", "mean_qual"):
            np.testing.assert_allclose(got.pop(k), want.pop(k), rtol=1e-6)
        return got, want

    full, jfull = run()
    assert full == jfull
    full_bytes = METRICS.get("pipeline.inflated_bytes")
    tbai.write_bai(path)
    METRICS.reset()
    trimmed, jtrimmed = run()
    assert trimmed == jtrimmed == full
    assert 0 < METRICS.get("pipeline.inflated_bytes") < full_bytes


def test_dataset_spans_equal_reference(unsorted_bam, tmp_path):
    path = _copy(unsorted_bam[0], tmp_path)
    ds, jds = open_bam(path, device="cpu"), jopen(path)
    assert _d(ds.spans(num_spans=5)) == _d(jds.spans(num_spans=5))
    assert ds.spans() is ds.spans(num_spans=5)
    with pytest.raises(ValueError, match="open a new dataset"):
        ds.spans(num_spans=6)
    with pytest.raises(ValueError):
        jds.spans(num_spans=6)
    tsi.write_splitting_index(path, granularity=200)
    assert _d(open_bam(path, device="cpu").spans(num_spans=5)) == \
        _d(jopen(path).spans(num_spans=5))


# ---------------------------------------------------------------------------
# sidecar-planned drivers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", ["native", "zlib", "device"])
def test_sidecar_planned_drivers_equal_reference(unsorted_bam, tmp_path,
                                                 plane, monkeypatch):
    """Both drivers (and span mode) with a .splitting-bai: the plans snap
    to it in both packages and the results equal the reference's.  The
    device plane's chunk is cut to 2 blocks so that the snapped spans
    overflow it and their remainders take the host fixup."""
    path = _copy(unsorted_bam[0], tmp_path)
    tsi.write_splitting_index(path, granularity=100)
    monkeypatch.setattr(tp, "DEVICE_PLANE_MAX_BLOCKS", 2)
    jcfg = dataclasses.replace(JAX_CONFIG, inflate_backend=plane)
    tcfg = _tcfg(jcfg)
    got = tp.flagstat_file(path, device="cpu", config=tcfg)
    assert got == jp.flagstat_file(path, config=jcfg)
    assert got["total"] == len(unsorted_bam[2])
    assert tp.flagstat_file(path, device="cpu", config=tcfg,
                            mode="span") == got
    s = tp.seq_stats_file(path, device="cpu", config=tcfg, geometry=TGEOM)
    js = jp.seq_stats_file(path, config=jcfg, geometry=GEOM)
    assert s["n_reads"] == js["n_reads"] == got["total"]
    np.testing.assert_array_equal(s["base_hist"], js["base_hist"])
    for k in ("mean_gc", "mean_qual"):
        np.testing.assert_allclose(s[k], js[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# the drivers' grain: long planned spans are cut at record starts
# ---------------------------------------------------------------------------

def _assert_partition(pieces, spans):
    """``pieces`` cut ``spans`` in order: contiguous, each span's start
    and end kept."""
    it = iter(pieces)
    for s in spans:
        p = next(it)
        assert p.start_voffset == s.start_voffset
        while p.end_voffset != s.end_voffset:
            q = next(it)
            assert q.start_voffset == p.end_voffset
            p = q
    assert next(it, None) is None


def _assert_bounded(pieces, spans, grain):
    """A planned span is kept only when it is at most twice the grain;
    a cut piece is at most a grain plus one block (a cut lands on the
    first record start at or after a byte offset)."""
    kept = {(s.start_voffset, s.end_voffset) for s in spans
            if s.compressed_size <= 2 * grain}
    for p in pieces:
        if (p.start_voffset, p.end_voffset) in kept:
            continue
        assert p.compressed_size <= grain + bgzf.MAX_BLOCK_SIZE


@pytest.mark.parametrize("plane", ["native", "zlib"])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_long_trimmed_spans_cut_at_the_grain(sorted_bam, tmp_path, plane,
                                             driver, monkeypatch):
    """A region whose merged .bai chunks pass twice the drivers' grain:
    the memo keeps the reference's trimmed plan, the drivers decode it in
    pieces of at most twice the grain, cut at record starts, and equal
    the full scan and the reference's."""
    grain = 32 << 10
    path = _copy(sorted_bam[0], tmp_path)
    jcfg = dataclasses.replace(JAX_CONFIG, bam_intervals="chr2",
                               inflate_backend=plane)
    tcfg = _tcfg(jcfg)
    hdr = read_bam_header(path)[0]

    def run():
        if driver == "flagstat":
            return (tp.flagstat_file(path, device="cpu", config=tcfg),
                    jp.flagstat_file(path, config=jcfg))
        got = tp.seq_stats_file(path, device="cpu", config=tcfg,
                                geometry=TGEOM)
        want = jp.seq_stats_file(path, config=jcfg, geometry=GEOM)
        np.testing.assert_array_equal(got.pop("base_hist"),
                                      want.pop("base_hist"))
        for k in ("mean_gc", "mean_qual"):
            np.testing.assert_allclose(got.pop(k), want.pop(k), rtol=1e-6)
        return got, want

    full, jfull = run()
    assert full == jfull
    tbai.write_bai(path)
    trimmed = list(tpl.plan_spans_cached(path, hdr, tcfg, 4))
    assert _d(trimmed) == _d(jpl.plan_spans_cached(path, _jheader(path),
                                                   jcfg, 4))
    assert max(s.compressed_size for s in trimmed) > 2 * grain
    pieces = list(tp._plan(path, hdr, 1, grain, tcfg))
    _assert_partition(pieces, trimmed)
    assert len(pieces) > len(trimmed)
    _assert_bounded(pieces, trimmed, grain)
    monkeypatch.setattr(tp, "FLAGSTAT_SPAN_BYTES", grain)
    monkeypatch.setattr(tp, "SEQ_STATS_SPAN_BYTES", grain)
    METRICS.reset()
    got, want = run()
    assert got == want == full
    assert METRICS.get("pipeline.spans") == len(pieces)


def test_coarse_index_span_mode_fits_bytes_cap(unsorted_bam, tmp_path):
    """A splitting index sampled more coarsely than span mode's grain
    (one span over the whole file, inflating past ``bytes_cap``): the
    driver cuts it to the grain instead of refusing the span."""
    path = _copy(unsorted_bam[0], tmp_path)
    cfg = _tcfg(dataclasses.replace(JAX_CONFIG, inflate_backend="native"))
    want = tp.flagstat_file(path, device="cpu", config=cfg, mode="span")
    tsi.write_splitting_index(path, granularity=len(unsorted_bam[2]))
    geom = tp.DecodeGeometry(bytes_cap=1 << 18, records_cap=1 << 12)
    snapped = list(tpl.plan_spans_cached(path, None, cfg, 2))
    assert len(snapped) == 1
    with pytest.raises(tp.PlanError, match="plan smaller spans"):
        tp.decode_span_host(path, snapped[0], geom)
    pieces = list(tp._plan(path, None, 1, geom.bytes_cap // 8, cfg))
    _assert_partition(pieces, snapped)
    _assert_bounded(pieces, snapped, geom.bytes_cap // 8)
    got = tp.flagstat_file(path, device="cpu", config=cfg, mode="span",
                           geometry=geom)
    assert got == want == jp.flagstat_file(path, config=JAX_CONFIG)


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_coarse_index_device_plane_stays_on_device(unsorted_bam, tmp_path,
                                                   driver, monkeypatch):
    """The device plane over a splitting index coarser than its grain:
    the snapped span is cut to the grain, so no chunk overflows the
    plane's block limit into the host fixup, and the results equal the
    reference's."""
    path = _copy(unsorted_bam[0], tmp_path)
    tsi.write_splitting_index(path, granularity=len(unsorted_bam[2]))
    monkeypatch.setattr(tp, "DEVICE_PLANE_SPAN_BYTES", 32 << 10)
    monkeypatch.setattr(tp, "DEVICE_PLANE_MAX_BLOCKS", 4)
    jcfg = dataclasses.replace(JAX_CONFIG, inflate_backend="device")
    tcfg = _tcfg(jcfg)
    chunks = []
    tokenize = tp._tokenize_span_tokens

    def spy(*a, **k):
        c = tokenize(*a, **k)
        chunks.append((c.used, c.n_blocks))
        return c
    monkeypatch.setattr(tp, "_tokenize_span_tokens", spy)
    if driver == "flagstat":
        got = tp.flagstat_file(path, device="cpu", config=tcfg)
        assert got == jp.flagstat_file(path, config=jcfg)
        assert got["total"] == len(unsorted_bam[2])
    else:
        got = tp.seq_stats_file(path, device="cpu", config=tcfg,
                                geometry=TGEOM)
        want = jp.seq_stats_file(path, config=jcfg, geometry=GEOM)
        assert got["n_reads"] == want["n_reads"] == len(unsorted_bam[2])
        np.testing.assert_array_equal(got["base_hist"], want["base_hist"])
        for k in ("mean_gc", "mean_qual"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert len(chunks) > 1
    assert all(used == n for used, n in chunks)


def test_drivers_take_a_byte_source(unsorted_bam):
    """A driver given the file's bytes (no sidecar lookup) plans from
    them, sized as the reference sizes them (``as_byte_source``), and is
    not memoized (the reference's memo key refuses bytes)."""
    raw = open(unsorted_bam[0], "rb").read()
    cfg = _tcfg(dataclasses.replace(JAX_CONFIG, inflate_backend="native",
                                    use_splitting_index=False))
    got = tp.flagstat_file(raw, device="cpu", config=cfg)
    assert tpl._PLAN_CACHE == {}
    assert got == tp.flagstat_file(unsorted_bam[0], device="cpu", config=cfg)
    assert got["total"] == len(unsorted_bam[2])
    assert len(tpl._PLAN_CACHE) == 1
