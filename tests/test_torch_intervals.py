"""The port's interval filter (``bam_intervals``) against the JAX
package's, on the CPU: the parser, the overlap rule (pos + CIGAR
reference span), the reference-span column, and both drivers on the
native, zlib and device-named planes (the device plane is gated off
with intervals, in both packages), on tests/test_intervals.py's
fixtures.

Tolerances: flagstat counters, n_reads and base_hist are equal;
mean_gc / mean_qual agree within rtol 1e-6 (f32 against f64 partial
sums, in other orders).
"""
import dataclasses
import os

import numpy as np
import pytest

from hadoop_bam_tpu import resilience as jres
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats.bam import BamBatch as JBamBatch
from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.formats.sam import SamRecord
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.split import intervals as jiv
from hadoop_bam_torch import resilience as tres
from hadoop_bam_torch.config import config_from_dict
from hadoop_bam_torch.formats.bam import BamBatch
from hadoop_bam_torch.formats.bamio import read_bam_header
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.plan.executor import select_plane
from hadoop_bam_torch.split import intervals as tiv
from hadoop_bam_torch.split.planners import plan_bam_spans
from hadoop_bam_torch.utils import resilient as trs
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.metrics import METRICS

from fixtures import make_header, make_records

GEOM = jp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)
TGEOM = tp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)


@pytest.fixture(autouse=True)
def _pristine():
    for res in (tres, jres):
        res.reset()
        res.chaos.clear_fault_points()
    METRICS.reset()
    yield
    for res in (tres, jres):
        res.reset()


def _write(path, header, recs):
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    return path


def _cfg(**kw):
    return dataclasses.replace(JAX_CONFIG, **kw)


def _both(driver, path, jcfg, **kw):
    """(port result, reference result) of one driver call."""
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    if driver == "flagstat":
        return (tp.flagstat_file(path, device="cpu", config=tcfg, **kw),
                jp.flagstat_file(path, config=jcfg, **kw))
    return (tp.seq_stats_file(path, device="cpu", config=tcfg,
                              geometry=TGEOM, **kw),
            jp.seq_stats_file(path, config=jcfg, geometry=GEOM, **kw))


def _same(got, want):
    g, w = dict(got), dict(want)
    for d in (g, w):       # entries land in completion order
        if "quarantine" in d:
            d["quarantine"] = sorted(
                ({k: v for k, v in e.items() if k != "error"}
                 for e in d["quarantine"]), key=lambda e: e["span_start"])
    assert set(g) == set(w)
    for k, v in w.items():
        if k == "base_hist":
            np.testing.assert_array_equal(g[k], np.asarray(v))
        elif k in ("mean_gc", "mean_qual"):
            np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=k)
        else:
            assert g[k] == v, k


# ---------------------------------------------------------------------------
# the parser (tests/test_intervals.py:26-50)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text,expect", [
    ("chr1", ("chr1", 1, (1 << 31) - 1)),
    ("chr1:500", ("chr1", 500, 500)),
    ("chr1:500-", ("chr1", 500, (1 << 31) - 1)),
    ("chr1:500-900", ("chr1", 500, 900)),
    ("chr1:1,000-2,000", ("chr1", 1000, 2000)),
])
def test_parse_interval(text, expect):
    got, ref = tiv.parse_interval(text), jiv.parse_interval(text)
    assert (got.rname, got.start, got.end) == \
        (ref.rname, ref.start, ref.end) == expect
    assert str(got) == str(ref)


@pytest.mark.parametrize("text", ["chr1:9-3", "chr1:0-5", "chr1:abc", ""])
def test_parse_interval_errors(text):
    with pytest.raises(tiv.IntervalError):
        tiv.parse_interval(text)
    with pytest.raises(jiv.IntervalError):
        jiv.parse_interval(text)
    assert issubclass(tiv.IntervalError, ValueError)


def test_parse_intervals_lists_and_colon_contigs():
    for iv in (tiv, jiv):
        assert len(iv.parse_intervals("chr1:1-10, chr2 ,chr3:5")) == 3
        got = iv.parse_intervals("HLA-A*01:01",
                                 ref_names=["chr1", "HLA-A*01:01"])
        assert [(i.rname, i.start) for i in got] == [("HLA-A*01:01", 1)]
        r = iv.resolve_interval("HLA-A*01:01:5-9",
                                ref_names=["chr1", "HLA-A*01:01"])
        assert (r.rname, r.start, r.end) == ("HLA-A*01:01", 5, 9)


# ---------------------------------------------------------------------------
# records with known spans (tests/test_intervals.py:71, :150)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def known(tmp_path_factory):
    """a: 100-149; b: 200-249 (a deletion extends it); c: 300-309 (a soft
    clip does not); d on chr2; e an unmapped read with a '*' CIGAR."""
    header = make_header()
    recs = [
        SamRecord("a", 0, "chr1", 100, 60, "50M", "*", 0, 0, "A" * 50,
                  "I" * 50),
        SamRecord("b", 0, "chr1", 200, 60, "10M30D10M", "*", 0, 0,
                  "A" * 20, "I" * 20),
        SamRecord("c", 0, "chr1", 300, 60, "40S10M", "*", 0, 0, "A" * 50,
                  "I" * 50),
        SamRecord("d", 0, "chr2", 100, 60, "50M", "*", 0, 0, "A" * 50,
                  "I" * 50),
        SamRecord("e", 4, "*", 0, 0, "*", "*", 0, 0, "A" * 30, "I" * 30),
    ]
    return _write(str(tmp_path_factory.mktemp("tiv") / "k.bam"), header,
                  recs)


@pytest.mark.parametrize("iv,n", [
    ("chr1:140-199", 1), ("chr1:150-199", 0), ("chr1:249-249", 1),
    ("chr1:310-400", 0), ("chr1:309-400", 1), ("chr2", 1),
    ("chr1:100-300,chr2", 4)])
@pytest.mark.parametrize("backend", ["native", "zlib"])
def test_interval_filtering_exact_overlap(known, iv, n, backend):
    cfg = _cfg(bam_intervals=iv, inflate_backend=backend)
    got, ref = _both("flagstat", known, cfg)
    assert got == ref
    assert got["total"] == n


def test_reference_span_column(tmp_path):
    """M/I/S/N mixes and a '*' CIGAR falling back to l_seq: the port's
    column equals the reference's on the same inflated bytes."""
    header = make_header()
    recs = [
        SamRecord("a", 0, "chr1", 10, 60, "10M5I10M", "*", 0, 0, "A" * 25,
                  "I" * 25),
        SamRecord("b", 0, "chr1", 10, 60, "5S10M100N10M", "*", 0, 0,
                  "A" * 25, "I" * 25),
        SamRecord("c", 4, "*", 0, 0, "*", "*", 0, 0, "A" * 30, "I" * 30),
        SamRecord("d", 0, "chr1", 10, 60, "3=2X4M1D", "*", 0, 0, "A" * 9,
                  "I" * 9),
    ]
    path = _write(str(tmp_path / "rs.bam"), header, recs)
    (span,) = plan_bam_spans(path, num_spans=1)
    data, offs, _, _ = tp._decode_span_core(path, span, False, "native")
    th, _ = read_bam_header(path)
    got = BamBatch(data, offs, header=th)
    ref = JBamBatch(data, offs, header=header)
    assert list(got.reference_span()) == list(ref.reference_span()) == \
        [20, 120, 30, 10]
    for col in ("refid", "pos", "n_cigar", "l_seq", "cigar_offset"):
        np.testing.assert_array_equal(getattr(got, col), getattr(ref, col))
    ivs = tiv.parse_intervals("chr1:130-135")
    np.testing.assert_array_equal(
        tiv.batch_overlap_mask(got, ivs, th),
        jiv.batch_overlap_mask(ref, jiv.parse_intervals("chr1:130-135"),
                               header))


# ---------------------------------------------------------------------------
# the drivers on every plane (tests/test_intervals.py:52, :100, :168)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bulk(tmp_path_factory):
    header = make_header()
    recs = make_records(header, 3000, seed=31)
    path = _write(str(tmp_path_factory.mktemp("tiv") / "b.bam"), header,
                  recs)
    return path, recs


def test_bulk_matches_bruteforce(bulk):
    """tests/test_intervals.py:100: the port's count equals a brute-force
    overlap over the generating records and the reference's."""
    from hadoop_bam_tpu.tools.cli import _alen
    path, recs = bulk
    iv = "chr1:200000-600000,chr3:1-50000"
    expect = 0
    for r in recs:
        end = r.pos + max(1, _alen(r)) - 1
        expect += (r.rname == "chr1" and r.pos <= 600000 and end >= 200000) \
            or (r.rname == "chr3" and r.pos <= 50000)
    got, ref = _both("flagstat", path, _cfg(bam_intervals=iv))
    assert got == ref and got["total"] == expect > 0


@pytest.mark.parametrize("backend", ["native", "zlib", "device"])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_drivers_honour_intervals_on_every_plane(bulk, driver, backend):
    """Both drivers, each plane name: the port equals the reference and
    counts a strict subset; with "device" named, select_plane sends the
    run to a host plane and says why."""
    path, recs = bulk
    iv = "chr1:1000-400000,chr2"
    cfg = _cfg(bam_intervals=iv, inflate_backend=backend)
    got, ref = _both(driver, path, cfg)
    _same(got, ref)
    key = "total" if driver == "flagstat" else "n_reads"
    assert 0 < got[key] < len(recs)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    d = select_plane(tcfg, intervals=tiv.parse_intervals(iv))
    assert d.plane == ("zlib" if backend == "zlib" else "native")
    if backend == "device":
        assert dict(d.rejected)["device"].startswith("interval filtering")


def test_intervals_with_skip_bad_spans(bulk, tmp_path):
    """An interval filter and quarantine in one run: the corrupt span is
    skipped and the rest filtered, as in the reference."""
    from hadoop_bam_torch.synth import flip_block
    path, _ = bulk
    spans = plan_bam_spans(path, num_spans=4)
    bad = str(tmp_path / "bad.bam")
    flip_block(path, bad, (spans[1].start[0] + spans[1].end[0]) // 2)
    cfg = _cfg(bam_intervals="chr1,chr3:1-2000000", skip_bad_spans=True)
    from hadoop_bam_tpu.split.planners import plan_bam_spans as jplan
    got = tp.flagstat_file(bad, device="cpu", spans=spans,
                           config=config_from_dict(dataclasses.asdict(cfg)))
    ref = jp.flagstat_file(bad, config=cfg, spans=jplan(path, num_spans=4))
    _same(got, ref)
    assert len(got["quarantine"]) == 1


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_unknown_contig(bulk, driver, skip):
    """A contig missing from the header raises IntervalError inside the
    span decode in both packages (a CORRUPT class there: every span
    fails on both host planes), or, under skip_bad_spans, quarantines
    every span, as the reference does."""
    path, _ = bulk
    cfg = _cfg(bam_intervals="chrX:1-100", skip_bad_spans=skip)
    if not skip:
        with pytest.raises(tiv.IntervalError):
            _both(driver, path, cfg)
        with pytest.raises(jiv.IntervalError):
            jp.flagstat_file(path, config=cfg)
        return
    from hadoop_bam_tpu.split.planners import plan_bam_spans as jplan
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    tspans, jspans = plan_bam_spans(path, num_spans=4), jplan(path,
                                                              num_spans=4)
    if driver == "flagstat":
        got = tp.flagstat_file(path, device="cpu", config=tcfg, spans=tspans)
        ref = jp.flagstat_file(path, config=cfg, spans=jspans)
    else:
        got = tp.seq_stats_file(path, device="cpu", config=tcfg,
                                spans=tspans, geometry=TGEOM)
        ref = jp.seq_stats_file(path, config=cfg, spans=jspans,
                                geometry=GEOM)
    _same(got, ref)
    assert len(got["quarantine"]) == 4 and \
        {e["error_class"] for e in got["quarantine"]} == {"corrupt"}


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_bad_interval_string_is_a_plan_error(bulk, driver):
    """A string that does not parse: PlanError in the port (as the
    reference's planner makes it), IntervalError from the reference's
    drivers; a ValueError either way, never quarantined."""
    path, _ = bulk
    cfg = _cfg(bam_intervals="chr1:9-3", skip_bad_spans=True)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    fn = tp.flagstat_file if driver == "flagstat" else tp.seq_stats_file
    with pytest.raises(PlanError, match="bad bam_intervals"):
        fn(path, device="cpu", config=tcfg)
    with pytest.raises(ValueError):
        (jp.flagstat_file if driver == "flagstat"
         else jp.seq_stats_file)(path, config=cfg)


def test_span_mode_refuses_intervals(bulk):
    """mode="span" has no interval filter in either package's drivers:
    the port raises PlanError rather than count every record."""
    path, _ = bulk
    cfg = config_from_dict({"bam_intervals": "chr2"})
    with pytest.raises(PlanError, match="span"):
        tp.flagstat_file(path, device="cpu", config=cfg, mode="span")
    assert tp.flagstat_file(path, device="cpu", config=cfg)["total"] > 0


def test_dataset_surface_takes_intervals_and_quarantine(bulk, tmp_path):
    """open_bam(...).flagstat() / .seq_stats() carry the config's
    intervals and pass ``quarantine=`` through to the drivers."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.synth import flip_block
    path, _ = bulk
    bad = str(tmp_path / "bad.bam")
    flip_block(path, bad, os.path.getsize(path) // 2)
    cfg = config_from_dict({"bam_intervals": "chr2", "skip_bad_spans": True})
    ds = open_bam(bad, device="cpu", config=cfg)
    tq = trs.QuarantineManifest()
    got = ds.flagstat(quarantine=tq)
    assert got == tp.flagstat_file(bad, device="cpu", config=cfg)
    assert len(tq) == len(got["quarantine"]) >= 1
    sq = trs.QuarantineManifest()
    stats = ds.seq_stats(quarantine=sq)
    assert stats["n_reads"] == got["total"]
    assert sq.to_dicts() == stats["quarantine"] == tq.to_dicts()


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from hadoop_bam_torch.synth import write_synthetic_bam
    regions = ("chr20:1-13000000", "chr21", "chr20:30000000",
               "chr21:1-5000000,chr20:60000000-")
    path = str(tmp_path_factory.mktemp("tsy") / "s.bam")
    return path, write_synthetic_bam(path, 6000, 5, regions=regions)


def test_synth_region_truth_matches_the_reference(synth):
    """``synth.region_mask`` parses its regions itself (the truth the
    card's interval checks hold the port to must not share the port's
    parser): each region's truth equals the reference's interval
    flagstat, and an unknown contig raises."""
    from hadoop_bam_torch.synth import region_mask
    path, truth = synth
    for region, t in truth.regions.items():
        ref = jp.flagstat_file(path, config=_cfg(bam_intervals=region))
        assert t.flagstat == ref, region
        assert t.n_reads == ref["total"]
    assert 0 < truth.regions["chr20:1-13000000"].n_reads < truth.n_reads
    with pytest.raises(ValueError):
        region_mask("chrX:1-10", np.zeros(1, np.int32), np.zeros(1, np.int32))
