"""The port's coverage path (K12: ops/cigar.py, the cigar-row host stage
and ``coverage_file``) against the JAX package's, on the CPU.

The same seeded inputs go through both packages; integer results are
compared exactly: every case of tests/test_cigar.py (messy CIGARs with
I/D/N/S/=/X ops, unmapped and '*'-CIGAR records, a second contig, the
high-position regression, the max_cigar guard, the 4-byte floor), the
driver with and without a ``.bai``, on the native and zlib planes with
the fused decode on and off, and a corrupt block under
``skip_bad_spans``.
"""
import dataclasses
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.formats.sam import SamRecord
from hadoop_bam_tpu.ops import cigar as jcigar
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.split.intervals import Interval as JInterval
from hadoop_bam_torch.config import config_from_dict
from hadoop_bam_torch.ops import cigar as tcigar
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.split.intervals import Interval
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.utils import errors as terr
from hadoop_bam_torch.utils.metrics import METRICS

from fixtures import make_header
from test_cigar import _make_bam, _oracle_depth


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(path):
    from hadoop_bam_tpu.api.dataset import open_bam
    batches = list(open_bam(path).batches())
    assert len(batches) == 1
    return batches[0]


def _both(path, region, jcfg=JAX_CONFIG, **kw):
    """(port depth on the CPU, reference depth), checked equal."""
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    treg = Interval(region.rname, region.start, region.end) \
        if isinstance(region, JInterval) else region
    got = tp.coverage_file(path, treg, device="cpu", config=tcfg, **kw)
    want = jp.coverage_file(path, region, config=jcfg, **kw)
    assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got


# ---------------------------------------------------------------------------
# tests/test_cigar.py, through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_cigar", [64, 8])
def test_reference_span_parity(tmp_path, max_cigar):
    path, header, recs = _make_bam(tmp_path, seed=1)
    b = _batch(path)
    args = (b.data, b.offsets.astype(np.int32),
            b.l_read_name.astype(np.int32), b.n_cigar.astype(np.int32))
    jt = jcigar.unpack_cigar_tiles(*(jnp.asarray(a) for a in args),
                                   max_cigar=max_cigar)
    tt = tcigar.unpack_cigar_tiles(*(_t(a) for a in args),
                                   max_cigar=max_cigar)
    assert tt.shape == jt.shape
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(
        np.int64))
    js = jcigar.reference_span_from_tiles(
        jt, jnp.asarray(args[3]), jnp.asarray(b.l_seq.astype(np.int32)))
    ts = tcigar.reference_span_from_tiles(
        tt, _t(args[3]), _t(b.l_seq.astype(np.int32)))
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if max_cigar == 64:
        assert ts.tolist() == b.reference_span().tolist()


@pytest.mark.parametrize("region", ["1-6000", "901-1400", "4900-8000"])
def test_window_coverage_matches_oracle(tmp_path, region):
    path, header, recs = _make_bam(tmp_path, n=500, seed=2)
    rname = header.ref_names[0]
    depth = _both(path, f"{rname}:{region}")
    lo, hi = (int(x) for x in region.split("-"))
    want = _oracle_depth(recs, header, rname, lo - 1, hi - lo + 1)
    assert depth.tolist() == want.tolist()
    assert want.sum() > 0
    assert _both(path, f"{rname}:6000-6200").sum() == 0


def test_coverage_interval_object_and_errors(tmp_path):
    path, header, recs = _make_bam(tmp_path, n=100, seed=3)
    rname = header.ref_names[0]
    d = _both(path, JInterval(rname, 1, 1000))
    assert d.shape == (1000,)
    for bad, match in (("nope:1-100", "not in header"),
                       (f"{rname}:5000000000-5000000010", "empty region")):
        with pytest.raises(ValueError, match=match):
            tp.coverage_file(path, bad, device="cpu")
        with pytest.raises(ValueError, match=match):
            jp.coverage_file(path, bad)


def test_coverage_window_cap(tmp_path, monkeypatch):
    """Windows past 2^26 bases raise in both (the cap lowered here: the
    fixture's contigs are shorter)."""
    path, header, recs = _make_bam(tmp_path, n=20, seed=4)
    monkeypatch.setattr(tp, "COVERAGE_MAX_WINDOW", 1000)
    with pytest.raises(ValueError, match="cap is 2"):
        tp.coverage_file(path, f"{header.ref_names[0]}:1-1001",
                         device="cpu")
    assert tp.coverage_file(path, f"{header.ref_names[0]}:1-1000",
                            device="cpu").shape == (1000,)


def _wide_bam(tmp_path):
    header = make_header()
    cigar = "1M1I" * 40 + "1M"          # 81 ops
    seq = "A" * 41 + "C" * 40
    path = str(tmp_path / "wide.bam")
    with BamWriter(path, header) as w:
        w.write_sam_record(SamRecord(
            qname="w", flag=0, rname=header.ref_names[0], pos=100,
            mapq=30, cigar=cigar, rnext="*", pnext=0, tlen=0,
            seq=seq, qual="I" * len(seq)))
    return path, header


def test_coverage_max_cigar_guard(tmp_path):
    path, header = _wide_bam(tmp_path)
    region = f"{header.ref_names[0]}:1-500"
    with pytest.raises(terr.PlanError, match="max_cigar"):
        tp.coverage_file(path, region, device="cpu", max_cigar=64)
    with pytest.raises(ValueError, match="max_cigar"):
        jp.coverage_file(path, region, max_cigar=64)
    d = _both(path, region, max_cigar=96)
    assert int(d.sum()) == 41


def test_coverage_max_cigar_is_not_quarantined(tmp_path):
    """The guard raises outside the span retry boundary: skip_bad_spans
    does not eat it as corruption."""
    path, header = _wide_bam(tmp_path)
    cfg = config_from_dict({"skip_bad_spans": True})
    with pytest.raises(terr.PlanError, match="max_cigar"):
        tp.coverage_file(path, f"{header.ref_names[0]}:1-500",
                         device="cpu", config=cfg, max_cigar=64)


def test_coverage_high_positions(tmp_path):
    """The reference's regression (FLAG read from the bin field): depth
    at positions >= 49152 equal to the oracle and to the reference."""
    header = make_header()
    rng = random.Random(8)
    recs = []
    for i in range(300):
        n = rng.randint(30, 80)
        recs.append(SamRecord(
            qname=f"h{i}", flag=0, rname=header.ref_names[0],
            pos=rng.randint(50_000, 80_000), mapq=30, cigar=f"{n}M",
            rnext="*", pnext=0, tlen=0, seq="A" * n, qual="I" * n))
    path = str(tmp_path / "high.bam")
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    depth = _both(path, f"{header.ref_names[0]}:50,000-81,000")
    want = _oracle_depth(recs, header, header.ref_names[0], 49_999, 31_001)
    assert depth.tolist() == want.tolist()
    assert want.sum() > 0


def test_unpack_cigar_tiles_tiny_buffer():
    for n_bytes in (0, 1, 3):
        tiles = tcigar.unpack_cigar_tiles(
            torch.zeros(n_bytes, dtype=torch.uint8),
            torch.zeros(2, dtype=torch.int32),
            torch.full((2,), 5, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32), max_cigar=4)
        want = jcigar.unpack_cigar_tiles(
            jnp.zeros((n_bytes,), jnp.uint8), jnp.zeros((2,), jnp.int32),
            jnp.full((2,), 5, jnp.int32), jnp.zeros((2,), jnp.int32),
            max_cigar=4)
        assert tiles.shape == (2, 4) == want.shape
        assert int(tiles.sum()) == 0 == int(np.asarray(want).sum())


# ---------------------------------------------------------------------------
# K12's integer widths and the one-cumsum form
# ---------------------------------------------------------------------------

def _random_tiles(rng, n, mc):
    ops = rng.integers(0, 9, (n, mc))
    ln = rng.integers(0, 1 << 12, (n, mc))
    ln[:, 3:] = np.where(rng.random((n, mc - 3)) < 0.3, 0, ln[:, 3:])
    return ((ln << 4) | ops).astype(np.uint32)


@pytest.mark.parametrize("seed,pos_lo,win_start", [
    (0, 0, 0), (1, 40_000, 50_000),
    # op starts past 2^31 wrap in int32 in the reference; so must they here
    (2, (1 << 31) - 40_000, (1 << 31) - 60_000),
    (3, (1 << 31) - 5_000, 1000)])
def test_window_coverage_from_tiles_int32(seed, pos_lo, win_start):
    rng = np.random.default_rng(seed)
    n, mc, window = 300, 16, 70_000
    tiles = _random_tiles(rng, n, mc)
    pos = rng.integers(pos_lo, min(pos_lo + 60_000, (1 << 31) - 1),
                       n).astype(np.int32)
    refid = rng.integers(-1, 3, n).astype(np.int32)
    flag = rng.integers(0, 1 << 12, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    want = np.asarray(jcigar.window_coverage_from_tiles(
        jnp.asarray(tiles), jnp.asarray(pos), jnp.asarray(refid),
        jnp.asarray(flag), jnp.asarray(valid), jnp.int32(1),
        jnp.int32(win_start), window))
    got = tcigar.window_coverage_from_tiles(
        _t(tiles.astype(np.int64)), _t(pos), _t(refid), _t(flag),
        _t(valid), 1, win_start, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_one_cumsum_equals_per_dispatch_depth():
    """coverage_step's summed diffs and one cumsum equal the sum of the
    reference form's per-dispatch depths (coverage_depth_step)."""
    rng = np.random.default_rng(5)
    mc, window, rows = 8, 5000, 256
    total, diff = np.zeros(window, np.int64), None
    for _ in range(4):
        tile = np.zeros((rows, tp._cigar_row_bytes(mc)), np.uint8)
        tile[:, 0:4] = np.frombuffer(rng.integers(0, 2, rows).astype(
            "<i4").tobytes(), np.uint8).reshape(rows, 4)
        tile[:, 4:8] = np.frombuffer(rng.integers(0, 4000, rows).astype(
            "<i4").tobytes(), np.uint8).reshape(rows, 4)
        tile[:, 8] = mc
        tile[:, 10] = rng.integers(0, 256, rows)
        tile[:, 12:] = np.frombuffer(_random_tiles(rng, rows, mc).astype(
            "<u4").tobytes(), np.uint8).reshape(rows, 4 * mc)
        count = int(rng.integers(1, rows))
        t = torch.from_numpy(tile)
        total += tp.coverage_depth_step(t, count, 1, 100, window,
                                        mc).numpy()
        diff = tp.coverage_step(t, count, 1, 100, window, mc, out=diff)
    once = torch.cumsum(diff[:window], 0, dtype=torch.int32).numpy()
    np.testing.assert_array_equal(once, total.astype(np.int32))


def test_decode_span_cigar_rows_parity(tmp_path):
    path, header, recs = _make_bam(tmp_path, n=400, seed=6)
    from hadoop_bam_tpu.split.planners import plan_bam_spans as jplan
    for js in jplan(path, num_spans=3):
        span = FileVirtualSpan(path, js.start_voffset, js.end_voffset)
        for mc in (4, 64):
            for fused in (True, False):
                jcfg = dataclasses.replace(JAX_CONFIG,
                                           use_fused_decode=fused)
                got = tp.decode_span_cigar_rows(
                    path, span, mc, config=config_from_dict(
                        dataclasses.asdict(jcfg)))
                want = jp.decode_span_cigar_rows(path, js, mc, config=jcfg)
                np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the driver: .bai, planes, fused decode, quarantine
# ---------------------------------------------------------------------------

def _sorted_bam(tmp_path, n=1500, seed=7):
    """A coordinate-sorted copy of ``_make_bam``'s records with its
    .bai (unmapped '*' records last)."""
    _, header, recs = _make_bam(tmp_path, n=n, seed=seed)
    from hadoop_bam_tpu.split.bai import write_bai

    def key(r):
        return ((header.ref_names.index(r.rname) if r.rname != "*"
                 else 1 << 30), r.pos)
    recs = sorted(recs, key=key)
    path = str(tmp_path / "sorted.bam")
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    write_bai(path)
    return path, header, recs


@pytest.mark.parametrize("backend,fused", [("native", True),
                                           ("native", False),
                                           ("zlib", False)])
def test_coverage_file_with_and_without_bai(tmp_path, backend, fused):
    path, header, recs = _sorted_bam(tmp_path)
    jcfg = dataclasses.replace(JAX_CONFIG, inflate_backend=backend,
                               use_fused_decode=fused, check_crc=True)
    for rname in header.ref_names[:2]:
        region = f"{rname}:200-4100"
        want = _oracle_depth(recs, header, rname, 199, 3901)
        METRICS.reset()
        with_bai = _both(path, region, jcfg, tile_records=256)
        assert with_bai.tolist() == want.tolist()
        # width-cut tiles: at most 8 + 4 ops of 4 bytes a row here, far
        # under the 268-byte rows of max_cigar=64
        shipped = METRICS.get("pipeline.dispatch_bytes")
        assert 0 < shipped <= 256 * (12 + 4 * 16) * -(-len(recs) // 256) \
            + 4 * len(recs)
        os.rename(path + ".bai", path + ".bai.off")
        try:
            whole = _both(path, region, jcfg, tile_records=256)
        finally:
            os.rename(path + ".bai.off", path + ".bai")
        assert whole.tolist() == want.tolist()


def test_coverage_file_explicit_spans_and_small_tiles(tmp_path):
    """Caller-given spans (four of them) and tiles smaller than a span:
    many dispatches, each cut to its own op width."""
    path, header, recs = _make_bam(tmp_path, n=800, seed=9)
    from hadoop_bam_tpu.split.planners import plan_bam_spans as jplan
    js = jplan(path, num_spans=4)
    ts = [FileVirtualSpan(path, s.start_voffset, s.end_voffset) for s in js]
    rname = header.ref_names[0]
    got = tp.coverage_file(path, f"{rname}:1-6000", device="cpu", spans=ts,
                           tile_records=64, max_cigar=32)
    want = jp.coverage_file(path, f"{rname}:1-6000", spans=js,
                            tile_records=64, max_cigar=32)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == _oracle_depth(recs, header, rname, 0,
                                         6000).tolist()


def test_coverage_file_quarantines_a_corrupt_block(tmp_path):
    """One flipped block under skip_bad_spans: both packages skip the
    same span, with equal depth and equal manifests; without it both
    raise the CORRUPT class."""
    from hadoop_bam_tpu.split.planners import plan_bam_spans as jplan
    from hadoop_bam_tpu.utils import errors as jerr
    from hadoop_bam_tpu.utils.resilient import QuarantineManifest as JQ
    from hadoop_bam_torch.synth import flip_block
    from hadoop_bam_torch.utils.resilient import QuarantineManifest

    path, header, recs = _make_bam(tmp_path, n=3000, seed=10)
    js = jplan(path, num_spans=6)
    bad = str(tmp_path / "bad.bam")
    flip_block(path, bad, (js[2].start[0] + js[2].end[0]) // 2)
    js = [type(s)(bad, s.start_voffset, s.end_voffset) for s in js]
    ts = [FileVirtualSpan(bad, s.start_voffset, s.end_voffset) for s in js]
    rname = header.ref_names[0]
    region = f"{rname}:1-6000"
    jcfg = dataclasses.replace(JAX_CONFIG, skip_bad_spans=True,
                               retry_backoff_base_s=0.001,
                               retry_backoff_max_s=0.002)
    tq, jq = QuarantineManifest(), JQ()
    got = tp.coverage_file(bad, region, device="cpu", spans=ts,
                           config=config_from_dict(dataclasses.asdict(jcfg)),
                           quarantine=tq)
    want = jp.coverage_file(bad, region, spans=js, config=jcfg,
                            quarantine=jq)
    np.testing.assert_array_equal(got, want)
    assert len(tq) == len(jq) >= 1
    keys = ("span_start", "span_end", "error_class", "attempts")
    assert sorted(tuple(e[k] for k in keys) for e in tq.to_dicts()) == \
        sorted(tuple(e[k] for k in keys) for e in jq.to_dicts())
    assert tq.total_spans == jq.total_spans == 6
    # what was skipped is real depth: the clean file has more
    clean = tp.coverage_file(path, region, device="cpu")
    assert clean.sum() > got.sum()
    plain = dataclasses.replace(jcfg, skip_bad_spans=False)
    with pytest.raises(Exception) as te:
        tp.coverage_file(bad, region, device="cpu", spans=ts,
                         config=config_from_dict(dataclasses.asdict(plain)))
    with pytest.raises(Exception) as je:
        jp.coverage_file(bad, region, spans=js, config=plain)
    assert terr.classify_error(te.value) == jerr.classify_error(je.value) \
        == terr.CORRUPT


def test_coverage_file_needs_a_card_unless_told(tmp_path, monkeypatch):
    path, header, recs = _make_bam(tmp_path, n=10, seed=11)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tp.coverage_file(path, f"{header.ref_names[0]}:1-100")


def test_synth_coverage_bam_matches_its_oracle(tmp_path):
    """The card's mixed-CIGAR generator (synth.write_coverage_bam) at a
    small size: its numpy pileup equals coverage_file on the port and on
    the reference, with and without the .bai, and the CIGAR mix holds
    every op kind, '*' CIGARs and reads past 8 and 32 ops."""
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import coverage_oracle, write_coverage_bam
    path = str(tmp_path / "cov.bam")
    truth = write_coverage_bam(path, 20_000, seed=3, span=200_000)
    write_bai(path)
    ops = truth.op_kinds()
    assert set("MIDNSH=X") <= set(ops), ops
    assert truth.star_cigars > 0 and truth.unmapped > 0
    assert truth.max_ops > 32 and truth.reads_over(8) > 0
    assert truth.on_ref(1) > 0
    for region, (lo, hi) in (("chr20:1-200000", (1, 200_000)),
                             ("chr20:150001-260000", (150_001, 260_000))):
        want = coverage_oracle(truth, 0, lo - 1, hi - lo + 1)
        got = _both(path, region, max_cigar=64)
        assert got.tolist() == want.tolist()
        os.rename(path + ".bai", path + ".off")
        try:
            assert _both(path, region).tolist() == want.tolist()
        finally:
            os.rename(path + ".off", path + ".bai")
    with pytest.raises(terr.PlanError, match="max_cigar"):
        tp.coverage_file(path, "chr20:1-200000", device="cpu", max_cigar=16)
