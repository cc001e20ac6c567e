"""The port's fused streaming decode against the JAX package's and against
the port's own two-pass path, on the CPU: every case of
tests/test_fused_decode.py (modes, randomized plans, the cut final
record, corruption fuzz, chaos, quarantine, chunk streaming and early
close, streamed corruption counters), the drivers with
``use_fused_decode`` on and off on every plane, and the port's own
rules: a library without the fused entry points raises
NativeBuildError, and an abandoned stream joins its native workers.

Outputs compare byte for byte; errors by class and failure class;
flagstat counters, n_reads and base_hist exactly, mean_gc / mean_qual
within rtol 1e-6 (f32 against f64 partial sums, in other orders).
"""
import dataclasses
import random

import numpy as np
import pytest

from hadoop_bam_tpu import resilience as jres
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats import bgzf as jbgzf
from hadoop_bam_tpu.formats.bam import SAMHeader
from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.ops import inflate as jinflate
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.plan.executor import (
    FLAGSTAT_DAG, SourceIR, select_plane as jselect,
)
from hadoop_bam_tpu.split import planners as jpl
from hadoop_bam_tpu.utils import errors as jerr
from hadoop_bam_tpu.utils import resilient as jrs
from hadoop_bam_tpu.utils.metrics import METRICS as JMETRICS
from hadoop_bam_torch import resilience as tres
from hadoop_bam_torch.config import HBamConfig, config_from_dict
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.ops import inflate as inflate_ops
from hadoop_bam_torch.ops.unpack_bam import (
    FLAGSTAT_PROJECTION, projection_ranges, projection_row_bytes,
)
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.plan.executor import (
    _fused_stream_gate, _use_fused, select_plane,
)
from hadoop_bam_torch.split import planners as tpl
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.utils import native
from hadoop_bam_torch.utils import resilient as trs
from hadoop_bam_torch.utils.errors import CORRUPT, PlanError, classify_error
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.native import NativeBuildError

from fixtures import make_header, make_records

SEL = projection_ranges(FLAGSTAT_PROJECTION)
ROW_W = projection_row_bytes(FLAGSTAT_PROJECTION)
ON = HBamConfig()
OFF = HBamConfig(use_fused_decode=False)
JON = JAX_CONFIG
JOFF = dataclasses.replace(JAX_CONFIG, use_fused_decode=False)
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


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fused") / "f.bam")
    header = make_header()
    records = make_records(header, 4000, seed=21)
    with BamWriter(path, header) as w:
        for r in records:
            w.write_sam_record(r)
    return path, header, records


def _span_setup(path):
    raw = open(path, "rb").read()
    table = inflate_ops.block_table(raw)
    data, _ = inflate_ops.inflate_span(raw, table)
    _, after = SAMHeader.from_bam_bytes(data.tobytes())
    return raw, table, data, after


# ---------------------------------------------------------------------------
# byte identity (tests/test_fused_decode.py:73-134)
# ---------------------------------------------------------------------------

def test_offsets_mode_matches_two_pass_and_reference(bam):
    raw, table, data, after = _span_setup(bam[0])
    offs, tail = inflate_ops.walk_records(data, start=after)
    dec = inflate_ops.FusedSpanDecode(raw, table, start=after,
                                      chunk_blocks=2)
    n, ftail = dec.run()
    ref = jinflate.FusedSpanDecode(raw, start=after, chunk_blocks=2)
    rn, rtail = ref.run()
    assert np.array_equal(dec.data, data) and np.array_equal(dec.data,
                                                             ref.data)
    assert np.array_equal(dec.offsets[:n], offs)
    assert np.array_equal(dec.offsets[:n], ref.offsets[:rn])
    assert ftail == tail == rtail


@pytest.mark.parametrize("chunk_blocks", [1, 3, 32])
def test_rows_and_payload_modes_match(bam, chunk_blocks):
    raw, table, data, after = _span_setup(bam[0])
    cap = max(16, (data.size - after) // 36 + 1)
    rows, offs, _ = native.walk_bam_packed(data, after, cap, SEL, ROW_W)
    dec = inflate_ops.FusedSpanDecode(raw, table, start=after, mode="rows",
                                      sel=SEL, row_stride=ROW_W,
                                      chunk_blocks=chunk_blocks)
    n, _ = dec.run()
    ref = jinflate.FusedSpanDecode(raw, start=after, mode="rows", sel=SEL,
                                   row_stride=ROW_W,
                                   chunk_blocks=chunk_blocks)
    rn, _ = ref.run()
    assert n == rows.shape[0] == rn
    assert np.array_equal(dec.rows[:n], rows)
    assert np.array_equal(dec.rows[:n], ref.rows[:rn])
    assert np.array_equal(dec.offsets[:n], offs)

    pf, sq, ql, _, _ = native.walk_bam_payload(data, after, cap, 160, 96,
                                               160)
    kw = dict(start=after, mode="payload", max_len=160, seq_stride=96,
              qual_stride=160, chunk_blocks=chunk_blocks)
    dec2 = inflate_ops.FusedSpanDecode(raw, table, **kw)
    n2, _ = dec2.run()
    ref2 = jinflate.FusedSpanDecode(raw, **kw)
    ref2.run()
    for got, two_pass, theirs in ((dec2.prefix, pf, ref2.prefix),
                                  (dec2.seq, sq, ref2.seq),
                                  (dec2.qual, ql, ref2.qual)):
        assert np.array_equal(got[:n2], two_pass)
        assert np.array_equal(got[:n2], theirs[:n2])


def test_randomized_split_offsets_byte_identity(bam):
    """Fused against two-pass and against the reference over randomized
    plans: the three span decoders, voffsets included."""
    path, header, _ = bam
    rng = random.Random(7)
    g, tg = jp.PayloadGeometry(max_len=120), tp.PayloadGeometry(max_len=120)
    sg = tp.DecodeGeometry(bytes_cap=1 << 22, records_cap=1 << 16)
    for num_spans in (rng.randint(2, 9), rng.randint(10, 25),
                      rng.randint(26, 60)):
        for s in tpl.plan_bam_spans(path, num_spans=num_spans):
            js = jpl.FileVirtualSpan(path, s.start_voffset, s.end_voffset)
            r1, v1 = tp.decode_span_prefix_host(
                path, s, projection=FLAGSTAT_PROJECTION, config=ON)
            r2, v2 = tp.decode_span_prefix_host(
                path, s, projection=FLAGSTAT_PROJECTION, config=OFF)
            r3, v3 = jp.decode_span_prefix_host(
                path, js, projection=FLAGSTAT_PROJECTION, config=JON)
            for a, b in ((r1, r2), (v1, v2), (r1, r3), (v1, v3)):
                assert np.array_equal(a, b)
            p1 = tp.decode_span_payload_host(path, s, tg, want_voffs=True,
                                             config=ON)
            p2 = tp.decode_span_payload_host(path, s, tg, want_voffs=True,
                                             config=OFF)
            p3 = jp.decode_span_payload_host(path, js, g, want_voffs=True,
                                             config=JON)
            for a, b, c in zip(p1, p2, p3):
                assert np.array_equal(a, b) and np.array_equal(a, c)
            d1 = tp.decode_span_host(path, s, sg, config=ON)
            d2 = tp.decode_span_host(path, s, sg, config=OFF)
            for a, b in zip(d1, d2):
                assert np.array_equal(a, b)


def _tiny_block_bam(tmp_path, n=40, chunk=100):
    """Records deflated ``chunk`` inflated bytes a block, so every ~130 B
    record crosses a block boundary (tests/test_fused_decode.py:137)."""
    from hadoop_bam_tpu.formats.bamio import read_bam
    header = make_header()
    base = str(tmp_path / "hdr.bam")
    with BamWriter(base, header):
        pass
    hdr_bytes = open(base, "rb").read()[:-len(jbgzf.EOF_BLOCK)]
    recs = make_records(header, n, seed=9)
    tmp = str(tmp_path / "tmp.bam")
    with BamWriter(tmp, header) as w:
        for r in recs:
            w.write_sam_record(r)
    _, batch = read_bam(tmp)
    payload = b"".join(batch.record_bytes(i) for i in range(n))
    rec_offs = np.cumsum([0] + [len(batch.record_bytes(i))
                                for i in range(n)])[:-1]
    blocks = b"".join(jbgzf.deflate_block(payload[i:i + chunk])
                      for i in range(0, len(payload), chunk))
    path = str(tmp_path / "tiny.bam")
    with open(path, "wb") as f:
        f.write(hdr_bytes + blocks + jbgzf.EOF_BLOCK)
    return path, hdr_bytes, rec_offs, chunk


def test_cut_final_record_falls_back_to_oracle(tmp_path):
    path, hdr_bytes, rec_offs, chunk = _tiny_block_bam(tmp_path)
    raw = open(path, "rb").read()
    coffs = [b.coffset for b in bgzf.scan_blocks(raw)
             if b.coffset >= len(hdr_bytes)]
    u = int(rec_offs[20])
    span = FileVirtualSpan(path, len(hdr_bytes) << 16,
                           (coffs[u // chunk] << 16) | (u % chunk + 1))
    r1, v1 = tp.decode_span_prefix_host(path, span, config=ON)
    assert METRICS.get("pipeline.fused_tail_fallbacks") == 1
    r2, v2 = tp.decode_span_prefix_host(path, span, config=OFF)
    js = jpl.FileVirtualSpan(path, span.start_voffset, span.end_voffset)
    r3, v3 = jp.decode_span_prefix_host(path, js, config=JON)
    assert r1.shape[0] == 21
    for a, b in ((r1, r2), (v1, v2), (r1, r3), (v1, v3)):
        assert np.array_equal(a, b)
    for s in tpl.plan_bam_spans(path, num_spans=11):
        a, _ = tp.decode_span_prefix_host(path, s, config=ON)
        b, _ = tp.decode_span_prefix_host(path, s, config=OFF)
        assert np.array_equal(a, b)


def _cut_tail_spans(path, every=17):
    """A partition of the file into spans of ``every`` records that end
    one byte past their last record's start: over the tiny-block layout
    each span's last record is cut at its end block (a planner's
    record-aligned ends never cut one)."""
    v = [int(x) for s in tpl.plan_bam_spans(path, num_spans=1)
         for x in tpl.read_bam_span(path, s).voffsets]
    end = len(open(path, "rb").read()) << 16
    cuts = list(range(0, len(v), every))
    spans = []
    for i, k in enumerate(cuts):
        last = cuts[i + 1] - 1 if i + 1 < len(cuts) else None
        spans.append((v[k], end if last is None else v[last] + 1))
    return ([FileVirtualSpan(path, a, b) for a, b in spans],
            [jpl.FileVirtualSpan(path, a, b) for a, b in spans])


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats", "span"])
def test_streamed_cut_tails_equal_reference(tmp_path, driver):
    """The streamed drivers over spans whose last record is cut: the
    two-pass tail joins the stream, and the results and counters equal
    the reference's."""
    path = _tiny_block_bam(tmp_path, n=400)[0]
    spans, jspans = _cut_tail_spans(path)
    if driver == "seq_stats":
        got = tp.seq_stats_file(path, device="cpu", config=ON,
                                geometry=TGEOM, spans=spans)
        want = jp.seq_stats_file(path, config=JON, geometry=GEOM,
                                 spans=jspans)
        assert got["n_reads"] == want["n_reads"] == 400
        np.testing.assert_array_equal(got["base_hist"], want["base_hist"])
    else:
        mode = "span" if driver == "span" else "tile"
        got = tp.flagstat_file(path, device="cpu", config=ON, spans=spans,
                               mode=mode)
        assert got == jp.flagstat_file(path, config=JON, spans=jspans)
        assert got["total"] == 400
    assert METRICS.get("pipeline.fused_tail_fallbacks") == len(spans) - 1
    assert METRICS.get("pipeline.records") == 400
    assert METRICS.get("pipeline.spans") == len(spans)
    if driver != "span":
        for k in ("pipeline.spans", "pipeline.blocks",
                  "pipeline.inflated_bytes", "pipeline.records"):
            assert METRICS.get(k) == JMETRICS.counters[k], k


# ---------------------------------------------------------------------------
# corruption fuzz (tests/test_fused_decode.py:189-298)
# ---------------------------------------------------------------------------

def _two_pass(raw, after, check_crc=False):
    table = inflate_ops.block_table(raw)
    data, ubase = inflate_ops.inflate_span(raw, table)
    if check_crc:
        inflate_ops.verify_crcs(raw, table, data, ubase)
    return inflate_ops.walk_records(data, start=after)


def _fused(raw, after, check_crc=False):
    dec = inflate_ops.FusedSpanDecode(raw, start=after, check_crc=check_crc,
                                      chunk_blocks=2)
    n, tail = dec.run()
    return dec.offsets[:n], tail


def _ref_fused(raw, after, check_crc=False):
    dec = jinflate.FusedSpanDecode(raw, start=after, check_crc=check_crc,
                                   chunk_blocks=2)
    n, tail = dec.run()
    return dec.offsets[:n], tail


def _outcome(fn, raw, after, check_crc):
    try:
        offs, tail = fn(raw, after, check_crc=check_crc)
        return ("ok", offs.size, tail)
    except Exception as e:  # noqa: BLE001 -- the class is the test
        return ("err", type(e).__name__, isinstance(e, ValueError),
                classify_error(e))


def test_byte_flip_fuzz_same_errors(bam):
    raw, _, _, after = _span_setup(bam[0])
    rng = random.Random(31)
    n_corrupt = 0
    for _ in range(25):
        bad = bytearray(raw)
        pos = rng.randrange(len(raw) - len(jbgzf.EOF_BLOCK))
        bad[pos] ^= 1 << rng.randrange(8)
        bad = bytes(bad)
        mine = _outcome(_fused, bad, after, True)
        oracle = _outcome(_two_pass, bad, after, True)
        theirs = _outcome(_ref_fused, bad, after, True)
        assert mine[0] == oracle[0] == theirs[0], pos
        if mine[0] == "ok":
            assert mine == oracle == theirs
        else:
            n_corrupt += 1
            assert mine[2:] == oracle[2:] == (True, CORRUPT), pos
            assert mine[1] == theirs[1], pos      # same class name
    assert n_corrupt >= 5


def test_crc_mismatch_only_with_check_crc(bam):
    raw, table, _, after = _span_setup(bam[0])
    foot = int(table["cdata_off"][3] + table["cdata_len"][3])
    bad = bytearray(raw)
    bad[foot] ^= 0xFF
    bad = bytes(bad)
    o1, t1 = _two_pass(bad, after)
    o2, t2 = _fused(bad, after)
    assert np.array_equal(o1, o2) and t1 == t2
    for fn in (_two_pass, _fused):
        with pytest.raises(bgzf.BGZFError, match="CRC32 mismatch"):
            fn(bad, after, check_crc=True)


def test_truncated_tail_matches(bam):
    raw, table, _, after = _span_setup(bam[0])
    cut = int(table["coffset"][5])
    o1, t1 = _two_pass(raw[:cut], after)
    o2, t2 = _fused(raw[:cut], after)
    assert np.array_equal(o1, o2) and t1 == t2
    for fn in (_two_pass, _fused):
        with pytest.raises(bgzf.BGZFError):
            fn(raw[:cut + 40], after)


def test_malformed_record_chain_same_class(bam):
    raw, table, data, after = _span_setup(bam[0])
    bad_data = bytearray(data.tobytes())
    bad_data[after:after + 4] = (5).to_bytes(4, "little")   # bs < 32
    ends = np.cumsum(table["isize"])
    blk = int(np.searchsorted(ends, after, side="right"))
    lo = int(ends[blk - 1]) if blk else 0
    hi = lo + int(table["isize"][blk])
    c0 = int(table["coffset"][blk])
    size = bgzf.parse_block_header(raw, c0).block_size
    bad_raw = raw[:c0] + jbgzf.deflate_block(bytes(bad_data[lo:hi])) + \
        raw[c0 + size:]
    for fn in (_two_pass, _fused):
        with pytest.raises(ValueError) as e:
            fn(bad_raw, after)
        assert classify_error(e.value) == CORRUPT
    with pytest.raises(ValueError) as e:
        _ref_fused(bad_raw, after)
    assert jerr.classify_error(e.value) == jerr.CORRUPT


# ---------------------------------------------------------------------------
# chaos and quarantine (tests/test_fused_decode.py:301-346)
# ---------------------------------------------------------------------------

def test_transient_chaos_heals_inside_retry_boundary(bam):
    """Transient read faults fail the fetch, which the streamed path runs
    eagerly inside decode_with_retry: the result equals a clean run."""
    path, _, records = bam
    cfg = dataclasses.replace(ON, span_retries=3, retry_backoff_base_s=0.0,
                              retry_backoff_max_s=0.0)
    clean = tp.flagstat_file(path, device="cpu", config=cfg)
    METRICS.reset()
    with trs.chaos_on(path, [trs.FaultSpec(kind="transient", at_read=0,
                                           count=2)]):
        chaotic = tp.flagstat_file(path, device="cpu", config=cfg)
    assert chaotic == clean and clean["total"] == len(records)
    assert METRICS.get("chaos.injected_faults") >= 2
    assert METRICS.get("pipeline.transient_retries") >= 1


def test_bitflip_chaos_quarantines_span(bam):
    """Persistent corruption with skip_bad_spans: streaming is gated off,
    the spans decode buffered, and the quarantine equals the
    reference's."""
    path, _, records = bam
    size = len(open(path, "rb").read())
    jcfg = dataclasses.replace(JON, skip_bad_spans=True, span_retries=0,
                               check_crc=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert not select_plane(tcfg).stream_fused
    spans = tpl.plan_bam_spans(path, num_spans=8)
    jspans = jpl.plan_bam_spans(path, num_spans=8)
    spec = dict(kind="bitflip", offset_range=(size // 2, size // 2 + 4),
                count=10_000)
    with trs.chaos_on(path, [trs.FaultSpec(**spec)]):
        got = tp.flagstat_file(path, device="cpu", config=tcfg, spans=spans)
    with jrs.chaos_on(path, [jrs.FaultSpec(**spec)]):
        want = jp.flagstat_file(path, config=jcfg, spans=jspans)
    assert "quarantine" in got and 0 < got["total"] < len(records)

    def entries(q):
        return sorted(({k: e[k] for k in ("span_start", "span_end",
                                          "error_class")} for e in q),
                      key=lambda e: e["span_start"])
    assert entries(got.pop("quarantine")) == entries(want.pop("quarantine"))
    assert got == want


# ---------------------------------------------------------------------------
# chunk streaming: order, knobs, early close (:353-:434)
# ---------------------------------------------------------------------------

def test_chunk_stream_order_and_coverage(bam):
    raw, table, data, after = _span_setup(bam[0])
    dec = inflate_ops.FusedSpanDecode(raw, table, start=after, mode="rows",
                                      sel=SEL, row_stride=ROW_W,
                                      chunk_blocks=1)
    ranges = list(dec.chunks())
    n, _ = dec.finish()
    assert len(ranges) >= 2
    prev = 0
    for lo, hi in ranges:
        assert lo == prev and hi > lo
        prev = hi
    assert prev == n
    cap = max(16, (data.size - after) // 36 + 1)
    rows, _, _ = native.walk_bam_packed(data, after, cap, SEL, ROW_W)
    assert np.array_equal(dec.rows[:n], rows)


def test_multithreaded_workers_race_free(bam):
    raw, table, data, after = _span_setup(bam[0])
    offs, tail = inflate_ops.walk_records(data, start=after)
    for _ in range(6):
        dec = inflate_ops.FusedSpanDecode(raw, table, start=after,
                                          mode="rows", sel=SEL,
                                          row_stride=ROW_W, check_crc=True,
                                          chunk_blocks=1, n_threads=4)
        n, t = dec.run()
        assert n == offs.size and t == tail
        assert np.array_equal(dec.offsets[:n], offs)


def test_chunk_blocks_knob_changes_granularity(bam):
    """One worker thread: with several, a walk that finds every chunk
    already inflated at its first drain publishes the span as one range,
    so the count of ranges would depend on the threads' timing."""
    raw, table, _, after = _span_setup(bam[0])
    n_blocks = int(table["isize"].size)
    fine = len(list(inflate_ops.FusedSpanDecode(
        raw, table, start=after, chunk_blocks=1, n_threads=1).chunks()))
    coarse = len(list(inflate_ops.FusedSpanDecode(
        raw, table, start=after, chunk_blocks=n_blocks,
        n_threads=1).chunks()))
    assert coarse == 1 and fine > coarse


def test_early_close_joins_native_workers(bam):
    raw, table, _, after = _span_setup(bam[0])
    for _ in range(4):
        dec = inflate_ops.FusedSpanDecode(raw, table, start=after,
                                          chunk_blocks=1)
        g = dec.chunks()
        next(g)
        g.close()
        assert dec.n_rows is not None          # joined: counts are final
    o1, t1 = _fused(raw, after)
    o2, t2 = _two_pass(raw, after)
    assert np.array_equal(o1, o2) and t1 == t2


@pytest.fixture
def job_log(monkeypatch):
    """Every FusedJob the test starts, to check each was joined."""
    jobs = []
    real = native.FusedJob.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        jobs.append(self)

    monkeypatch.setattr(native.FusedJob, "__init__", init)
    return jobs


@pytest.mark.parametrize("where", ["dispatch", "decode"])
def test_abandoned_driver_stream_joins_workers(bam, job_log, where,
                                               monkeypatch):
    """A driver run that fails part way (in a dispatch, or in a later
    span's decode) closes every fused stream it started: the stream in
    hand, the window's finished results and the ones still running."""
    path = bam[0]
    spans = tpl.plan_bam_spans(path, num_spans=24)
    calls = [0]
    if where == "dispatch":
        real = tp.flagstat_tile_step

        def step(*a, **kw):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("injected dispatch failure")
            return real(*a, **kw)
        monkeypatch.setattr(tp, "flagstat_tile_step", step)
        geom = tp.DecodeGeometry(tile_records=256)
        with pytest.raises(RuntimeError, match="injected"):
            tp.flagstat_file(path, device="cpu", config=ON, spans=spans,
                             geometry=geom)
    else:
        real = tp._start_fused_span

        def start(*a, **kw):
            calls[0] += 1
            if calls[0] == 9:
                raise PlanError("injected decode failure")
            return real(*a, **kw)
        monkeypatch.setattr(tp, "_start_fused_span", start)
        with pytest.raises(PlanError, match="injected"):
            tp.seq_stats_file(path, device="cpu", config=ON, spans=spans,
                              geometry=TGEOM)
    assert job_log and all(j._h is None for j in job_log)


def test_stream_close_joins_unstarted_and_started_streams(bam, job_log):
    path = bam[0]
    src = tp.as_byte_source(path)
    s0, s1 = tpl.plan_bam_spans(path, num_spans=2)
    a = tp._iter_fused_span_chunks(src, s0, "rows", sel=SEL,
                                   row_bytes=ROW_W, config=ON)
    b = tp._iter_fused_span_chunks(src, s1, "rows", sel=SEL,
                                   row_bytes=ROW_W, config=ON)
    it = iter(a)
    next(it)
    a.close()
    b.close()                      # never iterated
    src.close()
    assert len(job_log) == 2 and all(j._h is None for j in job_log)


def test_streamed_corruption_ticks_corrupt_spans(bam, tmp_path):
    """Corruption raised on the consumer's side of a stream keeps
    pipeline.corrupt_spans and pipeline.spans ticking, as in the
    reference."""
    path, _, _ = bam
    raw = bytearray(open(path, "rb").read())
    table = inflate_ops.block_table(bytes(raw))
    raw[int(table["cdata_off"][4]) + 9] ^= 0xFF
    bad = str(tmp_path / "bad.bam")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(bgzf.BGZFError):
        tp.flagstat_file(bad, device="cpu", config=ON)
    with pytest.raises(jbgzf.BGZFError):
        jp.flagstat_file(bad, config=JON)
    assert METRICS.get("pipeline.corrupt_spans") >= 1
    assert JMETRICS.counters["pipeline.corrupt_spans"] >= 1
    assert METRICS.get("pipeline.spans") >= 1


# ---------------------------------------------------------------------------
# gates and the port's rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"use_fused_decode": False}, {"inflate_backend": "zlib"},
    {"inflate_backend": "device"}, {"skip_bad_spans": True},
    {"bam_intervals": "chr1"}, {"decode_chunk_blocks": 7}])
def test_plane_decision_matches_reference(kw, bam):
    from hadoop_bam_tpu.split.intervals import parse_intervals as jparse
    from hadoop_bam_torch.split.intervals import parse_intervals
    jcfg = dataclasses.replace(JON, **kw)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    names = bam[1].ref_names
    iv = parse_intervals(tcfg.bam_intervals, names) \
        if tcfg.bam_intervals else None
    jiv = jparse(jcfg.bam_intervals, names) if jcfg.bam_intervals else None
    got = select_plane(tcfg, intervals=iv)
    want = jselect(SourceIR(bam[0], "bam"), FLAGSTAT_DAG, jcfg,
                   intervals=jiv)
    assert (got.plane, got.stream_fused) == (want.plane, want.stream_fused)
    assert _use_fused(tcfg, got.host_backend) == want.use_fused
    assert _fused_stream_gate(tcfg, iv) == \
        jp._fused_stream_gate(jcfg, jiv)


def test_config_knob_plumbing():
    assert _use_fused(ON) and _use_fused(None)
    assert not _use_fused(OFF)
    assert not _use_fused(ON, backend="zlib")
    assert tp._fused_off(ON).use_fused_decode is False
    assert tp._stream_window(10_000) == max(2, 2 * (__import__("os")
                                                    .cpu_count() or 1))


def test_library_without_fused_entry_points_raises(bam, monkeypatch):
    """The port builds its library from the repo's source: one without
    hbam_fused_* is a build fault, raised as NativeBuildError (PLAN), on
    every native path that would take the fused decode; the two-pass
    path and the zlib plane still run."""
    path = bam[0]
    lib = native.load()

    class Stale:
        def __getattr__(self, name):
            if name.startswith("hbam_fused"):
                raise AttributeError(name)
            return getattr(lib, name)

    monkeypatch.setattr(native, "load", lambda: Stale())
    assert not inflate_ops.fused_available()
    want = jp.flagstat_file(path, config=JON)
    for mode in ("tile", "span"):
        with pytest.raises(NativeBuildError):
            tp.flagstat_file(path, device="cpu", config=ON, mode=mode)
    with pytest.raises(NativeBuildError):
        tp.seq_stats_file(path, device="cpu", config=ON, geometry=TGEOM)
    assert tp.flagstat_file(path, device="cpu", config=OFF) == want
    assert tp.flagstat_file(path, device="cpu",
                            config=HBamConfig(inflate_backend="zlib")) == want


# ---------------------------------------------------------------------------
# the drivers, fused on and off, on every plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("plane", ["native", "zlib", "device"])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats", "span"])
def test_drivers_equal_reference(bam, driver, plane, fused):
    """Results, and the span counters on the host planes, equal the
    reference's over the same plan."""
    path, _, records = bam
    jcfg = dataclasses.replace(JON, inflate_backend=plane,
                               use_fused_decode=fused)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    kw = dict(spans=tpl.plan_bam_spans(path, num_spans=6))
    jkw = dict(spans=jpl.plan_bam_spans(path, num_spans=6))
    if driver == "seq_stats":
        got = tp.seq_stats_file(path, device="cpu", config=tcfg,
                                geometry=TGEOM, **kw)
        want = jp.seq_stats_file(path, config=jcfg, geometry=GEOM, **jkw)
        assert got["n_reads"] == want["n_reads"] == len(records)
        np.testing.assert_array_equal(got["base_hist"], want["base_hist"])
        for k in ("mean_gc", "mean_qual"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    else:
        mode = "span" if driver == "span" else "tile"
        got = tp.flagstat_file(path, device="cpu", config=tcfg, mode=mode,
                               **kw)
        assert got == jp.flagstat_file(path, config=jcfg, **jkw)
        assert got["total"] == len(records)
    if plane != "device" and driver != "span":
        for k in ("pipeline.spans", "pipeline.blocks",
                  "pipeline.inflated_bytes", "pipeline.records"):
            assert METRICS.get(k) == JMETRICS.counters[k], k
