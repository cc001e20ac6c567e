"""The port's observability layer against the JAX package's, on the CPU:
the cases of tests/test_obs.py that cover the ported code (histograms,
wall timers and spans, MetricsContext isolation, the pool's context
carry and histograms, NullMetrics, merge, Prometheus text, the query
latency histogram), plus the flight recorder, trace contexts and the
SLO engine.  Where both packages compute the same thing from the same
inputs (histogram state, merged metrics, Prometheus text, flight dumps,
burn rates on an injected clock) the results compare exactly.

Each test starts from reset metrics, flight recorders, resilience
registries and background queues in both packages."""
import concurrent.futures as cf
import json
import os
import random
import threading
import time

import numpy as np
import pytest

from hadoop_bam_tpu.obs import flight as jflight
from hadoop_bam_tpu.obs import slo as jslo
from hadoop_bam_tpu.obs.export import prometheus_text as jprometheus_text
from hadoop_bam_tpu.obs.hist import Histogram as JHistogram
from hadoop_bam_tpu.utils import metrics as jmetrics
from hadoop_bam_torch.obs import context as tctx
from hadoop_bam_torch.obs import flight
from hadoop_bam_torch.obs import slo
from hadoop_bam_torch.obs.export import prometheus_text
from hadoop_bam_torch.obs.hist import Histogram
from hadoop_bam_torch.utils.metrics import (
    METRICS, Metrics, MetricsContext, NullMetrics, base_metrics,
    current_metrics,
)


@pytest.fixture(autouse=True)
def _clean():
    from hadoop_bam_tpu import resilience as jres
    from hadoop_bam_tpu.utils import pools as jpools
    from hadoop_bam_torch import resilience as tres
    from hadoop_bam_torch.utils import pools as tpools
    for m in (base_metrics(), jmetrics.base_metrics()):
        m.reset()
    flight.reset()
    jflight.reset()
    tres.reset()
    jres.reset()
    tpools.cancel_background()
    jpools.cancel_background()
    yield
    flight.reset()
    jflight.reset()


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

def test_histogram_percentiles_within_bucket_error():
    h = Histogram()
    values = [0.001 * (i + 1) for i in range(1000)]   # 1ms..1s uniform
    for v in values:
        h.record(v)
    for p, expect in ((50, 0.5), (95, 0.95), (99, 0.99)):
        got = h.percentile(p)
        assert expect * 0.75 <= got <= expect * 1.35, (p, got)
    s = h.summary()
    assert s["count"] == 1000
    assert s["max"] == pytest.approx(1.0)
    assert abs(s["mean"] - sum(values) / 1000) < 1e-9


def test_histogram_empty_and_single():
    h = Histogram()
    assert h.percentile(99) == 0.0 and h.summary()["count"] == 0
    h.record(0.25)
    assert h.percentile(1) == h.percentile(99) == pytest.approx(0.25,
                                                                rel=0.2)


def test_histogram_merge_associative_and_commutative():
    parts = []
    for seed in range(4):
        h = Histogram()
        r = random.Random(seed)
        for _ in range(500):
            h.record(r.lognormvariate(0.0, 3.0))
        parts.append(h)

    def combine(hs):
        out = Histogram()
        for h in hs:
            out.merge(Histogram.from_dict(h.to_dict()))
        return out.to_dict()

    left = combine([Histogram.from_dict(combine(parts[:2])), parts[2],
                    parts[3]])
    right = combine([parts[0], Histogram.from_dict(combine(parts[1:]))])
    shuffled = combine([parts[2], parts[0], parts[3], parts[1]])
    assert left == right == shuffled


def test_histogram_dict_round_trip_and_equal_to_reference():
    h, j = Histogram(), JHistogram()
    rng = np.random.default_rng(1)
    for v in list(rng.lognormal(-4, 2, 300)) + [1e-12, 0.5, 3.0, 3.0, 1e4]:
        h.record(float(v))
        j.record(float(v))
    back = Histogram.from_dict(json.loads(json.dumps(h.to_dict())))
    assert back.to_dict() == h.to_dict() == j.to_dict()
    assert back.summary() == h.summary() == j.summary()
    for i in (-40, 0, 7):
        assert Histogram.bucket_bounds(i) == JHistogram.bucket_bounds(i)


# ---------------------------------------------------------------------------
# wall timers and spans
# ---------------------------------------------------------------------------

def test_span_is_wall_timer_plus_flight_append():
    m = Metrics()
    with tctx.trace_context(op="t") as ctx:
        with m.span("x.stage_wall", nbytes=1, path="p" * 500):
            time.sleep(0.002)
    assert m.wall_timers["x.stage_wall"] > 0
    assert m.wall_calls["x.stage_wall"] == 1
    spans = flight.recorder().snapshot()["spans"]
    assert [s["name"] for s in spans] == ["x.stage_wall"]
    assert spans[0]["trace"] == ctx.trace_id
    assert spans[0]["args"]["nbytes"] == 1
    assert len(spans[0]["args"]["path"]) < 200      # trimmed


def test_reset_racing_active_wall_span_discards_cleanly():
    m = Metrics()
    cm = m.wall_timer("race.stage")
    cm.__enter__()
    m.reset()
    cm.__exit__(None, None, None)
    assert "race.stage" not in m.wall_timers
    assert m._wall_active == {}
    with m.wall_timer("race.stage"):
        pass
    assert m.wall_calls["race.stage"] == 1


def test_reset_race_does_not_corrupt_new_epoch_spans():
    m = Metrics()
    old = m.wall_timer("s")
    old.__enter__()
    m.reset()
    new = m.wall_timer("s")
    new.__enter__()
    old.__exit__(None, None, None)
    new.__exit__(None, None, None)
    assert m.wall_calls["s"] == 1


def test_nested_same_name_wall_spans_union_once():
    m = Metrics()
    t0 = time.perf_counter()
    with m.wall_timer("n.stage"):
        with m.wall_timer("n.stage"):
            time.sleep(0.004)
        time.sleep(0.002)
    outer = time.perf_counter() - t0
    assert m.wall_calls["n.stage"] == 1
    assert m.wall_timers["n.stage"] == pytest.approx(outer, abs=0.05)
    assert m.wall_timers["n.stage"] >= 0.006 * 0.5


def test_overlapping_thread_spans_union_not_sum():
    m = Metrics()

    def work():
        with m.wall_timer("o.stage"):
            time.sleep(0.02)

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert m.wall_timers["o.stage"] < 0.06


# ---------------------------------------------------------------------------
# MetricsContext isolation + pool propagation
# ---------------------------------------------------------------------------

def test_metrics_context_isolates_and_falls_back():
    base_before = base_metrics().get("ctx.ticks")
    with MetricsContext() as a:
        METRICS.count("ctx.ticks", 2)
        with MetricsContext() as b:
            METRICS.count("ctx.ticks", 5)
        assert current_metrics() is a
    assert a.get("ctx.ticks") == 2
    assert b.get("ctx.ticks") == 5
    assert base_metrics().get("ctx.ticks") == base_before
    assert current_metrics() is base_metrics()


def test_two_threads_with_separate_contexts_do_not_smear():
    out = {}

    def run(name, n):
        with MetricsContext() as m:
            for _ in range(n):
                METRICS.count("smear.test")
            out[name] = m.get("smear.test")

    t1 = threading.Thread(target=run, args=("a", 3))
    t2 = threading.Thread(target=run, args=("b", 7))
    t1.start(); t2.start(); t1.join(); t2.join()
    assert out == {"a": 3, "b": 7}


def test_pool_submit_carries_context_and_records_histograms():
    from hadoop_bam_torch.utils import pools

    pool = cf.ThreadPoolExecutor(max_workers=2)
    try:
        with MetricsContext() as m, tctx.trace_context(op="p") as ctx:
            futs = [pools.submit(pool, lambda i=i: (
                METRICS.count("pooled.work", i), tctx.current_trace_id())[1])
                for i in (1, 2, 4)]
            ids = [f.result() for f in futs]
        assert m.get("pooled.work") == 7
        assert base_metrics().get("pooled.work") == 0
        assert m.hist_summary("pool.task_wait_s")["count"] == 3
        assert m.hist_summary("pool.task_run_s")["count"] == 3
        assert ids == [ctx.trace_id] * 3          # the trace rides along
    finally:
        pool.shutdown()


def test_null_metrics_is_inert():
    with MetricsContext(NullMetrics()) as m:
        METRICS.count("null.tick")
        METRICS.observe("null.h", 1.0)
        with METRICS.span("null.span"):
            pass
        with METRICS.timer("null.t"):
            pass
        METRICS.add_wall("null.w", 1.0)
    assert m.counters == {} and m.histograms == {}
    assert m.wall_timers == {} and m.timers == {}


def test_discard_series_and_snapshot_keys_match_reference():
    m, j = Metrics(), jmetrics.Metrics()
    for x in (m, j):
        x.count("serve.requests.t1", 2)
        x.observe("serve.latency_s.t1", 0.01)
        x.count("keep")
        with x.timer("tm"):
            pass
    assert sorted(m.snapshot()) == sorted(j.snapshot())
    m.discard_series("serve.requests.t1", "serve.latency_s.t1", "nope")
    assert m.counters == {"keep": 1} and m.histograms == {}
    assert m.hist_dict("absent") == {} and m.hist_summary("absent") == {}


# ---------------------------------------------------------------------------
# merge semantics and exporters, against the reference
# ---------------------------------------------------------------------------

def _host(cls, seed, wall):
    m = cls()
    r = random.Random(seed)
    m.count("pipeline.records", 100 * (seed + 1))
    with m.timer("pipeline.inflate"):
        pass
    m.timers["pipeline.inflate"] = 0.5 * (seed + 1)
    m.add_wall("pipeline.feed_wall", wall)
    for _ in range(200):
        m.observe("query.latency_s", r.lognormvariate(-3, 1))
    return m


def test_merge_dict_sums_counters_maxes_walls_merges_hists():
    hosts = [_host(Metrics, 0, 1.0), _host(Metrics, 1, 3.0),
             _host(Metrics, 2, 2.0)]
    merged = Metrics()
    for h in hosts:
        merged.merge_dict(h.to_dict())
    assert merged.get("pipeline.records") == 600
    assert merged.timers["pipeline.inflate"] == pytest.approx(3.0)
    assert merged.wall_timers["pipeline.feed_wall"] == pytest.approx(3.0)
    assert merged.hist_summary("query.latency_s")["count"] == 600
    other = Metrics()
    for h in reversed(hosts):
        other.merge_dict(h.to_dict())
    a, b = other.to_dict(), merged.to_dict()
    assert a["histograms"]["query.latency_s"]["buckets"] \
        == b["histograms"]["query.latency_s"]["buckets"]
    for key in ("counters", "timers", "wall_timers", "wall_calls"):
        assert a[key] == b[key]
    # the reference merges the same payloads to the same state
    ref = jmetrics.Metrics()
    for h in hosts:
        ref.merge_dict(h.to_dict())
    assert ref.to_dict() == merged.to_dict()
    assert Metrics.from_dict(b).to_dict() == b


def test_prometheus_exposition_shape_and_equal_to_reference():
    m = _host(Metrics, 1, 2.0)
    text = prometheus_text(m, labels={"host": "h1"})
    assert '# TYPE hbam_pipeline_records_total counter' in text
    assert 'hbam_pipeline_records_total{host="h1"} 200' in text
    assert '# TYPE hbam_pipeline_feed_wall_seconds gauge' in text
    assert '# TYPE hbam_query_latency_s histogram' in text
    lines = text.splitlines()
    inf = next(ln for ln in lines
               if ln.startswith("hbam_query_latency_s_bucket")
               and '+Inf' in ln)
    count = next(ln for ln in lines
                 if ln.startswith("hbam_query_latency_s_count"))
    assert inf.rsplit(" ", 1)[1] == count.rsplit(" ", 1)[1] == "200"
    vals = [int(ln.rsplit(" ", 1)[1]) for ln in lines
            if ln.startswith("hbam_query_latency_s_bucket")]
    assert vals == sorted(vals)
    d = m.to_dict()
    for labels in (None, {"host": "h1"}):
        assert prometheus_text(d, labels=labels) == \
            jprometheus_text(d, labels=labels)


# ---------------------------------------------------------------------------
# the query engine's latency histogram
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def indexed_bam(tmp_path_factory):
    from hadoop_bam_tpu.formats.bamio import BamWriter
    from hadoop_bam_tpu.split.bai import write_bai

    from fixtures import make_header, make_records
    header = make_header(2)
    recs = make_records(header, 400, seed=5)
    recs.sort(key=lambda r: (header.ref_names.index(r.rname)
                             if r.rname != "*" else 1 << 30, r.pos))
    path = str(tmp_path_factory.mktemp("tobs") / "q.bam")
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    write_bai(path)
    return path


def test_query_latency_histogram_records_per_batch(indexed_bam):
    from hadoop_bam_torch.query import QueryEngine, QueryRequest

    with MetricsContext() as m:
        engine = QueryEngine(device="cpu")
        for region in ("chr1:1-2000", "chr1:2000-9000", "chr2:1-800"):
            engine.query_records([QueryRequest(indexed_bam, region)])
    lat = m.hist_summary("query.latency_s")
    assert lat["count"] == 3
    assert lat["p99"] >= lat["p50"] > 0
    # the chunk decodes ticked the host-decode timers and spans
    assert m.timers["pipeline.host_decode"] > 0
    assert m.timers["pipeline.inflate"] > 0
    assert m.wall_calls["query.decode_wall"] >= 1
    assert m.hist_summary("query.chunk_fetch_s")["count"] >= 1


# ---------------------------------------------------------------------------
# trace contexts
# ---------------------------------------------------------------------------

def test_trace_context_mint_join_and_child_spans():
    assert tctx.current_trace() is None
    with tctx.ensure_trace(op="lib") as a:
        assert len(a.trace_id) == 16 and a.op == "lib"
        with tctx.ensure_trace(op="inner") as b:
            assert b is a                          # joined, not minted
        ids = tctx.begin_span()
        tok, tid, sid, psid = ids
        assert tid == a.trace_id and psid == a.span_id and sid > psid
        assert tctx.current_trace().span_id == sid
        tctx.end_span(tok)
        assert tctx.current_trace() is a
    assert tctx.current_trace() is None and tctx.begin_span() is None
    with tctx.trace_context(op="x", trace_id="abc-1", tenant="t") as c:
        assert (c.trace_id, c.tenant) == ("abc-1", "t")


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_bounds_redaction_and_stats():
    rec = flight.reset(capacity=16, transitions=16)
    for i in range(40):
        rec.record_span(f"s{i}", 0.001, {"api_token": "x", "n": i,
                                         "blob": "z" * 300})
    rec.record_transition("breaker", "decode/native", "open")
    snap = rec.snapshot(reason="r", error="e")
    assert len(snap["spans"]) == 16 and snap["spans"][-1]["name"] == "s39"
    args = snap["spans"][-1]["args"]
    assert args["api_token"] == "[redacted]" and args["n"] == 39
    assert len(args["blob"]) < 200
    st = rec.stats()
    assert st["spans_buffered"] == 16 and st["transitions_buffered"] == 1
    assert st["recent_transitions"][0]["state"] == "open"
    assert rec.dump("no dir") is None               # memory-only default


def test_flight_dump_rotation_and_counter_delta_match_reference(tmp_path):
    docs = {}
    for name, mod, metrics in (("t", flight, base_metrics()),
                               ("j", jflight, jmetrics.base_metrics())):
        rec = mod.reset()
        d = tmp_path / name
        rec.configure(dump_dir=str(d), dump_cap=3)
        metrics.count("x.ticks", 5)
        paths = []
        for i in range(5):
            rec.record_transition("deadline", "query.deadline", "missed",
                                  trace_id="feedface")
            paths.append(rec.dump(f"reason {i}", error="boom"))
            metrics.count("x.ticks", i)
        files = sorted(os.listdir(d))
        assert len(files) == 3 and rec.dumps_written == 5
        assert os.path.basename(paths[-1]) in files
        doc = json.load(open(paths[-1]))
        docs[name] = doc
        assert doc["reason"] == "reason 4" and doc["error"] == "boom"
        assert doc["counters_delta_since_last_dump"] == {
            "x.ticks": 3, "obs.flight_dumps": 1}
    strip = lambda d: {k: v for k, v in d.items() if k != "ts"} | {
        "transitions": [{k: v for k, v in t.items() if k != "ts"}
                        for t in d["transitions"]],
        "counters": {k: v for k, v in d["counters"].items()
                     if k == "x.ticks"}}
    assert strip(docs["t"]) == strip(docs["j"])


def test_demotion_leaves_one_flight_dump(tmp_path):
    from hadoop_bam_torch.resilience import decode_ladder

    flight.recorder().configure(dump_dir=str(tmp_path / "fd"))
    ladder = decode_ladder(str(tmp_path / "f.bam"), "device")
    ladder.confirm_failure("device", RuntimeError("injected device fault"))
    files = os.listdir(tmp_path / "fd")
    assert len(files) == 1 and "plane_demotion" in files[0]
    doc = json.load(open(tmp_path / "fd" / files[0]))
    assert doc["transitions"][-1]["kind"] == "demotion"
    assert doc["transitions"][-1]["name"] == "decode/device"
    assert "injected device fault" in doc["error"]
    assert base_metrics().get("obs.flight_dumps") == 1


def test_breaker_open_and_deadline_miss_dump(tmp_path):
    from hadoop_bam_torch.query.scheduler import Deadline
    from hadoop_bam_torch.resilience import CircuitBreaker

    flight.recorder().configure(dump_dir=str(tmp_path / "fd"))
    br = CircuitBreaker(failure_threshold=1.0, name="tenant/t")
    br.record_failure()
    assert br.state == "open"
    t = [10.0]
    d = Deadline(0.5, clock=lambda: t[0])
    t[0] = 11.0
    assert d.book_miss() and not d.book_miss()
    names = sorted(os.listdir(tmp_path / "fd"))
    assert len(names) == 2
    assert any("breaker_open" in n for n in names)
    assert any("deadline_miss" in n for n in names)
    kinds = [x["kind"] for x in flight.recorder().stats()[
        "recent_transitions"]]
    assert kinds == ["breaker", "deadline"]


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------

def _slo_feed(engine, metrics, clock, plan):
    """Tick ``engine`` through ``plan``: (seconds, good, bad) steps of
    observations into the ``serve.latency_s.t`` histogram."""
    for dt, good, bad in plan:
        for _ in range(good):
            metrics.observe("serve.latency_s.t", 0.05)
        for _ in range(bad):
            metrics.observe("serve.latency_s.t", 5.0)
        clock[0] += dt
        engine.tick(metrics, force=True)


def test_slo_fast_window_flips_before_slow_and_equals_reference():
    out = {}
    for name, mod, mcls in (("t", slo, Metrics),
                            ("j", jslo, jmetrics.Metrics)):
        clock = [1000.0]
        eng = mod.SloEngine(clock=lambda: clock[0], tick_s=10.0,
                            min_events=20)
        m = mcls()
        eng.ensure_latency("latency/t", "serve.latency_s.t", 1.0, 0.99)
        eng.tick(m, force=True)
        # a healthy hour, then a regression
        _slo_feed(eng, m, clock, [(60.0, 50, 0)] * 60)
        healthy = eng.burning("latency/t", m)
        _slo_feed(eng, m, clock, [(30.0, 20, 10)] * 4)
        out[name] = (healthy, eng.burning("latency/t", m),
                     eng.burn_rates(m), eng.summary(m),
                     eng.prometheus_lines(m))
    assert out["t"] == out["j"]
    healthy, now, rates, summary, lines = out["t"]
    assert healthy is None and now == "fast"
    assert rates["latency/t"]["fast"] >= 14.4 > rates["latency/t"]["slow"]
    assert summary["latency/t"]["burning"] == "fast"
    assert lines[0] == "# TYPE hbam_slo_burn_rate gauge"


def test_slo_min_events_and_lru_bound():
    clock = [0.0]
    eng = slo.SloEngine(clock=lambda: clock[0], min_events=64)
    m = Metrics()
    eng.ensure_latency("latency/t", "serve.latency_s.t", 1.0, 0.99)
    eng.tick(m, force=True)
    for _ in range(10):
        m.observe("serve.latency_s.t", 9.0)       # all bad, too few
    clock[0] += 5
    assert eng.burn_rates(m)["latency/t"] == {"fast": 0.0, "slow": 0.0}
    assert eng.burning("nope", m) is None
    for i in range(slo._MAX_OBJECTIVES + 10):
        eng.ensure_latency(f"latency/{i}", f"h{i}", 1.0, 0.99)
    assert len(eng.objectives()) == slo._MAX_OBJECTIVES
    assert not eng.tick(m)                        # rate-limited
