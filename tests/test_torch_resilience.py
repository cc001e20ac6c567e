"""The port's span failure policy against the JAX package's, on the CPU:
retry, quarantine, the circuit breakers, the demotion ladder and chaos,
on the fixtures of tests/test_faults.py, tests/test_resilience.py and
tests/test_device_planes.py.

Both packages run on the same file, plans, settings and chaos (the same
fault specs installed in each package's own registry), with an injected
clock and sleep in both: no test sleeps for real.  Results are compared
exactly: flagstat counters, n_reads and base_hist equal, mean_gc /
mean_qual within rtol 1e-6 (f32 against f64 partial sums); quarantine
entries equal in file, virtual-offset range, error class and attempts
(the message text names each package's own exception).  Errors compare
by their failure class and, where the taxonomy names one, their class.
"""
import dataclasses
import os

import numpy as np
import pytest

from hadoop_bam_tpu import resilience as jres
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats import bgzf as jbgzf
from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.resilience.chaos import PointFault as JPointFault
from hadoop_bam_tpu.split.planners import plan_bam_spans as jax_plan
from hadoop_bam_tpu.split.spans import FileVirtualSpan as JSpan
from hadoop_bam_tpu.utils import errors as jerr
from hadoop_bam_tpu.utils import resilient as jrs
from hadoop_bam_tpu.utils.metrics import METRICS as JMETRICS
from hadoop_bam_torch import resilience as tres
from hadoop_bam_torch.config import config_from_dict
from hadoop_bam_torch.ops.kernels import KernelBuildError, KernelLaunchError
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.resilience import chaos as tchaos
from hadoop_bam_torch.resilience.chaos import PointFault
from hadoop_bam_torch.split.planners import plan_bam_spans
from hadoop_bam_torch.split.spans import FileVirtualSpan
from hadoop_bam_torch.synth import flip_block
from hadoop_bam_torch.utils import errors as terr
from hadoop_bam_torch.utils import resilient as trs
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.native import NativeBuildError
from hadoop_bam_torch.utils.seekable import BytesByteSource

from fixtures import make_header, make_records

GEOM = jp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)
TGEOM = tp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)


class FakeClock:
    """Injectable clock + sleep: sleeping advances virtual time only."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append(d)
        self.t += d

    def advance(self, d):
        self.t += d


def _reset():
    for res, rs, m in ((tres, trs, METRICS), (jres, jrs, JMETRICS)):
        res.reset()
        res.chaos.clear_fault_points()
        rs.clear_chaos()
        m.reset()


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """Pristine registries, chaos and counters in both packages, and the
    span retry policy of both on one fake clock (no real sleeps)."""
    _reset()
    clk = FakeClock()

    def policy(mod):
        def make(config):
            p = mod.span_retry_policy(config)
            return dataclasses.replace(p, sleep=clk.sleep, clock=clk)
        return make

    monkeypatch.setattr(tp, "span_retry_policy", policy(trs))
    monkeypatch.setattr(jp, "_span_retry_policy", policy(jrs))
    yield clk
    _reset()


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """tests/test_faults.py's fixture: 4000 records, 3 contigs."""
    path = str(tmp_path_factory.mktemp("tres") / "f.bam")
    header = make_header()
    with BamWriter(path, header) as w:
        for r in make_records(header, 4000, seed=23):
            w.write_sam_record(r)
    return path


def _plans(path, n):
    """The port's and the reference's plans of ``n`` spans (equal)."""
    t = plan_bam_spans(path, num_spans=n)
    j = jax_plan(path, num_spans=n)
    assert [(s.start_voffset, s.end_voffset) for s in t] == \
        [(s.start_voffset, s.end_voffset) for s in j]
    return t, j


def _corrupt_copy(path, out, span=None):
    """``synth.flip_block``: the block nearest the middle of ``span``'s
    compressed range (strictly interior, so one span reads it), or of
    the file."""
    near = (span.start[0] + span.end[0]) // 2 if span is not None \
        else os.path.getsize(path) // 2
    flip_block(path, out, near)
    return out


def _cfg(**kw):
    base = dict(retry_backoff_base_s=0.001, retry_backoff_max_s=0.002)
    base.update(kw)
    return dataclasses.replace(JAX_CONFIG, **base)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- compared below
        return ("err", e)


def _entries(q):
    """Manifest entries without the message text, in span order (they
    land in completion order)."""
    return sorted(({k: v for k, v in e.items() if k not in ("error", "host")}
                   for e in q), key=lambda e: e["span_start"])


def _same(got, want):
    """Exact parity of two driver outcomes (module docstring)."""
    assert got[0] == want[0], (got, want)
    if got[0] == "err":
        g, w = got[1], want[1]
        assert terr.classify_error(g) == jerr.classify_error(w), (g, w)
        if isinstance(w, (jerr.CircuitBreakerError, jerr.TransientIOError,
                          jerr.PlanError)):
            assert type(g).__name__ == type(w).__name__, (g, w)
        return
    g, w = dict(got[1]), dict(want[1])
    assert ("quarantine" in g) == ("quarantine" in w), (g, w)
    if "quarantine" in w:
        assert _entries(g.pop("quarantine")) == _entries(w.pop("quarantine"))
    assert set(g) == set(w)
    for k, v in w.items():
        if k == "base_hist":
            np.testing.assert_array_equal(g[k], np.asarray(v))
        elif k in ("mean_gc", "mean_qual"):
            np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=k)
        else:
            assert g[k] == v, k


def _headers(path):
    """Both packages' headers, read before any chaos is armed."""
    from hadoop_bam_tpu.formats.bamio import read_bam_header as jread
    from hadoop_bam_torch.formats.bamio import read_bam_header as tread
    return tread(path)[0], jread(path)[0]


def _run(driver, path, jcfg, spans=None, tq=None, jq=None, headers=None):
    """(port outcome, reference outcome) of one driver call."""
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    ts, js = spans if spans is not None else (None, None)
    th, jh = headers if headers is not None else (None, None)
    if driver == "flagstat":
        t = _outcome(lambda: tp.flagstat_file(
            path, device="cpu", config=tcfg, spans=ts, quarantine=tq,
            header=th))
        j = _outcome(lambda: jp.flagstat_file(
            path, config=jcfg, spans=js, quarantine=jq, header=jh))
    else:
        t = _outcome(lambda: tp.seq_stats_file(
            path, device="cpu", config=tcfg, spans=ts, quarantine=tq,
            geometry=TGEOM, header=th))
        j = _outcome(lambda: jp.seq_stats_file(
            path, config=jcfg, spans=js, quarantine=jq, geometry=GEOM,
            header=jh))
    return t, j


def _states(key_plane, path):
    """(port, reference) registry state of one decode domain."""
    key = f"decode/{key_plane}/{os.path.abspath(path)}"
    return (tres.registry().states().get(key),
            jres.registry().states().get(key))


# ---------------------------------------------------------------------------
# tests/test_faults.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_skip_bad_spans_policy(bam, tmp_path, driver):
    """test_faults.py:166: the default raises (bad_spans does not tick);
    skip_bad_spans quarantines the corrupt span without retries, and the
    rest of the file still counts."""
    bad = _corrupt_copy(bam, str(tmp_path / "bad.bam"))
    spans = _plans(bam, 4)
    t, j = _run(driver, bad, _cfg(), spans)
    _same(t, j)
    assert t[0] == "err" and METRICS.get("pipeline.bad_spans") == 0
    cfg = _cfg(skip_bad_spans=True, span_retries=1)
    t, j = _run(driver, bad, cfg, spans)
    _same(t, j)
    key = "total" if driver == "flagstat" else "n_reads"
    assert 0 < t[1][key] < 4000
    for name in ("pipeline.bad_spans", "pipeline.corrupt_spans",
                 "pipeline.transient_retries"):
        assert METRICS.get(name) == JMETRICS.get(name), name
    assert METRICS.get("pipeline.bad_spans") >= 1
    assert METRICS.get("pipeline.transient_retries") == 0


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_quarantine_manifest_names_bad_span(bam, tmp_path, driver):
    """test_faults.py:193: one corrupt interior block + skip_bad_spans:
    the manifest names exactly the bad span, two attempts (native, then
    the zlib oracle), nobody charged; clean runs carry no manifest."""
    tspans, jspans = _plans(bam, 4)
    bad = _corrupt_copy(bam, str(tmp_path / "bad.bam"), tspans[1])
    cfg = _cfg(skip_bad_spans=True, span_retries=3)
    tq, jq = trs.QuarantineManifest(), jrs.QuarantineManifest()
    t, j = _run(driver, bad, cfg, (tspans, jspans), tq, jq)
    _same(t, j)
    assert _entries(tq.to_dicts()) == [{
        "path": tspans[1].path, "span_start": tspans[1].start_voffset,
        "span_end": tspans[1].end_voffset, "error_class": "corrupt",
        "attempts": 2}]
    assert t[1]["quarantine"] == tq.to_dicts()
    assert tq.total_spans == jq.total_spans == 4
    assert tres.registry().states() == jres.registry().states() == {}
    t, j = _run(driver, bam, cfg, (tspans, jspans))
    _same(t, j)
    assert "quarantine" not in t[1]


def test_circuit_breaker_aborts_run(bam, tmp_path):
    """test_faults.py:249: past max_bad_span_fraction the run raises."""
    bad = _corrupt_copy(bam, str(tmp_path / "bad.bam"))
    cfg = _cfg(skip_bad_spans=True, span_retries=0,
               max_bad_span_fraction=0.1)
    t, j = _run("flagstat", bad, cfg, _plans(bam, 4))
    _same(t, j)
    assert isinstance(t[1], terr.CircuitBreakerError)
    assert "max_bad_span_fraction" in str(t[1])


def test_transient_retry_uses_injected_clock(bam, clock):
    """test_faults.py:263: two transient read faults heal on retry with
    the exact backoff schedule, nothing quarantined."""
    (ts,), (js,) = _plans(bam, 1)
    got = {}
    for name, pkg, rs, span, m in (
            ("port", tp, trs, ts, METRICS), ("ref", jp, jrs, js, JMETRICS)):
        clk = FakeClock()
        policy = rs.RetryPolicy(retries=3, backoff_base_s=0.25,
                                backoff_max_s=8.0, jitter=0.0,
                                sleep=clk.sleep, clock=clk)
        src = rs.FaultInjectingByteSource(
            bam, [rs.FaultSpec("transient", at_read=0, count=2)])
        q = rs.QuarantineManifest(total_spans=1)
        rows, _ = pkg.decode_with_retry(
            lambda s: pkg.decode_span_prefix_host(src, s), span,
            _cfg(span_retries=3), quarantine=q, policy=policy)
        got[name] = (rows, clk.sleeps, dict(src.injected), len(q),
                     m.get("pipeline.transient_retries"),
                     m.get("pipeline.bad_spans"))
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    assert got["port"][1:] == got["ref"][1:] == \
        ([0.25, 0.5], {"transient": 2}, 0, 2, 0)
    assert got["port"][0].shape[0] == 4000


def _dummy_spans():
    return (FileVirtualSpan("/nonexistent.bam", 0, 1 << 16),
            JSpan("/nonexistent.bam", 0, 1 << 16))


@pytest.mark.parametrize("exc", ["corrupt", "plan"])
def test_corrupt_and_plan_fail_fast(exc):
    """test_faults.py:292, :306: corruption burns no retry; a PLAN error
    is never retried and never skipped, even under skip_bad_spans."""
    for pkg, err, rs, span in ((tp, terr, trs, _dummy_spans()[0]),
                               (jp, jerr, jrs, _dummy_spans()[1])):
        attempts = []
        cls = err.CorruptDataError if exc == "corrupt" else err.PlanError

        def fn(_span):
            attempts.append(1)
            raise cls("synthetic")

        cfg = _cfg(span_retries=5, skip_bad_spans=exc == "plan")
        q = rs.QuarantineManifest(total_spans=1)
        with pytest.raises(cls):
            pkg.decode_with_retry(fn, span, cfg, quarantine=q)
        assert len(attempts) == 1 and len(q) == 0


def test_transient_exhaustion_quarantines_as_transient():
    """test_faults.py:327: a fault that never heals is quarantined under
    its own class after the whole budget."""
    out = []
    for pkg, err, rs, span in ((tp, terr, trs, _dummy_spans()[0]),
                               (jp, jerr, jrs, _dummy_spans()[1])):
        def fn(_span):
            raise err.TransientIOError("network is down")

        clk = FakeClock()
        policy = rs.RetryPolicy(retries=2, backoff_base_s=0.1, jitter=0.0,
                                sleep=clk.sleep, clock=clk)
        q = rs.QuarantineManifest(total_spans=8)
        assert pkg.decode_with_retry(fn, span, _cfg(skip_bad_spans=True),
                                     quarantine=q, policy=policy) is None
        out.append((_entries(q.to_dicts()), clk.sleeps))
    assert out[0] == out[1]
    assert out[0][0][0]["error_class"] == "transient"
    assert out[0][0][0]["attempts"] == 3 and out[0][1] == [0.1, 0.2]


def test_retrying_byte_source_deadline():
    """test_faults.py:345: the per-read deadline bounds the backoff; with
    a healthy budget the read heals."""
    from hadoop_bam_tpu.utils.seekable import BytesByteSource as JBytes
    for rs, err, bsrc in ((trs, terr, BytesByteSource),
                          (jrs, jerr, JBytes)):
        clk = FakeClock()
        bad = rs.FaultInjectingByteSource(
            bsrc(b"x" * 64), [rs.FaultSpec("transient", count=10 ** 6)])
        src = rs.RetryingByteSource(bad, rs.RetryPolicy(
            retries=50, backoff_base_s=2.0, backoff_max_s=2.0, jitter=0.0,
            deadline_s=5.0, sleep=clk.sleep, clock=clk))
        with pytest.raises(err.TransientIOError):
            src.pread(0, 16)
        assert clk.sleeps == [2.0, 2.0]
        clk2 = FakeClock()
        heals = rs.FaultInjectingByteSource(
            bsrc(bytes(range(64))),
            [rs.FaultSpec("transient", at_read=0, count=2)])
        src2 = rs.RetryingByteSource(heals, rs.RetryPolicy(
            retries=4, backoff_base_s=0.5, jitter=0.0, sleep=clk2.sleep,
            clock=clk2))
        assert src2.pread(0, 4) == bytes(range(4))
        assert clk2.sleeps == [0.5, 1.0]


def test_classify_error_taxonomy():
    """test_faults.py:423: the same class for the same exception in both
    packages, the builtin ancestry kept; plus the port's deliberate
    difference: backend build/launch and CUDA runtime faults are PLAN."""
    import zlib

    from hadoop_bam_torch.formats import bgzf as tbgzf
    cases = [(lambda m: m.TransientIOError("x"), "transient"),
             (lambda m: TimeoutError(), "transient"),
             (lambda m: ConnectionResetError(), "transient"),
             (lambda m: OSError(5, "EIO"), "transient"),
             (lambda m: m.CorruptDataError("x"), "corrupt"),
             (lambda m: ValueError("malformed"), "corrupt"),
             (lambda m: zlib.error("bad code"), "corrupt"),
             (lambda m: m.PlanError("bad num_spans"), "plan"),
             (lambda m: FileNotFoundError("gone.bam"), "plan"),
             (lambda m: PermissionError("denied"), "plan"),
             (lambda m: RuntimeError("???"), "corrupt")]
    for make, want in cases:
        assert terr.classify_error(make(terr)) == \
            jerr.classify_error(make(jerr)) == want
    assert terr.classify_error(tbgzf.BGZFError("bad magic")) == \
        jerr.classify_error(jbgzf.BGZFError("bad magic")) == "corrupt"
    assert isinstance(terr.TransientIOError("x"), OSError)
    assert isinstance(tbgzf.BGZFError("x"), terr.CorruptDataError)
    assert isinstance(terr.CircuitBreakerError("x"), RuntimeError)
    import torch
    cuda = [torch.OutOfMemoryError("oom"),
            RuntimeError("CUDA error: an illegal memory access")]
    if hasattr(torch, "AcceleratorError"):
        cuda.append(torch.AcceleratorError("device-side assert"))
    for exc in [KernelBuildError("nvcc"), KernelLaunchError("launch"),
                NativeBuildError("g++")] + cuda:
        assert terr.is_backend_fault(exc), exc
        assert terr.classify_error(exc) == "plan", exc
        assert not tres.decode_ladder("x", "device").demotable("device", exc)


def test_quarantine_manifest_merge_and_serde():
    """test_faults.py:446: JSON round trip and the multi-host union
    (dedup by range, canonical order, totals summed) equal the
    reference's."""
    out = []
    for rs, err, (s1, _) in ((trs, terr, _dummy_spans()),
                             (jrs, jerr, _dummy_spans()[::-1])):
        span_cls = type(s1)
        s2 = span_cls("/nonexistent.bam", 1 << 20, 2 << 20)
        a = rs.QuarantineManifest(total_spans=8)
        a.add(s2, err.CorruptDataError("crc"), "corrupt", 1, host=0)
        b = rs.QuarantineManifest(total_spans=8)
        b.add(s1, err.TransientIOError("io"), "transient", 3, host=1)
        b.add(s2, err.CorruptDataError("crc"), "corrupt", 1, host=1)
        merged = a.merged_with([b])
        back = rs.QuarantineManifest.from_json(merged.to_json())
        assert back.to_dicts() == merged.to_dicts()
        assert back.total_spans == merged.total_spans == 16
        out.append((merged.to_dicts(), merged.bad_fraction(),
                    merged.to_json()))
    assert out[0] == out[1]
    assert out[0][1] == 0.125


# ---------------------------------------------------------------------------
# tests/test_resilience.py: the demotion ladder and the quarantine circuit
# ---------------------------------------------------------------------------

def _point(point, kind, count):
    """The same fault schedule armed in both packages' registries."""
    tchaos.install_fault_points(point, [PointFault(kind, count=count)])
    jres.chaos.install_fault_points(point, [JPointFault(kind, count=count)])


def _clear_points():
    tchaos.clear_fault_points()
    jres.chaos.clear_fault_points()


def _on_clock(clk):
    tres.reset(clock=clk)
    jres.reset(clock=clk)


def test_native_faults_demote_to_zlib_then_heal(bam, clock):
    """test_resilience.py:220: native-plane faults demote to the zlib
    oracle's result, the native breaker opens, runs stay on zlib while
    it is open, and a half-open probe after the cooldown heals it."""
    _on_clock(clock)
    spans = _plans(bam, 5)
    oracle = _run("flagstat", bam,
                  _cfg(inflate_backend="zlib", adaptive_planes=False),
                  spans)
    _same(*oracle)
    cfg = _cfg(inflate_backend="native")
    _point("decode.native", "corrupt", 1000)
    t, j = _run("flagstat", bam, cfg, spans)
    _clear_points()
    _same(t, oracle[1])
    _same(j, oracle[1])
    ts, js = _states("native", bam)
    assert ts["state"] == js["state"] == tres.OPEN
    assert ts["failures_total"] >= 3 and js["failures_total"] >= 3
    _same(_run("flagstat", bam, cfg, spans)[0], oracle[1])
    assert _states("native", bam)[0]["state"] == tres.OPEN
    clock.advance(float(cfg.breaker_cooldown_s) + 0.1)
    t, j = _run("flagstat", bam, cfg, spans)
    _same(t, oracle[1])
    _same(j, oracle[1])
    ts, js = _states("native", bam)
    assert ts["state"] == js["state"] == tres.CLOSED
    assert ts["healed_total"] == js["healed_total"] == 1
    assert METRICS.get("resilience.heals") >= 1
    assert METRICS.get("resilience.demotions") >= 3
    assert METRICS.get("chaos.point_faults") == \
        METRICS.get("chaos.decode.native.corrupt") >= 3


def test_pure_data_corruption_charges_no_plane(bam, tmp_path):
    """test_resilience.py:260: both planes fail on corrupt bytes, the
    error is CORRUPT, and no domain is charged."""
    tspans, _ = _plans(bam, 3)
    bad = _corrupt_copy(bam, str(tmp_path / "bad.bam"), tspans[1])
    t, j = _run("flagstat", bad, _cfg(inflate_backend="native"),
                _plans(bad, 3))
    _same(t, j)
    assert t[0] == "err" and terr.classify_error(t[1]) == "corrupt"
    assert tres.registry().states() == jres.registry().states() == {}


def test_adaptive_planes_off_keeps_static_selection(bam):
    """test_resilience.py:283: with adaptive_planes=False a native fault
    raises instead of demoting."""
    _point("decode.native", "corrupt", 1000)
    t, j = _run("flagstat", bam,
                _cfg(inflate_backend="native", adaptive_planes=False),
                _plans(bam, 2))
    _same(t, j)
    assert isinstance(t[1], terr.CorruptDataError)
    assert tres.registry().states() == jres.registry().states() == {}


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_device_step_faults_demote_to_host_then_heal(bam, clock, driver):
    """test_resilience.py:300 (flagstat) and test_device_planes.py:228
    (seq_stats): a device.step fault unwinds the device plane, the call
    demotes to the host planes (the oracle's result), the device domain
    is charged only then (threshold 1: open), an open circuit starts on
    the host planes, and after the cooldown the device plane's probe
    heals it."""
    _on_clock(clock)
    spans = _plans(bam, 3)
    oracle = _run(driver, bam,
                  _cfg(inflate_backend="zlib", adaptive_planes=False),
                  spans)
    _same(*oracle)
    cfg = _cfg(inflate_backend="device", breaker_failure_threshold=1.0)
    _point("device.step", "transient", 1)
    t, j = _run(driver, bam, cfg, spans)
    _clear_points()
    _same(t, oracle[1])
    _same(j, oracle[1])
    ts, js = _states("device", bam)
    assert ts["state"] == js["state"] == tres.OPEN
    assert METRICS.get("resilience.demotions") == 1
    assert METRICS.get("chaos.device.step.transient") == 1
    _same(_run(driver, bam, cfg, spans)[0], oracle[1])
    clock.advance(float(cfg.breaker_cooldown_s) + 0.1)
    t, j = _run(driver, bam, cfg, spans)
    _same(t, oracle[1])
    _same(j, oracle[1])
    ts, js = _states("device", bam)
    assert ts["state"] == js["state"] == tres.CLOSED
    assert ts["healed_total"] == js["healed_total"] == 1
    assert METRICS.get("resilience.heals") == 1


def test_device_plan_error_never_demotes(bam, monkeypatch):
    """test_resilience.py:333: without the native tokenizer the device
    plane raises PlanError through the ladder, untouched."""
    from hadoop_bam_tpu.utils import native as jnative
    from hadoop_bam_torch.utils import native as tnative

    def missing():
        raise NativeBuildError("no host library")

    monkeypatch.setattr(tnative, "load", missing)
    monkeypatch.setattr(jnative, "available", lambda: False)
    t, j = _run("flagstat", bam, _cfg(inflate_backend="device"),
                _plans(bam, 2))
    _same(t, j)
    assert isinstance(t[1], terr.PlanError)
    assert tres.registry().states() == jres.registry().states() == {}


def test_quarantine_circuit_gates_then_heals(bam, tmp_path, clock):
    """test_resilience.py:351: a run past the fraction trips and opens
    the file's quarantine circuit; the next run sheds at the gate; after
    the cooldown the probe runs (and trips again on corrupt bytes); once
    the file is repaired, a probe run heals it."""
    _on_clock(clock)
    clean_bytes = open(bam, "rb").read()
    tspans, _ = _plans(bam, 4)
    bad = _corrupt_copy(bam, str(tmp_path / "q.bam"), tspans[1])
    spans = _plans(bad, 4)
    cfg = _cfg(skip_bad_spans=True, span_retries=0,
               max_bad_span_fraction=0.1)
    t, j = _run("flagstat", bad, cfg, spans)
    _same(t, j)
    assert isinstance(t[1], terr.CircuitBreakerError)
    assert t[1].retry_after_s is not None
    t, j = _run("flagstat", bad, cfg, spans)
    _same(t, j)
    assert "quarantine circuit" in str(t[1])
    assert METRICS.get("resilience.quarantine_gate_shed") == \
        JMETRICS.get("resilience.quarantine_gate_shed") == 1
    clock.advance(float(cfg.breaker_cooldown_s) + 0.1)
    t, j = _run("flagstat", bad, cfg, spans)
    _same(t, j)
    assert "max_bad_span_fraction" in str(t[1])
    tb = tres.quarantine_breaker(bad, config=cfg)
    jb = jres.quarantine_breaker(bad, config=cfg)
    assert tb.state == jb.state == tres.OPEN
    assert tb.opened_total == jb.opened_total == 2
    with open(bad, "wb") as f:
        f.write(clean_bytes)
    clock.advance(float(cfg.breaker_cooldown_s) + 0.1)
    t, j = _run("flagstat", bad, cfg, spans)
    _same(t, j)
    assert "quarantine" not in t[1]
    assert tb.state == jb.state == tres.CLOSED
    assert tb.healed_total == jb.healed_total == 1


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_seeded_byte_chaos_heals_like_the_reference(bam, driver):
    """A seeded read-fault schedule (utils/resilient.SeededFaultSchedule,
    one seed in both packages) under the default policy: transient
    faults heal on retry and the results equal the clean run's."""
    spans = _plans(bam, 4)
    clean = _run(driver, bam, _cfg(), spans)
    _same(*clean)
    headers = _headers(bam)
    trs.install_chaos_seeded(bam, 7, transient_rate=0.5)
    jrs.install_chaos_seeded(bam, 7, transient_rate=0.5)
    t, j = _run(driver, bam, _cfg(span_retries=6), spans, headers=headers)
    _same(t, clean[1])
    _same(j, clean[1])
    assert METRICS.get("chaos.injected_faults") > 0
    assert METRICS.get("pipeline.transient_retries") > 0


# ---------------------------------------------------------------------------
# port-only: the repaired default, the never-demoted backend faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_default_config_retries_a_transient_read_fault(bam, driver):
    """test_faults.py:372's shape with NO settings: the reference's
    default span_retries = 2 retries a transient read fault and returns
    the counters, and so does the port (it used to raise)."""
    spans = _plans(bam, 3)
    headers = _headers(bam)
    clean = _run(driver, bam, _cfg(), spans)
    for rs in (trs, jrs):
        rs.install_chaos(bam, [rs.FaultSpec("transient", at_read=0,
                                            count=2)])
    tcfg = config_from_dict(dataclasses.asdict(JAX_CONFIG))
    assert tcfg.span_retries == 2 and tcfg.adaptive_planes
    t, j = _run(driver, bam, JAX_CONFIG, spans, headers=headers)
    _same(t, clean[1])
    _same(j, clean[1])
    assert "quarantine" not in t[1]
    assert METRICS.get("chaos.injected_faults") == 2
    assert METRICS.get("pipeline.transient_retries") >= 1


# faults of the port's own machinery inside the device plane: where each
# is raised (a kernel wrapper, or the chunk's step) and what it raises
_DEVICE_FAULTS = {
    "launch": ("step", lambda: KernelLaunchError("the kernel failed")),
    "build": ("step", lambda: KernelBuildError("nvcc failed")),
    "refusal": ("kernel", lambda: ValueError(
        "buf must be contiguous on the card")),
    "device_mismatch": ("step", lambda: RuntimeError(
        "Expected all tensors to be on the same device, but found at "
        "least two devices, cuda:0 and cpu!")),
    "bug": ("step", lambda: TypeError("unsupported operand type(s)")),
}


@pytest.mark.parametrize("fault", sorted(_DEVICE_FAULTS))
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_kernel_fault_on_device_plane_never_demotes(bam, monkeypatch, fault,
                                                    driver):
    """A kernel that fails to build or launch, a kernel wrapper that
    refuses its inputs (K7+K8's resolve on flagstat, K10p's gather on
    seq-stats), a device mismatch or a plain bug inside the device plane
    raises through the ladder: no demotion, no retry, no quarantine, no
    domain charged, and the host planes never run."""
    where, make = _DEVICE_FAULTS[fault]
    expected = type(make())
    calls = []

    def broken(*a, **kw):
        calls.append(1)
        raise make()

    if where == "kernel":
        from hadoop_bam_torch.ops import inflate_device
        name = "resolve_pack" if driver == "flagstat" else "payload_gather"
        monkeypatch.setattr(inflate_device, name, broken)
    else:
        name = "device_flagstat_step" if driver == "flagstat" \
            else "device_seq_stats_step"
        monkeypatch.setattr(tp, name, broken)
    host = []
    monkeypatch.setattr(tp, "_flagstat_tiles",
                        lambda *a, **kw: host.append(1))
    monkeypatch.setattr(tp, "iter_payload_tile_groups",
                        lambda *a, **kw: host.append(1))
    tcfg = config_from_dict(dataclasses.asdict(_cfg(
        inflate_backend="device", breaker_failure_threshold=1.0)))
    fn = tp.flagstat_file if driver == "flagstat" else tp.seq_stats_file
    q = trs.QuarantineManifest()
    with pytest.raises(expected):
        fn(bam, device="cpu", config=tcfg, quarantine=q)
    assert calls == [1] and host == [] and len(q) == 0
    assert tres.registry().states() == {}
    assert METRICS.get("resilience.demotions") == 0
    assert METRICS.get("pipeline.transient_retries") == 0


def test_span_mode_takes_retry_and_quarantine(bam, tmp_path):
    """mode="span" runs under the same policy: a corrupt interior block
    is quarantined as in tile mode (same manifest, the counters of the
    other spans), and a transient read fault heals."""
    tspans, jspans = _plans(bam, 4)
    bad = _corrupt_copy(bam, str(tmp_path / "bad.bam"), tspans[1])
    cfg = config_from_dict(dataclasses.asdict(_cfg(skip_bad_spans=True)))
    geom = tp.DecodeGeometry(bytes_cap=1 << 21, records_cap=1 << 14)
    tile = tp.flagstat_file(bad, device="cpu", config=cfg, spans=tspans)
    span = tp.flagstat_file(bad, device="cpu", config=cfg, spans=tspans,
                            geometry=geom, mode="span")
    assert span == tile and len(span["quarantine"]) == 1
    ref = jp.flagstat_file(bad, config=_cfg(skip_bad_spans=True),
                           spans=jspans)
    _same(("ok", span), ("ok", ref))
    trs.install_chaos(bam, [trs.FaultSpec("transient", at_read=0, count=2)])
    got = tp.flagstat_file(bam, device="cpu", spans=tspans, geometry=geom,
                           mode="span")
    trs.clear_chaos()
    assert got == tp.flagstat_file(bam, device="cpu", spans=tspans)
    assert METRICS.get("pipeline.transient_retries") >= 1


@pytest.mark.parametrize("skip", [False, True])
def test_plan_streams_unless_the_circuit_needs_its_length(bam, skip):
    """Without skip_bad_spans the plan streams into the decode (later
    boundaries are guessed while the first spans decode) and the
    manifest's total is set once the last span is handed out; with it,
    the plan is listed first, since the fraction circuit reads the
    total during the run.  Either way the total equals the
    reference's."""
    cfg = config_from_dict(dataclasses.asdict(_cfg(skip_bad_spans=skip)))
    q = trs.QuarantineManifest()
    it = tp._planned(iter(_plans(bam, 4)[0]), cfg, q)
    assert isinstance(it, list) == skip
    assert (q.total_spans is not None) == skip
    assert len(list(it)) == 4 and q.total_spans == 4
    tq, jq = trs.QuarantineManifest(), jrs.QuarantineManifest()
    _same(*_run("flagstat", bam, _cfg(skip_bad_spans=skip), _plans(bam, 4),
                tq, jq))
    assert tq.total_spans == jq.total_spans == 4


# ---------------------------------------------------------------------------
# tests/test_jobs.py: the span window's straggler and hang defence, and
# the drivers under pool.task chaos
# ---------------------------------------------------------------------------

def _window(pkg):
    """(iter_windowed, counters, chaos module) of one package."""
    if pkg == "port":
        return tp.iter_windowed, METRICS, tchaos
    return jp._iter_windowed, JMETRICS, jres.chaos


def _wcfg(pkg, **kw):
    cfg = dataclasses.replace(JAX_CONFIG, **kw)
    return config_from_dict(dataclasses.asdict(cfg)) if pkg == "port" \
        else cfg


@pytest.fixture()
def pool():
    import concurrent.futures as cf
    p = cf.ThreadPoolExecutor(max_workers=8)
    yield p
    p.shutdown(wait=False, cancel_futures=True)


PKGS = pytest.mark.parametrize("pkg", ["port", "reference"])


@PKGS
def test_window_speculates_on_a_straggler(pkg, pool):
    """A unit outliving the soft deadline gets one second copy, which
    wins; order is kept and nothing is yielded twice."""
    import threading
    import time
    windowed, m, _ = _window(pkg)
    seen, lock = set(), threading.Lock()

    def fn(i):
        with lock:
            first = i not in seen
            seen.add(i)
        time.sleep(3.0 if i == 30 and first else 0.005)
        return i

    cfg = _wcfg(pkg, straggler_min_s=0.3, straggler_multiplier=2.0)
    assert list(windowed(pool, range(32), fn, 4, config=cfg)) == \
        list(range(32))
    assert m.get("jobs.speculative_launched") == 1
    assert m.get("jobs.speculative_won") == 1


@PKGS
def test_window_small_runs_never_speculate(pkg, pool):
    windowed, m, _ = _window(pkg)
    cfg = _wcfg(pkg, straggler_min_s=0.0, straggler_multiplier=0.0)
    assert list(windowed(pool, range(8), lambda i: i, 4, config=cfg)) == \
        list(range(8))
    assert m.get("jobs.speculative_launched") == 0


@PKGS
def test_window_timeout_resubmits_past_wedged_worker(pkg, pool):
    import threading
    windowed, m, _ = _window(pkg)
    release, lock, attempts = threading.Event(), threading.Lock(), {}

    def fn(i):
        with lock:
            attempts[i] = attempts.get(i, 0) + 1
            first = attempts[i] == 1
        if i == 5 and first:
            release.wait()
            return -1
        return i * 10

    cfg = _wcfg(pkg, pool_task_timeout_s=0.25, speculative_decode=False)
    try:
        assert list(windowed(pool, range(8), fn, 4, config=cfg)) == \
            [i * 10 for i in range(8)]
        assert m.get("pool.task_timeouts") == 1
        assert m.get("jobs.timeout_resubmits") == 1
    finally:
        release.set()


@PKGS
def test_window_timeout_exhaustion_is_transient(pkg, pool):
    import threading
    windowed, m, _ = _window(pkg)
    release = threading.Event()

    def fn(i):
        if i == 2:
            release.wait()
        return i

    cfg = _wcfg(pkg, pool_task_timeout_s=0.15, span_retries=1,
                speculative_decode=False)
    try:
        with pytest.raises(Exception, match="pool_task_timeout") as e:
            list(windowed(pool, range(4), fn, 2, config=cfg))
        assert type(e.value).__name__ == "TransientIOError"
        assert (m.get("pool.task_timeouts"),
                m.get("jobs.timeout_resubmits")) == (2, 1)
    finally:
        release.set()


@PKGS
def test_window_does_not_resubmit_a_failed_unit(pkg, pool):
    """A unit that failed (not timed out) raises at once: no resubmit."""
    windowed, m, _ = _window(pkg)
    calls = []

    def fn(i):
        if i == 1:
            calls.append(i)
            raise terr.CorruptDataError("bad bytes")
        return i

    cfg = _wcfg(pkg, pool_task_timeout_s=30.0, speculative_decode=False)
    with pytest.raises(terr.CorruptDataError):
        list(windowed(pool, range(4), fn, 2, config=cfg))
    assert calls == [1] and m.get("jobs.timeout_resubmits") == 0


@PKGS
def test_window_timeout_is_active_wait_not_submit_age(pkg):
    """Queue wait behind a healthy single worker does not count against
    the deadline: the last units' submit age passes the 1.0 s timeout,
    their active wait does not."""
    import concurrent.futures as cf
    import time
    windowed, m, _ = _window(pkg)
    one = cf.ThreadPoolExecutor(max_workers=1)

    def fn(i):
        time.sleep(0.7 if i == 0 else 0.3)
        return i

    cfg = _wcfg(pkg, pool_task_timeout_s=1.0, span_retries=0,
                speculative_decode=False)
    try:
        assert list(windowed(one, range(4), fn, 4, config=cfg)) == \
            list(range(4))
        assert m.get("pool.task_timeouts") == 0
    finally:
        one.shutdown(wait=False, cancel_futures=True)


@PKGS
def test_window_pool_task_delay_is_resubmitted(pkg, pool):
    """A ``pool.task`` chaos delay wedges one worker; the window
    resubmits the unit and finishes long before the delay does."""
    import time
    windowed, m, chaos = _window(pkg)
    cfg = _wcfg(pkg, pool_task_timeout_s=0.2, speculative_decode=False)
    t0 = time.perf_counter()
    with chaos.fault_points_on("pool.task", [chaos.PointFault(
            kind="delay", at_call=1, delay_s=3.0)]):
        assert list(windowed(pool, range(6), lambda i: i, 2,
                             config=cfg)) == list(range(6))
    assert time.perf_counter() - t0 < 2.5
    assert m.get("pool.task_timeouts") == 1
    assert m.get("chaos.pool.task.delay") == 1


@PKGS
def test_window_fully_wedged_pool_raises_within_grace(pkg):
    import concurrent.futures as cf
    import threading
    import time
    windowed, m, _ = _window(pkg)
    release = threading.Event()
    two = cf.ThreadPoolExecutor(max_workers=2)
    cfg = _wcfg(pkg, pool_task_timeout_s=0.1, span_retries=1,
                speculative_decode=False)
    t0 = time.perf_counter()
    try:
        with pytest.raises(Exception, match="pool_task_timeout"):
            list(windowed(two, range(4), lambda i: (release.wait(), i)[1],
                          4, config=cfg))
        assert time.perf_counter() - t0 < 5.0
    finally:
        release.set()
        two.shutdown(wait=False, cancel_futures=True)


@PKGS
def test_window_retries_a_transient_submit_fault(pkg, pool):
    windowed, m, chaos = _window(pkg)
    with chaos.fault_points_on("pool.submit", [chaos.PointFault(
            kind="transient", at_call=0)]):
        assert list(windowed(pool, range(5), lambda i: i, 2,
                             config=_wcfg(pkg))) == list(range(5))
    assert m.get("pool.submit_retries") == 1


def test_window_config_fields_carry_over():
    """The four window settings come across with the reference's
    defaults and values; without a config the wait is the plain blocking
    one: a slow unit is waited for, nothing times out or speculates."""
    import concurrent.futures as cf
    import time
    d = config_from_dict(dataclasses.asdict(JAX_CONFIG))
    assert (d.pool_task_timeout_s, d.speculative_decode,
            d.straggler_multiplier, d.straggler_min_s) == \
        (None, True, 4.0, 0.5)
    c = config_from_dict(dataclasses.asdict(dataclasses.replace(
        JAX_CONFIG, pool_task_timeout_s=2.5, speculative_decode=False,
        straggler_multiplier=3.0, straggler_min_s=0.1)))
    assert (c.pool_task_timeout_s, c.speculative_decode,
            c.straggler_multiplier, c.straggler_min_s) == \
        (2.5, False, 3.0, 0.1)
    with cf.ThreadPoolExecutor(2) as p:
        assert list(tp.iter_windowed(
            p, range(3), lambda i: (time.sleep(0.3 if i == 1 else 0), i)[1],
            2)) == [0, 1, 2]
    assert METRICS.get("pool.task_timeouts") == 0
    assert METRICS.get("jobs.speculative_launched") == 0


def _drive(pkg, driver, path, jcfg, spans):
    """The outcome of one package's driver call (``_run`` runs both)."""
    ts, js = spans
    if pkg == "port":
        tcfg = config_from_dict(dataclasses.asdict(jcfg))
        if driver == "flagstat":
            return _outcome(lambda: tp.flagstat_file(
                path, device="cpu", config=tcfg, spans=ts))
        return _outcome(lambda: tp.seq_stats_file(
            path, device="cpu", config=tcfg, spans=ts, geometry=TGEOM))
    if driver == "flagstat":
        return _outcome(lambda: jp.flagstat_file(path, config=jcfg,
                                                 spans=js))
    return _outcome(lambda: jp.seq_stats_file(path, config=jcfg, spans=js,
                                              geometry=GEOM))


def _no_live_jobs_within(seconds):
    """Poll (the garbage collector off) until no fused native job is
    left: a job an abandoned copy started after the driver returned is
    closed by the window's cleanup when its task ends."""
    import gc
    import time
    from hadoop_bam_torch.utils import native
    gc.disable()
    try:
        t_end = time.perf_counter() + seconds
        while native.live_jobs() and time.perf_counter() < t_end:
            time.sleep(0.02)
        return native.live_jobs()
    finally:
        gc.enable()


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_hung_spans_raise_transient_like_the_reference(bam, driver, skip):
    """Every pool task wedged past ``pool_task_timeout_s``: both packages
    raise TransientIOError within a bounded wall, under
    ``skip_bad_spans`` too (the reference's window raises outside the
    span policy, so nothing is quarantined), with the same timeout
    counters; no native job outlives the abandoned copies."""
    import time
    spans = _plans(bam, 4)
    cfg = _cfg(pool_task_timeout_s=0.1, span_retries=1,
               speculative_decode=False, skip_bad_spans=skip,
               decode_pool_workers=4)
    out = []
    for chaos in (tchaos, jres.chaos):
        with chaos.fault_points_on("pool.task", [chaos.PointFault(
                kind="delay", count=1000, delay_s=0.6)]):
            t0 = time.perf_counter()
            got = _drive("port" if chaos is tchaos else "reference",
                         driver, bam, cfg, spans)
            out.append((got, time.perf_counter() - t0))
    (t, t_wall), (j, _) = out
    _same(t, j)
    assert t[0] == "err" and type(t[1]).__name__ == "TransientIOError"
    assert "pool_task_timeout_s" in str(t[1])
    assert t_wall < 3.0
    for name in ("pool.task_timeouts", "jobs.timeout_resubmits",
                 "pipeline.bad_spans"):
        assert METRICS.get(name) == JMETRICS.get(name), name
    assert METRICS.get("pipeline.bad_spans") == 0
    assert _no_live_jobs_within(10.0) == 0


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_one_hung_span_is_resubmitted_like_the_reference(bam, driver, skip):
    """One wedged task: both packages resubmit it and return the whole
    file's result, with one timeout and one resubmit each, before the
    wedged copy wakes."""
    import time
    spans = _plans(bam, 4)
    cfg = _cfg(pool_task_timeout_s=0.2, speculative_decode=False,
               skip_bad_spans=skip, decode_pool_workers=4)
    res = []
    for chaos in (tchaos, jres.chaos):
        with chaos.fault_points_on("pool.task", [chaos.PointFault(
                kind="delay", at_call=1, delay_s=1.0)]):
            res.append(_drive("port" if chaos is tchaos else "reference",
                              driver, bam, cfg, spans))
    _same(*res)
    assert res[0][0] == "ok" and "quarantine" not in res[0][1]
    for name in ("pool.task_timeouts", "jobs.timeout_resubmits"):
        assert METRICS.get(name) == JMETRICS.get(name) == 1, name
    # the wedged copy wakes, decodes and is reaped; nothing is recorded
    assert _no_live_jobs_within(5.0) == 0
    time.sleep(1.2)
    assert _no_live_jobs_within(5.0) == 0
    assert METRICS.get("pipeline.bad_spans") == 0


@pytest.fixture(scope="module")
def many_spans_bam(tmp_path_factory):
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path_factory.mktemp("tres_spec") / "s.bam")
    truth = write_synthetic_bam(path, 40_000, 5)
    return path, truth


@pytest.mark.parametrize("driver", ["flagstat", "seq_stats"])
def test_speculative_race_like_the_reference(many_spans_bam, driver):
    """A straggling span decode past the soft deadline: both packages
    race one second copy, the copy wins, the counters match and the
    result is the truth.  The call returns while the losing copy is
    still wedged (its chaos sleep is released only afterwards), and once
    released its native job is closed by the window's cleanup (the
    port's fused chunk streams)."""
    import threading
    path, truth = many_spans_bam
    spans = _plans(path, 40)
    assert len(spans[0]) >= 30
    # the soft deadline is the p95 of the units' turnaround (submit to
    # the consumer's pick-up): a straggler held until the call returns
    # outlives it however slowly the consumer drains the window
    cfg = _cfg(straggler_min_s=0.2, straggler_multiplier=1.0,
               decode_pool_workers=4)
    res = []
    for chaos in (tchaos, jres.chaos):
        release, woke = threading.Event(), []

        def sleep(d, release=release, woke=woke):
            release.wait(d)
            woke.append(d)

        with chaos.fault_points_on("pool.task", [chaos.PointFault(
                kind="delay", at_call=28, delay_s=120.0)], sleep=sleep):
            res.append(_drive("port" if chaos is tchaos else "reference",
                              driver, path, cfg, spans))
            assert woke == [], "the call returned before the loser woke"
            release.set()
    import time
    time.sleep(0.5)                 # the released losers start their jobs
    assert _no_live_jobs_within(10.0) == 0
    _same(*res)
    key = "total" if driver == "flagstat" else "n_reads"
    assert res[0][1][key] == truth.n_reads
    for name in ("jobs.speculative_launched", "jobs.speculative_won"):
        assert METRICS.get(name) == JMETRICS.get(name) >= 1, name
