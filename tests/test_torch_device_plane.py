"""The port's device decode plane drivers against the JAX package's, on
the CPU: ``flagstat_file`` and ``seq_stats_file`` with
``inflate_backend="device"`` (the port's kernels run their plain versions
on CPU tensors) equal the JAX drivers with the same backend and the
port's own native plane, on clean files and under corruption; plus the
"auto"/"device" configuration rules.

Tolerances: flagstat counters, n_reads and base_hist are equal;
mean_gc / mean_qual agree within rtol 1e-6 (the JAX package sums f32
per-chunk partials, the port f64, in other orders)."""
import dataclasses
import io
import random

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats import bgzf as jbgzf
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.split.planners import plan_bam_spans as jax_plan
from hadoop_bam_torch import config as tconfig
from hadoop_bam_torch.config import HBamConfig, config_from_dict
from hadoop_bam_torch.ops.inflate import block_table
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.split.planners import plan_bam_spans
from hadoop_bam_torch.utils import native as tnative
from hadoop_bam_torch.utils.errors import PlanError

from fixtures import make_header, make_records


def reference_native_loaded(limit_s: float = 60.0) -> bool:
    """Load the JAX package's native library, retrying a failed load for
    up to ``limit_s`` seconds.  That package compiles its library in
    place, unlocked, on first use, and remembers a failed load for the
    life of the process.  When several pytest-xdist workers of a fresh
    checkout collect the suite at once (``tests/test_device_planes.py``
    and ``tests/test_inflate_device.py`` load it at import), one worker
    can load the file while another worker's linker is rewriting it;
    every later test of that worker that compares with the reference's
    native or device plane then fails.  By the time this module is
    collected the other workers' builds are done, so a retry loads the
    whole file."""
    import time
    from hadoop_bam_tpu.utils import native as jnative
    deadline = time.monotonic() + limit_s
    while jnative.load() is None and time.monotonic() < deadline:
        jnative._tried = False
        if jnative.load() is not None:
            break
        time.sleep(1.0)
    return jnative.load() is not None


# at collection, before any test of this worker runs (xdist workers
# collect the whole suite first)
reference_native_loaded()

DEVICE = HBamConfig(inflate_backend="device")
NATIVE = HBamConfig(inflate_backend="native")


def _jax_cfg(**kw):
    return dataclasses.replace(JAX_CONFIG, inflate_backend="device",
                               retry_backoff_base_s=0.001,
                               retry_backoff_max_s=0.002, **kw)


def _write(path, n, seed):
    from hadoop_bam_tpu.formats.bamio import write_bam
    header = make_header()
    records = make_records(header, n, seed=seed)
    for i, r in enumerate(records):   # every flagstat counter non-zero
        if r.flag & 0x1:
            r.flag |= (0x100 if i % 13 == 0 else 0) | \
                (0x800 if i % 17 == 0 else 0) | (0x8 if i % 19 == 0 else 0)
            if i % 23 == 0:
                r.rnext = "chr1" if r.rname != "chr1" else "chr2"
                r.pnext = 100
        r.flag |= 0x400 if i % 7 == 0 else 0
    write_bam(path, header, records)
    return path


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("tdp") / "p.bam"), 3000, 11)


def _seq_equal(a, b):
    assert a["n_reads"] == b["n_reads"]
    np.testing.assert_array_equal(np.asarray(a["base_hist"]),
                                  np.asarray(b["base_hist"]))
    for k in ("mean_gc", "mean_qual"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)


def _run_both(path, t_spans=None, j_spans=None, **jkw):
    """(port device, JAX device, port native) results of both drivers."""
    tcfg = dataclasses.replace(DEVICE, **jkw)
    ncfg = dataclasses.replace(NATIVE, **jkw)
    flag = (tp.flagstat_file(path, device="cpu", config=tcfg, spans=t_spans),
            jp.flagstat_file(path, config=_jax_cfg(**jkw), spans=j_spans),
            tp.flagstat_file(path, device="cpu", config=ncfg, spans=t_spans))
    seq = (tp.seq_stats_file(path, device="cpu", config=tcfg, spans=t_spans),
           jp.seq_stats_file(path, config=_jax_cfg(**jkw), spans=j_spans),
           tp.seq_stats_file(path, device="cpu", config=ncfg, spans=t_spans))
    return flag, seq


def test_default_spans_match_jax_and_native(bam):
    flag, seq = _run_both(bam)
    assert flag[0] == flag[1] == flag[2]
    assert all(v > 0 for v in flag[0].values()), flag[0]
    _seq_equal(seq[0], seq[1])
    _seq_equal(seq[0], seq[2])
    assert seq[0]["n_reads"] == 3000


@pytest.mark.parametrize("check_crc", [False, True])
def test_explicit_spans_match_jax_and_native(bam, check_crc):
    """Every boundary of a pinned 6-span plan cuts a record: the cut
    records finish through the host fixup."""
    t_spans = plan_bam_spans(bam, num_spans=6)
    j_spans = jax_plan(bam, num_spans=6)
    assert len(t_spans) > 1
    flag, seq = _run_both(bam, t_spans, j_spans, check_crc=check_crc)
    assert flag[0] == flag[1] == flag[2]
    _seq_equal(seq[0], seq[1])
    _seq_equal(seq[0], seq[2])


def test_overwide_span_remainder_goes_to_host(tmp_path, monkeypatch):
    """A span of more than DEVICE_PLANE_MAX_BLOCKS blocks: its first 64
    blocks go through the device step, the rest through the host."""
    monkeypatch.setattr(jbgzf, "WRITE_PAYLOAD_SIZE", 2048)
    path = _write(str(tmp_path / "tiny.bam"), 1500, 7)
    monkeypatch.undo()
    n_blocks = block_table(open(path, "rb").read())["isize"].size
    assert n_blocks > tp.DEVICE_PLANE_MAX_BLOCKS
    spans = plan_bam_spans(path, num_spans=1)
    flag, seq = _run_both(path, spans, jax_plan(path, num_spans=1))
    assert flag[0] == flag[1] == flag[2]
    _seq_equal(seq[0], seq[1])
    _seq_equal(seq[0], seq[2])


def _rewrite(path, out, edit):
    """Inflate ``path``, apply ``edit`` to the bytes, BGZF them again."""
    from hadoop_bam_tpu.ops.inflate import inflate_span
    data = bytearray(inflate_span(open(path, "rb").read())[0].tobytes())
    edit(data)
    sink = io.BytesIO()
    w = jbgzf.BGZFWriter(sink)
    w.write(bytes(data))
    w.close()
    with open(out, "wb") as f:
        f.write(sink.getvalue())
    return out


def _outcome(fn):
    """("ok", result) or ("err", the builtin class a caller catches):
    every corruption class of both packages is a ValueError."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("err", "ValueError", type(e).__name__)


def _class(o):
    return o if o[0] == "ok" else o[:2]


def test_corrupt_chain_same_class(bam, tmp_path):
    """A block_size of 5 mid-file: CorruptDataError on the port's device
    plane (adaptive planes off), and the same builtin class on the JAX
    device plane and the port's native plane.  With the default adaptive
    planes the device plane's fault demotes to the host planes, which
    fail too, and both packages raise a ValueError (the reference's host
    planes name it after their fused decode, which the port lacks)."""
    from hadoop_bam_tpu.formats.bamio import read_bam_header
    from hadoop_bam_tpu.ops.inflate import inflate_span, walk_records
    data, _ = inflate_span(open(bam, "rb").read())
    _, voff = read_bam_header(bam)
    offs, _ = walk_records(data, start=voff & 0xFFFF)
    victim = int(offs[len(offs) // 2])

    def edit(b):
        b[victim:victim + 4] = (5).to_bytes(4, "little")
    bad = _rewrite(bam, str(tmp_path / "chain.bam"), edit)
    static = dataclasses.replace(DEVICE, adaptive_planes=False)
    for fn in (tp.flagstat_file, tp.seq_stats_file):
        got = _outcome(lambda: fn(bad, device="cpu", config=static))
        assert got == ("err", "ValueError", "CorruptDataError")
        nat = _outcome(lambda: fn(bad, device="cpu", config=NATIVE))
        assert _class(nat) == _class(got)
    for tfn, jfn in ((tp.flagstat_file, jp.flagstat_file),
                     (tp.seq_stats_file, jp.seq_stats_file)):
        got = _outcome(lambda: tfn(bad, device="cpu", config=DEVICE))
        assert _class(got) == _class(_outcome(
            lambda: jfn(bad, config=_jax_cfg()))) == ("err", "ValueError")
        assert _class(_outcome(lambda: jfn(
            bad, config=_jax_cfg(adaptive_planes=False)))) == \
            ("err", "ValueError")


def test_byte_flips_same_outcome_class(bam, tmp_path):
    """One byte flipped at a time across the compressed file: the port's
    device plane gives the same counters as its native plane and the JAX
    device plane, or the same class of error."""
    raw = open(bam, "rb").read()
    rng = random.Random(17)
    for pos in rng.sample(range(len(raw)), 6) + [len(raw) * 2 // 3]:
        bad = bytearray(raw)
        bad[pos] ^= 0xFF
        p = str(tmp_path / f"flip{pos}.bam")
        with open(p, "wb") as f:
            f.write(bytes(bad))
        dev = _outcome(lambda: tp.flagstat_file(p, device="cpu",
                                                config=DEVICE))
        nat = _outcome(lambda: tp.flagstat_file(p, device="cpu",
                                                config=NATIVE))
        jax = _outcome(lambda: jp.flagstat_file(p, config=_jax_cfg()))
        assert _class(dev) == _class(nat) == _class(jax), pos
    cut = str(tmp_path / "cut.bam")
    with open(cut, "wb") as f:
        f.write(raw[:len(raw) * 2 // 3])
    dev = _outcome(lambda: tp.seq_stats_file(cut, device="cpu",
                                             config=DEVICE))
    nat = _outcome(lambda: tp.seq_stats_file(cut, device="cpu",
                                             config=NATIVE))
    assert dev[0] == "err" and _class(dev) == _class(nat)


def test_crc_flip_caught_only_with_check_crc(bam, tmp_path):
    raw = open(bam, "rb").read()
    t = block_table(raw)
    i = int(np.argmax(t["cdata_len"]))
    bad = bytearray(raw)
    bad[int(t["cdata_off"][i] + t["cdata_len"][i])] ^= 0xFF
    p = str(tmp_path / "crc.bam")
    with open(p, "wb") as f:
        f.write(bytes(bad))
    clean = tp.flagstat_file(bam, device="cpu", config=NATIVE)
    assert tp.flagstat_file(p, device="cpu", config=DEVICE) == clean
    _seq_equal(tp.seq_stats_file(p, device="cpu", config=DEVICE),
               tp.seq_stats_file(bam, device="cpu", config=NATIVE))
    crc = dataclasses.replace(DEVICE, check_crc=True)
    for fn in (tp.flagstat_file, tp.seq_stats_file):
        with pytest.raises(tp.bgzf.BGZFError, match="CRC32 mismatch"):
            fn(p, device="cpu", config=crc)
    with pytest.raises(jbgzf.BGZFError, match="CRC32 mismatch"):
        jp.flagstat_file(p, config=_jax_cfg(check_crc=True))


def test_missing_native_library_is_plan_error(bam, monkeypatch):
    def broken():
        raise tnative.NativeBuildError("no g++")
    monkeypatch.setattr(tnative, "load", broken)
    for fn in (tp.flagstat_file, tp.seq_stats_file):
        with pytest.raises(PlanError):
            fn(bam, device="cpu", config=DEVICE)


def test_span_mode_inflates_on_host_under_device_plane(bam):
    ref = tp.flagstat_file(bam, device="cpu", config=NATIVE)
    assert tp.flagstat_file(bam, device="cpu", config=DEVICE,
                            mode="span") == ref


def test_config_auto_and_device():
    assert tconfig.DEFAULT_CONFIG.inflate_backend == "auto" == \
        JAX_CONFIG.inflate_backend
    for name in tconfig.INFLATE_BACKENDS:
        jcfg = dataclasses.replace(JAX_CONFIG, inflate_backend=name)
        cfg = config_from_dict(dataclasses.asdict(jcfg))
        assert cfg.inflate_backend == name
        want = "native" if name == "auto" else name
        assert tconfig.resolve_inflate_backend(cfg) == want
    assert HBamConfig(inflate_backend="device").host_backend == "native"
    assert HBamConfig(inflate_backend="zlib").host_backend == "zlib"
    with pytest.raises(PlanError):
        HBamConfig(inflate_backend="gpu")
    with pytest.raises(PlanError):
        config_from_dict({"inflate_backend": "fused"})


def test_auto_is_native_on_a_card_and_runs_no_probe(monkeypatch, bam):
    """On a card too, "auto" resolves to the native plane without timing
    anything: the device plane runs only when a caller names it."""
    from hadoop_bam_torch.ops import inflate_device as tid
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def probe(*_a, **_k):
        raise AssertionError("auto took the device plane")
    monkeypatch.setattr(tid, "probe_device_plane", probe)
    assert tconfig.resolve_inflate_backend(HBamConfig()) == "native"
    assert tconfig.resolve_inflate_backend(None) == "native"
    ref = tp.flagstat_file(bam, device="cpu", config=NATIVE)
    monkeypatch.setattr(tp, "_device_plane", probe)
    assert tp.flagstat_file(bam, device="cpu", config=HBamConfig()) == ref
