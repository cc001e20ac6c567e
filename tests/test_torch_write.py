"""The port's write path and k-way merge against the JAX package's, on
the CPU: ``ParallelBGZFWriter`` bytes and resolved voffsets,
``write_bam_records`` bytes and sidecars, ``BamIndexingSink`` blobs,
atomic publication, the deflate worker's fault policy, and the cases of
tests/test_kmerge.py through both packages' ``kmerge``.
"""
import concurrent.futures as cf
import dataclasses
import heapq
import io
import os
import random

import numpy as np
import pytest

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JCONFIG
from hadoop_bam_tpu.split import kmerge as jk
from hadoop_bam_tpu.write import (
    BamIndexingSink as JSink, ParallelBGZFWriter as JWriter,
    write_bam_records as jwrite,
)
from hadoop_bam_torch.config import config_from_dict
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.split import kmerge as tk
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.write import (
    BamIndexingSink, ParallelBGZFWriter, resolve_index_kinds,
    write_bam_records,
)

from fixtures import make_header, make_records


def _coord_sorted(header, recs):
    def key(r):
        rid = (header.ref_names.index(r.rname) if r.rname != "*"
               else 1 << 30)
        return (rid, r.pos)
    return sorted(recs, key=key)


def _record_chunks(header, recs, n_chunks=4):
    """(data, offsets) chunks of encoded records, file order."""
    blobs = [r.to_bam_bytes(header) for r in recs]
    per = max(1, len(blobs) // n_chunks)
    for i in range(0, len(blobs), per):
        group = blobs[i:i + per]
        lens = np.asarray([len(b) for b in group], np.int64)
        yield b"".join(group), np.cumsum(lens) - lens


@pytest.fixture(scope="module")
def sorted_fixture():
    header = make_header(2)
    recs = _coord_sorted(header, make_records(header, 1500, seed=11))
    return header, recs


def _payload(seed):
    rng = random.Random(seed)
    return (bytes(rng.randrange(256) for _ in range(200_000))
            + b"G" * 400_000
            + bytes(rng.randrange(4) for _ in range(150_000)))


# ---------------------------------------------------------------------------
# ParallelBGZFWriter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers,level", [(0, 6), (1, 6), (4, 6), (8, 6),
                                           (2, 1), (2, 9)])
def test_parallel_bgzf_bytes_equal_the_reference(workers, level):
    """Randomized splits of the write() calls and worker counts (0 =
    serial in-line): the port's bytes equal the reference's writer and
    the port's serial BGZFWriter."""
    data = _payload(workers + level)
    rng = random.Random(workers)
    splits = []
    i = 0
    while i < len(data):
        n = rng.randrange(1, 100_000)
        splits.append(data[i:i + n])
        i += n
    outs = []
    for cls in (ParallelBGZFWriter, JWriter):
        pool = cf.ThreadPoolExecutor(max(workers, 1)) if workers else None
        try:
            sink = io.BytesIO()
            w = cls(sink, level=level, pool=pool, max_inflight=workers)
            for s in splits:
                w.write(s)
            w.close()
            outs.append(sink.getvalue())
        finally:
            if pool:
                pool.shutdown()
    serial = io.BytesIO()
    with bgzf.BGZFWriter(serial, level=level) as w:
        w.write(data)
    assert outs[0] == outs[1] == serial.getvalue()
    assert outs[0].endswith(bgzf.EOF_BLOCK)


def test_parallel_bgzf_no_eof_and_voffsets_equal_the_reference(
        sorted_fixture):
    header, recs = sorted_fixture
    blobs = [r.to_bam_bytes(header) for r in recs]
    got = []
    for cls in (ParallelBGZFWriter, JWriter):
        sink = io.BytesIO()
        w = cls(sink, max_inflight=4, pool=cf.ThreadPoolExecutor(4),
                write_eof=False)
        tokens = []
        w.write(header.to_bam_bytes())
        for b in blobs:
            tokens.append(w.tell_payload_offset())
            w.write(b)
        w.close()
        got.append((sink.getvalue(),
                    w.resolve_voffsets(np.asarray(tokens, np.int64)).tolist(),
                    w.data_end_voffset, w.bytes_out))
    assert got[0] == got[1]
    assert not got[0][0].endswith(bgzf.EOF_BLOCK)


def test_parallel_writer_errors():
    pw = ParallelBGZFWriter(io.BytesIO(), max_inflight=0)
    pw.write(b"x" * 10)
    with pytest.raises(PlanError):
        pw.resolve_voffsets(np.asarray([0]))
    pw.close()
    with pytest.raises(PlanError):
        pw.write(b"y")
    with pytest.raises(PlanError):
        ParallelBGZFWriter(io.BytesIO(), max_inflight=-1)

    class BadSink:
        def write(self, b):
            raise OSError("disk on fire")

    pw = ParallelBGZFWriter(BadSink(), max_inflight=2,
                            pool=cf.ThreadPoolExecutor(2))
    with pytest.raises(OSError, match="disk on fire"):
        for _ in range(64):
            pw.write(b"z" * bgzf.WRITE_PAYLOAD_SIZE)
        pw.close()


@pytest.mark.parametrize("kind,count", [("transient", 3), ("corrupt", 1000)])
def test_deflate_worker_faults(kind, count):
    """A transient fault in a deflate worker retries in place (the same
    bytes); a corrupt one fails the write."""
    from hadoop_bam_torch.resilience import chaos
    from hadoop_bam_torch.resilience.chaos import PointFault, fault_points_on
    payload = _payload(3)
    cfg = config_from_dict(dataclasses.asdict(dataclasses.replace(
        JCONFIG, retry_backoff_base_s=0.0, retry_backoff_max_s=0.0,
        span_retries=4)))

    def run(faults):
        sink = io.BytesIO()
        with fault_points_on("write.deflate", list(faults)):
            with ParallelBGZFWriter(sink, level=6, max_inflight=4,
                                    config=cfg) as w:
                for lo in range(0, len(payload), 37_000):
                    w.write(payload[lo:lo + 37_000])
        return sink.getvalue()

    clean = run([])
    METRICS.reset()
    if kind == "transient":
        assert run([PointFault(kind, count=count)]) == clean
        assert METRICS.get("write.deflate_retries") >= count
    else:
        with pytest.raises(CorruptDataError):
            run([PointFault(kind, count=count)])
    assert chaos.injected_counts("write.deflate") == {}


# ---------------------------------------------------------------------------
# write_bam_records, BamIndexingSink, publication
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds,level", [("auto", 6), ("none", 6),
                                         ("bai,splitting-bai", 1),
                                         ("sbi", 6)])
def test_write_bam_records_equal_the_reference(tmp_path, sorted_fixture,
                                               kinds, level):
    header, recs = sorted_fixture
    jcfg = dataclasses.replace(JCONFIG, write_index_kinds=kinds,
                               write_compress_level=level,
                               splitting_index_granularity=97)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    a, b = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    ra = write_bam_records(a, header, _record_chunks(header, recs, 5),
                           config=tcfg)
    rb = jwrite(b, header, _record_chunks(header, recs, 3), config=jcfg)
    assert (ra.records, ra.bytes_out) == (rb.records, rb.bytes_out)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert sorted(ra.sidecars) == sorted(rb.sidecars)
    for suffix in ra.sidecars:
        assert open(a + suffix, "rb").read() == \
            open(b + suffix, "rb").read(), suffix
    assert not [f for f in os.listdir(tmp_path) if "hbam-write-tmp" in f]


def test_indexing_sink_blobs_equal_the_reference(sorted_fixture):
    from hadoop_bam_torch.formats.bam import BamBatch
    header, recs = sorted_fixture
    blobs = {}
    for cls in (BamIndexingSink, JSink):
        sink = cls(2, ("bai", "sbi", "splitting-bai"), granularity=64)
        tok = 0
        for data, offs in _record_chunks(header, recs, 7):
            arr = np.frombuffer(data, np.uint8)
            batch = BamBatch(arr, offs, header=header)
            pos0 = batch.pos.astype(np.int64)
            sink.observe(batch.refid, pos0,
                         pos0 + np.maximum(batch.reference_span(), 1),
                         tok + offs)
            tok += len(data)
        blobs[cls] = sink.finalize(
            lambda t: (t.astype(np.uint64) << np.uint64(16)), 99 << 16, 99)
    assert blobs[BamIndexingSink] == blobs[JSink]
    assert sorted(blobs[JSink]) == [".bai", ".sbi", ".splitting-bai"]


def test_index_kinds_resolve_like_the_reference():
    from hadoop_bam_tpu.write import resolve_index_kinds as jresolve
    for raw in ("auto", "none", "bai", "sbi, bai", ""):
        for container in ("bam", "bcf"):
            jcfg = dataclasses.replace(JCONFIG, write_index_kinds=raw)
            tcfg = config_from_dict(dataclasses.asdict(jcfg))
            try:
                want = jresolve(jcfg, container)
            except ValueError:
                with pytest.raises(PlanError):
                    resolve_index_kinds(tcfg, container)
                continue
            assert resolve_index_kinds(tcfg, container) == want


def test_failed_write_leaves_nothing_visible(tmp_path, sorted_fixture):
    header, recs = sorted_fixture
    out = str(tmp_path / "crash.bam")
    open(out + ".bai", "wb").write(b"stale")

    def bad_chunks():
        yield from _record_chunks(header, recs, n_chunks=8)
        raise RuntimeError("producer died")

    with pytest.raises(RuntimeError, match="producer died"):
        write_bam_records(out, header, bad_chunks())
    assert not os.path.exists(out)
    assert open(out + ".bai", "rb").read() == b"stale"
    # a good write purges every stale sidecar a reader could resolve
    open(out + ".csi", "wb").write(b"stale")
    res = write_bam_records(out, header, _record_chunks(header, recs))
    assert sorted(res.sidecars) == [".bai", ".sbi"]
    assert not os.path.exists(out + ".csi")
    assert open(out + ".bai", "rb").read() != b"stale"


def test_cowritten_bai_queries_like_posthoc_bai(tmp_path, sorted_fixture):
    from hadoop_bam_torch.split.bai import BaiIndex, build_bai
    header, recs = sorted_fixture
    out = str(tmp_path / "q.bam")
    write_bam_records(out, header, _record_chunks(header, recs))
    cowritten = BaiIndex.from_bytes(open(out + ".bai", "rb").read())
    posthoc = build_bai(out)
    for rid in range(len(header.ref_names)):
        for beg, end in ((0, 1 << 29), (5_000, 20_000), (0, 1),
                         (100_000, 400_000)):
            assert cowritten.query(rid, beg, end) \
                == posthoc.query(rid, beg, end), (rid, beg, end)


# ---------------------------------------------------------------------------
# kmerge: the cases of tests/test_kmerge.py through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_kmerge_heap_order_randomized(seed):
    rng = random.Random(7 + seed)
    for _ in range(5):
        k = rng.randint(1, 8)
        streams = [sorted(rng.randint(0, 40)
                          for _ in range(rng.randint(0, 30)))
                   for _ in range(k)]
        want = sorted(x for s in streams for x in s)
        assert list(tk.kmerge([iter(s) for s in streams])) == want
        assert list(tk.kmerge_indexed(streams)) == \
            list(jk.kmerge_indexed(streams))
        grouped = list(tk.kmerge_grouped(streams, key=lambda x: x // 4))
        assert grouped == list(jk.kmerge_grouped(streams,
                                                 key=lambda x: x // 4))


def test_kmerge_keys_ties_and_exhaustion():
    a = [(1, "a0"), (3, "a1"), (3, "a2"), (9, "a3")]
    b = [(2, "b0"), (3, "b1"), (8, "b2")]
    out = list(tk.kmerge([a, b], key=lambda t: t[0]))
    assert [t[0] for t in out] == [1, 2, 3, 3, 3, 8, 9]
    a = [(5, "a0"), (5, "a1")]
    b = [(5, "b0")]
    c = [(5, "c0")]
    out = list(tk.kmerge([a, b, c], key=lambda t: t[0]))
    assert out == [(5, "a0"), (5, "a1"), (5, "b0"), (5, "c0")]
    assert out == list(heapq.merge(a, b, c, key=lambda t: t[0]))
    assert list(tk.kmerge([[1], [0, 2, 4, 6, 8, 10, 12], [], [3, 5]])) == \
        [0, 1, 2, 3, 4, 5, 6, 8, 10, 12]
    assert list(tk.kmerge([])) == list(tk.kmerge([[], [], []])) == []
    assert list(tk.kmerge_grouped([[], []], key=lambda x: x)) == []
    assert list(tk.kmerge_indexed([[1, 4], [2, 3]])) == \
        [(0, 1), (1, 2), (1, 3), (0, 4)]


def test_kmerge_streams_one_item_ahead():
    pulled = []

    def trace(si, items):
        for x in items:
            pulled.append((si, x))
            yield x

    g = tk.kmerge([trace(0, [1, 3]), trace(1, [2, 4])])
    assert next(g) == 1
    assert pulled == [(0, 1), (1, 2)]
    assert next(g) == 2
    assert pulled == [(0, 1), (1, 2), (0, 3)]
    g.close()


def test_kmerge_grouped_runs_of_equal_keys():
    a = [(0, 10), (2, 11), (2, 12)]
    b = [(0, 20), (3, 21)]
    groups = list(tk.kmerge_grouped([a, b], key=lambda t: t[0]))
    assert groups == list(jk.kmerge_grouped([a, b], key=lambda t: t[0]))
    assert groups[1][1] == [(0, (2, 11)), (0, (2, 12))]


def test_spill_merge_equals_the_reference(tmp_path):
    """``_merge_bucket_runs`` on synthetic framed runs: equal to the
    reference's and to the stdlib heapq.merge oracle."""
    from hadoop_bam_tpu.parallel import mesh_sort as jms
    from hadoop_bam_torch.parallel import mesh_sort as tms

    rng = random.Random(13)
    paths = []
    for r in range(5):
        recs = sorted(
            ((rng.randint(0, 3), rng.randint(0, 50), rng.randint(0, 99),
              bytes(rng.randrange(256) for _ in range(rng.randint(0, 12))))
             for _ in range(rng.randint(0, 20))), key=lambda t: t[:3])
        out = bytearray()
        for hi, lo, gidx, payload in recs:
            out += int(hi).to_bytes(4, "little")
            out += int(lo).to_bytes(4, "little")
            out += int(gidx).to_bytes(4, "little", signed=True)
            out += len(payload).to_bytes(4, "little", signed=True)
            out += payload
        p = str(tmp_path / f"run{r}.bin")
        open(p, "wb").write(bytes(out))
        paths.append(p)
    payload, lens = tms._merge_bucket_runs(paths)
    jpayload, jlens = jms._merge_bucket_runs(paths)
    chunks = [p for _k, p in heapq.merge(
        *(tms._iter_run_frames(p) for p in paths), key=lambda kv: kv[0])]
    assert payload == jpayload == b"".join(chunks)
    assert lens.tolist() == jlens.tolist() == [len(c) for c in chunks]
    assert lens.dtype == np.int64


# ---------------------------------------------------------------------------
# ShardedFileWriter and write_bam_shards_concat against the reference's
# ---------------------------------------------------------------------------

def _writers(tmp_path, **kw):
    from hadoop_bam_tpu.write import ShardedFileWriter as JSharded
    from hadoop_bam_torch.write import ShardedFileWriter
    return [cls(str(tmp_path / f"{name}.bam"), 3, **kw)
            for name, cls in (("port", ShardedFileWriter),
                              ("ref", JSharded))]


def test_sharded_writer_commits_and_sweeps_like_the_reference(tmp_path):
    from hadoop_bam_tpu.utils.metrics import METRICS as JMETRICS
    for sw in _writers(tmp_path):
        assert [os.path.basename(p) for p in sw.parts()] == \
            ["part-00000", "part-00001", "part-00002"]
        with sw.open_shard(1) as f:
            f.write(b"one")
            # the part is visible only once its block exits
            assert not os.path.exists(sw.shard_path(1))
        assert open(sw.shard_path(1), "rb").read() == b"one"
        with pytest.raises(RuntimeError, match="mid-part"):
            with sw.open_shard(2) as f:
                f.write(b"half")
                raise RuntimeError("mid-part")
        assert sorted(os.listdir(sw.shard_dir)) == ["part-00001"]
        assert sw.missing_parts() == [sw.shard_path(0), sw.shard_path(2)]
        for name in ("part-00000.tmp", "part-00002.tmp"):
            open(os.path.join(sw.shard_dir, name), "wb").write(b"debris")
        metrics = METRICS if "port" in sw.final_path else JMETRICS
        metrics.reset()
        assert sw.sweep_stale_temps() == 2
        assert metrics.snapshot()["counters"]["write.stale_temps_swept"] == 2
        assert sorted(os.listdir(sw.shard_dir)) == ["part-00001"]
        sw.prepare()
        assert not os.path.exists(sw.shard_dir)
        assert sw.sweep_stale_temps() == 0


def test_sharded_writer_journal_verifies_committed_parts(tmp_path):
    """The port's producer records each part as a ``("shard", k)`` unit
    itself (the reference's writer does it through its ``journal``
    knob); both units match, and both writers verify them alike."""
    from hadoop_bam_tpu.jobs import JobJournal as JJournal
    from hadoop_bam_torch.jobs import (
        JobJournal, file_digest, file_identity_digest,
    )
    inp = tmp_path / "in.dat"
    inp.write_bytes(b"x" * 100)
    ident = [(str(inp), file_identity_digest(str(inp)))]
    units = []
    for sw, journal in zip(_writers(tmp_path), (JobJournal, JJournal)):
        jp = sw.final_path + ".j"
        hdr = dict(kind="k", output=sw.final_path, fingerprint="f",
                   params={}, inputs=ident, fsync=False)
        jr, _ = journal.resume(jp, **hdr)
        port = journal is JobJournal
        if not port:
            sw.journal = jr
        for k in range(3):
            with sw.open_shard(k) as f:
                f.write(bytes([k]) * (k + 5))
            if port:
                size, crc = file_digest(sw.shard_path(k))
                jr.unit_done("shard", k,
                             path=os.path.abspath(sw.shard_path(k)),
                             size=size, crc=crc)
        jr.close()
        if not port:
            sw.journal = None
        jr, state = journal.resume(jp, **hdr)
        jr.close()
        units.append([(state.unit("shard", k)["size"],
                       state.unit("shard", k)["crc"]) for k in range(3)])
        sw.resume_state = state
        assert [sw.shard_committed(k) for k in range(3)] == [True] * 3
        open(sw.shard_path(1), "wb").write(b"\x01" * 5)   # torn part
        os.unlink(sw.shard_path(2))
        assert [sw.shard_committed(k) for k in range(3)] == \
            [True, False, False]
    assert units[0] == units[1]


def test_concatenate_refuses_missing_parts(tmp_path):
    from hadoop_bam_torch.utils.errors import TransientIOError
    port, ref = _writers(tmp_path)
    for sw in (port, ref):
        with sw.open_shard(0) as f:
            f.write(b"a")
        with pytest.raises(OSError, match="missing") as e:
            sw.concatenate(lambda parts: None)
        assert type(e.value).__name__ == "TransientIOError"
        assert os.path.isdir(sw.shard_dir)
    with pytest.raises(TransientIOError):
        port.concatenate(lambda parts: None)
    for k in (1, 2):
        with port.open_shard(k) as f:
            f.write(b"b")
    assert port.concatenate(lambda parts: len(parts)) == 3
    assert not os.path.exists(port.shard_dir)


def _headerless_parts(tmp_path, header, recs, cuts, level):
    """Record parts written as headerless, unterminated BAM pieces by the
    port's BamWriter (``cuts`` the record index each part starts at)."""
    from hadoop_bam_torch.formats.bamio import BamWriter as TWriter
    blobs = [r.to_bam_bytes(header) for r in recs]
    bounds = list(cuts) + [len(blobs)]
    parts = []
    for k, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        p = str(tmp_path / f"part-{k:05d}")
        with TWriter(p, header, level=level, write_header=False,
                     write_eof=False) as w:
            w.write_raw(b"".join(blobs[a:b]), b - a)
        parts.append(p)
    return parts


@pytest.mark.parametrize("cuts,level", [((0,), 6), ((0, 400, 401, 1100), 6),
                                        ((0, 0, 700, 1500), 1)])
def test_shards_concat_equals_one_streaming_write(tmp_path, sorted_fixture,
                                                  cuts, level):
    """Parts (an empty one included) re-blocked into one BGZF stream: the
    bytes and every sidecar equal the reference's concat and one
    streaming ``write_bam_records`` of the same records."""
    from hadoop_bam_tpu.write import write_bam_shards_concat as jconcat
    from hadoop_bam_torch.write import write_bam_shards_concat
    header, recs = sorted_fixture
    jcfg = dataclasses.replace(JCONFIG, write_compress_level=level,
                               write_index_kinds="bai,sbi,splitting-bai")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    parts = _headerless_parts(tmp_path, header, recs, cuts, level)
    a, b, c = (str(tmp_path / f"{n}.bam") for n in ("port", "ref", "one"))
    ra = write_bam_shards_concat(parts, a, header, config=tcfg)
    rb = jconcat(parts, b, header, config=jcfg)
    rc = write_bam_records(c, header, _record_chunks(header, recs, 1),
                           config=tcfg)
    assert ra.records == rb.records == rc.records == len(recs)
    assert open(a, "rb").read() == open(b, "rb").read() == \
        open(c, "rb").read()
    assert sorted(ra.sidecars) == sorted(rb.sidecars) == sorted(rc.sidecars)
    for suffix in ra.sidecars:
        assert open(a + suffix, "rb").read() == \
            open(b + suffix, "rb").read() == open(c + suffix, "rb").read()


def test_shards_concat_retries_transient_part_reads(tmp_path,
                                                    sorted_fixture):
    from hadoop_bam_torch.utils import seekable
    from hadoop_bam_torch.utils.errors import TransientIOError
    from hadoop_bam_torch.write import write_bam_shards_concat
    header, recs = sorted_fixture
    parts = _headerless_parts(tmp_path, header, recs, (0, 750), 6)
    real = seekable.as_byte_source
    fails = {"n": 2}

    def flaky(obj):
        if isinstance(obj, str) and obj == parts[1] and fails["n"]:
            fails["n"] -= 1
            raise TransientIOError("injected part read fault")
        return real(obj)
    tcfg = config_from_dict(dataclasses.asdict(dataclasses.replace(
        JCONFIG, retry_backoff_base_s=0.0)))
    METRICS.reset()
    try:
        seekable.as_byte_source = flaky
        res = write_bam_shards_concat(parts, str(tmp_path / "o.bam"),
                                      header, config=tcfg)
    finally:
        seekable.as_byte_source = real
    assert res.records == len(recs) and fails["n"] == 0
    assert METRICS.snapshot()["counters"]["write.part_read_retries"] == 2
