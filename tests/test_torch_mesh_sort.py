"""The port's mesh sort against the JAX package's ``utils/sort.sort_bam``,
on the CPU: every case of tests/test_mesh_sort.py but the two-process
and CLI ones (ROADMAP Queue 1 item 12) through each exchange (index,
bytes, spill), each output byte-identical to the reference's sort and
to the port's own ``utils/sort.sort_bam``; K15's parts equal the
reference's functions at 1 and 8 devices, its two steps the reference's
on a one-device mesh, and the (hi, lo, index) sort the reference's
three-key sort on keys that tie and wrap.
"""
import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.formats.sam import SamRecord
from hadoop_bam_tpu.parallel import mesh_sort as jms
from hadoop_bam_tpu.utils.sort import sort_bam as jsort_bam
from hadoop_bam_torch.config import DEFAULT_CONFIG
from hadoop_bam_torch.parallel import mesh_sort as ms
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.sort import sort_bam

from fixtures import make_header, make_records


def _write_shuffled(path, recs, header, seed=1):
    rng = random.Random(seed)
    recs = list(recs)
    rng.shuffle(recs)
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    return path


def _ties(header, n):
    return [SamRecord(qname=f"r{i}", flag=0, rname=header.ref_names[0],
                      pos=500, mapq=9, cigar="10M", rnext="*", pnext=0,
                      tlen=0, seq="ACGTACGTAC", qual="IIIIIIIIII")
            for i in range(n)]


def _unmapped_mix(header, n, seed):
    rng = random.Random(seed)
    recs = []
    for i in range(n):
        unmapped = rng.random() < 0.3
        recs.append(SamRecord(
            qname=f"q{i}", flag=4 if unmapped else 0,
            rname="*" if unmapped else rng.choice(header.ref_names),
            pos=0 if unmapped else rng.randint(1, 10000), mapq=0,
            cigar="*" if unmapped else "8M", rnext="*", pnext=0, tlen=0,
            seq="ACGTACGT", qual="IIIIIIII"))
    return recs


# name -> (records, shuffle seed, spill round_records)
_CASES = {
    "mixed": (lambda h: make_records(h, 3000, seed=42), 1, 200),
    "skewed": (lambda h: _ties(h, 800), 3, 100),
    "unmapped_mix": (lambda h: _unmapped_mix(h, 600, 5), 6, 150),
    "fewer_than_devices": (lambda h: make_records(h, 3, seed=9), 9, 2),
    "bytes_mixed": (lambda h: make_records(h, 1500, seed=21), 22, 10_000),
    "bytes_tiny": (lambda h: make_records(h, 5, seed=23), 22, 3),
    "spill_many_rounds": (lambda h: make_records(h, 4000, seed=77), 5, 200),
    "spill_degenerate": (lambda h: make_records(h, 600, seed=9), 6, 10_000),
    "spill_skew_ties": (lambda h: _ties(h, 900), 11, 100),
    "spill_unmapped": (lambda h: make_records(h, 1200, seed=13), 7, 150),
}


@pytest.fixture(scope="module")
def sorted_cases(tmp_path_factory):
    """Each case's shuffled BAM and the reference sort's bytes."""
    d = tmp_path_factory.mktemp("tmsort")
    out = {}
    header = make_header()
    for name, (recs, seed, rr) in _CASES.items():
        p = _write_shuffled(str(d / f"{name}.bam"), recs(header), header,
                            seed)
        ref = str(d / f"{name}.ref.bam")
        n = jsort_bam(p, ref)
        out[name] = (p, open(ref, "rb").read(), n, rr)
    return out


@pytest.mark.parametrize("mode", ["index", "bytes", "spill"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_mesh_sort_byte_identical(sorted_cases, tmp_path, case, mode):
    path, want, n, rr = sorted_cases[case]
    kw = {"spill": dict(round_records=rr), "bytes": dict(exchange="bytes"),
          "index": {}}[mode]
    before = ms.bytes_sort_step.launches
    out = str(tmp_path / "mesh.bam")
    assert ms.sort_bam_mesh(path, out, device="cpu", **kw) == n
    assert open(out, "rb").read() == want
    assert os.path.exists(out + ".bai") and os.path.exists(out + ".sbi")
    assert not os.path.exists(out + ".mesh-spill")
    if mode == "spill" and n >= 3 * rr:
        # the plan cut the file into several rounds
        assert ms.bytes_sort_step.launches - before >= 3


@pytest.mark.parametrize("run_records", [1_000_000, 700])
@pytest.mark.parametrize("case", ["mixed", "unmapped_mix", "skewed"])
def test_host_sort_equals_the_reference(sorted_cases, tmp_path, case,
                                        run_records):
    """The port's ``sort_bam`` (the smoke's oracle), one run or spilled
    runs merged: the reference's bytes and sidecars."""
    path, want, n, _rr = sorted_cases[case]
    out = str(tmp_path / "host.bam")
    ref = str(tmp_path / "ref.bam")
    jsort_bam(path, ref, run_records=run_records)
    assert sort_bam(path, out, run_records=run_records) == n
    assert open(out, "rb").read() == want
    for suffix in (".bai", ".sbi"):
        assert open(out + suffix, "rb").read() == \
            open(ref + suffix, "rb").read()


def test_mesh_sort_exchange_validation(sorted_cases, tmp_path):
    path = sorted_cases["bytes_tiny"][0]
    with pytest.raises(ValueError, match="exchange"):
        ms.sort_bam_mesh(path, str(tmp_path / "o.bam"), device="cpu",
                         exchange="nope")
    with pytest.raises(ValueError, match="bytes"):
        ms.sort_bam_mesh(path, str(tmp_path / "o.bam"), device="cpu",
                         exchange="index", round_records=10)


def test_spill_dir_removed_on_success_and_failure(sorted_cases, tmp_path,
                                                  monkeypatch):
    path = sorted_cases["spill_degenerate"][0]
    out = str(tmp_path / "o.bam")
    ms.sort_bam_mesh(path, out, device="cpu", round_records=100)
    assert not os.path.exists(out + ".mesh-spill")

    def boom(run_paths):
        raise RuntimeError("injected merge failure")
    monkeypatch.setattr(ms, "_merge_bucket_runs", boom)
    with pytest.raises(RuntimeError, match="injected merge failure"):
        ms.sort_bam_mesh(path, out + "2", device="cpu", round_records=100)
    assert not os.path.exists(out + "2.mesh-spill")
    assert not os.path.exists(out + "2")
    cfg = dataclasses.replace(DEFAULT_CONFIG, debug_keep_spill=True)
    with pytest.raises(RuntimeError, match="injected merge failure"):
        ms.sort_bam_mesh(path, out + "3", device="cpu", round_records=100,
                         config=cfg)
    assert os.path.isdir(out + "3.mesh-spill")


def test_int32_ceiling_raises_plan_error_up_front(tmp_path, monkeypatch):
    from hadoop_bam_torch.split.splitting_index import SplittingIndex
    with pytest.raises(PlanError, match="global-index ceiling"):
        ms.check_global_index_ceiling(2**31, "unit")
    with pytest.raises(ValueError):
        ms.check_global_index_ceiling(2**31, "unit")
    ms.check_global_index_ceiling(ms.GLOBAL_INDEX_CEILING, "unit")
    assert ms.GLOBAL_INDEX_CEILING == jms.GLOBAL_INDEX_CEILING

    class _Huge:
        total_records = 2**31 + 5
        granularity = 4096
        voffsets = [0, 1 << 16]

    monkeypatch.setattr(SplittingIndex, "load_for",
                        classmethod(lambda cls, p: _Huge()))
    # a missing input proves the check fires before any file I/O
    with pytest.raises(PlanError, match="spill"):
        ms.sort_bam_mesh(str(tmp_path / "absent.bam"),
                         str(tmp_path / "out.bam"), device="cpu")


def test_mesh_sort_needs_a_card_unless_told(sorted_cases, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ms.sort_bam_mesh(sorted_cases["bytes_tiny"][0],
                         str(tmp_path / "o.bam"))


# ---------------------------------------------------------------------------
# K15's parts against the reference's functions
# ---------------------------------------------------------------------------

def _key_inputs(R, count, seed):
    rng = np.random.default_rng(seed)
    refid = rng.integers(-1, 6, R).astype(np.int32)
    pos = rng.integers(-1, 2000, R).astype(np.int32)
    pos[rng.random(R) < 0.05] = -1
    pos[rng.random(R) < 0.03] = 2**31 - 1          # lo wraps to 2^31
    pos[:8] = 500                                   # ties
    refid[:8] = 2
    valid = np.arange(R) < count
    return refid, pos, valid


@pytest.mark.parametrize("n_dev,R,count", [(1, 64, 50), (8, 256, 256),
                                           (8, 512, 300), (8, 16, 0)])
def test_k15_parts_equal_the_reference(n_dev, R, count):
    import jax.numpy as jnp
    refid, pos, valid = _key_inputs(R, count, n_dev * R + count)
    base = 1000
    jhi, jlo, jgidx = jms._device_keys(jnp.asarray(refid), jnp.asarray(pos),
                                       jnp.asarray(valid), jnp.int32(base),
                                       R)
    hi, lo, gidx = ms._device_keys(torch.from_numpy(refid),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(valid), base, R)
    for g, w in ((hi, jhi), (lo, jlo), (gidx, jgidx)):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    bhi, blo = jms._sample_bounds([np.asarray(jhi)[valid]],
                                  [np.asarray(jlo)[valid]], n_dev)
    tb = ms._sample_bounds([np.asarray(jhi)[valid]],
                           [np.asarray(jlo)[valid]], n_dev)
    assert np.array_equal(tb[0], bhi) and np.array_equal(tb[1], blo)
    jperm, jsb, jrank = jms._bucket_pack(jhi, jlo, jnp.asarray(bhi),
                                         jnp.asarray(blo), R)
    perm, sb, rank = ms._bucket_pack(hi, lo,
                                     torch.from_numpy(bhi.astype(np.int64)),
                                     torch.from_numpy(blo.astype(np.int64)),
                                     R)
    for g, w in ((perm, jperm), (sb, jsb), (rank, jrank)):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    jsend = jms._send_matrices(jhi, jlo, jgidx, jperm, jsb, jrank, n_dev, R)
    send = ms._send_matrices(hi, lo, gidx, perm, sb, rank, n_dev, R)
    for g, w in zip(send, jsend):
        assert g.shape == (n_dev, R)
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_host_keys_equal_the_reference(sorted_cases):
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    path = sorted_cases["unmapped_mix"][0]
    read_bam_header(path)
    for data, offs in map_file_spans(path, lambda d, o, v: (d, o)):
        for g, w in zip(ms._keys_of(data, offs), jms._keys_of(data, offs)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(ms._record_lens(data, offs),
                              jms._record_lens(data, offs))


@pytest.mark.parametrize("seed", range(4))
def test_three_key_sort_equals_the_reference_on_ties_and_wraps(seed):
    """The received keys of 8 sources (each source's send row for one
    device, concatenated as the exchange lays them out), then arbitrary
    key triples: the port's order equals ``lax.sort(num_keys=3)``."""
    import jax
    import jax.numpy as jnp
    n_dev, R = 8, 128
    rng = np.random.default_rng(seed)
    bhi = np.sort(rng.integers(0, 6, n_dev - 1)).astype(np.int64)
    blo = rng.integers(0, 2**32, n_dev - 1).astype(np.int64)
    rows = {k: [] for k in ("hi", "lo", "ix")}
    for s in range(n_dev):
        refid, pos, valid = _key_inputs(R, int(rng.integers(0, R + 1)),
                                        seed * 100 + s)
        hi, lo, gidx = ms._device_keys(torch.from_numpy(refid),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(valid), s * R, R)
        perm, sb, rank = ms._bucket_pack(hi, lo, torch.from_numpy(bhi),
                                         torch.from_numpy(blo), R)
        send = ms._send_matrices(hi, lo, gidx, perm, sb, rank, n_dev, R)
        for k, m in zip(rows, send):
            rows[k].append(m[3])              # what device 3 receives
    cases = [tuple(torch.cat(rows[k]) for k in rows)]
    n = 4000
    hi = rng.choice(np.array([0, 1, 2, 2**31 - 1, 2**32 - 1]), n)
    lo = rng.choice(np.array([0, 1, 7, 2**31, 2**32 - 1]), n)
    ix = rng.permutation(n)
    ix[rng.random(n) < 0.1] = 2**31 - 1
    cases.append(tuple(torch.from_numpy(a.astype(np.int64))
                       for a in (hi, lo, ix)))
    for hi, lo, ix in cases:
        got = ix[ms.sort_order(hi, lo, ix)].numpy()
        _, _, want = jax.lax.sort(
            (jnp.asarray(hi.numpy().astype(np.uint32)),
             jnp.asarray(lo.numpy().astype(np.uint32)),
             jnp.asarray(ix.numpy().astype(np.int32))), num_keys=3)
        assert np.array_equal(got, np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", range(4))
def test_one_key_sort_equals_the_reference_on_the_step_layout(seed):
    """What a one-device step receives (its send matrix's one row: rows
    in ascending global index, sentinel pads last, keys that tie and
    wrap): ``key_order`` alone equals ``lax.sort(num_keys=3)`` and the
    general ``sort_order``."""
    import jax
    import jax.numpy as jnp
    R = 512
    rng = np.random.default_rng(seed)
    refid, pos, valid = _key_inputs(R, int(rng.integers(0, R + 1)),
                                    seed + 40)
    pos[rng.random(R) < 0.05] = -2                 # lo = 2^32 - 1
    hi, lo, gidx = ms._device_keys(torch.from_numpy(refid),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(valid), 3 * R, R)
    perm, sb, rank = ms._bucket_pack(hi, lo, torch.zeros(0, dtype=torch.int64),
                                     torch.zeros(0, dtype=torch.int64), R)
    r_hi, r_lo, r_ix = (m.reshape(-1) for m in
                        ms._send_matrices(hi, lo, gidx, perm, sb, rank, 1, R))
    assert r_ix.dtype == torch.int32
    got = r_ix[ms.key_order(r_hi, r_lo)]
    assert torch.equal(got, r_ix[ms.sort_order(r_hi, r_lo, r_ix)])
    _, _, want = jax.lax.sort(
        (jnp.asarray(r_hi.numpy().astype(np.uint32)),
         jnp.asarray(r_lo.numpy().astype(np.uint32)),
         jnp.asarray(r_ix.numpy())), num_keys=3)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def span_tile(sorted_cases):
    """One decoded span of the unmapped mix, padded as both steps take
    it."""
    from hadoop_bam_torch.parallel.pipeline import map_file_spans
    path = sorted_cases["unmapped_mix"][0]
    parts = map_file_spans(path, lambda d, o, v: (d, o))
    data, offs = parts[0]
    R = jms._round_up(offs.size, 8)
    stride = jms._round_up(int(ms._record_lens(data, offs).max()), 64)
    return data, offs, R, stride


def _one_device_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def test_sort_step_equals_the_reference_on_one_device(span_tile):
    import jax.numpy as jnp
    data, offs, R, _stride = span_tile
    n = offs.size
    D = jms._round_up(data.size, 256)
    dpad = np.zeros(D, np.uint8)
    dpad[:data.size] = data
    opad = np.zeros(R, np.int32)
    opad[:n] = offs
    step = jms._make_sort_step(_one_device_mesh(), R)
    empty = jnp.zeros(0, jnp.uint32)
    want = np.asarray(step(dpad[None], opad[None], np.asarray([n], np.int32),
                           np.asarray([7], np.int32), empty, empty))[0]
    before = ms.sort_step.launches
    got = ms.sort_step(torch.from_numpy(dpad), torch.from_numpy(opad), n, 7,
                       torch.zeros(0, dtype=torch.int64),
                       torch.zeros(0, dtype=torch.int64))
    assert ms.sort_step.launches == before + 1
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


def test_bytes_sort_step_equals_the_reference_on_one_device(span_tile):
    import jax.numpy as jnp
    data, offs, R, stride = span_tile
    n = offs.size
    lens = jms._record_lens(data, offs)
    rows_np, lens_np = jms._pack_record_rows(data, offs, lens, R, stride)
    rows, ln = ms.pack_rows(torch.from_numpy(data), offs, lens, R, stride)
    assert np.array_equal(rows.numpy(), rows_np)
    assert np.array_equal(ln.numpy(), lens_np)
    step = jms._make_bytes_sort_step(_one_device_mesh(), R, stride)
    empty = jnp.zeros(0, jnp.uint32)
    w_rows, w_ln, w_six = (np.asarray(x)[0] for x in step(
        rows_np[None], lens_np[None], np.asarray([n], np.int32),
        np.asarray([0], np.int32), empty, empty))
    g_rows, g_ln, g_six = ms.bytes_sort_step(
        rows, ln, n, 0, torch.zeros(0, dtype=torch.int64),
        torch.zeros(0, dtype=torch.int64))
    assert np.array_equal(g_rows.numpy(), w_rows)
    assert np.array_equal(g_ln.numpy(), w_ln)
    assert g_six.dtype == torch.int32 and w_six.dtype == np.int32
    assert np.array_equal(g_six.numpy(), w_six)
    payload, starts = ms.row_payload(g_rows, g_ln, g_six)
    keep = w_six != jms._I32_SENTINEL
    want = w_rows[keep][np.arange(stride)[None, :] < w_ln[keep][:, None]]
    assert payload.tobytes() == want.tobytes()
    assert starts.tolist() == (np.cumsum(w_ln[keep]) - w_ln[keep]).tolist()


def test_frame_run_equals_the_reference(span_tile):
    data, offs, R, stride = span_tile
    lens = jms._record_lens(data, offs)
    rows, ln = jms._pack_record_rows(data, offs, lens, R, stride)
    n = offs.size
    six = np.arange(n, dtype=np.int32)[::-1].copy()
    hi, lo = jms._keys_of(rows[:n].ravel(),
                          np.arange(n, dtype=np.int64) * stride)
    assert ms._frame_run(rows[:n], ln[:n], six, hi, lo) == \
        jms._frame_run(rows[:n], ln[:n], six, hi, lo)
    assert ms._frame_run(rows[:0], ln[:0], six[:0], hi[:0], lo[:0]) == b""


# ---------------------------------------------------------------------------
# the planner and the single-process collectives the sort stands on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_spans,granularity", [(1, 0), (3, 0), (8, 0),
                                                   (5, 7), (10_000, 0)])
def test_balanced_plan_and_its_digest_equal_the_reference(
        sorted_cases, num_spans, granularity):
    from hadoop_bam_tpu.jobs import plan_digest as jdigest
    from hadoop_bam_tpu.parallel.distributed import (
        serialize_plan as jserialize,
    )
    from hadoop_bam_tpu.split.planners import (
        plan_bam_spans_balanced as jplan,
    )
    from hadoop_bam_torch.jobs import plan_digest
    from hadoop_bam_torch.parallel.distributed import serialize_plan
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    path = sorted_cases["mixed"][0]
    got = plan_bam_spans_balanced(path, num_spans, granularity=granularity)
    want = jplan(path, num_spans, granularity=granularity)
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert serialize_plan(got) == jserialize(want)
    assert plan_digest(got) == jdigest(want)


def test_single_process_collectives():
    from hadoop_bam_torch.jobs.runner import plan_journal_params
    from hadoop_bam_torch.parallel.distributed import (
        broadcast_plan, guarded_allgather, serialize_plan,
    )
    from hadoop_bam_torch.split.spans import FileVirtualSpan
    spans = [FileVirtualSpan("x.bam", 0, 5 << 16),
             FileVirtualSpan("x.bam", 5 << 16, 9 << 16)]
    assert broadcast_plan(spans) == spans
    with pytest.raises(PlanError):
        broadcast_plan(None)
    a = np.arange(6, dtype=np.int64)
    g = guarded_allgather(a, "unit")
    assert g.shape == (1, 6) and np.array_equal(g[0], a)
    with pytest.raises(PlanError, match="broadcast buffer"):
        serialize_plan(spans, max_bytes=16)

    class _Plan:
        def digest(self):
            return "d1"
    assert plan_journal_params(_Plan(), {"a": 1}) == {"a": 1,
                                                      "plan_digest": "d1"}
