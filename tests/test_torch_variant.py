"""The port's variant plane against the JAX package's, on the CPU: K11
(``variant_prefix`` / ``gt_dosage``: their plain versions, which a CPU
tensor takes, against ``variant_prefix_device`` /
``variant_gt_dosage_device``), K14 (``variant_tile_stats`` against
``_variant_tile_stats`` and ``make_variant_stats_step`` on a one-device
mesh), the text packers, the feeds, ``variant_stats_file`` on every
container and on the device plane (the kernels' plain versions), the
failure policy of the BCF device family, and ``synth.write_synthetic_vcf``'s
truth.

Tolerances: counts, bytes, columns and sample call rates are equal;
``mean_af`` agrees within rtol 1e-6 (both packages divide in f32 per
variant and sum in other orders).  Errors compare by failure class."""
import dataclasses
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu import resilience as jres
from hadoop_bam_tpu.api.vcf_dataset import open_vcf as jopen_vcf
from hadoop_bam_tpu.api.writers import open_vcf_writer
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats.vcf import VCFHeader as JHeader
from hadoop_bam_tpu.ops.inflate_device import (
    variant_gt_dosage_device, variant_prefix_device,
)
from hadoop_bam_tpu.parallel import variant_pipeline as jv
from hadoop_bam_tpu.parallel.mesh import make_mesh
from hadoop_bam_tpu.resilience.chaos import PointFault as JPointFault
from hadoop_bam_tpu.utils import errors as jerr
from hadoop_bam_tpu.utils.metrics import METRICS as JMETRICS
from hadoop_bam_torch import resilience as tres
from hadoop_bam_torch import synth
from hadoop_bam_torch.api.vcf_dataset import open_vcf
from hadoop_bam_torch.config import HBamConfig, config_from_dict
from hadoop_bam_torch.formats.vcf import VCFHeader, VcfRecord
from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.parallel import variant_pipeline as tv
from hadoop_bam_torch.resilience.chaos import PointFault, fault_points_on
from hadoop_bam_torch.utils import errors as terr
from hadoop_bam_torch.utils.metrics import METRICS, MetricsContext

from test_bcf_columns import CROSS_LINES, HDR, _encode
from test_variant_pipeline import HEADER_TEXT, _make_records


@pytest.fixture(autouse=True)
def _reset():
    """Both packages' breakers, chaos points and counters, per test."""
    def reset():
        for res, m in ((tres, METRICS), (jres, JMETRICS)):
            res.reset()
            res.chaos.clear_fault_points()
            m.reset()
    reset()
    yield
    reset()


def _jcfg(**kw):
    return dataclasses.replace(JAX_CONFIG, retry_backoff_base_s=0.001,
                               retry_backoff_max_s=0.002, **kw)


def _tcfg(**kw):
    return config_from_dict(dataclasses.asdict(_jcfg(**kw)))


def _stats_equal(got, want):
    for k in ("n_variants", "n_snp", "n_pass", "n_af"):
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_allclose(got["mean_af"], want["mean_af"], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(got["sample_callrate"]),
                                  np.asarray(want["sample_callrate"]))


def _write_bcf(path, header_text, recs):
    with open_vcf_writer(path, JHeader.from_text(header_text)) as w:
        for r in recs:
            w.write_record(r)
    return path


@pytest.fixture(scope="module")
def vcf(tmp_path_factory):
    """The reference's 2,000-record five-sample fixture as text VCF and
    BGZF BCF."""
    d = tmp_path_factory.mktemp("tvar")
    recs = _make_records(2000)
    path = str(d / "v.vcf")
    with open(path, "w") as f:
        f.write(HEADER_TEXT + "".join(r.to_line() + "\n" for r in recs))
    return path, _write_bcf(str(d / "v.bcf"), HEADER_TEXT, recs), recs


@pytest.fixture(scope="module")
def kg(tmp_path_factory):
    """The generator's 1000 Genomes layout at 300 samples: BGZF BCF,
    raw BCF and BGZF VCF, with the truth and its rows."""
    d = tmp_path_factory.mktemp("tvkg")
    paths = {"bcf": str(d / "kg.bcf"), "raw": str(d / "kg.raw.bcf"),
             "vcf.gz": str(d / "kg.vcf.gz")}
    truth = synth.write_synthetic_vcf(paths["bcf"], 6000, 11, n_samples=300,
                                      raw_path=paths["raw"],
                                      vcf_path=paths["vcf.gz"],
                                      vcf_records=2000, keep_rows=True)
    return paths, truth


@pytest.fixture(scope="module")
def cross_bcf(tmp_path_factory):
    """The reference's device-plane fixture (tests/test_device_planes.py):
    CROSS_LINES x 8 as BGZF BCF."""
    d = tmp_path_factory.mktemp("tvcross")
    _, _, recs, _ = _encode(CROSS_LINES * 8)
    return _write_bcf(str(d / "t.bcf"), HDR, recs)


# ---------------------------------------------------------------------------
# K11: plain versions against the JAX package's device functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(synth.GT_CASES)))
def test_gt_dosage_plain_matches_jax(case):
    """Every case of chip_smoke.py phase 15 (a): widths 1, 2 and 4;
    ploidy 1, 2, 3 and 200 (saturation past 127); END_OF_VECTOR tails,
    MISSING and allele-0 calls; offsets clipped at both ends and
    wrapping int32; rows of the tile no group writes stay as they were."""
    w, c, ns, G = synth.GT_CASES[case]
    buf, offs, rows, R = synth.gt_rows(w, c, ns, G, seed=case)
    j = np.asarray(variant_gt_dosage_device(jnp.asarray(buf),
                                            jnp.asarray(offs), w, c, ns))
    want = np.full((R, ns + 5), -1, np.int8)
    want[rows[:, None], np.arange(ns)] = j
    before = tid.gt_dosage.launches
    got = tid.gt_dosage(torch.from_numpy(buf), torch.from_numpy(offs),
                        torch.from_numpy(rows), w, c, ns,
                        torch.full((R, ns + 5), -1, dtype=torch.int8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tid.gt_dosage.launches == before      # CPU: plain, no launch
    if c == 200:
        assert (got.numpy() == 127).any()


@pytest.mark.parametrize("n", [1, 12, 300])
def test_variant_prefix_plain_matches_jax(n):
    buf, starts = synth.prefix_rows(n, seed=n)
    jc, jp = variant_prefix_device(jnp.asarray(buf), jnp.asarray(starts))
    tc, tpos = tid.variant_prefix(torch.from_numpy(buf),
                                  torch.from_numpy(starts))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jp))
    assert tc.dtype == tpos.dtype == torch.int32


def test_k11_wrappers_refuse_bad_arguments():
    buf = torch.zeros(64, dtype=torch.uint8)
    i32 = torch.zeros(4, dtype=torch.int32)
    dos = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        tid.variant_prefix(buf.to(torch.int32), i32)
    with pytest.raises(ValueError):
        tid.variant_prefix(buf, i32.to(torch.int64))
    for bad in (dict(width=3), dict(count=0), dict(count=257),
                dict(n_sample=9)):
        kw = dict(width=1, count=2, n_sample=8)
        kw.update(bad)
        with pytest.raises(ValueError):
            tid.gt_dosage(buf, i32, i32, kw["width"], kw["count"],
                          kw["n_sample"], dos)
    with pytest.raises(ValueError):
        tid.gt_dosage(buf, i32, i32[:3], 1, 2, 8, dos)
    with pytest.raises(ValueError):
        tid.gt_dosage(buf, i32, i32, 1, 2, 8, dos.to(torch.int32))


def test_device_unpack_of_a_span_matches_the_columnar_decode(kg):
    """``device_variant_unpack`` (K11 on the resolved bytes) gives the
    host columnar decode's chrom / pos / flags / dosage rows."""
    from hadoop_bam_torch.formats.bcf_columns import (
        decode_bcf_columns, decode_bcf_cursor_meta,
    )
    from hadoop_bam_torch.split.vcf_planners import read_bcf_span_frames
    paths, truth = kg
    ds = open_vcf(paths["bcf"], device="cpu")
    pad = tv.VariantGeometry(n_samples=300).samples_pad
    for span in ds.spans(4):
        raw, starts = read_bcf_span_frames(paths["bcf"], span, True)
        meta = decode_bcf_cursor_meta(raw, ds.header, pad, starts=starts)
        cols = decode_bcf_columns(raw, ds.header, pad, starts=starts)
        buf = torch.from_numpy(np.frombuffer(raw, np.uint8).copy())
        chrom, pos, flags, dosage, n = tv.device_variant_unpack(buf, meta,
                                                                pad)
        assert n == cols["chrom"].shape[0]
        for k, t in (("chrom", chrom), ("pos", pos), ("flags", flags),
                     ("dosage", dosage)):
            np.testing.assert_array_equal(t[:n].numpy(), cols[k], k)
        assert (dosage[n:] == -1).all() and (flags[n:] == 0).all()


# ---------------------------------------------------------------------------
# K14: the per-tile stats
# ---------------------------------------------------------------------------

def _tile(cap, S, seed, missing=0.1):
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 3, cap).astype(np.int32)
    pos = rng.integers(1, 1 << 30, cap).astype(np.int32)
    flags = rng.integers(0, 4, cap).astype(np.uint8)
    dosage = rng.integers(0, 3, (cap, S)).astype(np.int8)
    dosage[rng.random((cap, S)) < missing] = -1
    dosage[:3] = -1                      # variants with no called sample
    dosage[5, :] = 127
    return chrom, pos, flags, dosage


@pytest.mark.parametrize("cap,S,count", [(64, 8, 64), (64, 8, 0),
                                         (64, 8, 37), (512, 304, 300),
                                         (1024, 2504, 1000)])
def test_variant_tile_stats_matches_jax(cap, S, count):
    arrays = _tile(cap, S, cap + count)
    jf, ji = jv._variant_tile_stats(*(jnp.asarray(a) for a in arrays),
                                    jnp.int32(count))
    tf, ti = tv.variant_tile_stats(*(torch.from_numpy(a) for a in arrays),
                                   count)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32 and tf.dtype == torch.float32
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    # a device int32 scalar count, as the device plane may pass it
    tf2, ti2 = tv.variant_tile_stats(*(torch.from_numpy(a) for a in arrays),
                                     torch.tensor(count, dtype=torch.int32))
    assert torch.equal(ti2, ti) and torch.equal(tf2, tf)


def test_variant_tile_stats_matches_the_mesh_step():
    """On a one-device mesh the reference's psum is the identity."""
    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    g = jv.VariantGeometry(tile_records=256, n_samples=40)
    arrays = _tile(256, g.samples_pad, 3)
    step = jv.make_variant_stats_step(mesh, g)
    jf, ji = step(*(jnp.asarray(a)[None] for a in arrays),
                  jnp.asarray([200], jnp.int32))
    tf, ti = tv.variant_tile_stats(*(torch.from_numpy(a) for a in arrays),
                                   200)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)


def test_geometry_like_the_reference():
    for n in (0, 3, 5, 300, 2504, 100_000):
        t, j = tv.VariantGeometry(n_samples=n), jv.VariantGeometry(
            n_samples=n)
        assert (t.tile_records, t.samples_pad) == (j.tile_records,
                                                   j.samples_pad)
    assert tv.VariantGeometry(n_samples=2504).tile_records == 3352
    g = tv.VariantGeometry(n_samples=100_000)
    assert g.tile_records * g.samples_pad <= 16 << 20
    assert tv.VariantGeometry(n_samples=3).tile_records == 1 << 16
    for x in (0, 1, 8, 9, 1000, 1024, 1025):
        assert tid.round_pow2(x, 8) == jv._round_pow2_min8(x)


# ---------------------------------------------------------------------------
# the packers and the feed
# ---------------------------------------------------------------------------

def _cols_equal(a, b):
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], k)
        assert a[k].dtype == b[k].dtype, k


def test_text_packers_match_the_reference():
    """The reference's differential fuzz text (multi-allelic and wide
    ALTs, polyploid and multi-digit genotypes, missing fields): both of
    the port's tokenizers equal the reference's, with and without the
    final newline."""
    header_text = ("##fileformat=VCFv4.2\n"
                   "##contig=<ID=chr1,length=1000000>\n"
                   "##contig=<ID=chrX_alt,length=50000>\n"
                   '##FORMAT=<ID=GT,Number=1,Type=String,Description="G">\n'
                   "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                   "s0\ts1\ts2\n")
    rng = random.Random(17)
    alts = ["A", "T", "A,C", "A,C,G,T,A,C,G,T,A", "AT", "A,TT", ".",
            "<DEL>", "A,<INS>", "*"]
    gts = ["0/0", "0/1", "1|1", "./.", ".", "0", "2", "10/1", "0/1/1",
           "1", "0|0|1", "./0", "0/.", "", "1/2:99", "0/1:.:3"]
    lines = []
    for _ in range(400):
        nf = rng.choice([8, 9, 10, 11, 12])
        parts = [rng.choice(["chr1", "chrX_alt", "chrUnknown"]),
                 str(rng.randint(1, 999999)), ".", rng.choice(["A", "AT"]),
                 rng.choice(alts), "30", rng.choice(["PASS", "q10", "."]),
                 "DP=5"]
        if nf > 8:
            parts.append(rng.choice(["GT", "GT:GQ", "GQ", "GTX"]))
            parts += [rng.choice(gts) for _ in range(nf - 9)]
        lines.append("\t".join(parts))
    text = ("\n".join(lines) + "\n").encode()
    th, jh = VCFHeader.from_text(header_text), JHeader.from_text(header_text)
    tg, jg = tv.VariantGeometry(n_samples=3), jv.VariantGeometry(n_samples=3)
    for t in (text, text[:-1], b""):
        want = jv.pack_variant_tiles_from_text(t, jh, jg)
        _cols_equal(tv.pack_variant_tiles_from_text(t, th, tg), want)
        _cols_equal(tv._pack_variant_tiles_from_text_scalar(t, th, tg),
                    jv._pack_variant_tiles_from_text_scalar(t, jh, jg))
        tcols, todd = tv._pack_variant_text_vectorized(t, th, tg)
        jcols, jodd = jv._pack_variant_text_vectorized(t, jh, jg)
        _cols_equal(tcols, jcols)
        assert todd == jodd


def test_text_packer_and_record_pack_on_the_kg_layout(kg):
    """The text tokenizer on the generator's VCF equals the record
    parse (``pack_variant_tiles``) and the reference, span by span."""
    paths, truth = kg
    ds = open_vcf(paths["vcf.gz"], device="cpu")
    jds = jopen_vcf(paths["vcf.gz"])
    g, jg = tv.VariantGeometry(n_samples=300), jv.VariantGeometry(
        n_samples=300)
    rows = 0
    for s, u in zip(ds.spans(3), jds.spans(3)):
        text = ds.read_span_text(s)
        fast = tv.pack_variant_tiles_from_text(text, ds.header, g)
        _cols_equal(fast, jv.pack_variant_tiles_from_text(text, jds.header,
                                                          jg))
        from hadoop_bam_torch.formats.vcf import VariantBatch
        _cols_equal(fast, tv.pack_variant_tiles(
            VariantBatch(ds.read_span(s), ds.header), g))
        n = fast["chrom"].shape[0]
        np.testing.assert_array_equal(fast["dosage"][:, :300],
                                      truth.dosage[rows:rows + n])
        np.testing.assert_array_equal(fast["flags"],
                                      truth.flags[rows:rows + n])
        rows += n
    assert rows == truth.vcf.n_variants


def test_feed_matches_the_serial_tiler(kg):
    """FeedPipeline through ``variant_feed`` gives the serial tiler's
    tiles (``_iter_variant_tiles``, the oracle), pads included."""
    paths, truth = kg
    ds = open_vcf(paths["bcf"], device="cpu")
    g = tv.VariantGeometry(tile_records=700, n_samples=300)
    cols = [tv.bcf_span_stat_columns(paths["bcf"], s, ds.header, g, True)
            for s in ds.spans(5)]
    want = list(tv._iter_variant_tiles(iter(cols), 700, g))
    keys, fp, tuples = tv.variant_feed(iter(cols), 1, 700,
                                       fixed_shape=True)
    got = []
    fp.feed(tuples, lambda tensors, counts: got.append(
        ([t[0].clone() for t in tensors], int(counts[0]))))
    assert len(got) == len(want)
    for (tiles, n), (tile, m) in zip(got, want):
        assert n == m
        for k, t in zip(keys, tiles):
            np.testing.assert_array_equal(t.numpy(), tile[k], k)
    assert sum(n for _, n in got) == truth.n_variants
    assert tv.variant_feed(iter([]), 1, 8) == (None, None, None)


@pytest.mark.parametrize("kind", ["vcf", "bcf"])
def test_tensor_batches_match_the_reference(vcf, kind):
    """``tensor_batches`` on a one-device mesh in the reference and on
    the CPU in the port: the same batches, every one ``tile_records``
    rows, pads dosage -1 and 0 elsewhere, each batch its consumer's
    own."""
    path = vcf[0] if kind == "vcf" else vcf[1]
    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    tg = tv.VariantGeometry(tile_records=512, n_samples=5)
    jg = jv.VariantGeometry(tile_records=512, n_samples=5)
    want = [{k: np.array(v) for k, v in b.items()}
            for b in jopen_vcf(path).tensor_batches(mesh=mesh, geometry=jg,
                                                    num_spans=3)]
    got = list(open_vcf(path, device="cpu").tensor_batches(geometry=tg,
                                                           num_spans=3))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k].numpy(), b[k], k)
        n = int(a["n_records"][0])
        assert a["dosage"].shape == (1, 512, 8)
        assert (a["dosage"][0, n:] == -1).all()
        assert (a["chrom"][0, n:] == 0).all()
    assert sum(int(b["n_records"].sum()) for b in got) == 2000
    # every batch owns its tensors: no two share memory
    ptrs = {b["dosage"].data_ptr() for b in got}
    assert len(ptrs) == len(got)


def test_tensor_batches_rows_equal_the_generator(kg):
    paths, truth = kg
    rows = {k: [] for k in ("chrom", "pos", "flags", "dosage")}
    for b in open_vcf(paths["bcf"], device="cpu").tensor_batches():
        n = int(b["n_records"][0])
        for k in rows:
            rows[k].append(b[k][0, :n].numpy())
    for k in ("chrom", "pos", "flags"):
        np.testing.assert_array_equal(np.concatenate(rows[k]),
                                      getattr(truth, k), k)
    np.testing.assert_array_equal(np.concatenate(rows["dosage"])[:, :300],
                                  truth.dosage)


# ---------------------------------------------------------------------------
# variant_stats_file: every container, both planes
# ---------------------------------------------------------------------------

def test_stats_match_the_reference_and_the_oracle(vcf):
    from hadoop_bam_torch.formats.vcf import VariantBatch
    path, bcf, recs = vcf
    header = VCFHeader.from_text(HEADER_TEXT)
    d = VariantBatch([VcfRecord.from_line(r.to_line()) for r in recs],
                     header).dosage_matrix().astype(np.int64)
    called = d >= 0
    for p in (path, bcf):
        got = tv.variant_stats_file(p, device="cpu")
        _stats_equal(got, jv.variant_stats_file(p))
        assert got["n_variants"] == got["n_snp"] == 2000
        assert got["n_pass"] == sum(r.filters == ("PASS",) for r in recs)
        np.testing.assert_allclose(got["sample_callrate"],
                                   called.mean(axis=0), atol=1e-12)


@pytest.mark.parametrize("kind", ["bcf", "raw", "vcf.gz"])
def test_stats_on_every_container_equal_truth_and_reference(kg, kind):
    paths, truth = kg
    want = truth.vcf if kind == "vcf.gz" else truth
    got = tv.variant_stats_file(paths[kind], device="cpu")
    _stats_equal(got, jv.variant_stats_file(paths[kind]))
    _stats_equal(got, want.stats())


def test_device_plane_matches_reference_planes_and_truth(kg):
    """The device plane on the CPU (plain K7+K8 and K11, K14) against the
    reference's device and host planes and the generator: a 300-sample
    record is ~700 bytes, so the small plan's spans reach past 64 blocks
    only if asked; the fixup path is held by the next test."""
    paths, truth = kg
    p = paths["bcf"]
    with MetricsContext() as m:
        got = tv.variant_stats_file(p, device="cpu",
                                    config=_tcfg(inflate_backend="device"))
    _stats_equal(got, truth.stats())
    _stats_equal(got, jv.variant_stats_file(p, config=_jcfg(
        inflate_backend="device")))
    _stats_equal(got, jv.variant_stats_file(p))
    c = m.counters
    assert c["vcf.device_records"] + c.get("vcf.fixup_records", 0) == \
        truth.n_variants
    assert c["vcf.device_blocks"] > 0
    assert m.wall_timers.get("pipeline.host_decode_wall", 0.0) == 0.0 \
        or c.get("vcf.fixup_records", 0) > 0


def test_device_plane_fixups_count_each_record_once(kg, monkeypatch):
    """Spans wider than the chunk (the device plane's 64 blocks cut to
    2) and cut final records go through the host oracle, each record
    once; a span the columnar walk declines goes whole to the host."""
    paths, truth = kg
    monkeypatch.setattr(tp, "DEVICE_PLANE_MAX_BLOCKS", 2)
    cfg = _tcfg(inflate_backend="device")
    with MetricsContext() as m:
        got = tv.variant_stats_file(paths["bcf"], device="cpu", config=cfg)
    _stats_equal(got, truth.stats())
    c = m.counters
    assert c["vcf.fixup_blocks"] > 0 and c["vcf.fixup_records"] > 0
    assert c["vcf.device_records"] + c["vcf.fixup_records"] == \
        truth.n_variants
    # every span declined by the cursor walk: all records on the host
    monkeypatch.setattr(tv, "decode_bcf_cursor_meta", lambda *a, **k: None)
    with MetricsContext() as m:
        got = tv.variant_stats_file(paths["bcf"], device="cpu", config=cfg)
    _stats_equal(got, truth.stats())
    assert m.counters.get("vcf.device_records", 0) == 0
    assert m.counters["vcf.fixup_records"] == truth.n_variants


def test_plane_routing_like_the_reference(kg, vcf):
    """The device plane is offered only for a BGZF BCF under a named
    "device" backend; "auto" is native; a raw BCF or a .vcf.gz under
    "device" runs the host plane with the same result."""
    from hadoop_bam_torch.plan.executor import select_plane
    paths, truth = kg
    assert select_plane(HBamConfig(inflate_backend="auto"),
                        device_capable=True).plane == "native"
    d = select_plane(HBamConfig(inflate_backend="device"),
                     device_capable=False)
    assert d.plane == "native" and "device" in dict(d.rejected)
    for kind in ("raw", "vcf.gz"):
        with MetricsContext() as m:
            got = tv.variant_stats_file(paths[kind], device="cpu",
                                        config=_tcfg(inflate_backend="device"))
        _stats_equal(got, truth.vcf.stats() if kind == "vcf.gz"
                     else truth.stats())
        assert "vcf.device_blocks" not in m.counters


def test_columnar_path_and_its_fallback(vcf, monkeypatch):
    """BCF spans take the columnar decode (the record scanner poisoned),
    and with the columnar decode declining every span the scanner gives
    the same stats."""
    _, bcf, _ = vcf
    want = tv.variant_stats_file(vcf[0], device="cpu")

    def boom(*a, **k):
        raise AssertionError("record-serial scan used on an eligible span")
    monkeypatch.setattr(tv, "scan_variant_columns", boom)
    _stats_equal(tv.variant_stats_file(bcf, device="cpu"), want)
    monkeypatch.undo()
    monkeypatch.setattr(tv, "decode_bcf_columns", lambda *a, **k: None)
    _stats_equal(tv.variant_stats_file(bcf, device="cpu"), want)


def test_generator_truth_equals_the_reference(tmp_path):
    """``synth.write_synthetic_vcf``'s truth against the reference's
    ``variant_stats_file`` on a small file of each container, and its
    additions present."""
    p = str(tmp_path / "g.bcf")
    truth = synth.write_synthetic_vcf(p, 1500, 3, n_samples=64,
                                      raw_path=str(tmp_path / "g.raw.bcf"),
                                      vcf_path=str(tmp_path / "g.vcf.gz"),
                                      vcf_records=500)
    for path, want in ((p, truth), (str(tmp_path / "g.raw.bcf"), truth),
                       (str(tmp_path / "g.vcf.gz"), truth.vcf)):
        _stats_equal(jv.variant_stats_file(path), want.stats())
    assert 0 < truth.n_pass < truth.n_variants
    assert 0.85 < truth.n_snp / truth.n_variants < 0.97
    assert 0 < truth.missing_share < 0.02 and truth.filtered_share > 0
    with pytest.raises(ValueError):
        synth.write_synthetic_vcf(str(tmp_path / "x.bcf"), 100, 0,
                                  n_samples=8, vcf_path=str(
                                      tmp_path / "x.vcf.gz"),
                                  vcf_records=95)


# ---------------------------------------------------------------------------
# the BCF device family under faults (tests/test_device_planes.py)
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 -- compared by failure class
        return ("err", e)


def _same_outcome(t, j):
    assert t[0] == j[0], (t, j)
    if t[0] == "err":
        assert terr.classify_error(t[1]) == jerr.classify_error(j[1]), (t, j)
    else:
        _stats_equal(t[1], j[1])


def test_device_matches_host_with_no_host_decode(cross_bcf):
    host = tv.variant_stats_file(cross_bcf, device="cpu")
    with MetricsContext() as m:
        dev = tv.variant_stats_file(cross_bcf, device="cpu",
                                    config=_tcfg(inflate_backend="device"))
    _stats_equal(dev, host)
    _stats_equal(dev, jv.variant_stats_file(cross_bcf, config=_jcfg(
        inflate_backend="device")))
    assert m.wall_timers.get("pipeline.host_decode_wall", 0.0) == 0.0
    assert "vcf.device_resolve_wall" in m.wall_timers


@pytest.mark.parametrize("seed", [19, 23])
def test_byte_flip_fuzz_same_outcome(cross_bcf, tmp_path, seed):
    """One byte flipped at a time across the compressed file, and a cut
    file: each package's host and device planes give the same result
    or the same failure class as the reference's."""
    raw = open(cross_bcf, "rb").read()
    rng = random.Random(seed)
    cases = []
    for pos in rng.sample(range(len(raw)), 6):
        bad = bytearray(raw)
        bad[pos] ^= 0xFF
        cases.append((f"flip{pos}", bytes(bad)))
    cases.append(("trunc", raw[:len(raw) * 2 // 3]))
    for name, data in cases:
        p = str(tmp_path / f"{name}.bcf")
        with open(p, "wb") as f:
            f.write(data)
        for backend in ("native", "device"):
            t = _outcome(lambda: tv.variant_stats_file(
                p, device="cpu", config=_tcfg(inflate_backend=backend)))
            j = _outcome(lambda: jv.variant_stats_file(
                p, config=_jcfg(inflate_backend=backend)))
            _same_outcome(t, j)
        if name == "trunc":
            assert t[0] == "err"


@pytest.mark.parametrize("name", ["crc_variant", "crc.bcf"])
def test_crc_flip_same_outcome_both_planes(cross_bcf, tmp_path, name):
    """A CRC-footer flip of the largest block (here the one data block,
    header and records): both packages' planes give the same outcome
    with ``check_crc`` off and on.  Named without an extension (the
    reference's case) the container is sniffed from the bytes, whose
    inflate checks the CRC: CORRUPT on both planes whatever ``check_crc``
    says."""
    from hadoop_bam_torch.ops.inflate import block_table
    raw = open(cross_bcf, "rb").read()
    table = block_table(raw)
    idx = int(np.argmax(table["cdata_len"]))
    foot = int(table["cdata_off"][idx] + table["cdata_len"][idx])
    bad = bytearray(raw)
    bad[foot] ^= 0xFF
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(bytes(bad))
    from hadoop_bam_tpu.api.dispatch import clear_sniff_caches
    from hadoop_bam_torch.api import dispatch as tdispatch
    for crc in (False, True):
        for backend in ("native", "device"):
            clear_sniff_caches()
            tdispatch.clear_sniff_caches()
            t = _outcome(lambda: tv.variant_stats_file(
                p, device="cpu", config=_tcfg(inflate_backend=backend,
                                              check_crc=crc)))
            j = _outcome(lambda: jv.variant_stats_file(
                p, config=_jcfg(inflate_backend=backend, check_crc=crc)))
            _same_outcome(t, j)
            if name == "crc_variant":
                assert t[0] == "err" and \
                    terr.classify_error(t[1]) == terr.CORRUPT


def test_chaos_demotes_to_the_host_result(cross_bcf):
    """A transient fault at the device plane's dispatch demotes the run
    to the host plane's result, and the device breaker opens only after
    the host plane read the file, as in the reference."""
    oracle = tv.variant_stats_file(cross_bcf, device="cpu")
    cfg = _tcfg(inflate_backend="device", breaker_failure_threshold=1.0)
    with fault_points_on("device.step", [PointFault("transient", count=1)]):
        faulted = tv.variant_stats_file(cross_bcf, device="cpu", config=cfg)
    _stats_equal(faulted, oracle)
    key = f"decode/device/{os.path.abspath(cross_bcf)}"
    assert tres.registry().states()[key]["state"] == tres.OPEN
    jcfg = _jcfg(inflate_backend="device", breaker_failure_threshold=1.0)
    with jres.chaos.fault_points_on("device.step",
                                    [JPointFault("transient", count=1)]):
        jfaulted = jv.variant_stats_file(cross_bcf, config=jcfg)
    _stats_equal(faulted, jfaulted)
    assert jres.registry().states()[key]["state"] == jres.OPEN
    # the breaker now keeps the device plane off up front
    with MetricsContext() as m:
        again = tv.variant_stats_file(cross_bcf, device="cpu", config=cfg)
    _stats_equal(again, oracle)
    assert "vcf.device_resolve_wall" not in m.wall_timers


def test_a_kernel_fault_raises_and_never_demotes(cross_bcf, monkeypatch):
    """A K11 wrapper that fails (build or launch) raises: the run does
    not carry on on the host plane."""
    from hadoop_bam_torch.ops.kernels import KernelLaunchError

    def broken(*a, **k):
        raise KernelLaunchError("variant_unpack launch failed: CUDA error "
                                "700")
    monkeypatch.setattr(tv, "variant_unpack", broken)
    with pytest.raises(KernelLaunchError):
        tv.variant_stats_file(cross_bcf, device="cpu",
                              config=_tcfg(inflate_backend="device"))


def test_entry_points_default_to_cuda(vcf, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tv.variant_stats_file(vcf[1])
    with pytest.raises(RuntimeError):
        open_vcf(vcf[1])
