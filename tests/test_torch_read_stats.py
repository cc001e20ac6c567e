"""The port's read-format stats driver and tensor feeds against the JAX
package's, on the CPU: ``fastq_seq_stats_file`` (FASTQ and QSEQ, the
vectorized and the object path, gzip, quarantine), ``read_stats_step``
and ``unpack_step`` (K2 and K1 through their plain versions on CPU
tensors), every ``tensor_batches`` form (BAM, FASTQ, QSEQ, FASTA
windows; bucketed and ``fixed_shape`` final batches), and the staging
ring's ``fixed_shape`` / ``balance`` / ``stream`` forms.

Tolerances: n_reads, base_hist, every batch byte, shape and count, and
error classes are equal; mean_gc / mean_qual agree within rtol 1e-6
(the reference adds f32 per-tile sums, the port f64 sums).  Stats are
compared with the reference on its default 8-device mesh (``balance``
makes them independent of placement); batch layouts against the
reference on a one-device mesh, the port's n_dev = 1.
"""
import dataclasses
import random
import time

import jax
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.api import read_datasets as jrd
from hadoop_bam_tpu.api.dataset import open_bam as jopen_bam
from hadoop_bam_tpu.api.writers import FastqShardWriter, QseqShardWriter
from hadoop_bam_tpu.config import BaseQualityEncoding as JEnc
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats.bam import BamBatch as JBamBatch
from hadoop_bam_tpu.formats.bamio import BamWriter
from hadoop_bam_tpu.formats.fastq import SequencedFragment
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.parallel import staging as jstaging
from hadoop_bam_tpu.parallel.mesh import make_mesh
from hadoop_bam_tpu.split.planners import plan_bam_spans as jplan_bam
from hadoop_bam_tpu.utils import resilient as jrs
from hadoop_bam_torch import synth
from hadoop_bam_torch.api import open_bam, open_fasta, open_fastq, open_qseq
from hadoop_bam_torch.config import config_from_dict, geometry_from_dict
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.parallel.staging import FeedPipeline, TileSpec
from hadoop_bam_torch.split.planners import plan_bam_spans
from hadoop_bam_torch.utils import resilient as trs

from fixtures import make_header, make_records

GEOM = jp.PayloadGeometry(max_len=160, tile_records=1 << 10, block_n=256)
TGEOM = geometry_from_dict(dataclasses.asdict(GEOM))


def mesh1():
    return make_mesh(devices=jax.devices("cpu")[:1])


def same_stats(got, want, n=None):
    assert got["n_reads"] == want["n_reads"]
    if n is not None:
        assert got["n_reads"] == n
    np.testing.assert_array_equal(got["base_hist"], want["base_hist"])
    for k in ("mean_gc", "mean_qual"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert ("quarantine" in got) == ("quarantine" in want)


def host_copies(batches):
    """The reference's batches as host arrays, copied as each is yielded
    (on the CPU its arrays may share the ring's memory)."""
    return [{k: np.array(v) for k, v in b.items()} for b in batches]


def same_batches(got, want):
    """Port batches (torch) == reference batches (jax), key by key."""
    want = host_copies(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            a, b = g[k].numpy(), np.asarray(w[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def _fastq(path, n, seed, lo=40, hi=170, name=lambda i: f"read{i}"):
    rng = random.Random(seed)
    reads = []
    with open(path, "w") as f:
        for i in range(n):
            k = rng.randint(lo, hi)
            seq = "".join(rng.choice("ACGTN") for _ in range(k))
            qual = "".join(chr(33 + rng.randint(2, 40)) for _ in range(k))
            reads.append((seq, qual))
            f.write(f"@{name(i)}\n{seq}\n+\n{qual}\n")
    return reads


def _qseq_frags(n, seed, filt=lambda i: True):
    rng = random.Random(seed)
    frags = []
    for i in range(n):
        k = rng.randint(30, 150)
        seq = "".join(rng.choice("ACGTN") for _ in range(k))
        qual = "".join(chr(33 + rng.randint(0, 41)) for _ in range(k))
        f = SequencedFragment.from_name(
            f"M:1:F:1:{i}:{i}:{i} 1:{'N' if filt(i) else 'Y'}:0:AAA", seq,
            qual)
        f.filter_passed = filt(i)
        frags.append(f)
    return frags


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trs") / "r.fastq")
    return path, _fastq(path, 2500, 11)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """tests/test_seq_pallas.py's fixture: 3000 reads of 30-170 bases
    (some past max_len), one contig."""
    from hadoop_bam_tpu.formats.bam import SAMHeader
    from hadoop_bam_tpu.formats.sam import SamRecord
    rng = random.Random(7)
    path = str(tmp_path_factory.mktemp("trs") / "p.bam")
    header = SAMHeader.from_sam_text("@HD\tVN:1.6\n@SQ\tSN:c1\tLN:1000000\n")
    recs = []
    for i in range(3000):
        n = rng.randint(30, 170)
        seq = "".join(rng.choice("ACGTN") for _ in range(n))
        qual = "".join(chr(33 + rng.randint(2, 40)) for _ in range(n))
        recs.append(SamRecord(
            qname=f"q{i}", flag=99, rname="c1", pos=10 + i * 3, mapq=60,
            cigar=f"{n}M", rnext="=", pnext=500, tlen=100, seq=seq,
            qual=qual))
    with BamWriter(path, header) as w:
        for r in recs:
            w.write_sam_record(r)
    return path, recs


# ---------------------------------------------------------------------------
# fastq_seq_stats_file
# ---------------------------------------------------------------------------

def test_fastq_stats_and_tensor_batches(fastq):
    """tests/test_seq_pallas.py:136: the stats equal the reference's and
    a host oracle; the batches equal the reference's on one device."""
    path, reads = fastq
    got = tp.fastq_seq_stats_file(path, device="cpu", geometry=TGEOM)
    same_stats(got, jp.fastq_seq_stats_file(path, geometry=GEOM), 2500)
    gcs = [sum(c in "GC" for c in s[:160]) / len(s[:160]) for s, _ in reads]
    mqs = [sum(ord(c) - 33 for c in q[:160]) / len(q[:160])
           for _, q in reads]
    assert abs(got["mean_gc"] - float(np.mean(gcs))) < 1e-6
    assert abs(got["mean_qual"] - float(np.mean(mqs))) < 1e-4
    tb = list(open_fastq(path, "cpu").tensor_batches(TGEOM, num_spans=3))
    same_batches(tb, (jrd.open_fastq(path).tensor_batches(
        mesh1(), GEOM, num_spans=3)))
    assert sum(int(b["n_records"].sum()) for b in tb) == 2500
    assert all(b["seq_packed"].shape[1:] == (1024, TGEOM.seq_stride)
               for b in tb[:-1])
    codes = tb[0]["seq_packed"][0, :1]
    letters = {1: "A", 2: "C", 4: "G", 8: "T", 15: "N"}
    ln = int(tb[0]["lengths"][0, 0])
    unpacked = torch.stack([codes >> 4, codes & 15], -1).reshape(-1)[:ln]
    assert "".join(letters[int(c)] for c in unpacked) == reads[0][0][:160]


@pytest.mark.parametrize("filter_qc", [False, True])
def test_qseq_stats_driver(tmp_path, filter_qc):
    """tests/test_seq_pallas.py:222: QSEQ through the vectorized path,
    and through the object path when failed-QC reads are filtered."""
    frags = _qseq_frags(800, 13, filt=lambda i: i % 5 != 0)
    path = str(tmp_path / "r.qseq")
    with QseqShardWriter(path) as w:
        for f in frags:
            w.write_record(f)
    jcfg = dataclasses.replace(JAX_CONFIG, qseq_filter_failed_qc=filter_qc)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    got = tp.fastq_seq_stats_file(path, device="cpu", config=tcfg,
                                  geometry=TGEOM)
    same_stats(got, jp.fastq_seq_stats_file(path, config=jcfg,
                                            geometry=GEOM),
               640 if filter_qc else 800)
    same_batches(list(open_qseq(path, "cpu", tcfg).tensor_batches(TGEOM)),
                 (jrd.open_qseq(path, jcfg).tensor_batches(mesh1(),
                                                               GEOM)))


def test_fastq_filter_failed_qc_stats(tmp_path):
    path = str(tmp_path / "q.fastq")
    _fastq(path, 600, 4, name=lambda i: f"M:1:F:1:1:{i}:{i} 1:"
           f"{'Y' if i % 4 == 0 else 'N'}:0:AC")
    jcfg = dataclasses.replace(JAX_CONFIG, fastq_filter_failed_qc=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    same_stats(tp.fastq_seq_stats_file(path, device="cpu", config=tcfg,
                                       geometry=TGEOM),
               jp.fastq_seq_stats_file(path, config=jcfg, geometry=GEOM),
               450)


def test_illumina_encoded_config_stats_match_reference(tmp_path):
    """An Illumina (+64) FASTQ read under a config dict that says so:
    the port re-bases the qualities as the reference does."""
    frags = _qseq_frags(700, 17)
    jcfg = dataclasses.replace(
        JAX_CONFIG, fastq_base_quality_encoding=JEnc.ILLUMINA)
    path = str(tmp_path / "i.fastq")
    with FastqShardWriter(path, config=jcfg) as w:
        for f in frags:
            w.write_record(f)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    got = tp.fastq_seq_stats_file(path, device="cpu", config=tcfg,
                                  geometry=TGEOM)
    same_stats(got, jp.fastq_seq_stats_file(path, config=jcfg,
                                            geometry=GEOM), 700)
    mq = np.mean([np.mean([ord(c) - 33 for c in f.quality]) for f in frags])
    assert abs(got["mean_qual"] - mq) < 1e-4
    # read as Sanger, the same bytes give other qualities (both packages)
    sanger = tp.fastq_seq_stats_file(path, device="cpu", geometry=TGEOM)
    assert abs(sanger["mean_qual"] - got["mean_qual"] - 31) < 1e-4


def test_qseq_gz_single_span_and_stats(tmp_path):
    import gzip
    frags = _qseq_frags(150, 14)
    plain = str(tmp_path / "r.qseq")
    with QseqShardWriter(plain) as w:
        for f in frags:
            w.write_record(f)
    gz = plain + ".gz"
    with open(plain, "rb") as fi, gzip.open(gz, "wb") as fo:
        fo.write(fi.read())
    assert len(open_qseq(gz, "cpu").spans()) == 1
    same_stats(tp.fastq_seq_stats_file(gz, device="cpu"),
               jp.fastq_seq_stats_file(gz), 150)


def test_fastq_quarantine_matches_reference(tmp_path):
    """A malformed record (SEQ/QUAL lengths differ) in one span: under
    skip_bad_spans both packages skip that span with equal manifests and
    equal stats over the rest; without it both raise FastqError."""
    path = str(tmp_path / "bad.fastq")
    _fastq(path, 400, 6)
    lines = open(path).read().split("\n")
    lines[4 * 250 + 3] = lines[4 * 250 + 3][:-3]
    open(path, "w").write("\n".join(lines))
    jcfg = dataclasses.replace(JAX_CONFIG, skip_bad_spans=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    tspans = open_fastq(path, "cpu").spans(num_spans=4)
    jspans = jrd.open_fastq(path).spans(num_spans=4)
    tq, jq = trs.QuarantineManifest(), jrs.QuarantineManifest()
    got = tp.fastq_seq_stats_file(path, device="cpu", config=tcfg,
                                  geometry=TGEOM, spans=tspans, quarantine=tq)
    want = jp.fastq_seq_stats_file(path, config=jcfg, geometry=GEOM,
                                   spans=jspans, quarantine=jq)
    same_stats(got, want)
    assert 0 < got["n_reads"] < 400
    assert got["quarantine"] == want["quarantine"] == jq.to_dicts()
    assert len(tq) == 1 and tq.total_spans == jq.total_spans == 4
    assert tq.to_dicts()[0]["error_class"] == "corrupt"
    for fn in (lambda: tp.fastq_seq_stats_file(path, device="cpu",
                                                geometry=TGEOM),
               lambda: jp.fastq_seq_stats_file(path, geometry=GEOM)):
        with pytest.raises(ValueError, match="SEQ/QUAL length mismatch"):
            fn()


def test_fastq_from_bam_records_equals_bam_stats(tmp_path):
    """A FASTQ written from the same records as a BAM (synth): its
    fastq_seq_stats_file equals seq_stats_file on the BAM, the
    reference's on both, and the generator's truth."""
    bam_path, fq_path = str(tmp_path / "s.bam"), str(tmp_path / "s.fastq")
    truth = synth.write_synthetic_bam(bam_path, 6000, 5, chunk_pairs=1000)
    fq_truth = synth.write_synthetic_reads(fq_path, 6000, 5,
                                           chunk_pairs=1000)
    assert np.array_equal(fq_truth.base_hist, truth.base_hist)
    fq = tp.fastq_seq_stats_file(fq_path, device="cpu", geometry=TGEOM)
    same_stats(fq, tp.seq_stats_file(bam_path, device="cpu",
                                     geometry=TGEOM), 6000)
    same_stats(fq, jp.fastq_seq_stats_file(fq_path, geometry=GEOM))
    same_stats(fq, jp.seq_stats_file(bam_path, geometry=GEOM))
    np.testing.assert_array_equal(fq["base_hist"], truth.base_hist)
    np.testing.assert_allclose(fq["mean_gc"], truth.mean_gc, rtol=1e-6)
    # a gzipped QSEQ of the first 1000 of those reads
    qs = str(tmp_path / "s.qseq.gz")
    q_truth = synth.write_synthetic_reads(qs, 6000, 5, fmt="qseq",
                                          limit=1000, compress=True,
                                          chunk_pairs=1000)
    got = tp.fastq_seq_stats_file(qs, device="cpu", geometry=TGEOM)
    same_stats(got, jp.fastq_seq_stats_file(qs, geometry=GEOM), 1000)
    np.testing.assert_array_equal(got["base_hist"], q_truth.base_hist)


@pytest.mark.parametrize("exts", [("x.fq", False), ("x.fastq.gz", False),
                                  ("x.QSEQ", True), ("x.qseq.gz", True)])
def test_extensions_match_reference(exts):
    name, is_qseq = exts
    for mod in (tp, jp):
        assert name.lower().endswith(mod.QSEQ_EXTS) == is_qseq
        assert name.lower().endswith(mod.TEXT_READ_EXTS)
    assert (tp.FASTQ_EXTS, tp.QSEQ_EXTS) == (jp.FASTQ_EXTS, jp.QSEQ_EXTS)


def test_pipeline_span_count_matches_reference(fastq):
    path = fastq[0]
    for cfg in (JAX_CONFIG, dataclasses.replace(JAX_CONFIG,
                                                split_size=1 << 12)):
        tcfg = config_from_dict(dataclasses.asdict(cfg))
        for n_dev in (1, 8):
            assert tp.pipeline_span_count(path, n_dev, tcfg) == \
                jp.pipeline_span_count(path, n_dev, cfg)
    assert tp.pipeline_span_count(path + ".missing", 3) == 3


# ---------------------------------------------------------------------------
# bucketed, fixed_shape and BAM / FASTA tensor batches
# ---------------------------------------------------------------------------

def test_bucketed_final_tile_matches_full_cap(tmp_path):
    """tests/test_pipeline.py:344: a file far smaller than tile_records
    ships a shrunk final tile, with every stats answer equal to the
    full-cap geometry's and the reference's."""
    fq = str(tmp_path / "small.fastq")
    _fastq(fq, 700, 21, lo=80, hi=80)
    big = jp.PayloadGeometry(tile_records=4096, block_n=256)
    small = jp.PayloadGeometry(tile_records=256, block_n=256)
    got = tp.fastq_seq_stats_file(fq, device="cpu", geometry=geometry_from_dict(
        dataclasses.asdict(big)))
    want = tp.fastq_seq_stats_file(fq, device="cpu", geometry=geometry_from_dict(
        dataclasses.asdict(small)))
    same_stats(got, want, 700)
    same_stats(got, jp.fastq_seq_stats_file(fq, geometry=big))


@pytest.mark.parametrize("fixed", [False, True])
def test_tensor_batch_shapes(tmp_path, fixed):
    """tests/test_pipeline.py:384 and :404: full batches keep
    tile_records rows; the final batch shrinks to a bucket (600 rows ->
    1024) unless fixed_shape, which pads it to tile_records; FASTQ and
    BAM batches equal the reference's on one device."""
    fq = str(tmp_path / "shapes.fastq")
    with open(fq, "w") as f:
        for i in range(600):
            f.write(f"@r{i}\nACGTACGTAC\n+\nIIIIIIIIII\n")
    geom = jp.PayloadGeometry(tile_records=4096, block_n=256,
                              fixed_shape=fixed)
    tgeom = geometry_from_dict(dataclasses.asdict(geom))
    assert tgeom.fixed_shape is fixed
    got = list(open_fastq(fq, "cpu").tensor_batches(tgeom))
    same_batches(got, (jrd.open_fastq(fq).tensor_batches(mesh1(),
                                                             geom)))
    assert sum(int(b["n_records"].sum()) for b in got) == 600
    assert got[-1]["qual"].shape[1] == (4096 if fixed else 1024)
    bam = str(tmp_path / "shapes.bam")
    header = make_header()
    with BamWriter(bam, header) as w:
        for r in make_records(header, 500, seed=3):
            w.write_sam_record(r)
    got = list(open_bam(bam, "cpu").tensor_batches(geometry=tgeom))
    same_batches(got, (jopen_bam(bam).tensor_batches(mesh1(), geom)))
    assert all(b["prefix"].shape[1] == (4096 if fixed else 1024)
               for b in got)
    assert sum(int(b["n_records"].sum()) for b in got) == 500


@pytest.mark.parametrize("num_spans", [None, 4])
def test_bam_tensor_batches_match_reference(bam, num_spans):
    """tests/test_seq_pallas.py:178: the BAM payload feed, batch for
    batch; read_stats_step over the batches (lengths from the prefix
    tiles) equals seq_stats_file."""
    from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields_tile
    path, recs = bam
    got = list(open_bam(path, "cpu").tensor_batches(TGEOM, num_spans))
    same_batches(got, (jopen_bam(path).tensor_batches(
        mesh1(), GEOM, num_spans)))
    assert sum(int(b["n_records"].sum()) for b in got) == len(recs)
    totals = tp._StatTotals()
    for b in got:
        cols = unpack_fixed_fields_tile(b["prefix"][0])
        assert (cols["flag"][:int(b["n_records"][0])] == 99).all()
        lengths = torch.clamp(cols["l_seq"], max=TGEOM.max_len)
        totals.add(*tp.read_stats_step(b["seq_packed"][0], b["qual"][0],
                                       lengths, b["n_records"][0]))
    same_stats(tp._payload_stats_result(totals),
               tp.seq_stats_file(path, device="cpu", geometry=TGEOM),
               len(recs))


def test_fasta_window_tensor_batches(tmp_path):
    """tests/test_seq_pallas.py:196: windows cover every contig (700 ->
    1 short window; 1500 -> starts {0, 476}; 2300 -> {0, 1024, 1276});
    the batches equal the reference's, quality rows zero."""
    rng = random.Random(3)
    path = str(tmp_path / "ref.fa")
    sizes = {"ctg0": 700, "ctg1": 1500, "ctg2": 2300}
    with open(path, "w") as f:
        for name, n in sizes.items():
            seq = "".join(rng.choice("ACGT") for _ in range(n))
            f.write(f">{name}\n")
            for i in range(0, n, 70):
                f.write(seq[i:i + 70] + "\n")
    g = jp.PayloadGeometry(max_len=1024, tile_records=256, block_n=256)
    tg = geometry_from_dict(dataclasses.asdict(g))
    for stride in (0, 300):
        got = list(open_fasta(path, "cpu").window_tensor_batches(
            window=1024, stride=stride, geometry=tg, num_spans=2))
        same_batches(got, (jrd.open_fasta(path).window_tensor_batches(
            window=1024, stride=stride, mesh=mesh1(), geometry=g,
            num_spans=2)))
        n = sum(int(b["n_records"].sum()) for b in got)
        assert n == sum(synth.window_count(k, 1024, stride)
                        for k in sizes.values())
        assert n == (6 if stride == 0 else 1 + 3 + 6)
        assert all(int(b["qual"].sum()) == 0 for b in got)
    # the default geometry: max_len = window, strides (512, 1024)
    b = next(open_fasta(path, "cpu").window_tensor_batches(window=1024))
    assert (b["seq_packed"].shape[2], b["qual"].shape[2]) == (512, 1024)


def test_synthetic_fasta_window_count(tmp_path):
    path = str(tmp_path / "s.fa")
    contigs = (("a", 5000), ("b", 12345), ("c", 1024), ("d", 3))
    assert synth.write_synthetic_fasta(path, 2, contigs) == dict(contigs)
    got = list(open_fasta(path, "cpu").window_tensor_batches(window=1024))
    assert sum(int(b["n_records"].sum()) for b in got) == \
        sum(synth.window_count(n, 1024) for _, n in contigs) == 5 + 13 + 1 + 1
    assert [(f.contig, len(f.sequence)) for f in
            jrd.open_fasta(path).fragments(num_spans=1)][-1] == ("d", 3)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def test_read_stats_step_matches_reference_step(fastq):
    """read_stats_step on one device's tiles equals the reference's
    make_read_stats_step on a one-device mesh (rows past the count masked)."""
    text = open(fastq[0], "rb").read()
    seq, qual, lengths = jrd.fastq_text_to_payload_tiles(
        text, GEOM.seq_stride, GEOM.qual_stride, GEOM.max_len)
    n = 1024
    count = 700
    step = jp.make_read_stats_step(mesh1(), GEOM)
    jf, ji = step(seq[None, :n], qual[None, :n], lengths[None, :n],
                  np.asarray([count], np.int32))
    for c in (count, torch.tensor(count)):
        tf, ti = tp.read_stats_step(torch.from_numpy(seq[:n]),
                                    torch.from_numpy(qual[:n]),
                                    torch.from_numpy(lengths[:n]), c)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)


@pytest.fixture(scope="module")
def span_bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trs") / "u.bam")
    header = make_header()
    with BamWriter(path, header) as w:
        for r in make_records(header, 5000, seed=11):
            w.write_sam_record(r)
    return path


@pytest.mark.parametrize("n_dev", [1, 8])
def test_unpack_step_matches_reference(span_bam, n_dev):
    """tests/test_pipeline.py:122: a stacked span group through the K1
    gather gives the reference's make_unpack_step columns and valid mask
    (n_dev = 1 on a one-device mesh; 8 on the default mesh)."""
    path = span_bam
    geom = jp.DecodeGeometry(bytes_cap=1 << 21, records_cap=1 << 14)
    tgeom = geometry_from_dict(dataclasses.asdict(geom))
    tgroup = list(tp.iter_span_groups(plan_bam_spans(path, num_spans=8),
                                      n_dev))[0]
    jgroup = list(jp.iter_span_groups(jplan_bam(path, num_spans=8),
                                      n_dev))[0]
    tb = tp.stack_span_group(path, tgroup, n_dev, tgeom)
    jb = jp.stack_span_group(path, jgroup, n_dev, geom)
    np.testing.assert_array_equal(tb.data, jb.data)
    np.testing.assert_array_equal(tb.offsets, jb.offsets)
    np.testing.assert_array_equal(tb.n_records, jb.n_records)
    cols = tp.unpack_step(torch.from_numpy(tb.data),
                          torch.from_numpy(tb.offsets),
                          torch.from_numpy(tb.n_records))
    mesh = mesh1() if n_dev == 1 else make_mesh()
    want = jp.make_unpack_step(mesh)(jb.data, jb.offsets, jb.n_records)
    assert sorted(cols) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = cols[k].numpy()
        assert g.shape == w.shape == (n_dev, geom.records_cap), k
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
    n = int(tb.n_records[0])
    hb = JBamBatch(tb.data[0], tb.offsets[0, :n].astype(np.int64))
    np.testing.assert_array_equal(cols["pos"][0, :n].numpy(), hb.pos)
    assert cols["valid"][0, :n].all() and not cols["valid"][0, n:].any()


# ---------------------------------------------------------------------------
# the staging ring's fixed_shape, balance and stream forms
# ---------------------------------------------------------------------------

SPECS = ((TileSpec((7,), np.uint8, 0), jstaging.TileSpec((7,), np.uint8, 0)),
         (TileSpec((3,), np.int8, -1), jstaging.TileSpec((3,), np.int8, -1)),
         (TileSpec((), np.int32, 0), jstaging.TileSpec((), np.int32, 0)))


def _spans(rng, n_spans, max_rows=57):
    out, seq = [], 0
    for _ in range(n_spans):
        n = int(rng.integers(0, max_rows + 1))
        arrays = []
        for spec, _j in SPECS:
            shape = (n,) + spec.shape
            info = np.iinfo(np.dtype(spec.dtype))
            a = (seq + np.arange(int(np.prod(shape)), dtype=np.int64)
                 ).reshape(shape) % int(info.max) + 1
            arrays.append(a.astype(spec.dtype))
        seq += n
        out.append(tuple(arrays))
    return out


@pytest.mark.parametrize("n_dev,cap,fixed,balance", [
    (1, 32, False, False), (1, 32, True, True), (3, 32, False, True),
    (3, 32, True, False), (8, 64, True, True), (4, 16, False, False)])
def test_feed_pipeline_groups_match_reference(n_dev, cap, fixed, balance):
    """fixed_shape and balance: the port's groups equal the reference
    FeedPipeline's, byte for byte, with counts and bucket heights."""
    rng = np.random.default_rng(1234 + n_dev + cap)
    for _ in range(4):
        spans = _spans(rng, int(rng.integers(0, 24)))
        want = []
        jstaging.FeedPipeline(
            n_dev, cap, [j for _t, j in SPECS], block_n=8,
            fixed_shape=fixed, balance=balance, ring_slots=2).feed(
            iter(spans), lambda a, c: want.append(
                ([x.copy() for x in a], c.copy())))
        got = []
        fp = FeedPipeline(n_dev, cap, [t for t, _j in SPECS], block_n=8,
                          fixed_shape=fixed, balance=balance)
        assert fp.feed(iter(spans), lambda t, c: got.append(
            ([x.numpy().copy() for x in t], c.copy()))) == len(want)
        assert len(got) == len(want)
        for (ga, gc), (wa, wc) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            for g, w in zip(ga, wa):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)


def test_stream_mode_releases_slot_only_after_advance():
    """tests/test_staging.py:177: a yielded batch's buffers stay valid
    until the consumer asks for the next one; the in-flight handle is
    waited on before the slot is packed again."""
    class Handle:
        def __init__(self):
            self.synced = False

        def synchronize(self):
            self.synced = True

    spans = [(np.full((10, 4), i + 1, np.uint8),) for i in range(12)]
    fp = FeedPipeline(2, 8, (TileSpec((4,), np.uint8),), block_n=4)
    handles = []

    def emit(t, c):
        handles.append(Handle())
        return (t[0], c), handles[-1]

    it = fp.stream(iter(spans), emit)
    tile, counts = next(it)
    first = tile.clone()
    time.sleep(0.05)             # the packer has every chance to misbehave
    assert torch.equal(tile, first)
    rest = list(it)
    assert rest and fp.dispatches == 1 + len(rest)
    assert all(h.synced for h in handles[:-2])


def test_stream_closed_early_stops_the_packer():
    import threading
    before = threading.active_count()
    spans = ((np.zeros((8, 4), np.uint8),) for _ in range(1000))
    fp = FeedPipeline(1, 8, (TileSpec((4,), np.uint8),))
    it = fp.stream(spans, lambda t, c: (None, None))
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_tensor_batches_are_the_consumers_own(fastq):
    """A consumer that holds every batch across next() sees each one as
    it was yielded: on the CPU the feed clones out of the ring."""
    path = fastq[0]
    g = geometry_from_dict(dataclasses.asdict(jp.PayloadGeometry(
        tile_records=256, block_n=256)))
    held = list(open_fastq(path, "cpu").tensor_batches(g, num_spans=4))
    same_batches(held, jrd.open_fastq(path).tensor_batches(
        mesh1(), jp.PayloadGeometry(tile_records=256, block_n=256), 4))
    assert len(held) == 10
