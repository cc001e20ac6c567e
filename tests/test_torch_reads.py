"""The port's read formats (FASTQ, QSEQ, FASTA) against the JAX package's,
on the same seeded inputs: value types and codecs, span planning and
reading at every byte boundary, CRLF and gzip input, the vectorized
payload packers, their guards and malformed inputs.

Everything compared here is exact: parsed fields, span bytes, tiles,
and error classes (by name, both ValueErrors) with their messages.
"""
import dataclasses
import gzip
import random

import numpy as np
import pytest

from hadoop_bam_tpu.api import read_datasets as jrd
from hadoop_bam_tpu.api.writers import FastqShardWriter, QseqShardWriter
from hadoop_bam_tpu.config import BaseQualityEncoding as JEnc
from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats import fasta as jfa
from hadoop_bam_tpu.formats import fastq as jfq
from hadoop_bam_tpu.formats import qseq as jqs
from hadoop_bam_tpu.split import planners as jpl
from hadoop_bam_tpu.split import read_planners as jrp
from hadoop_bam_tpu.split.spans import FileByteSpan as JSpan
from hadoop_bam_torch.api import read_datasets as trd
from hadoop_bam_torch.config import BaseQualityEncoding as TEnc
from hadoop_bam_torch.config import HBamConfig, config_from_dict
from hadoop_bam_torch.formats import fasta as tfa
from hadoop_bam_torch.formats import fastq as tfq
from hadoop_bam_torch.formats import qseq as tqs
from hadoop_bam_torch.split import planners as tpl
from hadoop_bam_torch.split import read_planners as trp
from hadoop_bam_torch.split.spans import FileByteSpan
from hadoop_bam_torch.utils.errors import PlanError


def make_fragments(n: int, seed: int = 0):
    """tests/test_reads.py's reads: 30-120 bases of ACGTN, qualities that
    often begin with '@' (64) or '+' (43), Casava 1.8 names."""
    rng = random.Random(seed)
    frags = []
    for i in range(n):
        k = rng.randint(30, 120)
        seq = "".join(rng.choice("ACGTN") for _ in range(k))
        qual = "".join(chr(rng.choice([33 + rng.randint(0, 60), 64, 43]))
                       for _ in range(k))
        name = (f"M0:{i % 4}:FC1:1:{1000 + i}:{rng.randint(0, 9999)}:"
                f"{rng.randint(0, 9999)}")
        frags.append(jfq.SequencedFragment.from_name(name, seq, qual))
    return frags


def fields(frags):
    return [dataclasses.astuple(f) for f in frags]


def same_error(jfn, tfn):
    """Both raise: the same class name, message, and a ValueError."""
    with pytest.raises(ValueError) as je:
        jfn()
    with pytest.raises(ValueError) as te:
        tfn()
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


def write_fastq(path, frags):
    with FastqShardWriter(path) as w:
        for f in frags:
            w.write_record(f)


def write_qseq(path, frags):
    with QseqShardWriter(path) as w:
        for f in frags:
            w.write_record(f)


@pytest.fixture(scope="module")
def fastq_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("treads") / "r.fastq")
    frags = make_fragments(300, seed=11)
    write_fastq(path, frags)
    return path, frags


# ---------------------------------------------------------------------------
# value types and codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "EAS139:136:FC706VJ:2:2104:15343:197393 1:Y:18:ATCACG",
    "EAS139:136:FC706VJ:2:2104:15343:197393 2:N:0:",
    "HWUSI-EAS100R:6:73:941:1973#ATCG/1",
    "HWUSI-EAS100R:6:73:941:-1973",
    "plain_name with spaces"])
def test_name_metadata_matches_reference(name):
    t = tfq.SequencedFragment.from_name(name, "ACGT", "IIII")
    j = jfq.SequencedFragment.from_name(name, "ACGT", "IIII")
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert t.to_fastq() == j.to_fastq()


@pytest.mark.parametrize("q,src,dst", [
    ("II?5+#", "SANGER", "ILLUMINA"), ("hhhiB@", "ILLUMINA", "SANGER"),
    ("II", "SANGER", "SANGER")])
def test_quality_conversion_matches_reference(q, src, dst):
    assert tfq.convert_quality(q, TEnc[src], TEnc[dst]) == \
        jfq.convert_quality(q, JEnc[src], JEnc[dst])


def test_quality_conversion_out_of_range_raises_as_reference():
    same_error(lambda: jfq.convert_quality("!!", JEnc.ILLUMINA),
               lambda: tfq.convert_quality("!!", TEnc.ILLUMINA))
    same_error(lambda: jfq.convert_quality("~", JEnc.SANGER, JEnc.ILLUMINA),
               lambda: tfq.convert_quality("~", TEnc.SANGER, TEnc.ILLUMINA))


def test_fastq_parse_matches_reference(fastq_file):
    path, frags = fastq_file
    text = open(path, "rb").read()
    got = tfq.parse_fastq(text)
    assert fields(got) == fields(jfq.parse_fastq(text)) == fields(
        jfq.parse_fastq(b"".join(f.to_fastq().encode() for f in frags)))


@pytest.mark.parametrize("text", [
    b"@a\nACGT\n+\n", b"@a\nACGT\n+\nII\n", b"a\nACGT\n+\nIIII\n",
    b"@r0\nACGT\n+\nIIII\n\n", b"@a\nACGT\n-\nIIII\n"])
def test_fastq_parse_malformed_raises_as_reference(text):
    same_error(lambda: jfq.parse_fastq(text), lambda: tfq.parse_fastq(text))


def test_record_start_heuristic_at_every_offset(fastq_file):
    """The @/+ scanner gives the reference's answer from every byte
    offset, on the file and on a quality line that begins with '@'."""
    text = (b"@r1\nACGT\n+\n@@@@\n"
            b"@r2\nTTTT\n+\nIIII\n")
    assert text[tfq.find_fastq_record_start(text, 9):][:3] == b"@r2"
    for buf in (text, open(fastq_file[0], "rb").read()[:6000]):
        for off in range(len(buf) + 1):
            assert tfq.find_fastq_record_start(buf, off) == \
                jfq.find_fastq_record_start(buf, off), off
            assert tfq.record_fully_visible(buf, off) == \
                jfq.record_fully_visible(buf, off), off


@pytest.mark.parametrize("num_spans", [1, 2, 5, 9])
def test_fastq_span_union(fastq_file, num_spans):
    path, frags = fastq_file
    ds = trd.open_fastq(path, device="cpu")
    got = list(ds.records(num_spans=num_spans))
    assert [s.to_dict() for s in ds.spans()] == [
        s.to_dict() for s in jrd.open_fastq(path).spans(num_spans)]
    assert fields(got) == fields(
        jrd.open_fastq(path).records(num_spans=num_spans))
    assert [f.name for f in got] == [f.name for f in frags]


@pytest.fixture(scope="module")
def small_fastq(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("treads") / "small.fastq")
    frags = make_fragments(24, seed=5)
    write_fastq(path, frags)
    return path, frags


def test_fastq_every_boundary(small_fastq):
    """A two-span split at EVERY byte offset: the union is the file's
    records once each, in order; at a sample of offsets both spans'
    bytes equal the reference's."""
    path, frags = small_fastq
    size = len(open(path, "rb").read())
    want = [f.name for f in frags]
    rng = random.Random(5)
    sample = {1, 7, size // 2, size - 3} | {rng.randrange(1, size)
                                           for _ in range(40)}
    for cut in range(size + 1):
        a = trp.read_fastq_span(path, FileByteSpan(path, 0, cut))
        b = trp.read_fastq_span(path, FileByteSpan(path, cut, size))
        got = [f.name for f in tfq.parse_fastq(a) + tfq.parse_fastq(b)]
        assert got == want, f"cut={cut}"
        if cut in sample:
            assert a == jrp.read_fastq_span(path, JSpan(path, 0, cut))
            assert b == jrp.read_fastq_span(path, JSpan(path, cut, size))


def test_fastq_filter_failed_qc(tmp_path):
    frags = [jfq.SequencedFragment.from_name(
        f"M:1:F:1:1:{i}:{i} 1:{filt}:0:AAA", "ACGT", "IIII")
        for i, filt in enumerate("YNYN")]
    p = str(tmp_path / "f.fastq")
    write_fastq(p, frags)
    jcfg = dataclasses.replace(JAX_CONFIG, fastq_filter_failed_qc=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.fastq_filter_failed_qc
    got = list(trd.open_fastq(p, "cpu", tcfg).records(num_spans=1))
    assert fields(got) == fields(jrd.open_fastq(p, jcfg).records(1))
    assert len(got) == 2 and all(f.filter_passed for f in got)


def test_illumina_encoded_fastq_config_matches_reference(tmp_path):
    """A config dict with the Illumina (+64) encoding carries over and
    parses the reference's qualities; before, config_from_dict dropped
    the field and read the file as Sanger."""
    frags = make_fragments(40, seed=3)
    frags = [dataclasses.replace(f, quality="".join(
        chr(min(ord(c), 33 + 60)) for c in f.quality)) for f in frags]
    jcfg = dataclasses.replace(
        JAX_CONFIG, fastq_base_quality_encoding=JEnc.ILLUMINA)
    p = str(tmp_path / "i.fastq")
    with FastqShardWriter(p, config=jcfg) as w:
        for f in frags:
            w.write_record(f)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.fastq_base_quality_encoding is TEnc.ILLUMINA
    assert tcfg.qseq_base_quality_encoding is TEnc.ILLUMINA
    got = list(trd.open_fastq(p, "cpu", tcfg).records(num_spans=2))
    assert fields(got) == fields(jrd.open_fastq(p, jcfg).records(2))
    assert [f.quality for f in got] == [f.quality for f in frags]
    # the Sanger default reads the same bytes differently, as the
    # reference does
    sanger = list(trd.open_fastq(p, "cpu").records(num_spans=2))
    assert [f.quality for f in sanger] != [f.quality for f in frags]


@pytest.mark.parametrize("value,want", [
    ("illumina", TEnc.ILLUMINA), ("SANGER", TEnc.SANGER),
    (JEnc.SANGER, TEnc.SANGER), (None, TEnc.SANGER)])
def test_quality_encoding_setting_parses(value, want):
    assert HBamConfig(fastq_base_quality_encoding=value) \
        .fastq_base_quality_encoding is want


def test_unknown_quality_encoding_is_a_plan_error():
    with pytest.raises(PlanError):
        HBamConfig(qseq_base_quality_encoding="phred42")


# ---------------------------------------------------------------------------
# QSEQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("line", [
    "M001\t5\t1\t1101\t100\t200\tACGTAC\t1\tACGTN.AC\tabcdefgh\t1",
    "M001\t\t1\t1101\t100\t200\t0\t2\t.....\tBBBBB\t0",
    "\t5\t\t\t\t\t\t\tA\th\t1"])
def test_qseq_line_roundtrip_matches_reference(line):
    t = tqs.parse_qseq_line(line)
    j = jqs.parse_qseq_line(line)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert tqs.format_qseq_line(t) == jqs.format_qseq_line(j)
    assert tqs.format_qseq_line(t, TEnc.SANGER) == \
        jqs.format_qseq_line(j, JEnc.SANGER)


@pytest.mark.parametrize("line", [
    "a\tb\tc", "M\t1\t1\t1\t1\t1\t0\t1\tACGT\tab\t1",
    "M\t1\t1\t1\t1\t1\t0\t1\tACGT\t!!!!\t1"])
def test_qseq_malformed_raises_as_reference(line):
    same_error(lambda: jqs.parse_qseq_line(line),
               lambda: tqs.parse_qseq_line(line))


@pytest.mark.parametrize("num_spans", [1, 3, 7])
def test_qseq_span_union(tmp_path, num_spans):
    frags = make_fragments(120, seed=4)
    p = str(tmp_path / "r.qseq")
    write_qseq(p, frags)
    got = list(trd.open_qseq(p, "cpu").records(num_spans=num_spans))
    assert fields(got) == fields(jrd.open_qseq(p).records(num_spans))
    assert [f.sequence for f in got] == [f.sequence for f in frags]


def test_qseq_filter_failed_qc(tmp_path):
    frags = make_fragments(30, seed=6)
    for i, f in enumerate(frags):
        f.filter_passed = bool(i % 3)
    p = str(tmp_path / "q.qseq")
    write_qseq(p, frags)
    jcfg = dataclasses.replace(JAX_CONFIG, qseq_filter_failed_qc=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    got = list(trd.open_qseq(p, "cpu", tcfg).records(num_spans=2))
    assert fields(got) == fields(jrd.open_qseq(p, jcfg).records(2))
    assert len(got) == 20


def test_text_span_reader_at_every_boundary(tmp_path):
    """read_text_span (the QSEQ reader): a two-span split at every byte
    offset gives the reference's bytes, whose union is the file."""
    frags = make_fragments(12, seed=8)
    p = str(tmp_path / "b.qseq")
    write_qseq(p, frags)
    data = open(p, "rb").read()
    for cut in range(len(data) + 1):
        a = tpl.read_text_span(p, FileByteSpan(p, 0, cut))
        b = tpl.read_text_span(p, FileByteSpan(p, cut, len(data)))
        assert a + b == data, cut
        assert a == jpl.read_text_span(p, JSpan(p, 0, cut), chunk=7) \
            == tpl.read_text_span(p, FileByteSpan(p, 0, cut), chunk=7)
        assert b == jpl.read_text_span(p, JSpan(p, cut, len(data)))


# ---------------------------------------------------------------------------
# FASTA
# ---------------------------------------------------------------------------

FASTA_TEXT = b""">chr1 test contig
ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT
TTTTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTTTTT
ACGT
>chr2
GGGGACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTACGTCCCC
AAAA
>chr3
CCCC
"""


@pytest.mark.parametrize("line_fragments", [True, False])
def test_fasta_parse_matches_reference(line_fragments):
    got = tfa.parse_fasta(FASTA_TEXT, line_fragments)
    assert fields(got) == fields(jfa.parse_fasta(FASTA_TEXT,
                                                 line_fragments))
    if line_fragments:
        assert [f.position for f in got] == [1, 61, 121, 1, 61, 1]


@pytest.mark.parametrize("text", [b">\nACGT\n", b"ACGT\n>c\nAC\n"])
def test_bad_fasta_raises_as_reference(text):
    same_error(lambda: jfa.parse_fasta(text), lambda: tfa.parse_fasta(text))


def test_find_sequence_start_at_every_offset():
    for off in range(len(FASTA_TEXT) + 2):
        assert tfa.find_sequence_start(FASTA_TEXT, off) == \
            jfa.find_sequence_start(FASTA_TEXT, off), off


@pytest.mark.parametrize("num_spans", [1, 2, 3, 5, 40])
def test_fasta_span_union(tmp_path, num_spans):
    p = str(tmp_path / "r.fa")
    open(p, "wb").write(FASTA_TEXT)
    ds = trd.open_fasta(p, "cpu")
    got = list(ds.fragments(num_spans=num_spans))
    assert [s.to_dict() for s in ds.spans()] == [
        s.to_dict() for s in jrp.plan_fasta_spans(p, num_spans=num_spans)]
    assert fields(got) == fields(tfa.parse_fasta(FASTA_TEXT))
    for s in ds.spans():
        assert trp.read_fasta_span(p, s) == jrp.read_fasta_span(
            p, JSpan(p, s.start, s.end))


def test_fasta_span_bytes_plan(tmp_path):
    p = str(tmp_path / "r.fa")
    open(p, "wb").write(FASTA_TEXT * 3)
    for sb in (1, 17, 100, 1 << 20):
        assert [s.to_dict() for s in trp.plan_fasta_spans(
            p, span_bytes=sb)] == [s.to_dict() for s in
                                    jrp.plan_fasta_spans(p, span_bytes=sb)]


# ---------------------------------------------------------------------------
# CRLF, gzip, re-iteration, resume
# ---------------------------------------------------------------------------

def test_crlf_fastq(tmp_path):
    frags = make_fragments(5, seed=1)
    text = "".join(f.to_fastq() for f in frags).replace("\n", "\r\n")
    p = str(tmp_path / "crlf.fastq")
    open(p, "wb").write(text.encode())
    got = list(trd.open_fastq(p, "cpu").records(num_spans=2))
    assert fields(got) == fields(jrd.open_fastq(p).records(num_spans=2))
    assert [g.name for g in got] == [f.name for f in frags]


@pytest.mark.parametrize("fmt", ["fastq", "qseq"])
def test_compressed_input_is_one_span(tmp_path, fmt):
    frags = make_fragments(20, seed=2)
    plain = str(tmp_path / f"c.{fmt}")
    (write_fastq if fmt == "fastq" else write_qseq)(plain, frags)
    p = plain + ".gz"
    open(p, "wb").write(gzip.compress(open(plain, "rb").read()))
    opener = trd.open_fastq if fmt == "fastq" else trd.open_qseq
    jopener = jrd.open_fastq if fmt == "fastq" else jrd.open_qseq
    ds = opener(p, "cpu")
    assert len(ds.spans()) == 1    # non-splittable, like Hadoop's gzip
    got = list(ds.records())
    assert fields(got) == fields(jopener(p).records())
    assert [g.sequence for g in got] == [f.sequence for f in frags]
    assert ds.read_span_text(ds.spans()[0]) == \
        jopener(p).read_span_text(jopener(p).spans()[0])


def test_dataset_reiteration_plan_conflict_and_resume(fastq_file):
    path, frags = fastq_file
    ds = trd.open_fastq(path, "cpu")
    a = list(ds.records(num_spans=3))
    b = list(ds.records())     # a fresh iteration after exhaustion
    assert len(a) == len(b) == len(frags)
    with pytest.raises(ValueError):
        ds.spans(num_spans=8)  # a conflicting re-plan is loud
    # resume: the state after one span, in both packages
    tds, jds = trd.open_fastq(path, "cpu"), jrd.open_fastq(path)
    ti, ji = tds.records(num_spans=3), jds.records(num_spans=3)
    first = next(ti), next(ji)
    assert dataclasses.astuple(first[0]) == dataclasses.astuple(first[1])
    assert tds.state_dict() == jds.state_dict()
    fresh = trd.open_fastq(path, "cpu")
    fresh.load_state_dict(tds.state_dict())
    jfresh = jrd.open_fastq(path)
    jfresh.load_state_dict(jds.state_dict())
    assert fields(fresh.records()) == fields(jfresh.records())


def test_datasets_default_to_cuda(fastq_file, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for opener in (trd.open_fastq, trd.open_qseq, trd.open_fasta):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            opener(fastq_file[0])


# ---------------------------------------------------------------------------
# the vectorized packers
# ---------------------------------------------------------------------------

def _read_text(crlf: bool, trailing_newline: bool) -> bytes:
    rng = random.Random(3)
    reads = []
    for i in range(137):
        n = rng.choice([1, 2, 37, 40, 160, 161, 300])
        seq = "".join(rng.choice("ACGTNacgtnRYKM") for _ in range(n))
        qual = "".join(chr(33 + rng.randint(0, 41)) for _ in range(n))
        reads.append(f"@r{i} extra meta\n{seq}\n+\n{qual}")
    sep = "\r\n" if crlf else "\n"
    text = sep.join(r.replace("\n", sep) for r in reads)
    return (text + sep if trailing_newline else text).encode()


def same_tiles(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("crlf", [False, True])
@pytest.mark.parametrize("trailing_newline", [False, True])
def test_fastq_vectorized_tiles_parity(crlf, trailing_newline):
    """Mixed lengths, lowercase, N and ambiguity codes, reads past
    max_len: the port's packer equals the reference's and the port's
    object path."""
    text = _read_text(crlf, trailing_newline)
    for sb, qb, max_len in ((80, 160, 160), (16, 32, 32)):
        got = trd.fastq_text_to_payload_tiles(text, sb, qb, max_len)
        same_tiles(got, jrd.fastq_text_to_payload_tiles(text, sb, qb,
                                                        max_len))
        same_tiles(got, trd.fragments_to_payload_tiles(
            tfq.parse_fastq(text), sb, qb, max_len))


@pytest.mark.parametrize("text,offset", [
    (b"@a\nACGT\n+\nhhhi\n", 64), (b"@r0\nACGT\n+\nIIII\n@r1\n\n+\n\n", 33),
    (b"", 33)])
def test_fastq_vectorized_tiles_edges(text, offset):
    got = trd.fastq_text_to_payload_tiles(text, 8, 8, 8, qual_offset=offset)
    same_tiles(got, jrd.fastq_text_to_payload_tiles(text, 8, 8, 8,
                                                    qual_offset=offset))


@pytest.mark.parametrize("text,offset", [
    (b"@a\nACGT\n+\n", 33), (b"@a\nACGT\n+\nII\n", 33),
    (b"a\nACGT\n+\nIIII\n", 33), (b"@r0\nACGT\n+\nIIII\n\n", 33),
    (b"@a\nACGT\n+\n!!!!\n", 64), (b"\n", 33)])
def test_fastq_vectorized_tiles_malformed(text, offset):
    same_error(lambda: jrd.fastq_text_to_payload_tiles(text, 8, 8, 8,
                                                       offset),
               lambda: trd.fastq_text_to_payload_tiles(text, 8, 8, 8,
                                                       offset))
    assert issubclass(tfq.FastqError, ValueError)


@pytest.mark.parametrize("crlf", [False, True])
def test_qseq_vectorized_tiles_parity(crlf):
    frags = make_fragments(120, seed=8)
    sep = "\r\n" if crlf else "\n"
    text = (sep.join(jqs.format_qseq_line(f) for f in frags) + sep).encode()
    got = trd.qseq_text_to_payload_tiles(text, 80, 160, 160)
    same_tiles(got, jrd.qseq_text_to_payload_tiles(text, 80, 160, 160))
    same_tiles(got, trd.fragments_to_payload_tiles(
        tqs.parse_qseq(text), 80, 160, 160))


@pytest.mark.parametrize("text,max_len", [
    (b"a\tb\tc\n", 8), (b"M\t1\t1\t1\t1\t1\t0\t1\tACGT\tab\t1\n", 8),
    (b"M\t1\t1\t1\t1\t1\t0\t1\tACGT\t!!!!\t1\n", 8),
    (b"M\t1\t1\t1\t1\t1\t0\t1\tACGTAC\tabcd!!\t1\n", 4)])
def test_qseq_vectorized_tiles_malformed(text, max_len):
    """Field count, SEQ/QUAL mismatch, and the wrong-encoding guard over
    the WHOLE quality field (bad bytes past max_len too)."""
    same_error(lambda: jrd.qseq_text_to_payload_tiles(text, 8, 8, max_len),
               lambda: trd.qseq_text_to_payload_tiles(text, 8, 8, max_len))
    same_error(lambda: jqs.parse_qseq(text), lambda: tqs.parse_qseq(text))


def test_qseq_vectorized_tiles_empty():
    same_tiles(trd.qseq_text_to_payload_tiles(b"", 8, 8, 8),
               jrd.qseq_text_to_payload_tiles(b"", 8, 8, 8))
    same_tiles(trd.qseq_text_to_payload_tiles(b"\n\n", 8, 8, 8),
               jrd.qseq_text_to_payload_tiles(b"\n\n", 8, 8, 8))


@pytest.mark.parametrize("uniform", [False, True])
def test_ragged_to_payload_tiles_parity(uniform):
    rng = np.random.default_rng(4)
    n = 50
    lens = np.full(n, 37) if uniform else rng.integers(0, 60, n)
    qlens = lens if uniform else np.where(rng.random(n) < 0.3, 0, lens)
    seq_cat = bytes(rng.choice(list(b"ACGTNacgtn=.RY"),
                               int(lens.sum())).astype(np.uint8))
    qual_cat = bytes(rng.integers(33, 75, int(qlens.sum()), dtype=np.uint8))
    for offset in (0, 33):
        args = (seq_cat, lens.astype(np.int64), qual_cat,
                qlens.astype(np.int64), 16, 32, 32)
        same_tiles(trd.ragged_to_payload_tiles(*args, qual_offset=offset),
                   jrd.ragged_to_payload_tiles(*args, qual_offset=offset))
    empty = (b"", np.zeros(0, np.int64), b"", np.zeros(0, np.int64), 8, 8, 8)
    same_tiles(trd.ragged_to_payload_tiles(*empty),
               jrd.ragged_to_payload_tiles(*empty))


def test_fragments_to_arrays_parity():
    frags = make_fragments(10, seed=9) + [jfq.SequencedFragment(
        sequence="RYacgt", quality="IIIIII")]
    for max_len in (16, 64):
        same_tiles(trd.fragments_to_arrays(frags, max_len),
                   jrd.fragments_to_arrays(frags, max_len))
    bases, _, lengths = trd.fragments_to_arrays(frags[:1], 64)
    assert (bases[0, int(lengths[0]):] == 5).all()
