"""The port's VCF / BCF formats, container sniffing, split guesser, span
planners and ``VcfDataset`` against the JAX package's, on the CPU.

The same seeded inputs (the reference's record fixtures of
tests/test_bcf_columns.py and tests/test_variant_pipeline.py, and the
port's 1000 Genomes-layout generator, ``synth.write_synthetic_vcf``) go
through both packages.  Bytes, integers, spans, records (compared as
text lines) and error classes must be equal."""
import gzip
import random
import struct

import numpy as np
import pytest

from hadoop_bam_tpu.api import dispatch as jdispatch
from hadoop_bam_tpu.api.vcf_dataset import open_vcf as jopen_vcf
from hadoop_bam_tpu.api.writers import open_vcf_writer
from hadoop_bam_tpu.formats import bcf as jbcf
from hadoop_bam_tpu.formats import bcf_columns as jcols
from hadoop_bam_tpu.formats import bcfio as jbcfio
from hadoop_bam_tpu.formats import vcf as jvcf
from hadoop_bam_tpu.split import vcf_planners as jplan
from hadoop_bam_tpu.split.bcf_guesser import BCFSplitGuesser as JGuesser
from hadoop_bam_torch import synth
from hadoop_bam_torch.api import dispatch as tdispatch
from hadoop_bam_torch.api.vcf_dataset import open_vcf
from hadoop_bam_torch.config import HBamConfig, ValidationStringency
from hadoop_bam_torch.formats import bcf as tbcf
from hadoop_bam_torch.formats import bcf_columns as tcols
from hadoop_bam_torch.formats import bcfio as tbcfio
from hadoop_bam_torch.formats import vcf as tvcf
from hadoop_bam_torch.split import vcf_planners as tplan
from hadoop_bam_torch.split.bcf_guesser import BCFSplitGuesser
from hadoop_bam_torch.utils.errors import PlanError

from test_bcf_columns import HDR, LINES, _wide_lines
from test_variant_pipeline import HEADER_TEXT, _make_records

def _encode(lines, header_text=HDR):
    """Reference-encoded BCF record bytes of ``lines`` and the records."""
    header = jvcf.VCFHeader.from_text(header_text)
    codec = jbcf.BCFRecordCodec(header)
    recs = [jvcf.VcfRecord.from_line(ln.rstrip("\t")) for ln in lines]
    return header, recs, b"".join(codec.encode(r) for r in recs)


def _write_all(tmp, header_text, recs):
    """The same records as text VCF, BGZF VCF, plain-gzip VCF, BGZF BCF
    and raw BCF (the reference's writers)."""
    header = jvcf.VCFHeader.from_text(header_text)
    text = header_text + "".join(r.to_line() + "\n" for r in recs)
    paths = {k: str(tmp / f"t.{k}") for k in ("vcf", "vcf.gz", "bcf")}
    paths["gzip"] = str(tmp / "plain.vcf.gz")
    paths["raw"] = str(tmp / "raw.bcf")
    with open(paths["vcf"], "w") as f:
        f.write(text)
    from hadoop_bam_tpu.formats import bgzf as jbgzf
    with open(paths["vcf.gz"], "wb") as f:
        f.write(jbgzf.compress_bytes(text.encode()))
    with open(paths["gzip"], "wb") as f:
        f.write(gzip.compress(text.encode()))
    with open_vcf_writer(paths["bcf"], header) as w:
        for r in recs:
            w.write_record(r)
    with open(paths["raw"], "wb") as f:
        jbcfio.write_bcf(f, header, recs, compress=False)
    return paths


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    recs = _make_records(2000, seed=9)
    return _write_all(tmp_path_factory.mktemp("tvcf"), HEADER_TEXT, recs)


@pytest.fixture(scope="module")
def kg(tmp_path_factory):
    """A small file of the generator's 1000 Genomes layout (300 samples,
    X records with haploid males) in all three of its containers."""
    d = tmp_path_factory.mktemp("tkg")
    paths = {"bcf": str(d / "kg.bcf"), "raw": str(d / "kg.raw.bcf"),
             "vcf.gz": str(d / "kg.vcf.gz")}
    truth = synth.write_synthetic_vcf(paths["bcf"], 4000, 7, n_samples=300,
                                      raw_path=paths["raw"],
                                      vcf_path=paths["vcf.gz"],
                                      vcf_records=1500)
    return paths, truth


# ---------------------------------------------------------------------------
# formats/vcf.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [HDR, HEADER_TEXT,
                                  synth.kg_header(7).to_text()])
def test_header_round_trip_and_dictionaries(text):
    t, j = tvcf.VCFHeader.from_text(text), jvcf.VCFHeader.from_text(text)
    assert t.to_text() == j.to_text() == text
    assert t.string_dictionary() == j.string_dictionary()
    assert (t.contigs, t.contig_lengths, t.samples) == \
        (j.contigs, j.contig_lengths, j.samples)
    for name in t.contigs + ["nope"]:
        assert t.contig_index(name) == j.contig_index(name)
    for kind in ("filters", "infos", "formats"):
        assert {k: (v.number, v.type, v.idx) for k, v in
                getattr(t, kind).items()} == \
            {k: (v.number, v.type, v.idx) for k, v in
             getattr(j, kind).items()}
    with pytest.raises(tvcf.VCFError):
        tvcf.VCFHeader.from_text("#CHROM\tPOS\n")


@pytest.mark.parametrize("line", LINES + _wide_lines() + [
    "c1\t5\t.\tA\t.\t.\t.\t.", "c2\t9\tx;y\tAC\tA,ACC\t0.125\tq10;s50\tDB"])
def test_record_round_trip(line):
    line = line.rstrip("\t")
    t, j = tvcf.VcfRecord.from_line(line), jvcf.VcfRecord.from_line(line)
    assert t.to_line() == j.to_line()
    assert (t.chrom, t.pos, t.id, t.ref, t.alts, t.qual, t.filters,
            t.info, t.fmt, t.genotypes, t.rlen, t.n_allele) == \
        (j.chrom, j.pos, j.id, j.ref, j.alts, j.qual, j.filters, j.info,
         j.fmt, j.genotypes, j.rlen, j.n_allele)
    assert tvcf.VcfRecord.from_line(t.to_line()).to_line() == t.to_line()


def test_record_too_few_fields_raises():
    with pytest.raises(tvcf.VCFError):
        tvcf.VcfRecord.from_line("c1\t5\t.")


@pytest.mark.parametrize("chunk", [1, 7, 1 << 16])
def test_read_vcf_header_text_like_the_reference(chunk):
    data = (HEADER_TEXT + "c1\t1\t.\tA\tC\t.\t.\t.\tGT\t0\t0\t0\t0\t0\n"
            ).encode()

    def reader(buf):
        return lambda off, size: buf[off:off + min(size, chunk)]
    for buf in (data, HEADER_TEXT.encode(), HEADER_TEXT.encode()[:-1]):
        th, toff = tvcf.read_vcf_header_text(reader(buf))
        jh, joff = jvcf.read_vcf_header_text(reader(buf))
        assert (th.to_text(), toff) == (jh.to_text(), joff)
    for head in (b"", b"#a\n", b"#a\n#b", b"#a\nx", b"x\n#y\n"):
        for eof in (False, True):
            assert tvcf._header_end(head, eof) == jvcf._header_end(head, eof)


def test_variant_batch_like_the_reference():
    text_lines = [ln.rstrip("\t") for ln in LINES + _wide_lines()]
    th, jh = tvcf.VCFHeader.from_text(HDR), jvcf.VCFHeader.from_text(HDR)
    t = tvcf.VariantBatch([tvcf.VcfRecord.from_line(x) for x in text_lines],
                          th)
    j = jvcf.VariantBatch([jvcf.VcfRecord.from_line(x) for x in text_lines],
                          jh)
    assert len(t) == len(j)
    for k in ("chrom", "pos", "rlen", "qual", "n_allele", "is_pass",
              "is_snp"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), k)
    np.testing.assert_array_equal(t.dosage_matrix(), j.dosage_matrix())


# ---------------------------------------------------------------------------
# formats/bcf.py, formats/bcf_columns.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lines", [LINES, _wide_lines(),
                                   LINES + _wide_lines()])
def test_codec_decode_and_scans_like_the_reference(lines):
    jh, _, buf = _encode(lines)
    th = tvcf.VCFHeader.from_text(HDR)
    tc, jc = tbcf.BCFRecordCodec(th), jbcf.BCFRecordCodec(jh)
    off = 0
    while off < len(buf):
        tr, toff = tc.decode(buf, off)
        jr, joff = jc.decode(buf, off)
        assert (tr.to_line(), toff) == (jr.to_line(), joff)
        assert tbcf.peek_record_sizes(buf, off) == \
            jbcf.peek_record_sizes(buf, off)
        off = toff
    for pad in (8, 16):
        t = tbcf.scan_variant_columns(buf, th, pad)
        j = jbcf.scan_variant_columns(buf, jh, pad)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], k)
            assert t[k].dtype == j[k].dtype
        tcol = tcols.decode_bcf_columns(buf, th, pad)
        jcol = jcols.decode_bcf_columns(buf, jh, pad)
        assert set(tcol) == set(jcol)
        for k in jcol:
            np.testing.assert_array_equal(tcol[k], jcol[k], k)
            assert tcol[k].dtype == jcol[k].dtype
        _meta_equal(tcols.decode_bcf_cursor_meta(buf, th, pad),
                    jcols.decode_bcf_cursor_meta(buf, jh, pad))
    np.testing.assert_array_equal(tcols.frame_record_starts(buf),
                                  jcols.frame_record_starts(buf))


def _meta_equal(t, j):
    if j is None:
        assert t is None
        return
    assert t["n"] == j["n"]
    np.testing.assert_array_equal(t["starts"], j["starts"])
    np.testing.assert_array_equal(t["flags"], j["flags"])
    assert len(t["gt_groups"]) == len(j["gt_groups"])
    for a, b in zip(t["gt_groups"], j["gt_groups"]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]


def test_typed_values_and_header_block_like_the_reference():
    jh, _, buf = _encode(LINES)
    th = tvcf.VCFHeader.from_text(HDR)
    block = tbcf.encode_header(th)
    assert block == jbcf.encode_header(jh)
    assert tbcf.decode_header(block)[1] == jbcf.decode_header(block)[1]
    assert tbcf.decode_header(block)[0].to_text() == th.to_text()
    with pytest.raises(tbcf.BCFError):
        tbcf.decode_header(b"BAM\x01" + block[4:])
    for vals in ([1, -5, None], [300, None], [1 << 20], []):
        enc = jbcf.encode_typed_ints(vals)
        assert tbcf.read_typed(enc, 0) == jbcf.read_typed(enc, 0)
        assert tbcf.skip_typed(enc, 0) == jbcf.skip_typed(enc, 0) == len(enc)
    for s in ("", "x", "a" * 40):
        enc = jbcf.encode_typed_string(s)
        assert tbcf.read_typed(enc, 0) == jbcf.read_typed(enc, 0)
    enc = jbcf.encode_typed_floats([0.5, None], pad_to=4)
    assert tbcf.read_typed(enc, 0) == jbcf.read_typed(enc, 0)
    with pytest.raises(tbcf.BCFError):
        tbcf.read_typed(bytes([0x14]), 0)


def test_plausible_record_start_like_the_reference():
    _, _, buf = _encode(LINES * 3)
    buf = buf + bytes(64)
    for off in range(0, len(buf) - 1):
        assert tbcf.plausible_record_start(buf, off, 2) == \
            jbcf.plausible_record_start(buf, off, 2), off


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 -- compared by class name
        return ("err", type(e).__name__)
    return ("ok", out)


def _cols_outcome_equal(t, j):
    assert t[0] == j[0], (t, j)
    if t[0] == "err":
        assert t[1] == j[1]
    elif j[1] is None:
        assert t[1] is None
    else:
        for k in j[1]:
            np.testing.assert_array_equal(t[1][k], j[1][k], k)


def test_truncation_and_corruption_raise_like_the_reference():
    jh, _, buf = _encode(LINES)
    th = tvcf.VCFHeader.from_text(HDR)
    bad = []
    for cut in (1, 7, 8, 31, len(buf) // 2, len(buf) - 1):
        bad.append(buf[:cut])
    b = bytearray(buf)
    struct.pack_into("<I", b, 0, 10)               # l_shared below 24
    bad.append(bytes(b))
    b = bytearray(buf)
    b[32] = (b[32] & 0xF0) | 0x0B                 # reserved type code
    bad.append(bytes(b))
    b = bytearray(buf)
    struct.pack_into("<I", b, 0, 1 << 20)          # overrun
    bad.append(bytes(b))
    for x in bad:
        for pad in (8,):
            _cols_outcome_equal(
                _outcome(lambda: tcols.decode_bcf_columns(x, th, pad)),
                _outcome(lambda: jcols.decode_bcf_columns(x, jh, pad)))
            t = _outcome(lambda: tcols.decode_bcf_cursor_meta(x, th, pad))
            j = _outcome(lambda: jcols.decode_bcf_cursor_meta(x, jh, pad))
            assert t[0] == j[0] and (t[0] == "ok" or t[1] == j[1])
    # columnar decode of corrupt input raises, never decodes loosely
    assert _outcome(lambda: tcols.decode_bcf_columns(
        buf[:len(buf) - 1], th, 8)) == ("err", "BCFError")


@pytest.mark.parametrize("seed", range(6))
def test_random_byte_flips_same_outcome(seed):
    """Byte-flip fuzz: both packages' columnar decode, cursor walk and
    record scan give the same columns or the same error class."""
    jh, _, buf = _encode(LINES * 2)
    th = tvcf.VCFHeader.from_text(HDR)
    rng = random.Random(seed)
    starts = jcols.frame_record_starts(buf)
    for _ in range(40):
        b = bytearray(buf)
        for _ in range(rng.randint(1, 3)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        x = bytes(b)
        _cols_outcome_equal(
            _outcome(lambda: tcols.decode_bcf_columns(x, th, 8, starts)),
            _outcome(lambda: jcols.decode_bcf_columns(x, jh, 8, starts)))
        t = _outcome(lambda: tcols.decode_bcf_cursor_meta(x, th, 8, starts))
        j = _outcome(lambda: jcols.decode_bcf_cursor_meta(x, jh, 8, starts))
        assert t[0] == j[0]
        if t[0] == "ok":
            _meta_equal(t[1], j[1])
        else:
            assert t[1] == j[1]


def test_columnar_guards_decline_like_the_reference():
    """GT ploidy past 256 and records with more samples than the tile
    are declined (None), never decoded."""
    jh, _, buf = _encode(LINES)
    th = tvcf.VCFHeader.from_text(HDR)
    assert tcols.decode_bcf_columns(buf, th, 2) is None
    assert jcols.decode_bcf_columns(buf, jh, 2) is None
    assert tcols.decode_bcf_cursor_meta(buf, th, 2) is None
    assert tcols._MAX_GT_PLOIDY == jcols._MAX_GT_PLOIDY == 256
    t = tcols.decode_bcf_columns(b"", th, 8)
    j = jcols.decode_bcf_columns(b"", jh, 8)
    assert {k: v.shape for k, v in t.items()} == \
        {k: v.shape for k, v in j.items()}


# ---------------------------------------------------------------------------
# formats/bcfio.py, api/dispatch.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bcf", "raw"])
def test_bcf_header_and_whole_read_like_the_reference(files, kind):
    p = files[kind]
    th, tv, tb = tbcfio.read_bcf_header(p)
    jh, jv, jb = jbcfio.read_bcf_header(p)
    assert (th.to_text(), tv, tb) == (jh.to_text(), jv, jb)
    assert tb == (kind == "bcf") == tbcfio.is_bgzf_bcf(open(p, "rb").read(
        1 << 16))
    th2, trecs = tbcfio.read_bcf(p)
    _, jrecs = jbcfio.read_bcf(p)
    assert [r.to_line() for r in trecs] == [r.to_line() for r in jrecs]
    assert len(trecs) == 2000


def test_sniff_containers_like_the_reference(files, tmp_path):
    import shutil
    cases = dict(files)
    for k in ("vcf", "vcf.gz", "gzip", "bcf", "raw"):
        odd = str(tmp_path / f"{k.replace('.', '_')}.data")
        shutil.copy(files[k], odd)
        cases[f"{k} by magic"] = odd
    for trust in (True, False):
        tdispatch.clear_sniff_caches()
        jdispatch.clear_sniff_caches()
        tcfg = HBamConfig(vcf_trust_exts=trust)
        import dataclasses
        from hadoop_bam_tpu.config import DEFAULT_CONFIG as JC
        jcfg = dataclasses.replace(JC, vcf_trust_exts=trust)
        for name, p in cases.items():
            t = tdispatch.sniff_vcf_container(p, tcfg).value
            assert t == jdispatch.sniff_vcf_container(p, jcfg).value, name
            assert tdispatch.sniff_vcf_container(p, tcfg).value == t
    bad = str(tmp_path / "x.data")
    with open(bad, "wb") as f:
        f.write(b"hello")
    assert _outcome(lambda: tdispatch.sniff_vcf_container(bad))[1] == \
        _outcome(lambda: jdispatch.sniff_vcf_container(bad))[1] == \
        "ValueError"
    tdispatch.clear_sniff_caches()
    jdispatch.clear_sniff_caches()


# ---------------------------------------------------------------------------
# split/bcf_guesser.py, split/vcf_planners.py
# ---------------------------------------------------------------------------

def _span_key(s):
    return (s.start_voffset, s.end_voffset) if hasattr(s, "start_voffset") \
        else (s.start, s.end)


@pytest.mark.parametrize("kind", ["bcf", "raw"])
def test_bcf_guesser_like_the_reference(files, kind):
    p = files[kind]
    th, _, is_bgzf = tbcfio.read_bcf_header(p)
    jh, _, _ = jbcfio.read_bcf_header(p)
    tg = BCFSplitGuesser(p, th, is_bgzf=is_bgzf)
    jg = JGuesser(p, jh, is_bgzf=is_bgzf)
    size = len(open(p, "rb").read())
    rng = random.Random(3)
    for off in [0, 1, size - 1, size] + rng.sample(range(size), 40):
        assert tg.guess_next_record_start(off) == \
            jg.guess_next_record_start(off), off


@pytest.mark.parametrize("kind", ["bcf", "raw"])
@pytest.mark.parametrize("n", [1, 2, 5, 13])
def test_bcf_spans_and_readers_like_the_reference(files, kind, n):
    p = files[kind]
    th, _, is_bgzf = tbcfio.read_bcf_header(p)
    jh, _, _ = jbcfio.read_bcf_header(p)
    ts = tplan.plan_bcf_spans(p, num_spans=n, header=th)
    js = jplan.plan_bcf_spans(p, num_spans=n, header=jh)
    assert [_span_key(s) for s in ts] == [_span_key(s) for s in js]
    total = 0
    for t, j in zip(ts, js):
        tr = tplan.read_bcf_span(p, t, th, is_bgzf)
        assert [r.to_line() for r in tr] == \
            [r.to_line() for r in jplan.read_bcf_span(p, j, jh, is_bgzf)]
        tb, tst = tplan.read_bcf_span_frames(p, t, is_bgzf)
        jb, jst = jplan.read_bcf_span_frames(p, j, is_bgzf)
        assert tb == jb
        np.testing.assert_array_equal(tst, jst)
        assert tplan.read_bcf_span_bytes(p, t) == tb
        total += len(tr)
    assert total == 2000


@pytest.mark.parametrize("n", [1, 3, 8, 40])
def test_bgzf_text_spans_and_reader_like_the_reference(files, n):
    p = files["vcf.gz"]
    ts = tplan.plan_bgzf_text_spans(p, num_spans=n)
    js = jplan.plan_bgzf_text_spans(p, num_spans=n)
    assert [_span_key(s) for s in ts] == [_span_key(s) for s in js]
    text = b"".join(tplan.read_bgzf_text_span(p, s) for s in ts)
    assert text == b"".join(jplan.read_bgzf_text_span(p, s) for s in js)
    whole = gzip.decompress(open(p, "rb").read())
    assert text == whole      # every line exactly once, header included


def test_kg_bcf_spans_like_the_reference(kg):
    """The generator's BCF (records wider than a BGZF block) plans and
    reads the same in both packages, every record once."""
    paths, truth = kg
    for kind in ("bcf", "raw"):
        p = paths[kind]
        th, _, is_bgzf = tbcfio.read_bcf_header(p)
        jh, _, _ = jbcfio.read_bcf_header(p)
        for n in (3, 11):
            ts = tplan.plan_bcf_spans(p, num_spans=n, header=th)
            assert [_span_key(s) for s in ts] == [
                _span_key(s) for s in jplan.plan_bcf_spans(
                    p, num_spans=n, header=jh)]
            total = sum(tplan.read_bcf_span_frames(p, s, is_bgzf)[1].size
                        for s in ts)
            assert total == truth.n_variants


# ---------------------------------------------------------------------------
# api/vcf_dataset.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vcf", "vcf.gz", "gzip", "bcf", "raw"])
def test_dataset_like_the_reference(files, kind):
    p = files[kind]
    t = open_vcf(p, device="cpu")
    j = jopen_vcf(p)
    assert t.container.value == j.container.value
    assert t.header.to_text() == j.header.to_text()
    assert t._is_bgzf_bcf == j._is_bgzf_bcf
    n = 4
    ts, js = t.spans(n), j.spans(n)
    assert [_span_key(s) for s in ts] == [_span_key(s) for s in js]
    with pytest.raises(ValueError):
        t.spans(n + 1)
    for s, u in zip(ts, js):
        assert t.read_span_text(s) == j.read_span_text(u)
    lines = [r.to_line() for r in t.records()]
    assert lines == [r.to_line() for r in j.records()]
    assert len(lines) == 2000
    tb = list(t.batches())
    jb = list(j.batches())
    assert [len(b) for b in tb] == [len(b) for b in jb]
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.dosage_matrix(), b.dosage_matrix())
        np.testing.assert_array_equal(a.pos, b.pos)


def test_dataset_state_dict_resumes(files):
    """Checkpoint after two spans, resume in a new dataset: the rest of
    the records, as the reference's dataset resumes."""
    for kind in ("vcf", "raw"):
        p = files[kind]
        t = open_vcf(p, device="cpu")
        j = jopen_vcf(p)
        t.spans(5)
        j.spans(5)
        it, jt = t.records(), j.records()
        first = 0
        while t._next_span < 2:
            next(it)
            next(jt)
            first += 1
        st = t.state_dict()
        js = j.state_dict()
        assert {k: st[k] for k in ("container", "plan", "next_span")} == \
            {k: js[k] for k in ("container", "plan", "next_span")}
        t2 = open_vcf(p, device="cpu")
        t2.load_state_dict(st)
        j2 = jopen_vcf(p)
        j2.load_state_dict(js)
        rest = [r.to_line() for r in t2.records()]
        assert rest == [r.to_line() for r in j2.records()]
        whole = [r.to_line() for r in open_vcf(p, device="cpu").records()]
        assert 0 < len(rest) < 2000 - first and rest == whole[-len(rest):]
        with pytest.raises(ValueError):
            open_vcf(files["vcf.gz"], device="cpu").load_state_dict(st)


def test_dataset_stringency_and_query(tmp_path):
    p = str(tmp_path / "bad.vcf")
    with open(p, "w") as f:
        f.write(HEADER_TEXT + "c1\t10\t.\tA\tC\t.\tPASS\n"
                "c1\t20\t.\tA\tC\t.\tPASS\t.\tGT\t0\t0\t0\t0\t1\n")
    lenient = open_vcf(p, device="cpu")
    assert [r.pos for r in lenient.records()] == \
        [r.pos for r in jopen_vcf(p).records()] == [20]
    strict = open_vcf(p, device="cpu", config=HBamConfig(
        validation_stringency="strict"))
    assert strict.config.validation_stringency is ValidationStringency.STRICT
    with pytest.raises(tvcf.VCFError):
        list(strict.records())
    with pytest.raises(PlanError):
        next(lenient.query("c1:1-100"))


def test_vcf_settings_carry_over_from_the_reference():
    """``config_from_dict`` takes the VCF fields from the reference's
    dict: ``vcf_trust_exts`` and ``validation_stringency`` (the
    reference's enum, by name)."""
    import dataclasses
    from hadoop_bam_tpu.config import DEFAULT_CONFIG as JC
    from hadoop_bam_tpu.config import ValidationStringency as JVS
    from hadoop_bam_torch.config import config_from_dict
    cfg = config_from_dict(dataclasses.asdict(JC))
    assert (cfg.vcf_trust_exts, cfg.validation_stringency) == \
        (True, ValidationStringency.SILENT)
    cfg = config_from_dict(dataclasses.asdict(dataclasses.replace(
        JC, vcf_trust_exts=False, validation_stringency=JVS.STRICT)))
    assert (cfg.vcf_trust_exts, cfg.validation_stringency) == \
        (False, ValidationStringency.STRICT)
    with pytest.raises(PlanError):
        HBamConfig(validation_stringency="sloppy")
