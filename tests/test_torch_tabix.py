"""The port's index writers against the JAX package's, on the CPU: the
``.tbi`` that ``build_tabix`` / ``build_bcf_tabix`` / ``write_tabix``
write, the ``.bai`` of ``BAIBuilder`` (and ``bai_from_columns``), and the
chunks ``TabixIndex.query`` resolves, each compared byte for byte or
exactly with the reference's on the same files.
"""
import random

import numpy as np
import pytest

from hadoop_bam_tpu.split import bai as jbai
from hadoop_bam_tpu.split import tabix as jtabix
from hadoop_bam_torch.split import bai as tbai
from hadoop_bam_torch.split import tabix as ttabix

_HDR = (
    "##fileformat=VCFv4.2\n"
    "##contig=<ID=chr20,length=64444167>\n"
    "##contig=<ID=chr21,length=46709983>\n"
    '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End">\n'
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\ts1\n")


def _write_variants(path, n, seed, *, sv_every=0, wide=0):
    """``n`` sorted records on chr20 and chr21 through the reference's
    writer (the container follows the extension); every ``sv_every``-th
    record carries an INFO END= past its REF, and ``wide`` extra samples
    stretch each line over BGZF blocks."""
    from hadoop_bam_tpu.api.writers import open_vcf_writer
    from hadoop_bam_tpu.formats.vcf import VCFHeader, VcfRecord
    hdr = _HDR
    if wide:
        hdr = hdr.rstrip("\n") + "".join(f"\tw{i}" for i in range(wide)) \
            + "\n"
    header = VCFHeader.from_text(hdr)
    rng = random.Random(seed)
    gts = ["0/0", "0/1", "1/1", "./."]
    k = 0
    with open_vcf_writer(path, header) as w:
        for chrom in ("chr20", "chr21"):
            pos = 1
            for i in range(n // 2):
                pos += rng.randint(1, 60)
                ref = "".join(rng.choice("ACGT")
                              for _ in range(rng.choice([1, 1, 1, 3])))
                alt = rng.choice([c for c in "ACGT" if c != ref[0]])
                info = f"DP={i % 90}"
                k += 1
                if sv_every and k % sv_every == 0:
                    info += f";END={pos + rng.randint(100, 40000)}"
                g = "\t".join(rng.choice(gts) for _ in range(2 + wide))
                w.write_record(VcfRecord.from_line(
                    f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t{30 + i % 40}\t"
                    f"PASS\t{info}\tGT\t{g}"))
    return header


_CASES = {
    "vcf.gz": dict(n=3000, seed=21),
    "bcf": dict(n=3000, seed=22),
    "sv.vcf.gz": dict(n=2000, seed=23, sv_every=7),
    "sv.bcf": dict(n=2000, seed=24, sv_every=5),
    "wide.vcf.gz": dict(n=400, seed=25, wide=4000),
    "wide.bcf": dict(n=400, seed=26, wide=4000),
}


@pytest.fixture(scope="module")
def variant_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ttabix")
    out = {}
    for name, kw in _CASES.items():
        p = str(d / f"q.{name}")
        _write_variants(p, **kw)
        out[name] = p
    return out


@pytest.mark.parametrize("name", sorted(_CASES))
def test_tabix_bytes_equal_the_reference(variant_files, name):
    path = variant_files[name]
    if name.endswith("bcf"):
        got, want = ttabix.build_bcf_tabix(path), jtabix.build_bcf_tabix(path)
    else:
        got, want = ttabix.build_tabix(path), jtabix.build_tabix(path)
    assert got.to_bytes() == want.to_bytes()
    assert sum(len(r.bins) for r in got.refs) > 0


@pytest.mark.parametrize("name", ["vcf.gz", "sv.bcf"])
def test_write_tabix_file_equals_the_reference(variant_files, name,
                                               tmp_path):
    path = variant_files[name]
    a = ttabix.write_tabix(path, str(tmp_path / "port.tbi"))
    b = jtabix.write_tabix(path, str(tmp_path / "ref.tbi"))
    assert open(a, "rb").read() == open(b, "rb").read()
    idx = ttabix.TabixIndex.from_bytes(open(a, "rb").read())
    assert idx.to_bytes() == open(a, "rb").read()


def test_load_tabix_for(variant_files, tmp_path):
    import shutil
    p = str(tmp_path / "x.vcf.gz")
    shutil.copy(variant_files["vcf.gz"], p)
    assert ttabix.load_tabix_for(p) is None
    ttabix.write_tabix(p)
    got = ttabix.load_tabix_for(p)
    want = jtabix.load_tabix_for(p)
    assert got.names == want.names
    assert [r.bins for r in got.refs] == [r.bins for r in want.refs]


_REGIONS = [("chr20", 0, 30000), ("chr20", 39999, 60000), ("chr21", 0, 1),
            ("chr21", 0, 1 << 29), ("chr20", 123456, 123457),
            ("chrX", 0, 1000)]


@pytest.mark.parametrize("name", ["vcf.gz", "sv.bcf", "wide.vcf.gz"])
def test_tabix_query_chunks_equal_the_reference(variant_files, name):
    path = variant_files[name]
    build_t = ttabix.build_bcf_tabix if name.endswith("bcf") \
        else ttabix.build_tabix
    build_j = jtabix.build_bcf_tabix if name.endswith("bcf") \
        else jtabix.build_tabix
    t, j = build_t(path), build_j(path)
    rng = random.Random(5)
    regions = list(_REGIONS) + [
        (c, b, b + rng.randint(1, 200000))
        for c, b in ((rng.choice(["chr20", "chr21"]),
                      rng.randint(0, 100000)) for _ in range(40))]
    hits = 0
    for rname, beg, end in regions:
        got = t.query(rname, beg, end)
        assert got == j.query(rname, beg, end), (rname, beg, end)
        hits += len(got)
    assert hits > 0


def test_tabix_text_builder_stops_at_an_empty_line(tmp_path):
    """An empty line ends the reference's build; the port stops there
    too, with the same closing offset."""
    from hadoop_bam_tpu.formats import bgzf as jbgzf
    body = _HDR + "".join(f"chr20\t{100 + 10 * i}\t.\tA\tC\t.\tPASS\t.\tGT"
                          f"\t0/1\t1/1\n" for i in range(50))
    body += "\n" + "chr21\t5\t.\tA\tC\t.\tPASS\t.\tGT\t0/1\t1/1\n"
    p = tmp_path / "gap.vcf.gz"
    p.write_bytes(jbgzf.compress_bytes(body.encode()))
    assert ttabix.build_tabix(str(p)).to_bytes() == \
        jtabix.build_tabix(str(p)).to_bytes()


def test_raw_bcf_tabix_raises_plan_error(tmp_path):
    from hadoop_bam_tpu.formats.bcfio import BcfWriter
    from hadoop_bam_tpu.formats.vcf import VCFHeader, VcfRecord
    from hadoop_bam_torch.utils.errors import PlanError
    p = str(tmp_path / "raw.bcf")
    header = VCFHeader.from_text(_HDR)
    with BcfWriter(p, header, compress=False) as w:
        w.write_record(VcfRecord.from_line(
            "chr20\t5\t.\tA\tC\t.\tPASS\t.\tGT\t0/1\t1/1"))
    with pytest.raises(PlanError, match="raw"):
        ttabix.build_bcf_tabix(p)


# ---------------------------------------------------------------------------
# BAIBuilder
# ---------------------------------------------------------------------------

def _bai_rows(n, seed):
    """Coordinate-sorted (rid, beg, end, voffset) rows with unmapped
    records last, spans crossing 16 KiB windows and bin levels, and runs
    sharing a bin."""
    rng = np.random.default_rng(seed)
    n_map = n - n // 10
    rid = np.sort(rng.integers(0, 3, n_map))
    beg = np.concatenate([np.sort(rng.integers(0, 3_000_000,
                                               int((rid == r).sum())))
                          for r in range(3)])
    length = np.where(rng.random(n_map) < 0.05,
                      rng.integers(10_000, 600_000, n_map),
                      rng.integers(1, 300, n_map))
    rid = np.concatenate([rid, np.full(n - n_map, -1)])
    beg = np.concatenate([beg, np.full(n - n_map, -1)])
    end = np.concatenate([beg[:n_map] + length, np.zeros(n - n_map, int)])
    u = np.cumsum(rng.integers(40, 400, n))
    voffs = ((u // 60000 * 21000).astype(np.uint64) << np.uint64(16)) \
        | (u % 60000).astype(np.uint64)
    return rid, beg, end, voffs


@pytest.mark.parametrize("n,seed", [(1, 0), (700, 1), (5000, 2)])
def test_bai_builder_bytes_equal_the_reference_and_columns(n, seed):
    rid, beg, end, voffs = _bai_rows(n, seed)
    end_v = (int(voffs.max()) >> 16 << 16) + (1 << 32)
    tb, jb = tbai.BAIBuilder(3), jbai.BAIBuilder(3)
    for r, b, e, v in zip(rid.tolist(), beg.tolist(), end.tolist(),
                          voffs.tolist()):
        tb.add(r, b, e, v)
        jb.add(r, b, e, v)
    got = tb.finalize(end_v).to_bytes()
    assert got == jb.finalize(end_v).to_bytes()
    assert got == tbai.bai_from_columns(3, rid, beg, end, voffs,
                                        end_v).to_bytes()
