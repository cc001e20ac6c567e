"""The port's VCF / BCF region queries against the JAX package's, on the
CPU: the variant cases of tests/test_query.py through both packages'
``QueryEngine`` on the same files and ``.tbi`` sidecars (the port's
engine on ``device="cpu"``, its rows through K13's ``overlap_step``),
each held to the full-scan oracle, and ``VcfDataset.query``.
"""
import random

import numpy as np
import pytest

from hadoop_bam_tpu.query import (
    QueryEngine as JQueryEngine, QueryRequest as JRequest,
)
from hadoop_bam_tpu.utils import errors as jerr
from hadoop_bam_torch.query import QueryEngine, QueryRequest
from hadoop_bam_torch.query.engine import overlap_step
from hadoop_bam_torch.utils import errors as terr

_REGIONS = ["chr20:1-30000", "chr20:40,000-60,000", "chr21", "chr21:1-10"]


def _write_vcf_records(path, n, seed, sv_every=0):
    from hadoop_bam_tpu.api.writers import open_vcf_writer
    from hadoop_bam_tpu.formats.vcf import VCFHeader, VcfRecord

    hdr_text = (
        "##fileformat=VCFv4.2\n"
        "##contig=<ID=chr20,length=64444167>\n"
        "##contig=<ID=chr21,length=46709983>\n"
        '##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">\n'
        '##INFO=<ID=END,Number=1,Type=Integer,Description="End">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="GT">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts0\ts1\n")
    header = VCFHeader.from_text(hdr_text)
    rng = random.Random(seed)
    gts = ["0/0", "0/1", "1/1", "./."]
    with open_vcf_writer(path, header) as w:
        for chrom in ("chr20", "chr21"):
            pos = 1
            for i in range(n // 2):
                pos += rng.randint(1, 60)
                ref = rng.choice("ACGT")
                alt = rng.choice([c for c in "ACGT" if c != ref])
                info = f"DP={i % 90}"
                if sv_every and i % sv_every == 3:
                    info += f";END={pos + rng.randint(50, 20000)}"
                g = "\t".join(rng.choice(gts) for _ in range(2))
                w.write_record(VcfRecord.from_line(
                    f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t{30 + i % 40}\t"
                    f"PASS\t{info}\tGT\t{g}"))
    return header


@pytest.fixture(scope="module")
def variant_files(tmp_path_factory):
    """test_query.py's two fixtures (indexed by the reference's
    ``write_tabix``) and two with INFO END= spans (indexed by the
    port's)."""
    from hadoop_bam_tpu.split.tabix import write_tabix as jwrite
    from hadoop_bam_torch.split.tabix import write_tabix as twrite
    d = tmp_path_factory.mktemp("tqvar")
    out = {}
    for name, seed, sv, write in (("q.vcf.gz", 21, 0, jwrite),
                                  ("q.bcf", 22, 0, jwrite),
                                  ("sv.vcf.gz", 23, 9, twrite),
                                  ("sv.bcf", 24, 9, twrite)):
        p = str(d / name)
        _write_vcf_records(p, 3000, seed=seed, sv_every=sv)
        write(p)
        out[name] = p
    return out


def _variant_oracle(path, region):
    from hadoop_bam_tpu.api.vcf_dataset import open_vcf
    from hadoop_bam_tpu.split.intervals import resolve_interval
    ds = open_vcf(path)
    iv = resolve_interval(region, ds.header.contigs)
    want = []
    for rec in ds.records():
        if rec.chrom != iv.rname:
            continue
        if rec.pos <= iv.end and rec.pos + max(rec.rlen, 1) - 1 >= iv.start:
            want.append(rec.to_line())
    return want


@pytest.mark.parametrize("name", ["q.vcf.gz", "q.bcf", "sv.vcf.gz",
                                  "sv.bcf"])
def test_variant_query_matches_full_scan_oracle(variant_files, name):
    path = variant_files[name]
    before = overlap_step.launches
    got = QueryEngine(device="cpu").query_records(
        [QueryRequest(path, r) for r in _REGIONS])
    want = JQueryEngine().query_records(
        [JRequest(path, r) for r in _REGIONS])
    assert overlap_step.launches > before
    for region, g, w in zip(_REGIONS, got, want):
        lines = [r.to_line() for r in g.records]
        assert lines == [r.to_line() for r in w.records], region
        assert lines == _variant_oracle(path, region), region
        assert g.n_candidates == w.n_candidates
    assert sum(len(r.records) for r in got) > 0


def test_variant_query_many_regions_in_one_batch(variant_files):
    """Both engines over a batch of random regions across both files
    (two files, coalesced chunks shared by overlapping requests)."""
    rng = random.Random(7)
    reqs = []
    for _ in range(60):
        name = rng.choice(["q.vcf.gz", "sv.bcf"])
        c = rng.choice(["chr20", "chr21"])
        b = rng.randint(1, 90000)
        e = b + rng.randint(1, 5000)
        reqs.append((variant_files[name], f"{c}:{b}-{e}"))
    got = QueryEngine(device="cpu").query_records(
        [QueryRequest(p, r) for p, r in reqs])
    want = JQueryEngine().query_records([JRequest(p, r) for p, r in reqs])
    assert [[r.to_line() for r in x.records] for x in got] == \
        [[r.to_line() for r in x.records] for x in want]
    assert sum(len(x.records) for x in got) > 0


def test_variant_tensor_batches_mask_counts(variant_files):
    from hadoop_bam_torch.api import query_regions
    path = variant_files["q.bcf"]
    eng = QueryEngine(device="cpu")
    n = sum(int(out["keep"].sum()) for out in
            query_regions(path, _REGIONS, engine=eng))
    want = sum(len(_variant_oracle(path, r)) for r in _REGIONS)
    assert n == want > 0


@pytest.mark.parametrize("name", ["x.vcf.gz", "x.bcf"])
def test_variant_query_without_tbi_is_plan_error(variant_files, tmp_path,
                                                 name):
    import shutil
    src = variant_files["q." + name.split(".", 1)[1]]
    p = str(tmp_path / name)
    shutil.copy(src, p)
    with pytest.raises(terr.PlanError, match="tbi"):
        QueryEngine(device="cpu").query_records([QueryRequest(p, "chr20")])
    with pytest.raises(jerr.PlanError, match="tbi"):
        JQueryEngine().query_records([JRequest(p, "chr20")])


def test_variant_query_unknown_contig_is_plan_error(variant_files):
    path = variant_files["q.vcf.gz"]
    with pytest.raises(terr.PlanError, match="dictionary"):
        QueryEngine(device="cpu").query_records(
            [QueryRequest(path, "chr9:1-10")])


# ---------------------------------------------------------------------------
# VcfDataset.query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("region", _REGIONS + ["chr20:5000-5001",
                                               "chr21:60000-90000"])
def test_vcf_dataset_query_equals_the_reference(variant_files, region):
    from hadoop_bam_tpu.api.vcf_dataset import open_vcf as jopen
    from hadoop_bam_torch.api.vcf_dataset import open_vcf
    for name in ("q.vcf.gz", "sv.vcf.gz"):
        path = variant_files[name]
        got = [r.to_line() for r in open_vcf(path, device="cpu")
               .query(region)]
        want = [r.to_line() for r in jopen(path).query(region)]
        assert got == want, (name, region)


def test_vcf_dataset_query_errors(variant_files, tmp_path):
    import shutil
    from hadoop_bam_torch.api.vcf_dataset import open_vcf
    with pytest.raises(terr.PlanError, match="BGZF"):
        next(open_vcf(variant_files["q.bcf"], device="cpu").query("chr20"))
    p = str(tmp_path / "nosidecar.vcf.gz")
    shutil.copy(variant_files["q.vcf.gz"], p)
    with pytest.raises(FileNotFoundError, match="tbi"):
        next(open_vcf(p, device="cpu").query("chr20"))
    assert np.all([r.chrom == "chr21" for r in open_vcf(
        variant_files["q.vcf.gz"], device="cpu").query("chr21:1-500")])
