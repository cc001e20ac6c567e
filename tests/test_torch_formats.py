"""The PyTorch port's own copies of the reference's host modules, on the
CPU: span plans, header read, BGZF read/write and the error classes a
corrupt input raises, each held against the JAX package."""
import dataclasses
import zlib

import numpy as np
import pytest

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats import bgzf as jax_bgzf
from hadoop_bam_tpu.formats.bamio import BamWriter as JaxBamWriter
from hadoop_bam_tpu.formats.bamio import read_bam_header as jax_header
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.split.planners import plan_bam_spans as jax_plan
from hadoop_bam_torch import config as tconfig
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.formats.bamio import BamWriter, read_bam_header
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.split.planners import plan_bam_spans

from fixtures import make_header, make_records


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("th") / "h.bam")
    header = make_header()
    with JaxBamWriter(path, header) as w:
        for r in make_records(header, 3000, seed=2):
            w.write_sam_record(r)
    return path


@pytest.mark.parametrize("num_spans", [1, 3, 8])
def test_plan_bam_spans_matches_jax(bam, num_spans):
    got = plan_bam_spans(bam, num_spans=num_spans)
    ref = jax_plan(bam, num_spans=num_spans)
    assert [(s.path, s.start_voffset, s.end_voffset) for s in got] == \
        [(s.path, s.start_voffset, s.end_voffset) for s in ref]
    assert [s.start for s in got] == [s.start for s in ref]


@pytest.fixture(scope="module")
def fine_bam(tmp_path_factory):
    """A synthetic BAM of ~60 full BGZF blocks: fine-grained plans guess
    boundaries with several blocks of inspection window ahead."""
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path_factory.mktemp("tf") / "fine.bam")
    write_synthetic_bam(path, 20000, seed=6, chunk_pairs=2048)
    return path


@pytest.mark.parametrize("num_spans", [7, 25, 60])
def test_fine_plans_match_jax(fine_bam, num_spans):
    """Boundary guesses that inflate only the blocks the block check
    already inflated (and the rest when a check reaches their end) give
    the reference's plan, streamed or listed."""
    from hadoop_bam_torch.split.planners import iter_bam_spans
    ref = [(s.start_voffset, s.end_voffset)
           for s in jax_plan(fine_bam, num_spans=num_spans)]
    got = plan_bam_spans(fine_bam, num_spans=num_spans)
    assert [(s.start_voffset, s.end_voffset) for s in got] == ref
    assert [(s.start_voffset, s.end_voffset) for s in
            iter_bam_spans(fine_bam, num_spans=num_spans)] == ref
    assert len(ref) > num_spans // 2


def test_read_bam_header_matches_jax(bam):
    h, v = read_bam_header(bam)
    hj, vj = jax_header(bam)
    assert (h.text, h.ref_names, h.ref_lengths, v) == \
        (hj.text, hj.ref_names, hj.ref_lengths, vj)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — the class is the result
        return ("raised", type(e).__name__,
                tuple(c.__name__ for c in type(e).__mro__
                      if c.__module__ == "builtins"))


def _corrupt_cases(raw):
    blocks = jax_bgzf.scan_blocks(raw)
    cases = {}
    for bi in (1, len(blocks) - 2):
        b = blocks[bi]
        for frac in (0.1, 0.5, 0.9):
            bad = bytearray(raw)
            bad[b.cdata_offset + int(b.cdata_size * frac)] ^= 0x5A
            cases[f"flip{bi}@{frac}"] = bytes(bad)
    cases["truncated@0.6"] = raw[:int(len(raw) * 0.6)]
    cases["truncated@0.999"] = raw[:len(raw) - 3]
    return cases


@pytest.mark.parametrize("check_crc", [False, True])
@pytest.mark.parametrize("backend", ["native", "zlib"])
def test_corrupt_input_error_class_matches_jax(bam, tmp_path, backend,
                                               check_crc):
    """A byte flip inside a BGZF block, and a truncated file: the same
    outcome in both packages — the same error class (and builtin bases),
    or equal counters where the flip leaves a valid stream."""
    raw = open(bam, "rb").read()
    jcfg = dataclasses.replace(JAX_CONFIG, inflate_backend=backend,
                               check_crc=check_crc)
    tcfg = tconfig.config_from_dict(dataclasses.asdict(jcfg))
    raised = 0
    for name, blob in _corrupt_cases(raw).items():
        path = str(tmp_path / f"{name}.bam")
        with open(path, "wb") as f:
            f.write(blob)
        ref = _outcome(lambda: jp.flagstat_file(path, config=jcfg))
        got = _outcome(lambda: tp.flagstat_file(path, device="cpu",
                                                config=tcfg))
        assert got == ref, name
        raised += ref[0] == "raised"
    assert raised >= 4


def test_bgzf_parse_errors():
    with pytest.raises(bgzf.BGZFError):
        bgzf.parse_block_header(b"not a bgzf block at all.....")
    with pytest.raises(bgzf.BGZFError):
        bgzf.parse_block_header(bgzf.EOF_BLOCK[:20])
    assert isinstance(bgzf.BGZFError("x"), ValueError)


def test_bgzf_writer_round_trip(tmp_path):
    """The port's writer (native deflate, several blocks per call, and
    stored blocks for incompressible payload) produces BGZF that the
    reference reads back byte for byte."""
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 4, 4_500_000, dtype=np.uint8).tobytes() + \
        bytes(70_000) + rng.integers(0, 256, 200_000,
                                     dtype=np.uint8).tobytes()
    path = str(tmp_path / "w.bgz")
    with open(path, "wb") as f:
        w = bgzf.BGZFWriter(f)
        for i in range(0, len(payload), 400_000):
            w.write(payload[i:i + 400_000])
        w.close()
    blob = open(path, "rb").read()
    assert blob.endswith(bgzf.EOF_BLOCK)
    assert jax_bgzf.decompress_bytes(blob) == payload
    sizes = [b.isize for b in bgzf.scan_blocks(blob)]
    assert all(s == bgzf.WRITE_PAYLOAD_SIZE for s in sizes[:-2])


def test_bam_writer_output_reads_in_jax(tmp_path):
    header = SAMHeader.from_sam_text("@HD\tVN:1.6\n@SQ\tSN:c1\tLN:1000\n")
    rec = (np.arange(40, dtype=np.uint8)).tobytes()
    path = str(tmp_path / "hdr.bam")
    with BamWriter(path, header) as w:
        w.write_raw(rec, 0)
    h, _ = jax_header(path)
    assert (h.ref_names, h.ref_lengths) == (["c1"], [1000])


def test_crc_verification_matches_zlib(bam):
    """verify_crcs on both planes accepts the file and names a corrupted
    block's CRC."""
    from hadoop_bam_torch.ops import inflate as tinf
    raw = open(bam, "rb").read()
    table = tinf.block_table(raw)
    for backend in ("native", "zlib"):
        data, ubase = tinf.inflate_span(raw, table, backend=backend)
        tinf.verify_crcs(raw, table, data, ubase, backend)
        bad = data.copy()
        bad[int(ubase[1]) + 5] ^= 1
        with pytest.raises(bgzf.BGZFError, match=r"\[1\]"):
            tinf.verify_crcs(raw, table, bad, ubase, backend)
    assert zlib.crc32(data[:10]) >= 0
