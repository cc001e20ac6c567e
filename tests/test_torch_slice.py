"""Slice 1 end to end on the CPU: the port's BAM flagstat and seq-stats
drivers and its entry step against the JAX package's, on the same files
and settings (configs and geometries carried over with config_from_dict /
geometry_from_dict).

Tolerances: flagstat counters, n_reads, base_hist and every packed byte
are equal; mean_gc / mean_qual agree within rtol 1e-6 because the
reference adds per-tile f32 sums and the port f64 sums, in other orders.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from hadoop_bam_tpu.formats.bamio import BamWriter as JaxBamWriter
from hadoop_bam_tpu.parallel import pipeline as jp
from hadoop_bam_tpu.split.planners import plan_bam_spans as jax_plan
from hadoop_bam_torch.api import open_bam
from hadoop_bam_torch.config import config_from_dict, geometry_from_dict
from hadoop_bam_torch.parallel import pipeline as tp
from hadoop_bam_torch.split.planners import plan_bam_spans
from hadoop_bam_torch.synth import write_synthetic_bam

from fixtures import make_header, make_records

SPAN_GEOM = jp.DecodeGeometry(bytes_cap=1 << 21, records_cap=1 << 14)
PAYLOAD_GEOM = jp.PayloadGeometry(max_len=160, tile_records=1 << 10,
                                  block_n=256)


@pytest.fixture(scope="module")
def bam(tmp_path_factory):
    """tests/test_pipeline.py's fixture shape (5000 records, 3 contigs)
    with a FLAG mix that makes every flagstat counter non-zero."""
    path = str(tmp_path_factory.mktemp("ts") / "p.bam")
    header = make_header()
    records = make_records(header, 5000, seed=11)
    for i, r in enumerate(records):
        if r.flag & 0x1:
            r.flag |= (0x100 if i % 13 == 0 else 0) | \
                (0x800 if i % 17 == 0 else 0) | (0x8 if i % 19 == 0 else 0)
            if i % 23 == 0:
                r.rnext = "chr1" if r.rname != "chr1" else "chr2"
                r.pnext = 100
        r.flag |= 0x400 if i % 7 == 0 else 0
    with JaxBamWriter(path, header) as w:
        for r in records:
            w.write_sam_record(r)
    return path


def _configs(backend):
    jcfg = dataclasses.replace(JAX_CONFIG, inflate_backend=backend)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("mode", ["tile", "span"])
@pytest.mark.parametrize("backend", ["native", "zlib"])
def test_flagstat_file_matches_jax(bam, backend, mode):
    jcfg, tcfg = _configs(backend)
    ref = jp.flagstat_file(bam, config=jcfg)
    geom = geometry_from_dict(dataclasses.asdict(SPAN_GEOM))
    got = tp.flagstat_file(bam, device="cpu", config=tcfg, geometry=geom,
                           mode=mode)
    assert got == ref
    assert all(v > 0 for v in got.values()), got


def test_flagstat_file_check_crc(bam):
    jcfg = dataclasses.replace(JAX_CONFIG, check_crc=True)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.check_crc
    assert tp.flagstat_file(bam, device="cpu", config=tcfg) == \
        jp.flagstat_file(bam, config=jcfg)


@pytest.mark.parametrize("backend", ["native", "zlib"])
def test_seq_stats_file_matches_jax(bam, backend):
    jcfg, tcfg = _configs(backend)
    ref = jp.seq_stats_file(bam, config=jcfg, geometry=PAYLOAD_GEOM)
    got = tp.seq_stats_file(
        bam, device="cpu", config=tcfg,
        geometry=geometry_from_dict(dataclasses.asdict(PAYLOAD_GEOM)))
    assert got["n_reads"] == ref["n_reads"] == 5000
    np.testing.assert_array_equal(got["base_hist"],
                                  np.asarray(ref["base_hist"]))
    for k in ("mean_gc", "mean_qual"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


def test_dataset_surface_matches_drivers(bam):
    ds = open_bam(bam, device="cpu")
    assert ds.device == torch.device("cpu")
    assert ds.flagstat() == tp.flagstat_file(bam, device="cpu")
    a, b = ds.seq_stats(), tp.seq_stats_file(bam, device="cpu")
    assert a["n_reads"] == b["n_reads"] and a["mean_gc"] == b["mean_gc"]


@pytest.mark.parametrize("backend", ["native", "zlib"])
def test_span_decoders_match_jax(bam, backend):
    """Per span: the packed prefix rows, payload tiles, span bytes and
    record voffsets equal the reference's host decoders'."""
    jcfg, _ = _configs(backend)
    g = PAYLOAD_GEOM
    tg = geometry_from_dict(dataclasses.asdict(g))
    spans = plan_bam_spans(bam, num_spans=5)
    for s_t, s_j in zip(spans, jax_plan(bam, num_spans=5)):
        rows_t, v_t = tp.decode_span_prefix_host(bam, s_t, backend=backend)
        rows_j, v_j = jp.decode_span_prefix_host(bam, s_j, config=jcfg,
                                                 inflate_backend=backend)
        np.testing.assert_array_equal(rows_t, rows_j)
        np.testing.assert_array_equal(v_t, v_j)
        pay_t = tp.decode_span_payload_host(bam, s_t, tg, backend=backend)
        pay_j = jp.decode_span_payload_host(bam, s_j, g, config=jcfg,
                                            inflate_backend=backend)
        for a, b in zip(pay_t[:3], pay_j[:3]):
            np.testing.assert_array_equal(a, b)
        d_t, o_t, _ = tp.decode_span_host(bam, s_t, SPAN_GEOM,
                                          backend=backend)
        d_j, o_j, n_j, _ = jp.decode_span_host(bam, s_j, SPAN_GEOM,
                                               config=jcfg,
                                               inflate_backend=backend)
        assert o_t.size == n_j
        np.testing.assert_array_equal(o_t, o_j[:n_j])
        np.testing.assert_array_equal(d_t, d_j[:d_t.size])


def test_span_geometry_overflow_raises_plan_error(bam):
    from hadoop_bam_torch.utils.errors import PlanError
    tiny = tp.DecodeGeometry(bytes_cap=1 << 12, records_cap=1 << 14)
    with pytest.raises(PlanError):
        tp.flagstat_file(bam, device="cpu", geometry=tiny, mode="span",
                         spans=plan_bam_spans(bam, num_spans=1))


def test_entry_step_matches_graft_entry():
    """The port's entry step on __graft_entry__._example_span()'s arrays
    equals the reference's jitted step (flagstat + base composition)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    try:
        import __graft_entry__ as graft
    finally:
        sys.path.remove(root)
    from hadoop_bam_torch.entry import forward_step
    fn, (data, offs, n) = graft.entry()
    ref_stats, ref_comp = fn(data, offs, n)
    stats, comp = forward_step(torch.from_numpy(np.asarray(data)),
                               torch.from_numpy(np.asarray(offs)), int(n))
    assert {k: int(v) for k, v in stats.items()} == \
        {k: int(v) for k, v in ref_stats.items()}
    np.testing.assert_array_equal(comp.numpy(), np.asarray(ref_comp))
    assert int(comp.sum()) > 0


def test_synthetic_bam_matches_its_truth(tmp_path):
    """The port's writer + synthesizer: both packages' flagstat equal the
    generator's counts, and the port's seq-stats equal its sums."""
    path = str(tmp_path / "synth.bam")
    truth = write_synthetic_bam(path, 6000, seed=5, chunk_pairs=1024)
    assert all(v > 0 for v in truth.flagstat.values()), truth.flagstat
    for mode in ("tile", "span"):
        assert tp.flagstat_file(path, device="cpu", mode=mode) == \
            truth.flagstat
    assert jp.flagstat_file(path) == truth.flagstat
    got = tp.seq_stats_file(path, device="cpu")
    assert got["n_reads"] == truth.n_reads
    np.testing.assert_array_equal(got["base_hist"], truth.base_hist)
    for k in ("mean_gc", "mean_qual"):
        np.testing.assert_allclose(got[k], getattr(truth, k), rtol=1e-9)
