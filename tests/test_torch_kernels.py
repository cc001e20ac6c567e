"""K1 and K2 of the PyTorch port against the JAX reference, on the CPU.

On CPU tensors the port's wrappers run their kernels' plain PyTorch
versions; these tests hold those (the kernels' semantics) against the
reference's jnp functions and its Pallas kernels in interpret mode.
Tolerance: 0 everywhere — the columns are integers, the histogram is an
integer, and gc / mean_qual are one f32 division of exact integer sums
on both sides.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hadoop_bam_tpu.formats.bamio import BamWriter as JaxBamWriter
from hadoop_bam_tpu.ops import seq_pallas as jsp
from hadoop_bam_tpu.ops import unpack_bam as jub
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.ops import inflate as tinflate
from hadoop_bam_torch.ops import seq_stats as tss
from hadoop_bam_torch.ops import unpack_bam as tub

from fixtures import make_header, make_records

D_CAP, N_CAP = 1 << 18, 1024


@pytest.fixture(scope="module")
def span(tmp_path_factory):
    """A real inflated span (500 records, unmapped ones included) and its
    record offsets, decoded by the port's native plane."""
    path = str(tmp_path_factory.mktemp("tk") / "k.bam")
    header = make_header()
    with JaxBamWriter(path, header) as w:
        for r in make_records(header, 500, seed=9):
            w.write_sam_record(r)
    raw = open(path, "rb").read()
    data, _ = tinflate.inflate_span(raw, backend="native")
    _, after = SAMHeader.from_bam_bytes(data.tobytes())
    offs, _ = tinflate.walk_records(data, after, "native")
    return data, offs.astype(np.int32)


def _k1_inputs(data, offs, case):
    dev_data = tub.pad_data(data, D_CAP)
    dev_offs, _ = tub.pad_offsets(offs, N_CAP)
    if case == "end_clamp":
        dev_offs[-3:] = [D_CAP - 20, D_CAP - 1, D_CAP - 35]
    elif case == "negative_offsets":
        dev_offs[-2:] = [-5, -50]
    return dev_data, dev_offs


@pytest.mark.parametrize("case", ["span", "end_clamp", "negative_offsets"])
def test_k1_plain_matches_jax(span, case):
    data, offs = span
    dev_data, dev_offs = _k1_inputs(data, offs, case)
    got = tub.unpack_fixed_fields(torch.from_numpy(dev_data),
                                  torch.from_numpy(dev_offs))
    ref = jub.unpack_fixed_fields(jnp.asarray(dev_data), jnp.asarray(dev_offs))
    refs = [ref]
    if case != "negative_offsets":
        # the Pallas kernel itself, interpreted (tests/test_ops.py:52)
        refs.append(jub.unpack_fixed_fields_pallas(
            jnp.asarray(dev_data), jnp.asarray(dev_offs), block_n=256))
    for name in tub.FIXED_FIELDS:
        assert got[name].dtype == torch.int32
        for r in refs:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(r[name]),
                                          err_msg=f"{case} column {name}")


def test_k1_real_span_has_negative_fields(span):
    """The span fixture covers the sign rules: -1 refid/pos (unmapped)
    and negative tlen stay negative; padding rows read offset 0."""
    data, offs = span
    got = tub.unpack_fixed_fields(torch.from_numpy(tub.pad_data(data, D_CAP)),
                                  torch.from_numpy(tub.pad_offsets(
                                      offs, N_CAP)[0]))
    n = offs.size
    assert (got["refid"][:n] == -1).any()
    assert (got["pos"][:n] == -1).any()
    assert (got["tlen"][:n] < 0).any()
    assert (got["block_size"][n:] == got["block_size"][n]).all()


def test_k1_cpu_runs_plain_and_counts_no_launch(span):
    data, offs = span
    before = tub.unpack_fixed_fields.launches
    d, o = torch.from_numpy(data), torch.from_numpy(offs)
    got = tub.unpack_fixed_fields(d, o)
    want = tub.unpack_fixed_fields_plain(d, o)
    for name in tub.FIXED_FIELDS:
        assert torch.equal(got[name], want[name])
    assert tub.unpack_fixed_fields.launches == before


@pytest.mark.parametrize("bad", ["data_dtype", "offs_dtype", "data_2d",
                                 "empty_data", "strided"])
def test_k1_wrapper_rejects_bad_arguments(bad):
    data = torch.zeros(64, dtype=torch.uint8)
    offs = torch.zeros(4, dtype=torch.int32)
    if bad == "data_dtype":
        data = data.to(torch.int32)
    elif bad == "offs_dtype":
        offs = offs.to(torch.int64)
    elif bad == "data_2d":
        data = data.reshape(8, 8)
    elif bad == "empty_data":
        data = data[:0]
    elif bad == "strided":
        offs = torch.zeros(8, dtype=torch.int32)[::2]
    with pytest.raises(ValueError):
        tub.unpack_fixed_fields(data, offs)


def _k2_inputs(seed, n=512, sb=76, qb=151):
    """Random packed rows with odd lengths, empty rows, lengths past what
    the row holds and negative lengths."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 256, (n, sb), dtype=np.uint8)
    qual = rng.integers(0, 42, (n, qb), dtype=np.uint8)
    qual[rng.random((n, qb)) < 0.01] = 0xFF
    lens = rng.integers(0, 2 * sb + 1, n).astype(np.int32)
    lens[:8] = [0, 1, 3, 151, 2 * sb + 9, qb + 7, -3, 2 * sb]
    return seq, qual, lens


def _assert_k2_equal(got, ref):
    for k in ("gc", "mean_qual"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["base_hist"].numpy(),
                                  np.asarray(ref["base_hist"]))


@pytest.mark.parametrize("force_pallas", [False, True])
def test_k2_plain_matches_jax(force_pallas):
    seq, qual, lens = _k2_inputs(5)
    got = tss.seq_qual_stats(torch.from_numpy(seq), torch.from_numpy(qual),
                             torch.from_numpy(lens))
    ref = jsp.seq_qual_stats(jnp.asarray(seq), jnp.asarray(qual),
                             jnp.asarray(lens), block_n=256, interpret=True,
                             force_pallas=force_pallas)
    assert got["gc"].dtype == torch.float32
    assert got["base_hist"].dtype == torch.int32
    _assert_k2_equal(got, ref)


def test_k2_plain_matches_host_oracle():
    seq, qual, lens = _k2_inputs(6, n=300, sb=80, qb=160)
    got = tss.seq_qual_stats(torch.from_numpy(seq), torch.from_numpy(qual),
                             torch.from_numpy(lens))
    host = tss.seq_qual_stats_host(seq, qual, lens)
    # lengths past the row: the oracle slices what the row holds but
    # divides by len, exactly as the kernel does
    _assert_k2_equal(got, host)


def test_k2_base_hist_exact_past_2_24():
    """tests/test_seq_pallas.py:101's case on the plain path: the int32
    histogram stays exact past 2^24 bases (odd total)."""
    n, L = 2048, 16383
    seq = np.full((n, (L + 1) // 2), 0x11, np.uint8)
    qual = np.full((n, L), 40, np.uint8)
    lengths = np.full(n, L, np.int32)
    lengths[0] = L - 1
    got = tss.seq_qual_stats(torch.from_numpy(seq), torch.from_numpy(qual),
                             torch.from_numpy(lengths))
    total = int(lengths.astype(np.int64).sum())
    assert total > (1 << 24) and total % 2 == 1
    assert int(got["base_hist"][1]) == total
    assert int(got["base_hist"].sum()) == total
    ref = jsp.seq_qual_stats(jnp.asarray(seq), jnp.asarray(qual),
                             jnp.asarray(lengths), block_n=256,
                             interpret=True)
    _assert_k2_equal(got, ref)


def test_k2_empty_tile():
    got = tss.seq_qual_stats(torch.zeros((0, 96), dtype=torch.uint8),
                             torch.zeros((0, 160), dtype=torch.uint8),
                             torch.zeros(0, dtype=torch.int32))
    assert got["gc"].shape == (0,)
    assert int(got["base_hist"].sum()) == 0


@pytest.mark.parametrize("bad", ["seq_dtype", "len_dtype", "rows",
                                 "strided"])
def test_k2_wrapper_rejects_bad_arguments(bad):
    seq = torch.zeros((8, 96), dtype=torch.uint8)
    qual = torch.zeros((8, 160), dtype=torch.uint8)
    lens = torch.zeros(8, dtype=torch.int32)
    if bad == "seq_dtype":
        seq = seq.to(torch.int16)
    elif bad == "len_dtype":
        lens = lens.to(torch.int64)
    elif bad == "rows":
        qual = qual[:7]
    elif bad == "strided":
        seq = torch.zeros((8, 192), dtype=torch.uint8)[:, ::2]
    with pytest.raises(ValueError):
        tss.seq_qual_stats(seq, qual, lens)


@pytest.mark.parametrize("shape", [(65_536, 96, 160), (1, 96, 160),
                                   (1001, 96, 160), (513, 76, 151),
                                   (100, 17, 33), (2048, 8192, 16383),
                                   (2048, 8192, 16384), (7, 16, 16)])
def test_k2_launch_covers_every_row_once(shape):
    """The tiles cover rows 0..n-1 exactly once, every warp of the
    persistent grid owns at least one tile, and the launch stays inside
    what the C entry point accepts."""
    n, sb, qb = shape
    go = tss.k2_launch(n, sb, qb, (0, 0, 0), sms=132)
    assert 1 <= go.rows <= tss.MAX_ROWS
    assert (go.tiles - 1) * go.rows < n <= go.tiles * go.rows
    assert 1 <= go.warps <= tss.BLOCK_WARPS
    assert 1 <= go.grid <= tss.BLOCKS_PER_SM * 132 and go.grid < 1 << 16
    assert (go.grid - 1) * go.warps < go.tiles


@pytest.mark.parametrize("widths", [(96, 160), (16, 16), (48, 80),
                                    (8192, 16384), (16384, 32768),
                                    (32768, 65536), (8192, 16383),
                                    (1, 1)])
def test_k2_launch_stage_fits_shared_memory(widths):
    """A stage holds at least one row and about STAGE_BYTES of payload,
    and a block's rings fit its shared memory (the 16383-wide row
    included); rows too wide for one warp's ring take the direct path."""
    sb, qb = widths
    go = tss.k2_launch(4096, sb, qb, (0, 0, 0), sms=132)
    assert go.rows >= 1
    assert go.rows == 1 or go.rows * (sb + qb) <= tss.STAGE_BYTES
    assert go.smem == go.warps * go.warp_bytes <= tss.SMEM_BLOCK_MAX
    per_sm = -(-go.grid // 132)
    assert per_sm * (go.smem + tss.SMEM_RESERVED) <= tss.SMEM_SM
    if go.aligned:
        # the count buffer, then the stages, none overlapping: a stage is
        # the tile's seq rows, qual rows and lengths, 128-byte aligned
        assert go.pitch % 2 == 1 and go.pitch >= sb // 16 + qb // 16
        assert go.rows * go.pitch * 4 <= go.stage_off
        assert go.rows * (sb + qb + 4) <= go.stage_bytes
        assert go.stage_off % 128 == 0 and go.stage_bytes % 128 == 0
        assert go.stage_off + tss.STAGES * go.stage_bytes <= go.warp_bytes
    else:
        assert go.warp_bytes == 2 * 4 * go.rows
    if go.rows >= 4:
        assert go.rows % 4 == 0
    wide = (sb, qb) == (32768, 65536)
    assert go.aligned == (sb % 16 == 0 and qb % 16 == 0 and not wide)


@pytest.mark.parametrize("case", ["seq_ptr", "qual_ptr", "len_ptr",
                                  "odd_seq", "odd_qual", "aligned"])
def test_k2_launch_selects_path(case):
    """A base address off 16 bytes or an odd width selects the direct
    path; 16-byte strides and addresses select the TMA rings."""
    sb, qb, ptrs = 96, 160, [1 << 20, 2 << 20, 3 << 20]
    if case == "seq_ptr":
        ptrs[0] += 96 + 76       # a row slice t[1:] of a [n + 1, 76] tile
    elif case == "qual_ptr":
        ptrs[1] += 4
    elif case == "len_ptr":
        ptrs[2] += 4
    elif case == "odd_seq":
        sb = 76
    elif case == "odd_qual":
        qb = 151
    go = tss.k2_launch(65_536, sb, qb, tuple(ptrs), sms=132)
    assert go.aligned == (case == "aligned")
    assert go.smem == go.warps * go.warp_bytes <= tss.SMEM_BLOCK_MAX


def test_unpack_bases_matches_jax():
    seq, _, _ = _k2_inputs(7, n=16, sb=33)
    got = tss.unpack_bases(torch.from_numpy(seq), max_len=61)
    ref = jsp.unpack_bases(jnp.asarray(seq), max_len=61)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
