"""The port's torch ops (tile unpack, flagstat reduction, seq/qual decode)
against the JAX reference on the same real span, on the CPU.  Integer
results must be equal; mean_base_quality is one f32 division of equal
int32 sums on both sides, so it must be equal too."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hadoop_bam_tpu.formats.bamio import BamWriter as JaxBamWriter
from hadoop_bam_tpu.ops import flagstat as jfs
from hadoop_bam_tpu.ops import seq_decode as jsd
from hadoop_bam_tpu.ops import unpack_bam as jub
from hadoop_bam_torch.formats.bam import SAMHeader
from hadoop_bam_torch.ops import flagstat as tfs
from hadoop_bam_torch.ops import inflate as tinflate
from hadoop_bam_torch.ops import seq_decode as tsd
from hadoop_bam_torch.ops import unpack_bam as tub

from fixtures import make_header, make_records


@pytest.fixture(scope="module")
def span(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("to") / "o.bam")
    header = make_header()
    records = make_records(header, 700, seed=21)
    for i, r in enumerate(records):      # every flagstat counter non-zero
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
    data, _ = tinflate.inflate_span(open(path, "rb").read())
    _, after = SAMHeader.from_bam_bytes(data.tobytes())
    offs, _ = tinflate.walk_records(data, after)
    d = tub.pad_data(data, 1 << 18)
    o, n = tub.pad_offsets(offs.astype(np.int32), 1024)
    return d, o, n


def test_projected_tile_unpack_matches_jax(span):
    d, o, n = span
    idx = o[:n, None].astype(np.int64) + np.arange(36)[None, :]
    tile = d[idx]
    for fields in (tub.ALL_FIELDS, tub.FLAGSTAT_PROJECTION,
                   ("l_seq", "tlen", "mapq")):
        ranges = tub.projection_ranges(fields)
        assert ranges == jub.projection_ranges(fields)
        rows = np.concatenate([tile[:, a:a + w] for a, w in ranges], axis=1)
        got = tub.unpack_projected_tile(torch.from_numpy(rows), fields)
        ref = jub.unpack_projected_tile(jnp.asarray(rows), fields)
        for name in fields:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(ref[name]), err_msg=name)


def test_flagstat_from_columns_matches_jax(span):
    d, o, n = span
    cols_t = tub.unpack_fixed_fields(torch.from_numpy(d), torch.from_numpy(o))
    cols_j = jub.unpack_fixed_fields(jnp.asarray(d), jnp.asarray(o))
    valid = np.arange(o.size) < n
    got = tfs.flagstat_from_columns(cols_t, torch.from_numpy(valid))
    ref = jfs.flagstat_from_columns(cols_j, jnp.asarray(valid))
    assert tuple(got) == jfs.FLAGSTAT_FIELDS == tfs.FLAGSTAT_FIELDS
    for k in tfs.FLAGSTAT_FIELDS:
        assert int(got[k]) == int(ref[k]), k
        assert int(got[k]) > 0, f"fixture leaves {k} at zero"


def _payload_offsets(d, o, n):
    cols = tub.unpack_fixed_fields(torch.from_numpy(d), torch.from_numpy(o))
    seq_off = (o.astype(np.int64) + 36 + cols["l_read_name"].numpy()
               + 4 * cols["n_cigar"].numpy()).astype(np.int32)
    l_seq = np.where(np.arange(o.size) < n, cols["l_seq"].numpy(), 0)
    qual_off = (seq_off + (l_seq + 1) // 2).astype(np.int32)
    return seq_off, qual_off, l_seq.astype(np.int32)


@pytest.mark.parametrize("max_len", [160, 64, 151])
def test_seq_qual_decode_matches_jax(span, max_len):
    d, o, n = span
    seq_off, qual_off, l_seq = _payload_offsets(d, o, n)
    args_t = [torch.from_numpy(x) for x in (d, seq_off, l_seq)]
    args_j = [jnp.asarray(x) for x in (d, seq_off, l_seq)]
    s_t = tsd.decode_seq(*args_t, max_len)
    s_j = jsd.decode_seq(*args_j, max_len)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    q_t = tsd.decode_qual(torch.from_numpy(d), torch.from_numpy(qual_off),
                          torch.from_numpy(l_seq), max_len)
    q_j = jsd.decode_qual(jnp.asarray(d), jnp.asarray(qual_off),
                          jnp.asarray(l_seq), max_len)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(tsd.base_composition(s_t).numpy(),
                                  np.asarray(jsd.base_composition(s_j)))
    assert float(tsd.mean_base_quality(q_t)) == \
        float(jsd.mean_base_quality(q_j))


def test_decode_clamps_like_jax():
    """Offsets at, past and before the buffer: the reference caps at
    D - 1 and counts negative indices from the end."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 256, 300, dtype=np.uint8)
    offs = np.array([0, 290, 299, 310, -4, -400], np.int32)
    lens = np.array([40, 40, 3, 9, 12, 5], np.int32)
    np.testing.assert_array_equal(
        tsd.decode_seq(torch.from_numpy(d), torch.from_numpy(offs),
                       torch.from_numpy(lens), 48).numpy(),
        np.asarray(jsd.decode_seq(jnp.asarray(d), jnp.asarray(offs),
                                  jnp.asarray(lens), 48)))
    np.testing.assert_array_equal(
        tsd.decode_qual(torch.from_numpy(d), torch.from_numpy(offs),
                        torch.from_numpy(lens), 48).numpy(),
        np.asarray(jsd.decode_qual(jnp.asarray(d), jnp.asarray(offs),
                                   jnp.asarray(lens), 48)))
