"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``torch_cuda``: they skip where no CUDA device is present
(the card's machine runs them with ``python -m pytest -m torch_cuda``)."""
import numpy as np
import pytest
import torch

from hadoop_bam_torch.ops import seq_stats as tss
from hadoop_bam_torch.ops import unpack_bam as tub

pytestmark = pytest.mark.torch_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1/K2 kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", [1, 255, 1000, 262_144])
def test_k1_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    d = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    offs = rng.integers(0, d.size, n).astype(np.int32)
    edge = np.array([d.size - 1, d.size - 20, -7], np.int32)[:n]
    offs[:edge.size] = edge          # end clamp and a negative offset
    dt, ot = torch.from_numpy(d).to(cuda), torch.from_numpy(offs).to(cuda)
    before = tub.unpack_fixed_fields.launches
    got = tub.unpack_fixed_fields(dt, ot)
    want = tub.unpack_fixed_fields_plain(dt, ot)
    torch.cuda.synchronize()
    assert tub.unpack_fixed_fields.launches == before + 1
    for name in tub.FIXED_FIELDS:
        assert torch.equal(got[name], want[name]), name


def _k2_random(n, sb, qb, seed):
    """Random bytes (all 16 codes), lengths from negative to past the
    row, with a full row, an empty one and odd ones first."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 256, (n, sb), dtype=np.uint8)
    qual = rng.integers(0, 256, (n, qb), dtype=np.uint8)
    lens = rng.integers(-2, 2 * sb + 9, n).astype(np.int32)
    lens[:4] = [2 * sb, 0, 1, qb + 1][:n]
    return [torch.from_numpy(a) for a in (seq, qual, lens)]


# (n, sb, qb, sliced): the default tile; n = 1; n off the 16 rows of a
# stage; odd widths; a base address off 16 bytes with odd widths
# (seq t[1:] of a [n + 1, 76] tile) and with 16-byte widths (lengths 4
# bytes off); the 2^24 geometry
@pytest.mark.parametrize("shape", [(65_536, 96, 160, False),
                                   (1, 96, 160, False),
                                   (1001, 96, 160, False),
                                   (65, 96, 160, False),
                                   (513, 76, 151, False),
                                   (100, 17, 33, False),
                                   (513, 76, 151, True),
                                   (1000, 96, 160, True),
                                   (2048, 8192, 16383, False),
                                   (300, 8192, 16384, False)])
def test_k2_kernel_matches_plain(cuda, shape):
    n, sb, qb, sliced = shape
    args = [t.to(cuda) for t in _k2_random(n, sb, qb, sb + n)]
    if sliced:   # rows 1..n of [n + 1, W] tiles
        args = [t.new_empty((n + 1,) + t.shape[1:])[1:].copy_(t)
                for t in args]
        assert all(t.is_contiguous() for t in args)
        assert args[2].data_ptr() % 16 != 0
    before = tss.seq_qual_stats.launches
    got = tss.seq_qual_stats(*args)
    want = tss.seq_qual_stats_plain(*args)
    torch.cuda.synchronize()
    assert tss.seq_qual_stats.launches == before + 1
    assert int(want["base_hist"].count_nonzero()) == 16
    for k in ("gc", "mean_qual", "base_hist"):
        assert torch.equal(got[k], want[k]), k


def test_k2_back_to_back_calls_reset_scratch(cuda):
    """Launches in a row on one stream give the same histogram: each
    bin's last arrival in a launch leaves its running sum at zero."""
    a = [t.to(cuda) for t in _k2_random(65_536, 96, 160, 1)]
    b = [t.to(cuda) for t in _k2_random(777, 76, 151, 2)]
    c = [t.to(cuda) for t in _k2_random(4096, 96, 160, 3)]
    want = [tss.seq_qual_stats_plain(*x)["base_hist"] for x in (a, b, c)]
    got = [tss.seq_qual_stats(*x)["base_hist"] for x in (a, a, b, c, a, c)]
    torch.cuda.synchronize()
    for g, w in zip(got, [want[0], want[0], want[1], want[2], want[0],
                          want[2]]):
        assert torch.equal(g, w)


def test_drivers_on_card_match_truth(cuda, tmp_path):
    """flagstat (tile and span mode) and seq-stats on the card equal the
    synthesizer's counts, and both kernels launched."""
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "s.bam")
    truth = write_synthetic_bam(path, 40_000, seed=2)
    k1, k2 = tub.unpack_fixed_fields.launches, tss.seq_qual_stats.launches
    for mode in ("tile", "span"):
        assert tp.flagstat_file(path, mode=mode) == truth.flagstat
    got = tp.seq_stats_file(path)
    assert got["n_reads"] == truth.n_reads
    assert np.array_equal(got["base_hist"], truth.base_hist)
    for k in ("mean_gc", "mean_qual"):
        assert abs(got[k] - getattr(truth, k)) <= 1e-6 * getattr(truth, k)
    assert tub.unpack_fixed_fields.launches > k1
    assert tss.seq_qual_stats.launches > k2
