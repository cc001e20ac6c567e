"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``torch_cuda``: they skip where no CUDA device is present
(the card's machine runs them with ``python -m pytest -m torch_cuda``)."""
import numpy as np
import pytest
import torch

from hadoop_bam_torch import synth
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
                                   (300, 8192, 16384, False),
                                   (65_536, 512, 1024, False),
                                   (4097, 512, 1024, True)])
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


def test_k2_fasta_windows_on_card_match_plain(cuda, tmp_path):
    """FASTA windows (max_len = window = 1024: strides 512 and 1024, the
    quality rows zero) straight from window_tensor_batches on the card:
    K2 equals its plain version on every batch."""
    from hadoop_bam_torch.api import open_fasta
    from hadoop_bam_torch.synth import window_count, write_synthetic_fasta
    path = str(tmp_path / "w.fa")
    contigs = write_synthetic_fasta(path, 1, (("a", 300_000),
                                              ("b", 250_123)))
    n = 0
    for b in open_fasta(path).window_tensor_batches(window=1024):
        assert b["seq_packed"].device == cuda
        assert b["seq_packed"].shape[2:] == (512,)
        assert b["qual"].shape[2:] == (1024,)
        n += int(b["n_records"][0])
        args = (b["seq_packed"][0], b["qual"][0], b["lengths"][0])
        before = tss.seq_qual_stats.launches
        got = tss.seq_qual_stats(*args)
        want = tss.seq_qual_stats_plain(*args)
        torch.cuda.synchronize()
        assert tss.seq_qual_stats.launches == before + 1
        for k in ("gc", "mean_qual", "base_hist"):
            assert torch.equal(got[k], want[k]), k
    assert n == sum(window_count(k, 1024) for k in contigs.values())


def test_unpack_step_on_card_matches_plain(cuda, tmp_path):
    """unpack_step over a stacked span group on the card: one K1 launch,
    the 12 columns of K1's plain version, valid = the first n rows."""
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split.planners import plan_bam_spans
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "u.bam")
    write_synthetic_bam(path, 40_000, seed=4)
    g = tp.DecodeGeometry(bytes_cap=1 << 22, records_cap=1 << 16)
    group = next(tp.iter_span_groups(plan_bam_spans(path, num_spans=4), 1))
    batch = tp.stack_span_group(path, group, 1, g)
    d, o, c = (torch.from_numpy(a).to(cuda) for a in
               (batch.data, batch.offsets, batch.n_records))
    before = tub.unpack_fixed_fields.launches
    cols = tp.unpack_step(d, o, c)
    want = tub.unpack_fixed_fields_plain(d[0], o[0])
    torch.cuda.synchronize()
    assert tub.unpack_fixed_fields.launches == before + 1
    n = int(batch.n_records[0])
    assert n > 0
    for name in tub.FIXED_FIELDS:
        assert cols[name].shape == (1, g.records_cap)
        assert torch.equal(cols[name][0], want[name]), name
    assert cols["valid"][0, :n].all() and not cols["valid"][0, n:].any()


def test_read_formats_on_card_match_truth(cuda, tmp_path):
    """fastq_seq_stats_file over a FASTQ and a gzipped QSEQ written from a
    BAM's reads, and the BAM's tensor_batches through read_stats_step,
    on the card: the generator's counts, through K2."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.synth import (
        write_synthetic_bam, write_synthetic_reads,
    )
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    qs = str(tmp_path / "r.qseq.gz")
    truth = write_synthetic_bam(bam, 40_000, seed=6)
    write_synthetic_reads(fq, 40_000, 6)
    q_truth = write_synthetic_reads(qs, 40_000, 6, fmt="qseq", limit=9_000,
                                    compress=True)
    before = tss.seq_qual_stats.launches
    for p, t in ((fq, truth), (qs, q_truth)):
        got = tp.fastq_seq_stats_file(p)
        assert got["n_reads"] == t.n_reads
        assert np.array_equal(got["base_hist"], t.base_hist)
        for k in ("mean_gc", "mean_qual"):
            assert abs(got[k] - getattr(t, k)) <= 1e-6 * getattr(t, k)
    totals, rows = tp._StatTotals(), 0
    for b in open_bam(bam).tensor_batches():
        assert b["prefix"].device == cuda
        cols = tub.unpack_fixed_fields_tile(b["prefix"][0])
        lengths = torch.clamp(cols["l_seq"], max=160).to(torch.int32)
        totals.add(*tp.read_stats_step(b["seq_packed"][0], b["qual"][0],
                                       lengths, b["n_records"][0]))
        rows += int(b["n_records"][0])
    got = tp._payload_stats_result(totals)
    assert rows == got["n_reads"] == truth.n_reads
    assert np.array_equal(got["base_hist"], truth.base_hist)
    assert tss.seq_qual_stats.launches > before


# ---------------------------------------------------------------------------
# the device decode plane's kernels (K7+K8, K9, K10p)
# ---------------------------------------------------------------------------

def _token_chunk(payloads, P, B=None, level=6):
    """Raw-DEFLATE ``payloads``, tokenize them natively at width P and
    pad to B rows (n_tokens = isize = 0): (tokens, n_tokens, isize)."""
    import zlib
    from hadoop_bam_torch.utils import native
    comps = []
    for d in payloads:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comps.append(co.compress(d) + co.flush())
    src = np.frombuffer(b"".join(comps), np.uint8)
    off = np.cumsum([0] + [len(c) for c in comps[:-1]]).astype(np.int64)
    ln = np.array([len(c) for c in comps], np.int32)
    toks, nt, ol = native.deflate_tokenize_batch(src, off, ln, P)
    assert [int(x) for x in ol] == [len(d) for d in payloads]
    B = B or len(payloads)
    tok = np.zeros((B, P), np.uint32)
    tok[:len(payloads)] = toks
    n = np.zeros(B, np.int32)
    n[:len(payloads)] = nt
    iz = np.zeros(B, np.int32)
    iz[:len(payloads)] = ol
    return tok, n, iz


def _payloads(n, size, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            d = rng.choice(np.frombuffer(b"ACGT", np.uint8), size)
        elif kind == 1:
            d = rng.choice(np.frombuffer(b"FF:,#IIII", np.uint8), size)
        elif kind == 2:
            d = np.full(size, ord("A"), np.uint8)      # dist-1 chains
        else:
            d = rng.integers(0, 256, size, dtype=np.uint8)
        out.append(d[:max(1, size - 37 * i)].tobytes())
    return out


def _straddle_rows(P, S):
    """Token rows whose copies straddle segment boundaries (S bytes) and
    end exactly on one, with 258-byte copies, and a row whose tokens end
    before its size (the tail takes the last token): (tokens, n_tokens,
    isize, bytes)."""
    rows = []
    for edge in (S, 2 * S, P - S):
        toks, data = [], bytearray()
        for i in range(edge - 3):
            toks.append(97 + i % 26)
            data.append(97 + i % 26)
        for length, dist in ((10, 7), (258, 1), (3, 3)):   # straddles
            toks.append((1 << 31) | (length << 16) | (dist - 1))
            for _ in range(length):
                data.append(data[-dist])
        while len(data) % S != S - 6:
            toks.append(65 + len(data) % 7)
            data.append(65 + len(data) % 7)
        toks.append((1 << 31) | (6 << 16) | (200 - 1))     # ends on S
        for _ in range(6):
            data.append(data[-200])
        while len(data) + 258 <= P:
            toks.append((1 << 31) | (258 << 16) | (S + 5 - 1))
            for _ in range(258):
                data.append(data[-(S + 5)])
        rows.append((toks, bytes(data)))
    toks, data = rows[-1]
    rows.append((toks[:len(toks) // 2], None))   # tail: the last copy on
    B = 8
    tok = np.zeros((B, P), np.uint32)
    nt = np.zeros(B, np.int32)
    iz = np.zeros(B, np.int32)
    for i, (t, d) in enumerate(rows):
        tok[i, :len(t)] = t
        nt[i] = len(t)
        iz[i] = len(d) if d is not None else P - 100
    return tok, nt, iz, [d for _, d in rows]


def _k7_case(name, tmp_path):
    """(tokens [B, T] u32, n_tokens, isize, P, the rows' bytes or None
    where only the plain version knows them) of one K7+K8 card case."""
    if name.startswith("P"):
        P, n, B = (int(x) for x in name[1:].split("/"))
        payloads = _payloads(n, P, P + n)
        return (*_token_chunk(payloads, P, B), P, payloads)
    P = 1 << 16
    if name == "main path":
        # the BAM's first 17 blocks in 32 rows, tokens only as wide as
        # the longest row rounded up to 256, as _TokenRing.stage ships
        import zlib
        from hadoop_bam_torch.formats import bgzf
        from hadoop_bam_torch.synth import write_synthetic_bam
        path = str(tmp_path / "k7.bam")
        write_synthetic_bam(path, 20_000, seed=6)
        raw = open(path, "rb").read()
        payloads, off = [], 0
        while len(payloads) < 17:
            info = bgzf.parse_block_header(raw, off)
            payloads.append(zlib.decompress(raw[
                info.cdata_offset:info.cdata_offset + info.cdata_size],
                wbits=-15))
            off = info.next_coffset
        tok, nt, iz = _token_chunk(payloads, P, 32)
        T = -(-int(nt.max()) // 256) * 256
        assert T < P
        return np.ascontiguousarray(tok[:, :T]), nt, iz, P, payloads
    if name == "258-byte copies":
        rng = np.random.default_rng(11)
        unit = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
        payloads = [b"A" * P, (unit * 66)[:P], (unit[:300] * 219)[:P - 3]]
        return (*_token_chunk(payloads, P, 8), P, payloads)
    from hadoop_bam_torch.ops import inflate_device as tid
    tok, nt, iz, rows = _straddle_rows(P, tid.resolve_launch(8, P, P).S)
    return tok, nt, iz, P, rows


@pytest.mark.parametrize("name", ["P65536/64/64", "P65536/5/8",
                                  "P8192/13/16", "P1024/3/8", "main path",
                                  "straddling segments", "258-byte copies"])
def test_k7_resolve_pack_matches_plain_and_zlib(cuda, tmp_path, name):
    """K7+K8 against its plain version and zlib's bytes, twice in a row;
    pad rows hold uninitialised tokens, as on the device plane."""
    from hadoop_bam_torch.ops import inflate_device as tid
    tok, nt, iz, P, payloads = _k7_case(name, tmp_path)
    used = int(np.count_nonzero(iz))
    tokens = torch.empty(tok.shape, dtype=torch.int32, device=cuda)
    tokens[:used] = torch.from_numpy(tok[:used].view(np.int32)).to(cuda)
    args = [tokens, torch.from_numpy(nt).to(cuda),
            torch.from_numpy(iz).to(cuda)]
    want, want_total = tid.pack_contiguous_plain(
        tid.resolve_tokens_plain(args[0], args[1], P), args[2])
    for _ in range(2):
        before = tid.resolve_pack.launches
        buf, total = tid.resolve_pack(*args, P=P)
        torch.cuda.synchronize()
        assert tid.resolve_pack.launches == before + 1
        assert int(total) == int(want_total) == int(iz.clip(0, P).sum())
        assert torch.equal(buf, want)
        got = buf.cpu().numpy()
        assert not got[int(total):].any()
        at = 0
        for d, size in zip(payloads, iz[:len(payloads)]):
            if d is not None:
                assert got[at:at + size].tobytes() == d
            at += int(size)


def _walk_buffer(tmp_path, n_reads=6000):
    """Inflated bytes of a synthetic BAM, from its first record."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.ops.inflate import inflate_span
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "w.bam")
    write_synthetic_bam(path, n_reads, seed=3)
    data, _ = inflate_span(open(path, "rb").read())
    _, voff = read_bam_header(path)
    return data[voff & 0xFFFF:]


def _walk_cases(data):
    """(name, buf, total, start, stop, R) covering the walk's rules."""
    L = 1 << 20
    buf = np.zeros(L, np.uint8)
    buf[:min(L, data.size)] = data[:L]
    total = int(min(L, data.size))
    cases = [("full", buf, total, 0, L, 8192),
             ("cut tail", buf, 700_001, 0, L, 8192),
             ("stop mid", buf, total, 0, 400_000, 8192),
             ("start past L", buf, total, L + 9, L, 64),
             ("n_all over R", buf, total, 0, L, 16)]
    second = 4 + int(buf[:4].view("<i4")[0])
    third = second + 4 + int(buf[second:second + 4].view("<i4")[0])
    bad = buf.copy()
    bad[third:third + 4] = np.frombuffer(np.int32(5).tobytes(), np.uint8)
    cases.append(("bs < 32", bad, total, 0, L, 8192))
    big = buf.copy()
    big[0:4] = np.frombuffer(np.int32(L + 1).tobytes(), np.uint8)
    cases.append(("bs > L", big, total, 0, L, 8192))
    return cases


def test_k9_walk_matches_plain(cuda, tmp_path):
    """The BAM cases and the tiled walk's edge cases at the kernel's tile
    width (``synth.walk_cases``), each twice in a row (scratch reuse)."""
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.synth import walk_cases
    for name, buf, total, start, stop, R in (
            _walk_cases(_walk_buffer(tmp_path)) + walk_cases(tid.WALK_W)):
        b = torch.from_numpy(buf).to(cuda)
        want = tid.walk_records_device_plain(b, total, start, stop, R)
        for _ in range(2):
            before = tid.walk_records_device.launches
            got = tid.walk_records_device(b, total, start, stop, R)
            torch.cuda.synchronize()
            assert tid.walk_records_device.launches == before + 1
            assert torch.equal(got[0], want[0]), name
            assert ([int(x) for x in got[1:]]
                    == [int(x) for x in want[1:]]), name


def test_k10p_payload_gather_matches_plain(cuda):
    from hadoop_bam_torch.ops import inflate_device as tid
    rng = np.random.default_rng(5)
    L, R = 1 << 20, 4096
    buf = torch.from_numpy(rng.integers(0, 256, L, dtype=np.uint8)).to(cuda)
    offs = rng.integers(-50, L + 50, R).astype(np.int32)
    l_seq = rng.integers(-3, 400, R).astype(np.int32)
    l_seq[:3] = [2**31 - 1, 0, 161]
    rn = rng.integers(0, 256, R).astype(np.int32)
    nc = rng.integers(0, 70_000, R).astype(np.int32)
    cols = [torch.from_numpy(a).to(cuda) for a in (offs, l_seq, rn, nc)]
    for n_all in (0, 1000, R + 7):
        for strides in ((96, 160), (17, 33)):
            before = tid.payload_gather.launches
            got = tid.payload_gather(buf, *cols, n_all, 160, *strides)
            want = tid.payload_gather_plain(buf, *cols, n_all, 160, *strides)
            torch.cuda.synchronize()
            assert tid.payload_gather.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w), (n_all, strides)


def _k10p_main_chunk(tmp_path):
    """The main path's usual chunk: a synthetic BAM's first 17 BGZF blocks
    packed into a [32 x 65,536] buffer, the walk's offsets at R =
    records_cap(32, 65,536) = 65,536 rows and K1's columns there (plain
    versions, on the host)."""
    import zlib
    from hadoop_bam_torch.formats import bgzf
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "k10p.bam")
    write_synthetic_bam(path, 20_000, seed=6)
    raw = open(path, "rb").read()
    data, off = [], 0
    for _ in range(17):
        info = bgzf.parse_block_header(raw, off)
        data.append(zlib.decompress(raw[
            info.cdata_offset:info.cdata_offset + info.cdata_size],
            wbits=-15))
        off = info.next_coffset
    flat = np.frombuffer(b"".join(data), np.uint8)
    buf = np.zeros(32 << 16, np.uint8)
    buf[:flat.size] = flat
    _, voff = read_bam_header(path)
    R = tid.records_cap(32, 1 << 16)
    b = torch.from_numpy(buf)
    offs, n_all, _, _ = tid.walk_records_device_plain(
        b, flat.size, voff & 0xFFFF, flat.size, R)
    cols = tub.unpack_fixed_fields_plain(b, offs)
    return (buf, offs.numpy(), cols["l_seq"].numpy(),
            cols["l_read_name"].numpy(), cols["n_cigar"].numpy()), int(n_all)


def _k10p_case(name, tmp_path):
    """(buf, offs, l_seq, l_read_name, n_cigar as numpy, n_all, the
    offset of buf in the tensor the kernel is handed) of one K10p card
    case."""
    from hadoop_bam_torch.synth import payload_rows
    L, R = 1 << 16, 8192
    if name.startswith("n_all"):
        n_all = {"-1": -1, "0": 0, "1": 1, "R": R, "R + 7": R + 7}[name[6:]]
        return payload_rows("random", L, R, 3), n_all, 0
    if name == "buf[3:]":
        # windows at both ends of a view whose address is 3 off 16 bytes
        lo = payload_rows("window at byte 0", L, R // 2, 4)
        hi = payload_rows("window at byte L - 1", L, R // 2, 4)
        return ((lo[0],) + tuple(np.concatenate([a, b])
                                 for a, b in zip(lo[1:], hi[1:])), R, 3)
    if name == "17-block chunk":
        rows, n_all = _k10p_main_chunk(tmp_path)
        return rows, n_all, 0
    return payload_rows(name, L, R, 5), R - 5, 0


@pytest.mark.parametrize("strides", [(96, 160), (17, 33)])
@pytest.mark.parametrize("name", ["n_all -1", "n_all 0", "n_all 1",
                                  "n_all R", "n_all R + 7", "buf[3:]",
                                  "window at byte 0", "window at byte L - 1",
                                  "l_seq above max_len", "int32 wrap",
                                  "17-block chunk"])
def test_k10p_payload_gather_cases(cuda, tmp_path, name, strides):
    """K10p's edge rules with the allocator poisoned before the launch
    (an unwritten byte reads 0xAB) and n_all a device int32: bit-equal
    to plain, one launch."""
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.synth import poison_allocator
    (buf, *cols), n_all, shift = _k10p_case(name, tmp_path)
    held = torch.empty(buf.size + shift, dtype=torch.uint8, device=cuda)
    b = held[shift:]
    b.copy_(torch.from_numpy(buf))
    assert b.data_ptr() % 16 == shift
    cols = [torch.from_numpy(a).to(cuda) for a in cols]
    nv = torch.tensor([n_all], dtype=torch.int32, device=cuda)
    poison_allocator(cuda)
    before = tid.payload_gather.launches
    got = tid.payload_gather(b, *cols, nv, 160, *strides)
    torch.cuda.synchronize()
    assert tid.payload_gather.launches == before + 1
    want = tid.payload_gather_plain(b, *cols, nv, 160, *strides)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (name, strides)


def test_device_plane_drivers_on_card_match_truth(cuda, tmp_path):
    """flagstat and seq-stats through the device decode plane on the card
    equal the synthesizer's counts, with every kernel of the path
    launched."""
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "d.bam")
    truth = write_synthetic_bam(path, 40_000, seed=4)
    cfg = HBamConfig(inflate_backend="device")
    wrappers = (tid.resolve_pack, tid.walk_records_device, tid.payload_gather,
                tub.unpack_fixed_fields, tss.seq_qual_stats)
    before = [w.launches for w in wrappers]
    assert tp.flagstat_file(path, config=cfg) == truth.flagstat
    got = tp.seq_stats_file(path, config=cfg)
    assert got["n_reads"] == truth.n_reads
    assert np.array_equal(got["base_hist"], truth.base_hist)
    for k in ("mean_gc", "mean_qual"):
        assert abs(got[k] - getattr(truth, k)) <= 1e-6 * getattr(truth, k)
    assert all(w.launches > b for w, b in zip(wrappers, before))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 10 on the card, at a small size
# ---------------------------------------------------------------------------

REGIONS = ("chr20:1-13000000", "chr21")


@pytest.fixture
def phase10(cuda, tmp_path):
    """A 40,000-read synthetic BAM with its whole-file and interval
    truths, and pristine breakers, chaos points and counters."""
    from hadoop_bam_torch import resilience
    from hadoop_bam_torch.synth import write_synthetic_bam
    from hadoop_bam_torch.utils.metrics import METRICS
    resilience.reset()
    resilience.chaos.clear_fault_points()
    METRICS.reset()
    path = str(tmp_path / "p10.bam")
    yield path, write_synthetic_bam(path, 40_000, seed=5, regions=REGIONS)
    resilience.reset()
    resilience.chaos.clear_fault_points()


def _check_truth(flag, stats, truth):
    assert flag == truth.flagstat
    assert stats["n_reads"] == truth.n_reads
    assert np.array_equal(stats["base_hist"], truth.base_hist)
    for k in ("mean_gc", "mean_qual"):
        assert abs(stats[k] - getattr(truth, k)) <= \
            1e-6 * abs(getattr(truth, k))


@pytest.mark.parametrize("backend", ["native", "device"])
@pytest.mark.parametrize("region", REGIONS)
def test_phase10a_intervals_on_card(phase10, region, backend):
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    path, truth = phase10
    ds = open_bam(path, config=HBamConfig(inflate_backend=backend,
                                          bam_intervals=region))
    before = tss.seq_qual_stats.launches
    _check_truth(ds.flagstat(), ds.seq_stats(), truth.regions[region])
    assert tss.seq_qual_stats.launches > before
    assert 0 < truth.regions[region].n_reads < truth.n_reads


def test_phase10b_device_step_faults_demote_then_heal(phase10):
    from hadoop_bam_torch import resilience
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.resilience import chaos
    from hadoop_bam_torch.utils.metrics import METRICS
    path, truth = phase10
    clk = [0.0]
    resilience.reset(clock=lambda: clk[0])
    cfg = HBamConfig(inflate_backend="device", breaker_failure_threshold=1.0)
    ds = open_bam(path, config=cfg)
    faults = chaos.seeded_point_faults(5, "device.step",
                                       ["transient", "corrupt"], 2,
                                       max_call=4)
    with chaos.fault_points_on("device.step", faults):
        _check_truth(ds.flagstat(), ds.seq_stats(), truth)
    assert METRICS.get("resilience.demotions") == 1
    clk[0] += cfg.breaker_cooldown_s + 0.1
    before = tid.resolve_pack.launches
    _check_truth(ds.flagstat(), ds.seq_stats(), truth)
    assert tid.resolve_pack.launches > before
    assert METRICS.get("resilience.heals") == 1


def test_phase10c_native_transient_faults_retry(phase10):
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.resilience import chaos
    from hadoop_bam_torch.utils.metrics import METRICS
    path, truth = phase10
    ds = open_bam(path)
    for name in ("flagstat", "seq_stats"):
        with chaos.fault_points_on("decode.native", chaos.seeded_point_faults(
                5, "decode.native", ["transient"], 1, max_call=1)):
            out = getattr(ds, name)()
        assert "quarantine" not in out
    _check_truth(ds.flagstat(), ds.seq_stats(), truth)
    assert METRICS.get("pipeline.transient_retries") == 2


def test_phase10d_flipped_block_card_equals_cpu(phase10, tmp_path):
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.synth import flip_block
    from hadoop_bam_torch.utils.errors import CORRUPT, classify_error
    from hadoop_bam_torch.utils.resilient import QuarantineManifest
    path, truth = phase10
    bad = str(tmp_path / "flipped.bam")
    import os
    flip_block(path, bad, os.path.getsize(path) // 2)
    spans = tp._plan(path, None, 1, 1 << 20)
    spans = list(spans)
    cfg = HBamConfig(skip_bad_spans=True)
    out = {}
    for dev in (None, "cpu"):
        q = QuarantineManifest()
        flag = tp.flagstat_file(bad, device=dev, config=cfg, spans=spans,
                                quarantine=q)
        stats = open_bam(bad, device=dev, config=cfg).seq_stats()
        out[dev] = (flag, stats["n_reads"], stats["base_hist"].tolist(),
                    q.to_dicts(), stats["quarantine"])
    assert out[None] == out["cpu"]
    assert len(out[None][3]) == 1 and 0 < out[None][0]["total"] < 40_000
    for name in ("flagstat", "seq_stats"):
        with pytest.raises(ValueError) as e:
            getattr(open_bam(bad), name)()
        assert classify_error(e.value) == CORRUPT


# ---------------------------------------------------------------------------
# chip_smoke.py phase 11 on the card, at a small size
# ---------------------------------------------------------------------------

@pytest.fixture
def phase11(cuda, tmp_path):
    """A 40,000-read synthetic BAM and its truth, with the plan memo and
    the counters cleared."""
    from hadoop_bam_torch.split.planners import clear_plan_cache
    from hadoop_bam_torch.synth import write_synthetic_bam
    from hadoop_bam_torch.utils.metrics import METRICS
    clear_plan_cache()
    METRICS.reset()
    path = str(tmp_path / "p11.bam")
    yield path, write_synthetic_bam(path, 40_000, seed=7, regions=REGIONS)
    clear_plan_cache()


def test_phase11_sidecar_plans_and_memo_on_card(phase11):
    """(b), (c): both drivers on the native plane and the device plane
    planned from a .splitting-bai equal the truth, cold and from the
    memo; a rewritten sidecar plans again; every kernel launched."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split.splitting_index import (
        SplittingIndex, write_splitting_index,
    )
    path, truth = phase11
    write_splitting_index(path, 4096)
    wrappers = (tid.resolve_pack, tid.walk_records_device, tid.payload_gather,
                tub.unpack_fixed_fields, tss.seq_qual_stats)
    before = [w.launches for w in wrappers]
    for backend in ("native", "device"):
        ds = open_bam(path, config=HBamConfig(inflate_backend=backend))
        for _ in range(2):                       # cold, then a memo hit
            _check_truth(ds.flagstat(), ds.seq_stats(), truth)
    assert ds.flagstat(mode="span") == truth.flagstat
    assert all(w.launches > b for w, b in zip(wrappers, before))
    cfg = HBamConfig(inflate_backend="device")
    plan = tp._plan(path, None, 1, tp.DEVICE_PLANE_SPAN_BYTES, cfg)
    assert isinstance(plan, list)
    sampled = set(SplittingIndex.load_for(path).voffsets)
    assert all(s.start_voffset in sampled for s in plan[1:])
    write_splitting_index(path, 4096)
    again = tp._plan(path, None, 1, tp.DEVICE_PLANE_SPAN_BYTES, cfg)
    assert not isinstance(again, list)
    assert [s.to_dict() for s in again] == [s.to_dict() for s in plan]


def test_phase11_coarse_index_on_card(phase11, monkeypatch):
    """(b2): a splitting index coarser than the grains (one sample): the
    device plane and span mode cut the snapped span back to their grains,
    no device-plane chunk passes its blocks, and both equal the truth."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split.splitting_index import write_splitting_index
    path, truth = phase11
    write_splitting_index(path, 1 << 16)
    chunks = []
    tokenize = tp._tokenize_span_tokens

    def spy(*a, **k):
        c = tokenize(*a, **k)
        chunks.append((c.used, c.n_blocks))
        return c
    monkeypatch.setattr(tp, "_tokenize_span_tokens", spy)
    before = tid.walk_records_device.launches
    ds = open_bam(path, config=HBamConfig(inflate_backend="device"))
    assert ds.flagstat() == truth.flagstat
    assert tid.walk_records_device.launches > before
    assert len(chunks) > 1 and all(u == n for u, n in chunks)
    ds = open_bam(path, config=HBamConfig(inflate_backend="native"))
    assert ds.flagstat(mode="span", geometry=tp.DecodeGeometry(
        bytes_cap=1 << 22)) == truth.flagstat


@pytest.mark.parametrize("region", REGIONS)
def test_phase11_bai_trimming_on_card(phase11, tmp_path, region):
    """(d): a region on the native plane with a .bai (the same reads
    coordinate-sorted) equals the interval truth and inflates less than
    the full scan."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.split.planners import clear_plan_cache
    from hadoop_bam_torch.synth import write_synthetic_bam
    from hadoop_bam_torch.utils.metrics import METRICS
    srt = str(tmp_path / "sorted.bam")
    truth = write_synthetic_bam(srt, 40_000, seed=7, regions=REGIONS,
                                coordinate_sorted=True)
    ds = open_bam(srt, config=HBamConfig(bam_intervals=region))
    _check_truth(ds.flagstat(), ds.seq_stats(), truth.regions[region])
    full = METRICS.get("pipeline.inflated_bytes")
    write_bai(srt)
    clear_plan_cache()
    METRICS.reset()
    ds = open_bam(srt, config=HBamConfig(bam_intervals=region))
    _check_truth(ds.flagstat(), ds.seq_stats(), truth.regions[region])
    assert 0 < METRICS.get("pipeline.inflated_bytes") < full
    assert truth.regions[region].n_reads == phase11[1].regions[region].n_reads


@pytest.mark.parametrize("fused", [True, False])
def test_phase11_fused_and_two_pass_on_card(phase11, fused):
    """(e): the three native drivers with use_fused_decode on and off
    equal the truth, through K1 and K2."""
    from hadoop_bam_torch.api import open_bam
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.utils.metrics import METRICS
    path, truth = phase11
    ds = open_bam(path, config=HBamConfig(use_fused_decode=fused))
    k1, k2 = tub.unpack_fixed_fields.launches, tss.seq_qual_stats.launches
    _check_truth(ds.flagstat(), ds.seq_stats(), truth)
    assert ds.flagstat(mode="span") == truth.flagstat
    assert tub.unpack_fixed_fields.launches > k1
    assert tss.seq_qual_stats.launches > k2
    assert METRICS.get("pipeline.records") == 3 * truth.n_reads


# ---------------------------------------------------------------------------
# K12 (coverage) and K13 (region-query overlap): torch ops on the card
# against the same ops on the CPU, and their drivers
# ---------------------------------------------------------------------------

@pytest.fixture
def coverage_bam(cuda, tmp_path):
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_coverage_bam
    path = str(tmp_path / "cov.bam")
    truth = write_coverage_bam(path, 20_000, seed=4, span=300_000)
    write_bai(path)
    return path, truth


@pytest.mark.parametrize("mc", [8, 64])
def test_k12_coverage_step_on_card_matches_cpu(coverage_bam, mc):
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.split.planners import plan_bam_spans
    path, _ = coverage_bam
    rows = np.concatenate([tp.decode_span_cigar_rows(path, s, 64)
                           for s in plan_bam_spans(path, num_spans=3)])
    nc = rows[:, 8].astype(np.int64) | (rows[:, 9].astype(np.int64) << 8)
    tile = np.ascontiguousarray(rows[nc <= mc, :tp._cigar_row_bytes(mc)])
    host = torch.from_numpy(tile)
    dev = host.to("cuda")
    calls = tp.coverage_step.launches
    for count, start, window in ((tile.shape[0], 0, 300_000),
                                 (tile.shape[0] // 3, 100_000, 50_000)):
        got = tp.coverage_step(dev, count, 0, start, window, mc)
        want = tp.coverage_step(host, count, 0, start, window, mc)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
        d = tp.coverage_depth_step(dev, count, 0, start, window, mc)
        assert torch.equal(d.cpu(), torch.cumsum(want[:window], 0,
                                                 dtype=torch.int32))
    assert tp.coverage_step.launches == calls + 4


def test_k12_int32_wrap_on_card_matches_cpu(cuda):
    """Op starts past 2^31 wrap in int32 on the card as on the CPU."""
    from hadoop_bam_torch.ops import cigar
    rng = np.random.default_rng(9)
    n, mc = 500, 16
    words = ((rng.integers(0, 1 << 12, (n, mc)) << 4)
             | rng.integers(0, 9, (n, mc))).astype(np.int64)
    pos = rng.integers((1 << 31) - 30_000, (1 << 31) - 1, n).astype(
        np.int32)
    cols = [torch.from_numpy(a) for a in (
        words, pos, rng.integers(-1, 2, n).astype(np.int32),
        rng.integers(0, 4096, n).astype(np.int32), rng.random(n) < 0.9)]
    want = cigar.window_coverage_from_tiles(*cols, 1, (1 << 31) - 40_000,
                                            60_000)
    got = cigar.window_coverage_from_tiles(*(c.to(cuda) for c in cols), 1,
                                           (1 << 31) - 40_000, 60_000)
    assert torch.equal(got.cpu(), want) and bool(want.any())


def test_coverage_file_on_card_equals_cpu_and_oracle(coverage_bam):
    import os
    from hadoop_bam_torch.parallel import pipeline as tp
    from hadoop_bam_torch.synth import coverage_oracle
    path, truth = coverage_bam
    for region, lo, window in (("chr20:1-300000", 0, 300_000),
                               ("chr20:250001-310000", 250_000, 60_000)):
        want = coverage_oracle(truth, 0, lo, window)
        got = tp.coverage_file(path, region)
        assert np.array_equal(got, want)
        assert np.array_equal(tp.coverage_file(path, region, device="cpu"),
                              want)
        os.rename(path + ".bai", path + ".off")
        try:
            assert np.array_equal(tp.coverage_file(path, region), want)
        finally:
            os.rename(path + ".off", path + ".bai")


def test_k13_overlap_step_on_card_matches_cpu(cuda):
    from hadoop_bam_torch.query.engine import overlap_step
    rng = np.random.default_rng(3)
    cap = 8192
    cols = [rng.integers(-1, 3, (1, cap)), rng.integers(1, 9000, (1, cap)),
            rng.integers(1, 9000, (1, cap)), rng.integers(-1, 3, (1, cap)),
            rng.integers(1, 9000, (1, cap)), rng.integers(1, 9000, (1, cap)),
            rng.integers(0, 50, (1, cap))]
    host = [torch.from_numpy(c.astype(np.int32)) for c in cols]
    for count in (cap, 5000, 0):
        n = torch.tensor([count], dtype=torch.int32)
        want = overlap_step(*host, n)
        got = overlap_step(*(c.to(cuda) for c in host), n.to(cuda))
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
        assert not bool(want[0, count:].any())


def test_query_engine_on_card_equals_cpu(cuda, tmp_path):
    from hadoop_bam_torch.api import query_regions
    from hadoop_bam_torch.query import QueryEngine, QueryRequest
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "q.bam")
    truth = write_synthetic_bam(path, 40_000, seed=6, coordinate_sorted=True,
                                keep_columns=True)
    write_bai(path)
    regions = ["chr20:1-200000", "chr20:5,000,000-5,010,000", "chr21",
               "chr21:100-40000", "chr20:1000000-1000050"]
    reqs = [QueryRequest(path, r) for r in regions]
    card, cpu = QueryEngine(), QueryEngine(device="cpu")
    assert card.device.type == "cuda"
    got = [[x.to_line() for x in r.records] for r in card.query_records(reqs)]
    want = [[x.to_line() for x in r.records] for r in cpu.query_records(reqs)]
    assert got == want and sum(map(len, got)) > 0
    kept = sum(int(o["keep"].sum()) for o in query_regions(reqs, engine=card))
    assert kept == sum(map(len, got))
    pos1 = truth.pos[truth.refid == 1] + 1
    assert len(got[2]) == pos1.size


def _k10i_random(n_rows, L, seed, cuda, over=False, shift=0):
    """K10i inputs (``synth.interval_rows``): records' prefixes written
    into random bytes at every residue mod 4 with the edge rows (prefixes
    cut by either end, past both, wrapping int32; CIGARs cut by the end),
    n_cigar 0 to 64 (65 on row n_rows // 2 with ``over``), pos at the
    int32 edges; ``shift`` puts buf in a view that many bytes off 16."""
    from hadoop_bam_torch.synth import interval_rows
    buf, offs, _ = interval_rows(L, n_rows, seed, over=over)
    b = torch.from_numpy(buf).to(cuda)
    if shift:
        whole = torch.zeros(L + shift, dtype=torch.uint8, device=cuda)
        whole[shift:] = b
        b = whole[shift:]
    return [b, torch.from_numpy(offs).to(cuda)]


@pytest.mark.parametrize("n_all", [-1, 0, 1, 777, 4096, 5000])
def test_k10i_interval_cols_match_plain(cuda, n_all):
    from hadoop_bam_torch.ops import inflate_device as tid
    for over in (False, True):
        for shift in (0, 3):
            args = _k10i_random(4096, 1 << 17, 5, cuda, over, shift)
            na = torch.tensor([n_all], dtype=torch.int32, device=cuda)
            before = tid.interval_cols.launches
            got = tid.interval_cols(*args, na)
            want = tid.interval_cols_plain(*args, na)
            torch.cuda.synchronize()
            assert tid.interval_cols.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g.reshape(-1), w.reshape(-1))
            if over and n_all > 2048:
                assert int(got[3]) == 1
            if n_all <= 0:
                assert int(got[3]) == 0


@pytest.mark.parametrize("R", [16, 17, 4093, 16_384])
def test_k10i_pads_and_over_across_streams(cuda, R):
    """Row counts off the int4 pad quads, n_all on every residue, and
    ``over`` set and cleared launch after launch on two streams (each
    stream's scratch word must be back at zero after every launch)."""
    from hadoop_bam_torch.ops import inflate_device as tid
    streams = [torch.cuda.current_stream(cuda), torch.cuda.Stream(cuda)]
    for i, n_all in enumerate([R, R - 1, R - 2, R - 3, R // 2, 1, 0]):
        over = i % 2 == 0
        args = _k10i_random(R, 1 << 19, 40 + i, cuda, over)
        na = torch.tensor([n_all], dtype=torch.int32, device=cuda)
        s = streams[i % 2]
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            got = tid.interval_cols(*args, na)
            want = tid.interval_cols_plain(*args, na)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.reshape(-1), w.reshape(-1)), (R, n_all)
        if over and n_all > R // 2:
            assert int(got[3]) == 1


def test_k10i_serve_step_on_card_matches_plain(cuda, tmp_path):
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel.pipeline import _tokenize_span_tokens
    from hadoop_bam_torch.split.planners import plan_bam_spans
    from hadoop_bam_torch.synth import write_coverage_bam
    path = str(tmp_path / "cig.bam")
    write_coverage_bam(path, 20_000, seed=9, span=300_000)
    checked = 0
    for span in plan_bam_spans(path, num_spans=6):
        c = _tokenize_span_tokens(path, span)
        if c is None or c.used < c.n_blocks:
            continue
        B = tid.round_pow2(c.used, 8)
        tok = np.zeros((B, c.P), np.int32)
        tok[:c.used] = c.tokens.view(np.int32)
        nt = np.zeros(B, np.int32)
        iz = np.zeros(B, np.int32)
        nt[:c.used], iz[:c.used] = c.n_tokens, c.isize
        t = [torch.from_numpy(a).to(cuda) for a in (tok, nt, iz)]
        got = tid.resolve_walk_intervals(*t, c.start, c.stop, c.P)
        want = tid.resolve_walk_intervals_plain(*t, c.start, c.stop, c.P)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.reshape(-1), w.reshape(-1))
        assert int(got[3]) > 0 and int(got[6]) == 0
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("backend", ["native", "device"])
def test_serve_loop_on_card_equals_cpu_engine(cuda, tmp_path, backend):
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.query import QueryEngine, QueryRequest
    from hadoop_bam_torch.serve import ServeLoop
    from hadoop_bam_torch.serve import tiles as st
    from hadoop_bam_torch.split.bai import write_bai
    from hadoop_bam_torch.synth import write_synthetic_bam
    from hadoop_bam_torch.utils.metrics import MetricsContext
    path = str(tmp_path / "s.bam")
    write_synthetic_bam(path, 40_000, seed=6, coordinate_sorted=True)
    write_bai(path)
    regions = ["chr20:1-200000", "chr20:5,000,000-5,010,000", "chr21",
               "chr21:100-40000", "chr20:1000000-1000050"]
    want = QueryEngine(device="cpu").query_records(
        [QueryRequest(path, r) for r in regions])
    cfg = HBamConfig(inflate_backend=backend, serve_prefetch=False)
    k10i = tid.interval_cols.launches
    steps = st.tile_filter_step.launches
    with ServeLoop(config=cfg) as loop:
        assert loop.device.type == "cuda"
        cold = loop.query(path, regions)
        with MetricsContext() as warm_m:
            warm = loop.query(path, regions)
        recs = loop.query(path, regions[:2], want_records=True)
    # candidates are the region's own index ranges (the engine scans
    # the batch's hull): the same server on the CPU gives the same
    with ServeLoop(config=cfg, device="cpu") as cpu_loop:
        cpu_cands = [r.n_candidates for r in cpu_loop.query(path, regions)]
    for got in (cold, warm):
        assert [r.count for r in got] == [len(w.records) for w in want]
        assert [r.n_candidates for r in got] == cpu_cands
    assert all(r.tile_misses == 0 for r in warm)
    assert warm_m.counters.get("query.chunks_decoded", 0) == 0
    for r, w in zip(recs, want):
        assert [x.to_line() for x in r.records] == \
            [x.to_line() for x in w.records]
    assert st.tile_filter_step.launches > steps
    if backend == "device":
        assert tid.interval_cols.launches > k10i


# ---------------------------------------------------------------------------
# K11: the BCF device unpack (variant_unpack; variant_prefix and gt_dosage
# launch the same kernel for the prefix alone or one group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(synth.UNPACK_CASES)))
@pytest.mark.parametrize("shift", [0, 3])
def test_k11_variant_unpack_matches_plain(cuda, case, shift):
    """One launch a span: multi-group spans (diploid and haploid),
    widths 2 and 4, saturation, rows of no group, pad rows, n_sample <
    samples_pad, the clip and wrap edges; buf at an aligned and an odd
    address, twice in a row over a poisoned allocator: bit-equal to
    the plain version."""
    from hadoop_bam_torch.ops import inflate_device as tid
    _, groups, n, s_pad = synth.UNPACK_CASES[case]
    buf, meta, R, s_pad = synth.unpack_span(groups, n, s_pad, seed=case)
    big = torch.zeros(buf.size + shift, dtype=torch.uint8, device=cuda)
    big[shift:] = torch.from_numpy(buf).to(cuda)
    b = big[shift:]
    packed = tid.pack_variant_meta(meta, R)
    want = tid.variant_unpack_plain(b, packed, R, s_pad)
    for _ in range(2):
        synth.poison_allocator(cuda)
        before = tid.variant_unpack.launches
        got = tid.variant_unpack(b, packed, R, s_pad)
        torch.cuda.synchronize()
        assert tid.variant_unpack.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_k11_bad_header_raises_before_the_launch(cuda):
    """A packed array whose sections do not fit raises ValueError on the
    host, with no launch, and the card still takes the next span."""
    from hadoop_bam_torch.ops import inflate_device as tid
    _, groups, n, s_pad = synth.UNPACK_CASES[0]
    buf, meta, R, s_pad = synth.unpack_span(groups, n, s_pad, seed=0)
    b = torch.from_numpy(buf).to(cuda)
    packed = tid.pack_variant_meta(meta, R)
    for word, value in ((1, R + 10_000), (3, 2), (4, packed.size)):
        bad = packed.copy()
        bad[word] = value
        before = tid.variant_unpack.launches
        with pytest.raises(ValueError):
            tid.variant_unpack(b, bad, R, s_pad)
        assert tid.variant_unpack.launches == before
    got = tid.variant_unpack(b, packed, R, s_pad)
    for g, w in zip(got, tid.variant_unpack_plain(b, packed, R, s_pad)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", range(len(synth.GT_CASES)))
@pytest.mark.parametrize("shift", [0, 3])
def test_k11_gt_dosage_matches_plain(cuda, case, shift):
    """Every GT layout case (widths 1, 2, 4; ploidy 1-3 and 200;
    END_OF_VECTOR tails, MISSING and allele-0 calls, saturation, offsets
    clipped at both ends), buf at an aligned and an odd address, twice
    in a row: bit-equal to the plain version, rows of no group left
    as they were."""
    from hadoop_bam_torch.ops import inflate_device as tid
    w, c, ns, G = synth.GT_CASES[case]
    buf, offs, rows, R = synth.gt_rows(w, c, ns, G, seed=case)
    big = torch.zeros(buf.size + shift, dtype=torch.uint8, device=cuda)
    big[shift:] = torch.from_numpy(buf).to(cuda)
    b = big[shift:]
    o, r = (torch.from_numpy(a).to(cuda) for a in (offs, rows))
    want = tid.gt_dosage_plain(b, o, r, w, c, ns, torch.full(
        (R, ns + 5), -1, dtype=torch.int8, device=cuda))
    for _ in range(2):
        got = torch.full((R, ns + 5), -1, dtype=torch.int8, device=cuda)
        before = tid.gt_dosage.launches
        tid.gt_dosage(b, o, r, w, c, ns, got)
        torch.cuda.synchronize()
        assert tid.gt_dosage.launches == before + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 12, 1000, 70_000])
def test_k11_variant_prefix_matches_plain(cuda, n):
    from hadoop_bam_torch.ops import inflate_device as tid
    buf, starts = synth.prefix_rows(n, seed=n)
    b, s = (torch.from_numpy(a).to(cuda) for a in (buf, starts))
    before = tid.variant_prefix.launches
    got = tid.variant_prefix(b, s)
    want = tid.variant_prefix_plain(b, s)
    torch.cuda.synchronize()
    assert tid.variant_prefix.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_variant_planes_on_card_match_truth(cuda, tmp_path):
    """variant_stats_file on the card, host plane (BGZF and raw BCF,
    BGZF VCF) and device plane (K7+K8, K11, K14), equal to the
    generator's truth; the device plane launched K11 once a span it
    unpacked on the card, and the host planes never."""
    from hadoop_bam_torch.config import HBamConfig
    from hadoop_bam_torch.ops import inflate_device as tid
    from hadoop_bam_torch.parallel.variant_pipeline import (
        variant_stats_file,
    )
    from hadoop_bam_torch.utils.metrics import MetricsContext
    p, raw, vz = (str(tmp_path / n) for n in ("v.bcf", "v.raw.bcf",
                                              "v.vcf.gz"))
    truth = synth.write_synthetic_vcf(p, 3000, 5, n_samples=300,
                                      raw_path=raw, vcf_path=vz,
                                      vcf_records=1000)
    runs = [(p, None, truth), (raw, None, truth), (vz, None, truth.vcf),
            (p, HBamConfig(inflate_backend="device"), truth)]
    for path, cfg, want in runs:
        kw = {"config": cfg} if cfg is not None else {}
        before = tid.variant_unpack.launches
        with MetricsContext() as m:
            got = variant_stats_file(path, **kw)
        for k in ("n_variants", "n_snp", "n_pass", "n_af"):
            assert got[k] == getattr(want, k), (path, k)
        np.testing.assert_allclose(got["mean_af"], want.mean_af, rtol=1e-6)
        np.testing.assert_array_equal(got["sample_callrate"],
                                      want.sample_callrate)
        spans = m.counters.get("vcf.device_spans", 0)
        assert tid.variant_unpack.launches - before == spans
        assert (spans > 0) == (cfg is not None)


# ---------------------------------------------------------------------------
# K15: the mesh sort's steps on the card, and the sort through them
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shuffled_bam(tmp_path_factory):
    """A synthetic BAM (paired reads, unmapped mates, unsorted) and the
    port's host sort of it."""
    from hadoop_bam_torch.utils.sort import sort_bam
    d = tmp_path_factory.mktemp("k15")
    path = str(d / "s.bam")
    synth.write_synthetic_bam(path, 30_000, 4)
    ref = str(d / "ref.bam")
    sort_bam(path, ref)
    return path, open(ref, "rb").read()


@pytest.mark.parametrize("n,n_bounds", [(1, 0), (1000, 0), (30_000, 0),
                                        (5000, 7)])
def test_k15_steps_on_card_equal_their_cpu_run(cuda, shuffled_bam, n,
                                               n_bounds):
    """Both steps over the first ``n`` records of a span, with no bounds
    (one device) and with seven (the bucket pack of eight devices before
    the one-device exchange refuses)."""
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    path, _ = shuffled_bam
    (span,) = plan_bam_spans_balanced(path, 1)
    data, offs = ms._decode(path, span, DEFAULT_CONFIG)
    offs = offs[:n]
    R = ms._round_up(n, 8)
    host = np.zeros(ms._round_up(data.size, 256), np.uint8)
    host[:data.size] = data
    o = np.zeros(R, np.int32)
    o[:n] = offs
    rng = np.random.default_rng(n)
    bhi = torch.from_numpy(np.sort(rng.integers(0, 3, n_bounds)))
    blo = torch.from_numpy(rng.integers(0, 1 << 32, n_bounds))
    lens = ms._record_lens(data, offs)
    stride = ms._round_up(int(lens.max()), 64)
    rows, ln = ms.pack_rows(torch.from_numpy(data), offs, lens, R, stride)
    if n_bounds:
        with pytest.raises(Exception, match="one device"):
            ms.sort_step(torch.from_numpy(host).to(cuda),
                         torch.from_numpy(o).to(cuda), n, 5, bhi.to(cuda),
                         blo.to(cuda))
        for dev in ("cpu", cuda):
            hi, lo, _ = ms._device_keys(
                torch.from_numpy(o).to(dev), torch.from_numpy(o).to(dev),
                torch.arange(R, device=dev) < n, 5, R)
            got = ms._bucket_pack(hi, lo, bhi.to(dev), blo.to(dev), R)
            if dev == "cpu":
                want = got
            else:
                for g, w in zip(got, want):
                    assert torch.equal(g.cpu(), w)
        return
    before = tub.unpack_fixed_fields.launches
    got = ms.sort_step(torch.from_numpy(host).to(cuda),
                       torch.from_numpy(o).to(cuda), n, 5, bhi.to(cuda),
                       blo.to(cuda))
    assert tub.unpack_fixed_fields.launches == before + 1
    want = ms.sort_step(torch.from_numpy(host), torch.from_numpy(o), n, 5,
                        bhi, blo)
    assert torch.equal(got.cpu(), want)
    g = ms.bytes_sort_step(rows.to(cuda), ln.to(cuda), n, 5, bhi.to(cuda),
                           blo.to(cuda))
    w = ms.bytes_sort_step(rows, ln, n, 5, bhi, blo)
    for a, b in zip(g, w):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kw", [{}, {"exchange": "bytes"},
                                {"round_records": 7000}])
def test_mesh_sort_on_card_equals_host_sort(cuda, shuffled_bam, tmp_path,
                                            kw):
    from hadoop_bam_torch.parallel import mesh_sort as ms
    path, want = shuffled_bam
    out = str(tmp_path / "o.bam")
    assert ms.sort_bam_mesh(path, out, device=cuda, **kw) == 30_000
    assert open(out, "rb").read() == want


# ---------------------------------------------------------------------------
# K16: the duplicate-signature columns (K16a) and the signature exchange
# (K16b) on the card, and the duplicate-marking pipeline through them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kmax", ["rows", 2, 0])
@pytest.mark.parametrize("shift", [0, 16])
def test_k16a_markdup_columns_match_plain(cuda, kmax, shift):
    """Every ``synth.MARKDUP_CASES`` row, random pad rows and a last row
    whose CIGAR runs past the tile, at the rows' own CIGAR width and
    below it; the tile at a 16-byte offset from its allocation."""
    from hadoop_bam_torch.prep import markdup as md
    rows, lib, count, _ = synth.markdup_rows(seed=3)
    k = synth.rows_kmax(rows) if kmax == "rows" else kmax
    base = torch.zeros(rows.size + shift, dtype=torch.uint8, device=cuda)
    rt = base[shift:].view(rows.shape)
    rt.copy_(torch.from_numpy(rows))
    lt = torch.from_numpy(lib).to(cuda)
    before = md.markdup_columns.launches
    for _ in range(2):
        got = md.markdup_columns(rt, count, lt, k)
    want = md.markdup_columns_plain(torch.from_numpy(rows),
                                    torch.arange(rows.shape[0]) < count,
                                    torch.from_numpy(lib), k)
    torch.cuda.synchronize()
    assert md.markdup_columns.launches == before + 2
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("kmax", ["rows", 2, 0])
@pytest.mark.parametrize("shift", [0, 16])
@pytest.mark.parametrize("case", [n for n, _ in synth.MARKDUP_TILES]
                         + ["past the first sweep"])
def test_k16a_markdup_columns_match_plain_on_the_tiles(cuda, case, shift,
                                                       kmax):
    """``synth.MARKDUP_TILES`` (runs of 400-600 bases at stride 1024,
    30-40-byte names, R = 1, R = 7, R = 1,031) and a tile past the
    persistent grid's first sweep (777 rows more than the card has
    threads at once, 2,048 an SM): the last batch partial."""
    from hadoop_bam_torch.prep import markdup as md
    if case == "past the first sweep":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        rows, lib, count = synth.markdup_tile(sms * 2048 + 777, seed=4,
                                              stride=128, l_seq=(10, 40))
    else:
        rows, lib, count = synth.markdup_tile(
            seed=3, **dict(synth.MARKDUP_TILES)[case])
    k = synth.rows_kmax(rows) if kmax == "rows" else kmax
    base = torch.zeros(rows.size + shift, dtype=torch.uint8, device=cuda)
    rt = base[shift:].view(rows.shape)
    rt.copy_(torch.from_numpy(rows))
    lt = torch.from_numpy(lib).to(cuda)
    before = md.markdup_columns.launches
    got = md.markdup_columns(rt, count, lt, k)
    want = md.markdup_columns_plain(rt, torch.arange(rows.shape[0],
                                                     device=cuda) < count,
                                    lt, k)
    torch.cuda.synchronize()
    assert md.markdup_columns.launches == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("row_bytes", [None, 0, 48, "tile", 400, 2_000])
@pytest.mark.parametrize("case", ["edge rows", "30-40-byte names",
                                  "reads of 400-600 bases, stride 1024"])
def test_k16a_markdup_columns_match_plain_at_each_window(cuda, case,
                                                         row_bytes):
    """The staged window from the fixed fields alone (0, 48) through the
    tile's ``host_row_bytes`` to past the row (None: the whole row, at
    most 512 bytes): every op and quality word past it read from the
    tile, the columns the same."""
    from hadoop_bam_torch.prep import markdup as md
    if case == "edge rows":
        rows, lib, count, _ = synth.markdup_rows(seed=5)
    else:
        rows, lib, count = synth.markdup_tile(
            seed=5, **dict(synth.MARKDUP_TILES)[case])
    if row_bytes == "tile":
        row_bytes = md.host_row_bytes(
            rows.reshape(-1), np.arange(count) * rows.shape[1])
    k = synth.rows_kmax(rows)
    rt = torch.from_numpy(rows).to(cuda)
    lt = torch.from_numpy(lib).to(cuda)
    got = md.markdup_columns(rt, count, lt, k, row_bytes)
    want = md.markdup_columns_plain(rt, torch.arange(rows.shape[0],
                                                     device=cuda) < count,
                                    lt, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_k16a_refuses_unaligned_rows(cuda):
    from hadoop_bam_torch.prep import markdup as md
    rows, lib, count, _ = synth.markdup_rows()
    base = torch.zeros(rows.size + 4, dtype=torch.uint8, device=cuda)
    rt = base[4:].view(rows.shape)
    with pytest.raises(ValueError, match="aligned"):
        md.markdup_columns(rt, count, torch.from_numpy(lib).to(cuda), 4)


@pytest.fixture(scope="module")
def markdup_bam(tmp_path_factory):
    d = tmp_path_factory.mktemp("k16")
    path = str(d / "md.bam")
    return path, synth.write_markdup_bam(path, 20_000, 6)


def test_k16_steps_on_card_equal_their_cpu_run(cuda, markdup_bam):
    """The fused step and the exchange step over a round of a
    duplicate-bearing BAM: every output equal to the CPU run's."""
    from hadoop_bam_torch.config import DEFAULT_CONFIG
    from hadoop_bam_torch.parallel import mesh_sort as ms
    from hadoop_bam_torch.prep import markdup as md
    from hadoop_bam_torch.split.planners import plan_bam_spans_balanced
    path, _ = markdup_bam
    (span,) = plan_bam_spans_balanced(path, 1)
    data, offs = ms._decode(path, span, DEFAULT_CONFIG)
    n = int(offs.size)
    lens = ms._record_lens(data, offs)
    R = ms._round_up(n, 1024)
    rows, ln = ms.pack_rows(torch.from_numpy(data), offs, lens, R, 512)
    lib = torch.from_numpy(np.random.default_rng(1).integers(
        0, 3, R).astype(np.uint32))
    none = torch.zeros(0, dtype=torch.int64)
    kmax = md.host_kmax(data, offs)
    g = md.fused_sort_markdup_step(rows.to(cuda), ln.to(cuda), n, 7,
                                   lib.to(cuda), none.to(cuda),
                                   none.to(cuda), kmax,
                                   md.host_row_bytes(data, offs))
    w = md.fused_sort_markdup_step(rows, ln, n, 7, lib, none, none, kmax)
    for a, b in zip(g[0] + g[1], w[0] + w[1]):
        assert torch.equal(a.cpu(), b)
    cols, elig = w[1]
    el = elig[:n].bool()
    keys = [c[:n][el] for c in cols]
    gidx = (7 + torch.arange(n, dtype=torch.int32))[el]
    m = int(el.sum())
    g2 = md.markdup_exchange_step(*(k.to(cuda) for k in keys),
                                  gidx.to(cuda), m)
    w2 = md.markdup_exchange_step(*keys, gidx, m)
    for a, b in zip(g2, w2):
        assert torch.equal(a.cpu(), b)
    assert int(w2[1].sum()) > 0


@pytest.mark.parametrize("library_from", ["none", "rg"])
def test_markdup_on_card_equals_oracle_and_truth(cuda, markdup_bam,
                                                 tmp_path, library_from):
    from hadoop_bam_torch.prep import markdup_bam_mesh, markdup_bam_oracle
    path, truth = markdup_bam
    out, ref = str(tmp_path / "o.bam"), str(tmp_path / "ref.bam")
    assert markdup_bam_mesh(path, out, device=cuda, round_records=7_000,
                            library_from=library_from) == 20_000
    markdup_bam_oracle(path, ref, library_from=library_from)
    assert open(out, "rb").read() == open(ref, "rb").read()


# ---------------------------------------------------------------------------
# K17a (cohort_stats.cu): the cohort plane's GWAS columns
# ---------------------------------------------------------------------------

def _k17a_hold(got, want):
    """AF and call rate (integer-derived) bit for bit; HWE and score
    within rtol 1e-5, atol 1e-6 (their sums run in another order)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g[..., :2], w[..., :2])
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g[..., 2:], w[..., 2:], rtol=1e-5,
                               atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("case", synth.GWAS_CASES)
def test_k17a_cohort_gwas_matches_plain(cuda, case):
    from hadoop_bam_torch.cohort.gwas import (
        cohort_gwas_plain, cohort_gwas_step,
    )
    d, count, pheno, S = synth.gwas_case(case)
    dt = torch.from_numpy(d).to(cuda)
    pt = None if pheno is None else torch.from_numpy(pheno).to(cuda)
    ct = torch.tensor([count], dtype=torch.int32, device=cuda)
    before = cohort_gwas_step.launches
    for _ in range(2):
        got = cohort_gwas_step(dt, ct, pt, S)
        _k17a_hold(got, cohort_gwas_plain(dt, ct, pt, S))
    assert cohort_gwas_step.launches == before + 2
    assert torch.isnan(got[0, count:]).all()
    # an int count takes the same path
    _k17a_hold(cohort_gwas_step(dt, count, pt, S),
               cohort_gwas_plain(dt, count, pt, S))


def test_k17a_refuses_unaligned_phenotype(cuda):
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_step
    d = torch.zeros((1, 4, 8), dtype=torch.int8, device=cuda)
    y = torch.zeros(9, dtype=torch.float32, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        cohort_gwas_step(d, 4, y, 8)


def test_k17a_wide_tile_reads_the_phenotype_unstaged(cuda):
    """samples_pad past the staged width (csrc/cohort_stats.cu kStageMax):
    the phenotype is read from its vector as the rows need it."""
    from hadoop_bam_torch.cohort.gwas import (
        cohort_gwas_plain, cohort_gwas_step,
    )
    rng = np.random.default_rng(17)
    spad, S, count = 9_608, 9_603, 40
    d = rng.integers(-1, 3, (1, 48, spad)).astype(np.int8)
    y = rng.standard_normal(spad).astype(np.float32)
    y[rng.random(spad) < 0.1] = np.nan
    dt, yt = torch.from_numpy(d).to(cuda), torch.from_numpy(y).to(cuda)
    _k17a_hold(cohort_gwas_step(dt, count, yt, S),
               cohort_gwas_plain(dt, count, yt, S))


# ---------------------------------------------------------------------------
# K17b (hbam_cohort_slice in cohort_stats.cu): the cohort slice step
# ---------------------------------------------------------------------------

def _k17b_hold(got, want):
    """keep, hits and af_n exactly, af bit for bit, af_sum within rtol
    1e-6 (the kernel adds in float64, plain in float32)."""
    names = ("keep", "hits", "af", "af_sum", "af_n")
    for name, g, w in zip(names, got, want):
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "af_sum":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6)
        elif name == "af":
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("case", synth.SLICE_CASES)
def test_k17b_cohort_slice_matches_plain(cuda, case):
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_step
    from hadoop_bam_torch.cohort.serving import (
        cohort_slice_plain, cohort_slice_step,
    )
    tile = [torch.from_numpy(a).to(cuda) for a in synth.slice_case(case)]
    before = (cohort_slice_step.launches, cohort_gwas_step.launches)
    for _ in range(3):     # the ticket is back at zero between launches
        _k17b_hold(cohort_slice_step(*tile), cohort_slice_plain(*tile))
    assert cohort_slice_step.launches == before[0] + 3
    assert cohort_gwas_step.launches == before[1]


def test_k17b_is_one_launch_a_call(cuda):
    """The profiler sees the slice kernel and nothing else: no memset, no
    torch op."""
    from torch.profiler import ProfilerActivity, profile

    from hadoop_bam_torch.cohort.serving import cohort_slice_step
    tile = [torch.from_numpy(a).to(cuda)
            for a in synth.slice_case("200 rows, a slice")]
    cohort_slice_step(*tile)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            cohort_slice_step(*tile)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("cohort_rows_kernel" in n for n in names), names


def test_k17b_streams_keep_their_own_tickets(cuda):
    from hadoop_bam_torch.cohort.serving import (
        cohort_slice_plain, cohort_slice_step,
    )
    tiles = [[torch.from_numpy(a).to(cuda) for a in synth.slice_case(c)]
             for c in ("200 rows, a slice", "4096 rows, every row kept")]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(4):
        for k, (st, tile) in enumerate(zip(streams, tiles)):
            with torch.cuda.stream(st):
                got[k].append(cohort_slice_step(*tile))
    torch.cuda.synchronize()
    for k, tile in enumerate(tiles):
        want = cohort_slice_plain(*tile)
        for g in got[k]:
            _k17b_hold(g, want)


def test_k17b_graph_capture_then_eager_on_the_same_stream(cuda):
    """A capture on a stream K17b never ran on eagerly, a graph never
    replayed, then eager calls on that stream and replays on another: a
    graph has its own scratch, zeroed in the graph, so every result
    equals plain's."""
    from hadoop_bam_torch.cohort.serving import (
        cohort_slice_plain, cohort_slice_step,
    )
    tile = [torch.from_numpy(a).to(cuda)
            for a in synth.slice_case("200 rows, a slice")]
    want = cohort_slice_plain(*tile)
    cohort_slice_step(*tile)           # built and loaded, on another stream
    cap, other = torch.cuda.Stream(), torch.cuda.Stream()
    for st in (cap, other):
        st.wait_stream(torch.cuda.current_stream())
    unused, graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(unused, stream=cap):
        cohort_slice_step(*tile)
    with torch.cuda.graph(graph, stream=cap):
        out = cohort_slice_step(*tile)
    del unused
    for _ in range(3):                 # the two streams not ordered
        with torch.cuda.stream(cap):
            eager = [cohort_slice_step(*tile) for _ in range(4)]
        with torch.cuda.stream(other):
            graph.replay()
        torch.cuda.synchronize()
        for e in eager:
            _k17b_hold(e, want)
        _k17b_hold(out, want)


def test_k17b_refuses_bad_arguments_on_the_card(cuda):
    from hadoop_bam_torch.cohort.serving import cohort_slice_step
    chrom, pos, d, c, iv = (torch.from_numpy(a).to(cuda) for a in
                            synth.slice_case("200 rows, a slice"))
    with pytest.raises(ValueError, match="aligned"):
        x = torch.zeros(d.numel() + 1, dtype=torch.int8, device=cuda)
        cohort_slice_step(chrom, pos, x[1:].view(d.shape), c, iv)
    with pytest.raises(ValueError, match="share a device"):
        cohort_slice_step(chrom, pos, d, c, iv.cpu())


def test_cohort_gwas_and_slices_on_card_equal_the_cpu(cuda, tmp_path):
    from hadoop_bam_torch.cohort import open_cohort
    from hadoop_bam_torch.cohort.gwas import cohort_gwas_step
    from hadoop_bam_torch.serve import ServeLoop
    truth = synth.write_cohort(str(tmp_path), 40, 300, 3)
    y = np.random.default_rng(1).standard_normal(40).astype(np.float32)
    before = cohort_gwas_step.launches
    got = open_cohort(truth.manifest, device=cuda).gwas(y)
    assert cohort_gwas_step.launches > before
    want = open_cohort(truth.manifest, device="cpu").gwas(y)
    for k in ("chrom", "pos", "n_allele", "af", "call_rate"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("hwe_chi2", "score_chi2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=k)
    regions = ["20:1-30000000", "21:1000000-9000000", "20"]
    with ServeLoop(device=cuda) as loop:
        res = loop.query(truth.manifest, regions, cohort=True)
    for r, reg in zip(res, regions):
        c, _, span = reg.partition(":")
        beg, end = (map(int, span.split("-")) if span
                    else (1, 1 << 31))
        assert r.count == truth.slice_count(
            list(truth.contigs).index(c), beg, end)
