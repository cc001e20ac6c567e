"""The port's device decode plane functions against the JAX package's, on
the CPU: the native tokenize binding, LZ77 resolve + pack (K7+K8), the
record walk (K9), the fused fields/payload steps (with K1 and K10p),
``inflate_span_device`` and the shape helpers.  On CPU tensors the port
runs its kernels' plain versions; the JAX functions run as jitted XLA on
JAX CPU.  Inputs are made with numpy from seeds.

Tolerances: every output here is an integer or a byte, and must match
exactly."""
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.formats import bgzf as jbgzf
from hadoop_bam_tpu.ops import inflate_device as jid
from hadoop_bam_tpu.utils import native as jnative
from hadoop_bam_torch.formats import bgzf as tbgzf
from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.ops.inflate import inflate_span
from hadoop_bam_torch.synth import walk_cases
from hadoop_bam_torch.utils import native as tnative
from hadoop_bam_torch.utils.errors import PlanError


def _deflate(data: bytes, level=6, strategy=0) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return co.compress(data) + co.flush()


def _payload(kind: str, size: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if kind == "acgt":
        return rng.choice(np.frombuffer(b"ACGT", np.uint8), size).tobytes()
    if kind == "rle":
        return b"A" * size
    if kind == "qual":
        return rng.choice(np.frombuffer(b"FFFF:,#II", np.uint8),
                          size).tobytes()
    return rng.integers(0, 256, size, dtype=np.uint8).tobytes()


def _batch(payloads, strategy=0, level=6):
    comps = [_deflate(d, level, strategy) for d in payloads]
    src = np.frombuffer(b"".join(comps), np.uint8)
    off = np.cumsum([0] + [len(c) for c in comps[:-1]]).astype(np.int64)
    ln = np.array([len(c) for c in comps], np.int32)
    return src, off, ln


@pytest.mark.parametrize("with_crc", [False, True])
def test_tokenize_binding_matches_jax(with_crc):
    payloads = [_payload(k, s, i) for i, (k, s) in enumerate(
        [("acgt", 60000), ("rle", 65536), ("random", 3000), ("qual", 1),
         ("acgt", 0), ("qual", 40000)])]
    src, off, ln = _batch(payloads)
    got = tnative.deflate_tokenize_batch(src, off, ln, 1 << 16,
                                         with_crc=with_crc)
    want = jnative.deflate_tokenize_batch(src, off, ln, 1 << 16,
                                          with_crc=with_crc)
    assert len(got) == len(want) == 3 + with_crc
    for i, n in enumerate(want[1]):
        np.testing.assert_array_equal(got[0][i, :n], want[0][i, :n])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert [int(x) for x in got[2]] == [len(d) for d in payloads]
    if with_crc:
        assert [int(c) for c in got[3]] == [zlib.crc32(d) for d in payloads]


def test_tokenize_errors_match_jax():
    comp = bytearray(_deflate(b"ACGTN" * 5000))
    comp[10] ^= 0xFF
    cut = _deflate(_payload("acgt", 20000, 4))
    cases = [(bytes(comp), 1 << 16), (cut[:len(cut) // 2], 1 << 16),
             (_deflate(_payload("random", 5000, 1)), 64)]
    for comp, stride in cases:
        src = np.frombuffer(comp, np.uint8)
        args = (src, np.array([0], np.int64), np.array([src.size], np.int32),
                stride)
        with pytest.raises(ValueError) as got:
            tnative.deflate_tokenize_batch(*args)
        with pytest.raises(ValueError) as want:
            jnative.deflate_tokenize_batch(*args)
        assert str(got.value) == str(want.value)


def _chunk(P: int, kinds, B: int, seed: int, strategy=0, level=6):
    """Tokenized payloads of the given kinds, sizes near P, padded to B
    rows (n_tokens = isize = 0), with one empty block."""
    rng = np.random.default_rng(seed)
    payloads = [_payload(k, int(rng.integers(P // 2, P + 1)), seed + i)
                for i, k in enumerate(kinds)] + [b""]
    src, off, ln = _batch(payloads, strategy, level)
    toks, nt, ol = tnative.deflate_tokenize_batch(src, off, ln, P)
    tok = np.zeros((B, P), np.uint32)
    tok[:len(payloads)] = toks
    n = np.zeros(B, np.int32)
    n[:len(payloads)] = nt
    iz = np.zeros(B, np.int32)
    iz[:len(payloads)] = ol
    return payloads, tok, n, iz


@pytest.mark.parametrize("P", [1 << 10, 1 << 13, 1 << 16])
@pytest.mark.parametrize("mode", ["mixed", "fixed", "stored"])
def test_resolve_pack_matches_jax(P, mode):
    kinds = ["acgt", "rle", "random", "qual"]
    strategy = zlib.Z_FIXED if mode == "fixed" else 0
    level = 0 if mode == "stored" else 6
    payloads, tok, nt, iz = _chunk(P, kinds, 8, P, strategy, level)
    want = np.asarray(jid.resolve_tokens_packed(
        jnp.asarray(tok), jnp.asarray(nt), jnp.asarray(iz)))
    buf, total = tid.resolve_pack(*(torch.from_numpy(a)
                                    for a in (tok, nt, iz)))
    np.testing.assert_array_equal(buf.numpy(), want)
    assert int(total) == sum(len(d) for d in payloads)
    assert buf.numpy()[:int(total)].tobytes() == b"".join(payloads)
    # int32 bits of the same tokens give the same bytes
    got32, _ = tid.resolve_pack(*(torch.from_numpy(a) for a in (
        tok.view(np.int32), nt, iz)))
    np.testing.assert_array_equal(got32.numpy(), want)


def test_resolve_pack_narrow_token_rows_match_jax():
    """Rows of T < P tokens (the device plane ships only the columns in use)
    give the reference's resolve + pack at width P."""
    P = 1 << 16
    payloads, tok, nt, iz = _chunk(P, ["acgt", "qual", "rle", "acgt"], 8, 9)
    T = -(-int(nt.max()) // 256) * 256
    assert T < P
    blk = jid.resolve_tokens(jnp.asarray(tok[:, :T]), jnp.asarray(nt), P)
    want, _ = jid._pack_contiguous(blk, jnp.asarray(iz))
    buf, total = tid.resolve_pack(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (tok[:, :T], nt, iz)), P=P)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
    assert buf.numpy()[:int(total)].tobytes() == b"".join(payloads)


def test_resolve_clamps_isize_and_unpacked_rows_match_jax():
    """An ISIZE above P or below 0 clamps; the per-row resolve equals the
    JAX resolve_tokens on every byte of every block's length."""
    P = 1 << 13
    payloads, tok, nt, iz = _chunk(P, ["acgt", "qual", "rle"], 8, 5)
    iz_bad = iz.copy()
    iz_bad[0], iz_bad[1] = P + 100, -3
    want = np.asarray(jid.resolve_tokens_packed(
        jnp.asarray(tok), jnp.asarray(nt), jnp.asarray(iz_bad)))
    got, _ = tid.resolve_pack(*(torch.from_numpy(a)
                                for a in (tok, nt, iz_bad)))
    np.testing.assert_array_equal(got.numpy(), want)
    rows_j = np.asarray(jid.resolve_tokens(jnp.asarray(tok), jnp.asarray(nt),
                                           P))
    rows_t = tid.resolve_tokens_plain(torch.from_numpy(tok),
                                      torch.from_numpy(nt), P).numpy()
    for i, d in enumerate(payloads):
        assert rows_t[i, :len(d)].tobytes() == d
        np.testing.assert_array_equal(rows_t[i, :len(d)],
                                      rows_j[i, :len(d)])


@pytest.fixture(scope="module")
def bam_bytes(tmp_path_factory):
    """Inflated bytes of a synthetic BAM from its first record, and the
    BAM's path."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path_factory.mktemp("tid") / "w.bam")
    write_synthetic_bam(path, 4000, seed=3, chunk_pairs=1024)
    data, _ = inflate_span(open(path, "rb").read())
    _, voff = read_bam_header(path)
    return data[voff & 0xFFFF:], path


def _le32(a: np.ndarray, p: int) -> int:
    return int(a[p:p + 4].view("<i4")[0])


def _walk_case(name: str, data: np.ndarray):
    """(buf, total, start, stop, R) for one of the walk's rules."""
    L = 1 << 19
    buf = np.zeros(L, np.uint8)
    buf[:min(L, data.size)] = data[:L]
    total = int(min(L, data.size))
    second = 4 + _le32(buf, 0)
    third = second + 4 + _le32(buf, second)
    if name == "full":
        return buf, total, 0, L, 4096
    if name == "cut final record":
        return buf, third + 20, 0, L, 4096
    if name == "start past L":
        return buf, total, L + 3, L, 64
    if name == "stop mid-chunk":
        return buf, total, second, third + 1, 4096
    if name == "n_all over R":
        return buf, total, 0, L, 16
    if name == "bs < 32":
        bad = buf.copy()
        bad[third:third + 4] = np.frombuffer(np.int32(5).tobytes(), np.uint8)
        return bad, total, 0, L, 4096
    if name == "bs > L":
        big = buf.copy()
        big[second:second + 4] = np.frombuffer(np.int32(L + 1).tobytes(),
                                               np.uint8)
        return big, total, 0, L, 4096
    if name == "negative bs":
        neg = buf.copy()
        neg[third:third + 4] = np.frombuffer(np.int32(-7).tobytes(), np.uint8)
        return neg, total, 0, L, 4096
    assert name == "total past L"
    return buf, L + 2, 0, L, 4096


# the tiled walk's edge cases at the kernel's tile width
# (synth.walk_cases: chains written by synth.block_size_chain)
TILE_CASES = {c[0]: c[1:] for c in walk_cases(tid.walk_launch(1).W)}

WALK_CASES = ["full", "cut final record", "start past L", "stop mid-chunk",
              "n_all over R", "bs < 32", "bs > L", "negative bs",
              "total past L"] + list(TILE_CASES)


@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_matches_jax(bam_bytes, name):
    if name in TILE_CASES:
        buf, total, start, stop, R = TILE_CASES[name]
    else:
        buf, total, start, stop, R = _walk_case(name, bam_bytes[0])
    want = jid._walk_records_device(jnp.asarray(buf), jnp.int32(total),
                                    jnp.int32(start), jnp.int32(stop), R)
    got = tid.walk_records_device(torch.from_numpy(buf), total, start, stop,
                                  R)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert [int(x) for x in got[1:]] == [int(x) for x in want[1:]]
    if name == "bs < 32":
        assert int(got[3]) == 1
    if name == "n_all over R":
        assert int(got[1]) > R


def _bam_chunk(data: np.ndarray, n_blocks: int, P: int = 1 << 16):
    """The inflated BAM bytes as n_blocks BGZF-like blocks of P bytes,
    tokenized: (tokens, n_tokens, isize) padded to a power of two."""
    blocks = [data[i * P:(i + 1) * P].tobytes() for i in range(n_blocks)]
    src, off, ln = _batch(blocks)
    toks, nt, ol = tnative.deflate_tokenize_batch(src, off, ln, P)
    B = max(8, 1 << (n_blocks - 1).bit_length())
    tok = np.zeros((B, P), np.uint32)
    tok[:n_blocks] = toks
    pad = np.zeros(B, np.int32)
    n, iz = pad.copy(), pad.copy()
    n[:n_blocks], iz[:n_blocks] = nt, ol
    return tok, n, iz


@pytest.mark.parametrize("stop_frac", [1.0, 0.5])
def test_resolve_walk_fields_matches_jax(bam_bytes, stop_frac):
    data = bam_bytes[0]
    tok, nt, iz = _bam_chunk(data, 5)
    stop = int(iz.sum() * stop_frac)
    want = jid.resolve_walk_fields(jnp.asarray(tok), jnp.asarray(nt),
                                   jnp.asarray(iz), jnp.int32(0),
                                   jnp.int32(stop))
    got = tid.resolve_walk_fields(*(torch.from_numpy(a)
                                    for a in (tok, nt, iz)), 0, stop)
    valid = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), valid)
    assert valid.sum() > 100
    for k, col in want[0].items():
        np.testing.assert_array_equal(got[0][k].numpy()[valid],
                                      np.asarray(col)[valid], err_msg=k)
    assert [int(x) for x in got[2:]] == [int(x) for x in want[2:]]
    assert int(got[3]) < int(iz.sum())      # the final record is cut


@pytest.mark.parametrize("corrupt", [False, True])
def test_resolve_walk_payload_matches_jax(bam_bytes, corrupt):
    data = bam_bytes[0].copy()
    if corrupt:   # the 4th record's l_seq overruns its block_size
        p = 0
        for _ in range(3):
            p += 4 + _le32(data, p)
        data[p + 20:p + 24] = np.frombuffer(np.int32(5000).tobytes(),
                                            np.uint8)
    tok, nt, iz = _bam_chunk(data, 3)
    total = int(iz.sum())
    args = dict(max_len=160, seq_stride=96, qual_stride=160)
    want = jid.resolve_walk_payload(jnp.asarray(tok), jnp.asarray(nt),
                                    jnp.asarray(iz), jnp.int32(0),
                                    jnp.int32(total), **args)
    got = tid.resolve_walk_payload(*(torch.from_numpy(a)
                                     for a in (tok, nt, iz)), 0, total,
                                   **args)
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), valid)
    for k, col in want[0].items():
        np.testing.assert_array_equal(got[0][k].numpy()[valid],
                                      np.asarray(col)[valid], err_msg=k)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert [int(x) for x in got[4:]] == [int(x) for x in want[4:]]
    assert int(got[6]) == int(corrupt)


def test_payload_gather_plain_matches_reference_rules():
    """Edge rows of the segmented gather against the reference's jnp
    expressions (resolve_walk_payload :320-330): negative and huge
    lengths, offsets off both ends, rows past the count."""
    rng = np.random.default_rng(2)
    L, R = 5000, 64
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    offs = rng.integers(-100, L + 100, R).astype(np.int32)
    l_seq = rng.integers(-5, 300, R).astype(np.int32)
    l_seq[:3] = [2**31 - 1, 0, 161]
    rn = rng.integers(0, 256, R).astype(np.int32)
    nc = rng.integers(0, 9, R).astype(np.int32)
    n_all = 50
    b = jnp.asarray(buf)
    valid = jnp.arange(R) < n_all
    seq_off = jnp.asarray(offs) + 36 + jnp.asarray(rn) + 4 * jnp.asarray(nc)
    ls = jnp.asarray(l_seq)
    nb = (jnp.maximum(ls, 0) + 1) // 2
    use = jnp.where(valid, jnp.clip(ls, 0, 160), 0)
    js = jnp.arange(96)[None, :]
    want_s = jnp.where(js < ((use + 1) // 2)[:, None],
                       b[jnp.clip(seq_off[:, None] + js, 0, L - 1)], 0)
    jq = jnp.arange(160)[None, :]
    want_q = jnp.where(jq < use[:, None], b[jnp.clip(
        seq_off[:, None] + nb[:, None] + jq, 0, L - 1)], 0)
    got = tid.payload_gather(torch.from_numpy(buf), *(
        torch.from_numpy(a) for a in (offs, l_seq, rn, nc)), n_all, 160, 96,
        160)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_q))


def _bgzf(payload: bytes) -> bytes:
    import io
    sink = io.BytesIO()
    w = tbgzf.BGZFWriter(sink)
    w.write(payload)
    w.close()
    return sink.getvalue()


def test_inflate_span_device_matches_host_and_jax(monkeypatch):
    rng = random.Random(41)
    payload = bytes(rng.choice(b"ACGTNacgtn#!Fqual\t|")
                    for _ in range(300000)) + b"A" * 70000
    raw = _bgzf(payload)
    host, host_ub = inflate_span(raw, backend="zlib")
    dev, dev_ub = tid.inflate_span_device(raw, device="cpu")
    jdev, jdev_ub = jid.inflate_span_device(raw)
    assert dev.tobytes() == payload
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(dev_ub, host_ub)
    np.testing.assert_array_equal(dev_ub, jdev_ub)
    got, ub = inflate_span(raw, backend="device", device="cpu")
    np.testing.assert_array_equal(got, host)
    monkeypatch.setattr(tid, "SPAN_CHUNK_BLOCKS", 3)
    crc, _ = tid.inflate_span_device(raw, check_crc=True, device="cpu")
    np.testing.assert_array_equal(crc, host)


def test_inflate_span_device_crc_flip_needs_check_crc():
    raw = _bgzf(_payload("acgt", 30000, 3))
    from hadoop_bam_torch.ops.inflate import block_table
    t = block_table(raw)
    bad = bytearray(raw)
    bad[int(t["cdata_off"][0] + t["cdata_len"][0])] ^= 0xFF
    data, _ = tid.inflate_span_device(bytes(bad), device="cpu")
    assert data.tobytes() == _payload("acgt", 30000, 3)
    with pytest.raises(tbgzf.BGZFError, match="CRC32 mismatch"):
        tid.inflate_span_device(bytes(bad), check_crc=True, device="cpu")
    with pytest.raises(jbgzf.BGZFError, match="CRC32 mismatch"):
        jid.inflate_span_device(bytes(bad), check_crc=True)


def test_inflate_span_device_byte_flips_same_outcome_as_host():
    """A byte flipped anywhere in the span gives the same outcome on the
    device resolve as on the zlib host plane and the JAX device plane:
    the same bytes, or a BGZFError on all three."""
    rng = random.Random(9)
    raw = _bgzf(bytes(rng.choice(b"ACGT#F!") for _ in range(40000)))
    for pos in rng.sample(range(len(raw)), 12):
        bad = bytearray(raw)
        bad[pos] ^= 0xFF
        outcomes = []
        for run in (lambda: inflate_span(bytes(bad), backend="zlib"),
                    lambda: tid.inflate_span_device(bytes(bad),
                                                    device="cpu"),
                    lambda: jid.inflate_span_device(bytes(bad))):
            try:
                outcomes.append(("ok", run()[0].tobytes()))
            except (tbgzf.BGZFError, jbgzf.BGZFError):
                outcomes.append(("err",))
        assert outcomes[0] == outcomes[1] == outcomes[2], pos


def test_inflate_span_device_without_native_is_plan_error(monkeypatch):
    raw = _bgzf(b"ACGT" * 100)

    def broken():
        raise tnative.NativeBuildError("no g++")
    monkeypatch.setattr(tnative, "load", broken)
    with pytest.raises(PlanError):
        tid.inflate_span_device(raw, device="cpu")


def test_shape_helpers_match_jax():
    for x in (0, 1, 16, 1023, 1024, 1025, 8192, 8193, 65535, 65536):
        assert tid.ladder_pow2(x) == jid.ladder_pow2(x)
    for bad in ((1 << 16) + 1, 1 << 20):
        with pytest.raises(tbgzf.BGZFError):
            tid.ladder_pow2(bad)
    for B in (1, 8, 13, 32, 64):
        for P in tid.P_LADDER:
            assert tid.records_cap(B, P) == jid.records_cap(B, P)
    assert tid.records_cap(64, 1 << 16) == 131_072
    assert tid.BGZF_MAX_ISIZE == jid.BGZF_MAX_ISIZE
    assert tid.P_LADDER == jid.P_LADDER
    for L in (1, 36, 8192, 8193, 4 << 20, 64 << 16):
        lw = tid.walk_launch(L)
        assert lw.W == tid.WALK_W and lw.tiles == max(1, -(-L // lw.W))
        assert 4 ** lw.rounds >= lw.tiles
        assert lw.rounds == 0 or 4 ** (lw.rounds - 1) < lw.tiles
        assert lw.entries == lw.tiles * lw.W
    assert tid.walk_launch(64 << 16)[2:4] == (512, 5)


def test_probe_measures_each_plane():
    out = tid.probe_device_plane("cpu")
    assert out["device"] == "cpu"
    assert all(out[k] > 0 for k in ("tokenize_s", "resolve_s", "inflate_s"))
    assert out["device_wins"] == (max(out["tokenize_s"], out["resolve_s"])
                                  < out["inflate_s"])
