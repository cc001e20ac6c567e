"""A numpy model of the payload gather (K10p, ``csrc/payload_gather.cu``)
held against the port's plain version and the JAX package's expressions
(``resolve_walk_payload`` :319-331) on the CPU.

The model runs the kernel's partition of the work with the addresses of
``buf`` and of both tiles as parameters (only their residues mod 16
matter), so that misaligned views and odd strides are cheap to build:

- the one-wave grid of ``payload_launch`` and each CTA's share, its
  warps split by role: row pairs spread over the live warps of the whole
  grid (CTA-minor), two rows a warp, one lane a 16-byte output piece;
  the zero stream over the zero warps;
- each live piece's fast-path test: its source bytes inside the
  16-byte-aligned interior of ``buf`` and no int32 index sum wrapped;
- the fast path's assembly of a piece from one or two aligned 16-byte
  words with ``__funnelshift_r`` and a byte mask, the other pieces byte
  by byte with the reference's clamp;
- the zero stream: rows [n_valid, R) of each tile as one byte range,
  split into an unaligned head, aligned 16-byte words walked grid-stride
  over one flat index space for both tiles, and an unaligned tail.

It also checks what the kernel relies on: a fast load never leaves
``buf``, every byte of both tiles is written exactly once, and the
shares of the grid are balanced.  Every output is a byte and must match
exactly."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.ops.unpack_bam import unpack_fixed_fields_plain
from hadoop_bam_torch.synth import PAYLOAD_CASES, payload_rows

INT32_MAX = (1 << 31) - 1
# the kernel's warps of a CTA that stream zeros, and its edge threads
# (kZeroWarps, kEdgeThreads in csrc/payload_gather.cu)
ZERO_WARPS = 1
EDGE_THREADS = 64


def _i32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def funnelshift_r(lo: int, hi: int, sh: int) -> int:
    return (((hi << 32) | lo) >> (sh & 31)) & 0xFFFFFFFF


def assemble(x: bytes, y: bytes, s: int, c: int) -> bytes:
    """The kernel's ``assemble``: bytes [s, s + 16) of x:y (32 bytes),
    the first c kept, from u32 words picked by s >> 2 and funnel-shifted
    by 8 * (s & 3)."""
    w = [int.from_bytes(x[i:i + 4] if i < 16 else y[i - 16:i - 12],
                        "little") for i in range(0, 32, 4)]
    q, sh = s >> 2, (s & 3) * 8
    a = [w[i + q] for i in range(5)]
    out = b""
    for i in range(4):
        n = min(max(c - 4 * i, 0), 4)
        m = 0xFFFFFFFF if n == 4 else (1 << (8 * n)) - 1
        out += (funnelshift_r(a[i], a[i + 1], sh) & m).to_bytes(4, "little")
    return out


def split_range(start: int, end: int):
    """(head end, tail start) of the byte range [start, end) in addresses:
    head [start, body), aligned body [body, tail), tail [tail, end)."""
    up, down = (start + 15) & ~15, end & ~15
    body = up if up <= end else end
    return body, down if down >= body else body


def model_gather(buf, offs, l_seq, rn, nc, n_all, max_len, S, Q,
                 base=0, seq_base=0, qual_base=0, sms=132):
    """The kernel in numpy: (seq, qual tiles, {"fast": pieces on the fast
    path, "bytes": pieces byte by byte}, per-CTA work counts).  ``base``,
    ``seq_base`` and ``qual_base`` are the addresses of buf and of the
    tiles."""
    L, R = buf.size, offs.size
    raw = buf.tobytes()
    lp = tid.payload_launch(R, S, Q, sms)
    grid, threads = lp
    warps = grid * (threads // 32 - ZERO_WARPS)
    n_valid = min(max(int(n_all), 0), R)
    seq = np.full((R, S), 0xAB, np.uint8)
    qual = np.full((R, Q), 0xAB, np.uint8)
    written = [np.zeros(R * S, np.int64), np.zeros(R * Q, np.int64)]
    vec = S % 16 == 0 and Q % 16 == 0 and seq_base % 16 == 0 \
        and qual_base % 16 == 0
    in_lo = ((base + 15) & ~15) - base
    in_hi = ((base + L) & ~15) - base
    seq_pieces = -(-S // 16)
    pieces = seq_pieces + -(-Q // 16)
    counts = {"fast": 0, "bytes": 0}
    cta_work = np.zeros(grid, np.int64)
    for w in range(warps):
        cta, p = w % grid, w
        # the kernel's loop: p from (warp - ZERO_WARPS) * grid + cta, step
        # the live warps of the grid
        while p < (n_valid + 1) // 2:
            for half in range(2):
                r = 2 * p + half
                if r >= n_valid:
                    break
                cta_work[cta] += 1
                ls = int(l_seq[r])
                use = min(max(ls, 0), max_len)
                seq_off = _i32(int(offs[r]) + 36 + int(rn[r])
                               + _i32(int(nc[r]) * 4))
                nb = _i32(max(ls, 0) + 1) >> 1
                for k in range(pieces):
                    is_seq = k < seq_pieces
                    j0 = (k if is_seq else k - seq_pieces) * 16
                    frm = seq_off if is_seq else _i32(seq_off + nb)
                    limit = (use + 1) >> 1 if is_seq else use
                    c = min(max(limit - j0, 0), 16)
                    v = bytes(16)
                    if c > 0:
                        i0 = frm + j0
                        if in_lo <= i0 and i0 + c <= in_hi \
                                and i0 + c - 1 <= INT32_MAX:
                            s = (base + i0) & 15
                            a = i0 - s
                            assert 0 <= a and a + 16 <= L
                            x = raw[a:a + 16]
                            y = bytes(16)
                            if s + c > 16:
                                assert a + 32 <= L
                                y = raw[a + 16:a + 32]
                            v = assemble(x, y, s, c)
                            counts["fast"] += 1
                        else:
                            v = bytes(raw[min(max(_i32(frm + j0 + i), 0),
                                              L - 1)] if i < c else 0
                                      for i in range(16))
                            counts["bytes"] += 1
                    tile, width, t = (seq, S, 0) if is_seq else (qual, Q, 1)
                    if vec:
                        assert j0 + 16 <= width
                    n = min(16, width - j0)
                    tile[r, j0:j0 + n] = np.frombuffer(v[:n], np.uint8)
                    written[t][r * width + j0:r * width + j0 + n] += 1
            p += warps
    # the zero stream, in addresses
    ranges = []
    for t, (tb, width) in enumerate(((seq_base, S), (qual_base, Q))):
        start, end = tb + n_valid * width, tb + R * width
        body, tail = split_range(start, end)
        assert body % 16 == 0 and tail % 16 == 0 or body == tail
        assert body - start <= 15 and end - tail <= 15
        ranges.append((tb, start, body, tail, end))
    ns = (ranges[0][3] - ranges[0][2]) // 16
    nw = ns + (ranges[1][3] - ranges[1][2]) // 16
    zt = 32 * ZERO_WARPS
    step = grid * zt
    wi = np.arange(nw, dtype=np.int64)
    cta_work += np.bincount((wi % step) // zt, minlength=grid)
    for t, sel, first in ((0, wi < ns, 0), (1, wi >= ns, ns)):
        tb, _, body, _, _ = ranges[t]
        at = body - tb + 16 * (wi[sel] - first)
        for i in range(16):
            np.add.at(written[t], at + i, 1)
    # 64 edge slots walked grid-stride by the zero threads: seq head, seq
    # tail, qual head, qual tail
    for e in range(EDGE_THREADS):
        tb, start, body, tail, end = ranges[e >> 5]
        k = e & 15
        d, stop = (tail + k, end) if e & 16 else (start + k, body)
        if d < stop:
            written[e >> 5][d - tb] += 1
    for t, tile in ((0, seq), (1, qual)):
        flat = tile.reshape(-1)
        flat[n_valid * tile.shape[1]:] = 0
        assert (written[t] == 1).all(), "every byte written exactly once"
    return seq, qual, counts, cta_work


def reference_tiles(buf, offs, l_seq, rn, nc, n_all, max_len, S, Q):
    """The reference's jnp expressions (resolve_walk_payload :319-331)."""
    L, R = buf.size, offs.size
    b = jnp.asarray(buf)
    valid = jnp.arange(R) < jnp.minimum(jnp.int32(n_all), R)
    seq_off = (jnp.asarray(offs) + 36 + jnp.asarray(rn)
               + 4 * jnp.asarray(nc))
    ls = jnp.asarray(l_seq)
    nb = (jnp.maximum(ls, 0) + 1) // 2
    use = jnp.where(valid, jnp.clip(ls, 0, max_len), 0)
    js = jnp.arange(S, dtype=jnp.int32)[None, :]
    seq = jnp.where(js < ((use + 1) // 2)[:, None],
                    b[jnp.clip(seq_off[:, None] + js, 0, L - 1)],
                    jnp.uint8(0))
    jq = jnp.arange(Q, dtype=jnp.int32)[None, :]
    qual = jnp.where(jq < use[:, None], b[jnp.clip(
        seq_off[:, None] + nb[:, None] + jq, 0, L - 1)], jnp.uint8(0))
    return np.asarray(seq), np.asarray(qual)


def _plain(buf, offs, l_seq, rn, nc, n_all, max_len, S, Q):
    got = tid.payload_gather(torch.from_numpy(buf), *(
        torch.from_numpy(a) for a in (offs, l_seq, rn, nc)), n_all, max_len,
        S, Q)
    return got[0].numpy(), got[1].numpy()


@pytest.mark.parametrize("name", PAYLOAD_CASES)
@pytest.mark.parametrize("strides", [(96, 160), (17, 33)])
@pytest.mark.parametrize("bases", [(0, 0, 0), (3, 0, 0), (13, 5, 9)])
def test_model_matches_plain_and_reference(name, strides, bases):
    """Edge rows at both strides, with buf's address off 16 bytes (a view
    such as buf[3:]) and the tiles' addresses off 16 bytes."""
    S, Q = strides
    L, R, n_all = 3000, 96, 90
    args = payload_rows(name, L, R, seed=len(name) + S)
    base, sb, qb = bases
    seq, qual, counts, _ = model_gather(*args, n_all, 160, S, Q, base, sb,
                                        qb, sms=2)
    want = _plain(*args, n_all, 160, S, Q)
    ref = reference_tiles(*args, n_all, 160, S, Q)
    for got, w, r in zip((seq, qual), want, ref):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, r)
    if name != "int32 wrap":
        assert counts["fast"] > 0
    if name != "l_seq above max_len":
        assert counts["bytes"] > 0


@pytest.mark.parametrize("n_all", [-1, 0, 1, 64, 71])
def test_model_n_all_edges(n_all):
    """n_all below 0, at 0 and 1, at R and past it: rows past the clamped
    count are zero, every byte written once."""
    L, R = 3000, 64
    args = payload_rows("random", L, R, seed=9)
    for S, Q, sb in ((96, 160, 0), (17, 33, 7)):
        seq, qual, _, _ = model_gather(*args, n_all, 160, S, Q, 0, sb, sb,
                                       sms=132)
        want = _plain(*args, n_all, 160, S, Q)
        ref = reference_tiles(*args, n_all, 160, S, Q)
        for got, w, r in zip((seq, qual), want, ref):
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, r)
        nv = min(max(n_all, 0), R)
        assert not seq[nv:].any() and not qual[nv:].any()


@pytest.fixture(scope="module")
def bam_chunk(tmp_path_factory):
    """A synthetic BAM's inflated bytes in a 512 KiB buffer, the walk's
    offsets at R = 8192 rows and K1's columns there (plain versions)."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.ops.inflate import inflate_span
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path_factory.mktemp("k10p") / "m.bam")
    write_synthetic_bam(path, 3000, seed=8, chunk_pairs=1024)
    data, _ = inflate_span(open(path, "rb").read())
    _, voff = read_bam_header(path)
    data = data[voff & 0xFFFF:]
    L, R = 1 << 19, 8192
    buf = np.zeros(L, np.uint8)
    buf[:min(L, data.size)] = data[:L]
    b = torch.from_numpy(buf)
    offs, n_all, _, _ = tid.walk_records_device_plain(
        b, min(L, data.size), 0, L, R)
    cols = unpack_fixed_fields_plain(b, offs)
    return (buf, offs.numpy(), cols["l_seq"].numpy(),
            cols["l_read_name"].numpy(), cols["n_cigar"].numpy(),
            int(n_all))


@pytest.mark.parametrize("base", [0, 3])
def test_model_on_bam_chunk(bam_chunk, base):
    """A chunk of real records at the default payload geometry: all live
    pieces take the fast path, the shares of the grid are balanced, and
    the tiles equal plain and the reference."""
    *args, n_all = bam_chunk
    assert 1000 < n_all < 8192
    seq, qual, counts, cta_work = model_gather(*args, n_all, 160, 96, 160,
                                               base, sms=132)
    want = _plain(*args, n_all, 160, 96, 160)
    ref = reference_tiles(*args, n_all, 160, 96, 160)
    for got, w, r in zip((seq, qual), want, ref):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, r)
    assert counts["bytes"] == 0 and counts["fast"] > 10 * n_all
    # live rows, then zero words: no CTA's share is far from the mean
    assert cta_work.max() <= 2 * cta_work.mean() + 32


@pytest.mark.parametrize("R,S,Q,sms,grid", [
    (131_072, 96, 160, 132, 528),       # the 64-block chunk: one wave
    (65_536, 96, 160, 132, 528),        # the main path's 17-block chunk
    (64, 96, 160, 132, 4),              # 16 KiB of tiles: 4 CTAs
    (4096, 17, 33, 2, 8),               # a small card
    (1, 0, 0, 132, 1),
])
def test_payload_launch_arithmetic(R, S, Q, sms, grid):
    lp = tid.payload_launch(R, S, Q, sms)
    assert lp == (grid, tid.PAYLOAD_THREADS)


def test_launch_constants_match_kernel_source():
    """PAYLOAD_THREADS and PAYLOAD_CTAS_PER_SM are the kernel's kThreads
    and kMinBlocks (its launch bounds); the model's roles are its own."""
    src = open(os.path.join(os.path.dirname(tid.__file__), os.pardir,
                            "csrc", "payload_gather.cu")).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == tid.PAYLOAD_THREADS
    assert int(consts["kMinBlocks"]) == tid.PAYLOAD_CTAS_PER_SM
    assert int(consts["kEdgeThreads"]) == EDGE_THREADS
    assert int(consts["kZeroWarps"]) == ZERO_WARPS
    assert "__launch_bounds__(kThreads, kMinBlocks)" in src


def test_wrapper_gathers_from_a_strided_cpu_buf():
    """A strided CPU buf takes the plain version, which indexes it as it
    is: the tiles equal those of the same bytes made contiguous.  Only the
    card's kernel needs contiguous bytes (the wrapper refuses a strided
    CUDA buf)."""
    L, R = 3000, 64
    buf, *cols = payload_rows("random", L, R, seed=1)
    b = torch.from_numpy(np.repeat(buf, 2))[::2]
    assert not b.is_contiguous()
    cols = [torch.from_numpy(a) for a in cols]
    got = tid.payload_gather(b, *cols, R - 3, 160, 96, 160)
    args = (buf, *(c.numpy() for c in cols), R - 3, 160, 96, 160)
    for g, w, r in zip(got, _plain(*args), reference_tiles(*args)):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), r)
