"""A numpy model of the clustered LZ77 resolve (K7+K8,
``csrc/lz77_resolve.cu``) held against the JAX package's
``resolve_tokens`` + ``_pack_contiguous`` on the CPU.

The model validates the kernel's design, not the kernel: only the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` run that.  It
takes the launch arithmetic from ``resolve_launch`` with the cluster
width C as a parameter and runs the kernel's phases:

- each CTA r of a row takes the r-th of C equal shares of the row's
  tokens; the CTAs' length totals are exchanged (each CTA's first output
  position is the sum of the earlier CTAs' totals); then in passes of
  ``threads * RESOLVE_TOKENS_PER_THREAD`` tokens, warp v takes 32 *
  RESOLVE_TOKENS_PER_THREAD of them, lane l the l-th of each round of
  32, and a lane scan a round and the rounds' and warps' totals place
  them;
- each token's bytes go to the segment that owns them (a source pointer
  and a literal per position), clipped to the row's size; a byte of a
  copy whose source lies inside the same copy points at the same byte of
  the period before it; bytes past the tokens' total take the last
  non-empty token;
- doubling inside each segment, where a pointer that leaves its segment
  stops, until a pass changes nothing; the positions with a root in the
  segment take its literal;
- in rank order: once segment k - 1's bytes are final, every later CTA
  holds them in its window (the row before its own segment); then CTA k
  reads each pointer that left in its window;
- the pack into 16-byte pieces with a head and a tail per segment, and
  the zero fill past the total in one stripe per CTA.

It also checks what the kernel relies on: every position below a row's
size gets a pointer, every pointer that leaves its segment lands in the
window, the tokens of more than 32 bytes fit the kernel's queue, the
local passes stay below log2(S) + 2, and the pieces and stripes cover
the buffer once.
Every output is a byte and must match exactly."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from hadoop_bam_tpu.ops import inflate_device as jid
from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.utils import native as tnative

CLUSTERS = [1, 2, 4, 8, 16]


def _pieces(addr: int, lo: int, hi: int):
    """The pack's pieces of positions [lo, hi) placed at address addr +
    position: (head positions, 16-byte aligned pieces, tail positions)."""
    a0 = min(hi, lo + (-(addr + lo)) % 16)
    n16 = (hi - a0) // 16
    return (range(lo, a0), [range(a0 + 16 * i, a0 + 16 * i + 16)
                            for i in range(n16)], range(a0 + 16 * n16, hi))


def cluster_resolve(tok: np.ndarray, nt: np.ndarray, isize: np.ndarray,
                    P: int, cluster: int, addr: int = 0):
    """The kernel's phases in numpy over [B, T] u32 tokens: ([B*P] u8
    buffer, total, {"local_passes", "left"}): the most local passes of
    a segment, and the pointers that left their segments."""
    B, T = tok.shape
    lr = tid.resolve_launch(B, T, P, cluster)
    C, S, NT = lr.C, lr.S, lr.threads
    K = tid.RESOLVE_TOKENS_PER_THREAD
    iz = np.clip(isize.astype(np.int64), 0, P)
    base = np.cumsum(iz) - iz
    total = int(iz.sum())
    out = np.full(B * P, 0xEE, np.uint8)   # junk where nothing writes
    # zero fill: one stripe of S bytes per CTA over the whole grid
    zeroed = np.zeros(B * P, np.int64)
    for g in range(B * C):
        zeroed[max(g * S, total):min((g + 1) * S, B * P)] += 1
    assert (zeroed[total:] == 1).all() and not zeroed[:total].any()
    out[total:] = 0
    stats = {"local_passes": 0, "left": 0}
    for b in range(B):
        if iz[b] == 0:
            continue          # pad rows: no token is read
        n = int(min(max(int(nt[b]), 0), T))
        w = tok[b].astype(np.int64)
        copy = (w >> 31) == 1
        ln = np.where(copy, (w >> 16) & 0x1FF, 1)
        ln[n:] = 0
        share = -(-n // C)
        # per CTA: the share's lengths summed and exchanged; then per pass
        # warp v takes 32 * K tokens, lane l the l-th of each round of 32:
        # a lane scan a round, the rounds' and warps' totals before it
        seg_len, seg_nz, starts = [], [], np.zeros(T, np.int64)
        for r in range(C):
            lo, hi = min(r * share, n), min((r + 1) * share, n)
            run = 0
            for p0 in range(lo, hi, NT * K):
                chunk = np.zeros(NT * K, np.int64)
                m = min(hi, p0 + NT * K) - p0
                chunk[:m] = ln[p0:p0 + m]
                rounds = chunk.reshape(NT // 32, K, 32)
                lane = np.cumsum(rounds, 2) - rounds
                rnd = rounds.sum(2)
                before_round = np.cumsum(rnd, 1) - rnd
                warp = rnd.sum(1)
                before_warp = np.cumsum(warp) - warp
                at = lane + before_round[:, :, None] + \
                    before_warp[:, None, None]
                starts[p0:p0 + m] = run + at.reshape(-1)[:m]
                run += int(chunk.sum())
                # tokens queued for a warp each: their clipped spans are
                # disjoint, so the queue never holds more than kQueue
                clipped = np.minimum(starts[p0:p0 + m] + ln[p0:p0 + m],
                                     iz[b]) - starts[p0:p0 + m]
                assert (clipped > 32).sum() <= (1 << 16) // 33 + 1
            seg_len.append(run)
            seg_nz.append(int((ln[lo:hi] > 0).sum()))
        cta_start = np.cumsum(seg_len) - seg_len
        row_total, row_nz = int(sum(seg_len)), int(sum(seg_nz))
        for r in range(C):
            lo, hi = min(r * share, n), min((r + 1) * share, n)
            starts[lo:hi] += cta_start[r]
        np.testing.assert_array_equal(starts[:n], np.cumsum(ln[:n]) - ln[:n])
        # writes to the owning segment, clipped to the row's size
        src = np.full(C * S, -1, np.int64)
        lit = np.zeros(C * S, np.uint8)
        end = np.minimum(starts[:n] + ln[:n], iz[b])
        cnt = np.maximum(end - starts[:n], 0)
        t_of = np.repeat(np.arange(n), cnt)
        pos = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt) \
            + starts[t_of]
        tail = np.arange(row_total, iz[b])
        if tail.size:
            last = min(max(row_nz - 1, 0), T - 1)
            t_of = np.concatenate([t_of, np.full(tail.size, last)])
            pos = np.concatenate([pos, tail])
        assert (pos // S < C).all()
        wb = w[t_of]
        cb = (wb >> 31) == 1
        d = (wb & 0xFFFF) + 1
        st = starts[t_of]
        if tail.size:
            st[-tail.size:] = tail            # no copy start: p - d
        periodic = cb & (pos - d >= st) & (st >= d)
        src[pos] = np.where(cb, np.where(periodic, st - d + (pos - st) % d,
                                         np.maximum(pos - d, 0)), pos)
        lit[pos] = np.where(cb, 0, wb & 0xFF)
        p_all = np.arange(iz[b])
        assert (src[p_all] >= 0).all() and (src[p_all] <= p_all).all()
        # doubling inside each segment; a pointer that leaves it stops
        seg = p_all // S
        s = src[p_all]
        passes = 0
        while True:
            passes += 1
            inside = s // S == seg
            s2 = np.where(inside, s[np.where(inside, s, 0)], s)
            if np.array_equal(s2, s):
                break
            s = s2
        assert passes <= int(np.log2(S)) + 2
        stats["local_passes"] = max(stats["local_passes"], passes)
        # every pointer is now a local root or leaves its segment; the
        # positions with a root here take its literal
        inside = s // S == seg
        assert (s[s[inside]] == s[inside]).all()
        final = np.zeros(iz[b], np.uint8)
        final[inside] = lit[s[inside]]
        # in rank order: CTA r reads its pointers that left in its window,
        # the final bytes of the row before its segment
        for r in range(1, C):
            lo, hi = r * S, min((r + 1) * S, iz[b])
            if lo >= hi:
                continue
            wlo = lo - lr.window
            out_ptrs = np.nonzero(~inside[lo:hi])[0] + lo
            e = s[out_ptrs]
            assert (e < lo).all() and (e >= wlo).all()
            stats["left"] += int(out_ptrs.size)
            final[out_ptrs] = final[e]
        # the pack: head, 16-byte pieces and tail of each segment
        packed = np.zeros(iz[b], np.int64)
        for r in range(C):
            lo, hi = r * S, min((r + 1) * S, iz[b])
            if lo >= hi:
                continue
            head, mid, tl = _pieces(addr + int(base[b]), lo, hi)
            for piece in [head, *mid, tl]:
                packed[list(piece)] += 1
        assert (packed == 1).all()
        out[base[b]:base[b] + iz[b]] = final
    return out, total, stats


def _jax(tok, nt, iz, P):
    blk = jid.resolve_tokens(jnp.asarray(tok), jnp.asarray(nt), P)
    buf, total = jid._pack_contiguous(blk, jnp.asarray(iz))
    return np.asarray(buf), int(total)


def _check(tok, nt, iz, P, cluster, addr=0):
    want, want_total = _jax(tok, nt, iz, P)
    got, total, stats = cluster_resolve(tok, nt, iz, P, cluster, addr)
    assert total == want_total
    np.testing.assert_array_equal(got, want)
    return got, stats


def _deflate(data: bytes, level=6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _tokenize(payloads, P, B, level=6):
    comps = [_deflate(d, level) for d in payloads]
    src = np.frombuffer(b"".join(comps), np.uint8)
    off = np.cumsum([0] + [len(c) for c in comps[:-1]]).astype(np.int64)
    ln = np.array([len(c) for c in comps], np.int32)
    toks, n, ol = tnative.deflate_tokenize_batch(src, off, ln, P)
    # pad rows hold junk tokens: the kernel reads none of them
    tok = np.random.default_rng(B).integers(0, 1 << 32, (B, P),
                                            dtype=np.uint64).astype(np.uint32)
    tok[:len(payloads)] = toks
    nt = np.zeros(B, np.int32)
    iz = np.zeros(B, np.int32)
    nt[:len(payloads)], iz[:len(payloads)] = n, ol
    return tok, nt, iz


@pytest.fixture(scope="module")
def bam_blocks(tmp_path_factory):
    """The inflated blocks of a small synthetic BAM."""
    from hadoop_bam_torch.formats import bgzf
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path_factory.mktemp("rc") / "r.bam")
    write_synthetic_bam(path, 3000, seed=4, chunk_pairs=500)
    raw = open(path, "rb").read()
    out, off = [], 0
    while off < len(raw):
        info = bgzf.parse_block_header(raw, off)
        out.append(zlib.decompress(
            raw[info.cdata_offset:info.cdata_offset + info.cdata_size],
            wbits=-15))
        off = info.next_coffset
    return [b for b in out if b]


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_model_on_bam_blocks_and_run_length_matches_jax(bam_blocks,
                                                        cluster):
    """BAM blocks, the 64 KiB run-length block (a dist-1 chain across
    every segment) and a pad row, at full width and as narrow rows."""
    P = 1 << 16
    payloads = bam_blocks[:3] + [b"A" * P]
    tok, nt, iz = _tokenize(payloads, P, 8)
    _, stats = _check(tok, nt, iz, P, cluster)
    if cluster > 1:
        assert stats["left"] > 0     # pointers do leave their segments
    T = -(-int(nt.max()) // 256) * 256
    assert T < P
    _check(np.ascontiguousarray(tok[:, :T]), nt, iz, P, cluster, addr=5)


@pytest.mark.parametrize("P", list(tid.P_LADDER))
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_model_on_each_rung_random_and_stored_matches_jax(P, cluster):
    """Random, A/C/G/T and quality-like blocks, deflated and stored, an
    empty block, ISIZEs above P and below 0, on every rung of P."""
    rng = np.random.default_rng(P + cluster)
    payloads = [rng.integers(0, 256, P, dtype=np.uint8).tobytes(),
                rng.choice(np.frombuffer(b"ACGT", np.uint8), P).tobytes(),
                rng.choice(np.frombuffer(b"FF:,#I", np.uint8),
                           P - 7).tobytes(), b""]
    for level in (6, 0):
        tok, nt, iz = _tokenize(payloads, P, 8, level)
        _check(tok, nt, iz, P, cluster)
        iz_bad = iz.copy()
        iz_bad[0], iz_bad[1] = P + 100, -3
        _check(tok, nt, iz_bad, P, cluster, addr=11)


def _row(pieces, P):
    """A token row from ("lit", n) / ("copy", length, dist) pieces."""
    out = []
    for piece in pieces:
        if piece[0] == "lit":
            out += [ord("a") + i % 26 for i in range(piece[1])]
        else:
            _, length, dist = piece
            out.append((1 << 31) | (length << 16) | (dist - 1))
    tok = np.zeros(P, np.uint32)
    tok[:len(out)] = out
    size = sum(p[1] for p in pieces)
    return tok, len(out), size


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_model_boundary_tokens_and_tail_rule_match_jax(cluster):
    """Copies that straddle a segment boundary and one that ends exactly
    on it, 258-byte copies, rows whose tokens end before the row's size
    (the tail takes the last token, a copy or a literal), and a row with
    no tokens at all, at P = 1,024 (segments of 64-1,024 bytes)."""
    P = 1 << 10
    S = tid.resolve_launch(8, P, P, cluster).S
    S = S if S < P else P // 2       # one segment: a boundary inside it
    rows = [
        [("lit", S - 3), ("copy", 10, 7), ("lit", 2), ("copy", 258, 1)],
        [("lit", S - 6), ("copy", 6, 3), ("lit", 5), ("copy", 258, 200)],
        [("lit", 40), ("copy", 258, 40), ("copy", 258, 258),
         ("copy", 258, 1), ("copy", 200, 3)],
        [("lit", 17), ("copy", 30, 17)],      # tail after a copy
        [("lit", 70)],                        # tail after a literal
    ]
    tok = np.zeros((8, P), np.uint32)
    nt = np.zeros(8, np.int32)
    iz = np.zeros(8, np.int32)
    for i, pieces in enumerate(rows):
        tok[i], nt[i], size = _row(pieces, P)
        iz[i] = min(size, P)
    iz[3], iz[4] = 900, 1000                 # past the tokens' total
    nt[5], iz[5] = 0, 300                    # no tokens: token 0 repeats
    tok[5, 0] = ord("z")
    _check(tok, nt, iz, P, cluster)
    _check(tok, nt, iz, P, cluster, addr=15)


def test_resolve_launch_arithmetic():
    """Segments cover P once, the window holds DEFLATE's 32 KiB reach (or
    every earlier segment), the shared memory fits a block, the cluster
    is at most 16 CTAs, each thread owns at most 64 positions, and bad
    shapes are refused."""
    for P in (1, 63, 64, 65, 1000, 1 << 10, 5000, 1 << 13, 65535, 1 << 16):
        for cluster in CLUSTERS:
            lr = tid.resolve_launch(32, 999, P, cluster)
            assert lr.C * lr.S >= P > (lr.C - 1) * lr.S
            assert lr.S & (lr.S - 1) == 0 and lr.S >= tid.RESOLVE_MIN_SEGMENT
            assert 1 <= lr.C <= cluster <= 16
            assert lr.window == (lr.C - 1) * lr.S
            # beside the kernel's 16,704 static bytes (ptxas), within the
            # 232,448 bytes an H100 block may hold
            assert lr.smem == 3 * lr.S + lr.window <= 232_448 - 16_704
            assert lr.threads % 32 == 0 and 64 <= lr.threads <= 1024
            assert lr.S % lr.threads == 0 and lr.S // lr.threads <= 64
            assert lr.tokens == -(-999 // lr.C)
    lr = tid.resolve_launch(32, 29952, 1 << 16)
    assert (lr.C, lr.S, lr.threads, lr.tokens, lr.window, lr.smem) == (
        tid.RESOLVE_CLUSTER, 16384, 1024, 7488, 49152, 98304)
    # the widest cluster whose CTAs the card holds in one wave
    assert tid.resolve_launch(64, 65536, 1 << 16).C == 2
    for B in (8, 32, 64, 128):
        for P in tid.P_LADDER:
            lr = tid.resolve_launch(B, P, P)
            assert lr.C in (2, tid.RESOLVE_CLUSTER)
            assert lr.C == 2 or B * lr.C * lr.threads <= \
                tid.RESOLVE_WAVE_THREADS
    for bad in ((0, 8, 64, 8), (8, 0, 64, 8), (8, 8, 0, 8),
                (8, 8, 65537, 8), (8, 8, 64, 3), (8, 8, 64, 32)):
        with pytest.raises(ValueError):
            tid.resolve_launch(*bad)
