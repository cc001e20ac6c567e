"""A numpy model of the interval columns (K10i, ``csrc/interval_cols.cu``)
held against the JAX package's formula (``resolve_walk_intervals``
:359-386, its prefix gather included) and the port's plain version, on
the CPU.

The model runs the kernel's partition of the work with buf's address
mod 16 as a parameter (only its residue matters):

- the grid of ceil(R / 256) CTAs of 256 threads; eight lanes a record,
  32 records a CTA a pass, records spread over the grid's sub-warps
  (grid-stride);
- lanes 0-4's prefix words: one or two aligned 32-bit loads and
  ``__funnelshift_r`` where the four bytes lie in buf, else byte loads
  with the reference's clip;
- the CIGAR: the sub-warp's fast-path test (the window and its aligned
  words inside buf), lane j's words j, j + 8, ... in batches of 64
  words, each lane's uint32 sum and the sub-warp's sum of them mod 2^32
  (``__reduce_add_sync``); off the fast path each word as a prefix word;
- the pad rows: whole quads as int4 stores from the grid's last threads
  backwards, a partial quad at either end by one thread;
- ``over`` through the per-stream counter word, the CTAs counting
  themselves in in any order.

It also checks what the kernel relies on: a fast load never leaves buf,
every row of the three columns is written exactly once, and the counter
word is zero again after a launch.  Every output is an integer and must
match exactly."""
import numpy as np
import pytest
import torch

from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.synth import interval_rows
from test_torch_serve_tiles import _chunks, _jax_interval_formula

THREADS, LANES, STEPS = 256, 8, 8     # kThreads, kLanes, kSteps
GROUPS = THREADS // LANES
CAP = tid.DEVICE_TILE_CIGAR_CAP
I32_MAX = (1 << 31) - 1
U32 = (1 << 32) - 1


def _i32(a):
    return (np.asarray(a, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def funnelshift_r(lo, hi, sh):
    return (((hi << 32) | lo) >> sh) & U32


def load32(buf, idx):
    """Aligned 32-bit loads at byte indices ``idx``; each must lie in
    buf (the kernel's fast loads never leave it)."""
    idx = np.asarray(idx, np.int64)
    assert ((idx >= 0) & (idx + 4 <= buf.size)).all(), "a load left buf"
    b = buf[idx[..., None] + np.arange(4)].astype(np.int64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def bytes_word(buf, b):
    """The four bytes at int32 indices b + j, each clipped to buf."""
    out = np.zeros(np.shape(b), np.int64)
    for j in range(4):
        idx = np.clip(_i32(np.asarray(b, np.int64) + j), 0, buf.size - 1)
        out |= buf[idx].astype(np.int64) << (8 * j)
    return out


def _aligned(base, s):
    """(aligned word's byte index, funnel shift) of int32 index s."""
    addr = base + s
    return (addr & ~3) - base, (addr & 3) * 8


def word_at(buf, base, b):
    """The kernel's ``word_at`` over an array of uint32 indices: (words,
    which took the aligned loads)."""
    b = np.asarray(b, np.int64)
    s = _i32(b)
    p, sh = _aligned(base, s)
    fast = ((s >= 0) & (s + 4 <= buf.size) & (p >= 0)
            & ((sh == 0) | (p + 8 <= buf.size)))
    out = bytes_word(buf, b)
    if fast.any():
        lo = load32(buf, p[fast])
        hi = np.zeros_like(lo)
        two = sh[fast] != 0
        hi[two] = load32(buf, p[fast][two] + 4)
        out[fast] = funnelshift_r(lo, hi, sh[fast])
    return out, fast


def ref_len(word):
    op = word & 0xF
    return np.where(np.isin(op, (0, 2, 3, 7, 8)), word >> 4, 0)


def grid(R):
    return max(1, -(-R // THREADS))


def cigar_sums(buf, base, c, nw, cap):
    """Each record's eight lane sums (uint32) of its CIGAR at uint32 index
    c, and whether its sub-warp took the fast path."""
    n = c.size
    s = _i32(c)
    p, sh = _aligned(base, s)
    fast = ((nw > 0) & (s >= 0) & (s + 4 * nw <= buf.size) & (p >= 0)
            & (p + 4 * (nw + (sh != 0)) <= buf.size))
    width = -(-max(cap, 1) // LANES) * LANES
    k = np.arange(width, dtype=np.int64)[None, :]
    act = k < nw[:, None]
    word = np.zeros((n, width), np.int64)
    f = act & fast[:, None]
    if f.any():
        rows, ks = np.nonzero(f)
        lo = load32(buf, p[rows] + 4 * ks)
        hi = np.zeros_like(lo)
        two = sh[rows] != 0
        hi[two] = load32(buf, p[rows][two] + 4 * ks[two] + 4)
        word[rows, ks] = funnelshift_r(lo, hi, sh[rows])
    slow = act & ~fast[:, None]
    if slow.any():
        rows, ks = np.nonzero(slow)
        word[rows, ks], _ = word_at(buf, base, (c[rows] + 4 * ks) & U32)
    # lane j holds words j, j + 8, ...: batches of kSteps words a lane
    lanes = np.where(act, ref_len(word), 0).reshape(n, width // LANES, LANES)
    return lanes.sum(1) & U32, fast


def model_interval_cols(buf, offs, n_all, cap=CAP, base=0, order=None,
                        done=0):
    """The kernel in numpy: (rid, pos1, end1, over, info), ``order`` the
    order the CTAs count themselves in (default: by index), ``done`` the
    stream's counter word before the launch (the kernel needs 0)."""
    buf = np.asarray(buf, np.uint8)
    offs = np.asarray(offs, np.int64)
    R = offs.size
    G = grid(R)
    nv = max(0, min(int(n_all), R))
    rid = np.zeros(R, np.int64)
    pos1 = np.zeros(R, np.int64)
    end1 = np.zeros(R, np.int64)
    writes = np.zeros(R, np.int64)

    # valid rows: record r on sub-warp r mod (G * 32), pass r // (G * 32)
    r = np.arange(nv)
    cta = (r % (G * GROUPS)) // GROUPS
    o = offs[:nv] & U32
    pw = np.zeros((nv, 5), np.int64)
    pfast = np.zeros((nv, 5), bool)
    for j in range(5):
        pw[:, j], pfast[:, j] = word_at(buf, base, (o + 4 + 4 * j) & U32)
    nc = pw[:, 3] & 0xFFFF
    nw = np.minimum(nc, cap)
    c = (o + 36 + (pw[:, 2] & 0xFF)) & U32
    lanes, cfast = cigar_sums(buf, base, c, nw, cap)
    span = lanes.sum(1) & U32          # __reduce_add_sync over the sub-warp
    ls = _i32(pw[:, 4])
    ref = np.where(nc > 0, _i32(span), np.maximum(ls, 0))
    pos = _i32(pw[:, 1])
    p1 = np.minimum(pos, I32_MAX - 1) + 1
    room = _i32((I32_MAX - p1) & U32)
    m = np.minimum(np.maximum(ref, 1) - 1, room)
    rid[:nv], pos1[:nv], end1[:nv] = _i32(pw[:, 0]), p1, _i32((p1 + m) & U32)
    writes[:nv] += 1

    # pad rows: quad q from thread T - 1 - ((q - q_lo) mod T)
    T = G * THREADS
    q_lo, q_hi = (nv + 3) // 4, R // 4
    q = np.arange(q_lo, max(q_lo, q_hi))
    pad_cta = (T - 1 - (q - q_lo) % T) // THREADS
    for i in range(4):
        writes[4 * q + i] += 1
    head = np.arange(nv, min(4 * q_lo, R))
    tail = np.arange(max(4 * q_hi, 4 * q_lo), R)
    writes[head] += 1
    writes[tail] += 1
    assert (writes == 1).all(), "a row written other than once"
    rid[nv:] = -1

    # over: each CTA adds 1 + (saw an over-cap row) << 32 to the word
    saw = np.zeros(G, bool)
    saw[cta[nc > cap]] = True
    over = None
    for b in (range(G) if order is None else order):
        old = done
        done = (done + 1 + (int(saw[b]) << 32)) % (1 << 64)
        if old & U32 == G - 1:
            over = int((old >> 32) != 0 or saw[b])
            done = 0
    info = {"grid": G, "passes": -(-nv // (G * GROUPS)), "done": done,
            "walk_ctas": np.unique(cta), "pad_ctas": np.unique(pad_cta),
            "prefix_fast": pfast, "cigar_fast": cfast, "nw": nw,
            "lanes": lanes, "span": span}
    return (rid.astype(np.int32), pos1.astype(np.int32),
            end1.astype(np.int32), over, info)


def _check(buf, offs, n_all, cap=CAP, base=0, **kw):
    """The model against the JAX formula and the port's plain version."""
    got = model_interval_cols(buf, offs, n_all, cap, base, **kw)
    want = _jax_interval_formula(buf, offs, n_all, cap)
    plain = tid.interval_cols_plain(torch.from_numpy(buf),
                                    torch.from_numpy(offs), n_all, cap)
    for g, w, p in zip(got[:4], want, plain):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    assert got[4]["done"] == 0
    return got[4]


@pytest.mark.parametrize("R,n_all,base", [
    (16, -1, 0), (16, 0, 1), (16, 5, 2), (16, 16, 3), (16, 40, 0),
    (16_384, 3, 1), (16_384, 806, 0), (16_384, 16_384, 3),
    (131_072, 15_000, 0), (131_072, 131_079, 2)])
def test_model_matches_reference_on_records(R, n_all, base):
    """``synth.interval_rows`` (records at every residue mod 4, CIGARs of
    random words, n_cigar 0 to 65, the edge rows) at the serve chunk's R,
    the 64-block chunk's and the least; n_all -1, 0, in between and past
    R (eight passes of the grid at 131,072 rows)."""
    buf, offs, edges = interval_rows(24 * R + 4096, R, seed=R + base,
                                     over=True)
    info = _check(buf, offs, n_all, base=base)
    nv = max(0, min(n_all, R))
    assert info["grid"] == max(1, R // THREADS)
    assert info["passes"] == -(-nv // (R // LANES if R >= THREADS
                                       else GROUPS))
    if nv == R == 131_072:
        assert info["passes"] == 8
    # the records inside buf take the aligned loads
    normal = np.ones(nv, bool)
    for rows in edges.values():
        normal[rows[rows < nv]] = False
    assert info["prefix_fast"][normal].all()
    walked = normal & (info["nw"] > 0)
    assert info["cigar_fast"][walked].all()


@pytest.mark.parametrize("residue", range(4))
@pytest.mark.parametrize("base", range(4))
def test_every_alignment_takes_the_aligned_loads(residue, base):
    """Prefixes at each residue mod 4 and CIGARs at every residue
    (l_read_name 0-3), with buf's address at each residue mod 16."""
    rng = np.random.default_rng(16 * residue + base)
    L, R = 1 << 14, 64
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    offs = (64 + 200 * np.arange(R) + residue).astype(np.int64)
    for i, o in enumerate(offs):
        buf[o + 12] = i % 4                       # l_read_name
        buf[o + 16:o + 18] = [CAP - i % 9, 0]     # n_cigar
    info = _check(buf, offs.astype(np.int32), R, base=base)
    assert info["prefix_fast"].all() and info["cigar_fast"].all()


@pytest.mark.parametrize("nw", [8, 33, 64])
def test_subwarp_sums_wrap_int32(nw):
    """M ops of length 2^28 - 1: the reference's int32 sum wraps past
    2^31 and the lanes' uint32 sums, added mod 2^32, give its value."""
    L = 4096
    buf = np.zeros(L, np.uint8)
    offs = np.array([100, 1003], np.int32)
    word = ((1 << 28) - 1) << 4                  # op M (0)
    for o in offs:
        buf[o + 16:o + 18] = [nw, 0]
        buf[o + 36:o + 36 + 4 * nw] = np.frombuffer(
            np.full(nw, word, "<u4").tobytes(), np.uint8)
    info = _check(buf, offs, 2)
    total = nw * ((1 << 28) - 1)
    assert (info["span"] == total % (1 << 32)).all()
    assert (info["lanes"].sum(1) == total).all()   # before the mod
    assert (total > I32_MAX) == (nw > 8)


@pytest.mark.parametrize("nc", [0, CAP, CAP + 1])
def test_n_cigar_zero_cap_and_one_past(nc):
    """A '*' CIGAR takes l_seq (negative, 0, positive); the cap's words
    are all read; one op past it raises over."""
    rng = np.random.default_rng(nc)
    L, R = 1 << 14, 48
    buf = rng.integers(0, 256, L, dtype=np.uint8)
    offs = (40 + 300 * np.arange(R)).astype(np.int64)
    for i, o in enumerate(offs):
        buf[o + 16:o + 18] = [nc & 0xFF, nc >> 8]
        buf[o + 20:o + 24] = np.frombuffer(
            np.array([(-3, 0, 151)[i % 3]], "<i4").tobytes(), np.uint8)
    for n_all in (R, R // 2):
        got = model_interval_cols(buf, offs, n_all)
        _check(buf, offs.astype(np.int32), n_all)
        assert got[3] == int(nc > CAP)
        assert (got[4]["nw"] == min(nc, CAP)).all()
        if nc == 0:
            ls = np.array([(-3, 0, 151)[i % 3] for i in range(n_all)])
            p1 = got[1][:n_all].astype(np.int64)
            span = np.maximum(np.maximum(ls, 0), 1) - 1
            room = _i32(I32_MAX - p1)    # wraps for a negative pos
            np.testing.assert_array_equal(
                got[2][:n_all], _i32(p1 + np.minimum(span, room)))


@pytest.mark.parametrize("base", [0, 3])
@pytest.mark.parametrize("kind", ["prefix", "cigar"])
def test_cut_by_either_end_takes_the_clip(kind, base):
    """The edge rows of ``interval_rows``: prefixes cut by byte 0 or by
    byte L - 1, past either end or wrapping int32 read bytes (no aligned
    load leaves buf); CIGARs cut by L - 1 drop off the fast path, one
    ending 2 bytes before L keeps it where its aligned words fit."""
    L, R = 1 << 15, 1024
    buf, offs, edges = interval_rows(L, R, seed=5 + base)
    info = _check(buf, offs, R, base=base)
    rows = edges[kind]
    o = offs[rows].astype(np.int64)
    if kind == "prefix":
        cut = (o + 4 < 0) | (o + 24 > L)     # bytes 4-23 leave buf
        assert cut.sum() == 8
        assert not info["prefix_fast"][rows[cut]].all(axis=1).any()
    else:
        cut = _i32(o + 36 + (np.arange(4) * 3 + 1)) + 4 * info["nw"][rows] > L
        assert cut.tolist() == [False, False, True, True]
        assert not info["cigar_fast"][rows][cut].any()


@pytest.mark.parametrize("n_all", [-1, 0, 1, 3, "R - 1", "R", "R + 7"])
@pytest.mark.parametrize("R", [16, 17, 4093, 16_384, 131_072])
def test_pad_rows_each_written_once(R, n_all):
    """Rows [min(n_all, R), R) as whole int4 quads from the grid's last
    CTAs and a partial quad at either end; the walk's CTAs are the
    first."""
    n = {"R - 1": R - 1, "R": R, "R + 7": R + 7}.get(n_all, n_all)
    offs = np.zeros(R, np.int32)
    buf = np.zeros(64, np.uint8)
    rid, pos1, end1, over, info = model_interval_cols(buf, offs, n)
    nv = max(0, min(n, R))
    assert (rid[nv:] == -1).all() and not pos1[nv:].any() \
        and not end1[nv:].any()
    assert over == 0 and info["done"] == 0
    G = info["grid"]
    if info["pad_ctas"].size:
        quads = R // 4 - (nv + 3) // 4
        assert info["pad_ctas"].min() == G - 1 - (quads - 1) // THREADS
        assert info["pad_ctas"].max() == G - 1
    if nv:
        assert info["walk_ctas"].min() == 0


@pytest.mark.parametrize("seed", range(4))
def test_over_counter_in_any_order(seed):
    """The CTAs count themselves in in a random order: the last writes
    over, the word is zero after the launch, and a second launch on the
    same stream starts from it."""
    rng = np.random.default_rng(seed)
    R = 1 << 14
    buf, offs, _ = interval_rows(24 * R + 4096, R, seed=seed)
    G = grid(R)
    for flag_row in (None, 37, R - 5):
        o = offs.copy()
        b = buf.copy()
        if flag_row is not None:
            b[o[flag_row] + 16:o[flag_row] + 18] = [CAP + 1, 0]
        nc = tid._prefix_columns(torch.from_numpy(b),
                                 torch.from_numpy(o))["n_cigar"].numpy()
        done = 0
        for _ in range(2):
            got = model_interval_cols(b, o, R, order=rng.permutation(G),
                                      done=done)
            assert got[3] == int((nc > CAP).any())
            done = got[4]["done"]
            assert done == 0


@pytest.mark.parametrize("num_spans", [1, 3])
def test_model_on_mixed_cigar_chunks(tmp_path, num_spans):
    """The model on ``synth.write_coverage_bam``'s chunks (9-41 ops, '*',
    unmapped reads) as the walk leaves them, against the reference's
    formula, the port's plain version and the JAX step's own columns."""
    import jax.numpy as jnp
    from hadoop_bam_tpu.ops import inflate_device as jid
    from hadoop_bam_torch.synth import write_coverage_bam
    path = str(tmp_path / "cig.bam")
    write_coverage_bam(path, 4_000, seed=num_spans, span=300_000)
    seen = 0
    for tok, nt, iz, start, stop, P, _ in _chunks(path, num_spans):
        t = [torch.from_numpy(a) for a in (tok.view(np.int32), nt, iz)]
        B = tok.shape[0]
        buf, total = tid.pack_contiguous_plain(
            tid.resolve_tokens_plain(*t[:2], P), t[2])
        offs, n_all, _, _ = tid.walk_records_device_plain(
            buf, total, start, stop, tid.records_cap(B, P))
        b, o, n = buf.numpy(), offs.numpy(), int(n_all)
        info = _check(b, o, n)
        want = jid.resolve_walk_intervals(
            jnp.asarray(tok), jnp.asarray(nt), jnp.asarray(iz),
            jnp.int32(start), jnp.int32(stop))
        got = model_interval_cols(b, o, n)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[3] == int(want[6])
        assert n > 0 and info["cigar_fast"][info["nw"] > 0].all()
        seen += 1
    assert seen
