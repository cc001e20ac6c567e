"""A numpy model of the duplicate-signature columns (K16a,
``csrc/markdup_cols.cu``) held against the JAX package's
``markdup_columns`` and the port's plain version, on the CPU.

The model runs the kernel's partition of the work, its constants read
from the source, with the tile's address mod 64 (a multiple of 16: the
wrapper refuses any other) as a parameter:

- the persistent grid: min(resident CTAs, batches) CTAs of kThreads
  threads; CTA c takes the batches of kThreads consecutive records c,
  c + G, ...; thread t computes record t of its batch;
- the staging by cp.async, a batch ahead into one of two buffers: each
  row's first win 16-byte words and its library number, a row's words
  on consecutive threads (each thread stepping its record and word by
  kThreads copies), win the words below the launch's ``row_bytes``
  (the whole row when None), at least two, at most the row and
  kWinMax;
- a record's CIGAR walk, each op from the staged words when its bytes
  lie there, else from the tile (one or two aligned 32-bit loads and
  ``__funnelshift_r``, or bytes clamped to the tile's end);
- its quality run: its words summed whole (the SWAR test of a byte
  >= 15, ``__dp4a``), staged or from the tile, less the bytes outside
  [lo, hi) of its first and last words.

It also checks what the kernel relies on: every copy lies in its row,
every row is computed once, after its batch was staged and before its
buffer is staged again, and every column of every row is written exactly
once.  Every output is an integer and must match
exactly."""
import os
import re

import numpy as np
import pytest
import torch

from hadoop_bam_tpu.prep import markdup as jmd
from hadoop_bam_torch import synth
from hadoop_bam_torch.prep import markdup as md

SRC = os.path.join(os.path.dirname(md.__file__), os.pardir, "csrc",
                   "markdup_cols.cu")


def _const(name):
    with open(SRC) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not found in markdup_cols.cu"
    return int(m.group(1))


THREADS, WIN_MAX = (_const(n) for n in ("kThreads", "kWinMax"))
U32 = (1 << 32) - 1
RESIDENT = 132 * 6          # an H100's SMs x the CTAs its shared memory holds


def _i32(x):
    return ((int(x) + (1 << 31)) & U32) - (1 << 31)


def le32(flat, p):
    """Aligned little-endian 32-bit loads at byte indices ``p`` of the
    tile (each must lie in it)."""
    p = np.asarray(p, np.int64)
    assert ((p >= 0) & (p + 4 <= flat.size) & (p % 4 == 0)).all(), \
        "a 32-bit load left the tile"
    b = flat[p[..., None] + np.arange(4)].astype(np.int64)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def word_at(flat, cap, p):
    """The kernel's ``word_at``: (word, fast) for flat index p."""
    p = int(p)
    if p >= 0 and p + 3 <= cap:
        lo = int(le32(flat, p & ~3))
        sh = (p & 3) * 8
        if not sh:
            return lo, True
        hi = int(le32(flat, (p & ~3) + 4))
        return (((hi << 32) | lo) >> sh) & U32, True
    idx = np.clip(p + np.arange(4), 0, cap)
    b = flat[idx].astype(np.int64)
    return int(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24), False


def funnelshift_lc(lo, hi, shift):
    return ((((hi << 32) | lo) << min(shift, 32)) >> 32) & U32


def below(n):
    """Bytes [0, n) of a 4-byte lane, n clamped to [0, 4]."""
    return funnelshift_lc(0xFFFFFFFF, 0, 8 * max(n, 0))


def ge15_sel(x, keep):
    """0x01 in each byte of x that is >= 15 and kept (0x80 in keep)."""
    return ((((x | 0x80808080) - 0x0F0F0F0F) | x) & keep) >> 7


def dp4a(a, b, acc):
    return (acc + sum(((a >> s) & 0xFF) * ((b >> s) & 0xFF)
                      for s in (0, 8, 16, 24))) & U32


def word_sum(x, acc):
    """acc plus the bytes >= 15 of the 16-byte word x (four lanes)."""
    for xi in x:
        acc = dp4a(xi, ge15_sel(xi, 0x80808080), acc)
    return acc


def range_sum(x, a, b):
    """The bytes >= 15 of the 16-byte word x in [a, b)."""
    acc = 0
    for i, xi in enumerate(x):
        keep = 0x80808080 & below(b - 4 * i) & ~below(a - 4 * i) & U32
        acc = dp4a(xi, ge15_sel(xi, keep), acc)
    return acc


def quality_sum(flat, row0, lo, hi, win):
    """A record's uint32 score: the words of [lo, hi) summed whole, less
    the bytes outside the run in its first and last words; words below
    ``win`` come from the stage (asserted), the rest from the tile."""
    w0 = lo >> 4
    w1 = (hi - 1) >> 4 if lo < hi else w0 - 1

    def word(w):
        return [int(v) for v in le32(flat, row0 + 16 * w + 4 * np.arange(4))]
    acc = 0
    for w in range(w0, w1 + 1):
        acc = word_sum(word(w), acc)
    if w1 >= w0:
        acc -= range_sum(word(w0), 0, lo & 15)
        acc -= range_sum(word(w1), hi - 16 * w1, 16)
    staged = [w for w in range(w0, w1 + 1) if w < win]
    return acc & U32, staged


def grid(R, resident=RESIDENT):
    return min(resident, -(-R // THREADS))


def timeline(R, resident=RESIDENT):
    """Each CTA's program order as the kernel runs it: ("stage", batch,
    buffer) and ("compute", batch, buffer) events, the prologue first."""
    batches = -(-R // THREADS)
    G = grid(R, resident)
    for c in range(G):
        ev = [("stage", c, 0)]
        i, b = 0, c
        while b < batches:
            if b + G < batches:
                ev.append(("stage", b + G, (i & 1) ^ 1))
            ev.append(("compute", b, i & 1))
            i, b = i + 1, b + G
        yield c, ev


def model_record(flat, lib, r, R, stride, count, kmax, win):
    """Thread t's record r from its staged words and the tile: its six
    column words, elig byte and the staged words it read."""
    cap = R * stride - 1
    row0 = r * stride
    head = flat[row0:row0 + 16 * win]
    w = head[:32].copy().view("<u4").astype(np.int64)
    l_read_name, n_cigar, flag, l_seq = (int(w[3] & 0xFF), int(w[4] & 0xFFFF),
                                         int(w[4] >> 16), int(w[5]))
    half = _i32(l_seq + 1) >> 1
    qoff = _i32(36 + l_read_name + 4 * n_cigar + (half & U32))
    qend = _i32(qoff + l_seq)
    score, staged = quality_sum(flat, row0, max(qoff, 0), min(qend, stride),
                                win)

    lead = trail = ref = 0
    in_lead = True
    for k in range(min(n_cigar, kmax)):
        rel = 36 + l_read_name + 4 * k
        if rel + 4 <= 16 * win:                      # in the staged words
            v = int(head[rel:rel + 4].copy().view("<u4")[0])
            staged.append(rel // 16)
        else:
            v = word_at(flat, cap, row0 + rel)[0]
        op, ln = v & 0xF, v >> 4
        if op in (4, 5):
            lead += ln if in_lead else 0
            trail += ln
        else:
            in_lead, trail = False, 0
        if op in (0, 2, 3, 7, 8):
            ref += ln
    orient = (flag >> 4) & 1
    pair = int(bool(flag & 1) and not flag & 8)
    mate_rev = (flag >> 5) & 1 if pair else 0
    ref_len = l_seq if n_cigar == 0 else ref
    pos = int(w[2])
    upos = pos + ref_len - 1 + trail if orient else pos - lead
    cols = [int(w[1]), upos + 1,
            (int(lib[r]) << 3) | (mate_rev << 2) | (orient << 1) | pair,
            int(w[6]) + 1 if pair else 0, int(w[7]) + 1 if pair else 0,
            score]
    return ([c & U32 for c in cols], int(r < count and not flag & 0x904),
            staged)


def window(stride, row_bytes=None):
    """The launch's staged words a row (``hbam_markdup_cols``)."""
    w = -(-(stride if row_bytes is None else row_bytes) // 16)
    return max(min(w, stride // 16, WIN_MAX), 2)


def model_columns(rows, lib, count, kmax, resident=RESIDENT, base=0,
                  row_bytes=None):
    """The kernel in numpy: (uint32 [6, R] columns, uint8 [R] elig,
    info).  ``base`` is the tile's address mod 64."""
    R, stride = rows.shape
    flat = rows.reshape(-1)
    out = np.zeros((6, R), np.int64)
    elig = np.zeros(R, np.int64)
    writes = np.zeros((7, R), np.int64)
    win = window(stride, row_bytes)
    copies, copied = [], set()
    for c, events in timeline(R, resident):
        buf_of = {}
        for kind, b, q in events:
            recs = [r for r in range(b * THREADS, (b + 1) * THREADS) if r < R]
            if kind == "stage":
                buf_of[q] = b
                # the flat copy list: record f // win, word f % win
                staged = [(b * THREADS + f // win, 16 * (f % win))
                          for f in range(THREADS * win)
                          if b * THREADS + f // win < R]
                copies += staged
                copied.update(staged)
                continue
            assert buf_of[q] == b, "a buffer staged again before it was read"
            for r in recs:
                cols, e, staged = model_record(flat, lib, r, R, stride,
                                               count, kmax, win)
                assert all((r, 16 * wd) in copied for wd in staged), \
                    "a word read from the stage that was not copied"
                out[:, r] = cols
                elig[r] = e
                writes[:, r] += 1
    assert (writes == 1).all(), "a column of a row written other than once"
    assert len(set(copies)) == len(copies), "a word copied twice"
    for r, o in copies:
        a = base + r * stride + o
        assert a % 16 == 0 and 0 <= o and o + 16 <= stride, \
            "a copy left its row"
    return (out.astype(np.uint32), elig.astype(np.uint8),
            {"grid": grid(R, resident), "copies": copies, "win": win})


def _jax_columns(rows, valid, lib, kmax):
    import jax.numpy as jnp
    got = jmd.markdup_columns(jnp.asarray(rows), None, jnp.asarray(valid),
                              jnp.asarray(lib), kmax, rows.shape[1])
    return (np.stack([np.asarray(c).astype(np.uint32) for c in got[:6]]),
            np.asarray(got[6]).astype(np.uint8))


def _check(rows, lib, count, kmax, **kw):
    """The model against the JAX reference and the port's plain version."""
    got_cols, got_elig, info = model_columns(rows, lib, count, kmax, **kw)
    valid = np.arange(rows.shape[0]) < count
    want_cols, want_elig = _jax_columns(rows, valid, lib, kmax)
    plain = md.markdup_columns_plain(torch.from_numpy(rows),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(lib), kmax)
    np.testing.assert_array_equal(got_cols, want_cols)
    np.testing.assert_array_equal(got_elig, want_elig)
    np.testing.assert_array_equal(plain[0].numpy(), want_cols)
    np.testing.assert_array_equal(plain[1].numpy(), want_elig)
    return info


# ---------------------------------------------------------------------------
# the whole model on the edge rows and tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", [0, 16, 48])
@pytest.mark.parametrize("kmax", ["rows", 2, 0])
def test_model_on_the_edge_rows(kmax, base):
    """``synth.MARKDUP_CASES`` with random pads and a CIGAR past the
    tile, the tile at each 16-byte residue mod 64."""
    rows, lib, count, _ = synth.markdup_rows(seed=2)
    k = synth.rows_kmax(rows) if kmax == "rows" else kmax
    _check(rows, lib, count, k, base=base)


@pytest.mark.parametrize("kmax", ["rows", 2])
@pytest.mark.parametrize("case", [n for n, _ in synth.MARKDUP_TILES])
def test_model_on_the_tiles(case, kmax):
    """``synth.MARKDUP_TILES``: runs longer than the staged words, names
    of 30-40 bytes, R = 1, R under a warp, R not a multiple of a CTA's
    records."""
    rows, lib, count = synth.markdup_tile(seed=5,
                                          **dict(synth.MARKDUP_TILES)[case])
    k = synth.rows_kmax(rows) if kmax == "rows" else kmax
    _check(rows, lib, count, k)


@pytest.mark.parametrize("resident", [1, 2, 3])
def test_model_across_sweeps(resident):
    """A grid of 1-3 resident CTAs over 1,031 rows: every CTA walks many
    batches through its two buffers, the last batch partial."""
    rows, lib, count = synth.markdup_tile(
        seed=resident, **dict(synth.MARKDUP_TILES)["R = 1,031, stride 128"])
    info = _check(rows, lib, count, synth.rows_kmax(rows),
                  resident=resident)
    assert info["grid"] == resident


@pytest.mark.parametrize("stride", [48, 64, 80])
def test_model_on_narrow_rows(stride):
    """Rows narrower than the staged words (stride 48: three words, all
    of the row): ops and qualities past them read from the tile."""
    rows, lib, count = synth.markdup_tile(200, seed=stride, stride=stride,
                                          l_seq=(4, 20))
    _check(rows, lib, count, synth.rows_kmax(rows), resident=2)


@pytest.mark.parametrize("row_bytes", [0, 48, 100, 281, 320, 400, 2_000])
@pytest.mark.parametrize("case", ["edge rows", "30-40-byte names",
                                  "reads of 400-600 bases, stride 1024"])
def test_model_at_each_window(case, row_bytes):
    """The launch's window from the fixed fields alone to past the row
    (the named tile's ``host_row_bytes`` is 320): ops and quality words
    below it read from the stage, the rest from the tile, the columns
    the same."""
    if case == "edge rows":
        rows, lib, count, _ = synth.markdup_rows(seed=6)
    else:
        rows, lib, count = synth.markdup_tile(
            seed=6, **dict(synth.MARKDUP_TILES)[case])
    info = _check(rows, lib, count, synth.rows_kmax(rows), resident=5,
                  row_bytes=row_bytes)
    assert info["win"] == window(rows.shape[1], row_bytes)


# ---------------------------------------------------------------------------
# the parts of the partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resident", [1, 2, 7, RESIDENT])
@pytest.mark.parametrize("R", [1, 7, 31, 64, 511, 513, 4_097, 1_000_448])
def test_every_row_computed_once(R, resident):
    """Each batch by one CTA, after it was staged and before its buffer is
    staged again; the grid no larger than the batches."""
    batches = -(-R // THREADS)
    seen = np.zeros(batches, np.int64)
    for _, events in timeline(R, resident):
        buf_of = {}
        for kind, b, q in events:
            if kind == "stage":
                buf_of[q] = b
            else:
                assert buf_of[q] == b
                seen[b] += 1
    assert (seen == 1).all()
    assert grid(R, resident) == min(resident, batches)


@pytest.mark.parametrize("stride", [48, 64, 128, 512, 1024])
def test_window_stays_in_the_row(stride):
    """The window: the words below row_bytes, at least the fixed fields'
    two, at most the row's and kWinMax; None the whole row."""
    for rb in [None, -5, 0, 1, 31, 32, 33, 281, 288, 289, 600, 5_000]:
        w = window(stride, rb)
        assert 2 <= w <= min(stride // 16, WIN_MAX)
        if rb is not None and 32 <= rb <= 16 * min(stride // 16, WIN_MAX):
            assert w == -(-rb // 16)
    assert window(stride) == min(stride // 16, WIN_MAX)


def _stage_cost(end, b):
    """64-byte pieces moved for run ends ``end`` with a stage of ``b``
    bytes: the stage's pieces for every record, and twice each piece a
    record reads past it."""
    pieces = -(-end // 64)
    return end.size * -(-b // 64) + 2 * int(np.maximum(
        pieces - -(-b // 64), 0).sum())


@pytest.mark.parametrize("seed", range(6))
def test_host_row_bytes_moves_the_fewest_pieces(seed):
    """``host_row_bytes`` on decoded spans of records without tags (a
    quality run ends at block_size + 4): names of 2-60 bytes, runs of
    0-160 bases, one to seven CIGAR ops.  It is at most the furthest
    end, and no 64-byte boundary or end moves fewer pieces."""
    rng = np.random.default_rng(seed)
    rows, _, count = synth.markdup_tile(
        int(rng.integers(1, 400)), seed=seed, pads=0,
        name_len=(2, int(rng.integers(2, 61))),
        l_seq=(0, int(rng.integers(0, 161))))
    flat = rows.reshape(-1)
    offs = np.arange(count, dtype=np.int64) * rows.shape[1]
    end = rows[:, 0:4].copy().view("<i4").ravel().astype(np.int64) + 4
    got = md.host_row_bytes(flat, offs)
    assert got <= end.max()
    best = min(_stage_cost(end, b)
               for b in list(range(64, int(end.max()) + 64, 64)) + list(end))
    assert _stage_cost(end, got) == best


@pytest.mark.parametrize("ends, want", [
    ([281] * 9, 281),                    # a round tile's: the run's end
    ([300] * 6 + [331] * 4, 320),        # most within a 64-byte piece
    ([300] * 4 + [331] * 6, 331),        # most past it
    ([100, 500], 128),                   # the lower median's piece
    ([40], 40)])
def test_host_row_bytes_on_chosen_ends(ends, want):
    """Spans whose records' runs end at ``ends``."""
    stride = 512
    rows = np.zeros((len(ends), stride), np.uint8)
    for r, e in enumerate(ends):
        # e = 36 + l_read_name + (l_seq + 1) // 2 + l_seq, no CIGAR
        ls = (e - 38) * 2 // 3
        nl = e - 36 - (ls + 1) // 2 - ls
        assert 1 <= nl <= 3 and ls >= 0
        rows[r, 12] = nl
        rows[r, 20:24] = np.frombuffer(np.int32(ls).tobytes(), np.uint8)
    offs = np.arange(len(ends), dtype=np.int64) * stride
    assert md.host_row_bytes(rows.reshape(-1), offs) == want
    assert md.host_row_bytes(rows.reshape(-1), offs[:0]) == 0


@pytest.mark.parametrize("lo16", range(16))
def test_quality_words_cover_the_run(lo16):
    """For every offset mod 16 and every run length from 0 to past twice
    the staged words: the whole-word sums less the end words' outside
    bytes equal the bytes >= 15 of [lo, hi), staged or not."""
    rng = np.random.default_rng(lo16)
    stride = 1024
    flat = rng.integers(0, 256, stride, dtype=np.uint8)
    win = window(512, 281)         # a round tile's: bytes 0-287
    for n in range(0, 2 * 16 * win + 40):
        lo = 48 + lo16
        hi = min(lo + n, stride)
        got, _ = quality_sum(flat, 0, lo, hi, win)
        q = flat[lo:hi].astype(np.int64)
        assert got == int(q[q >= 15].sum()) & U32


@pytest.mark.parametrize("a", range(17))
def test_end_word_masks(a):
    """range_sum over every byte range [a, b) of a word, against the
    bytes themselves, on words of every byte value class."""
    rng = np.random.default_rng(a)
    for _ in range(8):
        x = rng.choice([0, 14, 15, 16, 127, 128, 255], 16).astype(np.uint8)
        lanes = [int(v) for v in x.view("<u4")]
        for b in range(a, 17):
            q = x[a:b].astype(np.int64)
            assert range_sum(lanes, a, b) == int(q[q >= 15].sum())


def test_swar_byte_compare_is_exact():
    """The byte compare over every byte value in every lane position, with the other
    three bytes at their extremes (no borrow crosses a byte)."""
    v = np.arange(256, dtype=np.int64)
    for pos in range(4):
        for other in (0x00, 0x0E, 0x0F, 0x7F, 0x80, 0xFF):
            fill = sum(other << (8 * i) for i in range(4) if i != pos)
            for b in v:
                x = fill | (int(b) << (8 * pos))
                got = ge15_sel(x, 0x80808080)
                want = sum(int(((x >> (8 * i)) & 0xFF) >= 15) << (8 * i)
                           for i in range(4))
                assert got == want


def _cigar_tile(cigars, kmaxes, stride=512, seed=0):
    """One row a CIGAR (lists of (length, op)), with a declared n_cigar
    that may exceed the words written; random qualities."""
    rng = np.random.default_rng(seed)
    R = len(cigars)
    rows = rng.integers(0, 256, (R, stride), dtype=np.uint8)
    for r, (ops, nc) in enumerate(zip(cigars, kmaxes)):
        words = np.asarray([(ln << 4) | op for ln, op in ops], "<u4")
        rec = np.frombuffer(synth.markdup_record(
            rng, flag=[0, 16, 99, 147][r % 4], pos=1_000 + r, cigar=None,
            l_seq=60), np.uint8)
        rows[r, :rec.size] = rec
        rows[r, 16:18] = np.frombuffer(np.uint16(nc).tobytes(), np.uint8)
        rows[r, 46:46 + 4 * words.size] = words.view(np.uint8)
    return rows, rng.integers(0, 4, R).astype(np.uint32)


@pytest.mark.parametrize("n_ops", range(20))
def test_cigar_walk_against_the_reference(n_ops):
    """Random CIGARs of ``n_ops`` ops over all nine codes (clips weighted up), all-clip CIGARs
    and n_cigar past kmax: lead / trail / ref equal the reference's
    cumulative products."""
    rng = np.random.default_rng(n_ops)
    codes = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 4, 5, 4, 5])
    cigars, ncs = [], []
    for i in range(24):
        ops = [(int(rng.integers(1, 1 << 20)), int(rng.choice(codes)))
               for _ in range(n_ops)]
        if i % 6 == 0:
            ops = [(ln, int(rng.choice([4, 5]))) for ln, _ in ops]
        cigars.append(ops)
        ncs.append(n_ops + (3 if i % 4 == 3 else 0))
    rows, lib = _cigar_tile(cigars, ncs, seed=n_ops)
    for kmax in sorted({n_ops, n_ops + 3, max(n_ops - 1, 0), 19}):
        _check(rows, lib, rows.shape[0], kmax, resident=1)


@pytest.mark.parametrize("tail", [0, 1, 2, 3, 5, 9])
def test_clamped_ops_at_the_tile_end(tail):
    """A last row whose CIGAR runs ``tail`` bytes short of or past the
    tile's end: the op straddling the end takes the byte clamp, the ops
    past it read the tile's last byte repeated."""
    rows, lib, count, _ = synth.markdup_rows(seed=tail, pads=1)
    R, stride = rows.shape
    flat = rows.reshape(-1)
    cap = R * stride - 1
    # the tile-end row's CIGAR starts past the row's middle
    cig = (R - 1) * stride + 36 + int(rows[-1, 12])
    n = (stride - 36 - int(rows[-1, 12])) // 4 + tail
    rows[-1, 16:18] = np.frombuffer(np.uint16(n).tobytes(), np.uint8)
    for k in range(n):
        p = cig + 4 * k
        got, fast = word_at(flat, cap, p)
        idx = np.clip(p + np.arange(4), 0, cap)
        want = int(sum(int(flat[i]) << (8 * j) for j, i in enumerate(idx)))
        assert got == want and fast == (p + 3 <= cap)
    _check(rows, lib, count, n + 2)
