"""A numpy model of the tiled record walk (K9, ``csrc/record_walk.cu``)
held against the JAX package's ``_walk_records_device`` on the CPU.

The model runs the kernel's three phases with the tile width W as a
parameter, so that small tiles (64-256 positions) make records longer
than a tile, skipped tiles and terms after a long jump cheap to build:

- phase A, per tile: the candidates (positions whose block_size is
  readable, in [32, L] and complete), each one's successor inside the
  tile, the exits after local pointer doubling, a jump where the exit is
  a candidate, and the live candidates (those with a jump);
- phase B: radix-4 doubling over the live candidates' jumps, marks
  pushed from ``start`` with the jumps double-buffered, in at most
  ``rounds`` rounds with an early exit when a round adds no mark;
- phase C, per tile with an entry: the serial walk from the entry, the
  kept positions (p < stop), the term and its rules, then the rank-order
  offsets from a scan of the per-tile counts.

It also checks what the kernel relies on: an exit inside its tile is
never a candidate, ``rounds`` rounds converge, a tile's path fits
``path_cap`` and holds at most one marked candidate (its entry).
Every output is an integer and must match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest

from hadoop_bam_tpu.ops import inflate_device as jid
from hadoop_bam_torch.ops import inflate_device as tid
from hadoop_bam_torch.synth import block_size_chain, record_flags, walk_cases


def _flags(buf: np.ndarray, total: int):
    L = buf.size
    bs, complete = record_flags(buf, total)
    pos = np.arange(L, dtype=np.int64)
    nxt = np.where(complete, np.minimum(pos + 4 + bs, L), L)
    return bs, pos + 4 <= total, complete, nxt


def tile_arithmetic(L: int, W: int):
    """(tiles, phase-B rounds, path_cap) of the tiled walk at tile width
    W: the least k with 4^k >= tiles, and the chain nodes (at least 36
    bytes apart) one tile can hold."""
    tiles = max(1, -(-L // W))
    rounds = 0
    while 4 ** rounds < tiles:
        rounds += 1
    return tiles, rounds, (W - 1) // 36 + 1


def tiled_walk(buf: np.ndarray, total: int, start: int, stop: int, R: int,
               W: int):
    """The kernel's phases in numpy: (offs [R], n_all, tail, bad)."""
    L = buf.size
    T, rounds, path_cap = tile_arithmetic(L, W)
    bs, has_size, complete, nxt = _flags(buf, total)
    # phase A: per tile, local doubling to each candidate's exit; a jump
    # (by position) where the exit is a candidate, and the live lists
    jump = np.full(T * W, -1, np.int64)
    marks = np.zeros(T * W, bool)
    entry = np.full(T, -1, np.int64)
    live = []
    for t in range(T):
        t0 = t * W
        cands = np.nonzero(complete[t0:t0 + W])[0] + t0
        rank = {int(p): i for i, p in enumerate(cands)}
        ptr = np.array([rank.get(int(nxt[p]), i)
                        for i, p in enumerate(cands)], np.int64)
        while True:
            p2 = ptr[ptr]
            if np.array_equal(p2, ptr):
                break
            ptr = p2
        exits = nxt[cands[ptr]] if cands.size else cands
        assert not any(t0 <= x < t0 + W and complete[x] for x in exits)
        for p, x in zip(cands, exits):
            if x < L and complete[x]:
                jump[p] = x
        marks[cands] = cands == start
        live.append(cands[jump[cands] >= 0])
        if start in rank:
            entry[t] = start
    # phase B: radix-4 rounds over the live candidates, jumps
    # double-buffered, marks in place
    changed = True
    for _ in range(rounds):
        if not changed:
            break
        changed = False
        out = jump.copy()
        for c in np.concatenate(live):
            j = jump[c]
            for _ in range(3):
                if j < 0:
                    break
                if marks[c] and not marks[j]:
                    marks[j] = True
                    entry[j // W] = j
                    changed = True
                j = jump[j]
            out[c] = j
        jump = out
    # the rounds always suffice: one more would add no mark
    for c in np.concatenate(live):
        if marks[c] and jump[c] >= 0:
            assert marks[jump[c]]
    for t in range(T):
        assert marks[t * W:(t + 1) * W].sum() <= 1
    # phase C
    term = -1
    if start < L and not complete[start]:
        term = start
    kept = []
    for t in range(T):
        kept.append([])
        if entry[t] < 0:
            continue
        t0 = t * W
        p = int(entry[t])
        nodes = 0
        while True:
            nodes += 1
            if p < stop:
                kept[t].append(p)
            n = int(nxt[p])
            if n >= L:
                break
            if n < t0 + W and complete[n]:
                p = n
                continue
            if not complete[n]:
                term = n
            break
        assert nodes <= path_cap
    tail, bad = total, 0
    if term >= 0:
        tail = min(term, total)
        bad = int(bool(has_size[term] and bs[term] < 32))
    counts = np.array([len(k) for k in kept], np.int64)
    base = np.cumsum(counts) - counts
    n_all = int(counts.sum())
    offs = np.zeros(R, np.int32)
    for t in range(T):
        for i, p in enumerate(kept[t]):
            if base[t] + i < R:
                offs[base[t] + i] = p
    return offs, n_all, tail, bad


def _jax(buf, total, start, stop, R):
    got = jid._walk_records_device(jnp.asarray(buf), jnp.int32(total),
                                   jnp.int32(start), jnp.int32(stop), R)
    return np.asarray(got[0]), [int(x) for x in got[1:]]


CASE_NAMES = [c[0] for c in walk_cases(64)]


@pytest.mark.parametrize("W", [64, 256, tid.WALK_W])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_tiled_model_matches_jax(W, name):
    (case,) = [c for c in walk_cases(W, seed=W) if c[0] == name]
    _, buf, total, start, stop, R = case
    offs, n_all, tail, bad = tiled_walk(buf, total, start, stop, R, W)
    want_offs, want = _jax(buf, total, start, stop, R)
    np.testing.assert_array_equal(offs, want_offs)
    assert [n_all, tail, bad] == want


@pytest.mark.parametrize("seed", range(4))
def test_tiled_model_random_chains_match_jax(seed):
    """Random chains with many off-chain candidates, random windows and
    totals, at W = 128."""
    rng = np.random.default_rng(seed)
    W, L = 128, 2048
    at = int(rng.integers(0, 50))
    sizes = [int(s) for s in rng.integers(36, 3 * W, 40)]
    sizes = sizes[:int(np.searchsorted(np.cumsum(sizes), L - at - 4))]
    buf, end = block_size_chain(L, sizes, at, seed, zero_share=0.8)
    for _ in range(6):
        total = int(rng.integers(0, L + 8))
        start = int(rng.choice([at, rng.integers(0, L + 4)]))
        stop = int(rng.integers(-4, L + 4))
        R = int(rng.integers(0, 40))
        offs, *rest = tiled_walk(buf, total, start, stop, R, W)
        want_offs, want = _jax(buf, total, start, stop, R)
        np.testing.assert_array_equal(offs, want_offs)
        assert list(rest) == want, (total, start, stop, R)


def test_tiled_model_on_bam_bytes(tmp_path):
    """A synthetic BAM's inflated bytes at W = 1024, from its first record
    and from a position inside it."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.ops.inflate import inflate_span
    from hadoop_bam_torch.synth import write_synthetic_bam
    path = str(tmp_path / "m.bam")
    write_synthetic_bam(path, 400, seed=2, chunk_pairs=100)
    data, _ = inflate_span(open(path, "rb").read())
    _, voff = read_bam_header(path)
    data = data[voff & 0xFFFF:]
    L = 1 << 16
    buf = np.zeros(L, np.uint8)
    n = min(L, data.size)
    buf[:n] = data[:n]
    for start in (0, 3):
        offs, *rest = tiled_walk(buf, n, start, L, 512, 1024)
        want_offs, want = _jax(buf, n, start, L, 512)
        np.testing.assert_array_equal(offs, want_offs)
        assert list(rest) == want
        if start == 0:
            assert rest[0] == L // 277   # every whole record in the buffer


def test_launch_helper_arithmetic():
    """The package's launch helper gives the model's arithmetic at the
    kernel's tile width, and the scratch the kernel's layout needs."""
    lw = tid.walk_launch(4 << 20)
    assert (lw.W, lw.tiles, lw.rounds) == (tid.WALK_W, 512, 5) == (
        8192, 512, 5)
    assert tid.walk_launch(2 << 20)[2:4] == (256, 4)
    assert tid.walk_launch(1 << 20)[2:4] == (128, 4)
    assert tid.walk_launch(1 << 18)[2:4] == (32, 3)
    assert lw.path_cap == (tid.WALK_W - 1) // 36 + 1 == 228
    for L in (1, 36, 8191, 8192, 8193, 4 * 8192 + 1, 17 * 8192, 1 << 22):
        lw = tid.walk_launch(L)
        assert lw.L == L
        assert (lw.tiles, lw.rounds, lw.path_cap) == tile_arithmetic(
            L, tid.WALK_W)
        assert 4 ** lw.rounds >= lw.tiles
        assert lw.rounds == 0 or 4 ** (lw.rounds - 1) < lw.tiles
        assert lw.entries == lw.tiles * lw.W
        assert lw.words == (3 * lw.entries + 4 * lw.tiles
                            + lw.tiles * lw.path_cap + lw.rounds + 2)
    for L in (0, (1 << 31) - tid.WALK_W):
        with pytest.raises(ValueError):
            tid.walk_launch(L)
