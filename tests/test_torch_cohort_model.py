"""A numpy model of the cohort kernels (K17a's GWAS columns and K17b's
slice step, ``csrc/cohort_stats.cu``) held against the port's plain
versions and the JAX package's steps, on the CPU.

The model runs the kernel's partition of the work and its arithmetic,
its constants (warps a CTA, 8-byte words a lane has in flight, the
widest staged phenotype, the CTAs an SM its launch bounds ask for) read
from the source:

- the persistent grid: G = min(resident CTAs, cap) CTAs; row r goes to
  CTA r mod G as its j-th row, j = r div G, and to its warp j mod kWarps
  in step j div kWarps; the rows past the count are written NaN by a
  grid-stride loop;
- lane l reads the row's 8-byte words l, l + 32, ..., kWords a pass;
  words at or past n_samples are not loaded (0xFF bytes), the word
  holding n_samples is masked past it;
- the SWAR counts a 32-bit word at a time (``prmt`` in its sign mode,
  ``__byte_perm`` and ``__dp4a`` emulated here, and the form with
  ``__vcmpges4``, ``__vcmpeq4`` and ``__popc`` that the kernel's first
  design used, held equal to it; the fast sums a pass takes while every
  called value is 0, 1 or 2), the phenotype staged as y' and a finite
  mask, the float sums a lane's columns in its order, then the warp's
  butterfly;
- K17b's sums: each warp's rows in step order, the CTA's warps in
  order, the CTAs' partials added by the last CTA lane-strided then by a
  butterfly, in float64, rounded to float32 once.

Integers (and AF and call rate, which derive from them) must match the
plain version and the JAX step exactly; HWE and score within rtol 1e-5,
atol 1e-6; K17b's af_sum within rtol 1e-6."""
import os
import re

import numpy as np
import pytest
import torch

from hadoop_bam_torch import synth
from hadoop_bam_torch.cohort import gwas as tg
from hadoop_bam_torch.cohort import serving as tsv

SRC = os.path.join(os.path.dirname(tg.__file__), os.pardir, "csrc",
                   "cohort_stats.cu")
with open(SRC) as _f:
    _SOURCE = _f.read()


def _const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", _SOURCE)
    assert m, f"{name} not found in cohort_stats.cu"
    return int(m.group(1))


WARPS, WORDS, STAGE_MAX = (_const(n) for n in ("kWarps", "kWords",
                                               "kStageMax"))
THREADS = 32 * WARPS
_LB = re.search(r"__launch_bounds__\(kThreads, (\d+)\)", _SOURCE)
assert _LB, "the row kernel's launch bounds not found in cohort_stats.cu"
RESIDENT = 132 * int(_LB.group(1))   # an H100's SMs x the CTAs an SM
U32 = np.uint32(0xFFFFFFFF)
_POPC8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


# ---------------------------------------------------------------------------
# the SWAR primitives, a 32-bit word (uint32 arrays) at a time
# ---------------------------------------------------------------------------

def _bytes(x):
    x = np.asarray(x, np.uint32)
    return [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]


def _join(parts):
    out = np.zeros(np.shape(parts[0]), np.uint32)
    for k, p in enumerate(parts):
        out |= (p.astype(np.uint32) & np.uint32(0xFF)) << np.uint32(8 * k)
    return out


def vcmpges4(a, b):
    """0xFF in each byte where a's signed byte >= b's."""
    return _join([np.where(ba.astype(np.uint8).view(np.int8)
                           >= bb.astype(np.uint8).view(np.int8), 0xFF, 0)
                  for ba, bb in zip(_bytes(a), _bytes(b))])


def vcmpeq4(a, b):
    """0xFF in each byte where a's byte equals b's."""
    return _join([np.where(ba == bb, 0xFF, 0)
                  for ba, bb in zip(_bytes(a), _bytes(b))])


def popc(x):
    return sum(_POPC8[b] for b in _bytes(x))


def neg_bytes(x):
    """prmt.b32 x, 0, 0xBA98: 0xFF in each byte of x that is negative."""
    return _join([np.where(b >= 0x80, 0xFF, 0) for b in _bytes(x)])


def byte_perm(x, y, sel):
    """__byte_perm: byte k of the result is byte (sel >> 4k) & 7 of the
    eight bytes of (y, x)."""
    both = _bytes(x) + _bytes(np.broadcast_to(np.asarray(y, np.uint32),
                                              np.shape(x)))
    return _join([both[(sel >> (4 * k)) & 7] for k in range(4)])


def dp4a(a, b, c=0):
    """c plus the products of a's and b's signed bytes."""
    return c + sum(ba.astype(np.uint8).view(np.int8).astype(np.int64)
                   * bb.astype(np.uint8).view(np.int8).astype(np.int64)
                   for ba, bb in zip(_bytes(a), _bytes(np.broadcast_to(
                       np.asarray(b, np.uint32), np.shape(a)))))


def test_swar_primitives_are_bytewise():
    """The emulations against a byte loop, on every byte value paired
    with the edge values."""
    rng = np.random.default_rng(0)
    edge = np.array([0, 1, 2, 3, 0x7F, 0x80, 0x81, 0xFE, 0xFF], np.uint32)
    a = np.concatenate([np.arange(256, dtype=np.uint32) * 0x01010101,
                        rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                        .astype(np.uint32)])
    for e in edge:
        b = np.full(a.shape, e * 0x01010101, np.uint32)
        for i in range(0, a.size, 37):
            x, y = int(a[i]), int(b[i])
            xs = [((x >> (8 * k)) & 0xFF) for k in range(4)]
            ys = [((y >> (8 * k)) & 0xFF) for k in range(4)]
            sx = [v - 256 if v > 127 else v for v in xs]
            sy = [v - 256 if v > 127 else v for v in ys]
            ge = sum(0xFF << (8 * k) for k in range(4) if sx[k] >= sy[k])
            eq = sum(0xFF << (8 * k) for k in range(4) if xs[k] == ys[k])
            assert int(vcmpges4(a[i], b[i])) == ge
            assert int(vcmpeq4(a[i], b[i])) == eq
            assert int(popc(a[i])) == bin(x).count("1")
            assert int(dp4a(a[i], b[i], 5)) == 5 + sum(
                p * q for p, q in zip(sx, sy))
            assert int(neg_bytes(a[i])) == sum(
                0xFF << (8 * k) for k in range(4) if sx[k] < 0)
            for k in range(4):
                assert int(byte_perm(a[i], 0x4B00, 0x5440 | k)) \
                    == 0x4B000000 | xs[k]


def swar_counts(x, f=None):
    """The kernel's count4 over uint32 words x (bytes past n_samples
    already 0xFF), summed over the last axes: {unc, alt, ns, s1, s2, n3}
    and with a finite mask f {n, sg, sgg}."""
    neg = neg_bytes(x)
    xc = x & ~neg
    s80 = ~(((x & np.uint32(0x7C7C7C7C)) + np.uint32(0x7C7C7C7C)) | x) \
        & np.uint32(0x80808080)
    s1 = s80 >> np.uint32(7)
    lo = x & (s1 * np.uint32(3))
    ones = 0x01010101
    out = {"unc": dp4a(neg, ones), "alt": dp4a(xc, ones),
           "ns": dp4a(s1, ones), "s1": dp4a(lo, ones), "s2": dp4a(lo, lo),
           "n3": dp4a(lo & (lo >> np.uint32(1)) & np.uint32(ones), ones)}
    if f is not None:
        xu = xc & f
        out.update(n=dp4a(f & ~neg & np.uint32(ones), ones),
                   sg=dp4a(xu, ones), sgg=dp4a(xu, xu))
    axes = tuple(range(1, np.ndim(x)))
    return {k: v.sum(axis=axes) if axes else v for k, v in out.items()}


def from_moments(c, words):
    """The row's called count and n0, n1, n2 from its sums (s1 = n1 +
    2 n2 + 3 n3, s2 = n1 + 4 n2 + 9 n3) over ``words`` 8-byte words."""
    n2 = (c["s2"] - c["s1"] - 6 * c["n3"]) >> 1
    n1 = c["s1"] - 2 * n2 - 3 * c["n3"]
    return {"called": 8 * words + c["unc"], "n0": c["ns"] - n1 - n2 - c["n3"],
            "n1": n1, "n2": n2}


def fast_sums(x):
    """The kernel's count_fast over uint32 words x, summed over the last
    axes: {unc, alt, q} and big (nonzero where a called value is above 2)."""
    neg = neg_bytes(x)
    xc = x & ~neg
    ones = 0x01010101
    big = (xc & np.uint32(0x7C7C7C7C)) | ((xc + np.uint32(ones))
                                         & np.uint32(0x04040404))
    axes = tuple(range(1, np.ndim(x)))
    return ({"unc": dp4a(neg, ones).sum(axis=axes),
             "alt": dp4a(xc, ones).sum(axis=axes),
             "q": dp4a(xc, xc).sum(axis=axes)},
            np.bitwise_or.reduce(big, axis=axes))


@pytest.mark.parametrize("top", [2, 3, 4, 127])
def test_fast_sums_hold_while_called_values_are_small(top):
    """The fast sums (a warp's pass takes them when no lane's ``big`` is
    set) give the general sums' counts whenever every called value is 0,
    1 or 2, and ``big`` is set exactly when one is not."""
    rng = np.random.default_rng(top)
    d = rng.integers(-3, top + 1, (4_000, 8)).astype(np.int8)
    d[rng.random(d.shape) < 0.3] = 0
    x = np.ascontiguousarray(d).view("<u4").reshape(-1, 2)
    fast, big = fast_sums(x)
    gen = swar_counts(x)
    called = d >= 0
    want_big = (called & (d > 2)).any(axis=1)
    np.testing.assert_array_equal(big != 0, want_big)
    ok = ~want_big
    words = 1                                # each row is one 8-byte word
    from_fast = from_moments({"unc": fast["unc"], "ns": 8 * words
                              + fast["unc"], "s1": fast["alt"],
                              "s2": fast["q"], "n3": 0 * fast["q"]}, words)
    for k, v in from_moments(gen, words).items():
        np.testing.assert_array_equal(from_fast[k][ok], v[ok], err_msg=k)
    np.testing.assert_array_equal(fast["alt"], gen["alt"])
    np.testing.assert_array_equal(fast["unc"], gen["unc"])


def test_swar_forms_agree():
    """The kernel's prmt / dp4a form and the first design's
    __vcmpges4 / __vcmpeq4 / __popc form count the same, on every byte
    value in every position."""
    rng = np.random.default_rng(1)
    vals = np.arange(256, dtype=np.uint32)
    x = np.concatenate([vals * 0x01010101, vals | (vals[::-1] << 8)
                        | (rng.permutation(vals) << 16) | (vals << 24),
                        rng.integers(0, 1 << 32, 20_000, dtype=np.uint64)
                        .astype(np.uint32)])
    for xi in np.array_split(x, 64):
        got = from_moments(swar_counts(xi[None]), xi.size / 2)
        c = vcmpges4(xi, 0)
        assert got["called"] == popc(c).sum() // 8
        for k in range(3):
            assert got[f"n{k}"] == popc(vcmpeq4(xi, k * 0x01010101)).sum() // 8
        assert swar_counts(xi[None])["alt"] == dp4a(xi & c, 0x01010101).sum()


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------

def grid(cap, resident=RESIDENT, slots=None):
    G = min(resident, max(cap, 1))
    return G if slots is None else min(G, slots)


def plan(cap, count, spad, resident=RESIDENT):
    """The kernel's row partition: (G, live, [(row, cta, step, warp)] in
    each CTA's program order for the rows under the count, and how many
    times the grid-stride loop writes each row past it)."""
    G = grid(cap, resident)
    live = max(0, min(int(count), cap))
    work = []
    for c in range(G):
        J = -(-(live - c) // G) if live > c else 0
        for s in range(-(-J // WARPS)):
            for warp in range(WARPS):
                j = s * WARPS + warp
                if j < J:
                    work.append((c + G * j, c, s, warp))
    writes = np.zeros(cap, np.int64)
    first = live + np.arange(G * THREADS, dtype=np.int64)
    r = first
    while r.size and r.min() < cap:
        np.add.at(writes, r[r < cap], 1)
        r = r + G * THREADS
    return G, live, work, writes


@pytest.mark.parametrize("cap, count, spad, resident", [
    (3352, 200, 2504, RESIDENT), (3352, 3352, 2504, RESIDENT),
    (3352, 800, 2504, RESIDENT), (4096, 200, 2504, RESIDENT),
    (4096, 4096, 2504, RESIDENT), (64, 37, 304, RESIDENT),
    (16, 16, 8, RESIDENT), (3352, 3352, 2504, 4), (100, 0, 16, RESIDENT),
    (5000, 4999, 64, 7), (0, 0, 8, RESIDENT)])
def test_every_row_computed_once_and_written_once(cap, count, spad,
                                                  resident):
    G, live, work, writes = plan(cap, count, spad, resident)
    rows = [w[0] for w in work]
    assert sorted(rows) == list(range(live)), "each live row computed once"
    assert all(r % G == c for r, c, _, _ in work), "row r in CTA r mod G"
    assert (writes[:live] == 0).all() and (writes[live:] == 1).all(), \
        "each row past the count written once, no live row by the sweep"
    # the same warp never holds two rows in one step
    assert len({(c, s, w) for _, c, s, w in work}) == len(work)


def test_live_rows_spread_over_the_card():
    """The main path's tile: 200 live rows of 3,352 land on 200 CTAs (the
    rows numbered into CTAs of 8 put them on 25); the full tile's rows
    on every CTA."""
    G, live, work, _ = plan(3352, 200, 2504)
    ctas = {c for _, c, _, _ in work}
    assert len(ctas) >= 100 and len(ctas) == min(200, G)
    G, _, work, _ = plan(3352, 3352, 2504)
    assert len({c for _, c, _, _ in work}) == G


def lane_words(spad, S):
    """For each lane l, the 8-byte words it loads in order (passes of
    kWords); it leaves the others at 0xFF."""
    nw = spad // 8
    nw_s = (min(S, spad) + 7) // 8
    loads = [[] for _ in range(32)]
    for base in range(0, nw, 32 * WORDS):
        for lane in range(32):
            for u in range(WORDS):
                wi = base + lane + 32 * u
                if wi < nw_s:
                    loads[lane].append(wi)
    return loads


@pytest.mark.parametrize("spad, S", [(2504, 2504), (528, 517), (304, 300),
                                     (8, 1), (24, 20), (40_000, 39_999),
                                     (2504, 2503), (2504, 2500)])
def test_lanes_read_each_word_below_n_samples_once(spad, S):
    loads = lane_words(spad, S)
    flat = sorted(w for ws in loads for w in ws)
    assert flat == list(range((min(S, spad) + 7) // 8))
    for L, ws in enumerate(loads):
        assert all(b > a for a, b in zip(ws, ws[1:])), "in order"
        assert all(w % 32 == L for w in ws)
    if spad == 2504:
        assert max(len(ws) for ws in loads) == WORDS == 10, \
            "one pass: all of a lane's words in flight at once"


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

def _words(d, S):
    """The tile's rows as the lanes see them: uint32 [cap, nw, 2] (each
    8-byte word's halves), words at or past n_samples 0xFF, the word
    holding it masked past it."""
    cap, spad = d.shape
    nw = spad // 8
    S = min(S, spad)
    nw_s, full = (S + 7) // 8, S // 8
    w = np.ascontiguousarray(d).view("<u8").reshape(cap, nw).copy()
    w[:, nw_s:] = np.uint64(0xFFFFFFFFFFFFFFFF)
    if S % 8:
        w[:, full] |= np.uint64((0xFFFFFFFFFFFFFFFF << (8 * (S % 8)))
                                & 0xFFFFFFFFFFFFFFFF)
    return np.stack([(w & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (w >> np.uint64(32)).astype(np.uint32)], axis=2)


def _stage(pheno, spad, S):
    """The staged phenotype: y' float32 [spad] and the finite mask as
    uint32 [nw, 2] (0xFF a column)."""
    col = np.arange(spad)
    ok = np.isfinite(pheno) & (col < S)
    y = np.where(ok, pheno, np.float32(0)).astype(np.float32)
    fb = np.where(ok, 0xFF, 0).astype(np.uint32).reshape(-1, 2, 4)
    return y, _join([fb[..., k] for k in range(4)])


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _lane_sums(tsy, tyy_a, tyy_b, gy_a, gy_b, order):
    """Each row's Sy (of tsy), Syy (fma of tyy_a, tyy_b) and Sgy (fma of
    gy_a, gy_b) in the kernel's order: lane L adds its columns
    (``order[L]``, its words' columns in turn), the warp's butterfly, the
    Inputs [rows, columns]."""
    rows = tsy.shape[0]
    TL = 32
    n = max(len(o) for o in order)
    idx = np.full((TL, n), -1, np.int64)
    for L, o in enumerate(order):
        idx[L, :len(o)] = o
    acc = [np.zeros((rows, TL), np.float32) for _ in range(3)]
    for p in range(n):
        cols = idx[:, p]
        on = cols >= 0
        cc = np.where(on, cols, 0)
        sy = acc[0] + np.where(on, tsy[:, cc], np.float32(0))
        syy = _fma(np.where(on, tyy_a[:, cc], np.float32(0)), tyy_b[:, cc],
                   acc[1])
        sgy = _fma(np.where(on, gy_a[:, cc], np.float32(0)), gy_b[:, cc],
                   acc[2])
        acc = [sy.astype(np.float32), syy, sgy]
    out = []
    lanes = np.arange(TL)
    for v in acc:
        for o in (16, 8, 4, 2, 1):
            v = (v + v[:, lanes ^ o]).astype(np.float32)
        tot = v[:, 0]
        out.append(tot)
    return out


def model_gwas(d, count, pheno, S, resident=RESIDENT):
    """K17a's outputs [cap, 4] as the kernel computes them, and its
    integer counts {name: int64 [cap]} of the rows under the count."""
    cap, spad = d.shape
    G, live, work, _ = plan(cap, count, spad, resident)
    f32 = np.float32
    nw_s = (min(S, spad) + 7) // 8
    x = _words(d[:live], S)[:, :nw_s]       # no lane loads a word past them
    y = f = None
    if pheno is not None:
        y, f = _stage(pheno, spad, S)
        y, f = y[:8 * nw_s], f[:nw_s]
    sums = swar_counts(x, None if f is None else f[None])
    cnt = dict(from_moments(sums, nw_s), alt=sums["alt"])
    out = np.full((cap, 4), np.nan, np.float32)
    if pheno is not None:
        cnt.update(n=sums["n"], sg=sums["sg"], sgg=sums["sgg"])
        # the float work a byte: t = y' where called, g = the called value
        raw = np.stack(_bytes(x), axis=-1).reshape(live, 8 * nw_s)
        yb = np.broadcast_to(y, raw.shape)
        tsy = np.where(raw < 0x80, yb, np.float32(0)).astype(np.float32)
        g = np.where(raw < 0x80, raw, 0).astype(np.float32)
        order = [[8 * w + k for w in ws for k in range(8)]
                 for ws in lane_words(spad, S)]
        sy, syy, sgy = _lane_sums(tsy, tsy, yb, g, yb, order)
    ncf = cnt["called"].astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        af = np.where(cnt["called"] > 0, cnt["alt"].astype(f32)
                      / (f32(2) * np.maximum(ncf, f32(1))), np.nan)
        cr = ncf * (f32(1) / f32(max(S, 1)))
        f0, f1, f2 = (cnt[k].astype(f32) for k in ("n0", "n1", "n2"))
        m = (f0 + f1) + f2
        p = (f32(2) * f2 + f1) / (f32(2) * np.maximum(m, f32(1)))
        q = f32(1) - p
        e = ((q * q) * m, ((f32(2) * p) * q) * m, (p * p) * m)

        def term(o, ex):
            dd = o - ex
            return np.where(ex > 0, (dd * dd) / np.maximum(ex, f32(1e-12)),
                            f32(0))
        hwe = np.where(m > 0, (term(f0, e[0]) + term(f1, e[1]))
                       + term(f2, e[2]), np.nan)
        score = np.full(live, np.nan, np.float32)
        if pheno is not None:
            nf = cnt["n"].astype(f32)
            ns = np.maximum(nf, f32(1))
            sgf, sggf = cnt["sg"].astype(f32), cnt["sgg"].astype(f32)
            uu = sgy - (sy * sgf) / ns
            vg = sggf - (sgf * sgf) / ns
            vy = (syy - (sy * sy) / ns) / ns
            den = vy * vg
            score = np.where((nf > 1) & (den > f32(1e-12)),
                             (uu * uu) / np.maximum(den, f32(1e-12)), np.nan)
    out[:live] = np.stack([af, cr, hwe, score], axis=1).astype(np.float32)
    return out, cnt


def _jax_gwas(d, count, pheno, S):
    import jax

    from hadoop_bam_tpu.cohort.gwas import make_cohort_gwas_step
    from hadoop_bam_tpu.parallel.mesh import make_mesh
    from hadoop_bam_tpu.parallel.variant_pipeline import VariantGeometry

    mesh = make_mesh(devices=jax.devices("cpu")[:1])
    geom = VariantGeometry(tile_records=d.shape[1], n_samples=S)
    step = make_cohort_gwas_step(mesh, geom, pheno is not None)
    y = pheno if pheno is not None else np.full(d.shape[2], np.nan,
                                                np.float32)
    return np.asarray(step(d, np.asarray([count], np.int32), y))


def _hold(got, want, what):
    np.testing.assert_array_equal(got[..., :2], want[..., :2], err_msg=what)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-5,
                               atol=1e-6, equal_nan=True, err_msg=what)


def _int_counts(d, count, S):
    """The integer counts by plain byte arithmetic, rows under count."""
    dd = d[:count].astype(np.int64)
    called = (dd >= 0) & (np.arange(d.shape[1]) < S)[None, :]
    out = {"called": called.sum(1), "alt": np.where(called, dd, 0).sum(1)}
    for k in range(3):
        out[f"n{k}"] = ((dd == k) & called).sum(1)
    return out, called


@pytest.mark.parametrize("case", synth.GWAS_CASES)
def test_model_matches_plain_and_jax(case):
    d, count, pheno, S = synth.gwas_case(case)
    got, cnt = model_gwas(d[0], count, pheno, S)
    want_ints, called = _int_counts(d[0], count, S)
    for k, v in want_ints.items():
        np.testing.assert_array_equal(cnt[k], v, err_msg=k)
    if pheno is not None:
        use = called & (np.isfinite(pheno) & (np.arange(d.shape[2]) < S))
        g = np.where(use, d[0, :count].astype(np.int64), 0)
        np.testing.assert_array_equal(cnt["n"], use.sum(1))
        np.testing.assert_array_equal(cnt["sg"], g.sum(1))
        np.testing.assert_array_equal(cnt["sgg"], (g * g).sum(1))
    plain = tg.cohort_gwas_plain(torch.from_numpy(d), count,
                                 None if pheno is None
                                 else torch.from_numpy(pheno), S).numpy()
    _hold(got[None], plain, f"{case} against plain")
    _hold(got[None], _jax_gwas(d, count, pheno, S), f"{case} against JAX")


@pytest.mark.parametrize("S", [1, 3, 4, 5, 7, 9, 13, 63, 517])
def test_tail_mask_for_any_sample_count(S):
    """n_samples not a multiple of 4 or 8: the columns at or past it hold
    values the step must not count (-1..3), in a pad of up to 15."""
    rng = np.random.default_rng(S)
    spad = -(-S // 8) * 8 + 8
    d = rng.integers(-1, 4, (1, 40, spad)).astype(np.int8)
    pheno = rng.standard_normal(spad).astype(np.float32)
    pheno[rng.random(spad) < 0.2] = np.nan
    got, cnt = model_gwas(d[0], 33, pheno, S)
    want_ints, _ = _int_counts(d[0], 33, S)
    for k, v in want_ints.items():
        np.testing.assert_array_equal(cnt[k], v, err_msg=k)
    _hold(got[None], _jax_gwas(d, 33, pheno, S), f"S={S}")


def test_staged_phenotype_fits_shared_memory():
    """y' (two float4 a word) and the finite mask (a uint2 a word): 5 B a
    column, under the 48 KB a CTA has without an opt-in, with the warps'
    16-byte partials of K17b beside it."""
    assert 5 * STAGE_MAX + WARPS * 16 <= 48 * 1024
    assert STAGE_MAX % 8 == 0 and STAGE_MAX >= 2504


# ---------------------------------------------------------------------------
# K17b
# ---------------------------------------------------------------------------

def model_slice(chrom, pos, dosage, count, iv, resident=RESIDENT):
    """K17b's five outputs as the kernel computes them, its sums in its
    order: a warp's rows in step order, the CTA's warps in order, the
    CTAs' partials by the last CTA (lane l the partials l, l + 32, ...,
    then a butterfly), float64, af_sum rounded to float32 once."""
    cap, spad = dosage.shape[1:]
    count = int(count[0])
    G, live, work, _ = plan(cap, count, spad, resident)
    stats, _ = model_gwas(dosage[0], count, None, spad, resident)
    af = stats[:, 0]
    keep = np.zeros(cap, bool)
    keep[:live] = ((chrom[0, :live] == iv[0]) & (pos[0, :live] >= iv[1])
                   & (pos[0, :live] <= iv[2]))
    part = np.zeros((G, WARPS, 3))
    for r, c, s, w in work:              # each warp in step order
        if keep[r]:
            part[c, w, 0] += 1
            if not np.isnan(af[r]):
                part[c, w, 1] += 1
                part[c, w, 2] = part[c, w, 2] + np.float64(af[r])
    cta = np.zeros((G, 3))
    for k in range(WARPS):
        cta = cta + part[:, k]
    lanes = np.zeros((32, 3))
    for b in range(G):
        lanes[b % 32] = lanes[b % 32] + cta[b]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ o]
    hits, an, asum = lanes[0]
    return (keep[None], np.asarray([hits], np.int32), af[None],
            np.asarray([asum], np.float64).astype(np.float32),
            np.asarray([an], np.int32))


def _slice_hold(got, want, what):
    for name, g, w in zip(("keep", "hits", "af", "af_sum", "af_n"), got,
                          want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        if name == "af_sum":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


def _small_tile():
    """tests/test_torch_cohort.py's K17b tile."""
    rng = np.random.default_rng(5)
    cap, spad, count = 64, 24, 50
    chrom = np.full((1, cap), -1, np.int32)
    pos = np.zeros((1, cap), np.int32)
    chrom[0, :count] = np.sort(rng.integers(0, 2, count))
    pos[0, :count] = np.sort(rng.integers(1, 300, count))
    dosage = rng.integers(-1, 3, (1, cap, spad)).astype(np.int8)
    dosage[0, :count][rng.random((count, spad)) < 0.3] = -1
    dosage[0, 3] = -1
    dosage[0, count:] = -1
    dosage[0, :, 20:] = -1
    return chrom, pos, dosage, np.asarray([count], np.int32)


def _jax_slice(chrom, pos, dosage, count, iv):
    import jax

    from hadoop_bam_tpu.cohort.serving import make_cohort_slice_step
    from hadoop_bam_tpu.parallel.mesh import make_mesh
    step = make_cohort_slice_step(make_mesh(devices=jax.devices("cpu")[:1]))
    return [np.asarray(x) for x in step(chrom, pos, dosage, count, iv)]


@pytest.mark.parametrize("resident", [RESIDENT, 3])
@pytest.mark.parametrize("iv", [(0, 1, 200), (0, 150, 100_000),
                                (1, 1, 10), (0, 5, 4)])
def test_slice_model_matches_the_jax_step(iv, resident):
    tile = _small_tile()
    ivs = np.asarray(iv, np.int32)
    got = model_slice(*tile, ivs, resident)
    _slice_hold(got, _jax_slice(*tile, ivs), f"{iv} against JAX")
    _slice_hold(got, [x.numpy() for x in tsv.cohort_slice_plain(
        *map(torch.from_numpy, (*tile, ivs)))], f"{iv} against plain")


@pytest.mark.parametrize("case", synth.SLICE_CASES)
def test_slice_model_on_the_serve_tile(case):
    """The serve's tile (4,096 x 2,504) in each card case: the model's
    reduction order against the JAX step and the plain version."""
    tile = synth.slice_case(case)
    got = model_slice(*tile)
    _slice_hold(got, _jax_slice(*tile), f"{case} against JAX")
    _slice_hold(got, [x.numpy() for x in tsv.cohort_slice_plain(
        *map(torch.from_numpy, tile))], f"{case} against plain")


def test_af_sum_is_exact_in_float64():
    """At the serve's width (samples_pad 2,504) 4,096 float32 AFs (alt /
    2n, n <= samples_pad) add exactly in float64, so any order of the
    partials gives one af_sum (the bound: ``test_af_sum_exact_width``)."""
    rng = np.random.default_rng(3)
    n = rng.integers(1, 2505, 4096)
    af = (rng.integers(0, 2 * n + 1) / (2.0 * n)).astype(np.float32)
    a = af.astype(np.float64)
    sums = {float(np.sum(a[rng.permutation(a.size)])) for _ in range(8)}
    from fractions import Fraction
    exact = sum(Fraction(float(v)) for v in af)
    assert sums == {float(exact)} and Fraction(sums.pop()) == exact


@pytest.mark.parametrize("n_max,exact", [(131_072, True),
                                         (1_000_000, False)])
def test_af_sum_exact_width(n_max, exact):
    """The kernel's claim: cap float32 AFs with n <= samples_pad add
    exactly in float64 while cap 2^k <= 2^30, 2^k the power of two at or
    above 2 samples_pad (each AF a multiple of 2^-(k + 23)).  At cap
    4,096 that holds to 131,072 samples; at 10^6 the float64 sum is no
    longer exact, and the kernel's fixed order alone makes it
    deterministic."""
    from fractions import Fraction
    cap = 4096
    k = int(np.ceil(np.log2(2 * n_max)))
    assert (cap << k <= 1 << 30) == exact
    rng = np.random.default_rng(11)
    n = rng.integers(n_max // 2, n_max + 1, cap)
    af = (rng.integers(0, 2 * n + 1) / (2.0 * n)).astype(np.float32)
    af[: cap // 2] = np.float32(1) - np.float32(2.0 ** -24)
    af[-1] = np.float32(1 / (2.0 * n_max))
    got = float(np.sum(af.astype(np.float64)))
    assert (Fraction(got) == sum(Fraction(float(v)) for v in af)) == exact
