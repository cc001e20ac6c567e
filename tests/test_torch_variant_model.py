"""K11's fused unpack (``variant_unpack``, ``csrc/variant_gt.cu``) on the
CPU: its plain version and a numpy model of the kernel's partition, held
against the JAX package's formulas (``variant_prefix_device`` :391,
``variant_gt_dosage_device`` :413 and the reference device plane's -1
tile and per-group scatter).

The model runs the kernel's work split with buf's and the tile's
addresses mod 16 as parameters (only their residues matter):

- the packed metadata (``pack_variant_meta``) read as the kernel reads
  it: header, one 16-byte entry a tile row (GT offset, row, layout,
  n_sample), starts, flags;
- one flat task list walked by a grid stride: (row entry, 512 columns)
  with the next entry loaded ahead, then (32 rows of CHROM / POS /
  flags);
- the interior rule (off >= 0, off + width*count*n_sample <= L) that
  sends a row to the aligned path;
- lane i's aligned 16-byte words (two for diploid, one for haploid),
  the next word from lane i + 1 (``__shfl_down_sync``; lane 31 loads
  it) and ``__funnelshift_r`` at the task's byte shift;
- the diploid and haploid decode by SWAR byte classes and
  ``__byte_perm``, the generic layouts' loop, the stores (8-byte where
  the tile row is 8-byte aligned, else bytes).

It checks what the kernel relies on: an aligned load never leaves buf,
every cell of the tile and every row of the columns is written exactly
once, and the header's sections fit the array.  Every output is an
integer and must match exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_bam_tpu.ops.inflate_device import (
    variant_gt_dosage_device, variant_prefix_device,
)
from hadoop_bam_torch import synth
from hadoop_bam_torch.ops import inflate_device as tid
from test_torch_interval_model import U32, _i32, funnelshift_r, word_at

FILL_COLS = 512


def _round_pow2(x):
    R = 8
    while R < x:
        R <<= 1
    return R


def _jax_tile(buf, meta, R, s_pad):
    """The reference device plane's tile (parallel/variant_pipeline.py
    :778-797): the prefix at the starts padded with 0, a -1 tile, each
    group's dosages scattered at its rows, the flags padded with 0."""
    n = int(meta["n"])
    jb = jnp.asarray(buf)
    s32 = np.zeros(R, np.int32)
    s32[:n] = meta["starts"]
    chrom, pos = variant_prefix_device(jb, jnp.asarray(s32))
    flags = np.zeros(R, np.uint8)
    flags[:n] = meta["flags"]
    dosage = jnp.full((R, s_pad), -1, jnp.int8)
    for rows, offs, width, count, n_sample in meta["gt_groups"]:
        offs_p = np.zeros(_round_pow2(rows.size), np.int32)
        offs_p[:rows.size] = offs
        d = variant_gt_dosage_device(jb, jnp.asarray(offs_p), width, count,
                                     n_sample)[:rows.size]
        dosage = dosage.at[jnp.asarray(rows.astype(np.int32))[:, None],
                           jnp.arange(n_sample)].set(d)
    return (np.asarray(chrom), np.asarray(pos), flags, np.asarray(dosage))


def _span(case, seed):
    _, groups, n, s_pad = synth.UNPACK_CASES[case]
    return synth.unpack_span(groups, n, s_pad, seed=seed)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def classes(w):
    """The kernel's SWAR byte classes of uint32 words w (bit 7 of each
    byte): ALT, bad, END_OF_VECTOR."""
    w = np.asarray(w, np.int64) & U32
    alt = ((w & 0x7F7F7F7F) + 0x7C7C7C7C) & ~w & 0x80808080
    t = w & 0x7E7E7E7E
    z = ~((t + 0x7F7F7F7F) | t) & 0x80808080
    u = w ^ 0x81818181
    eov = ~(((u & 0x7F7F7F7F) + 0x7F7F7F7F) | u) & 0x80808080
    return alt, z & ~eov & U32, eov


def calls2(w):
    """Two diploid calls of a word, in bytes 0 and 2."""
    alt, bad, eov = classes(w)
    off = bad | (bad >> 8) | (eov & (eov >> 8))
    n_alt = ((alt >> 7) & 0x00010001) + ((alt >> 15) & 0x00010001)
    return n_alt | (((off >> 7) & 0x00010001) * 0xFF)


def calls1(w):
    alt, bad, eov = classes(w)
    return ((alt >> 7) & 0x01010101) | ((((bad | eov) >> 7) & 0x01010101)
                                        * 0xFF)


def byte_perm_6420(x, y):
    """``__byte_perm(x, y, 0x6420)``: bytes 0 and 2 of x, then of y."""
    return ((x & 0xFF) | ((x >> 16) & 0xFF) << 8 | (y & 0xFF) << 16
            | ((y >> 16) & 0xFF) << 24)


def pad_calls(d, k, nv):
    m = nv - 4 * k
    return np.where(m >= 4, d, np.where(
        m <= 0, U32, d | ((U32 << (8 * np.clip(m, 0, 3))) & U32)))


def as_words(b):
    """[..., 4k] bytes -> [..., k] little-endian uint32."""
    b = np.asarray(b, np.int64).reshape(*np.shape(b)[:-1], -1, 4)
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def words_to_calls(d):
    """[..., 4] call words -> [..., 16] calls as int8 values."""
    d = np.asarray(d, np.int64)
    b = (d[..., None] >> (8 * np.arange(4))) & 0xFF
    return b.reshape(*d.shape[:-1], 16).astype(np.uint8).view(np.int8)


def _header(packed):
    h = [int(x) for x in packed[:5]]
    return dict(zip(("n", "P", "mode", "starts", "flags"), h))


def sections_fit(packed, R):
    """The kernel's header check (a failing one traps)."""
    h, m = _header(packed), len(packed)
    room = (m - 8) // 4
    ok = True
    if h["mode"] & tid.MODE_PREFIX:
        ok &= h["starts"] >= 8 and h["starts"] + R <= m
    if h["mode"] & tid.MODE_FLAGS:
        ok &= h["flags"] >= 8 and 4 * h["flags"] + R <= 4 * m
    if h["mode"] & tid.MODE_DOSAGE:
        ok &= 0 <= h["P"] <= room
    return ok


def walk(total, warps, t_rows, chunks):
    """Each warp's tasks in grid-stride order, with the entry each row
    task reads: its first loaded beside the header, each next one ahead
    of the current task's work."""
    seen = np.zeros(total, np.int64)
    for w in range(warps):
        ahead = (w // chunks, w % chunks) if chunks else None
        for t in range(w, total, warps):
            seen[t] += 1
            if t < t_rows:
                assert ahead == divmod(t, chunks)
                cur = ahead
                if t + warps < t_rows:
                    ahead = divmod(t + warps, chunks)
                yield t, cur
            else:
                yield t, None
    assert (seen == 1).all(), "a task walked other than once"


def interior(off, nbytes, L):
    return off >= 0 and off + nbytes <= L


def load16(buf, base, addr):
    """An aligned 16-byte load at address ``addr``, which must lie in
    buf: four little-endian uint32."""
    assert addr % 16 == 0 and base <= addr and addr + 16 <= base + buf.size, \
        "an aligned load left buf"
    return as_words(buf[addr - base:addr - base + 16])


def lane_bytes(buf, base, off, C, ns, chunk):
    """Each lane's 16 * C GT bytes of a width-1 row's task ([32, 16 * C]
    int64) and whether the task took the aligned path (None: no GT
    bytes)."""
    L = buf.size
    s0 = chunk * 512
    s_end = min(s0 + 512, ns)
    v = np.zeros((32, 16 * C), np.int64)
    if s_end <= s0:
        return v, None
    fast = interior(off, C * ns, L)
    if fast:
        p0 = base + off + C * s0
        p1 = base + off + C * s_end
        a0, a1 = p0 & ~15, (p1 + 15) & ~15
        fast = a0 >= base and a1 <= base + L
    if fast:
        words = np.zeros((32 * C + 1, 4), np.int64)
        for i in range(32 * C + 1):
            if a0 + 16 * i < p1:
                words[i] = load16(buf, base, a0 + 16 * i)
        sh = p0 & 15
        q, r = sh >> 2, (sh & 3) * 8
        for lane in range(32):
            # lane i + 1's first word by the shuffle; lane 31 loads it
            cat = words[C * lane:C * lane + C + 1].ravel()
            out = [funnelshift_r(cat[q + k], cat[q + k + 1], r)
                   for k in range(4 * C)]
            for j in range(16 * C):
                v[lane, j] = (out[j // 4] >> (8 * (j % 4))) & 0xFF
    else:
        lanes = s0 + 16 * np.arange(32)
        for j in range(16 * C):
            k = C * lanes + j
            idx = np.clip(_i32(off + k), 0, L - 1)
            v[:, j] = np.where(k < C * ns, buf[idx], 0)
    return v, fast


def generic_calls(buf, off, width, count, ns):
    """One row's calls of any layout by the plain formula (the generic
    instantiation's arithmetic): int64 [ns]."""
    L = buf.size
    k = np.arange(width * count * ns, dtype=np.int64)
    raw = buf[np.clip(_i32(off + k), 0, L - 1)].astype(np.int64)
    raw = raw.reshape(ns, count, width)
    w = (raw << (8 * np.arange(width))).sum(-1)
    sbit = 1 << (8 * width - 1)
    g = (w ^ sbit) - sbit
    present = g != -sbit + 1
    miss = present & (((g >> 1) == 0) | (g == -sbit))
    alt = present & (((g >> 1) - 1) > 0)
    return np.where(present.any(1) & ~miss.any(1),
                    np.minimum(alt.sum(1), 127), -1)


def store(tile, writes, row_addr, row, cols, col, calls):
    """A lane's 16 calls at [col, col + 16): 8-byte granules where the
    row is 8-byte aligned and the granule whole, else bytes; columns at
    or past cols left alone."""
    for k in range(0, 16, 8):
        c = col + k
        if c >= cols:
            return
        if row_addr % 8 == 0 and c + 8 <= cols:
            assert (row_addr + c) % 8 == 0
            sl = slice(c, c + 8)
        else:
            sl = slice(c, min(c + 8, cols))
        tile[row, sl] = calls[k:k + sl.stop - sl.start]
        writes[row, sl] += 1


def task_calls(buf, base, e, chunk, ns):
    """[32, 16] calls of one row task (entry e), and its path."""
    width, count = e[2] & 0xFF, e[2] >> 8
    s_lane = chunk * 512 + 16 * np.arange(32)
    nv = ns - s_lane
    if width == 0:
        return np.full((32, 16), -1), None
    if width == 1 and count in (1, 2):
        v, fast = lane_bytes(buf, base, int(e[0]), count, ns, chunk)
        w = as_words(v)
        if count == 2:
            d = [byte_perm_6420(calls2(w[:, 2 * k]), calls2(w[:, 2 * k + 1]))
                 for k in range(4)]
        else:
            d = [calls1(w[:, k]) for k in range(4)]
        d = np.stack([pad_calls(d[k], k, nv) for k in range(4)], 1)
        return words_to_calls(d), "fast" if fast else "scalar"
    s = s_lane[:, None] + np.arange(16)
    row = np.append(generic_calls(buf, int(e[0]), width, count, ns), -1)
    return row[np.where(s < ns, s, ns)], "generic"


def model_unpack(buf, packed, R, s_pad, base=0, tile_base=0, warps=24,
                 tile=None):
    """The kernel in numpy: (chrom, pos, flags, dosage, info), ``tile``
    the dosage tile before the launch (the gt_dosage mode writes into
    its caller's)."""
    buf = np.asarray(buf, np.uint8)
    packed = np.asarray(packed, np.int32)
    assert sections_fit(packed, R)
    h = _header(packed)
    mode = h["mode"]
    fill = bool(mode & tid.MODE_FILL)
    chunks = -(-s_pad // 512)
    t_rows = h["P"] * chunks if mode & tid.MODE_DOSAGE else 0
    total = t_rows + (-(-R // 32) if mode & (tid.MODE_PREFIX
                                             | tid.MODE_FLAGS) else 0)
    entries = packed[8:8 + 4 * h["P"]].reshape(-1, 4).astype(np.int64)
    dosage = (np.full((R, s_pad), 0x5A, np.int64) if tile is None
              else tile.astype(np.int64).copy())
    writes = np.zeros((R, s_pad), np.int64)
    chrom = np.zeros(R, np.int64)
    pos = np.zeros(R, np.int64)
    flags = np.zeros(R, np.int64)
    row_writes = np.zeros(R, np.int64)
    info = {"fast": 0, "scalar": 0, "generic": 0, "tasks": total}
    lanes = np.arange(32)
    for t, ahead in walk(total, warps, t_rows, chunks):
        if ahead is not None:
            i, chunk = ahead
            e = entries[i]
            row, width = int(e[1]), int(e[2]) & 0xFF
            ns = min(max(int(e[3]), 0), s_pad)
            cols = s_pad if (width == 0 or fill) else ns
            if not 0 <= row < R or chunk * 512 >= cols:
                continue
            calls, path = task_calls(buf, base, e, chunk, ns)
            if path:
                info[path] += 1
            for lane in range(32):
                store(dosage, writes, tile_base + row * s_pad, row, cols,
                      chunk * 512 + 16 * lane, calls[lane])
        else:
            r = (t - t_rows) * 32 + lanes
            r = r[r < R]
            if mode & tid.MODE_PREFIX:
                s = packed[h["starts"] + r].astype(np.int64) & U32
                chrom[r] = _i32(word_at(buf, base, (s + 8) & U32)[0])
                pos[r] = _i32(word_at(buf, base, (s + 12) & U32)[0] + 1)
            if mode & tid.MODE_FLAGS:
                flags[r] = packed.view(np.uint8)[4 * h["flags"] + r]
            row_writes[r] += 1
    info["writes"] = writes
    info["row_writes"] = row_writes
    return (chrom.astype(np.int32), pos.astype(np.int32),
            flags.astype(np.uint8), dosage.astype(np.int8), info)


# ---------------------------------------------------------------------------
# the plain version and the packer against the reference
# ---------------------------------------------------------------------------

CASES = [(c, s) for c in range(len(synth.UNPACK_CASES)) for s in (0, 1)]


@pytest.mark.parametrize("case,seed", CASES)
def test_plain_matches_jax(case, seed):
    """``variant_unpack`` on CPU tensors (its plain version, no launch)
    against the reference's prefix, -1 tile and per-group scatter:
    multi-group spans, pads, rows of no group, n_sample < samples_pad,
    widths 1 / 2 / 4, saturation, clip and wrap edges."""
    buf, meta, R, s_pad = _span(case, seed)
    packed = tid.pack_variant_meta(meta, R)
    before = tid.variant_unpack.launches
    got = tid.variant_unpack(torch.from_numpy(buf), torch.from_numpy(packed),
                             R, s_pad)
    assert tid.variant_unpack.launches == before
    for g, w in zip(got, _jax_tile(buf, meta, R, s_pad)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.uint8,
                                      torch.int8]


@pytest.mark.parametrize("case", range(len(synth.UNPACK_CASES)))
def test_pack_round_trips_and_fits(case):
    buf, meta, R, s_pad = _span(case, 3)
    packed = tid.pack_variant_meta(meta, R)
    assert sections_fit(packed, R)
    h = _header(packed)
    assert h["P"] == R and h["starts"] == 8 + 4 * R
    assert h["flags"] == h["starts"] + R
    back = tid.unpack_variant_meta(packed)
    n = meta["n"]
    assert back["n"] == n and back["R"] == R and back["mode"] == tid.MODE_ALL
    np.testing.assert_array_equal(back["starts"][:n], meta["starts"])
    np.testing.assert_array_equal(back["flags"][:n], meta["flags"])
    assert not back["starts"][n:].any() and not back["flags"][n:].any()
    assert len(back["gt_groups"]) == len(meta["gt_groups"])
    covered = []
    for (r, o, *lay), (r2, o2, *lay2) in zip(back["gt_groups"],
                                             meta["gt_groups"]):
        np.testing.assert_array_equal(r, r2)
        np.testing.assert_array_equal(o, o2)
        assert lay == lay2
        covered += list(r)
    np.testing.assert_array_equal(
        back["fill_rows"], np.setdiff1d(np.arange(n), covered))


def test_pack_round_trips_a_real_bcf_span(tmp_path):
    """The cursor metadata of real synthetic BCF spans (rows on 20, and
    on X, where the haploid males' second GT entry is END_OF_VECTOR)
    packs and unpacks unchanged, and the model's tile from the packed
    array equals the host columnar decode's."""
    from hadoop_bam_torch.api.vcf_dataset import open_vcf
    from hadoop_bam_torch.formats.bcf_columns import (
        decode_bcf_columns, decode_bcf_cursor_meta,
    )
    from hadoop_bam_torch.parallel.variant_pipeline import VariantGeometry
    from hadoop_bam_torch.split.vcf_planners import read_bcf_span_frames
    p = str(tmp_path / "kg.bcf")
    synth.write_synthetic_vcf(p, 1200, 4, n_samples=97, x_records=300)
    ds = open_vcf(p, device="cpu")
    pad = VariantGeometry(n_samples=97).samples_pad
    layouts = set()
    for span in ds.spans(3):
        raw, starts = read_bcf_span_frames(p, span, True)
        meta = decode_bcf_cursor_meta(raw, ds.header, pad, starts=starts)
        n = meta["n"]
        R = tid.round_pow2(n, 8)
        packed = tid.pack_variant_meta(meta, R)
        back = tid.unpack_variant_meta(packed)
        np.testing.assert_array_equal(back["starts"][:n], meta["starts"])
        np.testing.assert_array_equal(back["flags"][:n], meta["flags"])
        for (r, o, *lay), (r2, o2, *lay2) in zip(back["gt_groups"],
                                                 meta["gt_groups"]):
            np.testing.assert_array_equal(r, r2)
            np.testing.assert_array_equal(o, o2)
            assert lay == lay2
            layouts.add(tuple(lay))
        assert back["fill_rows"].size == 0
        cols = decode_bcf_columns(raw, ds.header, pad, starts=starts)
        buf = np.frombuffer(raw, np.uint8)
        got = model_unpack(buf, packed, R, pad)
        for k, g in zip(("chrom", "pos", "flags", "dosage"), got):
            np.testing.assert_array_equal(g[:n], cols[k], k)
    assert layouts == {(1, 2, 97)}


def test_pack_refuses_a_short_tile():
    buf, meta, R, s_pad = _span(0, 0)
    with pytest.raises(ValueError):
        tid.pack_variant_meta(meta, meta["n"] - 1)


def test_wrapper_refuses_bad_arguments():
    buf = torch.zeros(64, dtype=torch.uint8)
    meta = torch.from_numpy(tid.pack_variant_meta(
        {"n": 0, "starts": np.zeros(0), "flags": np.zeros(0, np.uint8),
         "gt_groups": []}, 8))
    tid.variant_unpack(buf, meta, 8, 8)
    for args in ((buf.to(torch.int32), meta, 8, 8),
                 (buf, meta.to(torch.int64), 8, 8),
                 (buf, meta[:10], 8, 8), (buf, meta, 8, -1),
                 (buf, meta, 16, 8)):
        with pytest.raises(ValueError):
            tid.variant_unpack(*args)


@pytest.mark.parametrize("case", range(len(synth.UNPACK_CASES)))
def test_host_check_keeps_the_kernel_from_trapping(case):
    """``check_variant_meta`` passes the packer's arrays, and any header
    it passes also passes the kernel's own check of the sections (a trap
    on the card), over random changes of each header word and of the
    array's length."""
    buf, meta, R, s_pad = _span(case, 5)
    packed = tid.pack_variant_meta(meta, R)
    assert tid.check_variant_meta(packed, R) is not None
    rng = np.random.default_rng(case)
    passed = refused = 0
    for _ in range(400):
        bad = packed.copy()
        word = int(rng.integers(0, 5))
        bad[word] += int(rng.integers(-R - 4, R + 5))
        bad = bad[:bad.size - int(rng.integers(0, 3)) * int(rng.integers(
            0, R + 2))]
        try:
            tid.check_variant_meta(bad, R)
        except ValueError:
            refused += 1
            with pytest.raises(ValueError):
                tid.variant_unpack(torch.from_numpy(buf), bad, R, s_pad)
            continue
        passed += 1
        assert sections_fit(bad, R)
    assert passed > 0 and refused > 0


# ---------------------------------------------------------------------------
# the model's parts against the JAX formulas
# ---------------------------------------------------------------------------

def test_swar_calls_match_the_formula():
    """The diploid and haploid decode by SWAR byte classes against
    ``variant_gt_dosage_device`` on every byte pair (as either sample of
    a word) and every byte (at each place in a word)."""
    b0, b1 = (a.ravel() for a in np.meshgrid(np.arange(256), np.arange(256),
                                             indexing="ij"))
    buf = np.stack([b0, b1], 1).astype(np.uint8).ravel()
    want = np.asarray(variant_gt_dosage_device(
        jnp.asarray(buf), jnp.zeros(8, jnp.int32), 1, 2, 65536))[0]
    rev = np.roll(np.arange(65536), 12345)     # the other sample of a word
    w = b0 | b1 << 8 | b0[rev] << 16 | b1[rev] << 24
    got = calls2(w)
    np.testing.assert_array_equal((got & 0xFF).astype(np.uint8)
                                  .view(np.int8), want)
    np.testing.assert_array_equal(((got >> 16) & 0xFF).astype(np.uint8)
                                  .view(np.int8), want[rev])
    d = byte_perm_6420(got, got)
    np.testing.assert_array_equal(d & 0xFFFF, (got & 0xFF)
                                  | ((got >> 16) & 0xFF) << 8)
    b = np.arange(256)
    want = np.asarray(variant_gt_dosage_device(
        jnp.asarray(b.astype(np.uint8)), jnp.zeros(8, jnp.int32), 1, 1,
        256))[0]
    for k in range(4):
        w = np.roll(b, 7) | np.roll(b, 99) << 8 | np.roll(b, 200) << 16
        w = (w & ~(0xFF << (8 * k))) | b << (8 * k)
        got = (calls1(w) >> (8 * k)) & 0xFF
        np.testing.assert_array_equal(got.astype(np.uint8).view(np.int8),
                                      want)


@pytest.mark.parametrize("nv", [-3, 0, 1, 5, 13, 16, 40])
def test_calls_past_n_sample_are_minus_one(nv):
    d = np.array([0x03020100, 0x07060504, 0x0B0A0908, 0x0F0E0D0C])
    got = words_to_calls(np.stack([pad_calls(d[k], k, nv)
                                   for k in range(4)]))
    want = np.where(np.arange(16) < nv, np.arange(16), -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(len(synth.UNPACK_CASES)))
def test_interior_rule_is_where_the_clip_is_the_identity(case):
    """A group row is interior exactly when the reference's clipped,
    int32-wrapped index of every GT byte is the plain offset."""
    buf, meta, R, s_pad = _span(case, 0)
    L = buf.size
    kinds = set()
    for rows, offs, w, c, ns in meta["gt_groups"]:
        nbytes = w * c * ns
        k = np.arange(nbytes, dtype=np.int32)
        for off in offs:
            idx = np.asarray(jnp.clip(jnp.int32(off) + jnp.asarray(k), 0,
                                      L - 1))
            same = bool((idx == off + k.astype(np.int64)).all())
            assert interior(int(off), nbytes, L) == same
            kinds.add(same)
    if meta["gt_groups"]:
        assert kinds == {True, False}


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("residue", range(16))
def test_aligned_words_and_funnel_shift_at_every_offset(residue, C):
    """Lane bytes by aligned words, the neighbour's word and the funnel
    shift, for a row at every start offset mod 16 and buf at every
    address mod 16, each segment of a row cut short: the reference's
    gathered bytes, every load inside buf."""
    rng = np.random.default_rng(residue * 2 + C)
    ns = 1000 + residue
    for base in range(16):
        off = 48 + ((residue - base) % 16)     # (base + off) % 16 == residue
        buf = rng.integers(0, 256, off + C * ns + 40, dtype=np.uint8)
        want = np.asarray(jnp.asarray(buf)[jnp.clip(
            jnp.int32(off) + jnp.arange(C * ns, dtype=jnp.int32), 0,
            buf.size - 1)])
        for chunk in range(-(-ns // 512)):
            v, fast = lane_bytes(buf, base, off, C, ns, chunk)
            assert fast
            k = C * (chunk * 512 + 16 * np.arange(32))[:, None] \
                + np.arange(16 * C)
            ok = k < C * ns
            np.testing.assert_array_equal(v[ok], want[k[ok]])


@pytest.mark.parametrize("base", [0, 5])
def test_rows_cut_by_the_buffer_take_the_clip(base):
    """Rows whose aligned words leave buf, or which the clip cuts, take
    the scalar path and still give the reference's bytes."""
    rng = np.random.default_rng(base)
    buf = rng.integers(0, 256, 3000, dtype=np.uint8)
    L = buf.size
    for C in (1, 2):
        ns = 400
        for off in (0, 1, L - C * ns, L - C * ns - 3, L - 5, -7,
                    (1 << 31) - 9):
            off = int(_i32(off))
            want = np.asarray(jnp.asarray(buf)[jnp.clip(
                jnp.int32(off) + jnp.arange(C * ns, dtype=jnp.int32), 0,
                L - 1)])
            paths = set()
            for chunk in range(-(-ns // 512)):
                v, fast = lane_bytes(buf, base, off, C, ns, chunk)
                paths.add(fast)
                k = C * (chunk * 512 + 16 * np.arange(32))[:, None] \
                    + np.arange(16 * C)
                ok = k < C * ns
                np.testing.assert_array_equal(v[ok], want[k[ok]])
            if not interior(off, C * ns, L):
                assert paths == {False}


@pytest.mark.parametrize("layout", [(1, 2), (1, 1), (2, 3), (4, 1), (0, 0)])
@pytest.mark.parametrize("ns,s_pad,fill", [
    (300, 304, True), (300, 304, False), (256, 256, True), (7, 8, True),
    (2504, 2504, True), (2504, 2509, False), (1, 13, False)])
def test_segments_cover_each_row_once(layout, ns, s_pad, fill):
    """A row's tasks (512 columns), lanes (16) and granules (8) cover its
    columns [0, cols) once (cols = s_pad with the fill or for a width-0
    row, else n_sample) and no column past them, with 8-byte stores
    aligned wherever the row is, for every layout."""
    w, c = layout
    cols = s_pad if (w == 0 or fill) else ns
    for tile_base in (0, 8, 3):
        for row in (0, 1, 5):
            tile = np.zeros((6, s_pad), np.int64)
            writes = np.zeros((6, s_pad), np.int64)
            for chunk in range(-(-s_pad // 512)):
                if chunk * 512 >= cols:
                    continue
                for lane in range(32):
                    store(tile, writes, tile_base + row * s_pad, row, cols,
                          chunk * 512 + 16 * lane, np.ones(16))
            assert (writes[row, :cols] == 1).all()
            assert (writes[row, cols:] == 0).all()
            assert writes.sum() == cols


@pytest.mark.parametrize("R,s_pad", [(8, 8), (64, 304), (1024, 2504),
                                     (16, 513)])
def test_every_task_once_and_entries_ahead(R, s_pad):
    """The grid stride walks every task once for any warp count, and the
    entry a warp loaded ahead (beside the header for its first task, then
    before each task's work) is the one its next row task needs."""
    chunks = -(-s_pad // 512)
    t_rows = R * chunks
    total = t_rows + -(-R // 32)
    for warps in (1, 7, 32, 4224, total + 50):
        got = [(t, e) for t, e in walk(total, warps, t_rows, chunks)]
        assert len(got) == total
        assert sorted(e for _, e in got if e is not None) == [
            divmod(t, chunks) for t in range(t_rows)]


@pytest.mark.parametrize("case", range(len(synth.UNPACK_CASES)))
@pytest.mark.parametrize("base,tile_base,warps",
                         [(0, 0, 2112), (3, 0, 24), (13, 8, 7)])
def test_model_matches_jax(case, base, tile_base, warps):
    """The whole model against the reference's tile: every cell of the
    tile and every row of the columns written exactly once."""
    buf, meta, R, s_pad = _span(case, 1)
    packed = tid.pack_variant_meta(meta, R)
    *got, info = model_unpack(buf, packed, R, s_pad, base, tile_base, warps)
    for g, w in zip(got, _jax_tile(buf, meta, R, s_pad)):
        np.testing.assert_array_equal(g, w)
    assert (info["writes"] == 1).all()
    assert (info["row_writes"] == 1).all()
    if any(w == 1 and c in (1, 2) for _, _, w, c, _ in meta["gt_groups"]):
        assert info["fast"] > 0 and info["scalar"] > 0


@pytest.mark.parametrize("m", [1, 12, 300])
def test_the_prefix_alone(m):
    """``variant_prefix``'s header (no group) through the model: the
    reference's CHROM / POS, nothing else written."""
    buf, starts = synth.prefix_rows(m, seed=m)
    packed = np.concatenate([tid.prefix_meta_head(m), starts])
    chrom, pos, _, _, info = model_unpack(buf, packed, m, 0, base=3)
    jc, jp = variant_prefix_device(jnp.asarray(buf), jnp.asarray(starts))
    np.testing.assert_array_equal(chrom, np.asarray(jc))
    np.testing.assert_array_equal(pos, np.asarray(jp))
    assert info["writes"].size == 0 and (info["row_writes"] == 1).all()


@pytest.mark.parametrize("case", range(len(synth.GT_CASES)))
def test_one_group_without_the_fill(case):
    """``gt_dosage``'s header (one group, no fill) through the model, on
    a tile of rows no group writes and n_sample + 5 columns (rows not
    8-byte aligned): the reference's scatter, every other cell as it
    was."""
    w, c, ns, G = synth.GT_CASES[case]
    buf, offs, rows, R = synth.gt_rows(w, c, ns, G, seed=case)
    packed = np.concatenate([tid.group_meta_head(R, G),
                             tid._entries(offs, rows, w, c, ns).ravel()])
    before = np.full((R, ns + 5), -1, np.int8)
    before[:, ns:] = 9
    *_, dosage, info = model_unpack(buf, packed, R, ns + 5, tile=before)
    want = before.copy()
    want[rows[:, None], np.arange(ns)] = np.asarray(variant_gt_dosage_device(
        jnp.asarray(buf), jnp.asarray(offs), w, c, ns))
    np.testing.assert_array_equal(dosage, want)
    assert (info["writes"][rows, :ns] == 1).all()
    assert info["writes"].sum() == G * ns and info["row_writes"].sum() == 0
