"""The variant plane: VCF/BCF spans -> typed columns and dosage tiles ->
per-tile stats on the card (counterpart of
hadoop_bam_tpu/parallel/variant_pipeline.py).

Host plane (every container): pool threads parse spans into the tile
columns

    chrom [cap] i32, pos [cap] i32, flags [cap] u8 (bit0 PASS, bit1 SNP),
    dosage [cap, S_pad] i8 (ALT dosage, -1 missing), count

(text through the NumPy grid tokenizer, BCF through the columnar decode
of formats/bcf_columns.py), FeedPipeline packs them into tiles and
``variant_tile_stats`` (K14, torch ops) reduces each on the card:
variant / SNP / PASS counts, mean ALT allele frequency and per-sample
call rates in one pass.

Device plane (a BGZF BCF, ``inflate_backend="device"`` named): pool
threads tokenize each span's BGZF blocks; on the card K7+K8
(``resolve_pack``) resolves them into one buffer, which is copied to
pinned host memory ONCE a span (the serial cursor walk over the typed
values, ``decode_bcf_cursor_meta``, runs there); K11
(``variant_unpack``, one launch a span from one packed metadata copy)
then reads each record's CHROM / POS and GT vectors straight out of the
device buffer into the whole tile, pads and flags included, and K14
reduces it.  Records cut at a chunk's end, blocks past the chunk and
spans the columnar walk declines take the host oracle
(``bcf_span_stat_columns``), each exactly once.

Counters (utils/metrics.py): ``vcf.device_blocks`` / ``vcf.fixup_blocks``
and ``vcf.device_records`` / ``vcf.fixup_records`` split the device
plane's work between the card and the host fixup, ``vcf.device_spans``
counts the spans unpacked on the card (one K11 launch each), and
``pipeline.records`` counts the records the card unpacked, as the
reference does.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import struct
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.config import (
    DEFAULT_CONFIG, HBamConfig, resolve_inflate_backend,
)
from hadoop_bam_torch.device import DataAxis, data_axis
from hadoop_bam_torch.formats.bcf import BCFError, scan_variant_columns
from hadoop_bam_torch.formats.bcf_columns import (
    decode_bcf_columns, decode_bcf_cursor_meta, stat_columns,
)
from hadoop_bam_torch.formats.vcf import VariantBatch, VCFHeader
from hadoop_bam_torch.ops.inflate_device import (
    host_to_device, pack_variant_meta, require_tokenizer, resolve_pack,
    round_pow2, variant_unpack,
)
from hadoop_bam_torch.parallel.pipeline import (
    DEVICE_PLANE_SPAN_BYTES, _copy_to, _CopiesDone, _decode_pool,
    _device_data_fault, _reading, _StatTotals, _TokenRing,
    _tokenize_span_tokens, decode_with_retry, iter_windowed,
    pipeline_span_count,
)
from hadoop_bam_torch.parallel.staging import FeedPipeline, TileSpec
from hadoop_bam_torch.plan.executor import select_plane
from hadoop_bam_torch.resilience import chaos
from hadoop_bam_torch.resilience.domains import decode_ladder
from hadoop_bam_torch.split.vcf_planners import read_bcf_span_frames
from hadoop_bam_torch.utils.metrics import METRICS
from hadoop_bam_torch.utils.seekable import scoped_byte_source

logger = logging.getLogger(__name__)

# dispatch-bucket granularity of the host plane's final partial tile
_VARIANT_BLOCK_N = 64


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class VariantGeometry:
    """Static shapes of one device's variant tile.

    ``tile_records=None`` (the default) sizes the tile from the sample
    count: as many variants a step as keep the int8 dosage tile within
    ~8 MB, clamped to [64, 65536] and rounded to 8 (2,504 samples: 3,352
    records).  ``samples_pad`` rounds the sample count up to 8 bytes,
    at least 8."""
    tile_records: "Optional[int]" = None
    n_samples: int = 0             # from the header; padded to samples_pad

    def __post_init__(self):
        if self.tile_records is None:
            budget = (8 << 20) // max(1, self.samples_pad)
            object.__setattr__(
                self, "tile_records",
                max(64, min(1 << 16, _round_up(budget, 8))))

    @property
    def samples_pad(self) -> int:
        return max(8, _round_up(self.n_samples, 8))


FLAG_PASS = 1
FLAG_SNP = 2


def pack_variant_tiles(batch: VariantBatch, geometry: VariantGeometry
                       ) -> Dict[str, np.ndarray]:
    """VariantBatch -> dense typed rows (unpadded; the group packer pads)."""
    n = len(batch)
    flags = (batch.is_pass.astype(np.uint8) * FLAG_PASS
             | batch.is_snp.astype(np.uint8) * FLAG_SNP)
    dosage = np.full((n, geometry.samples_pad), -1, dtype=np.int8)
    if geometry.n_samples:
        dosage[:, :geometry.n_samples] = batch.dosage_matrix()
    return {
        "chrom": batch.chrom.astype(np.int32),
        "pos": np.minimum(batch.pos, np.iinfo(np.int32).max
                          ).astype(np.int32),
        "flags": flags,
        "dosage": dosage,
    }


# Common diploid GT strings resolved by dict lookup — the fast path that
# skips per-field parsing for the overwhelming majority of genotypes.
_GT_DOSE = {b"0/0": 0, b"0|0": 0, b"0/1": 1, b"1/0": 1, b"0|1": 1,
            b"1|0": 1, b"1/1": 2, b"1|1": 2, b"./.": -1, b".|.": -1,
            b".": -1, b"0": 0, b"1": 1}

_SNP_ALTS = frozenset(b"ACGTN")


def pack_variant_tiles_from_text(text: bytes, header: VCFHeader,
                                 geometry: VariantGeometry
                                 ) -> Dict[str, np.ndarray]:
    """Text-VCF tokenizer for the stats/tensor path — the host-side 'VCF
    line tokenizer' kernel of SURVEY.md section 7.3(e).

    Dispatches to the NumPy grid tokenizer (newline/tab scans -> field
    boundary matrix -> one clamped gather per column; no per-line Python)
    and falls back to this scalar parse ONLY for rows the vectorized path
    flags as irregular (ALT wider than its gather, multi-digit or
    polyploid genotypes, non-digit POS).  Semantics match
    pack_variant_tiles (asserted by tests)."""
    cols, odd = _pack_variant_text_vectorized(text, header, geometry)
    if odd:
        # odd: (kept-row index, line start, line end) for irregular rows
        rows = np.asarray([r for r, _, _ in odd])
        patch = _pack_variant_tiles_from_text_scalar(
            b"\n".join(text[s:e] for _, s, e in odd) + b"\n",
            header, geometry)
        for k in cols:
            cols[k][rows] = patch[k]
    return cols


def _pack_variant_tiles_from_text_scalar(text: bytes, header: VCFHeader,
                                         geometry: VariantGeometry
                                         ) -> Dict[str, np.ndarray]:
    """Per-line reference tokenizer (the vectorized path's oracle and its
    irregular-row fallback)."""
    S = geometry.n_samples
    cap = text.count(b"\n") + 1
    chrom = np.empty(cap, np.int32)
    pos = np.empty(cap, np.int32)
    flags = np.empty(cap, np.uint8)
    dosage = np.full((cap, geometry.samples_pad), -1, np.int8)
    cmap: Dict[bytes, int] = {c.encode(): i
                              for i, c in enumerate(header.contigs)}
    n = 0
    for line in text.split(b"\n"):
        if not line or line[:1] == b"#":
            continue
        parts = line.split(b"\t")
        if len(parts) < 8:
            continue
        chrom[n] = cmap.get(parts[0], -1)
        pos[n] = int(parts[1])
        ref, alt, filt = parts[3], parts[4], parts[6]
        f = 0
        if filt == b"PASS":
            f |= FLAG_PASS
        if len(ref) == 1 and alt != b"." and all(
                len(a) == 1 and a[0] in _SNP_ALTS
                for a in alt.split(b",")):
            f |= FLAG_SNP
        flags[n] = f
        if S and len(parts) > 9 and parts[8][:2] == b"GT":
            row = dosage[n]
            for s, field in enumerate(parts[9:9 + S]):
                colon = field.find(b":")
                gt = field if colon < 0 else field[:colon]
                d = _GT_DOSE.get(gt)
                if d is None:  # polyploid / multi-allelic / malformed
                    d = 0
                    for a in gt.replace(b"|", b"/").split(b"/"):
                        if not a.isdigit():
                            d = -1
                            break
                        d += 1 if int(a) > 0 else 0
                row[s] = min(d, 127) if d >= 0 else -1
        n += 1
    return {"chrom": chrom[:n], "pos": pos[:n], "flags": flags[:n],
            "dosage": dosage[:n]}


def bcf_span_stat_columns(path: str, span, header: VCFHeader,
                          geometry: VariantGeometry,
                          is_bgzf: Optional[bool] = None
                          ) -> Dict[str, np.ndarray]:
    """One BCF span -> stats tile columns via the columnar decoder
    (formats/bcf_columns.py): the span walk frames records for free,
    one vectorized pass decodes them.  Spans the columnar path declines
    (pathological geometry) fall back to the record-serial scanner with
    identical output — the binary twin of the text tokenizer's
    vectorized/scalar split above."""
    with METRICS.span("vcf.inflate_wall"):
        raw, starts = read_bcf_span_frames(path, span, is_bgzf)
    with METRICS.span("vcf.tokenize_wall"):
        cols = decode_bcf_columns(raw, header, geometry.samples_pad,
                                  starts=starts)
        if cols is not None:
            return stat_columns(cols)
        return scan_variant_columns(raw, header, geometry.samples_pad)


_ALT_W = 16            # widest ALT the vectorized SNP test gathers
_GT_W = 4              # widest genotype prefix gathered (covers "0/1:")
_POS_W = 10            # max decimal digits in a 31-bit position


def _pack_variant_text_vectorized(text: bytes, header: VCFHeader,
                                  geometry: VariantGeometry):
    """NumPy grid tokenizer: newline/tab scans -> per-line field-boundary
    matrix -> one clamped gather per column.  Returns (cols, odd) where
    ``odd`` lists (row, line_start, line_end) for rows needing the scalar
    fallback (wide ALT, unusual GT shapes, non-digit POS)."""
    S = geometry.n_samples
    buf = np.frombuffer(text, dtype=np.uint8)
    if buf.size == 0:
        return {"chrom": np.empty(0, np.int32),
                "pos": np.empty(0, np.int32),
                "flags": np.empty(0, np.uint8),
                "dosage": np.full((0, geometry.samples_pad), -1, np.int8),
                }, []
    nl = np.flatnonzero(buf == 0x0A)
    if nl.size == 0 or nl[-1] != buf.size - 1:
        nl = np.append(nl, buf.size)
    starts = np.empty(nl.size, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl
    first = buf[np.minimum(starts, buf.size - 1)]
    keep = (ends > starts) & (first != ord("#"))

    tabs = np.flatnonzero(buf == 0x09)
    t0 = np.searchsorted(tabs, starts)
    t1 = np.searchsorted(tabs, ends)
    ntab = t1 - t0
    keep &= ntab >= 7                       # >= 8 fields, scalar parity
    starts, ends, t0, ntab = (a[keep] for a in (starts, ends, t0, ntab))
    n = starts.size
    cols = {"chrom": np.full(n, -1, np.int32),
            "pos": np.zeros(n, np.int32),
            "flags": np.zeros(n, np.uint8),
            "dosage": np.full((n, geometry.samples_pad), -1, np.int8)}
    if n == 0:
        return cols, []
    nf = 10 + S                             # fields we may need bounds for
    k = np.arange(nf - 1, dtype=np.int64)[None, :]
    tabm = tabs[np.minimum(t0[:, None] + k, tabs.size - 1)]
    tabm = np.where(k < ntab[:, None], tabm, ends[:, None])
    # field f occupies [fs[f], fe[f])
    fs = np.concatenate([starts[:, None], tabm + 1], axis=1)
    fe = np.concatenate([tabm, ends[:, None]], axis=1)
    fe = np.maximum(fe, fs)                 # past-the-last fields: empty
    odd = np.zeros(n, bool)

    def gather(f, width):
        """[n, width] bytes of field f, zero past its length, + lengths."""
        ln = fe[:, f] - fs[:, f]
        j = np.arange(width, dtype=np.int64)[None, :]
        g = buf[np.minimum(fs[:, f, None] + j, buf.size - 1)]
        return np.where(j < ln[:, None], g, 0), ln

    # CHROM: a span holds 1-2 distinct names, but a real header can carry
    # thousands of contigs — dedupe the gathered rows and dict-look-up
    # only the unique values (O(lines) + O(unique * lookup), not
    # O(lines * contigs))
    cmap = {c.encode(): i for i, c in enumerate(header.contigs)}
    cw = max((len(c) for c in header.contigs), default=1)
    cbytes, clen = gather(0, cw)
    # clen joins the key so a truncated long name can't alias a contig
    keyed = np.concatenate(
        [cbytes, np.minimum(clen, cw + 1)[:, None].astype(np.uint8)],
        axis=1)
    # hash-group the rows (a span holds ~1-2 distinct names; a real
    # header can carry thousands of contigs, so neither a per-contig
    # scan nor a lexicographic row-unique is acceptable): u64 scalar
    # unique + one vectorized verify against each group's representative
    weights = ((2 * np.arange(cw + 1, dtype=np.uint64) + 1)
               * np.uint64(0x9E3779B97F4A7C15))
    with np.errstate(over="ignore"):
        h = (keyed.astype(np.uint64) * weights[None, :]).sum(
            axis=1, dtype=np.uint64)
    _, first_idx, inv = np.unique(h, return_index=True,
                                  return_inverse=True)
    lut = np.full(first_idx.size, -1, np.int32)
    for ui, ri in enumerate(first_idx):
        ul = int(clen[ri])
        if ul <= cw:
            lut[ui] = cmap.get(cbytes[ri, :ul].tobytes(), -1)
    cols["chrom"] = lut[inv]
    # hash-collision rows (different bytes, same hash): re-look-up exactly
    mismatch = np.flatnonzero(
        ~(keyed == keyed[first_idx[inv]]).all(axis=1))
    for ri in mismatch:
        ul = int(clen[ri])
        cols["chrom"][ri] = cmap.get(cbytes[ri, :ul].tobytes(), -1) \
            if ul <= cw else -1

    # POS: fixed-width decimal parse (int64 accumulate; values past
    # int32 fall back so the scalar path raises the same OverflowError
    # the pre-vectorized tokenizer did on out-of-spec input)
    pb, plen = gather(1, _POS_W)
    digit = (pb >= 0x30) & (pb <= 0x39)
    j = np.arange(_POS_W, dtype=np.int64)[None, :]
    in_field = j < plen[:, None]
    odd |= (plen > _POS_W) | (plen == 0) | (digit != in_field).any(axis=1)
    scale = np.where(in_field, 10 ** np.maximum(
        plen[:, None] - 1 - j, 0), 0)
    pos64 = ((pb.astype(np.int64) - 0x30) * in_field * scale).sum(axis=1)
    odd |= pos64 > np.iinfo(np.int32).max
    cols["pos"] = np.minimum(pos64, np.iinfo(np.int32).max) \
        .astype(np.int32)

    # FILTER == PASS
    fb, flen = gather(6, 4)
    is_pass = (flen == 4) & (fb == np.frombuffer(b"PASS", np.uint8)) \
        .all(axis=1)

    # SNP: REF is 1 base; ALT is single bases joined by commas
    _rb, rlen = gather(3, 1)
    ab, alen = gather(4, _ALT_W)
    odd |= alen > _ALT_W
    ja = np.arange(_ALT_W, dtype=np.int64)[None, :]
    in_alt = ja < alen[:, None]
    snp_char = np.isin(ab, np.frombuffer(b"ACGTN", np.uint8))
    ok_even = (~in_alt | (ja % 2 == 1) | snp_char).all(axis=1)
    ok_odd = (~in_alt | (ja % 2 == 0) | (ab == ord(","))).all(axis=1)
    is_snp = (rlen == 1) & (alen % 2 == 1) & ok_even & ok_odd
    cols["flags"] = (is_pass.astype(np.uint8) * FLAG_PASS
                     | is_snp.astype(np.uint8) * FLAG_SNP)

    # genotypes: FORMAT (field 8) must start "GT"; per sample, dosage
    # from the first 1 or 3 characters of the GT subfield.  Wall-spanned
    # separately (vcf.dosage_pack_wall): the GT columns are the dominant
    # tokenizer cost on wide cohorts and the bench's vcf_stage_seconds
    # row wants them attributable
    if S:
        with METRICS.span("vcf.dosage_pack_wall"):
            gb8, glen8 = gather(8, 2)
            has_gt = (glen8 >= 2) & (gb8[:, 0] == ord("G")) \
                & (gb8[:, 1] == ord("T")) & (ntab >= 9)
            for s in range(S):
                f = 9 + s
                present = has_gt & (ntab >= f)  # field exists on the line
                sb, sln = gather(f, _GT_W)
                colon = np.where((sb == ord(":")) & (np.arange(_GT_W) <
                                                     sln[:, None]),
                                 np.arange(_GT_W), _GT_W).min(axis=1)
                gtlen = np.minimum(sln, colon)
                c0, c1, c2 = sb[:, 0], sb[:, 1], sb[:, 2]
                d0 = (c0 >= 0x30) & (c0 <= 0x39)
                d2 = (c2 >= 0x30) & (c2 <= 0x39)
                sep = (c1 == ord("/")) | (c1 == ord("|"))
                one = gtlen == 1
                tri = (gtlen == 3) & sep
                dot0, dot2 = c0 == ord("."), c2 == ord(".")
                val1 = np.where(d0, (c0 > 0x30).astype(np.int8),
                                np.int8(-1))
                val3 = np.where(d0 & d2,
                                ((c0 > 0x30).astype(np.int8)
                                 + (c2 > 0x30).astype(np.int8)),
                                np.int8(-1))
                # '.' anywhere -> missing (scalar: first non-digit allele
                # aborts to -1); handled by d0/d2 being False for '.'
                val = np.where(one, val1, np.where(tri, val3, np.int8(0)))
                regular = one | tri
                odd |= present & ~regular & (gtlen > 0)
                row_ok = present & regular
                cols["dosage"][row_ok, s] = val[row_ok]
    odd_rows = np.flatnonzero(odd)
    return cols, [(int(r), int(starts[r]), int(ends[r]))
                  for r in odd_rows]


def _iter_variant_tiles(cols_stream, cap: int, geometry: VariantGeometry
                        ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Repack a stream of per-span column dicts into cap-row tiles
    (cross-span concatenation; only the final tile is padded).

    The tile schema is taken from the first span's dict, so the feed
    accepts both the stats schema (chrom/pos/flags/dosage) and extended
    columnar dicts (e.g. formats/bcf_columns.py's rlen/qual/n_allele/
    n_fmt columns) without either side hard-coding the other.

    Serial tiler: the drivers feed through parallel/staging.FeedPipeline
    (``variant_feed``); this stays as its oracle in the tests."""
    parts: "deque[Dict[str, np.ndarray]]" = deque()
    have = 0
    proto: Dict[str, np.ndarray] = {}

    def empty_tile() -> Dict[str, np.ndarray]:
        out = {}
        for k, v in proto.items():
            shape = (cap,) + v.shape[1:]
            if k == "dosage":
                out[k] = np.full(shape, -1, v.dtype)
            elif k == "qual":
                out[k] = np.full(shape, np.nan, v.dtype)
            else:
                out[k] = np.zeros(shape, v.dtype)
        return out

    def emit(take: int) -> Tuple[Dict[str, np.ndarray], int]:
        nonlocal have
        tile = empty_tile()
        filled = 0
        while filled < take:
            head = parts[0]
            m = min(take - filled, head["chrom"].shape[0])
            for k in tile:
                tile[k][filled:filled + m] = head[k][:m]
            if m == head["chrom"].shape[0]:
                parts.popleft()
            else:
                parts[0] = {k: v[m:] for k, v in head.items()}
            filled += m
        have -= take
        return tile, take

    for cols in cols_stream:
        if not proto:
            proto = cols
        if cols["chrom"].shape[0]:
            parts.append(cols)
            have += cols["chrom"].shape[0]
        while have >= cap:
            yield emit(cap)
    if have:
        yield emit(have)


def _variant_feed_specs(proto: Dict[str, np.ndarray]):
    """Key order + TileSpecs for feeding schema-dict variant tiles
    through FeedPipeline (parallel/staging.py).  The schema comes from
    the first span's dict, as in _iter_variant_tiles, and the pads are
    its empty_tile's: -1 for dosage, NaN for qual, 0 elsewhere."""
    keys = list(proto)
    specs = []
    for k in keys:
        v = proto[k]
        pad = -1 if k == "dosage" else (np.nan if k == "qual" else 0)
        specs.append(TileSpec(tuple(v.shape[1:]), v.dtype, pad))
    return keys, specs


def variant_feed(cols_stream, n_dev: int, cap: int, **fp_kwargs):
    """Peek the first span's column dict for the tile schema and build a
    FeedPipeline over it.  Returns ``(keys, fp, tuples)``, or ``(None,
    None, None)`` for an empty stream, where ``tuples`` is the dict
    stream as key-ordered array tuples for ``fp.feed`` / ``fp.stream``:
    the one wiring the stats driver, ``VcfDataset.tensor_batches`` and
    the cohort feed share."""
    stream = iter(cols_stream)
    first = next(stream, None)
    if first is None:
        return None, None, None
    keys, specs = _variant_feed_specs(first)
    fp = FeedPipeline(n_dev, cap, specs, **fp_kwargs)
    tuples = (tuple(d[k] for k in keys)
              for d in itertools.chain([first], stream))
    return keys, fp, tuples


# ---------------------------------------------------------------------------
# K14: the per-tile stats (torch ops)
# ---------------------------------------------------------------------------

def variant_tile_stats(chrom: torch.Tensor, pos: torch.Tensor,
                       flags: torch.Tensor, dosage: torch.Tensor, count
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One tile's stats on its device (``make_variant_stats_step``'s
    ``per_device`` :501 and ``_variant_tile_stats`` :557; the psum of
    one device is the identity): (sum_af f32 [1], int32 [4 + S_pad]:
    n_variants, n_snp, n_pass, n_af, then each sample's called count).

    Rows at or past ``count`` (an int or an int32 scalar tensor) are
    pads.  A variant's AF is its ALT dosage sum over 2 x its called
    samples, in f32; variants with no called sample count 0 in sum_af
    and are left out of n_af.  Counts stay int32 end to end (f32 counts
    drift past 2^24).  ``chrom`` and ``pos`` are the tile's own columns
    and take no part in the sums."""
    variant_tile_stats.launches += 1
    cap = flags.shape[0]
    dev = flags.device
    valid = torch.arange(cap, device=dev) < count
    n_variants = valid.sum(dtype=torch.int32)
    f = flags.to(torch.int32)
    n_snp = (valid & ((f & FLAG_SNP) != 0)).sum(dtype=torch.int32)
    n_pass = (valid & ((f & FLAG_PASS) != 0)).sum(dtype=torch.int32)
    called = (dosage >= 0) & valid[:, None]
    n_called = called.sum(1, dtype=torch.int32)
    alt_sum = torch.where(called, dosage, 0).sum(
        1, dtype=torch.int32).to(torch.float32)
    has_calls = n_called > 0
    af = torch.where(
        has_calls,
        alt_sum / (2.0 * torch.clamp(n_called, min=1).to(torch.float32)),
        torch.zeros((), dtype=torch.float32, device=dev))
    sum_af = (af * valid.to(torch.float32)).sum()
    n_af = (has_calls & valid).sum(dtype=torch.int32)
    per_sample = called.sum(0, dtype=torch.int32)
    ivec = torch.cat([torch.stack([n_variants, n_snp, n_pass, n_af]),
                      per_sample])
    return sum_af.reshape(1), ivec


variant_tile_stats.launches = 0     # calls (torch ops, no hand kernel)


def _add_stats(totals: _StatTotals, stats, dev: torch.device) -> None:
    """A tile's stats into the run's totals on ``dev``: sum_af in f64
    and the counts in int64 (the reference's 64-bit host totals)."""
    fvec, ivec = stats
    totals.add(fvec.to(dev, torch.float64), ivec.to(dev, torch.int64))


def _variant_stats_result(totals: _StatTotals,
                          header: VCFHeader) -> Dict[str, object]:
    """The result of both planes."""
    if not totals:
        return {"n_variants": 0, "n_snp": 0, "n_pass": 0, "mean_af": 0.0,
                "n_af": 0, "sample_callrate": np.zeros(header.n_samples)}
    tf, ints = totals.drain()
    sum_af = float(tf[0])
    n_variants = int(ints[0])
    callrate = (ints[4:4 + header.n_samples].astype(np.float64)
                / max(n_variants, 1)
                if header.n_samples else np.zeros(0))
    return {
        "n_variants": n_variants,
        "n_snp": int(ints[1]),
        "n_pass": int(ints[2]),
        "mean_af": float(sum_af / max(int(ints[3]), 1)),
        # the mean_af denominator, so that combiners weight means exactly
        "n_af": int(ints[3]),
        "sample_callrate": callrate,
    }


# ---------------------------------------------------------------------------
# The device plane (BGZF BCF through K7+K8, K11, K14)
# ---------------------------------------------------------------------------

class _HostBytes:
    """The resolved span's one copy to the host: a pinned buffer, grown
    when a span needs more, filled on the device's current stream and
    read after that copy's event (the plane's one sync a span).  On the
    CPU the buffer is the resolved tensor itself."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None

    def fetch(self, buf: torch.Tensor, total: int) -> np.ndarray:
        if buf.device.type != "cuda":
            return buf[:total].numpy()
        if self.host is None or self.host.shape[0] < total:
            self.host = torch.empty(max(total, 1 << 20), dtype=torch.uint8,
                                    pin_memory=True)
        out = self.host[:total]
        out.copy_(buf[:total], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(buf.device))
        ev.synchronize()
        return out.numpy()


def _frame_span_records(hbuf: np.ndarray, start: int, stop: int
                        ) -> Tuple[np.ndarray, int]:
    """Record framing over a resolved span buffer with span ownership:
    the l_shared / l_indiv chase from ``start``, keeping the records
    whose FIRST byte is < ``stop`` (the host span reader's ownership
    rule) and which complete within the buffer.  Returns (starts i64,
    tail): ``tail`` is the first incomplete owned record's offset (the
    walked end when every owned record completed), where the host fixup
    takes over."""
    total = hbuf.shape[0]
    unpack = struct.Struct("<II").unpack_from
    starts: List[int] = []
    p = int(start)
    view = memoryview(hbuf)
    while p < stop:
        if p + 8 > total:
            break
        l_shared, l_indiv = unpack(view, p)
        end = p + 8 + l_shared + l_indiv
        if end > total:
            break
        starts.append(p)
        p = end
    return np.asarray(starts, np.int64), p


def _pad_cols_device(cols: Dict[str, np.ndarray], samples_pad: int,
                     dev: torch.device):
    """Host column dict -> padded tile tuple on ``dev`` for
    ``variant_tile_stats`` (the host oracle's fixup feed)."""
    n = int(cols["chrom"].shape[0])
    R = round_pow2(n, 8)

    def pad(a, fill):
        out = np.full((R,) + a.shape[1:], fill, a.dtype)
        out[:n] = a
        return host_to_device(out, dev)

    dosage = cols["dosage"]
    if dosage.shape[1] != samples_pad:
        wide = np.full((dosage.shape[0], samples_pad), -1, np.int8)
        wide[:, :dosage.shape[1]] = dosage[:, :samples_pad]
        dosage = wide
    return (pad(cols["chrom"], 0), pad(cols["pos"], 0),
            pad(cols["flags"], 0), pad(dosage, -1), n)


def device_variant_unpack(buf: torch.Tensor, meta: Dict[str, object],
                          samples_pad: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor, int]:
    """One span's tile on the card from its resolved buffer ``buf`` and
    its cursor metadata (``decode_bcf_cursor_meta``): the metadata packed
    into one int32 array (``pack_variant_meta``), which ``variant_unpack``
    checks, copies to the card once from pinned memory and reads in one
    launch that writes CHROM / POS, the flags and the whole dosage tile,
    R = ``round_pow2(n, 8)`` rows (pads: start 0, flags 0, dosage -1).
    Returns (chrom, pos, flags, dosage, n), the arguments of
    ``variant_tile_stats``."""
    n = int(meta["n"])
    R = round_pow2(n, 8)
    return (*variant_unpack(buf, pack_variant_meta(meta, R), R,
                            samples_pad), n)


def _variant_stats_device_plane(ds, axis: DataAxis, config: HBamConfig,
                                header: VCFHeader,
                                geometry: VariantGeometry, spans,
                                prefetch: int = 2) -> Dict[str, object]:
    """Variant stats through the token-feed device plane (module
    docstring; BGZF BCF only, the caller gates)."""
    require_tokenizer()
    if spans is None:
        with scoped_byte_source(ds.path) as src0:
            size = src0.size
        n_spans = max(axis.n_dev, int(np.ceil(size
                                              / DEVICE_PLANE_SPAN_BYTES)))
        with METRICS.span("vcf.plan_wall", spans=n_spans):
            spans = ds.spans(num_spans=n_spans)
    spans = list(spans)
    # the host oracle's BGZF frame read checks every CRC, so the device
    # route keeps the same error on CRC-only damage: the tokenize-time
    # fold is always on for this family, config.check_crc or not
    check_crc = True
    samples_pad = geometry.samples_pad
    home = axis.devices[0]
    totals = _StatTotals()
    fix_spans = []
    n_records = 0
    ring = _TokenRing(pin_memory=home.type == "cuda")
    host = _HostBytes()

    def host_cols(span):
        """The host oracle's decode of one (fixup) span."""
        def inner(s):
            return bcf_span_stat_columns(ds.path, s, header, geometry, True)
        with METRICS.wall_timer("pipeline.host_decode_wall"), \
                METRICS.span("vcf.host_decode_wall"):
            return decode_with_retry(inner, span, config)

    def host_tile(span, dev) -> None:
        cols = host_cols(span)
        if cols is not None:
            METRICS.count("vcf.fixup_records", int(cols["chrom"].shape[0]))
            _add_stats(totals, variant_tile_stats(
                *_pad_cols_device(cols, samples_pad, dev)), home)

    with _reading(ds.path, config) as src, \
            _decode_pool(config, "hbam-tokenize") as pool:
        stream = iter_windowed(
            pool, spans,
            lambda span: decode_with_retry(
                lambda s: _tokenize_span_tokens(src, s, check_crc), span,
                config),
            max(1, prefetch) * config.pool_size(), config=config)
        try:
            for i, chunk in enumerate(stream):
                if chunk is None:
                    continue
                # the plane's dispatch boundary: the driver's ladder
                # demotes on a fault injected here
                chaos.fire("device.step", blocks=int(chunk.used))
                dev = axis.devices[i % axis.n_dev]
                with METRICS.timer("pipeline.device_inflate"), \
                        METRICS.span("vcf.device_resolve_wall",
                                     blocks=int(chunk.used)):
                    tokens, nt, iz = ring.stage(chunk, dev)
                    buf, _ = resolve_pack(tokens, nt, iz, chunk.P)
                    hbuf = host.fetch(buf, int(chunk.ubase[chunk.used]))
                starts, tail = _frame_span_records(hbuf, chunk.start,
                                                   chunk.stop)
                meta = decode_bcf_cursor_meta(hbuf, header, samples_pad,
                                              starts=starts)
                if meta is None:
                    # the columnar walk declines the span: ALL of it
                    # takes the host oracle (no tail fixup, or its cut
                    # records would count twice)
                    METRICS.count("vcf.fixup_blocks", int(chunk.n_blocks))
                    host_tile(chunk.span, dev)
                    continue
                METRICS.count("vcf.device_blocks", int(chunk.used))
                METRICS.count("vcf.fixup_blocks",
                              int(chunk.n_blocks - chunk.used))
                if tail < chunk.stop or chunk.used < chunk.n_blocks:
                    fix_spans.append((chunk.fixup_span(tail), dev))
                n = int(meta["n"])
                n_records += n
                if n == 0:
                    continue
                with METRICS.span("vcf.device_unpack_wall", rows=n):
                    _add_stats(totals, variant_tile_stats(
                        *device_variant_unpack(buf, meta, samples_pad)),
                        home)
                METRICS.count("vcf.device_spans")
        finally:
            stream.close()
    METRICS.count("pipeline.records", n_records)
    METRICS.count("vcf.device_records", n_records)
    for fs, dev in fix_spans:
        host_tile(fs, dev)
    return _variant_stats_result(totals, header)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def _variant_data_fault(exc: BaseException) -> bool:
    """May a device-plane failure demote?  The BAM planes' data faults
    (``_device_data_fault``) and a malformed BCF record (BCFError, which
    the cursor walk raises on both planes); anything else is the port's
    own fault and raises."""
    return isinstance(exc, BCFError) or _device_data_fault(exc)


def _variant_stats_host(ds, axis: DataAxis, config: HBamConfig,
                        header: VCFHeader, geometry: VariantGeometry,
                        spans, prefetch: int) -> Dict[str, object]:
    """The host plane: spans parsed on the pool (text tokenizer, or the
    BCF columnar decode), packed by FeedPipeline, K14 on each tile."""
    if spans is None:
        with METRICS.span("vcf.plan_wall"):
            spans = ds.spans(num_spans=pipeline_span_count(
                ds.path, axis.n_dev, config))
    totals = _StatTotals()
    home = axis.devices[0]

    def decode(span):
        def inner(s):
            with METRICS.span("vcf.inflate_wall"):
                text = ds.read_span_text(s)
            if text is not None:       # text: the tokenizer, no records
                with METRICS.span("vcf.tokenize_wall"):
                    return pack_variant_tiles_from_text(text, header,
                                                        geometry)
            return bcf_span_stat_columns(ds.path, s, header, geometry,
                                         ds._is_bgzf_bcf)
        with METRICS.wall_timer("pipeline.host_decode_wall"), \
                METRICS.span("vcf.host_decode_wall"):
            out = decode_with_retry(inner, span, config)
        if out is not None:
            return out
        return pack_variant_tiles(VariantBatch([], header), geometry)

    def dispatch(tensors, counts):
        with METRICS.span("vcf.dispatch_wall"):
            named = dict(zip(keys, tensors))
            copies = _CopiesDone()
            for i, dev in enumerate(axis.devices):
                tiles = [_copy_to(named[k][i], dev)
                         for k in ("chrom", "pos", "flags", "dosage")]
                copies.record(dev)
                _add_stats(totals, variant_tile_stats(*tiles,
                                                      int(counts[i])), home)
            return copies.handle()

    with _decode_pool(config) as pool:
        stream = iter_windowed(pool, spans, decode,
                               max(1, prefetch) * config.pool_size(),
                               config=config)
        try:
            keys, fp, tuples = variant_feed(
                stream, axis.n_dev, geometry.tile_records,
                block_n=_VARIANT_BLOCK_N, balance=True,
                pin_memory=home.type == "cuda")
            if fp is not None:
                fp.feed(tuples, dispatch)
        finally:
            stream.close()
    return _variant_stats_result(totals, header)


def variant_stats_file(path: str, device=None,
                       config: HBamConfig = DEFAULT_CONFIG,
                       geometry: Optional[VariantGeometry] = None,
                       header: Optional[VCFHeader] = None,
                       spans=None,
                       prefetch: int = 2) -> Dict[str, object]:
    """Variant stats over a whole VCF / BCF (any container
    ``api/dispatch.py`` recognises) on ``cuda:0`` unless ``device`` says
    otherwise: n_variants, n_snp, n_pass, mean_af (the mean ALT allele
    frequency over the n_af variants with a called sample) and
    sample_callrate (float64 [n_samples]).

    Plane routing (the reference's ``_variant_stats_impl``):
    ``select_plane`` offers the device plane for a ``.bcf`` path when
    ``inflate_backend="device"`` is named, and it runs only on a BGZF
    BCF (the breaker is consulted only then); a data fault there
    (``_variant_data_fault``) demotes the run to the host plane, and the
    device domain is charged only once the host plane has read the same
    file."""
    from hadoop_bam_torch.api.vcf_dataset import open_vcf

    axis = data_axis(device)
    ds = open_vcf(path, device=axis.devices[0], config=config)
    if header is None:
        header = ds.header
    if geometry is None:
        geometry = VariantGeometry(n_samples=header.n_samples)
    fmt = "bcf" if path.lower().endswith(".bcf") else "vcf"
    ladder = decode_ladder(path, resolve_inflate_backend(config), config) \
        if config.adaptive_planes else None
    # a non-BGZF source never takes the device route: its decision must
    # not use up the breaker's half-open probe
    decision = select_plane(config, ladder=ladder if ds._is_bgzf_bcf
                            else None, device_capable=fmt == "bcf")
    device_blame: Optional[BaseException] = None
    if decision.plane == "device" and ds._is_bgzf_bcf:
        try:
            result = _variant_stats_device_plane(
                ds, axis, config, header, geometry, spans, prefetch)
            if ladder is not None:
                ladder.record_success("device")
            return result
        except Exception as e:  # noqa: BLE001 -- demotion boundary
            if (ladder is None or not _variant_data_fault(e)
                    or not ladder.demotable("device", e)):
                raise
            logger.warning("variant device plane failed (%s: %s); "
                           "demoting to the host plane for %s",
                           type(e).__name__, e, path)
            device_blame = e
    result = _variant_stats_host(ds, axis, config, header, geometry, spans,
                                 prefetch)
    if device_blame is not None:
        ladder.confirm_failure("device", device_blame)
    return result
