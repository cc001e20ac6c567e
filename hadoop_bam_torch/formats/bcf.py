"""BCF2 binary codec: the header block, typed values, the record decode,
the split guesser's plausibility test and the record-serial column scan
(copy of hadoop_bam_tpu/formats/bcf.py, decode half; ``encode_header``
is the one encoder kept, for the synthetic writer).

[SPEC] BCF2.2 (hts-specs VCFv4.x section 6):

- file = BGZF-compressed (or raw) stream: magic ``BCF\\2\\2``, header
  block (l_text u32 + VCF header text, NUL-terminated), then records.
- record = l_shared u32, l_indiv u32, then the shared block
  (CHROM i32, POS i32 0-based, rlen i32, QUAL f32, n_info u16,
  n_allele u16, n_sample u24 | n_fmt<<24, ID, alleles, FILTER, INFO
  key/value pairs) and the per-sample block (n_fmt x (FORMAT key,
  per-sample vectors)).
- typed values: one descriptor byte ``(count << 4) | type``; count 15
  means the real count follows as a typed scalar int.  Types: 1=int8,
  2=int16, 3=int32, 5=float32, 7=char, 0=MISSING (no payload).
- sentinels: int8 0x80 missing / 0x81 end-of-vector (and the int16 /
  int32 / float equivalents).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from hadoop_bam_torch.formats.vcf import (
    MISSING, VCFError, VCFHeader, VcfRecord,
)

BCF_MAGIC = b"BCF\x02\x02"
BCF_MAGIC_21 = b"BCF\x02\x01"

# typed-value type codes [SPEC]
T_MISSING, T_INT8, T_INT16, T_INT32, T_FLOAT, T_CHAR = 0, 1, 2, 3, 5, 7

INT8_MISSING, INT8_EOV = -128, -127
INT16_MISSING, INT16_EOV = -32768, -32767
INT32_MISSING, INT32_EOV = -2147483648, -2147483647
FLOAT_MISSING_BITS, FLOAT_EOV_BITS = 0x7F800001, 0x7F800002


class BCFError(VCFError):
    pass


# ---------------------------------------------------------------------------
# typed-value primitives
# ---------------------------------------------------------------------------

_INT_FMT = {T_INT8: "b", T_INT16: "<h", T_INT32: "<i"}
_INT_MISSING = {T_INT8: INT8_MISSING, T_INT16: INT16_MISSING,
                T_INT32: INT32_MISSING}
_INT_EOV = {T_INT8: INT8_EOV, T_INT16: INT16_EOV, T_INT32: INT32_EOV}
_INT_SIZE = {T_INT8: 1, T_INT16: 2, T_INT32: 4}


def skip_typed(buf: bytes, off: int) -> int:
    """Advance past one typed value without decoding it (fast-scan path)."""
    desc = buf[off]
    off += 1
    count, typ = desc >> 4, desc & 0x0F
    if count == 15:
        _, cv, off = read_typed(buf, off)
        count = int(cv[0])
    if typ == T_MISSING:
        return off
    size = 1 if typ == T_CHAR else (4 if typ == T_FLOAT
                                    else _INT_SIZE.get(typ, 4))
    return off + size * count


def read_typed(buf: bytes, off: int) -> Tuple[int, List, int]:
    """Read one typed value: returns (type, values list, new offset).
    Chars come back as one Python str; sentinels as None (missing) with
    EOV padding stripped."""
    desc = buf[off]
    off += 1
    count, typ = desc >> 4, desc & 0x0F
    if count == 15:
        _, cv, off = read_typed(buf, off)
        count = int(cv[0])
    if typ == T_MISSING:
        return typ, [], off
    if typ == T_CHAR:
        raw = buf[off:off + count]
        off += count
        return typ, [raw.rstrip(b"\x00").decode()], off
    if typ == T_FLOAT:
        vals: List = []
        for i in range(count):
            bits = struct.unpack_from("<I", buf, off + 4 * i)[0]
            if bits == FLOAT_EOV_BITS:
                vals.append(Ellipsis)
            elif bits == FLOAT_MISSING_BITS:
                vals.append(None)
            else:
                vals.append(struct.unpack_from("<f", buf, off + 4 * i)[0])
        off += 4 * count
        while vals and vals[-1] is Ellipsis:
            vals.pop()
        vals = [None if v is Ellipsis else v for v in vals]
        return typ, vals, off
    if typ in _INT_FMT:
        fmt, size = _INT_FMT[typ], _INT_SIZE[typ]
        miss, eov = _INT_MISSING[typ], _INT_EOV[typ]
        vals = []
        for i in range(count):
            v = struct.unpack_from(fmt, buf, off + size * i)[0]
            vals.append(Ellipsis if v == eov else (None if v == miss else v))
        off += size * count
        while vals and vals[-1] is Ellipsis:
            vals.pop()
        vals = [None if v is Ellipsis else v for v in vals]
        return typ, vals, off
    raise BCFError(f"unknown typed-value type {typ}")


# ---------------------------------------------------------------------------
# header block
# ---------------------------------------------------------------------------

def encode_header(header: VCFHeader) -> bytes:
    text = header.to_text().encode() + b"\x00"
    return BCF_MAGIC + struct.pack("<I", len(text)) + text


def decode_header(buf: bytes, off: int = 0) -> Tuple[VCFHeader, int]:
    magic = buf[off:off + 5]
    if magic not in (BCF_MAGIC, BCF_MAGIC_21):
        raise BCFError(f"bad BCF magic {magic!r}")
    l_text = struct.unpack_from("<I", buf, off + 5)[0]
    start = off + 9
    text = bytes(buf[start:start + l_text]).rstrip(b"\x00").decode()
    return VCFHeader.from_text(text), start + l_text


# ---------------------------------------------------------------------------
# per-field typing from the header
# ---------------------------------------------------------------------------

def _field_type(header: VCFHeader, table: str, key: str) -> str:
    defs = header.infos if table == "INFO" else header.formats
    line = defs.get(key)
    if line is not None and line.type:
        return line.type
    return "String"


def _format_values(typ: int, vals: List, vtype: str) -> Union[str, bool]:
    if typ == T_MISSING:
        return True
    if typ == T_CHAR:
        return vals[0] if vals else MISSING
    parts = []
    for v in vals:
        if v is None:
            parts.append(MISSING)
        elif typ == T_FLOAT:
            parts.append(_fmt_float(v))
        else:
            parts.append(str(int(v)))
    return ",".join(parts)


def _fmt_float(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    # shortest text that round-trips the float32 the wire format stores
    return np.format_float_positional(np.float32(v), unique=True, trim="0")


# ---------------------------------------------------------------------------
# genotype (GT) packing
# ---------------------------------------------------------------------------

def _decode_gt(vals: List[Optional[int]]) -> str:
    parts: List[str] = []
    seps: List[str] = []
    for i, v in enumerate(vals):
        if v is None:
            continue  # EOV padding for mixed ploidy
        allele = (int(v) >> 1) - 1
        parts.append(MISSING if allele < 0 else str(allele))
        if i > 0:
            seps.append("|" if int(v) & 1 else "/")
    if not parts:
        return MISSING
    out = parts[0]
    for sep, p in zip(seps, parts[1:]):
        out += sep + p
    return out


# ---------------------------------------------------------------------------
# record decode
# ---------------------------------------------------------------------------

class BCFRecordCodec:
    """Decode BCF2 record bytes into VcfRecord against one header."""

    def __init__(self, header: VCFHeader):
        self.header = header
        self.strings = header.string_dictionary()
        self.string_idx = {s: i for i, s in enumerate(self.strings) if s}

    # -- decode --------------------------------------------------------------
    def decode(self, buf: bytes, off: int = 0) -> Tuple[VcfRecord, int]:
        l_shared, l_indiv = struct.unpack_from("<II", buf, off)
        base = off + 8
        end_shared = base + l_shared
        end = end_shared + l_indiv
        if end > len(buf):
            raise BCFError("truncated BCF record")
        chrom_idx, pos0, rlen = struct.unpack_from("<iii", buf, base)
        qual_bits = struct.unpack_from("<I", buf, base + 12)[0]
        qual = struct.unpack_from("<f", buf, base + 12)[0]
        n_info, n_allele = struct.unpack_from("<HH", buf, base + 16)
        ns_nf = struct.unpack_from("<I", buf, base + 20)[0]
        n_sample, n_fmt = ns_nf & 0xFFFFFF, ns_nf >> 24
        p = base + 24
        _, idv, p = read_typed(buf, p)
        rid = idv[0] if idv else None
        alleles: List[str] = []
        for _ in range(n_allele):
            _, av, p = read_typed(buf, p)
            alleles.append(av[0] if av else "")
        _, fv, p = read_typed(buf, p)
        filters: Optional[Tuple[str, ...]]
        if not fv:
            filters = None
        else:
            filters = tuple(self.strings[int(i)] if int(i) else "PASS"
                            for i in fv)
        info: Dict[str, Union[str, bool]] = {}
        for _ in range(n_info):
            _, kv, p = read_typed(buf, p)
            key = self.strings[int(kv[0])]
            typ, vals, p = read_typed(buf, p)
            info[key] = _format_values(typ, vals,
                                       _field_type(self.header, "INFO", key))
        if p != end_shared:
            p = end_shared  # tolerate writer padding
        fmt_keys: List[str] = []
        sample_fields: List[List[str]] = [[] for _ in range(n_sample)]
        while p < end and len(fmt_keys) < n_fmt:
            _, kv, p = read_typed(buf, p)
            key = self.strings[int(kv[0])]
            fmt_keys.append(key)
            desc = buf[p]
            count, typ = desc >> 4, desc & 0x0F
            p += 1
            if count == 15:
                _, cv, p = read_typed(buf, p)
                count = int(cv[0])
            vtype = _field_type(self.header, "FORMAT", key)
            for s in range(n_sample):
                if typ == T_CHAR:
                    raw = buf[p:p + count]
                    p += count
                    sample_fields[s].append(
                        raw.rstrip(b"\x00").decode() or MISSING)
                else:
                    fmtc = _INT_FMT.get(typ)
                    size = _INT_SIZE.get(typ, 4)
                    vals: List = []
                    for i in range(count):
                        if typ == T_FLOAT:
                            bits = struct.unpack_from("<I", buf, p)[0]
                            if bits == FLOAT_EOV_BITS:
                                v: object = Ellipsis
                            elif bits == FLOAT_MISSING_BITS:
                                v = None
                            else:
                                v = struct.unpack_from("<f", buf, p)[0]
                        else:
                            iv = struct.unpack_from(fmtc, buf, p)[0]
                            v = (Ellipsis if iv == _INT_EOV[typ]
                                 else None if iv == _INT_MISSING[typ] else iv)
                        vals.append(v)
                        p += size
                    while vals and vals[-1] is Ellipsis:
                        vals.pop()
                    vals = [None if v is Ellipsis else v for v in vals]
                    if key == "GT":
                        sample_fields[s].append(_decode_gt(vals))
                    else:
                        sample_fields[s].append(
                            str(_format_values(typ, vals, vtype)))
        rec = VcfRecord(
            chrom=(self.header.contigs[chrom_idx]
                   if 0 <= chrom_idx < len(self.header.contigs)
                   else str(chrom_idx)),
            pos=pos0 + 1,
            id=rid,
            ref=alleles[0] if alleles else "N",
            alts=tuple(alleles[1:]),
            qual=None if qual_bits == FLOAT_MISSING_BITS else float(qual),
            filters=filters, info=info,
            fmt=tuple(fmt_keys),
            genotypes=[":".join(f) for f in sample_fields],
        )
        return rec, end


def shared_only(rec: bytes) -> bytes:
    """A BCF record cut to its shared part (no samples, no FORMAT): the
    codec decodes CHROM, POS, the alleles, FILTER and INFO of it, a few
    hundred times faster than the whole record of a wide call set."""
    (l_shared,) = struct.unpack_from("<I", rec, 0)
    out = bytearray(rec[:8 + l_shared])
    struct.pack_into("<I", out, 4, 0)
    struct.pack_into("<I", out, 28, 0)          # n_sample | n_fmt << 24
    return bytes(out)


def peek_record_sizes(buf: bytes, off: int) -> Tuple[int, int]:
    l_shared, l_indiv = struct.unpack_from("<II", buf, off)
    return l_shared, l_indiv


def plausible_record_start(buf: bytes, off: int, n_contigs: int,
                           max_len: int = 1 << 24) -> bool:
    """Cheap plausibility check for a candidate BCF record start — the
    validation core of hb/BCFSplitGuesser.java: sane block lengths, CHROM
    within the contig dictionary, non-negative 0-based POS (or -1 for
    telomere), sane counts."""
    if off + 32 > len(buf):
        return False
    l_shared, l_indiv = struct.unpack_from("<II", buf, off)
    if l_shared < 24 or l_shared > max_len or l_indiv > max_len:
        return False
    chrom_idx, pos0, rlen = struct.unpack_from("<iii", buf, off + 8)
    if not (0 <= chrom_idx < max(n_contigs, 1)):
        return False
    if pos0 < -1 or rlen < 0:
        return False
    n_info, n_allele = struct.unpack_from("<HH", buf, off + 24)
    if n_allele == 0 and n_info == 0 and l_shared == 24:
        return True
    if n_allele > 1024:
        return False
    return True


# ---------------------------------------------------------------------------
# Fast column scan (the binary twin of the text tokenizer in
# parallel/variant_pipeline.py): chrom/pos/flags + GT dosage straight from
# record bytes, skipping ID/INFO entirely and non-GT FORMAT fields by size
# arithmetic — no VcfRecord objects.  Semantics match BCFRecordCodec
# (asserted by tests).
# ---------------------------------------------------------------------------

_SNP_BASES = frozenset(b"ACGTN")
_GT_NP_DTYPES = {T_INT8: np.dtype("i1"), T_INT16: np.dtype("<i2"),
                 T_INT32: np.dtype("<i4")}


def scan_variant_columns(buf: bytes, header: VCFHeader, samples_pad: int
                         ) -> Dict[str, "np.ndarray"]:
    """All records in ``buf`` (concatenated BCF record bytes) -> typed
    columns {chrom i32, pos i32 (1-based), flags u8, dosage i8
    [n, samples_pad]}.  FLAG bits follow the variant pipeline: 1 = PASS,
    2 = SNP."""

    strings = header.string_dictionary()
    try:
        gt_key = strings.index("GT")
    except ValueError:
        gt_key = -1
    n_samples = header.n_samples

    chroms: List[int] = []
    poss: List[int] = []
    flags: List[int] = []
    dosages: List[np.ndarray] = []
    p = 0
    n_buf = len(buf)
    while p + 8 <= n_buf:
        l_shared, l_indiv = struct.unpack_from("<II", buf, p)
        base = p + 8
        end_shared = base + l_shared
        end = end_shared + l_indiv
        if end > n_buf:
            raise BCFError("truncated BCF record in scan")
        chrom_idx, pos0 = struct.unpack_from("<ii", buf, base)
        n_info, n_allele = struct.unpack_from("<HH", buf, base + 16)
        ns_nf = struct.unpack_from("<I", buf, base + 20)[0]
        n_sample, n_fmt = ns_nf & 0xFFFFFF, ns_nf >> 24
        q = skip_typed(buf, base + 24)          # ID
        # alleles: need lengths/content for the SNP flag
        snp = n_allele >= 2
        for k in range(n_allele):
            desc = buf[q]
            q += 1
            count, typ = desc >> 4, desc & 0x0F
            if count == 15:
                _, cv, q = read_typed(buf, q)
                count = int(cv[0])
            if typ != T_CHAR:
                raise BCFError("allele is not a char vector")
            # REF (k == 0) only needs length 1; ALTs must also be bases
            # (matches VariantBatch.is_snp)
            if count != 1 or (k > 0 and buf[q] not in _SNP_BASES):
                snp = False
            q += count
        # FILTER: typed int vector; PASS == exactly [0]
        f_typ, f_vals, q = read_typed(buf, q)
        is_pass = (len(f_vals) == 1 and int(f_vals[0]) == 0)
        # INFO is skipped wholesale: jump to the indiv block
        q = end_shared
        dose = np.full(samples_pad, -1, dtype=np.int8)
        seen_fmt = 0
        while q < end and seen_fmt < n_fmt:
            k_typ, k_vals, q = read_typed(buf, q)
            key = int(k_vals[0])
            desc = buf[q]
            q += 1
            count, typ = desc >> 4, desc & 0x0F
            if count == 15:
                _, cv, q = read_typed(buf, q)
                count = int(cv[0])
            size = 1 if typ == T_CHAR else (4 if typ == T_FLOAT
                                            else _INT_SIZE.get(typ, 4))
            data_len = size * count * n_sample
            if key == gt_key and typ in _GT_NP_DTYPES and n_sample:
                # GT vectors may be int8/int16/int32 (high allele counts
                # widen the encoding); all three share the same semantics.
                g = np.frombuffer(buf, _GT_NP_DTYPES[typ],
                                  count * n_sample, q
                                  ).reshape(n_sample, count).astype(np.int64)
                present = (g != _INT_EOV[typ])          # pre-EOV entries
                # allele index = (g >> 1) - 1; masking the phase bit is
                # required: a phased missing allele ('0|.') encodes as 1
                missing = present & (((g >> 1) == 0)
                                     | (g == _INT_MISSING[typ]))
                alt = present & (((g >> 1) - 1) > 0)
                # Any missing allele ('./.', '0/.') -> -1, matching
                # VariantBatch.dosage_matrix and the text tokenizer.
                d = np.where(present.any(axis=1) & ~missing.any(axis=1),
                             alt.sum(axis=1), -1)
                dose[:n_sample] = np.minimum(d, 127).astype(np.int8)
            q += data_len
            seen_fmt += 1
        chroms.append(chrom_idx)
        poss.append(pos0 + 1)
        flags.append((1 if is_pass else 0) | (2 if snp else 0))
        dosages.append(dose)
        p = end
    return {
        "chrom": np.asarray(chroms, dtype=np.int32),
        "pos": np.asarray(poss, dtype=np.int32),
        "flags": np.asarray(flags, dtype=np.uint8),
        "dosage": (np.stack(dosages) if dosages
                   else np.empty((0, samples_pad), np.int8)),
    }
