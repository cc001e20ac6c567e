"""The serial host duplicate-marking oracle (copy of
hadoop_bam_tpu/prep/oracle.py): the one definition of the duplicate
signature, the best-of-duplicate score and the flag patch that the
pipeline (``prep/pipeline.py``) is held to byte for byte.

Duplicate marking is the Picard-style ends signature computed from each
record's own bytes, with two simplifications that the device columns
(``prep/markdup.py``) mirror exactly:

- the mate key is the raw ``(next_refID, next_pos, mate-reverse)``
  triple, not the mate's unclipped end (no MC tag round trip);
- the best of a group is chosen per end (each record scored by its own
  sum of base qualities >= 15), not per pair.

The signature of an eligible record (mapped, primary: ``flag & 0x904 ==
0``) is ``(refid, unclipped 5' position, library, orientation and pair
bits, mate key)``.  The unclipped 5' position extends the mapped
position through the leading (forward strand) or trailing (reverse
strand) soft and hard clips, so trimmed copies of one molecule collide.
In a group the winner is the highest score, ties to the lowest global
input index, whatever the round size.  Every record's duplicate flag
(0x400) is cleared and re-derived; losers are flagged, or dropped under
``remove_duplicates``.  The output is coordinate-sorted through
``write_bam_records``, sidecars included.

Raw-record offsets (block_size first):

    0:4 block_size | 4:8 refID | 8:12 pos | 12 l_read_name | 13 mapq
    | 14:16 bin | 16:18 n_cigar_op | 18:20 flag | 20:24 l_seq
    | 24:28 next_refID | 28:32 next_pos | 32:36 tlen
    | 36+ read_name NUL | cigar u32[n_cigar] | seq (l_seq+1)//2
    | qual l_seq | aux
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.utils.errors import CorruptDataError, PlanError

_CLIP_OPS = frozenset((4, 5))               # S, H
_REF_CONSUME = frozenset((0, 2, 3, 7, 8))   # M D N = X
_U32 = 0xFFFFFFFF

# the sum-of-base-qualities floor (Picard's DuplicateScoringStrategy):
# qualities below it never count toward the score
SCORE_MIN_QUAL = 15

LIBRARY_MODES = ("none", "rg")


def _u16(rec, off: int) -> int:
    return int.from_bytes(rec[off:off + 2], "little")


def _i32(rec, off: int) -> int:
    return int.from_bytes(rec[off:off + 4], "little", signed=True)


def _cigar_walk(rec) -> Tuple[int, int, int]:
    """(leading clip, trailing clip, reference span) from the packed
    CIGAR: the maximal S/H prefix and suffix (an all-clip CIGAR counts
    its total on both sides), and the M/D/N/=/X sum, or l_seq for a
    record with no CIGAR ('*')."""
    n_cigar = _u16(rec, 16)
    if n_cigar == 0:
        return 0, 0, _i32(rec, 20)
    off = 36 + rec[12]
    ops = []
    for k in range(n_cigar):
        v = int.from_bytes(rec[off + 4 * k:off + 4 * k + 4], "little")
        ops.append((v & 0xF, v >> 4))
    lead = 0
    for op, ln in ops:
        if op not in _CLIP_OPS:
            break
        lead += ln
    trail = 0
    for op, ln in reversed(ops):
        if op not in _CLIP_OPS:
            break
        trail += ln
    ref_len = sum(ln for op, ln in ops if op in _REF_CONSUME)
    return lead, trail, ref_len


def record_score(rec) -> int:
    """The sum of base qualities >= SCORE_MIN_QUAL, the best-of-duplicate
    key.  A missing quality string (0xFF bytes) counts at face value, as
    on the device."""
    l_read_name = rec[12]
    n_cigar = _u16(rec, 16)
    l_seq = _i32(rec, 20)
    qual_off = 36 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2
    if qual_off + l_seq > len(rec):
        raise CorruptDataError(
            f"record qual array ([{qual_off}:{qual_off + l_seq}]) "
            f"overruns the {len(rec)}-byte record")
    return sum(q for q in rec[qual_off:qual_off + l_seq]
               if q >= SCORE_MIN_QUAL)


def record_signature(rec, lib: int) -> Optional[Tuple[int, int, int,
                                                      int, int]]:
    """The five uint32 key columns ``(k0, k1, k2, k3, k4)`` of one
    record, or None when it is unmapped, secondary or supplementary:

    - k0: refid;
    - k1: unclipped 5' position + 1, wrapped to 32 bits;
    - k2: ``lib << 3 | mate_reverse << 2 | orientation << 1 | pair``;
    - k3, k4: the mate key ``(next_refID + 1, next_pos + 1)`` as
      uint32, zero for fragments (unpaired, or mate unmapped)."""
    flag = _u16(rec, 18)
    if flag & 0x904:
        return None
    pos = _i32(rec, 8)
    lead, trail, ref_len = _cigar_walk(rec)
    orient = (flag >> 4) & 1
    upos = pos + ref_len - 1 + trail if orient else pos - lead
    pair = 1 if (flag & 0x1) and not (flag & 0x8) else 0
    mate_rev = ((flag >> 5) & 1) if pair else 0
    k3 = ((_i32(rec, 24) + 1) & _U32) if pair else 0
    k4 = ((_i32(rec, 28) + 1) & _U32) if pair else 0
    k0 = _i32(rec, 4) & _U32
    k1 = (upos + 1) & _U32
    k2 = ((lib << 3) | (mate_rev << 2) | (orient << 1) | pair) & _U32
    return (k0, k1, k2, k3, k4)


# ---------------------------------------------------------------------------
# library resolution (library_from)
# ---------------------------------------------------------------------------

def library_map(header, mode: str) -> Optional[Dict[bytes, int]]:
    """RG id -> library number, or None when ``mode`` is "none" (every
    record in one library 0).  Libraries are the sorted unique ``@RG
    LB:`` values numbered from 1; read groups without LB and records
    without an RG tag fall into library 0, so the numbering depends on
    the header alone."""
    if mode == "none":
        return None
    if mode != "rg":
        raise PlanError(f"unknown library mode {mode!r}; expected one "
                        f"of {LIBRARY_MODES}")
    rg_lb: Dict[bytes, bytes] = {}
    for line in header.text.splitlines():
        if not line.startswith("@RG"):
            continue
        m_id = re.search(r"\tID:([^\t\n]+)", line)
        m_lb = re.search(r"\tLB:([^\t\n]+)", line)
        if m_id and m_lb:
            rg_lb[m_id.group(1).encode()] = m_lb.group(1).encode()
    libs = {lb: i + 1 for i, lb in enumerate(sorted(set(rg_lb.values())))}
    return {rg: libs[lb] for rg, lb in rg_lb.items()}


_B_SIZES = {0x63: 1, 0x43: 1, 0x73: 2, 0x53: 2, 0x69: 4, 0x49: 4,
            0x66: 4}
_FIXED_SIZES = {**_B_SIZES, 0x41: 1}


def _aux_rg(rec) -> Optional[bytes]:
    """The RG:Z tag's value in a record's aux block, or None."""
    l_read_name = rec[12]
    n_cigar = _u16(rec, 16)
    l_seq = _i32(rec, 20)
    off = 36 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
    end = len(rec)
    raw = rec if isinstance(rec, bytes) else bytes(rec)
    while off + 3 <= end:
        tag = raw[off:off + 2]
        typ = raw[off + 2]
        off += 3
        if typ in (0x5A, 0x48):                       # Z, H
            nul = raw.find(b"\x00", off)
            if nul < 0:
                raise CorruptDataError(
                    f"unterminated {chr(typ)}-type aux tag {tag!r} in "
                    f"record")
            if tag == b"RG" and typ == 0x5A:
                return raw[off:nul]
            off = nul + 1
        elif typ == 0x42:                             # B: array
            if off + 5 > end:
                raise CorruptDataError("truncated B-type aux tag")
            size = _B_SIZES.get(raw[off])
            if size is None:
                raise CorruptDataError(
                    f"unknown B-array subtype {raw[off]:#x} in aux block")
            off += 5 + size * int.from_bytes(raw[off + 1:off + 5], "little")
        else:
            size = _FIXED_SIZES.get(typ)
            if size is None:
                raise CorruptDataError(
                    f"unknown aux tag type {typ:#x} in record")
            off += size
    return None


def library_column(data: np.ndarray, offs: np.ndarray, lens: np.ndarray,
                   rg_to_lib: Optional[Dict[bytes, int]]) -> np.ndarray:
    """uint32 library numbers of a decoded span's records: the host
    column the pipeline ships beside the row tile (a library is a text
    tag joined with the header; everything positional in the signature
    is computed on the device)."""
    n = int(offs.size)
    out = np.zeros(n, np.uint32)
    if rg_to_lib is None or not n:
        return out
    mv = data.tobytes()
    base = offs.astype(np.int64).tolist()
    ln = np.asarray(lens, np.int64).tolist()
    for i in range(n):
        rg = _aux_rg(mv[base[i]:base[i] + ln[i]])
        if rg is not None:
            out[i] = rg_to_lib.get(rg, 0)
    return out


# ---------------------------------------------------------------------------
# the oracle pipeline
# ---------------------------------------------------------------------------

def select_duplicates(sigs: List[Optional[Tuple]],
                      scores: List[int]) -> np.ndarray:
    """One uint8 duplicate bit per input record: in each signature group
    the winner is the highest score, ties to the lowest global index;
    ineligible records (signature None) never take part."""
    groups: Dict[Tuple, List[int]] = {}
    for gidx, sig in enumerate(sigs):
        if sig is not None:
            groups.setdefault(sig, []).append(gidx)
    dup = np.zeros(len(sigs), np.uint8)
    for members in groups.values():
        if len(members) < 2:
            continue
        winner = min(members, key=lambda g: (-scores[g], g))
        for g in members:
            if g != winner:
                dup[g] = 1
    return dup


def patch_flag(rec: bytes, dup: bool) -> bytes:
    """Clear and re-derive the duplicate flag (0x400) of a raw record."""
    flag = int.from_bytes(rec[18:20], "little")
    nf = (flag & ~0x400) | (0x400 if dup else 0)
    if nf == flag:
        return rec
    return rec[:18] + nf.to_bytes(2, "little") + rec[20:]


def _records(input_path: str, config: HBamConfig) -> Iterator[bytes]:
    """Every record's bytes in file order (the host span decode)."""
    from hadoop_bam_torch.parallel.mesh_sort import _record_lens
    from hadoop_bam_torch.parallel.pipeline import iter_file_spans
    for data, offs in iter_file_spans(input_path,
                                      lambda d, o, v: (d, o), config):
        mv = data.tobytes()
        base = offs.astype(np.int64).tolist()
        for b, ln in zip(base, _record_lens(data, offs).tolist()):
            yield mv[b:b + ln]


def markdup_bam_oracle(input_path: str, output_path: str, *,
                       config: HBamConfig = DEFAULT_CONFIG,
                       remove_duplicates: bool = False,
                       library_from: str = "none") -> int:
    """Mark (or remove) duplicates serially: decode every record, build
    signatures and scores, select winners, coordinate-sort, patch flags
    during the write.  Returns the record count written.  It holds the
    whole file's records in memory: the validation oracle, not the
    scalable path (``prep.pipeline.markdup_bam_mesh``)."""
    from hadoop_bam_torch.formats.bamio import read_bam_header
    from hadoop_bam_torch.utils.sort import _sorted_header
    from hadoop_bam_torch.write import write_bam_records

    if library_from not in LIBRARY_MODES:
        raise PlanError(f"unknown library_from {library_from!r}; "
                        f"expected one of {LIBRARY_MODES}")
    header, _ = read_bam_header(input_path)
    rg_to_lib = library_map(header, library_from)
    recs: List[bytes] = []
    sigs: List[Optional[Tuple]] = []
    scores: List[int] = []
    for rec in _records(input_path, config):
        lib = 0
        if rg_to_lib is not None:
            rg = _aux_rg(rec)
            lib = rg_to_lib.get(rg, 0) if rg is not None else 0
        recs.append(rec)
        sigs.append(record_signature(rec, lib))
        scores.append(record_score(rec))
    dup = select_duplicates(sigs, scores)

    # coordinate order with the input index as the tie key: the
    # pipeline's (hi, lo, gidx) sort
    def key(gidx: int) -> Tuple[int, int, int]:
        rec = recs[gidx]
        refid = _i32(rec, 4)
        return (_U32 if refid < 0 else refid,
                (_i32(rec, 8) + 1) & _U32, gidx)

    order = sorted(range(len(recs)), key=key)

    def chunks() -> Iterator[Tuple[bytes, np.ndarray]]:
        buf: List[bytes] = []
        offsets: List[int] = []
        pos = 0
        for gidx in order:
            if remove_duplicates and dup[gidx]:
                continue
            rec = patch_flag(recs[gidx], bool(dup[gidx]))
            buf.append(rec)
            offsets.append(pos)
            pos += len(rec)
            if pos >= (8 << 20):
                yield b"".join(buf), np.asarray(offsets, np.int64)
                buf, offsets, pos = [], [], 0
        if buf:
            yield b"".join(buf), np.asarray(offsets, np.int64)

    return write_bam_records(output_path, _sorted_header(header, False),
                             chunks(), config=config).records
