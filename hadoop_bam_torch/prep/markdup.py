"""K16, the duplicate-marking device steps (counterpart of
hadoop_bam_tpu/prep/markdup.py):

1. ``markdup_columns`` (K16a), the duplicate-signature columns of a row
   tile: a hand CUDA kernel (``csrc/markdup_cols.cu``) on a CUDA tensor,
   its plain PyTorch version ``markdup_columns_plain`` on a CPU tensor.
   ``fused_sort_markdup_step`` is the bytes exchange's step
   (``parallel/mesh_sort.bytes_sort_step``, K15) with these columns taken
   from the rows before they ship: one call a round sorts the rows and
   unpacks the signature from bytes already on the card.
2. ``markdup_exchange_step`` (K16b), torch ops: the signature columns
   (7 words a record, never the payload) are hash-partitioned so each
   group lands whole on one device (with one device, the identity), a
   7-key sort over (signature, inverted score, global index) puts each
   group's winner first, and a record is a duplicate when it is valid
   and its signature equals the previous row's.

The columns mirror ``prep.oracle.record_signature`` / ``record_score``
field for field.  Torch has no uint32 shift, modulo or compare, so keys
are held in int64 masked to 32 bits; the 7-key sort is stable sorts on
packed key pairs from the least significant up, after a sort on the
global index, so ties break as the reference's ``lax.sort`` breaks them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.ops import kernels
from hadoop_bam_torch.parallel.mesh_sort import (
    _I32_SENTINEL, _all_to_all, _le_i32, bytes_sort_step,
)

_U32 = 0xFFFFFFFF
# ineligible flags: unmapped 0x4, secondary 0x100, supplementary 0x800
_INELIGIBLE_MASK = 0x904
_HASH_MUL = 0x9E3779B1
_REF_OPS = (0, 2, 3, 7, 8)           # M D N = X
COLUMNS = ("k0", "k1", "k2", "k3", "k4", "score")


def host_kmax(data: np.ndarray, offs: np.ndarray) -> int:
    """The largest n_cigar_op of a decoded span (host): the CIGAR width
    the columns walk."""
    if not offs.size:
        return 0
    base = offs.astype(np.int64)
    n_cigar = data[base[:, None] + np.arange(16, 18)].view("<u2").ravel()
    return int(n_cigar.max())


def host_row_bytes(data: np.ndarray, offs: np.ndarray) -> int:
    """The bytes of each row K16a stages for a decoded span
    (``markdup_columns``' ``row_bytes``).  A record's quality run ends e
    bytes from its start (its row's).  The card reads memory in 64-byte
    pieces, and a piece a record reads past the stage costs about two
    staged ones, so the stage that moves the fewest bytes ends at the
    64-byte boundary past the median record's e (at most half the
    records read past it), or at the furthest e where that is nearer."""
    if not offs.size:
        return 0
    base = offs.astype(np.int64)
    l_read_name = data[base + 12].astype(np.int64)
    n_cigar = data[base[:, None] + np.arange(16, 18)].view("<u2").ravel()
    l_seq = data[base[:, None] + np.arange(20, 24)].view("<i4").ravel()
    l_seq = l_seq.astype(np.int64)
    end = (36 + l_read_name + 4 * n_cigar.astype(np.int64)
           + (l_seq + 1) // 2 + l_seq)
    mid = (end.size - 1) // 2
    median = int(np.partition(end, mid)[mid])
    return min(-(-median // 64) * 64, int(end.max()))


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's range with its wrap."""
    return ((x + (1 << 31)) & _U32) - (1 << 31)


def _le_u16(rows: torch.Tensor, col: int) -> torch.Tensor:
    b = rows[:, col:col + 2].to(torch.int64)
    return b[:, 0] | (b[:, 1] << 8)


def markdup_columns_plain(rows: torch.Tensor, valid: torch.Tensor,
                          lib: torch.Tensor, kmax: int):
    """Plain PyTorch version of K16a, the reference's ``markdup_columns``
    formulas: rows uint8 [R, stride], valid bool [R], lib uint32 [R],
    ``kmax`` the CIGAR width walked (at least every valid row's
    n_cigar).  Returns uint32 [6, R] (k0..k4, score) and uint8 [R]
    elig."""
    R, stride = rows.shape
    dev = rows.device
    flag = _le_u16(rows, 18)
    l_read_name = rows[:, 12].to(torch.int64)
    n_cigar = _le_u16(rows, 16)
    l_seq = _le_i32(rows, 20)
    refid = _le_i32(rows, 4)
    pos = _le_i32(rows, 8)
    nref = _le_i32(rows, 24)
    npos = _le_i32(rows, 28)
    elig = valid & ((flag & _INELIGIBLE_MASK) == 0)

    # the masked CIGAR walk: clips at either end and the reference span;
    # op bytes are read from the flat tile, clamped to its end
    cig_off = 36 + l_read_name
    zero = torch.zeros(R, dtype=torch.int64, device=dev)
    lead, trail, ref_sum = zero, zero, zero
    if kmax > 0:
        k = torch.arange(kmax, device=dev)
        kvalid = k[None, :] < n_cigar[:, None]
        flat = rows.reshape(-1)
        cpos = (torch.arange(R, device=dev)[:, None] * stride
                + cig_off[:, None] + 4 * k[None, :])
        cap = R * stride - 1
        v = torch.zeros((R, kmax), dtype=torch.int64, device=dev)
        for j in range(4):
            v |= flat[(cpos + j).clamp_(0, cap)].to(torch.int64) << (8 * j)
        op = v & 0xF
        ln = v >> 4
        is_clip = (op == 4) | (op == 5)
        is_clip &= kvalid
        lead_mask = torch.cumprod(is_clip.to(torch.int64), dim=1)
        clip_or_pad = (is_clip | ~kvalid).to(torch.int64)
        suffix = torch.cumprod(clip_or_pad.flip(1), dim=1).flip(1)
        lead = (ln * lead_mask).sum(1)
        trail = (ln * suffix * is_clip).sum(1)
        is_ref = torch.zeros_like(kvalid)
        for o in _REF_OPS:
            is_ref |= op == o
        ref_sum = (ln * (is_ref & kvalid)).sum(1)
    ref_len = torch.where(n_cigar == 0, l_seq, ref_sum)
    orient = (flag >> 4) & 1
    upos = torch.where(orient.bool(), pos + ref_len - 1 + trail, pos - lead)

    # the sum of base qualities >= 15 inside the row; the offsets wrap as
    # the reference's int32 arithmetic does
    qual_off = _wrap32(36 + l_read_name + 4 * n_cigar
                       + torch.div(_wrap32(l_seq + 1), 2,
                                   rounding_mode="floor"))
    qend = _wrap32(qual_off + l_seq)
    cols = torch.arange(stride, device=dev)[None, :]
    qmask = (cols >= qual_off[:, None]) & (cols < qend[:, None]) \
        & (rows >= 15)
    score = torch.where(qmask, rows.to(torch.int64), 0).sum(1) & _U32

    pair = ((flag & 0x1) != 0) & ((flag & 0x8) == 0)
    mate_rev = torch.where(pair, (flag >> 5) & 1, 0)
    out = torch.stack([
        refid & _U32,
        (upos + 1) & _U32,
        ((lib.to(torch.int64) << 3) | (mate_rev << 2) | (orient << 1)
         | pair.to(torch.int64)) & _U32,
        torch.where(pair, (nref + 1) & _U32, 0),
        torch.where(pair, (npos + 1) & _U32, 0),
        score])
    return out.to(torch.uint32), elig.to(torch.uint8)


def _check_columns_args(rows: torch.Tensor, lib: torch.Tensor) -> None:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be uint8 [R, stride], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if lib.dtype != torch.uint32 or lib.shape != rows.shape[:1]:
        raise ValueError(f"lib must be uint32 [{rows.shape[0]}], got "
                         f"{lib.dtype} {tuple(lib.shape)}")
    if lib.device != rows.device:
        raise ValueError(f"rows on {rows.device}, lib on {lib.device}")
    if not (rows.is_contiguous() and lib.is_contiguous()):
        raise ValueError("rows and lib must be contiguous")
    if rows.shape[1] % 16 or rows.shape[1] < 48:
        raise ValueError(f"the row stride {rows.shape[1]} is not a "
                         f"multiple of 16 of at least 48")
    if rows.device.type == "cuda" and rows.data_ptr() % 16:
        raise ValueError("rows must start 16-byte aligned")


def markdup_columns(rows: torch.Tensor, count: int, lib: torch.Tensor,
                    kmax: int, row_bytes: Optional[int] = None):
    """K16a: the duplicate-signature columns of the first ``count`` rows
    of a tile (the rest are pads, never eligible).  rows uint8 [R,
    stride] (16-byte aligned, stride a multiple of 16, at least 48), lib
    uint32 [R]; each row's CIGAR is walked up to ``kmax`` ops (the
    pipeline passes at least every row's n_cigar).  Returns uint32 [6,
    R] (k0..k4, score) and uint8 [R] elig.

    A CUDA tensor launches the kernel on the current stream, which takes
    n_cigar and ``kmax`` at run time; a CPU tensor takes
    ``markdup_columns_plain``.  The kernel stages the first ``row_bytes``
    bytes of each row (the pipeline passes ``host_row_bytes``; None: the
    whole row), at most 512, and reads any byte past them from the tile:
    the columns do not depend on it.  ``markdup_columns.launches`` counts
    kernel launches."""
    _check_columns_args(rows, lib)
    R, stride = rows.shape
    if rows.device.type == "cpu":
        valid = torch.arange(R) < count
        return markdup_columns_plain(rows, valid, lib, kmax)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    out = torch.empty((len(COLUMNS), R), dtype=torch.uint32,
                      device=rows.device)
    elig = torch.empty(R, dtype=torch.uint8, device=rows.device)
    if R:
        fn = kernels.kernel("markdup_cols")
        with torch.cuda.device(rows.device):
            rc = fn(rows.data_ptr(), R, stride, int(count), int(kmax),
                    lib.data_ptr(),
                    stride if row_bytes is None else int(row_bytes),
                    out.data_ptr(), elig.data_ptr(),
                    torch.cuda.current_stream(rows.device).cuda_stream)
        kernels.check_launch("markdup_columns", rc)
        markdup_columns.launches += 1
    return out, elig


markdup_columns.launches = 0


def fused_sort_markdup_step(rows: torch.Tensor, lens: torch.Tensor,
                            count: int, base: int, lib: torch.Tensor,
                            bhi: torch.Tensor, blo: torch.Tensor,
                            kmax: int, row_bytes: Optional[int] = None):
    """The bytes exchange's step (K15) with K16a's columns taken from the
    rows before they ship (at one device the exchange is the identity;
    ``row_bytes`` as ``markdup_columns`` takes it).  Returns ((sorted
    rows, lengths, int32 global indices), (uint32 [6, R] columns, uint8
    [R] elig)); the columns stay in input row order, so row i is global
    index ``base + i``."""
    fused_sort_markdup_step.launches += 1
    cols = markdup_columns(rows, count, lib, kmax, row_bytes)
    return bytes_sort_step(rows, lens, count, base, bhi, blo), cols


fused_sort_markdup_step.launches = 0


# ---------------------------------------------------------------------------
# K16b: the signature exchange, torch ops
# ---------------------------------------------------------------------------

def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x, c in [0, 2^32), without leaving
    int64's range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def signature_hash(k0, k1, k2, k3, k4) -> torch.Tensor:
    """The reference's uint32 hash mix ``h = (h ^ k) * 0x9E3779B1`` over
    the five signature keys, int64 masked to 32 bits: equal signatures
    land on one device whatever the device count."""
    h = k0.to(torch.int64)
    for k in (k1, k2, k3, k4):
        h = _mul_u32(h ^ k.to(torch.int64), _HASH_MUL)
    return h


def signature_bucket(h: torch.Tensor, valid: torch.Tensor,
                     n_dev: int) -> torch.Tensor:
    """Each row's destination device, ``h % n_dev`` (pads to 0)."""
    return torch.where(valid, h % n_dev, 0)


def exchange_sends(k0, k1, k2, k3, k4, score, gidx, count: int,
                   n_dev: int):
    """One source device's send matrices of the signature exchange:
    six int64 [n_dev, R] key matrices (k0..k4 and the inverted score,
    2^32 - 1 in unfilled cells) and the int32 [n_dev, R] global indices
    (the sentinel in unfilled cells); row b goes to device b."""
    R = gidx.shape[0]
    dev = gidx.device
    valid = torch.arange(R, device=dev) < count
    keys = [k.to(torch.int64) for k in (k0, k1, k2, k3, k4)]
    bucket = signature_bucket(signature_hash(*keys), valid, n_dev)
    perm = torch.argsort(bucket, stable=True)
    sb = bucket[perm]
    rank = torch.arange(R, device=dev) - torch.searchsorted(sb, sb,
                                                            side="left")
    # the inverted score: an ascending sort puts the highest score first
    keys.append(_U32 - torch.where(valid, score.to(torch.int64), 0))
    pad = torch.full((R,), _U32, dtype=torch.int64, device=dev)
    sends = [torch.full((n_dev, R), _U32, dtype=torch.int64,
                        device=dev).index_put_((sb, rank),
                                               torch.where(valid, x, pad)[perm])
             for x in keys]
    six = torch.where(valid, gidx, torch.full_like(gidx, _I32_SENTINEL))
    send_ix = torch.full((n_dev, R), _I32_SENTINEL, dtype=torch.int32,
                         device=dev).index_put_((sb, rank), six[perm])
    return sends, send_ix


def _pair_key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the lexicographic order of two
    32-bit unsigned keys."""
    return ((a - (1 << 31)) << 32) | b


def duplicate_bits(keys, six: torch.Tensor):
    """The receive side: the reference's 7-key sort over (k0..k4,
    inverted score, global index) as stable sorts (the index, then the
    packed key pairs from the least significant up), then a row is a
    duplicate when it and the row before it are real records with the
    same k0..k4.  Returns (sorted int32 global indices, uint8 bits)."""
    order = torch.sort(six, stable=True).indices
    for a, b in ((keys[4], keys[5]), (keys[2], keys[3]),
                 (keys[0], keys[1])):
        order = order[torch.sort(_pair_key(a[order], b[order]),
                                 stable=True).indices]
    s = [k[order] for k in keys[:5]]
    six = six[order]
    ok = six != _I32_SENTINEL
    same = ok[1:] & ok[:-1]
    for k in s:
        same &= k[1:] == k[:-1]
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool,
                                       device=six.device), same])
    return six, (ok & prev_same).to(torch.uint8)


def markdup_exchange_step(k0, k1, k2, k3, k4, score, gidx: torch.Tensor,
                          count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16b on one device: the first ``count`` rows of the eligible
    records' columns (uint32 or int64 k0..k4 and score, int32 global
    indices) through the hash bucket, the exchange (the identity) and
    the 7-key sort.  Returns (int32 global indices in group order,
    uint8 duplicate bits), sentinel rows last.
    ``markdup_exchange_step.launches`` counts its calls."""
    markdup_exchange_step.launches += 1
    sends, send_ix = exchange_sends(k0, k1, k2, k3, k4, score, gidx, count,
                                    1)
    recv = [_all_to_all(s).reshape(-1) for s in sends]
    return duplicate_bits(recv, _all_to_all(send_ix).reshape(-1))


markdup_exchange_step.launches = 0
