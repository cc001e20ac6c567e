"""CIGAR geometry on tensors: ragged cigar unpack, reference spans and
per-base coverage (counterpart of hadoop_bam_tpu/ops/cigar.py, K12).

The ragged cigar arrays become fixed-shape ``[N, max_cigar]`` tiles of
cigar words (zero-padded: a zero word is a 0-length M op, which every
reduction ignores), and geometry falls out of masked row reductions:

- ``reference_span_from_tiles``: bases consumed on the reference
  (M/D/N/=/X), equal to the host ``BamBatch.reference_span``;
- ``window_coverage_from_tiles``: exact per-base aligned-base depth
  (M/=/X only: deletions and skips add none) over a genomic window, as
  a diff-array scatter plus a cumsum.

The reference jits these as XLA code (no Pallas kernel).  PyTorch has a
direct form for each step (gathers, masks, ``index_add_`` into the diff
array, ``cumsum``), so they are plain torch ops, on the card and on the
CPU alike.

Words are held in int64 masked to 32 bits (torch has no uint32 shifts).
Coordinates are int32 throughout, as in the reference: ``op_start =
pos + cumsum(adv) - adv`` wraps in int32 exactly as it does there, and
the clip into the window reads the wrapped value (``cumsum`` is given
``dtype=torch.int32``; torch would widen it to int64 otherwise).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from hadoop_bam_torch.ops.unpack_bam import PREFIX

# op codes [SPEC]: M I D N S H P = X
_REF_CONSUMING = (0, 2, 3, 7, 8)     # M D N = X
_ALIGNED = (0, 7, 8)                 # M = X  (bases that add depth)
_I32 = torch.int32
# slots past the window's diff that the ops adding nothing are sent to,
# spread by position: one shared slot would take every such op's atomic
# add on the card, one after another
SPREAD = 1024


def _is_in(op: torch.Tensor, codes: Tuple[int, ...]) -> torch.Tensor:
    m = op == codes[0]
    for c in codes[1:]:
        m = m | (op == c)
    return m


def unpack_cigar_tiles(data: torch.Tensor, offsets: torch.Tensor,
                       l_read_name: torch.Tensor, n_cigar: torch.Tensor,
                       max_cigar: int) -> torch.Tensor:
    """Each record's cigar words as an int64 ``[N, max_cigar]`` tile of
    values below 2^32.  ``data`` is the inflated span (uint8); a record's
    cigar begins at ``offset + PREFIX + l_read_name``.  Ops past
    ``n_cigar`` are 0; gathers past the buffer clamp to its last word.

    Records with ``n_cigar > max_cigar`` are truncated here: callers
    check ``n_cigar.max() <= max_cigar`` on the host first, as
    ``coverage_file`` does."""
    n = offsets.shape[0]
    if data.shape[0] < 4:
        # a buffer shorter than one word holds no ops (the reference's
        # 4-byte floor: the clip below would get a negative bound)
        return torch.zeros((n, max_cigar), dtype=torch.int64,
                           device=data.device)
    start = offsets.to(torch.int64) + PREFIX + l_read_name.to(torch.int64)
    j = torch.arange(max_cigar, device=data.device)
    base = (start[:, None] + 4 * j[None, :]).clamp_(0, data.shape[0] - 4)
    d = data.to(torch.int64)
    w = d[base] | (d[base + 1] << 8) | (d[base + 2] << 16) | \
        (d[base + 3] << 24)
    valid = j[None, :] < n_cigar.to(torch.int64)[:, None]
    return torch.where(valid, w, torch.zeros((), dtype=torch.int64,
                                             device=w.device))


def _op_len(tiles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    words = tiles.to(torch.int64) & 0xFFFFFFFF
    return (words & 0xF).to(_I32), (words >> 4).to(_I32)


def reference_span_from_tiles(tiles: torch.Tensor, n_cigar: torch.Tensor,
                              l_seq: torch.Tensor) -> torch.Tensor:
    """Reference bases consumed per record (int32); '*'-cigar records
    fall back to l_seq (``BamBatch.reference_span``)."""
    op, ln = _op_len(tiles)
    span = torch.where(_is_in(op, _REF_CONSUMING), ln,
                       torch.zeros_like(ln)).sum(1, dtype=_I32)
    return torch.where(n_cigar > 0, span, l_seq.to(_I32).clamp(min=0))


def coverage_diff_from_tiles(tiles: torch.Tensor, pos: torch.Tensor,
                             refid: torch.Tensor, flag: torch.Tensor,
                             row_valid: torch.Tensor, target_refid: int,
                             win_start: int, window: int,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The diff array of ``window_coverage_from_tiles``: +1 at each
    aligned op's clipped start, -1 at its clipped end, added into
    ``out`` (int32 ``[window + 1 + SPREAD]``, made when None) and
    returned.  The depth is ``cumsum(diff[:window])``; diffs of many
    tiles add before one cumsum (int32 sums wrap alike in either order).

    Ops that add nothing (not aligned, off the target, unmapped, past
    the row count, or of length 0: the tile's zero padding) add 0 into
    the ``SPREAD`` slots past ``window`` instead of at index 0 as the
    reference's scatter does; the depth is the same integers."""
    op, ln = _op_len(tiles)
    adv = torch.where(_is_in(op, _REF_CONSUMING), ln, torch.zeros_like(ln))
    op_start = pos.to(_I32)[:, None] + torch.cumsum(adv, 1, dtype=_I32) \
        - adv
    keep = (_is_in(op, _ALIGNED)
            & (ln > 0)
            & row_valid[:, None]
            & ((flag.to(_I32)[:, None] & 4) == 0)
            & (refid.to(_I32)[:, None] == target_refid))
    ws = torch.tensor(win_start, dtype=_I32, device=tiles.device)
    s = (op_start - ws).clamp_(0, window)
    e = (op_start + ln - ws).clamp_(0, window)
    spare = window + 1 + torch.arange(
        keep.numel(), dtype=_I32, device=tiles.device).view(keep.shape) \
        % SPREAD
    s = torch.where(keep, s, spare)
    e = torch.where(keep, e, spare)
    one = keep.to(_I32).reshape(-1)
    if out is None:
        out = torch.zeros(window + 1 + SPREAD, dtype=_I32,
                          device=tiles.device)
    elif out.shape != (window + 1 + SPREAD,) or out.dtype != _I32:
        # index_add_ past the end is a device-side assert on the card
        raise ValueError(f"out must be int32 [{window + 1 + SPREAD}], got "
                         f"{out.dtype} {tuple(out.shape)}")
    out.index_add_(0, s.reshape(-1).to(torch.int64), one)
    out.index_add_(0, e.reshape(-1).to(torch.int64), -one)
    return out


def window_coverage_from_tiles(tiles: torch.Tensor, pos: torch.Tensor,
                               refid: torch.Tensor, flag: torch.Tensor,
                               row_valid: torch.Tensor, target_refid: int,
                               win_start: int, window: int) -> torch.Tensor:
    """Exact per-base depth of aligned bases over ``[win_start, win_start
    + window)`` of reference ``target_refid`` (int32 ``[window]``).

    M/=/X op bases of mapped records on the target count; D/N ops move
    the reference cursor without depth; unmapped records (FLAG 0x4) and
    rows past ``row_valid`` count nothing; padding ops are zero words
    (0-length M ops, net zero in the diff array)."""
    diff = coverage_diff_from_tiles(tiles, pos, refid, flag, row_valid,
                                    target_refid, win_start, window)
    return torch.cumsum(diff[:window], 0, dtype=_I32)
