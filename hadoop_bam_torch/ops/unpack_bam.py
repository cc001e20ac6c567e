"""Batched BAM fixed-field unpack: bytes + offsets -> int32 columns.

Counterpart of hadoop_bam_tpu/ops/unpack_bam.py.  Two entry shapes:

- ``unpack_projected_tile`` / ``unpack_fixed_fields_tile``: the host packed
  each record's projected prefix bytes into a dense row tile, so field
  extraction is elementwise PyTorch (no gather);
- ``unpack_fixed_fields``: the span-mode gather at record offsets over
  the whole inflated span.  On a CUDA tensor it launches the K1 kernel
  (``csrc/unpack_bam.cu``); on a CPU tensor it runs the plain PyTorch
  version ``unpack_fixed_fields_plain`` beside it.

Padding convention: offsets[i] for i >= n_records point at valid bytes
(use 0); consumers mask with ``valid = arange(N) < n_records``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hadoop_bam_torch.ops import kernels

# column name -> (byte offset in record, byte width, signed)
FIXED_FIELDS: Dict[str, Tuple[int, int, bool]] = {
    "block_size": (0, 4, True),
    "refid": (4, 4, True),
    "pos": (8, 4, True),
    "l_read_name": (12, 1, False),
    "mapq": (13, 1, False),
    "bin": (14, 2, False),
    "n_cigar": (16, 2, False),
    "flag": (18, 2, False),
    "l_seq": (20, 4, True),
    "mate_refid": (24, 4, True),
    "mate_pos": (28, 4, True),
    "tlen": (32, 4, True),
}

PREFIX = 36

ALL_FIELDS: Tuple[str, ...] = tuple(FIXED_FIELDS)

# pushdown projection for flagstat: only the columns the reduction reads
# cross the host->device link (11 bytes/record instead of 36)
FLAGSTAT_PROJECTION: Tuple[str, ...] = ("flag", "refid", "mate_refid", "mapq")


def projection_row_bytes(fields: Tuple[str, ...]) -> int:
    return sum(FIXED_FIELDS[name][1] for name in fields)


def projection_ranges(fields: Tuple[str, ...]) -> "list[tuple[int, int]]":
    """(src_offset, length) copy ranges for the host row packer, with
    adjacent source ranges merged (the full-field projection is one
    36-byte copy)."""
    ranges: list[tuple[int, int]] = []
    for name in fields:
        off, width, _ = FIXED_FIELDS[name]
        if ranges and ranges[-1][0] + ranges[-1][1] == off:
            ranges[-1] = (ranges[-1][0], ranges[-1][1] + width)
        else:
            ranges.append((off, width))
    return ranges


def _le_int32(cols: torch.Tensor) -> torch.Tensor:
    """[N, width] byte columns (int64) -> little-endian value as int32:
    1- and 2-byte fields zero-extended, 4-byte fields reinterpreted."""
    acc = cols[:, 0]
    for k in range(1, cols.shape[1]):
        acc = acc | (cols[:, k] << (8 * k))
    if cols.shape[1] == 4:
        acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    return acc.to(torch.int32)


def unpack_projected_tile(tile: torch.Tensor, fields: Tuple[str, ...]
                          ) -> Dict[str, torch.Tensor]:
    """tile: [N, row_bytes] uint8, rows packed per ``fields`` order ->
    dict of int32 [N] columns."""
    t = tile.to(torch.int64)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name in fields:
        width = FIXED_FIELDS[name][1]
        out[name] = _le_int32(t[:, off:off + width])
        off += width
    return out


def unpack_fixed_fields_tile(tile: torch.Tensor) -> Dict[str, torch.Tensor]:
    """tile: [N, 36] uint8 record prefixes -> dict of int32 columns."""
    return unpack_projected_tile(tile, ALL_FIELDS)


def gather_indices(offsets: torch.Tensor, width: int, size: int
                   ) -> torch.Tensor:
    """[N, width] byte indices offsets[:, None] + arange(width) under the
    reference's gather rule: a negative index counts from the end, then
    every index is clamped to [0, size - 1]."""
    idx = offsets.to(torch.int64)[:, None] + torch.arange(
        width, device=offsets.device)[None, :]
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp_(0, size - 1)


def unpack_fixed_fields_plain(data: torch.Tensor, offsets: torch.Tensor
                              ) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the K1 kernel: one [N, 36] gather, then
    the tile unpack."""
    tile = data[gather_indices(offsets, PREFIX, data.shape[0])]
    return unpack_fixed_fields_tile(tile)


def _check_gather_args(data: torch.Tensor, offsets: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise ValueError(f"data must be uint8 [D], got {data.dtype} "
                         f"{tuple(data.shape)}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise ValueError(f"offsets must be int32 [N], got {offsets.dtype} "
                         f"{tuple(offsets.shape)}")
    if data.device != offsets.device:
        raise ValueError(f"data on {data.device}, offsets on "
                         f"{offsets.device}")
    if data.shape[0] == 0 and offsets.shape[0] > 0:
        raise ValueError("cannot gather record prefixes from empty data")
    if not (data.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("data and offsets must be contiguous")


def unpack_fixed_fields(data: torch.Tensor, offsets: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
    """data: uint8 [D]; offsets: int32 [N] (padded with safe offsets).
    Returns a dict of int32 [N] columns for every fixed field.

    CUDA tensors launch the K1 kernel on the current stream (no
    synchronisation); CPU tensors take ``unpack_fixed_fields_plain``.
    ``unpack_fixed_fields.launches`` counts kernel launches."""
    _check_gather_args(data, offsets)
    if data.device.type == "cpu":
        return unpack_fixed_fields_plain(data, offsets)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    n = offsets.shape[0]
    out = torch.empty((len(FIXED_FIELDS), n), dtype=torch.int32,
                      device=data.device)
    if n:
        fn = kernels.kernel("unpack_bam")
        with torch.cuda.device(data.device):
            rc = fn(data.data_ptr(), data.shape[0], offsets.data_ptr(), n,
                    out.data_ptr(),
                    torch.cuda.current_stream(data.device).cuda_stream)
        kernels.check_launch("unpack_fixed_fields", rc)
        unpack_fixed_fields.launches += 1
    return dict(zip(FIXED_FIELDS, out.unbind(0)))


unpack_fixed_fields.launches = 0


def pad_offsets(offsets: np.ndarray, capacity: int) -> Tuple[np.ndarray, int]:
    """Host helper: pad an offsets vector to ``capacity`` with zeros."""
    n = int(offsets.size)
    if n > capacity:
        raise ValueError(f"{n} records exceed capacity {capacity}")
    out = np.zeros(capacity, dtype=np.int32)
    out[:n] = offsets
    return out, n


def pad_data(data: np.ndarray, capacity: int) -> np.ndarray:
    """Host helper: pad span bytes to ``capacity``."""
    if data.size > capacity:
        raise ValueError(f"{data.size} bytes exceed capacity {capacity}")
    out = np.zeros(capacity, dtype=np.uint8)
    out[:data.size] = data
    return out
