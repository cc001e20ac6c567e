"""Sequence/quality payload decode (counterpart of
hadoop_bam_tpu/ops/seq_decode.py): 4-bit packed bases and raw qualities
at per-read offsets in an inflated span become [N, L] ASCII matrices, and
small reductions over them.  Plain PyTorch on the tensors' device."""
from __future__ import annotations

import torch

from hadoop_bam_torch.formats.bam import SEQ_NIBBLE

_NIBBLE_LUT = list(SEQ_NIBBLE.encode())


def _span_indices(offsets: torch.Tensor, steps: torch.Tensor, size: int
                  ) -> torch.Tensor:
    """offsets[:, None] + steps, capped at size - 1, then the reference
    gather rule (negative counts from the end, clamp to [0, size - 1])."""
    idx = offsets.to(torch.int64)[:, None] + steps[None, :]
    idx = torch.minimum(idx, torch.tensor(size - 1, device=idx.device))
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp_(0, size - 1)


def decode_seq(data: torch.Tensor, seq_offsets: torch.Tensor,
               l_seq: torch.Tensor, max_len: int) -> torch.Tensor:
    """data u8 [D]; seq_offsets/l_seq i32 [N] -> ASCII bases u8
    [N, max_len], zero beyond each read's length."""
    pos = torch.arange(max_len, device=data.device)
    packed = data[_span_indices(seq_offsets, pos // 2, data.shape[0])]
    nibble = torch.where(pos % 2 == 0, packed >> 4, packed & 0xF)
    lut = torch.tensor(_NIBBLE_LUT, dtype=torch.uint8, device=data.device)
    ascii_ = lut[nibble.to(torch.int64)]
    mask = pos[None, :] < l_seq.to(torch.int64)[:, None]
    return torch.where(mask, ascii_, 0).to(torch.uint8)


def decode_qual(data: torch.Tensor, qual_offsets: torch.Tensor,
                l_seq: torch.Tensor, max_len: int,
                ascii_offset: int = 33) -> torch.Tensor:
    """Phred qualities as ASCII (+33 by default, wrapping in uint8 as the
    reference does); 0 beyond length and for absent (0xFF) qualities."""
    pos = torch.arange(max_len, device=data.device)
    q = data[_span_indices(qual_offsets, pos, data.shape[0])]
    mask = (pos[None, :] < l_seq.to(torch.int64)[:, None]) & (q != 0xFF)
    shifted = ((q.to(torch.int32) + ascii_offset) & 0xFF).to(torch.uint8)
    return torch.where(mask, shifted, 0).to(torch.uint8)


def base_composition(seq_ascii: torch.Tensor) -> torch.Tensor:
    """Count A/C/G/T/N/other over an [N, L] ASCII base matrix -> int32 [6]."""
    flat = seq_ascii.reshape(-1)
    live = flat != 0
    codes = torch.tensor(list(b"ACGTN"), dtype=flat.dtype,
                         device=flat.device)
    hits = (flat[None, :] == codes[:, None]) & live[None, :]
    counts = hits.sum(dim=1, dtype=torch.int32)
    other = live.sum(dtype=torch.int32) - counts.sum(dtype=torch.int32)
    return torch.cat([counts, other[None]])


def mean_base_quality(qual_ascii: torch.Tensor, ascii_offset: int = 33
                      ) -> torch.Tensor:
    """Mean Phred score over valid bases of an [N, L] ASCII quality
    matrix (f32, as the reference's int32 sum over int32 count)."""
    live = qual_ascii != 0
    q = torch.where(live, qual_ascii.to(torch.int32) - ascii_offset, 0)
    n = torch.clamp(live.sum(dtype=torch.int32), min=1)
    return q.sum(dtype=torch.int32).to(torch.float32) / n.to(torch.float32)
