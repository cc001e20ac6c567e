"""The port's twin of the reference's jitted entry step
(``__graft_entry__._forward_step``): over one padded inflated span,
gather the fixed fields (K1), reduce them to the flagstat counters,
decode the bases at each record's sequence offset and count the base
composition."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from hadoop_bam_torch.ops.flagstat import flagstat_from_columns
from hadoop_bam_torch.ops.seq_decode import base_composition, decode_seq
from hadoop_bam_torch.ops.unpack_bam import PREFIX, unpack_fixed_fields

MAX_LEN = 160


def forward_step(data: torch.Tensor, offsets: torch.Tensor, count: int,
                 max_len: int = MAX_LEN
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """data u8 [D], offsets i32 [N] (``count`` valid) -> (flagstat dict of
    int32 scalars, int32 [6] A/C/G/T/N/other composition)."""
    cols = unpack_fixed_fields(data, offsets)
    valid = torch.arange(offsets.shape[0], device=offsets.device) < count
    stats = flagstat_from_columns(cols, valid)
    seq_off = (offsets.to(torch.int64) + PREFIX + cols["l_read_name"]
               + 4 * cols["n_cigar"]).to(torch.int32)
    seq = decode_seq(data, seq_off, torch.where(valid, cols["l_seq"], 0),
                     max_len)
    return stats, base_composition(seq)
