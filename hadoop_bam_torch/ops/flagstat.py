"""Flagstat: the samtools flagstat counters as a device reduction.

Counterpart of hadoop_bam_tpu/ops/flagstat.py::flagstat_from_columns.
The 16 masked counts are stacked into one [16, N] mask and summed in one
reduction; across devices they finish with the data axis's add.
"""
from __future__ import annotations

from typing import Dict

import torch

from hadoop_bam_torch.formats.bam import (
    FDUP, FMUNMAP, FPAIRED, FPROPER_PAIR, FREAD1, FREAD2, FSECONDARY,
    FSUPPLEMENTARY, FUNMAP,
)

FLAGSTAT_FIELDS = (
    "total", "primary", "secondary", "supplementary", "duplicates",
    "primary_duplicates", "mapped", "primary_mapped", "paired", "read1",
    "read2", "properly_paired", "with_itself_and_mate_mapped", "singletons",
    "mate_on_different_chr", "mate_on_different_chr_mapq5",
)


def flagstat_vector(cols: Dict[str, torch.Tensor], valid: torch.Tensor
                    ) -> torch.Tensor:
    """cols: int32 columns with flag, refid, mate_refid and mapq; valid:
    bool [N].  Returns the int32 [16] counters in FLAGSTAT_FIELDS order."""
    flag = cols["flag"]
    refid = cols["refid"]
    mate_refid = cols["mate_refid"]
    mapq = cols["mapq"]

    def has(bit):
        return (flag & bit) != 0

    secondary = has(FSECONDARY)
    supplementary = has(FSUPPLEMENTARY)
    primary = ~secondary & ~supplementary
    mapped = ~has(FUNMAP)
    paired = has(FPAIRED)
    mate_mapped = ~has(FMUNMAP)
    dup = has(FDUP)
    both = paired & mapped & mate_mapped
    diff_chr = both & (mate_refid != refid) & (refid >= 0) & (mate_refid >= 0)
    masks = torch.stack([
        torch.ones_like(flag, dtype=torch.bool),
        primary,
        secondary,
        supplementary,
        dup,
        primary & dup,
        mapped,
        primary & mapped,
        paired,
        paired & has(FREAD1),
        paired & has(FREAD2),
        paired & has(FPROPER_PAIR) & mapped,
        both,
        paired & mapped & ~mate_mapped,
        diff_chr,
        diff_chr & (mapq >= 5),
    ])
    return (masks & valid[None, :]).sum(dim=1, dtype=torch.int32)


def flagstat_from_columns(cols: Dict[str, torch.Tensor], valid: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """Dict form of ``flagstat_vector``: counter name -> int32 scalar."""
    return dict(zip(FLAGSTAT_FIELDS, flagstat_vector(cols, valid).unbind(0)))
