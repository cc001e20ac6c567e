"""Per-site allele harmonization: k samples' records -> one joined row
(copy of hadoop_bam_tpu/cohort/harmonize.py).

Single-sample callers emit the SAME variant in different shapes: ALT
lists in different orders, multi-allelic sites split across calls,
even REF/ALT swapped (the caller normalized against the other allele).
Joining on position alone would average apples with oranges, so every
joined site runs through one harmonization pass:

- the **canonical REF** is the majority REF string among the site's
  records (ties break toward the earliest sample — deterministic
  because the k-way merge groups in stream order);
- **canonical ALTs** are the union, in sample order, of the ALT strings
  of records whose REF matches the canonical REF (the multi-allelic
  split/merge case: sample A's ``A->G`` and sample B's ``A->T`` join as
  ``A -> [G, T]``);
- a record whose REF does NOT match canonical is admitted only when
  its REF string is ITSELF in the canonical allele set (a true REF/ALT
  swap); its alleles then map **by string** into the canonical set, so
  a swapped caller's hom-ref ``0/0`` becomes dosage 2.  A genuinely
  inconsistent record (e.g. an indel REF overlapping a SNP site) is
  rejected wholesale — that sample's call becomes the missing sentinel
  (-1), counted as ``dropped`` — even when one of its ALT strings
  happens to collide with a canonical allele (an ``AT->A`` deletion's
  ALT "A" is NOT the SNP site's reference allele).  Mismatched-REF
  records never mint NEW canonical alleles: appending an unmapped
  indel REF as an ALT would fabricate an allele no consistent caller
  saw.
- **duplicate positions within one input** (same sample, same site,
  two records): the FIRST record wins, the rest are counted as
  ``duplicates`` and ignored — re-blocked gVCF spills do this.

Dosage is diploid-and-beyond ALT-allele count against the canonical
set: number of called alleles whose canonical index is non-zero;
any missing/unmappable allele makes the whole call -1 (matching the
tiles' sentinel convention; qual's sentinel is NaN).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SampleSite:
    """One sample's record at one position, reduced to what the join
    needs (parsed once, in the sample's stream thread)."""
    chrom: int                        # shared cohort contig index
    pos: int                          # 1-based
    ref: str
    alts: Tuple[str, ...]
    alleles: Tuple[Optional[int], ...]  # GT allele indices; None = '.'
    qual: float                       # NaN when missing

    @property
    def key(self) -> Tuple[int, int]:
        return (self.chrom, self.pos)


@dataclasses.dataclass
class HarmonizedSite:
    """One joined [variants, samples] row plus its accounting."""
    chrom: int
    pos: int
    n_allele: int                     # 1 + canonical ALT count
    dosage: np.ndarray                # [n_samples] int8, -1 missing
    qual: np.ndarray                  # [n_samples] float32, NaN missing
    duplicates: int                   # extra same-sample records dropped
    dropped: int                      # calls lost to REF inconsistency


def harmonize_site(entries: Sequence[Tuple[int, SampleSite]],
                   n_samples: int) -> HarmonizedSite:
    """``entries`` is one k-merge group: ``(sample_index, site)`` pairs
    at a single (chrom, pos), in sample order.  Returns the joined row;
    samples absent from the group keep the missing sentinels."""
    # duplicate positions within one input: first record per sample wins
    first: Dict[int, SampleSite] = {}
    duplicates = 0
    for si, site in entries:
        if si in first:
            duplicates += 1
        else:
            first[si] = site

    sites = list(first.items())
    # canonical REF: majority, ties toward the earliest sample
    counts: Dict[str, int] = {}
    order: Dict[str, int] = {}
    for rank, (_si, s) in enumerate(sites):
        counts[s.ref] = counts.get(s.ref, 0) + 1
        order.setdefault(s.ref, rank)
    ref = min(counts, key=lambda r: (-counts[r], order[r]))

    # canonical ALTs: union in sample order from REF-consistent records
    alts: List[str] = []
    index: Dict[str, int] = {ref: 0}
    for _si, s in sites:
        if s.ref != ref:
            continue
        for a in s.alts:
            if a not in index:
                alts.append(a)
                index[a] = len(alts)

    dosage = np.full(n_samples, -1, dtype=np.int8)
    qual = np.full(n_samples, np.nan, dtype=np.float32)
    dropped = 0
    for si, s in sites:
        qual[si] = np.float32(s.qual)
        if not s.alleles:
            continue                   # no GT block: call stays missing
        if s.ref != ref and s.ref not in index:
            # not a swap — an incompatible variant shape at this
            # position: reject the whole record (string-level ALT
            # collisions must not smuggle it in)
            dropped += 1
            continue
        local = (s.ref,) + s.alts      # this record's allele strings
        dose = 0
        ok = True
        for a in s.alleles:
            if a is None or not (0 <= a < len(local)):
                ok = False             # '.' or out-of-range index
                break
            canon = index.get(local[a])
            if canon is None:
                # a swap record calling an allele the canonical set
                # never saw: unusable — sentinel, counted
                ok = False
                dropped += 1
                break
            dose += 1 if canon != 0 else 0
        if ok:
            dosage[si] = min(dose, 127)
    return HarmonizedSite(
        chrom=sites[0][1].chrom, pos=sites[0][1].pos,
        n_allele=1 + len(alts), dosage=dosage, qual=qual,
        duplicates=duplicates, dropped=dropped)
