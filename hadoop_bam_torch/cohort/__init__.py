"""The cohort plane (counterpart of hadoop_bam_tpu/cohort/): thousands of
single-sample VCF/BCF files joined on position into one
``[variants, samples]`` dosage tensor on the card.

- ``manifest``: the named input set and its cache-keying identity;
- ``harmonize``: per-site allele harmonization (multi-allelic split and
  merge, REF/ALT swaps, duplicate positions);
- ``join``: the k-way streaming position merge (split/kmerge.py) with a
  fault domain a sample file;
- ``dataset``: ``CohortDataset``: the joined chunks, journaled or not,
  and ``tensor_batches`` through the shared feed with the sentinels;
- ``gwas``: allele frequency, call rate, HWE and score-test columns
  (K17a, a hand CUDA kernel);
- ``serving``: cohort-slice requests from device-resident dosage tiles
  (K17b, ``ServeLoop.query(..., cohort=True)``).
"""
from hadoop_bam_torch.cohort.manifest import (      # noqa: F401
    CohortManifest, CohortSample, as_manifest, load_manifest,
)
from hadoop_bam_torch.cohort.dataset import (       # noqa: F401
    CohortDataset, open_cohort,
)
from hadoop_bam_torch.cohort.gwas import (          # noqa: F401
    GWAS_COLUMNS, cohort_gwas, cohort_gwas_plain, cohort_gwas_step,
)
