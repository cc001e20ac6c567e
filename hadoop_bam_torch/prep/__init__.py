"""Duplicate marking (counterpart of hadoop_bam_tpu/prep/): the
reference's last pipeline over BAM, read -> sort exchange -> markdup ->
indexed write in one pass.

- ``oracle``: the serial host oracle, the one definition of the
  duplicate signature, the score and the flag patch;
- ``markdup``: K16, the signature columns (a hand kernel, K16a) fused
  into the sort exchange's step, and the signature exchange (K16b);
- ``pipeline``: the journaled pipeline, with a resume grain a stage
  (round, markdup, shard).
"""
from hadoop_bam_torch.prep.oracle import markdup_bam_oracle  # noqa: F401
from hadoop_bam_torch.prep.pipeline import markdup_bam_mesh  # noqa: F401
