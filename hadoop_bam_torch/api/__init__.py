"""User entry points of the port: ``open_bam``, ``open_fastq``,
``open_qseq`` and ``open_fasta`` (each ``(path, device=None, config)``),
``query_regions`` (batched BAM region queries), and the cohort plane's
``open_cohort`` (a manifest, ``device=None``, ``config``,
``journal_path``) and ``cohort_gwas``."""
from hadoop_bam_torch.api.dataset import BamDataset, open_bam
from hadoop_bam_torch.api.read_datasets import (
    FastaDataset, FastqDataset, QseqDataset, open_fasta, open_fastq,
    open_qseq,
)
from hadoop_bam_torch.api.query import query_regions
from hadoop_bam_torch.cohort import (
    CohortDataset, CohortManifest, cohort_gwas, open_cohort,
)

__all__ = ["BamDataset", "CohortDataset", "CohortManifest", "FastaDataset",
           "FastqDataset", "QseqDataset", "cohort_gwas", "open_bam",
           "open_cohort", "open_fasta", "open_fastq", "open_qseq",
           "query_regions"]
