"""User entry points of the port: ``open_bam``, ``open_fastq``,
``open_qseq`` and ``open_fasta`` (each ``(path, device=None, config)``),
and ``query_regions`` (batched BAM region queries)."""
from hadoop_bam_torch.api.dataset import BamDataset, open_bam
from hadoop_bam_torch.api.read_datasets import (
    FastaDataset, FastqDataset, QseqDataset, open_fasta, open_fastq,
    open_qseq,
)
from hadoop_bam_torch.api.query import query_regions

__all__ = ["BamDataset", "FastaDataset", "FastqDataset", "QseqDataset",
           "open_bam", "open_fasta", "open_fastq", "open_qseq",
           "query_regions"]
