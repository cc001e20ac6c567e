"""hadoop_bam_torch: the PyTorch + CUDA port of hadoop_bam_tpu.

The first slice runs BAM flagstat and BAM seq-stats end to end on one
NVIDIA H100: record-aligned span planning, host inflate + record walk in
C++ (``native/hbam_native.cpp``, built by this package's own loader),
fixed-stride row tiles staged through pinned host memory, and device
reductions through two hand-written CUDA kernels (``csrc/``):

- ``ops/unpack_bam.py::unpack_fixed_fields`` (the fixed-field gather of
  ``hadoop_bam_tpu/ops/unpack_bam.py::unpack_fixed_fields_pallas``);
- ``ops/seq_stats.py::seq_qual_stats`` (the payload stats kernel of
  ``hadoop_bam_tpu/ops/seq_pallas.py``).

The package imports ``torch`` and ``numpy`` only; it never imports
``jax`` or ``hadoop_bam_tpu``.  Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"``.

    from hadoop_bam_torch.api import open_bam
    ds = open_bam("sample.bam")
    ds.flagstat()
    ds.seq_stats()
    ds.tensor_batches()

The read formats (``open_fastq``, ``open_qseq``, ``open_fasta``,
``parallel.pipeline.fastq_seq_stats_file``) feed the same K2 kernel.
Later slices add the device decode plane, coverage, region queries and
the resident server, the variant plane, the mesh sort, duplicate
marking and the cohort plane (``cohort/``: ``api.open_cohort``).
"""
