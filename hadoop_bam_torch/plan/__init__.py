"""Plane selection (counterpart of hadoop_bam_tpu/plan/)."""
