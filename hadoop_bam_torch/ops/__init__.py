"""ops layer of the hadoop_bam_torch port (see the package docstring)."""
