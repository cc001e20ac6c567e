"""User entry points of the port: ``open_bam(path, device=None)``."""
from hadoop_bam_torch.api.dataset import BamDataset, open_bam

__all__ = ["BamDataset", "open_bam"]
