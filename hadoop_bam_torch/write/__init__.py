"""The write path: ``parallel_bgzf.ParallelBGZFWriter`` (deflates on the
shared pool, blocks committed in order), ``indexing`` (BAI and splitting
index sidecars built during the write), ``api.write_bam_records``, the
front door ``utils/sort.py`` and ``parallel/mesh_sort.py`` write
through, and ``sharded.ShardedFileWriter`` with
``api.write_bam_shards_concat``, the part-a-bucket write that duplicate
marking takes at more than one device."""
from hadoop_bam_torch.write.api import (            # noqa: F401
    WriteResult, write_bam_records, write_bam_shards_concat,
)
from hadoop_bam_torch.write.indexing import (       # noqa: F401
    BamIndexingSink, resolve_index_kinds,
)
from hadoop_bam_torch.write.parallel_bgzf import (  # noqa: F401
    ParallelBGZFWriter,
)
from hadoop_bam_torch.write.sharded import (        # noqa: F401
    ShardedFileWriter,
)
