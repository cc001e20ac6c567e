"""Batched random-access region queries over indexed BAMs (counterpart
of hadoop_bam_tpu/query/):

- ``engine``: ``QueryEngine`` resolves a batch of (path, region)
  requests through each file's ``.bai`` / ``.csi`` to chunks coalesced
  across requests, decodes each once and filters the candidates on the
  device with the interval-overlap step (K13);
- ``cache``: ``ChunkCache``, the byte-budgeted LRU of decoded chunks
  keyed by file identity and virtual-offset range;
- ``scheduler``: ``QueryScheduler``, bounded in-flight admission with a
  bounded wait queue, and per-request ``Deadline`` s.

API: ``api.query_regions``.
"""
from hadoop_bam_torch.query.cache import ChunkCache, file_identity  # noqa: F401
from hadoop_bam_torch.query.scheduler import (  # noqa: F401
    Deadline, QueryScheduler,
)
from hadoop_bam_torch.query.engine import (  # noqa: F401
    QueryEngine, QueryRequest, QueryResult,
)
