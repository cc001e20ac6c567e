"""``api.query_regions``: the tensor-batch face of the query engine
(counterpart of hadoop_bam_tpu/api/query.py, with ``device=`` in place
of ``mesh=``).

Where ``BamDataset.tensor_batches`` streams a whole file, this streams
the union of a batch of region queries: the engine resolves every
region through the files' indexes, decodes each needed chunk once
(cached across calls on one engine) and yields device groups whose
``keep`` mask the overlap step (K13) computed on the device.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.query.engine import QueryEngine, QueryRequest

RequestLike = Union[QueryRequest, Tuple[str, str]]


def query_regions(requests: "Sequence[RequestLike] | RequestLike",
                  regions: Optional[Sequence[str]] = None,
                  *, config: HBamConfig = DEFAULT_CONFIG,
                  engine: Optional[QueryEngine] = None,
                  device=None,
                  deadline_s: Optional[float] = None) -> Iterator[Dict]:
    """Serve a batch of region queries as device tensor batches.

    Two calling shapes::

        query_regions([("a.bam", "chr1:1-5000"), ("b.bam", "chr2")])
        query_regions("a.bam", ["chr1:1-5000", "chr2:100-200"])

    Returns an iterator of ``{rid, pos, end, req, keep, n_records}``
    groups: ``[n_dev, rows]`` int32 columns on the device, ``keep`` the
    boolean overlap mask, ``req`` each row's request index.  Pass a
    long-lived ``engine`` to reuse its chunk cache across calls;
    otherwise a fresh engine (and cold cache) is built on ``device``
    (``cuda:0`` unless named; RuntimeError at the call without a
    card)."""
    if isinstance(requests, (str, bytes)):
        if regions is None:
            raise TypeError(
                "query_regions(path, regions): regions list required")
        batch = [QueryRequest(str(requests), r) for r in regions]
    else:
        batch = [r if isinstance(r, QueryRequest) else QueryRequest(*r)
                 for r in requests]
    if engine is None:
        engine = QueryEngine(config=config, device=device)
    return engine.tensor_batches(batch, deadline_s=deadline_s)
