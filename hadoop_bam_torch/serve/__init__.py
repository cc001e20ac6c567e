"""The resident multi-tenant region server (counterpart of
hadoop_bam_tpu/serve/, single-replica):

- ``tiles``: ``DeviceTileCache``, the cache tier of decoded interval
  tiles resident on the card above the host chunk LRU (a hit skips
  fetch, inflate and host decode), ``tile_filter_step`` (the rest of
  K13), ``TileBuilder`` (tiles through a staging ring with slot
  pinning) and ``device_build_chunk`` (cold tiles on the device plane:
  K7+K8, K9, K1 and K10i);
- ``prefetch``: ``Prefetcher``, adjacent-window decode into the host
  cache at background pool priority;
- ``tenancy``: ``TenantQuotas``, per-tenant admission gates, breakers
  and the ``interactive`` / ``batch`` priority classes;
- ``loop``: ``ServeLoop``, the server: client futures, one dispatcher
  thread that owns every device call and its CUDA stream, per-client
  ``MetricsContext`` isolation, SLO accounting;
- ``transport``: JSONL over a stream (``handle_stream``,
  ``serve_stdio``) or TCP (``make_tcp_server``).

Entry point: ``ServeLoop(device=...)``.  The serving fleet
(``serve/fleet.py``, ``serve/membership.py``) waits for ROADMAP Queue 1
item 11a.
"""
from hadoop_bam_torch.serve.loop import ServeLoop, ServeResult  # noqa: F401
from hadoop_bam_torch.serve.prefetch import Prefetcher  # noqa: F401
from hadoop_bam_torch.serve.tenancy import (  # noqa: F401
    PRIORITIES, TenantQuotas,
)
from hadoop_bam_torch.serve.tiles import (  # noqa: F401
    DeviceTileCache, TileBuilder, TileSet, tile_filter_step, tile_key,
)
from hadoop_bam_torch.serve.transport import (  # noqa: F401
    effective_deadline_s, handle_stream, make_tcp_server, serve_stdio,
)
