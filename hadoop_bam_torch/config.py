"""Run configuration of the port: only the fields the slice reads.

``config_from_dict`` and ``geometry_from_dict`` take ``dataclasses.asdict``
of the reference's ``HBamConfig`` / ``PayloadGeometry`` /
``DecodeGeometry``, so a test can run both packages on the same settings.
Keys the slice does not read are ignored, except reference settings that
would change what the drivers return and that the port does not
implement (``UNSUPPORTED``, empty since the failure policy and interval
filters were ported): a non-default value of one of those is refused.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import Callable, Dict, Optional

from hadoop_bam_torch.utils.errors import PlanError

# decode planes: "device" is the token-feed plane (host tokenize, LZ77
# resolve and record walk on the card); "native" and "zlib" inflate and
# walk on the host; "auto" is "native" (see resolve_inflate_backend)
INFLATE_BACKENDS = ("auto", "native", "zlib", "device")


class ValidationStringency(enum.Enum):
    """What a malformed text record does (htsjdk ValidationStringency):
    STRICT raises, LENIENT and SILENT skip it."""

    STRICT = "STRICT"
    LENIENT = "LENIENT"
    SILENT = "SILENT"

    @classmethod
    def parse(cls, s) -> "ValidationStringency":
        """None -> SILENT; a member of this or any other
        ``ValidationStringency`` enum (the reference's included) or a
        name -> the member of that name."""
        if s is None:
            return cls.SILENT
        if isinstance(s, cls):
            return s
        name = s.name if isinstance(s, enum.Enum) else str(s)
        try:
            return cls[name.upper()]
        except KeyError:
            raise PlanError(f"unknown validation stringency {s!r}; "
                            f"expected STRICT, LENIENT or SILENT") from None


class BaseQualityEncoding(enum.Enum):
    """FASTQ/QSEQ base-quality encodings [SPEC offsets]: Sanger is
    Phred+33, Illumina (1.3-1.7) Phred+64."""

    SANGER = 33
    ILLUMINA = 64

    @classmethod
    def parse(cls, s, default: "BaseQualityEncoding"
              ) -> "BaseQualityEncoding":
        """None -> ``default``; a member of this or any other
        ``BaseQualityEncoding`` enum (the reference's included) or a
        name -> the member of that name."""
        if s is None:
            return default
        if isinstance(s, cls):
            return s
        name = s.name if isinstance(s, enum.Enum) else str(s)
        try:
            return cls[name.upper()]
        except KeyError:
            raise PlanError(f"unknown base-quality encoding {s!r}; "
                            f"expected SANGER or ILLUMINA") from None


@dataclasses.dataclass(frozen=True)
class HBamConfig:
    check_crc: bool = False               # verify BGZF CRC32 footers
    inflate_backend: str = "auto"         # decode plane, INFLATE_BACKENDS
    decode_pool_workers: Optional[int] = None  # span decode threads

    # interval filter: "chr20:1-100000,chr21" (samtools grammar, 1-based
    # inclusive); None or "" = no filtering (split/intervals.py)
    bam_intervals: Optional[str] = None

    # span failure policy (parallel/pipeline.decode_with_retry): only
    # TRANSIENT faults are re-attempted, CORRUPT fails fast, PLAN always
    # raises (utils/errors.classify_error)
    span_retries: int = 2                 # TRANSIENT re-decodes per span
    skip_bad_spans: bool = False          # True: quarantine + skip a span
    #                                       the policy gave up on
    max_bad_span_fraction: float = 1.0    # abort past this quarantined
    #                                       share of the plan (1.0: never)
    retry_backoff_base_s: float = 0.05    # first transient-retry delay
    retry_backoff_max_s: float = 2.0      # backoff ceiling
    io_read_retries: int = 0              # > 0: reads go through a
    #                                       RetryingByteSource
    io_read_deadline_s: Optional[float] = None  # per-read deadline

    # adaptive planes (resilience/): oracle-confirmed plane faults demote
    # device -> native -> zlib and heal back through half-open probes
    adaptive_planes: bool = True
    breaker_failure_threshold: float = 3.0  # decayed failures that OPEN
    breaker_window_s: float = 30.0        # failure-rate decay window
    breaker_cooldown_s: float = 5.0       # OPEN -> HALF_OPEN delay
    breaker_half_open_probes: int = 1     # probes HALF_OPEN admits

    # span planning (split/planners.py): byte ranges of split_size (when
    # the caller asks for no span count), snapped to a .splitting-bai /
    # .sbi sidecar when one sits next to the BAM and use_splitting_index
    # is on, and moved past a shared query name when
    # keep_paired_reads_together is on (queryname-grouped BAMs)
    split_size: int = 128 * 1024 * 1024
    use_splitting_index: bool = True
    keep_paired_reads_together: bool = False

    # host decode (parallel/pipeline.py): the fused native inflate + walk
    # + pack of each span, streamed in chunks of decode_chunk_blocks BGZF
    # blocks; False runs the two-pass path (inflate, then walk)
    use_fused_decode: bool = True
    decode_chunk_blocks: int = 32

    # the span window's straggler and hang defence
    # (parallel/pipeline.iter_windowed, jobs/speculate.py)
    pool_task_timeout_s: Optional[float] = None  # hard deadline on the
    #                                       active wait for one pool task:
    #                                       an overrun is abandoned and
    #                                       resubmitted once per
    #                                       span_retries, then raises
    #                                       TransientIOError; None = off
    speculative_decode: bool = True       # race a second copy of a task
    #                                       that outlives the soft deadline
    #                                       (first result wins)
    straggler_multiplier: float = 4.0     # soft deadline = p95 of the
    #                                       decaying task latencies x this
    straggler_min_s: float = 0.5          # soft-deadline floor

    # region queries (query/): decoded-chunk LRU budget, the compressed
    # bytes coalesced into one chunk, rows per overlap dispatch, and
    # admission (concurrent batches, bounded wait queue, deadline)
    query_cache_bytes: int = 256 << 20
    query_chunk_bytes: int = 1 << 20
    query_tile_records: int = 8192
    query_max_in_flight: int = 8
    query_queue_depth: int = 32
    query_deadline_s: Optional[float] = None

    # the resident region server (serve/: ServeLoop): the device-resident
    # interval-tile LRU budget and rows per tile, adjacent-window
    # prefetch at background pool priority, per-tenant admission
    # (running + bounded wait queue, idle gates LRU past max_tenants),
    # the tile builder's staging-ring slots, the retry hint on sheds and
    # the fault pressure that pauses prefetch.  serve_replica_id and
    # serve_peers name a fleet, which the port refuses until it is
    # ported; serve_cohort_manifests is the cohort manifests kept
    # resident before LRU eviction
    serve_tile_cache_bytes: int = 512 << 20
    serve_tile_records: int = 4096
    serve_prefetch: bool = True
    serve_prefetch_depth: int = 2
    serve_recent_regions: int = 16
    serve_tenant_max_in_flight: int = 4
    serve_tenant_queue_depth: int = 16
    serve_max_tenants: int = 64
    serve_ring_slots: int = 3
    serve_replica_id: Optional[str] = None
    serve_peers: str = ""
    serve_shed_retry_after_s: float = 0.1
    serve_prefetch_pause_pressure: float = 3.0
    serve_cohort_manifests: int = 8

    # live ops (obs/flight.py, obs/slo.py): where flight-recorder dumps
    # land (None: the ring stays in memory) and how many are kept; the
    # per-tenant latency objective, its target, the burn-window tick,
    # the events below which a window reads 0, and whether a burning
    # tenant's batch work is shed
    flight_dump_dir: Optional[str] = None
    flight_dump_cap: int = 16
    slo_latency_s: float = 1.0
    slo_target: float = 0.99
    slo_tick_s: float = 10.0
    slo_min_events: int = 64
    slo_shed_batch: bool = True

    # FASTQ / QSEQ input (api/read_datasets.py): the quality encoding of
    # the text (re-based to Sanger on read) and whether reads whose
    # Illumina filter flag failed are dropped
    fastq_base_quality_encoding: BaseQualityEncoding = \
        BaseQualityEncoding.SANGER
    fastq_filter_failed_qc: bool = False
    qseq_base_quality_encoding: BaseQualityEncoding = \
        BaseQualityEncoding.ILLUMINA
    qseq_filter_failed_qc: bool = False

    # the write path (write/, utils/sort.py, parallel/mesh_sort.py): the
    # BGZF deflate level, the deflates in flight (None: the shared decode
    # pool's size, 0: serial in-line), the sidecars written beside the
    # output ("auto" is bai + sbi for a BAM, "none", or a comma list) and
    # the splitting index's records a sample
    write_compress_level: int = 6
    write_parallel_workers: Optional[int] = None
    write_index_kinds: str = "auto"
    splitting_index_granularity: int = 4096

    # the mesh sort's jobs (jobs/journal.py): fsync the journal after
    # every record, and keep the spill runs after a sort for a
    # post-mortem
    journal_fsync: bool = True
    debug_keep_spill: bool = False

    # the cohort plane (cohort/): joined sites a host column chunk, and
    # what a sample input whose bytes fault mid-join does: quarantined
    # (its column -1 / NaN from the fault on; False: raise), with the
    # build refused once more than the fraction of samples quarantined
    cohort_chunk_sites: int = 1024
    cohort_quarantine_inputs: bool = True
    cohort_max_quarantine_fraction: float = 0.5

    # VCF / BCF input (api/dispatch.py, api/vcf_dataset.py): trust a
    # .vcf / .vcf.gz / .bcf extension over the magic bytes, and what a
    # malformed text VCF line does
    vcf_trust_exts: bool = True
    validation_stringency: ValidationStringency = \
        ValidationStringency.SILENT

    def __post_init__(self):
        for name, default in (
                ("fastq_base_quality_encoding", BaseQualityEncoding.SANGER),
                ("qseq_base_quality_encoding",
                 BaseQualityEncoding.ILLUMINA)):
            object.__setattr__(self, name, BaseQualityEncoding.parse(
                getattr(self, name), default))
        object.__setattr__(self, "validation_stringency",
                           ValidationStringency.parse(
                               self.validation_stringency))
        if self.inflate_backend not in INFLATE_BACKENDS:
            raise PlanError(f"unknown inflate backend "
                            f"{self.inflate_backend!r}; expected one of "
                            f"{INFLATE_BACKENDS}")

    @property
    def host_backend(self) -> str:
        """The host plane of paths that inflate on the host: native
        unless zlib is asked for."""
        return "zlib" if self.inflate_backend == "zlib" else "native"

    def pool_size(self) -> int:
        """Decode threads: decode_pool_workers when set, else 4x CPUs in
        [4, 32] (the reference's sizing: decode threads wait on I/O about
        as often as they inflate)."""
        if self.decode_pool_workers:
            return max(1, int(self.decode_pool_workers))
        return min(32, max(4, (os.cpu_count() or 4) * 4))


DEFAULT_CONFIG = HBamConfig()


def resolve_inflate_backend(config: Optional[HBamConfig]) -> str:
    """The concrete decode plane ("native" | "zlib" | "device") of a
    config.  "auto" is "native" on every device: on an NVIDIA H100 80GB
    HBM3 at 700 W the device plane took more than four times the native
    plane's wall over chip_smoke.py's 2,000,000-read file (PERF.md), and
    ``probe_device_plane``'s one-block timing cannot tell the two planes
    apart, so the device plane runs only when a caller names it."""
    backend = (config if config is not None else DEFAULT_CONFIG
               ).inflate_backend
    return "native" if backend == "auto" else backend


# reference settings that would change the drivers' results (which
# records count, or whether a bad span raises) and that the port does not
# implement, each with the test that its value is the reference's
# default; none is left
UNSUPPORTED: Dict[str, Callable[[object], bool]] = {}

# reference fields the port carries over as they are
CARRIED = tuple(f.name for f in dataclasses.fields(HBamConfig))


def config_from_dict(d: dict) -> HBamConfig:
    """The port's config from a dict of reference config fields: every
    field of ``HBamConfig`` carries over as it is (every decode plane
    name, "auto" and "device" included; a quality encoding of the
    reference's enum becomes the port's member of the same name).
    Raises PlanError naming the field when the dict sets one of
    ``UNSUPPORTED`` to anything but its default: the drivers would
    otherwise return what the reference would not, with no sign that a
    setting was lost."""
    for name, is_default in UNSUPPORTED.items():
        if name in d and not is_default(d[name]):
            raise PlanError(f"reference setting {name}={d[name]!r} is not "
                            f"implemented by the port; leave it at its "
                            f"default")
    return HBamConfig(**{k: d[k] for k in CARRIED if k in d})


def geometry_from_dict(d: dict):
    """A ``PayloadGeometry`` (dict has ``max_len``) or a
    ``DecodeGeometry`` (dict has ``bytes_cap``) from the reference's
    fields."""
    from hadoop_bam_torch.parallel.pipeline import (
        DecodeGeometry, PayloadGeometry,
    )
    for cls in (PayloadGeometry, DecodeGeometry):
        names = {f.name for f in dataclasses.fields(cls)}
        if names <= set(d):
            return cls(**{k: d[k] for k in names})
    raise PlanError(f"not a geometry: keys {sorted(d)}")
