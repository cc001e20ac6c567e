"""Run configuration of the port: only the fields the slice reads.

``config_from_dict`` and ``geometry_from_dict`` take ``dataclasses.asdict``
of the reference's ``HBamConfig`` / ``PayloadGeometry`` /
``DecodeGeometry`` (keys the slice does not read are ignored), so a test
can run both packages on the same settings.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

from hadoop_bam_torch.ops.inflate import check_backend
from hadoop_bam_torch.utils.errors import PlanError


@dataclasses.dataclass(frozen=True)
class HBamConfig:
    check_crc: bool = False               # verify BGZF CRC32 footers
    inflate_backend: str = "native"       # host decode plane: native | zlib
    decode_pool_workers: Optional[int] = None  # span decode threads

    def __post_init__(self):
        check_backend(self.inflate_backend)

    def pool_size(self) -> int:
        """Decode threads: decode_pool_workers when set, else 4x CPUs in
        [4, 32] (the reference's sizing: decode threads wait on I/O about
        as often as they inflate)."""
        if self.decode_pool_workers:
            return max(1, int(self.decode_pool_workers))
        return min(32, max(4, (os.cpu_count() or 4) * 4))


DEFAULT_CONFIG = HBamConfig()


def config_from_dict(d: dict) -> HBamConfig:
    """The port's config from a dict of reference config fields.  The
    reference's ``inflate_backend="auto"`` resolves to a host plane there
    when the native library builds, so it maps to ``"native"``; its
    ``"device"`` plane is not in this slice and raises PlanError."""
    backend = d.get("inflate_backend", DEFAULT_CONFIG.inflate_backend)
    if backend == "auto":
        backend = "native"
    return HBamConfig(
        check_crc=bool(d.get("check_crc", DEFAULT_CONFIG.check_crc)),
        inflate_backend=backend,
        decode_pool_workers=d.get("decode_pool_workers"))


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
