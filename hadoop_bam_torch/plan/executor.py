"""Plane selection (trimmed copy of hadoop_bam_tpu/plan/executor.py).

``select_plane`` is the one predicate table that decides which decode
plane a driver call runs on and why every other plane was rejected:
the device gates of the reference (:176-194) -- the plane was named,
no interval filter, no ``skip_bad_spans``, and the device fault
domain's breaker lets the run through.  No IR and no fused-mode gate:
both of the port's drivers have a device plane, and fused streaming is
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from hadoop_bam_torch.config import (
    DEFAULT_CONFIG, HBamConfig, resolve_inflate_backend,
)


@dataclasses.dataclass(frozen=True)
class PlaneDecision:
    """One driver call's routing: the selected plane, the backend the
    host span decoders take, and why each rejected plane failed."""
    plane: str            # "device" | "native" | "zlib"
    backend: str          # resolve_inflate_backend(config)
    host_backend: str     # what host span decoders pass as backend
    rejected: Tuple[Tuple[str, str], ...]   # (plane, reason)


def select_plane(config: Optional[HBamConfig], *, intervals=None,
                 ladder=None) -> PlaneDecision:
    """THE plane-selection table.  ``intervals`` is the parsed interval
    filter (None: no filtering).  ``ladder`` is the file's
    ``DemotionLadder`` when adaptive planes are on; its device breaker
    is consulted LAST, only when every other device gate passed, since
    ``allow_plane`` uses up a half-open probe slot."""
    cfg = config if config is not None else DEFAULT_CONFIG
    backend = resolve_inflate_backend(cfg)
    host_backend = "zlib" if backend == "zlib" else "native"
    rejected = []
    plane = None
    if backend != "device":
        rejected.append(
            ("device", f"inflate_backend resolved to {backend!r}"))
    elif intervals is not None:
        rejected.append(
            ("device", "interval filtering needs whole-span offsets "
                       "on the host"))
    elif cfg.skip_bad_spans:
        rejected.append(
            ("device", "skip_bad_spans needs span-granular quarantine"))
    elif ladder is not None and not ladder.allow_plane("device"):
        rejected.append(
            ("device", "device fault-domain breaker is OPEN"))
    else:
        plane = "device"
    if plane is None:
        if backend == "zlib":
            rejected.append(
                ("native", "inflate_backend='zlib' pins the portable "
                           "plane"))
        plane = host_backend
    return PlaneDecision(plane=plane, backend=backend,
                         host_backend=host_backend,
                         rejected=tuple(rejected))
