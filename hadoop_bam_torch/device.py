"""Device resolution and the data axis (counterpart of
hadoop_bam_tpu/parallel/mesh.py).

The reference shards span batches over a mesh axis named ``data`` and
finishes every reduction with a ``psum`` over it.  Here the axis is a
list of torch devices — one H100 in this slice, so n_dev = 1 — and the
psum is a plain add of the per-device partial results.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` unless the caller names a device.  Raises RuntimeError
    when CUDA is asked for (explicitly or by default) and absent: the
    port never moves to the CPU on its own."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The ``data`` axis: the devices a span batch is spread over."""
    devices: Tuple[torch.device, ...]

    @property
    def n_dev(self) -> int:
        return len(self.devices)

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The psum: per-device partials added on the first device."""
        out = parts[0]
        for p in parts[1:]:
            out = out + p.to(self.devices[0])
        return out


def data_axis(device=None) -> DataAxis:
    return DataAxis((resolve_device(device),))
