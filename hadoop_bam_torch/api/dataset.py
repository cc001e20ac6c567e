"""Datasets: the user surface over one BAM (counterpart of
hadoop_bam_tpu/api/dataset.py, slice 1: ``flagstat`` and ``seq_stats``).

    ds = open_bam("sample.bam")          # cuda:0
    ds = open_bam("sample.bam", device="cpu")
    ds.flagstat()
    ds.seq_stats()

    ds = open_bam("sample.bam", config=HBamConfig(
        bam_intervals="chr20:1-1000000", skip_bad_spans=True))
    q = QuarantineManifest()
    ds.flagstat(quarantine=q)            # q lists the spans skipped
    ds.spans(num_spans=8)                # the dataset's span plan
    for b in ds.tensor_batches(): ...    # payload tiles on the device
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.device import resolve_device
from hadoop_bam_torch.formats.bamio import read_bam_header


class BamDataset:
    """One BAM file, its header, and the device its reductions run on."""

    def __init__(self, path: str, device=None,
                 config: HBamConfig = DEFAULT_CONFIG):
        self.path = path
        self.device = resolve_device(device)
        self.config = config
        self.header, self.first_voffset = read_bam_header(path)
        self._plan: Optional[List] = None
        self._plan_num_spans: Optional[int] = None

    def spans(self, num_spans: Optional[int] = None) -> List:
        """The dataset's record-aligned spans (``FileVirtualSpan``),
        planned once (``split/planners.plan_spans_maybe_intervals``:
        trimmed to a ``.bai``'s chunks under intervals, snapped to a
        splitting index, or guessed).  Asking again with another
        ``num_spans`` raises ValueError: open a new dataset to re-plan."""
        if self._plan is not None and num_spans is not None \
                and num_spans != self._plan_num_spans:
            raise ValueError(
                f"span plan already built with num_spans="
                f"{self._plan_num_spans}; open a new dataset to re-plan")
        if self._plan is None:
            from hadoop_bam_torch.split.planners import (
                plan_spans_maybe_intervals,
            )
            self._plan = list(plan_spans_maybe_intervals(
                self.path, self.header, self.config, num_spans=num_spans))
            self._plan_num_spans = num_spans
        return self._plan

    def flagstat(self, geometry=None, mode: str = "tile",
                 quarantine=None) -> Dict[str, int]:
        """The 16 samtools flagstat counters (parallel/pipeline.flagstat_file);
        spans skipped under ``skip_bad_spans`` go into ``quarantine`` (a
        ``utils.resilient.QuarantineManifest``) and the result."""
        from hadoop_bam_torch.parallel.pipeline import flagstat_file
        return flagstat_file(self.path, device=self.device,
                             config=self.config, geometry=geometry,
                             header=self.header, mode=mode,
                             quarantine=quarantine)

    def seq_stats(self, geometry=None, quarantine=None) -> Dict[str, object]:
        """Mean GC fraction, mean per-read quality and the base-code
        histogram (parallel/pipeline.seq_stats_file, K2 kernel);
        ``quarantine`` as for ``flagstat``."""
        from hadoop_bam_torch.parallel.pipeline import seq_stats_file
        return seq_stats_file(self.path, device=self.device,
                              config=self.config, geometry=geometry,
                              header=self.header, quarantine=quarantine)


    def tensor_batches(self, geometry=None, num_spans: Optional[int] = None
                       ) -> Iterator[Dict]:
        """Payload batches on the dataset's device (the ML feed), n_dev =
        1: ``prefix`` uint8 [1, rows, 36] (the fixed columns; decode with
        ``ops.unpack_bam.unpack_fixed_fields_tile``), ``seq_packed``
        uint8 [1, rows, seq_stride] (4-bit bases, two a byte, the first
        in the high nibble; ``ops.seq_stats.unpack_bases``), ``qual``
        uint8 [1, rows, qual_stride] and ``n_records`` int32 [1].
        ``rows`` is geometry.tile_records except in the final batch,
        which shrinks to the smallest bucket that holds it unless
        ``PayloadGeometry(fixed_shape=True)``.  Each batch's tensors are
        the consumer's own.  The dataset's plan (``spans``) is decoded
        with the drivers' cut of long spans: the same rows in the same
        order."""
        from hadoop_bam_torch.parallel.pipeline import (
            SEQ_STATS_SPAN_BYTES, PayloadGeometry, _batch_emit, _grain_cut,
            data_axis, iter_payload_tile_groups,
        )
        geometry = geometry if geometry is not None else PayloadGeometry()
        spans = _grain_cut(self.path, self.header, self.spans(num_spans),
                           SEQ_STATS_SPAN_BYTES)
        yield from iter_payload_tile_groups(
            self.path, spans, geometry, data_axis(self.device),
            _batch_emit(self.device, ("prefix", "seq_packed", "qual")),
            self.config, header=self.header, balance=False)


def open_bam(path: str, device=None,
             config: HBamConfig = DEFAULT_CONFIG) -> BamDataset:
    """Open a BAM for device reductions on ``cuda:0`` (or ``device``)."""
    return BamDataset(path, device=device, config=config)
