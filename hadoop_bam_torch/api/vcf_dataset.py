"""Variant datasets: one VCF or BCF file in any container, its header,
spans, records and device feeds (counterpart of
hadoop_bam_tpu/api/vcf_dataset.py; hb/VCFInputFormat.java,
hb/VCFRecordReader.java and hb/BCFRecordReader.java).

    ds = open_vcf("calls.bcf")                 # cuda:0
    ds = open_vcf("calls.vcf.gz", device="cpu")
    for rec in ds.records(): ...               # VcfRecord
    ds.variant_stats()                         # counts, mean AF, call rates
    for b in ds.tensor_batches(): ...          # torch tensors on the device

``open_vcf`` resolves the container (text VCF, BGZF VCF, plain-gzip VCF,
BGZF or raw BCF: api/dispatch.py), reads the header once, plans spans
and yields records, ``VariantBatch``es or tensor batches per span.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Union

from hadoop_bam_torch.api.dispatch import VCFContainer, sniff_vcf_container
from hadoop_bam_torch.config import (
    DEFAULT_CONFIG, HBamConfig, ValidationStringency,
)
from hadoop_bam_torch.device import resolve_device
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.formats.bcfio import read_bcf_header
from hadoop_bam_torch.formats.vcf import (
    VariantBatch, VCFHeader, VcfRecord, read_vcf_header_text,
)
from hadoop_bam_torch.split.planners import plan_text_spans, read_text_span
from hadoop_bam_torch.split.spans import FileByteSpan, FileVirtualSpan
from hadoop_bam_torch.split.vcf_planners import (
    plan_bcf_spans, plan_bgzf_text_spans, read_bcf_span, read_bgzf_text_span,
)
from hadoop_bam_torch.utils.errors import PlanError
from hadoop_bam_torch.utils.seekable import as_byte_source

Span = Union[FileByteSpan, FileVirtualSpan]


class VcfDataset:
    """Record-aligned access to one VCF/BCF file, and the device its
    reductions run on."""

    def __init__(self, path: str, device=None,
                 config: HBamConfig = DEFAULT_CONFIG,
                 container: Optional[VCFContainer] = None):
        self.path = path
        self.device = resolve_device(device)
        self.config = config
        self.container = container or sniff_vcf_container(path, config)
        self._is_bgzf_bcf = False
        self.header = self._read_header()
        self._plan: Optional[List[Span]] = None
        self._plan_num_spans: Optional[int] = None
        self._next_span = 0

    # -- header (hb/util/VCFHeaderReader.java) -------------------------------
    def _read_header(self) -> VCFHeader:
        src = as_byte_source(self.path)
        try:
            if self.container is VCFContainer.VCF:
                header, _ = read_vcf_header_text(src.pread)
                return header
            if self.container is VCFContainer.VCF_BGZF:
                r = bgzf.BGZFReader(src)

                def read_chunk(off: int, size: int) -> bytes:
                    r.seek_voffset(0)
                    r.read(off)  # positions are tiny (header-sized)
                    return r.read(size)
                header, _ = read_vcf_header_text(read_chunk)
                return header
            if self.container is VCFContainer.VCF_GZIP:
                import gzip
                text = gzip.decompress(src.pread(0, src.size))

                def read_chunk(off: int, size: int) -> bytes:
                    return text[off:off + size]
                header, _ = read_vcf_header_text(read_chunk)
                return header
            header, _, self._is_bgzf_bcf = read_bcf_header(src)
            return header
        finally:
            src.close()

    # -- planning (hb/VCFInputFormat.getSplits) ------------------------------
    def spans(self, num_spans: Optional[int] = None) -> List[Span]:
        """The dataset's spans, planned once; another ``num_spans``
        raises ValueError (open a new dataset to re-plan)."""
        if self._plan is not None and num_spans is not None \
                and num_spans != self._plan_num_spans:
            raise ValueError(
                f"span plan already built with num_spans="
                f"{self._plan_num_spans}; open a new dataset to re-plan")
        if self._plan is None:
            self._plan_num_spans = num_spans
            if self.container is VCFContainer.VCF:
                self._plan = plan_text_spans(
                    self.path, num_spans=num_spans,
                    span_bytes=None if num_spans else self.config.split_size)
            elif self.container is VCFContainer.VCF_BGZF:
                self._plan = plan_bgzf_text_spans(
                    self.path, num_spans=num_spans, config=self.config)
            elif self.container is VCFContainer.VCF_GZIP:
                # plain gzip cannot be split: one whole-file span
                src = as_byte_source(self.path)
                try:
                    self._plan = [FileByteSpan(self.path, 0, src.size)]
                finally:
                    src.close()
            else:
                self._plan = plan_bcf_spans(
                    self.path, num_spans=num_spans, config=self.config,
                    header=self.header)
        return self._plan

    def read_span_text(self, span: Span) -> Optional[bytes]:
        """A span's text lines (None for BCF): the input of the text
        tokenizer (parallel/variant_pipeline.pack_variant_tiles_from_text)."""
        if self.container is VCFContainer.BCF:
            return None
        if self.container is VCFContainer.VCF_BGZF:
            return read_bgzf_text_span(self.path, span)
        if self.container is VCFContainer.VCF_GZIP:
            import gzip
            with open(self.path, "rb") as f:
                return gzip.decompress(f.read())
        return read_text_span(self.path, span)

    # -- span read (hb/VCFRecordReader / hb/BCFRecordReader) -----------------
    def read_span(self, span: Span) -> List[VcfRecord]:
        if self.container is VCFContainer.BCF:
            return read_bcf_span(self.path, span, header=self.header,
                                 is_bgzf=self._is_bgzf_bcf)
        text = self.read_span_text(span)
        out: List[VcfRecord] = []
        for line in text.decode().splitlines():
            if not line or line.startswith("#"):
                continue
            try:
                out.append(VcfRecord.from_line(line))
            except Exception:
                if (self.config.validation_stringency
                        is ValidationStringency.STRICT):
                    raise
        return out

    def records(self, num_spans: Optional[int] = None) -> Iterator[VcfRecord]:
        for recs in self._iter_spans(num_spans):
            yield from recs

    def batches(self, num_spans: Optional[int] = None
                ) -> Iterator[VariantBatch]:
        for recs in self._iter_spans(num_spans):
            yield VariantBatch(recs, self.header)

    def _iter_spans(self, num_spans: Optional[int]) -> Iterator[List]:
        """Each span's records in turn, resumable (the state is the spans
        delivered): a call after the plan is exhausted starts over."""
        plan = self.spans(num_spans)
        if self._next_span >= len(plan):
            self._next_span = 0
        while self._next_span < len(plan):
            recs = self.read_span(plan[self._next_span])
            self._next_span += 1
            yield recs

    def tensor_batches(self, geometry=None, num_spans: Optional[int] = None
                       ) -> Iterator[Dict]:
        """Variant batches on the dataset's device, n_dev = 1: ``chrom``
        and ``pos`` int32 [1, rows], ``flags`` uint8 [1, rows] (bit 0
        PASS, bit 1 SNP), ``dosage`` int8 [1, rows, samples_pad] (ALT
        dosage, -1 missing) and ``n_records`` int32 [1].  Every batch has
        ``rows = geometry.tile_records``; rows past ``n_records`` hold
        the pads (dosage -1, the other columns 0).  Each batch's tensors
        are the consumer's own.  BCF spans take the columnar decode
        (``bcf_span_stat_columns``), text spans the record parse."""
        from hadoop_bam_torch.parallel.pipeline import (
            _batch_emit, _decode_pool, iter_windowed,
        )
        from hadoop_bam_torch.parallel.variant_pipeline import (
            VariantGeometry, bcf_span_stat_columns, pack_variant_tiles,
            variant_feed,
        )

        if geometry is None:
            geometry = VariantGeometry(n_samples=self.header.n_samples)
        spans = self.spans(num_spans)

        def decode(span):
            if self.container is VCFContainer.BCF:
                return bcf_span_stat_columns(
                    self.path, span, self.header, geometry,
                    self._is_bgzf_bcf)
            return pack_variant_tiles(
                VariantBatch(self.read_span(span), self.header), geometry)

        with _decode_pool(self.config) as pool:
            stream = iter_windowed(pool, spans, decode,
                                   2 * self.config.pool_size(),
                                   config=self.config)
            try:
                keys, fp, tuples = variant_feed(
                    stream, 1, geometry.tile_records, fixed_shape=True,
                    pin_memory=self.device.type == "cuda")
                if fp is None:
                    return
                yield from fp.stream(tuples, _batch_emit(self.device, keys))
            finally:
                stream.close()

    def variant_stats(self) -> Dict:
        """Variant / SNP / PASS counts, mean ALT allele frequency and
        per-sample call rates on the dataset's device
        (``parallel/variant_pipeline.variant_stats_file``)."""
        from hadoop_bam_torch.parallel.variant_pipeline import (
            variant_stats_file,
        )
        return variant_stats_file(self.path, device=self.device,
                                  config=self.config, header=self.header)

    def query(self, region: str) -> Iterator[VcfRecord]:
        """The records of a BGZF VCF overlapping a samtools-style region
        (``chr``, ``chr:start-end``), reading only the chunks of its
        ``.tbi`` sidecar (``split.tabix.write_tabix`` builds one).  Other
        containers raise PlanError (a BCF region goes through
        ``query.QueryEngine``); a missing sidecar FileNotFoundError."""
        from hadoop_bam_torch.split.intervals import parse_interval
        from hadoop_bam_torch.split.tabix import TBI_SUFFIX, load_tabix_for

        if self.container is not VCFContainer.VCF_BGZF:
            raise PlanError("query() needs a BGZF-compressed VCF "
                            "(.vcf.gz); plain text or gzip cannot be "
                            "random-accessed")
        idx = load_tabix_for(self.path)
        if idx is None:
            raise FileNotFoundError(
                f"{self.path}{TBI_SUFFIX} not found; build it with "
                "split.tabix.write_tabix")
        iv = parse_interval(region)
        ranges = idx.query(iv.rname, iv.start - 1, iv.end)
        src = as_byte_source(self.path)
        try:
            r = bgzf.BGZFReader(src)
            for v0, v1 in ranges:
                r.seek_voffset(v0)
                text = r.read_to_voffset(v1)
                for line in text.split(b"\n"):
                    if not line or line[:1] == b"#":
                        continue
                    try:
                        rec = VcfRecord.from_line(line.decode())
                    except Exception:
                        if (self.config.validation_stringency
                                is ValidationStringency.STRICT):
                            raise
                        continue
                    if rec.chrom != iv.rname:
                        continue
                    if rec.pos <= iv.end and \
                            rec.pos + rec.rlen - 1 >= iv.start:
                        yield rec
        finally:
            src.close()

    # -- checkpoint / resume -------------------------------------------------
    def state_dict(self) -> Dict:
        return {
            "path": self.path,
            "container": self.container.value,
            "plan": [s.to_dict() for s in (self._plan or [])],
            "next_span": self._next_span,
        }

    def load_state_dict(self, state: Dict) -> None:
        if state["path"] != self.path:
            raise ValueError(f"state of {state['path']!r}, not of "
                             f"{self.path!r}")
        cls = (FileVirtualSpan if self.container is VCFContainer.BCF
               else FileByteSpan)
        self._plan = [cls.from_dict(d) for d in state["plan"]] or None
        self._next_span = int(state["next_span"])


def open_vcf(path: str, device=None,
             config: HBamConfig = DEFAULT_CONFIG) -> VcfDataset:
    """Open a VCF or BCF (any container) for device reductions on
    ``cuda:0`` (or ``device``)."""
    return VcfDataset(path, device=device, config=config)
