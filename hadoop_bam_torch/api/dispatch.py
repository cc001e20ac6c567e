"""VCF container dispatch: extension and magic-byte sniffing (the VCF
half of hadoop_bam_tpu/api/dispatch.py; hb/VCFFormat.java and the
trust-exts rule of hb/VCFInputFormat.java).

Magics [SPEC]: BCF = "BCF" (optionally inside BGZF); text VCF starts
"##fileformat="; a gzip stream that is not BGZF is a plain-gzip VCF
(readable, not splittable).
"""
from __future__ import annotations

import enum
from typing import Dict, Optional

from hadoop_bam_torch.config import DEFAULT_CONFIG, HBamConfig
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.utils.seekable import as_byte_source


class VCFContainer(enum.Enum):
    VCF = "vcf"       # plain text
    VCF_BGZF = "vcf.gz"
    # plain-gzip (non-BGZF) .vcf.gz: readable but NOT splittable, read as
    # one whole-file span (hb/util/BGZFEnhancedGzipCodec.java)
    VCF_GZIP = "vcf.gz(plain)"
    BCF = "bcf"


# per-path sniff cache, as in hb/VCFInputFormat
_vcf_cache: Dict[str, VCFContainer] = {}


def sniff_vcf_container(path: str, config: HBamConfig = DEFAULT_CONFIG,
                        data: Optional[bytes] = None) -> VCFContainer:
    """VCF / VCF-in-BGZF / plain-gzip VCF / BCF for a path: the
    extension when ``config.vcf_trust_exts`` (a .vcf.gz still checks
    BGZF against plain gzip in its bytes), else the magic bytes."""
    if path in _vcf_cache:
        return _vcf_cache[path]
    lower = path.lower()
    if config.vcf_trust_exts:
        if lower.endswith((".vcf.gz", ".vcf.bgz", ".vcf.bgzf")):
            head = data if data is not None else _read_head(path)
            fmt = VCFContainer.VCF_BGZF if bgzf.is_bgzf(head) \
                else VCFContainer.VCF_GZIP
        elif lower.endswith(".bcf"):
            fmt = VCFContainer.BCF
        elif lower.endswith(".vcf"):
            fmt = VCFContainer.VCF
        else:
            fmt = _sniff_vcf_data(path, data)
    else:
        fmt = _sniff_vcf_data(path, data)
    _vcf_cache[path] = fmt
    return fmt


def _sniff_vcf_data(path: str, data: Optional[bytes]) -> VCFContainer:
    head = data if data is not None else _read_head(path)
    if head[:3] == b"BCF":
        return VCFContainer.BCF
    if bgzf.is_bgzf(head):
        try:
            payload = bgzf.inflate_block(head)
        except bgzf.BGZFError:
            payload = b""
        if payload[:3] == b"BCF":
            return VCFContainer.BCF
        return VCFContainer.VCF_BGZF
    if head[:2] == b"\x1f\x8b":
        return VCFContainer.VCF_GZIP
    if head[:13] == b"##fileformat=":
        return VCFContainer.VCF
    raise ValueError(f"cannot determine VCF container of {path!r}")


def _read_head(path: str) -> bytes:
    src = as_byte_source(path)
    try:
        return src.pread(0, bgzf.MAX_BLOCK_SIZE)
    finally:
        src.close()


def clear_sniff_caches() -> None:
    _vcf_cache.clear()
