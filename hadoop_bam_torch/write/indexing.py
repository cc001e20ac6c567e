"""Index sidecars built during the write, not after it (trimmed copy of
hadoop_bam_tpu/write/indexing.py: the BAM sink; the BCF sink waits for
the port's BCF writer).

The sink observes one ``(refid, pos, end, position token)`` row per
record as the writer emits it and, at finalize, once the
``ParallelBGZFWriter`` knows every block's compressed offset, resolves
the tokens to virtual offsets and renders:

- ``.bai``            the genomic binning index (``split/bai.py``);
- ``.sbi`` / ``.splitting-bai``   the record-boundary splitting index,

so a file from the write path can be region-queried and planned with no
rescan (hb/SplittingBAMIndexer.java rode the output writer for the same
reason).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from hadoop_bam_torch.utils.errors import PlanError

BAM_INDEX_KINDS = ("bai", "sbi", "splitting-bai")
BCF_INDEX_KINDS = ("tbi",)


def resolve_index_kinds(config, container: str) -> Tuple[str, ...]:
    """``config.write_index_kinds`` -> the sidecar kinds of one container:
    "auto" picks what the query engine needs cold (BAM: bai + sbi, BCF:
    tbi); "none" none; otherwise a comma list checked against the
    container's kinds (PlanError naming the bad ones)."""
    raw = getattr(config, "write_index_kinds", "auto") or "auto"
    legal = BAM_INDEX_KINDS if container == "bam" else BCF_INDEX_KINDS
    if raw == "none":
        return ()
    if raw == "auto":
        return ("bai", "sbi") if container == "bam" else ("tbi",)
    kinds = tuple(k.strip() for k in str(raw).split(",") if k.strip())
    bad = [k for k in kinds if k not in legal]
    if bad:
        raise PlanError(
            f"write_index_kinds {bad} unsupported for {container} "
            f"output; legal kinds: {legal} (or 'auto'/'none')")
    return kinds


class BamIndexingSink:
    """Per-record (refid, beg0, end0, payload token) columns of a BAM
    write; ``finalize`` maps the tokens to virtual offsets through the
    writer's resolver and renders the sidecars."""

    def __init__(self, n_ref: int, kinds: Sequence[str],
                 granularity: int = 4096):
        self.kinds = tuple(kinds)
        self._n_ref = n_ref
        self._granularity = max(1, int(granularity))
        self._refid: List[np.ndarray] = []
        self._beg: List[np.ndarray] = []
        self._end: List[np.ndarray] = []
        self._tokens: List[np.ndarray] = []
        self.records = 0

    def observe(self, refid, beg0, end0, tokens) -> None:
        """One batch of records, in file order."""
        self._refid.append(np.asarray(refid, np.int64))
        self._beg.append(np.asarray(beg0, np.int64))
        self._end.append(np.asarray(end0, np.int64))
        self._tokens.append(np.asarray(tokens, np.int64))
        self.records += int(self._tokens[-1].size)

    def _concat(self):
        def cat(xs):
            return np.concatenate(xs) if xs else np.zeros(0, np.int64)
        return (cat(self._refid), cat(self._beg), cat(self._end),
                cat(self._tokens))

    def finalize(self, resolve: Callable[[np.ndarray], np.ndarray],
                 end_voffset: int, file_size: int) -> Dict[str, bytes]:
        """{sidecar suffix: bytes} for every configured kind.  ``resolve``
        maps payload tokens to voffsets
        (``ParallelBGZFWriter.resolve_voffsets``); ``end_voffset`` closes
        the last BAI chunk."""
        from hadoop_bam_torch.split.bai import BAI_SUFFIX, bai_from_columns
        from hadoop_bam_torch.split.splitting_index import (
            SBI_SUFFIX, SPLITTING_BAI_SUFFIX, SplittingIndex,
        )

        refid, beg, end, tokens = self._concat()
        voffs = resolve(tokens).astype(np.uint64)
        out: Dict[str, bytes] = {}
        if "bai" in self.kinds:
            idx = bai_from_columns(self._n_ref, refid, beg, end, voffs,
                                   int(end_voffset))
            out[BAI_SUFFIX] = idx.to_bytes()
        if "sbi" in self.kinds or "splitting-bai" in self.kinds:
            g = self._granularity
            sampled = [int(v) for v in voffs[::g]] + [file_size << 16]
            idx = SplittingIndex(voffsets=sampled, granularity=g,
                                 total_records=self.records)
            if "sbi" in self.kinds:
                out[SBI_SUFFIX] = idx.to_sbi_bytes(file_size)
            if "splitting-bai" in self.kinds:
                out[SPLITTING_BAI_SUFFIX] = idx.to_splitting_bai_bytes()
        return out
