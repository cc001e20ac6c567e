"""Per-read stats over packed sequence/quality payload tiles.

Counterpart of hadoop_bam_tpu/ops/seq_pallas.py.  The host packs each
read's 4-bit bases (2 per byte, the FIRST base in the HIGH nibble) and
quality bytes into fixed-stride tiles; ``seq_qual_stats`` reduces them to
per-read GC fraction, per-read mean quality and one 16-bin base-code
histogram.  On CUDA tensors it launches the K2 kernel
(``csrc/seq_stats.cu``); on CPU tensors it runs ``seq_qual_stats_plain``,
the plain PyTorch version modelled on the reference's ``_seq_stats_jnp``.

Codes [SPEC]: 0='=', 1=A, 2=C, 4=G, 8=T, 15=N; GC counts C, G and S (6).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hadoop_bam_torch.ops import kernels

N_CODES = 16

_GC_CODES = (2, 4, 6)


def _is_gc(c: torch.Tensor) -> torch.Tensor:
    m = c == _GC_CODES[0]
    for code in _GC_CODES[1:]:
        m = m | (c == code)
    return m


def _check_args(seq: torch.Tensor, qual: torch.Tensor,
                lengths: torch.Tensor) -> None:
    for name, t in (("seq", seq), ("qual", qual)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name} must be uint8 [N, W], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise ValueError(f"lengths must be int32 [N], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if not seq.shape[0] == qual.shape[0] == lengths.shape[0]:
        raise ValueError(f"row counts differ: {seq.shape[0]}, "
                         f"{qual.shape[0]}, {lengths.shape[0]}")
    if not seq.device == qual.device == lengths.device:
        raise ValueError("seq, qual and lengths must share a device")
    if not (seq.is_contiguous() and qual.is_contiguous()
            and lengths.is_contiguous()):
        raise ValueError("seq, qual and lengths must be contiguous")


def seq_qual_stats_plain(seq: torch.Tensor, qual: torch.Tensor,
                         lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of K2, in row chunks that bound the int64
    temporaries.  Counts are integers divided once in f32 by
    max(len, 1), as the reference's twin does."""
    n, sb = seq.shape
    qb = qual.shape[1]
    dev = seq.device
    gc = torch.empty(n, dtype=torch.float32, device=dev)
    mq = torch.empty(n, dtype=torch.float32, device=dev)
    hist = torch.zeros(N_CODES, dtype=torch.int64, device=dev)
    jidx = torch.arange(sb, device=dev)[None, :]
    qidx = torch.arange(qb, device=dev)[None, :]
    rows = max(1, (1 << 22) // max(sb + qb, 1))
    for r0 in range(0, n, rows):
        s = seq[r0:r0 + rows].to(torch.int64)
        ln = lengths[r0:r0 + rows].to(torch.int64)[:, None]
        hi, lo = s >> 4, s & 0xF
        hv, lv = 2 * jidx < ln, 2 * jidx + 1 < ln
        gcn = (_is_gc(hi) & hv).sum(1) + (_is_gc(lo) & lv).sum(1)
        qs = (qual[r0:r0 + rows].to(torch.int64) * (qidx < ln)).sum(1)
        denom = ln[:, 0].clamp(min=1).to(torch.float32)
        gc[r0:r0 + rows] = gcn.to(torch.float32) / denom
        mq[r0:r0 + rows] = qs.to(torch.float32) / denom
        hist += torch.bincount(hi[hv], minlength=N_CODES)
        hist += torch.bincount(lo[lv], minlength=N_CODES)
    return {"gc": gc, "mean_qual": mq, "base_hist": hist.to(torch.int32)}


def seq_qual_stats(seq: torch.Tensor, qual: torch.Tensor,
                   lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fused per-read stats over packed payload tiles.

    seq: [N, SB] uint8, 2 bases/byte; qual: [N, QB] uint8; lengths: [N]
    int32 (0 for padding rows, which contribute nothing).  N needs no
    padding to any multiple.  Returns {"gc": [N] f32, "mean_qual": [N]
    f32, "base_hist": [16] int32}.  CUDA tensors launch K2 on the current
    stream (no synchronisation); ``seq_qual_stats.launches`` counts the
    launches.  CPU tensors take ``seq_qual_stats_plain``."""
    _check_args(seq, qual, lengths)
    if seq.device.type == "cpu":
        return seq_qual_stats_plain(seq, qual, lengths)
    if seq.device.type != "cuda":
        raise ValueError(f"unsupported device {seq.device}")
    n, sb = seq.shape
    qb = qual.shape[1]
    dev = seq.device
    gc = torch.empty(n, dtype=torch.float32, device=dev)
    mq = torch.empty(n, dtype=torch.float32, device=dev)
    hist = torch.zeros(N_CODES, dtype=torch.int32, device=dev)
    if n:
        fn = kernels.kernel("seq_stats")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        with torch.cuda.device(dev):
            rc = fn(seq.data_ptr(), sb, qual.data_ptr(), qb,
                    lengths.data_ptr(), n, gc.data_ptr(), mq.data_ptr(),
                    hist.data_ptr(), 8 * sms,
                    torch.cuda.current_stream(dev).cuda_stream)
        kernels.check_launch("seq_qual_stats", rc)
        seq_qual_stats.launches += 1
    return {"gc": gc, "mean_qual": mq, "base_hist": hist}


seq_qual_stats.launches = 0


def unpack_bases(seq_tile: torch.Tensor, max_len: Optional[int] = None
                 ) -> torch.Tensor:
    """[N, SB] packed nibbles -> [N, 2*SB] base codes (uint8), high nibble
    first [SPEC]."""
    codes = torch.stack([seq_tile >> 4, seq_tile & 0xF], dim=-1)
    codes = codes.reshape(seq_tile.shape[0], -1)
    return codes if max_len is None else codes[:, :max_len]


def seq_qual_stats_host(seq_tile: np.ndarray, qual_tile: np.ndarray,
                        lengths: np.ndarray) -> Dict[str, np.ndarray]:
    """NumPy oracle, one read at a time (tests)."""
    n = seq_tile.shape[0]
    gc = np.zeros(n, dtype=np.float32)
    mq = np.zeros(n, dtype=np.float32)
    hist = np.zeros(N_CODES, dtype=np.int64)
    for i in range(n):
        ln = int(lengths[i])
        packed = seq_tile[i]
        codes = np.empty(packed.size * 2, dtype=np.uint8)
        codes[0::2] = packed >> 4
        codes[1::2] = packed & 0xF
        codes = codes[:max(ln, 0)]
        denom = max(ln, 1)
        gc[i] = float(np.isin(codes, _GC_CODES).sum()) / denom
        mq[i] = float(qual_tile[i, :max(ln, 0)].astype(np.float64).sum()) \
            / denom
        hist += np.bincount(codes, minlength=N_CODES)
    return {"gc": gc, "mean_qual": mq, "base_hist": hist}
