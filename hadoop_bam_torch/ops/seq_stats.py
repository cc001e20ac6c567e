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

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from hadoop_bam_torch.ops import kernels

N_CODES = 16

_GC_CODES = (2, 4, 6)

# Launch geometry of the K2 kernel (csrc/seq_stats.cu).  A tile is R whole
# rows, one warp's work; its seq and qual bytes fill one stage of that
# warp's shared-memory ring.
STAGES = 3                     # ring depth (kStages in the source)
STAGE_BYTES = 4 << 10          # payload bytes a stage aims at
MAX_ROWS = 32                  # rows per tile at most
BLOCK_WARPS = 8                # warps per block at most (kWarps)
BLOCKS_PER_SM = 4              # the persistent grid (kMinBlocksDirect)
ALIGNED_BLOCKS_PER_SM = 2      # with the rings (kMinBlocksAligned)
SMEM_BLOCK_MAX = 232_448       # shared memory one block may use (227 KB)
SMEM_SM = 233_472              # shared memory of one SM (228 KB)
SMEM_RESERVED = 1_024          # the runtime's share per resident block


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


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class K2Launch:
    """One K2 launch: tiles of ``rows`` rows go round robin to the
    ``grid * warps`` warps of a persistent grid; ``aligned`` selects the
    TMA rings (else direct loads).  The sizes of one warp's shared memory
    are decided here and taken as they are by the kernel: aligned, a count
    buffer of ``rows`` rows of ``pitch`` u32 at offset 0, then STAGES
    stages of ``stage_bytes`` from ``stage_off`` on (each a tile's seq
    rows, qual rows and lengths); direct, per-row gc and quality sums."""
    n: int
    aligned: bool
    rows: int
    tiles: int
    grid: int
    warps: int
    pitch: int
    stage_off: int
    stage_bytes: int
    warp_bytes: int

    @property
    def smem(self) -> int:
        """Dynamic shared memory of one block."""
        return self.warps * self.warp_bytes


def _warp_layout(rows: int, sb: int, qb: int, aligned: bool
                 ) -> Tuple[int, int, int, int]:
    """(pitch, stage_off, stage_bytes, warp_bytes) of one warp.  The count
    buffer's row pitch is odd, so the per-row sums are free of bank
    conflicts; stages start on 128 bytes, as the TMA copies want."""
    if not aligned:
        return 0, 0, 0, 2 * 4 * rows
    pitch = (sb // 16 + qb // 16) | 1
    stage_off = _round_up(rows * pitch * 4, 128)
    stage = _round_up(rows * (sb + qb) + _round_up(4 * rows, 16), 128)
    return pitch, stage_off, stage, stage_off + STAGES * stage


def k2_launch(n: int, sb: int, qb: int, ptrs: Tuple[int, int, int],
              sms: int) -> K2Launch:
    """The arithmetic of a K2 launch over n rows of sb + qb bytes, with the
    seq, qual and lengths base addresses ``ptrs`` on a card of ``sms``
    SMs.  The aligned path needs 16-byte strides and base addresses and a
    warp's ring to fit one block's shared memory."""
    rows = max(1, min(MAX_ROWS, STAGE_BYTES // max(sb + qb, 1)))
    if rows >= 4:
        rows -= rows % 4    # whole 16-byte runs of lengths per tile
    aligned = (sb > 0 and qb > 0 and sb % 16 == 0 and qb % 16 == 0
               and all(p % 16 == 0 for p in ptrs))
    warps = BLOCK_WARPS
    if aligned:
        warps = min(BLOCK_WARPS,
                    SMEM_BLOCK_MAX // _warp_layout(rows, sb, qb, True)[3])
        aligned = warps > 0
        warps = warps or BLOCK_WARPS
    layout = _warp_layout(rows, sb, qb, aligned)
    smem = warps * layout[3]
    per_sm = max(1, min(ALIGNED_BLOCKS_PER_SM if aligned else BLOCKS_PER_SM,
                        SMEM_SM // (smem + SMEM_RESERVED)))
    tiles = -(-n // rows)
    return K2Launch(n, aligned, rows, tiles,
                    max(1, min(-(-tiles // warps), per_sm * sms)), warps,
                    *layout)


_scratch: Dict[tuple, torch.Tensor] = {}


def _k2_scratch(dev: torch.device, stream: int) -> torch.Tensor:
    """K2's running per-bin (arrivals, count) pairs for launches on one
    stream: zeroed once; each bin's last arrival in a launch zeroes it."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros(N_CODES, dtype=torch.int64,
                                          device=dev)
    return buf


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
    if not n:
        return {"gc": gc, "mean_qual": mq,
                "base_hist": torch.zeros(N_CODES, dtype=torch.int32,
                                         device=dev)}
    hist = torch.empty(N_CODES, dtype=torch.int32, device=dev)
    fn = kernels.kernel("seq_stats")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    go = k2_launch(n, sb, qb, (seq.data_ptr(), qual.data_ptr(),
                               lengths.data_ptr()), sms)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(seq.data_ptr(), sb, qual.data_ptr(), qb, lengths.data_ptr(),
                n, gc.data_ptr(), mq.data_ptr(), hist.data_ptr(),
                _k2_scratch(dev, stream).data_ptr(), go.rows, go.grid,
                go.warps, int(go.aligned), go.pitch, go.stage_off,
                go.stage_bytes, go.warp_bytes, stream)
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
