"""The device decode plane's kernels: LZ77 resolve, record walk and
payload gather on the card (counterpart of
hadoop_bam_tpu/ops/inflate_device.py).

Inflating a BGZF block splits into two halves.  The Huffman decode is
bit-serial and stays on the host: ``utils/native.deflate_tokenize_batch``
turns each block into fixed-width u32 LZ77 tokens (bit 31 set: a copy,
length in bits 16-24, distance - 1 in bits 0-15; clear: a literal byte).
Everything after that runs here, on one chunk of at most 64 blocks:

- ``resolve_pack`` (K7+K8, ``csrc/lz77_resolve.cu``): tokens -> each
  block's bytes by pointer doubling, packed into one contiguous buffer;
- ``walk_records_device`` (K9, ``csrc/record_walk.cu``): the BAM record
  chain over that buffer by pointer doubling over the positions that can
  start a complete record, tile by tile;
- ``unpack_fixed_fields`` (K1) at the walk's offsets;
- ``payload_gather`` (K10p, ``csrc/payload_gather.cu``): each record's
  packed bases and quals into the fixed-stride tiles K2 reads;
- ``interval_cols`` (K10i, ``csrc/interval_cols.cu``): each record's
  (rid, pos1, end1) interval columns from its own prefix, end1 from its
  own CIGAR, for the serve tiles (no K1 on that chain).
- ``variant_unpack`` (K11, ``csrc/variant_gt.cu``): one span's variant
  tile in one launch, each BCF record's CHROM and POS, its samples' ALT
  dosages from its GT vectors, the tile's pads and the flags, from one
  packed metadata array (``pack_variant_meta``), for the variant plane
  (``parallel/variant_pipeline.py``); ``variant_prefix`` and
  ``gt_dosage`` launch the same kernel for the prefix alone or one
  group.

``resolve_walk_fields``, ``resolve_walk_payload`` and
``resolve_walk_intervals`` chain them, so the inflated bytes never
exist on the host.  Each wrapper launches its kernel
on a CUDA tensor (``<wrapper>.launches`` counts the launches) and runs
its plain PyTorch version, kept beside it, on a CPU tensor.

Shapes: a chunk is [B, P] tokens with P (bytes per block row, == the
token pad) on the ``P_LADDER`` rungs and B a power of two >= 8, so the
record capacity ``records_cap(B, P)`` is fixed per rung.
"""
from __future__ import annotations

import functools
import threading
import time
import zlib
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from hadoop_bam_torch.device import resolve_device
from hadoop_bam_torch.formats import bgzf
from hadoop_bam_torch.ops import kernels
from hadoop_bam_torch.ops.unpack_bam import PREFIX, unpack_fixed_fields
from hadoop_bam_torch.utils import native
from hadoop_bam_torch.utils.errors import PlanError

# BGZF caps a block's inflated size at 64 KiB [SPEC SAMv1 4.1]
BGZF_MAX_ISIZE = 1 << 16

# per-block widths P snaps up to: tiny index/EOF blocks, mid-size text
# blocks, full 64 KiB BAM blocks
P_LADDER = (1 << 10, 1 << 13, 1 << 16)

# BGZF blocks per resolve_pack call of inflate_span_device
SPAN_CHUNK_BLOCKS = 64

# inflated bytes of the synthetic block probe_device_plane times
PROBE_BLOCK_BYTES = 1 << 16

# positions per tile of the record walk (kW in csrc/record_walk.cu)
WALK_W = 1 << 13

# least distance between two records of a chain: a 4-byte block_size
# and a 32-byte core
MIN_RECORD = 36

# K10p's CTA width and CTAs per SM (kThreads and kMinBlocks in
# csrc/payload_gather.cu; its launch bounds hold the kernel to them), and
# the least tile bytes per CTA (8 16-byte words per zero-stream thread)
PAYLOAD_THREADS = 256
PAYLOAD_CTAS_PER_SM = 4
PAYLOAD_CTA_BYTES = 4096

Scalar = Union[int, torch.Tensor]


def round_pow2(x: int, lo: int = 1) -> int:
    n = lo
    while n < x:
        n <<= 1
    return n


def ladder_pow2(x: int) -> int:
    """Snap a per-block byte width up to its ``P_LADDER`` rung."""
    for p in P_LADDER:
        if x <= p:
            return p
    raise bgzf.BGZFError(
        f"block inflated size {x} exceeds the BGZF 64 KiB cap")


def records_cap(B: int, P: int) -> int:
    """Record capacity of a [B, P] chunk's walk: a BAM record is at least
    36 bytes (4-byte block_size + 32-byte core), so B*P//32 rounded up to
    a power of two can never be exceeded by well-formed data; more is
    corruption."""
    return round_pow2(max(16, (B * P) // 32), 16)


class WalkLaunch(NamedTuple):
    """The arithmetic of one K9 launch over an L-byte buffer (see
    ``csrc/record_walk.cu`` for the phases)."""
    L: int
    W: int          # positions per tile
    tiles: int
    rounds: int     # phase B: the least k with 4^k >= tiles
    path_cap: int   # chain nodes one tile can hold
    entries: int    # positions the scratch indexes (W per tile), and
                    # its u8 marks
    words: int      # int32 scratch words, in the kernel's layout


def walk_launch(L: int) -> WalkLaunch:
    """Launch arithmetic of the tiled record walk over an L-byte buffer,
    at the kernel's tile width ``WALK_W``; ``hbam_record_walk`` takes
    these sizes and checks them.  Every jump of phase B leaves its tile
    for a later one, so a path holds at most ``tiles`` candidates there
    and 4^rounds >= tiles radix-4 rounds mark all of them; chain nodes
    are at least MIN_RECORD bytes apart, so a tile holds at most
    (W - 1) // MIN_RECORD + 1 of them.  The int32 scratch is, in order:
    two jump arrays and the live candidates [entries each], per-tile live
    counts, entries, kept counts and kept bases [tiles each], the kept
    positions [tiles * path_cap], the rounds' change flags [rounds + 1]
    and a ticket [1]."""
    if L < 1 or L >= (1 << 31) - WALK_W:
        raise ValueError(f"buffer of {L} bytes: K9 needs 1 <= L < 2^31 - "
                         f"{WALK_W} (int32 positions)")
    W = WALK_W
    tiles = -(-L // W)
    rounds = 0
    while 4 ** rounds < tiles:
        rounds += 1
    path_cap = (W - 1) // MIN_RECORD + 1
    entries = tiles * W
    words = 3 * entries + 4 * tiles + tiles * path_cap + rounds + 2
    return WalkLaunch(L, W, tiles, rounds, path_cap, entries, words)


# K7+K8's widest cluster (CTAs that share one token row; of 2, 4, 8 and
# 16, 4 ran fastest at the main path's chunk, PERF.md), the threads an
# H100 keeps resident at once at the kernel's 64 registers a thread (132
# SMs x 1,024), the tokens each thread takes per pass (kTok in
# csrc/lz77_resolve.cu) and the least segment
RESOLVE_CLUSTER = 4
RESOLVE_WAVE_THREADS = 132 * 1024
RESOLVE_TOKENS_PER_THREAD = 8
RESOLVE_MIN_SEGMENT = 64


class ResolveLaunch(NamedTuple):
    """The arithmetic of one K7+K8 launch over a [B, T] token chunk of
    P-byte rows (see ``csrc/lz77_resolve.cu`` for the phases)."""
    B: int
    T: int
    P: int
    C: int          # CTAs per row: one thread block cluster
    S: int          # positions each CTA owns, a power of two
    threads: int    # per CTA; S / threads positions each (<= 64)
    tokens: int     # the most tokens one CTA's share holds
    window: int     # the row's bytes before the last segment, which its
                    # CTA receives from the earlier ones
    smem: int       # dynamic shared memory: u16 source + u8 byte per
                    # owned position, and the window


def resolve_launch(B: int, T: int, P: int,
                   cluster: Optional[int] = None) -> ResolveLaunch:
    """Launch arithmetic of the clustered LZ77 resolve: row b's positions
    [0, P) are cut into C segments of S bytes (S the least power of two
    >= max(P / cluster, RESOLVE_MIN_SEGMENT), C = ceil(P / S) <= cluster),
    one CTA each; CTA r takes the r-th of C equal shares of the row's
    tokens.  ``cluster`` defaults to RESOLVE_CLUSTER, or 2 where the
    card would not hold the B * C CTAs in one wave (a second wave costs
    more than the narrower cluster's longer segments: the 64-block chunk
    runs fastest at 2, the main path's 32-row chunk at 4; PERF.md).
    ``hbam_lz77_resolve`` takes these sizes and checks them."""
    if B < 1 or T < 1 or not 1 <= P <= BGZF_MAX_ISIZE:
        raise ValueError(f"K7+K8 needs B >= 1, T >= 1 and 1 <= P <= "
                         f"{BGZF_MAX_ISIZE}, got B={B} T={T} P={P}")
    if cluster is None:
        for cluster in (RESOLVE_CLUSTER, 2):
            lr = resolve_launch(B, T, P, cluster)
            if B * lr.C * lr.threads <= RESOLVE_WAVE_THREADS:
                break
        return lr
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"cluster of {cluster} CTAs: K7+K8 takes 1, 2, 4, "
                         f"8 or 16")
    S = round_pow2(max(-(-P // cluster), RESOLVE_MIN_SEGMENT))
    C = -(-P // S)
    threads = min(1024, max(64, S // 16))
    tokens = -(-T // C)
    window = (C - 1) * S
    return ResolveLaunch(B, T, P, C, S, threads, tokens, window,
                         3 * S + window)


class PayloadLaunch(NamedTuple):
    """The grid of one K10p launch (see ``csrc/payload_gather.cu``)."""
    grid: int
    threads: int


def payload_launch(R: int, seq_stride: int, qual_stride: int,
                   sms: int) -> PayloadLaunch:
    """K10p's one persistent wave over [R, seq_stride] and [R, qual_stride]
    tiles on a card of ``sms`` SMs: ``PAYLOAD_CTAS_PER_SM`` CTAs an SM
    (what the kernel's launch bounds keep resident), or one per
    ``PAYLOAD_CTA_BYTES`` of tile where the tiles are smaller, never fewer
    than one.  The kernel reads n_valid on the card, so the grid is sized
    for R rows."""
    per_bytes = -(-R * (seq_stride + qual_stride) // PAYLOAD_CTA_BYTES)
    grid = min(sms * PAYLOAD_CTAS_PER_SM, per_bytes)
    return PayloadLaunch(max(1, grid), PAYLOAD_THREADS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _cuda_or_cpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (take the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _i32_scalar(x: Scalar, dev: torch.device) -> torch.Tensor:
    """A [1] int32 tensor on ``dev`` holding x (a Python int or a tensor
    already there)."""
    if isinstance(x, torch.Tensor):
        if x.device != dev or x.dtype != torch.int32 or x.numel() != 1:
            raise ValueError(f"scalar must be one int32 on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        return x.reshape(1)
    return torch.full((1,), int(x), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# K7+K8: LZ77 resolve + contiguous pack
# ---------------------------------------------------------------------------

def _tokens_i64(tokens: torch.Tensor) -> torch.Tensor:
    if tokens.dtype == torch.uint32:
        return tokens.to(torch.int64)
    return tokens.to(torch.int64) & 0xFFFFFFFF


def resolve_tokens_plain(tokens: torch.Tensor, n_tokens: torch.Tensor,
                         P: int) -> torch.Tensor:
    """Plain version of the resolve: [B, T] tokens + [B] counts -> [B, P]
    u8 block bytes (junk past each block's length).  The reference's
    steps: token lengths, exclusive cumsum, marks at token starts, cumsum
    to a token id per byte, a source pointer per byte, pointer doubling
    to convergence, one gather of the literals."""
    B, T = tokens.shape
    dev = tokens.device
    w = _tokens_i64(tokens)
    is_copy = (w >> 31) == 1
    tok_len = torch.where(is_copy, (w >> 16) & 0x1FF, 1)
    valid = (torch.arange(T, device=dev)[None, :]
             < n_tokens.to(torch.int64)[:, None])
    tok_len = torch.where(valid, tok_len, 0)
    starts = torch.cumsum(tok_len, 1) - tok_len
    # zero-length pads (and starts past P) land in a sacrificial column
    scat = torch.where((tok_len > 0) & valid, starts, P).clamp_(max=P)
    marks = torch.zeros((B, P + 1), dtype=torch.int64, device=dev)
    marks.scatter_add_(1, scat, torch.ones_like(scat))
    tok_of_byte = (torch.cumsum(marks[:, :P], 1) - 1).clamp_(0, T - 1)
    wb = torch.gather(w, 1, tok_of_byte)
    pos = torch.arange(P, device=dev)[None, :]
    copy = (wb >> 31) == 1
    src = torch.where(copy, pos - ((wb & 0xFFFF) + 1), pos).clamp_(0, P - 1)
    lit = torch.where(copy, 0, wb & 0xFF).to(torch.uint8)
    while True:
        s2 = torch.gather(src, 1, src)
        if torch.equal(s2, src):
            break
        src = s2
    return torch.gather(lit, 1, src)


def pack_contiguous_plain(blk_bytes: torch.Tensor, isize: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the pack: [B, P] block bytes + [B] isize -> ([B*P]
    u8 buffer with block b's first clamp(isize, 0, P) bytes at their
    running offset and zeros past the total, total as int32)."""
    B, P = blk_bytes.shape
    dev = blk_bytes.device
    iz = isize.to(torch.int64).clamp(0, P)
    ubase = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                       torch.cumsum(iz, 0)])
    total = ubase[B]
    q = torch.arange(B * P, device=dev)
    blk = torch.searchsorted(ubase[1:].contiguous(), q,
                             right=True).clamp_(max=B - 1)
    off = (q - ubase[blk]).clamp_(0, P - 1)
    out = blk_bytes.reshape(-1)[blk * P + off]
    out = torch.where(q < total, out, torch.zeros_like(out))
    return out, total.to(torch.int32)


def _check_resolve_args(tokens, n_tokens, isize) -> None:
    if tokens.dtype not in (torch.uint32, torch.int32) or tokens.dim() != 2:
        raise ValueError(f"tokens must be uint32 [B, T], got {tokens.dtype} "
                         f"{tuple(tokens.shape)}")
    B = tokens.shape[0]
    for name, t in (("n_tokens", n_tokens), ("isize", isize)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be int32 [{B}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != tokens.device:
            raise ValueError(f"{name} on {t.device}, tokens on "
                             f"{tokens.device}")
    if tokens.shape[1] < 1 or B < 1:
        raise ValueError(f"empty token chunk {tuple(tokens.shape)}")
    if not (tokens.is_contiguous() and n_tokens.is_contiguous()
            and isize.is_contiguous()):
        raise ValueError("tokens, n_tokens and isize must be contiguous")


def resolve_pack(tokens: torch.Tensor, n_tokens: torch.Tensor,
                 isize: torch.Tensor, P: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve a token chunk and pack it contiguous: [B, T] tokens (u32,
    or their bits as int32),
    [B] i32 counts and [B] i32 ISIZEs -> ([B*P] u8 buffer, int32 total),
    zeros past the total.  P (bytes per row) defaults to T.

    CUDA tensors launch the K7+K8 kernel on the current stream (no
    synchronisation); CPU tensors take the plain versions."""
    _check_resolve_args(tokens, n_tokens, isize)
    B, T = tokens.shape
    P = T if P is None else int(P)
    if not _cuda_or_cpu(tokens):
        return pack_contiguous_plain(
            resolve_tokens_plain(tokens, n_tokens, P), isize)
    if not 1 <= P <= BGZF_MAX_ISIZE:
        raise ValueError(f"P = {P} outside [1, {BGZF_MAX_ISIZE}]")
    out = launch_resolve(tokens, n_tokens, isize, resolve_launch(B, T, P))
    resolve_pack.launches += 1
    return out


resolve_pack.launches = 0


def launch_resolve(tokens: torch.Tensor, n_tokens: torch.Tensor,
                   isize: torch.Tensor, lr: ResolveLaunch,
                   clocks: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K7+K8 launch with the given arithmetic (``resolve_pack``'s,
    or another cluster width when variants are timed); counts nothing.
    ``clocks`` (int64 [B * C, 9], or None) receives each CTA's clock64()
    at its phase boundaries, for the phase split."""
    dev = tokens.device
    out = torch.empty(lr.B * lr.P, dtype=torch.uint8, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    fn = kernels.kernel("lz77_resolve")
    with torch.cuda.device(dev):
        rc = fn(tokens.data_ptr(), lr.B, lr.T, lr.P, n_tokens.data_ptr(),
                isize.data_ptr(), out.data_ptr(), total.data_ptr(), lr.C,
                lr.S, lr.threads, lr.tokens, lr.smem,
                None if clocks is None else clocks.data_ptr(), _stream(dev))
    kernels.check_launch("resolve_pack", rc)
    return out, total[0]


# ---------------------------------------------------------------------------
# K9: the record walk
# ---------------------------------------------------------------------------

def walk_records_device_plain(buf: torch.Tensor, total: Scalar, start: int,
                              stop: int, R: int):
    """Plain version of the walk (the reference's pointer doubling over a
    successor per byte, marks pushed along the jumps until no mark
    changes).  Returns (offs [R] i32, n_all, tail, bad) as int32
    scalars."""
    L = buf.shape[0]
    dev = buf.device
    total = (total.to(torch.int64).reshape(()) if isinstance(
        total, torch.Tensor) else torch.tensor(int(total), device=dev))
    pos = torch.arange(L, device=dev)
    bp = torch.cat([buf, torch.zeros(4, dtype=torch.uint8, device=dev)]
                   ).to(torch.int64)
    bs = bp[:L] | (bp[1:L + 1] << 8) | (bp[2:L + 2] << 16) | \
        (bp[3:L + 3] << 24)
    bs = torch.where(bs >= 1 << 31, bs - (1 << 32), bs)
    has_size = pos + 4 <= total
    bs_ok = has_size & (bs >= 32) & (bs <= L)
    rec_end = pos + 4 + torch.where(bs_ok, bs, 0)
    complete = bs_ok & (rec_end <= total)
    sink = torch.full((1,), L, dtype=torch.int64, device=dev)
    jumps = torch.cat([torch.where(complete, rec_end.clamp(max=L), L), sink])
    marks = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    marks[min(int(start), L)] = True
    while True:
        m2 = marks.clone()
        m2[jumps[marks]] = True
        jumps = jumps[jumps]
        if torch.equal(m2, marks):
            break
        marks = m2
    started = marks[:L]
    term = started & ~complete
    bad = (term & has_size & (bs < 32)).any().to(torch.int32)
    tail = torch.where(term, pos, total).min().to(torch.int32)
    kept = started & complete & (pos < stop)
    n_all = kept.sum().to(torch.int32)
    rank = torch.cumsum(kept.to(torch.int64), 0) - 1
    sel = kept & (rank < R)
    offs = torch.zeros(R, dtype=torch.int32, device=dev)
    offs[rank[sel]] = pos[sel].to(torch.int32)
    return offs, n_all, tail, bad


def walk_records_device(buf: torch.Tensor, total: Scalar, start: int,
                        stop: int, R: int):
    """The BAM record walk over a contiguous inflated buffer: the chain
    from ``start``; ``total`` bytes are data.  Returns (offs [R] int32:
    the records starting before ``stop`` whose bytes are complete, in
    order, rows past min(n_all, R) zero; n_all: their count, unclamped;
    tail: the first reached record that is not complete, or total; bad:
    1 when a reached record has a readable block_size below 32).

    CUDA tensors launch the K9 kernels on the current stream (no
    synchronisation; ``total`` may be a device int32); CPU tensors take
    ``walk_records_device_plain``."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.shape[0] < 1:
        raise ValueError(f"buf must be uint8 [L], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous")
    if int(start) < 0 or int(R) < 0:
        raise ValueError(f"start {start} and R {R} must be >= 0")
    if not _cuda_or_cpu(buf):
        return walk_records_device_plain(buf, total, start, stop, R)
    dev = buf.device
    lw = walk_launch(buf.shape[0])
    total = _i32_scalar(total, dev)
    offs = torch.empty(R, dtype=torch.int32, device=dev)
    walk = torch.empty(3, dtype=torch.int32, device=dev)
    words = torch.empty(lw.words, dtype=torch.int32, device=dev)
    marks = torch.empty(lw.entries, dtype=torch.uint8, device=dev)
    fn = kernels.kernel("record_walk")
    with torch.cuda.device(dev):
        rc = fn(buf.data_ptr(), lw.L, total.data_ptr(), int(start),
                int(stop), int(R), offs.data_ptr(), walk.data_ptr(),
                words.data_ptr(), lw.words, marks.data_ptr(), lw.entries,
                lw.W, lw.tiles, lw.rounds, lw.path_cap, _stream(dev))
    kernels.check_launch("walk_records_device", rc)
    walk_records_device.launches += 1
    return offs, walk[0], walk[1], walk[2]


walk_records_device.launches = 0


# ---------------------------------------------------------------------------
# K10p: the segmented seq/qual gather
# ---------------------------------------------------------------------------

def payload_gather_plain(buf: torch.Tensor, offs: torch.Tensor,
                         l_seq: torch.Tensor, l_read_name: torch.Tensor,
                         n_cigar: torch.Tensor, n_all: Scalar, max_len: int,
                         seq_stride: int, qual_stride: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the payload gather: one index tile per stream,
    the reference's int32 arithmetic (it wraps where the reference's
    does) and its clamp of every index to [0, L - 1]."""
    L = buf.shape[0]
    R = offs.shape[0]
    dev = buf.device
    n_valid = torch.clamp(torch.as_tensor(n_all, device=dev), 0, R)
    valid = torch.arange(R, device=dev) < n_valid
    seq_off = offs + PREFIX + l_read_name + 4 * n_cigar
    nb = (torch.clamp(l_seq, min=0) + 1) // 2
    use = torch.where(valid, torch.clamp(l_seq, 0, max_len), 0)
    half = (use + 1) // 2

    def tile(start: torch.Tensor, width: int, limit: torch.Tensor):
        j = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
        idx = (start[:, None] + j).clamp_(0, L - 1).to(torch.int64)
        return torch.where(j < limit[:, None], buf[idx],
                           torch.zeros((), dtype=torch.uint8, device=dev))

    return (tile(seq_off, seq_stride, half),
            tile(seq_off + nb, qual_stride, use))


def payload_gather(buf: torch.Tensor, offs: torch.Tensor,
                   l_seq: torch.Tensor, l_read_name: torch.Tensor,
                   n_cigar: torch.Tensor, n_all: Scalar, max_len: int,
                   seq_stride: int, qual_stride: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each valid record's packed bases and quals as [R, seq_stride] and
    [R, qual_stride] u8 tiles (rows r >= min(n_all, R) and bytes past a
    read's clipped length zero), with ``resolve_walk_payload``'s rules.

    CUDA tensors launch the K10p kernel on the current stream as one
    persistent wave (``payload_launch``; ``n_all`` may be a device int32,
    read there); CPU tensors take ``payload_gather_plain``."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.shape[0] < 1:
        raise ValueError(f"buf must be uint8 [L], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    R = offs.shape[0]
    for name, t in (("offs", offs), ("l_seq", l_seq),
                    ("l_read_name", l_read_name), ("n_cigar", n_cigar)):
        if t.dtype != torch.int32 or tuple(t.shape) != (R,):
            raise ValueError(f"{name} must be int32 [{R}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != buf.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {buf.device}")
    if not _cuda_or_cpu(buf):
        return payload_gather_plain(buf, offs, l_seq, l_read_name, n_cigar,
                                    n_all, max_len, seq_stride, qual_stride)
    if not buf.is_contiguous():   # the kernel reads buf as bytes
        raise ValueError("buf must be contiguous on the card")
    dev = buf.device
    n_all = _i32_scalar(n_all, dev)
    lp = payload_launch(R, int(seq_stride), int(qual_stride),
                        _sm_count(dev.index))
    seq = torch.empty((R, seq_stride), dtype=torch.uint8, device=dev)
    qual = torch.empty((R, qual_stride), dtype=torch.uint8, device=dev)
    fn = kernels.kernel("payload_gather")
    with torch.cuda.device(dev):
        rc = fn(buf.data_ptr(), buf.shape[0], offs.data_ptr(),
                l_seq.data_ptr(), l_read_name.data_ptr(), n_cigar.data_ptr(),
                n_all.data_ptr(), R, int(max_len), int(seq_stride),
                int(qual_stride), seq.data_ptr(), qual.data_ptr(), lp.grid,
                lp.threads, _stream(dev))
    kernels.check_launch("payload_gather", rc)
    payload_gather.launches += 1
    return seq, qual


payload_gather.launches = 0


# ---------------------------------------------------------------------------
# K10i: the serve tiles' interval columns
# ---------------------------------------------------------------------------

# CIGAR ops a record may have for the serve-tile device walk.  A chunk
# with a longer CIGAR raises ``over`` and the caller builds it on the
# host: an end1 from a truncated CIGAR would be wrong (the reference's
# value, which keeps its gather tile [R, 64, 4] bytes).
DEVICE_TILE_CIGAR_CAP = 64

_I32_MAX = (1 << 31) - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value two's-complement arithmetic leaves."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _prefix_columns(buf: torch.Tensor, offs: torch.Tensor) -> Dict[str,
                                                                 torch.Tensor]:
    """Bytes 4-23 of each row's record by the reference's index rule for
    the serve step, ``clip(offs + k, 0, L - 1)`` with the int32 sum
    wrapping (``resolve_walk_intervals`` :359-362; K1 wraps a negative
    index by L instead): refid, pos, l_read_name, n_cigar and l_seq as
    int64 [R] holding their int32 / unsigned values."""
    L = buf.shape[0]
    k = torch.arange(4, 24, device=buf.device, dtype=torch.int64)
    idx = _wrap32(offs.to(torch.int64)[:, None] + k[None, :]).clamp(0, L - 1)
    t = buf[idx].to(torch.int64)

    def le(at: int, width: int) -> torch.Tensor:
        v = t[:, at]
        for i in range(1, width):
            v = v | (t[:, at + i] << (8 * i))
        return v
    return {"refid": _wrap32(le(0, 4)), "pos": _wrap32(le(4, 4)),
            "l_read_name": t[:, 8], "n_cigar": le(12, 2),
            "l_seq": _wrap32(le(16, 4))}


def interval_cols_plain(buf: torch.Tensor, offs: torch.Tensor,
                        n_all: Scalar, cap: int = DEVICE_TILE_CIGAR_CAP):
    """Plain version of K10i: each row's prefix gathered by the
    reference's clip rule (``_prefix_columns``), then the reference's
    [R, cap] formulation (every row's first ``cap`` CIGAR words gathered
    byte by byte with the index clamp), in int64 masked to the int32
    values the reference's int32 sums and clamps wrap to.  Returns (rid,
    pos1, end1) int32 [R] and the int32 ``over`` flag."""
    L = buf.shape[0]
    R = offs.shape[0]
    dev = buf.device
    cols = _prefix_columns(buf, offs)
    n_valid = torch.clamp(torch.as_tensor(n_all, device=dev).reshape(()),
                          max=R)
    valid = torch.arange(R, device=dev) < n_valid
    nc, ls = cols["n_cigar"], cols["l_seq"]
    over = (valid & (nc > cap)).any().to(torch.int32)
    cig_off = _wrap32(offs.to(torch.int64) + PREFIX + cols["l_read_name"])
    k = torch.arange(cap, device=dev, dtype=torch.int64)[None, :]
    widx = _wrap32(cig_off[:, None] + 4 * k)
    word = torch.zeros(widx.shape, dtype=torch.int64, device=dev)
    for j in range(4):
        idx = _wrap32(widx + j).clamp(0, L - 1)
        word |= buf[idx].to(torch.int64) << (8 * j)
    op = word & 0xF
    oplen = word >> 4
    consumes = (op == 0) | (op == 2) | (op == 3) | (op == 7) | (op == 8)
    act = k < torch.clamp(nc, max=cap)[:, None]
    span = _wrap32(torch.where(act & consumes, oplen, 0).sum(1))
    ref = torch.where(nc > 0, span, torch.clamp(ls, min=0))
    pos1 = torch.clamp(cols["pos"], max=_I32_MAX - 1) + 1
    room = _wrap32(_I32_MAX - pos1)
    end1 = _wrap32(pos1 + torch.minimum(torch.clamp(ref, min=1) - 1, room))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return (torch.where(valid, cols["refid"].to(torch.int32),
                        torch.full((), -1, dtype=torch.int32, device=dev)),
            torch.where(valid, pos1.to(torch.int32), zero),
            torch.where(valid, end1.to(torch.int32), zero), over)


# K10i's per-stream scratch: one uint64 that counts the launch's CTAs in
# and is zero between launches (``csrc/interval_cols.cu``), keyed by
# (device index, stream handle): launches on one stream never overlap
_K10I_DONE: Dict[Tuple[int, int], torch.Tensor] = {}
_K10I_DONE_LOCK = threading.Lock()


def _k10i_done(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    with _K10I_DONE_LOCK:
        done = _K10I_DONE.get(key)
        if done is None:
            done = _K10I_DONE[key] = torch.zeros(1, dtype=torch.int64,
                                                 device=dev)
    return done


def interval_cols(buf: torch.Tensor, offs: torch.Tensor, n_all: Scalar,
                  cap: int = DEVICE_TILE_CIGAR_CAP):
    """Each walked record's 1-based inclusive (rid, pos1, end1) as int32
    [R] columns, from the record's own fixed prefix at ``offs`` (refid,
    pos, l_read_name, n_cigar, l_seq) and its first ``cap`` CIGAR ops (a
    ``*`` CIGAR takes l_seq), rows at or past min(n_all, R) holding the
    tile pads (rid -1, pos1 = end1 = 0), and the int32 ``over`` flag (a
    valid row with more than ``cap`` ops), with ``resolve_walk_intervals``'
    rules: every byte index clipped to the buffer.

    CUDA tensors launch the K10i kernel on the current stream (``n_all``
    may be a device int32, read there: no synchronisation); CPU tensors
    take ``interval_cols_plain``."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.shape[0] < 1:
        raise ValueError(f"buf must be uint8 [L], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    if offs.dtype != torch.int32 or offs.dim() != 1:
        raise ValueError(f"offs must be int32 [R], got {offs.dtype} "
                         f"{tuple(offs.shape)}")
    if offs.device != buf.device:
        raise ValueError(f"offs must be on {buf.device}")
    if not 0 <= int(cap) <= 4096:
        raise ValueError(f"cigar cap {cap} outside [0, 4096]")
    if not _cuda_or_cpu(buf):
        return interval_cols_plain(buf, offs, n_all, cap)
    if not buf.is_contiguous():   # the kernel reads buf as bytes
        raise ValueError("buf must be contiguous on the card")
    dev = buf.device
    R = offs.shape[0]
    offs = offs.contiguous()
    n_all = _i32_scalar(n_all, dev)
    # three allocations: the pad sweep's int4 stores need each column
    # 16-byte aligned
    rid, pos1, end1 = (torch.empty(R, dtype=torch.int32, device=dev)
                       for _ in range(3))
    over = torch.empty(1, dtype=torch.int32, device=dev)
    fn = kernels.kernel("interval_cols")
    with torch.cuda.device(dev):
        stream = _stream(dev)
        done = _k10i_done(dev, stream)
        rc = fn(buf.data_ptr(), buf.shape[0], offs.data_ptr(),
                n_all.data_ptr(), R, int(cap), rid.data_ptr(),
                pos1.data_ptr(), end1.data_ptr(), over.data_ptr(),
                done.data_ptr(), stream)
    kernels.check_launch("interval_cols", rc)
    interval_cols.launches += 1
    return rid, pos1, end1, over[0]


interval_cols.launches = 0


# ---------------------------------------------------------------------------
# K11: the BCF device unpack
# ---------------------------------------------------------------------------

# GT entry widths (int8, int16, int32) and the widest ploidy the
# columnar decode hands to the card (formats/bcf_columns._MAX_GT_PLOIDY)
GT_WIDTHS = (1, 2, 4)
GT_MAX_COUNT = 256

# K11's packed metadata (``csrc/variant_gt.cu``): eight int32 header words
# (n, row entries P, mode, the word offsets of the starts and of the
# flags, three zeros), then P row entries of four words (GT offset, tile
# row, width | count << 8, n_sample; width 0 writes -1), the starts and
# the flags.  The mode's bits name the outputs a launch writes; with
# MODE_FILL every column of the tile is written.
META_HEADER = 8
MODE_PREFIX, MODE_FLAGS, MODE_DOSAGE, MODE_FILL = 1, 2, 4, 8
MODE_ALL = MODE_PREFIX | MODE_FLAGS | MODE_DOSAGE | MODE_FILL


def _entries(offs, rows, width: int, count: int, n_sample: int
             ) -> np.ndarray:
    """Row entries [k, 4] int32 of one GT layout."""
    e = np.empty((len(rows), 4), np.int32)
    e[:, 0] = np.asarray(offs).astype(np.int32)
    e[:, 1] = np.asarray(rows).astype(np.int32)
    e[:, 2] = width | count << 8
    e[:, 3] = n_sample
    return e


def pack_variant_meta(meta: Dict[str, object], R: int) -> np.ndarray:
    """One span's cursor metadata (``decode_bcf_cursor_meta``: n, starts,
    flags, gt_groups) as K11's int32 array for a tile of R >= n rows: a
    row entry (GT offset, row, width | count << 8, n_sample) for every
    row of every GT layout group, group by group, then a width-0 entry
    for each row of no group and each pad row n..R-1 (their dosage rows
    are -1); the starts and flags padded with 0 to R.  Mode: every
    output, every column."""
    n = int(meta["n"])
    if not 0 <= n <= R:
        raise ValueError(f"{n} records do not fit a tile of {R} rows")
    covered = np.zeros(R, bool)
    parts = []
    for rows, offs, width, count, n_sample in meta["gt_groups"]:
        covered[np.asarray(rows)] = True
        parts.append(_entries(offs, rows, width, count, n_sample))
    rest = np.flatnonzero(~covered)
    parts.append(_entries(np.zeros(rest.size), rest, 0, 0, 0))
    entries = np.concatenate(parts)
    P = entries.shape[0]
    starts_at = META_HEADER + 4 * P
    flags_at = starts_at + R
    out = np.zeros(flags_at + (R + 3) // 4, np.int32)
    out[:META_HEADER] = (n, P, MODE_ALL, starts_at, flags_at, 0, 0, 0)
    out[META_HEADER:starts_at] = entries.ravel()
    out[starts_at:starts_at + n] = np.asarray(meta["starts"]).astype(
        np.int32)
    out[flags_at:].view(np.uint8)[:n] = meta["flags"]
    return out


def unpack_variant_meta(packed) -> Dict[str, object]:
    """``pack_variant_meta``'s array (numpy or a tensor) back to its
    parts: n, R, mode, starts int64 [R], flags uint8 [R], gt_groups
    [(rows int64, offs int64, width, count, n_sample)] in the order of
    their first entries, and fill_rows int64 (the rows [0, n) of no
    group)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    a = np.asarray(packed, np.int32)
    n, P, mode, starts_at, flags_at = (int(x) for x in a[:5])
    R = flags_at - starts_at
    e = a[META_HEADER:META_HEADER + 4 * P].reshape(P, 4).astype(np.int64)
    layouts = list(dict.fromkeys(zip(e[:, 2], e[:, 3])))
    groups = []
    for lay, n_sample in layouts:
        if lay & 0xFF == 0:
            continue
        sel = (e[:, 2] == lay) & (e[:, 3] == n_sample)
        groups.append((e[sel, 1], e[sel, 0], int(lay & 0xFF),
                       int(lay >> 8), int(n_sample)))
    fill = e[(e[:, 2] & 0xFF) == 0, 1]
    return {"n": n, "R": R, "mode": mode,
            "starts": a[starts_at:flags_at].astype(np.int64),
            "flags": a[flags_at:].view(np.uint8)[:R].copy(),
            "gt_groups": groups, "fill_rows": fill[fill < n]}


def variant_prefix_plain(buf: torch.Tensor, starts: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``variant_prefix``: the reference's formula
    (``variant_prefix_device`` :391), each byte index ``starts + k`` in
    int32 arithmetic (the sum wraps) clipped to [0, L - 1], the words
    assembled in int64 and wrapped to int32."""
    L = buf.shape[0]
    k = torch.arange(8, 16, device=buf.device, dtype=torch.int64)
    idx = _wrap32(starts.to(torch.int64)[:, None] + k[None, :]).clamp(
        0, L - 1)
    t = buf[idx].to(torch.int64)

    def le32(at: int) -> torch.Tensor:
        return (t[:, at] | (t[:, at + 1] << 8) | (t[:, at + 2] << 16)
                | (t[:, at + 3] << 24))
    return (_wrap32(le32(0)).to(torch.int32),
            _wrap32(le32(4) + 1).to(torch.int32))


def gt_dosage_plain(buf: torch.Tensor, gt_off: torch.Tensor,
                    rows: torch.Tensor, width: int, count: int,
                    n_sample: int, dosage: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gt_dosage``: the reference's formula
    (``variant_gt_dosage_device`` :413) on an index [G, width * count *
    n_sample] (``gt_off + j`` in int32 arithmetic, clipped to the
    buffer), the words held in int64, then the reference's scatter into
    ``dosage`` at ``rows`` (rows outside the tile are dropped, as a JAX
    scatter drops them).  Returns ``dosage``."""
    L = buf.shape[0]
    G = gt_off.shape[0]
    dev = buf.device
    if G == 0 or n_sample == 0:
        return dosage
    j = torch.arange(width * count * n_sample, device=dev,
                     dtype=torch.int64)
    idx = _wrap32(gt_off.to(torch.int64)[:, None] + j[None, :]).clamp(
        0, L - 1)
    raw = buf[idx].to(torch.int64).reshape(G, n_sample, count, width)
    shifts = 8 * torch.arange(width, device=dev, dtype=torch.int64)
    w = (raw << shifts).sum(-1)
    if width < 4:
        sbit = 1 << (8 * width - 1)
        g = (w ^ sbit) - sbit
    else:
        g = _wrap32(w)
    missing = -(1 << (8 * width - 1))
    present = g != missing + 1              # END_OF_VECTOR trims ploidy
    miss = present & (((g >> 1) == 0) | (g == missing))
    alt = present & (((g >> 1) - 1) > 0)
    d = torch.where(present.any(2) & ~miss.any(2), alt.sum(2),
                    torch.full((), -1, dtype=torch.int64, device=dev))
    d = torch.clamp(d, max=127).to(torch.int8)
    r = rows.to(torch.int64)
    keep = (r >= 0) & (r < dosage.shape[0])
    dosage[r[keep][:, None], torch.arange(n_sample, device=dev)] = d[keep]
    return dosage


def variant_unpack_plain(buf: torch.Tensor, meta, R: int, s_pad: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """Plain version of ``variant_unpack``: the packed array's parts
    (``unpack_variant_meta``), ``variant_prefix_plain`` at the R starts,
    the flags as packed, and ``gt_dosage_plain`` a group over a tile of
    -1, as the reference builds the tile."""
    m = unpack_variant_meta(meta)
    if m["mode"] != MODE_ALL or m["R"] != R:
        raise ValueError(f"not a packed span of {R} rows: mode "
                         f"{m['mode']}, {m['R']} rows")
    dev = buf.device

    def i32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int32)).to(dev)
    chrom, pos = variant_prefix_plain(buf, i32(m["starts"]))
    dosage = torch.full((R, s_pad), -1, dtype=torch.int8, device=dev)
    for rows, offs, width, count, n_sample in m["gt_groups"]:
        gt_dosage_plain(buf, i32(offs), i32(rows), width, count, n_sample,
                        dosage)
    return chrom, pos, torch.from_numpy(m["flags"]).to(dev), dosage


def prefix_meta_head(R: int) -> np.ndarray:
    """The header ``variant_prefix`` puts before its R starts: no row
    entry, the prefix alone."""
    return np.array([R, 0, MODE_PREFIX, META_HEADER, 0, 0, 0, 0], np.int32)


def group_meta_head(R: int, G: int) -> np.ndarray:
    """The header ``gt_dosage`` puts before its G row entries: the calls
    alone, columns [0, n_sample) only."""
    return np.array([R, G, MODE_DOSAGE, 0, 0, 0, 0, 0], np.int32)


def host_to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A small host array on ``dev``: through pinned memory and an
    asynchronous copy on CUDA (the caching host allocator keeps the
    pinned block until the copy is done), a private copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


def check_variant_meta(meta, R: int) -> np.ndarray:
    """``meta`` (a host int32 array, numpy or a CPU tensor) as the int32
    array K11 reads, its header checked on the host: a span of every
    output and every column (``MODE_ALL``) whose n records fit the R
    rows, whose P row entries, R starts and R flag bytes follow the
    header in that order, inside the array.  Raises ValueError
    otherwise, so that the kernel's own check of the sections (a trap,
    which would leave the CUDA context unusable) never fires."""
    if isinstance(meta, torch.Tensor):
        if meta.device.type != "cpu":
            raise ValueError(f"meta must be a host array, got a tensor "
                             f"on {meta.device}")
        meta = meta.numpy()
    a = np.asarray(meta)
    if a.dtype != np.int32 or a.ndim != 1 or a.shape[0] < META_HEADER:
        raise ValueError(f"meta must be int32 [>= {META_HEADER}], got "
                         f"{a.dtype} {a.shape}")
    n, P, mode, starts_at, flags_at = (int(x) for x in a[:5])
    m = a.shape[0]
    if mode != MODE_ALL or not 0 <= n <= R or P < 0 \
            or META_HEADER + 4 * P > starts_at \
            or starts_at + R != flags_at or 4 * flags_at + R > 4 * m:
        raise ValueError(
            f"meta's header (n {n}, {P} row entries, mode {mode}, starts "
            f"at {starts_at}, flags at {flags_at}) is not a packed span of "
            f"{R} rows in {m} words")
    return a


def _check_buf(buf: torch.Tensor) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1 or buf.shape[0] < 1:
        raise ValueError(f"buf must be uint8 [L], got {buf.dtype} "
                         f"{tuple(buf.shape)}")


def launch_unpack(buf: torch.Tensor, meta: torch.Tensor, R: int,
                  s_pad: int, chrom: Optional[torch.Tensor],
                  pos: Optional[torch.Tensor],
                  flags: Optional[torch.Tensor],
                  dosage: Optional[torch.Tensor]) -> None:
    """One K11 launch over CUDA tensors the caller checked (``meta`` on
    the card): the outputs given (None leaves a part out of the header's
    mode).  Counts nothing."""
    dev = buf.device

    def ptr(t: Optional[torch.Tensor]) -> int:
        return t.data_ptr() if t is not None else 0
    fn = kernels.kernel("variant_unpack")
    with torch.cuda.device(dev):
        rc = fn(buf.data_ptr(), buf.shape[0], meta.data_ptr(),
                meta.shape[0], R, s_pad, ptr(chrom), ptr(pos), ptr(flags),
                ptr(dosage), _stream(dev))
    kernels.check_launch("variant_unpack", rc)


def variant_unpack(buf: torch.Tensor, meta, R: int, s_pad: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """One span's tile from its resolved buffer ``buf`` (uint8 [L]) and
    its packed metadata ``meta`` (``pack_variant_meta``: a host int32
    array, its header checked by ``check_variant_meta``): (chrom int32
    [R], pos int32 [R] 1-based, flags uint8 [R], dosage int8 [R, s_pad])
    with ``variant_prefix_device``'s and ``variant_gt_dosage_device``'s
    rules, every byte index clipped to the buffer; pad rows and rows of
    no group hold -1, and so do the columns past each group's n_sample.

    CUDA tensors copy ``meta`` to the card once from pinned memory and
    launch the K11 kernel once on the current stream (the prefix, every
    GT group, the pads and the flags); CPU tensors take
    ``variant_unpack_plain``."""
    _check_buf(buf)
    R, s_pad = int(R), int(s_pad)
    if R < 0 or s_pad < 0:
        raise ValueError(f"tile [{R}, {s_pad}] has a negative side")
    meta = check_variant_meta(meta, R)
    if not _cuda_or_cpu(buf):
        return variant_unpack_plain(buf, meta, R, s_pad)
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous on the card")
    dev = buf.device
    meta = host_to_device(meta, dev)
    chrom = torch.empty(R, dtype=torch.int32, device=dev)
    pos = torch.empty(R, dtype=torch.int32, device=dev)
    flags = torch.empty(R, dtype=torch.uint8, device=dev)
    dosage = torch.empty((R, s_pad), dtype=torch.int8, device=dev)
    launch_unpack(buf, meta, R, s_pad, chrom, pos, flags, dosage)
    variant_unpack.launches += 1
    return chrom, pos, flags, dosage


variant_unpack.launches = 0


def variant_prefix(buf: torch.Tensor, starts: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each BCF record's CHROM and 1-based POS, as int32 [R] columns,
    from bytes 8..15 of the record at ``starts`` (int32 [R]) in the
    resolved buffer ``buf`` (uint8 [L]), every byte index clipped to the
    buffer: a pad start of 0 or below still gathers, and the caller
    masks it by its count.

    CUDA tensors launch the K11 kernel with no row entry (the
    header and the starts joined on the card); CPU tensors take
    ``variant_prefix_plain``."""
    _check_buf(buf)
    if starts.dtype != torch.int32 or starts.dim() != 1:
        raise ValueError(f"starts must be int32 [R], got {starts.dtype} "
                         f"{tuple(starts.shape)}")
    if starts.device != buf.device:
        raise ValueError(f"starts must be on {buf.device}")
    if not _cuda_or_cpu(buf):
        return variant_prefix_plain(buf, starts)
    if not buf.is_contiguous():
        raise ValueError("buf must be contiguous on the card")
    dev = buf.device
    R = starts.shape[0]
    chrom = torch.empty(R, dtype=torch.int32, device=dev)
    pos = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return chrom, pos
    meta = torch.cat([host_to_device(prefix_meta_head(R), dev), starts])
    launch_unpack(buf, meta, R, 0, chrom, pos, None, None)
    variant_prefix.launches += 1
    return chrom, pos


variant_prefix.launches = 0


def gt_dosage(buf: torch.Tensor, gt_off: torch.Tensor, rows: torch.Tensor,
              width: int, count: int, n_sample: int,
              dosage: torch.Tensor) -> torch.Tensor:
    """One GT layout group's ALT dosages, written straight into the int8
    tile ``dosage`` [R, S_pad] at ``rows``: for each of the G records of
    the group (``gt_off`` int32 [G], the offset of its GT data in
    ``buf``; ``rows`` int32 [G], its row of the tile) ``n_sample``
    vectors of ``count`` little-endian sign-extended ints ``width``
    bytes wide, with ``variant_gt_dosage_device``'s rules:
    END_OF_VECTOR trims ploidy, any MISSING allele or allele value 0
    makes the call -1, else the count of ALT alleles saturated at 127;
    every byte index clipped to the buffer.  Columns past ``n_sample``
    and rows of no group are left as they are.  Returns ``dosage``.

    CUDA tensors launch the K11 kernel with a row entry a group row and
    no pad fill (the header and the entries joined on the card);
    CPU tensors take ``gt_dosage_plain``."""
    _check_buf(buf)
    for name, t in (("gt_off", gt_off), ("rows", rows)):
        if t.dtype != torch.int32 or t.dim() != 1 \
                or t.shape[0] != gt_off.shape[0]:
            raise ValueError(f"{name} must be int32 [{gt_off.shape[0]}], "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != buf.device:
            raise ValueError(f"{name} must be on {buf.device}")
    if dosage.dtype != torch.int8 or dosage.dim() != 2 \
            or dosage.device != buf.device:
        raise ValueError(f"dosage must be int8 [R, S_pad] on {buf.device}, "
                         f"got {dosage.dtype} {tuple(dosage.shape)} on "
                         f"{dosage.device}")
    width, count, n_sample = int(width), int(count), int(n_sample)
    if width not in GT_WIDTHS or not 1 <= count <= GT_MAX_COUNT \
            or not 0 <= n_sample <= dosage.shape[1]:
        raise ValueError(f"GT layout width {width}, count {count}, "
                         f"n_sample {n_sample} outside widths {GT_WIDTHS}, "
                         f"counts [1, {GT_MAX_COUNT}], samples "
                         f"[0, {dosage.shape[1]}]")
    if not _cuda_or_cpu(buf):
        return gt_dosage_plain(buf, gt_off, rows, width, count, n_sample,
                               dosage)
    if not (buf.is_contiguous() and dosage.is_contiguous()):
        raise ValueError("buf and dosage must be contiguous on the card")
    G = gt_off.shape[0]
    if G == 0 or n_sample == 0:
        return dosage
    dev = buf.device
    R = dosage.shape[0]
    meta = torch.cat([host_to_device(group_meta_head(R, G), dev), torch.stack(
        [gt_off, rows, torch.full_like(gt_off, width | count << 8),
         torch.full_like(gt_off, n_sample)], 1).reshape(-1)])
    launch_unpack(buf, meta, R, dosage.shape[1], None, None, None, dosage)
    gt_dosage.launches += 1
    return dosage


gt_dosage.launches = 0


# ---------------------------------------------------------------------------
# The fused decode steps
# ---------------------------------------------------------------------------

def _resolve_offsets(tokens, n_tokens, isize, start: int, stop: int,
                     P: Optional[int]):
    """resolve + pack + walk: (buf, offs, n_all, tail, bad)."""
    B, T = tokens.shape
    P = T if P is None else int(P)
    buf, total = resolve_pack(tokens, n_tokens, isize, P)
    offs, n_all, tail, bad = walk_records_device(buf, total, start, stop,
                                                 records_cap(B, P))
    return buf, offs, n_all, tail, bad


def _resolve_walk(tokens, n_tokens, isize, start: int, stop: int,
                  P: Optional[int]):
    """resolve + pack + walk + K1 at the walk's offsets."""
    buf, offs, n_all, tail, bad = _resolve_offsets(tokens, n_tokens, isize,
                                                   start, stop, P)
    cols = unpack_fixed_fields(buf, offs)
    R = offs.shape[0]
    valid = torch.arange(R, device=buf.device) < torch.clamp(n_all, max=R)
    return buf, offs, cols, valid, n_all, tail, bad


def resolve_walk_fields(tokens: torch.Tensor, n_tokens: torch.Tensor,
                        isize: torch.Tensor, start: int, stop: int,
                        P: Optional[int] = None):
    """The device decode step of the flagstat family: one chunk's [B, T]
    tokens (blocks of P bytes, P = T unless given), counts and ISIZEs and
    its walk window [start, stop) in inflated-buffer coordinates ->
    (cols: the 12 fixed-field int32
    columns at the walk's R = records_cap(B, P) offsets, rows past the
    owned count gathered at offset 0; valid [R] bool; n_all, tail, bad:
    int32 scalars of the walk)."""
    _, _, cols, valid, n_all, tail, bad = _resolve_walk(
        tokens, n_tokens, isize, start, stop, P)
    return cols, valid, n_all, tail, bad


def resolve_walk_payload(tokens: torch.Tensor, n_tokens: torch.Tensor,
                         isize: torch.Tensor, start: int, stop: int,
                         max_len: int, seq_stride: int, qual_stride: int,
                         P: Optional[int] = None):
    """The device decode step of the payload family: ``resolve_walk_fields``
    plus each record's packed bases and quals in [R, seq_stride] /
    [R, qual_stride] tiles (the layout of the host packer
    ``decode_span_payload_host``).  Returns (cols, seq, qual, valid,
    n_all, tail, bad); ``bad`` also flags a valid record whose seq or qual
    section overruns its block_size (the host walker's "malformed BAM
    record chain")."""
    buf, offs, cols, valid, n_all, tail, bad = _resolve_walk(
        tokens, n_tokens, isize, start, stop, P)
    l_seq = cols["l_seq"]
    seq_rel = PREFIX + cols["l_read_name"] + 4 * cols["n_cigar"]
    nb = (torch.clamp(l_seq, min=0) + 1) // 2
    pay_bad = valid & ((l_seq < 0) | (
        seq_rel + nb + torch.clamp(l_seq, min=0) > 4 + cols["block_size"]))
    bad = torch.maximum(bad, pay_bad.any().to(torch.int32))
    seq, qual = payload_gather(buf, offs, l_seq, cols["l_read_name"],
                               cols["n_cigar"], n_all, max_len, seq_stride,
                               qual_stride)
    return cols, seq, qual, valid, n_all, tail, bad


def resolve_walk_intervals(tokens: torch.Tensor, n_tokens: torch.Tensor,
                           isize: torch.Tensor, start: int, stop: int,
                           P: Optional[int] = None,
                           cigar_cap: int = DEVICE_TILE_CIGAR_CAP):
    """The device decode step of the serve-tile family: resolve + pack +
    walk, then K10i's (rid, pos1, end1) interval columns at the walk's
    R = records_cap(B, P) rows (the pads past the walked records); K10i
    reads each record's prefix itself, so no K1 runs.  Returns (rid,
    pos1, end1, n_all, tail, bad, over), the four verdicts int32 scalars
    on the chunk's device: ``over`` (a record with more than
    ``cigar_cap`` ops) sends the chunk to the host build."""
    buf, offs, n_all, tail, bad = _resolve_offsets(tokens, n_tokens, isize,
                                                   start, stop, P)
    rid, pos1, end1, over = interval_cols(buf, offs, n_all, cigar_cap)
    return rid, pos1, end1, n_all, tail, bad, over


def resolve_walk_intervals_plain(tokens: torch.Tensor,
                                 n_tokens: torch.Tensor,
                                 isize: torch.Tensor, start: int, stop: int,
                                 P: Optional[int] = None,
                                 cigar_cap: int = DEVICE_TILE_CIGAR_CAP):
    """``resolve_walk_intervals`` through every kernel's plain version,
    on the tensors' own device (the check a card run holds the kernels
    to)."""
    B, T = tokens.shape
    P = T if P is None else int(P)
    R = records_cap(B, P)
    buf, total = pack_contiguous_plain(
        resolve_tokens_plain(tokens, n_tokens, P), isize)
    offs, n_all, tail, bad = walk_records_device_plain(buf, total, start,
                                                       stop, R)
    rid, pos1, end1, over = interval_cols_plain(buf, offs, n_all, cigar_cap)
    return rid, pos1, end1, n_all, tail, bad, over


# ---------------------------------------------------------------------------
# Library entry: a whole span through the device resolve
# ---------------------------------------------------------------------------

def require_tokenizer() -> None:
    """The plane needs the native tokenizer; without the host library it
    is misconfigured (PlanError), not faced with bad data."""
    try:
        native.load()
    except native.NativeBuildError as e:
        raise PlanError(
            "the device decode plane needs the native tokenizer "
            f"(hbam_deflate_tokenize_batch): {e}") from e


def inflate_span_device(raw: bytes, table: Optional[dict] = None,
                        n_threads: int = 0,
                        check_crc: bool = False, device=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Inflate a BGZF span with host Huffman tokenize + device LZ77
    resolve, on ``cuda:0`` unless ``device`` says otherwise.  The
    contract of ``ops.inflate.inflate_span``: (contiguous inflated bytes,
    per-block starting offsets), resolved SPAN_CHUNK_BLOCKS blocks at a
    time.  ``check_crc`` checks each block's
    CRC32 footer against a CRC folded into the tokenize pass; a bad
    block raises BGZFError as on the host planes."""
    from hadoop_bam_torch.ops.inflate import block_table, footer_crcs
    dev = resolve_device(device)
    if table is None:
        table = block_table(raw)
    require_tokenizer()
    isize = table["isize"]
    n = isize.size
    ubase = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(isize, out=ubase[1:])
    dst = np.empty(int(ubase[-1]), dtype=np.uint8)
    src = np.frombuffer(raw, dtype=np.uint8)
    expect = footer_crcs(src, table) if check_crc else None
    for lo in range(0, n, SPAN_CHUNK_BLOCKS):
        hi = min(lo + SPAN_CHUNK_BLOCKS, n)
        sub = isize[lo:hi]
        P = ladder_pow2(max(16, int(sub.max())))
        b_cap = round_pow2(hi - lo, 8)
        try:
            out = native.deflate_tokenize_batch(
                src, table["cdata_off"][lo:hi], table["cdata_len"][lo:hi],
                P, n_threads, with_crc=check_crc)
        except ValueError as e:
            raise bgzf.BGZFError(str(e)) from e
        tokens, n_tokens, out_lens = out[:3]
        if not np.array_equal(out_lens, sub):
            bad = int(np.nonzero(out_lens != sub)[0][0])
            raise bgzf.BGZFError(
                f"ISIZE mismatch in block {lo + bad}: tokenized "
                f"{int(out_lens[bad])}, footer says {int(sub[bad])}")
        if check_crc:
            mism = np.nonzero(out[3] != expect[lo:hi])[0]
            if mism.size:
                raise bgzf.BGZFError(
                    f"CRC32 mismatch in block(s) {(mism[:8] + lo).tolist()}")
        tok = np.zeros((b_cap, P), np.int32)
        tok[:hi - lo] = tokens.view(np.int32)
        nt = np.zeros(b_cap, np.int32)
        nt[:hi - lo] = n_tokens
        iz = np.zeros(b_cap, np.int32)
        iz[:hi - lo] = sub
        got, _ = resolve_pack(*(torch.from_numpy(a).to(dev)
                                for a in (tok, nt, iz)))
        k = int(ubase[hi] - ubase[lo])
        dst[int(ubase[lo]):int(ubase[hi])] = got[:k].cpu().numpy()
    return dst, ubase[:-1]


# ---------------------------------------------------------------------------
# Plane probe: one block through each plane's per-block work
# ---------------------------------------------------------------------------

def probe_device_plane(device=None) -> Dict[str, object]:
    """Time one synthetic PROBE_BLOCK_BYTES block of ACGT through each
    plane's per-block work on ``device`` (``cuda:0`` unless given; the
    plain resolve on a CPU device), best of 3 after a warm-up.

    The device plane's steady wall per block is max(tokenize, resolve)
    (the two overlap); the native plane pays the whole inflate, so
    ``device_wins`` says which of the two the block favours.  It times
    neither planning nor staging, which is why
    ``config.resolve_inflate_backend`` does not act on it.  A kernel that
    fails to build or launch raises."""
    dev = resolve_device(device)
    out: Dict[str, object] = {"device": str(dev)}
    rng = np.random.RandomState(0)
    data = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                      size=PROBE_BLOCK_BYTES).tobytes()
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    src = np.frombuffer(comp, np.uint8)
    off = np.array([0], np.int64)
    ln = np.array([len(comp)], np.int32)
    P = ladder_pow2(len(data))

    def timeit(fn, reps: int = 3) -> float:
        fn()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    toks, nt, _ = native.deflate_tokenize_batch(src, off, ln, P, 1)
    args = [torch.from_numpy(a).to(dev) for a in
            (toks.view(np.int32), nt, np.array([len(data)], np.int32))]

    def resolve():
        resolve_pack(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out["tokenize_s"] = timeit(
        lambda: native.deflate_tokenize_batch(src, off, ln, P, 1))
    out["resolve_s"] = timeit(resolve)
    dst = np.empty(len(data), dtype=np.uint8)
    dst_off = np.zeros(1, np.int64)
    isz = np.array([len(data)], np.int32)
    out["inflate_s"] = timeit(
        lambda: native.inflate_batch(src, off, ln, dst, dst_off, isz, 1))
    out["device_wins"] = (max(out["tokenize_s"], out["resolve_s"])
                          < out["inflate_s"])
    return out
