// K2: per-read GC fraction, mean quality and base-code histogram over
// packed payload tiles, for Hopper (sm_90a).
//
// Replaces: hadoop_bam_tpu/ops/seq_pallas.py::seq_qual_stats (:127), i.e.
//   the Pallas kernel _seq_stats_kernel (:50, pallas_call :154), with the
//   semantics of its plain-XLA twin _seq_stats_jnp (:92).
//
// What bounds it on the card: by bytes it would take 4.7 us at the
//   default tile (65,536 rows of 96 + 160 bytes at 3.35 TB/s).  The first
//   port of this kernel was bound by integer issue: it counted the 16
//   codes one at a time (~10 instructions and a popcount per code per 8
//   bases) on 8 lanes per read.  This one is about twice as fast (PERF.md
//   has its times with the card's name and power limit).  Counting is no
//   longer what holds it: with every length 0 (the rings fill, nothing is
//   counted) it takes nearly as long.  What holds it is the staging and
//   each warp's per-tile chain (wait, stride, row sums, stores), which
//   starts only when the warp's first tile has landed; a warp owns about
//   two tiles, so little of that chain overlaps the stream.
//
// What the design does about it (points 1-4 of the redesign):
// 1. Bit-sliced counting.  A 16-byte chunk (32 bases, four little-endian
//    words) is turned into four bit-planes by a 4x4 bit transpose inside
//    each nibble position (four masked swap steps): plane k holds bit k of
//    all 32 nibbles.  Four low-pair masks V & f(P0, P1) (V = valid bases)
//    and four high-pair masks g(P2, P3) are one logic op each; a code's
//    matches are one AND of a low and a high mask and one popcount per 32
//    bases (~80 instructions per chunk, against ~640 before).  GC is the
//    sum of the code-2, -4 and -6 counts.  Quals keep __dp4a.
// 2. Balanced work.  A tile is R whole rows (about 4 KB) and one warp's
//    work.  Its seq chunks (R * cs) and then its qual chunks (R * cq) form
//    one list that the warp's lanes stride over, so no lane idles through
//    a loop round while a neighbour counts; only the list's last round is
//    ragged.  Per-chunk counts land in the warp's shared memory, and
//    32 / R lanes per row add them up once the tile is done.
// 3. Asynchronous staging.  On the aligned path (SB, QB and the three base
//    pointers multiples of 16) every warp of a persistent grid has its own
//    kStages-deep shared-memory ring.  Its lane 0 fills a stage with three
//    1-D TMA bulk copies (seq rows, qual rows, lengths: a tile's rows are
//    contiguous) that complete on the stage's mbarrier, and refills it
//    with the warp's tile kStages ahead as soon as the warp is done reading
//    it: the next tiles' copies are in flight while the lanes count, no
//    lane stalls on its own loads, and warps wait on nothing but their own
//    data (one producer per block, with a block-wide release per tile,
//    was slower on the card).  A stage is sized in bytes (at least one
//    row); the wrapper fits the warps' rings in the 227 KB a block may use,
//    with fewer warps per block for wide rows, else takes the other path.
//    That path (odd widths, misaligned pointers) keeps the tiles and the
//    counting with direct loads and per-row shared atomics.
// 4. One launch.  The histogram needs no zeroed output: each block adds
//    (1 << 48 | its count) to a running 64-bit sum per bin in a scratch
//    buffer that the wrapper zeroes once per device and stream.  The block
//    whose add brings a bin's arrivals (the high 16 bits) to the grid size
//    holds that bin's total, writes it out and zeroes the sum for the next
//    launch.  No fence, no ticket, no second pass; exact past 2^24 bases.
// Rules kept from the reference: bases with index >= len count nowhere
// (nor do bases past 2*SB, quals past QB); the denominator is max(len, 1)
// even when len exceeds what the row holds; rows with len <= 0 give 0.
// gc and mean_qual are integer sums divided once in f32, so they equal the
// reference bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps of a block at most
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;       // ops/seq_stats.py STAGES
// Blocks per SM that the registers must allow (ops/seq_stats.py
// ALIGNED_BLOCKS_PER_SM, BLOCKS_PER_SM): an aligned block's rings take
// about 108 KB of shared memory at the default tile, so two fit.
constexpr int kMinBlocksAligned = 2;
constexpr int kMinBlocksDirect = 4;
constexpr int kCodes = 16;
constexpr uint32_t kNib = 0x11111111u;

struct Params {
  const uint8_t* seq;
  const uint8_t* qual;
  const int32_t* lengths;
  int64_t n, tiles;
  int sb, qb;                // row widths in bytes (< 2^30)
  int rows;                  // rows per tile (R <= 32): one warp's work
  int cs, cq;                // 16-byte chunks per seq / qual row
  int row_shift;             // log2 of the lanes that sum one row
  // One warp's region of dynamic shared memory, sized by
  // ops/seq_stats.py::k2_launch.  Aligned: a count buffer of R rows of
  // `pitch` u32, then kStages stages of `stage_bytes` from `stage_off`
  // on, each [R * SB seq | R * QB qual (qual_off) | R lengths (len_off)].
  // Direct: R gc and R quality sums.
  int warp_bytes;
  int pitch, stage_off, stage_bytes, qual_off, len_off;
  float* gc;
  float* mq;
  int32_t* hist;
  unsigned long long* scratch;   // 16 running (arrivals, count) pairs
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// one 1-D TMA copy of `bytes` (a multiple of 16) from global to shared
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Valid-base mask, in plane bit order, of a chunk's first nv bases.  Base
// i of a chunk is nibble m = 2 * ((i & 7) >> 1) + 1 - (i & 1) of word
// i >> 3, i.e. plane bit 4 * m + (i >> 3).
__device__ __forceinline__ uint32_t valid_mask(int nv) {
  if (nv >= 32) return 0xFFFFFFFFu;
  const int jp = nv >> 3, r = nv & 7, fb = r >> 1;
  uint32_t nm = kNib & ((1u << (8 * fb)) - 1u);
  if (r & 1) nm |= 0x10u << (8 * fb);
  return kNib * ((1u << jp) - 1u) | (nm << jp);
}

// Adds the codes of a chunk's valid bases to h; returns their GC count.
__device__ __forceinline__ uint32_t count_chunk(uint4 w, uint32_t v,
                                                uint32_t (&h)[kCodes]) {
  uint32_t a = w.x, b = w.y, c = w.z, d = w.w, t;
  // 4x4 bit transpose inside each nibble: a, b, c, d become planes P0..P3
  t = ((a >> 2) ^ c) & 0x33333333u; c ^= t; a ^= t << 2;
  t = ((b >> 2) ^ d) & 0x33333333u; d ^= t; b ^= t << 2;
  t = ((a >> 1) ^ b) & 0x55555555u; b ^= t; a ^= t << 1;
  t = ((c >> 1) ^ d) & 0x55555555u; d ^= t; c ^= t << 1;
  const uint32_t lo[4] = {v & ~a & ~b, v & a & ~b, v & ~a & b, v & a & b};
  const uint32_t hi[4] = {~c & ~d, c & ~d, ~c & d, c & d};
  uint32_t k[kCodes];
#pragma unroll
  for (int code = 0; code < kCodes; ++code) {
    k[code] = __popc(lo[code & 3] & hi[code >> 2]);
    h[code] += k[code];
  }
  return k[2] + k[4] + k[6];
}

__device__ __forceinline__ uint32_t keep_bytes(int nb) {
  return nb >= 4 ? 0xFFFFFFFFu : nb <= 0 ? 0u : (1u << (8 * nb)) - 1u;
}

// sum of a chunk's first nq (> 0) quality bytes
__device__ __forceinline__ uint32_t qual_chunk(uint4 q, int nq) {
  if (nq < 16) {
    q.x &= keep_bytes(nq);
    q.y &= keep_bytes(nq - 4);
    q.z &= keep_bytes(nq - 8);
    q.w &= keep_bytes(nq - 12);
  }
  uint32_t s = __dp4a(q.x, 0x01010101u, 0u);
  s = __dp4a(q.y, 0x01010101u, s);
  s = __dp4a(q.z, 0x01010101u, s);
  return __dp4a(q.w, 0x01010101u, s);
}

// bytes [j0, j0 + 16) of a row of `width` bytes, zero past the row
__device__ __forceinline__ uint4 load_bytes16(const uint8_t* row, int j0,
                                              int width) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (j0 + b < width)
      w[b >> 2] |= static_cast<uint32_t>(__ldg(row + j0 + b)) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Lane 0 of a warp: start the copies of tile t into a stage of its ring.
// Lengths that a bulk copy cannot take (a tail of < 4, or R not a
// multiple of 4) are stored by this lane before its arrive, whose release
// makes them visible to the waiters.
__device__ void issue_tile(const Params& p, int64_t t, uint8_t* stage,
                           uint64_t* bar) {
  const int64_t row0 = t * p.rows;
  const int rt = static_cast<int>(lmin(p.rows, p.n - row0));
  const int lb = p.rows % 4 == 0 ? (rt & ~3) : 0;
  int32_t* lens = reinterpret_cast<int32_t*>(stage + p.len_off);
  for (int r = lb; r < rt; ++r) lens[r] = __ldg(p.lengths + row0 + r);
  const uint32_t sbytes = static_cast<uint32_t>(rt) * p.sb;
  const uint32_t qbytes = static_cast<uint32_t>(rt) * p.qb;
  mbar_expect_tx(bar, sbytes + qbytes + 4u * lb);
  bulk_load(stage, p.seq + row0 * p.sb, sbytes, bar);
  bulk_load(stage + p.qual_off, p.qual + row0 * p.qb, qbytes, bar);
  if (lb) bulk_load(lens, p.lengths + row0, 4u * lb, bar);
}

// the (row, chunk) of flat index u in a list of rows of `per_row` chunks
__device__ __forceinline__ void split(int u, int per_row, int& row, int& k) {
  row = per_row ? u / per_row : 0;
  k = u - row * per_row;
}

// The first index >= total that lane visits striding by 32 from lane,
// minus total: where its walk goes on in the list that follows.
__device__ __forceinline__ int past(int lane, int total) {
  return lane < total ? lane + (total - lane + 31) / 32 * 32 - total
                      : lane - total;
}

// Every warp works alone: tiles of R rows go to the grid's warps round
// robin, and each warp's lane 0 keeps kStages of its tiles in flight in
// the warp's own ring while its lanes stride over a tile's seq chunks and
// then its qual chunks, then sum the rows and write gc and mean_qual.
template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kAligned ? kMinBlocksAligned
                                                     : kMinBlocksDirect)
seq_stats_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kWarps][kStages];
  __shared__ uint32_t block_hist[kCodes];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* region = smem + warp * p.warp_bytes;
  uint32_t* counts = reinterpret_cast<uint32_t*>(region);
  uint8_t* ring = region + p.stage_off;
  uint64_t* bar = full[warp];
  if (tid < kCodes) block_hist[tid] = 0;
  if (!kAligned)   // per-row sums take atomics; count buffers are stored
    for (int i = lane; i < 2 * p.rows; i += 32) counts[i] = 0;
  if (kAligned && lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int64_t nw = blockDim.x >> 5;
  const int64_t first_tile = blockIdx.x * nw + warp, stride = gridDim.x * nw;
  if (kAligned && lane == 0)
    for (int s = 0; s < kStages; ++s) {
      const int64_t t = first_tile + s * stride;
      if (t < p.tiles) issue_tile(p, t, ring + s * p.stage_bytes, &bar[s]);
    }

  // This lane's walk over a full tile: seq chunks lane, lane + 32, ...,
  // then on into the qual chunks.  One stride moves (sr rows, sk chunks)
  // or (qr, qk).
  const int sr = p.cs ? 32 / p.cs : 0, sk = 32 - sr * p.cs;
  const int qr = p.cq ? 32 / p.cq : 0, qk = 32 - qr * p.cq;
  int s_row0, s_k0, q_row_full, q_k_full;
  split(lane, p.cs, s_row0, s_k0);
  const int v_full = past(lane, p.rows * p.cs);
  split(v_full, p.cq, q_row_full, q_k_full);
  // After a tile, 1 << row_shift neighbouring lanes add up one row's
  // chunk counts and the first of them writes its gc and mean_qual.
  const int fin_row = lane >> p.row_shift;
  const int fin_part = lane & ((1 << p.row_shift) - 1);
  const int pitch = p.pitch;

  uint32_t h[kCodes];
#pragma unroll
  for (int c = 0; c < kCodes; ++c) h[c] = 0;
  int it = 0;
  for (int64_t t = first_tile; t < p.tiles; t += stride, ++it) {
    const int s = it % kStages;
    const int64_t row0 = t * p.rows;
    const int rt = static_cast<int>(lmin(p.rows, p.n - row0));
    uint8_t* stage = ring + s * p.stage_bytes;
    const int32_t* lens = kAligned
        ? reinterpret_cast<const int32_t*>(stage + p.len_off)
        : p.lengths + row0;
    if (kAligned) mbar_wait(&bar[s], (it / kStages) & 1);
    const bool live = fin_row < rt;
    const int my_len = live && fin_part == 0 ? lens[fin_row] : 0;

    // the tile's seq chunks, then its qual chunks, as one strided list
    const int total_s = rt * p.cs;
    const uint4* sv = reinterpret_cast<const uint4*>(stage);
    int u = lane, row = s_row0, k = s_k0;
    for (; u < total_s; u += 32) {
      const int nv = min(lens[row], 2 * p.sb) - 32 * k;
      uint32_t g = 0;
      if (nv > 0) {
        const uint4 w = kAligned
            ? sv[u]
            : load_bytes16(p.seq + (row0 + row) * p.sb, 16 * k, p.sb);
        g = count_chunk(w, valid_mask(nv), h);
      }
      if (kAligned) counts[row * pitch + k] = g;
      else if (g) atomicAdd(counts + row, g);
      k += sk; row += sr;
      if (k >= p.cs) { k -= p.cs; ++row; }
    }
    int v = v_full;
    row = q_row_full;
    k = q_k_full;
    if (rt < p.rows) {
      v = past(lane, total_s);
      split(v, p.cq, row, k);
    }
    const uint4* qv = reinterpret_cast<const uint4*>(stage + p.qual_off);
    for (const int total_q = rt * p.cq; v < total_q; v += 32) {
      const int nq = min(lens[row], p.qb) - 16 * k;
      uint32_t q = 0;
      if (nq > 0) {
        const uint4 w = kAligned
            ? qv[v]
            : load_bytes16(p.qual + (row0 + row) * p.qb, 16 * k, p.qb);
        q = qual_chunk(w, nq);
      }
      if (kAligned) counts[row * pitch + p.cs + k] = q;
      else if (q) atomicAdd(counts + p.rows + row, q);
      k += qk; row += qr;
      if (k >= p.cq) { k -= p.cq; ++row; }
    }
    __syncwarp();   // the stage is read; this tile's counts stand
    if (kAligned && lane == 0) {
      const int64_t next = t + kStages * stride;
      if (next < p.tiles) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue_tile(p, next, stage, &bar[s]);
      }
    }

    uint32_t g = 0, q = 0;
    if (kAligned) {
      if (live) {
        const uint32_t* r = counts + fin_row * pitch;
        for (int j = fin_part; j < p.cs; j += 1 << p.row_shift) g += r[j];
        for (int j = p.cs + fin_part; j < p.cs + p.cq; j += 1 << p.row_shift)
          q += r[j];
      }
      for (int o = 1; o < (1 << p.row_shift); o <<= 1) {
        g += __shfl_xor_sync(0xFFFFFFFFu, g, o);
        q += __shfl_xor_sync(0xFFFFFFFFu, q, o);
      }
    } else if (live) {
      g = counts[fin_row];
      q = counts[p.rows + fin_row];
      counts[fin_row] = 0;
      counts[p.rows + fin_row] = 0;
    }
    if (live && fin_part == 0) {
      const float denom = static_cast<float>(my_len > 1 ? my_len : 1);
      p.gc[row0 + fin_row] = static_cast<float>(g) / denom;
      p.mq[row0 + fin_row] = static_cast<float>(q) / denom;
    }
    __syncwarp();   // the sums are read before the next tile's counts
  }

  // histogram: warp sums, block sums, then one 64-bit atomic per bin
  // adds the block's count (low 48 bits) and one arrival (high 16 bits);
  // the block that arrives last at a bin holds its total, writes it out
  // and leaves the running sum at zero for the next launch
#pragma unroll
  for (int c = 0; c < kCodes; ++c) {
    const uint32_t v = __reduce_add_sync(0xFFFFFFFFu, h[c]);
    if (lane == 0 && v) atomicAdd(&block_hist[c], v);
  }
  __syncthreads();
  if (tid < kCodes) {
    const unsigned long long add = (1ull << 48) | block_hist[tid];
    const unsigned long long sum = atomicAdd(p.scratch + tid, add) + add;
    if (sum >> 48 == gridDim.x) {
      p.hist[tid] = static_cast<int32_t>(sum & ((1ull << 48) - 1));
      p.scratch[tid] = 0;
    }
  }
}

}  // namespace

// gc / mq are written for every row and hist for every bin; scratch holds
// 16 u64 that are zero between launches (zero them once, then reuse them
// on one stream).  rows, grid, warps, aligned and the sizes of a warp's
// shared memory (pitch, stage_off, stage_bytes, warp_bytes) come from
// ops/seq_stats.py::k2_launch.
extern "C" int hbam_seq_qual_stats(const void* seq, int64_t sb,
                                   const void* qual, int64_t qb,
                                   const void* lengths, int64_t n,
                                   void* gc, void* mq, void* hist,
                                   void* scratch, int32_t rows, int32_t grid,
                                   int32_t warps, int32_t aligned,
                                   int32_t pitch, int32_t stage_off,
                                   int32_t stage_bytes, int32_t warp_bytes,
                                   void* stream) {
  if (n <= 0) return 0;
  const int64_t smem = static_cast<int64_t>(warps) * warp_bytes;
  if (rows <= 0 || rows > 32 || warps <= 0 || warps > kWarps || grid <= 0 ||
      grid >= (1 << 16) || sb < 0 || qb < 0 || sb >= (1 << 30) ||
      qb >= (1 << 30) || warp_bytes <= 0 || smem > (227 << 10))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto misaligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  };
  if (aligned && (sb % 16 || qb % 16 || sb == 0 || qb == 0 ||
                  misaligned(seq) || misaligned(qual) || misaligned(lengths)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.seq = static_cast<const uint8_t*>(seq);
  p.qual = static_cast<const uint8_t*>(qual);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.sb = static_cast<int>(sb);
  p.qb = static_cast<int>(qb);
  p.n = n;
  p.rows = rows;
  p.tiles = (n + rows - 1) / rows;
  p.cs = static_cast<int>((sb + 15) / 16);
  p.cq = static_cast<int>((qb + 15) / 16);
  p.warp_bytes = warp_bytes;
  p.pitch = pitch;
  p.stage_off = stage_off;
  p.stage_bytes = stage_bytes;
  p.qual_off = rows * p.sb;
  p.len_off = rows * (p.sb + p.qb);
  // aligned: 2^row_shift <= 32 / rows lanes sum a row
  while (aligned && (2 << p.row_shift) * rows <= 32) ++p.row_shift;
  p.gc = static_cast<float*>(gc);
  p.mq = static_cast<float*>(mq);
  p.hist = static_cast<int32_t*>(hist);
  p.scratch = static_cast<unsigned long long*>(scratch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned) {
    // above 48 KB a block's dynamic shared memory has to be asked for
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    static int64_t granted[64];
    if (dev >= 64 || smem > granted[dev]) {
      e = cudaFuncSetAttribute(seq_stats_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < 64) granted[dev] = smem;
    }
    seq_stats_kernel<true><<<grid, 32 * warps, smem, st>>>(p);
  } else {
    seq_stats_kernel<false><<<grid, 32 * warps, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
