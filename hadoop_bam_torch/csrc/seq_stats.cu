// K2: per-read GC fraction, mean quality and base-code histogram over
// packed payload tiles, for Hopper (sm_90a).
//
// Replaces: hadoop_bam_tpu/ops/seq_pallas.py::seq_qual_stats (:127), i.e.
//   the Pallas kernel _seq_stats_kernel (:50, pallas_call :154), with the
//   semantics of its plain-XLA twin _seq_stats_jnp (:92).
//
// What bounds it on the card: bytes.  Each read's packed bases (SB bytes,
//   high nibble first), quals (QB bytes) and length are read once; two
//   floats per read and 16 ints per launch are written.  The arithmetic is
//   integer compare/popcount work that stays under the memory time at the
//   default widths (96 and 160 bytes per read).
//
// What the design does about it:
// - 8 threads per read, 32 reads per 256-thread block, a grid-stride loop
//   over reads.  Neighbouring reads are adjacent in memory, so a warp's
//   loads cover 4 contiguous rows; 16-byte loads when both strides and
//   both base pointers are multiples of 16 (the default 96/160 are),
//   otherwise 4-byte words assembled from byte loads (odd widths such as
//   16383).  Chunks wholly past a read's length are never read.
// - Bases are counted 8 at a time inside a 32-bit word: for code c,
//   x = w ^ (c * 0x11111111) has a zero nibble where the base equals c;
//   OR-folding x's nibbles and masking by the valid-base mask gives the
//   matches, one popcount per code.  Counts stay in registers.
// - GC (codes 2, 4, 6) and the quality sum are integer counts (quality
//   bytes summed with __dp4a), reduced over the 8 threads of a read with
//   shuffles, then divided once in f32 by max(len, 1).  Both sums are
//   exact below 2^24, so gc and mean_qual match the reference bit for bit.
// - The histogram: the TPU grid ran in order and carried it across grid
//   steps; here blocks run in parallel.  Each thread keeps 16 counters,
//   a warp reduces them, lanes 0 add into a shared int[16] per block, and
//   one atomicAdd per bin per block lands in the zeroed global int32
//   output — exact past 2^24 bases.
// Rules kept from the reference: bases with index >= len count nowhere
// (nor do bases past 2*SB, quals past QB); the denominator is max(len, 1)
// even when len exceeds what the row holds; rows with len <= 0 give 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                       // threads per read
constexpr int kRowsPerBlock = kThreads / kLanes;
constexpr int kCodes = 16;

// Valid-base mask of a word holding bases 0..7 of a chunk (base i sits in
// byte i/2, high nibble for even i): one bit at each valid nibble's bit 0.
__device__ __forceinline__ uint32_t nibble_mask(int nv) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < nv) m |= 1u << (8 * (i >> 1) + ((i & 1) ? 0 : 4));
  return m;
}

struct Acc {
  uint32_t hist[kCodes];
  uint32_t gc;
  uint32_t qsum;
};

// w holds packed bytes [j0, j0 + 4) of a read; bases [0, len) count
__device__ __forceinline__ void seq_word(Acc& a, uint32_t w, int64_t j0,
                                         int64_t len) {
  int64_t nv = len - 2 * j0;
  if (nv <= 0) return;
  const uint32_t m = nibble_mask(nv > 8 ? 8 : static_cast<int>(nv));
#pragma unroll
  for (int c = 0; c < kCodes; ++c) {
    const uint32_t x = w ^ (0x11111111u * static_cast<uint32_t>(c));
    const uint32_t nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & 0x11111111u;
    const uint32_t k = __popc(~nz & m);
    a.hist[c] += k;
    if (c == 2 || c == 4 || c == 6) a.gc += k;
  }
}

// q holds quality bytes [j0, j0 + 4) of a read; quals [0, len) count
__device__ __forceinline__ void qual_word(Acc& a, uint32_t q, int64_t j0,
                                          int64_t len) {
  int64_t nq = len - j0;
  if (nq <= 0) return;
  const uint32_t keep = nq >= 4 ? 0xFFFFFFFFu : ((1u << (8 * nq)) - 1u);
  a.qsum = __dp4a(q & keep, 0x01010101u, a.qsum);
}

__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int64_t j0,
                                              int64_t width) {
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (j0 + b < width) w |= static_cast<uint32_t>(row[j0 + b]) << (8 * b);
  return w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
seq_stats_kernel(const uint8_t* __restrict__ seq, int64_t sb,
                 const uint8_t* __restrict__ qual, int64_t qb,
                 const int32_t* __restrict__ lengths, int64_t n,
                 float* __restrict__ gc_out, float* __restrict__ mq_out,
                 int32_t* __restrict__ hist_out) {
  __shared__ uint32_t block_hist[kCodes];
  if (threadIdx.x < kCodes) block_hist[threadIdx.x] = 0;
  __syncthreads();

  Acc a;
#pragma unroll
  for (int c = 0; c < kCodes; ++c) a.hist[c] = 0;
  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;

  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
       base < n; base += static_cast<int64_t>(gridDim.x) * kRowsPerBlock) {
    const int64_t row = base + group;
    const bool live = row < n;
    const int64_t len = live ? lengths[row] : 0;
    a.gc = 0;
    a.qsum = 0;
    if (live && len > 0) {
      const uint8_t* s = seq + row * sb;
      const uint8_t* q = qual + row * qb;
      // bases and quals that the row holds and the length covers
      const int64_t sl = len < 2 * sb ? len : 2 * sb;
      const int64_t ql = len < qb ? len : qb;
      if (kVec) {
        for (int64_t k = lane; 32 * k < sl; k += kLanes) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(s) + k);
          seq_word(a, v.x, 16 * k, sl);
          seq_word(a, v.y, 16 * k + 4, sl);
          seq_word(a, v.z, 16 * k + 8, sl);
          seq_word(a, v.w, 16 * k + 12, sl);
        }
        for (int64_t k = lane; 16 * k < ql; k += kLanes) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + k);
          qual_word(a, v.x, 16 * k, ql);
          qual_word(a, v.y, 16 * k + 4, ql);
          qual_word(a, v.z, 16 * k + 8, ql);
          qual_word(a, v.w, 16 * k + 12, ql);
        }
      } else {
        for (int64_t j0 = 4 * lane; 2 * j0 < sl; j0 += 4 * kLanes)
          seq_word(a, load_word(s, j0, sb), j0, sl);
        for (int64_t j0 = 4 * lane; j0 < ql; j0 += 4 * kLanes)
          qual_word(a, load_word(q, j0, qb), j0, ql);
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      a.gc += __shfl_xor_sync(0xFFFFFFFFu, a.gc, off);
      a.qsum += __shfl_xor_sync(0xFFFFFFFFu, a.qsum, off);
    }
    if (live && lane == 0) {
      const float denom = static_cast<float>(len > 1 ? len : 1);
      gc_out[row] = static_cast<float>(a.gc) / denom;
      mq_out[row] = static_cast<float>(a.qsum) / denom;
    }
  }

#pragma unroll
  for (int c = 0; c < kCodes; ++c) {
    const uint32_t v = __reduce_add_sync(0xFFFFFFFFu, a.hist[c]);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&block_hist[c], v);
  }
  __syncthreads();
  if (threadIdx.x < kCodes && block_hist[threadIdx.x])
    atomicAdd(hist_out + threadIdx.x,
              static_cast<int32_t>(block_hist[threadIdx.x]));
}

}  // namespace

// hist must arrive zeroed; gc/mq are written for every row.
extern "C" int hbam_seq_qual_stats(const void* seq, int64_t sb,
                                   const void* qual, int64_t qb,
                                   const void* lengths, int64_t n,
                                   void* gc, void* mq, void* hist,
                                   int32_t max_blocks, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
    const bool vec = sb % 16 == 0 && qb % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(seq) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(qual) % 16 == 0;
    const auto s = static_cast<const uint8_t*>(seq);
    const auto q = static_cast<const uint8_t*>(qual);
    const auto l = static_cast<const int32_t*>(lengths);
    const auto g = static_cast<float*>(gc);
    const auto m = static_cast<float*>(mq);
    const auto h = static_cast<int32_t*>(hist);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (vec)
      seq_stats_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          s, sb, q, qb, l, n, g, m, h);
    else
      seq_stats_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          s, sb, q, qb, l, n, g, m, h);
  }
  return static_cast<int>(cudaGetLastError());
}
