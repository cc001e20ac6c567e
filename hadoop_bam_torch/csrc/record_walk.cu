// K9: the BAM record walk over a contiguous inflated buffer, for Hopper
// (sm_90a).
//
// Replaces hadoop_bam_tpu/ops/inflate_device.py::_walk_records_device
// (:176): the record chain offset[i+1] = offset[i] + 4 + block_size[i]
// walked from ``start`` by pointer doubling over a successor for every
// byte position, instead of a serial walk.
//
// In: buf [L] u8, total (device i32: bytes of buf that are data), start,
// stop, R.  Out: offs [R] i32 (the kept records in rank order, rows past
// min(n_all, R) zero) and walk [3] i32 = (n_all unclamped, tail, bad).
// Per position p, with bs the little-endian int32 at p (zeros past L):
//   bs_ok    = p + 4 <= total && 32 <= bs <= L
//   complete = bs_ok && p + 4 + bs <= total
//   next     = complete ? min(p + 4 + bs, L) : L   (L is the sink)
// reached = the chain from min(start, L); tail = min(total, least reached
// p that is not complete); bad = a reached p that is not complete has
// p + 4 <= total and bs < 32; kept = reached && complete && p < stop.
//
// Design (all launches on the caller's stream, no host synchronisation):
//   init     one pass over L + 1 positions: next (J), a flag byte
//            (complete, bad candidate), marks (start only);
//   round k  J'[p] = J[J[p]] into the other buffer, and marks pushed along
//            J: if m[p] then m[J[p]] = 1.  After round k every chain node
//            less than 2^(k+1) hops from start is marked (marks set early
//            are still chain nodes, so racing writes only add true ones).
//            ceil(log2(L / 36 + 2)) rounds always suffice (records are at
//            least 36 bytes apart); a round that adds no mark sets no
//            "changed" word, and every later round returns at once.
//   count    per tile of positions: kept count, atomicMin of tail,
//            atomicOr of bad;
//   scan     one block: exclusive scan of the tile counts, n_all;
//   write    each kept p to offs[tile base + rank in tile] when < R.
// Bound: bytes -- buf read once, offs written once.  The rounds read and
// write 4-byte successors for every position, which is what this simple
// design spends beyond that (see PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;   // positions per count/write block
                                      // (WALK_TILE in ops/inflate_device.py)
constexpr int kScanThreads = 1024;
constexpr uint8_t kComplete = 1, kBadSize = 2;

__device__ __forceinline__ int32_t le32(const uint8_t* buf, long long L,
                                        long long p) {
  uint32_t v = 0;
  for (int k = 3; k >= 0; --k) {
    const long long q = p + k;
    v = (v << 8) | (q < L ? buf[q] : 0u);
  }
  return static_cast<int32_t>(v);
}

__global__ void walk_init(const uint8_t* __restrict__ buf, long long L,
                          const int32_t* __restrict__ total_ptr,
                          long long start, int32_t* __restrict__ jump,
                          uint8_t* __restrict__ flags,
                          uint8_t* __restrict__ marks,
                          int32_t* __restrict__ changed, int rounds,
                          int32_t* __restrict__ walk) {
  const long long total = *total_ptr;
  const long long root = start < L ? start : L;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i == 0) {
    walk[0] = 0;
    walk[1] = static_cast<int32_t>(total);
    walk[2] = 0;
    changed[0] = 1;
    for (int k = 1; k <= rounds; ++k) changed[k] = 0;
  }
  if (i > L) return;
  marks[i] = i == root;
  if (i == L) {
    jump[L] = static_cast<int32_t>(L);
    return;
  }
  const bool has_size = i + 4 <= total;
  const int32_t bs = le32(buf, L, i);
  const bool bs_ok = has_size && bs >= 32 && bs <= L;
  const long long end = i + 4 + (bs_ok ? bs : 0);
  const bool complete = bs_ok && end <= total;
  flags[i] = (complete ? kComplete : 0) |
             (has_size && bs < 32 ? kBadSize : 0);
  jump[i] = static_cast<int32_t>(complete ? (end < L ? end : L) : L);
}

__global__ void walk_round(const int32_t* __restrict__ jump_in,
                           int32_t* __restrict__ jump_out,
                           uint8_t* marks, int32_t* changed, int k,
                           long long L) {
  if (!changed[k]) return;   // converged in an earlier round
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i > L) return;
  const int32_t j = jump_in[i];
  jump_out[i] = j == L ? j : jump_in[j];
  if (marks[i] && !marks[j]) {
    marks[j] = 1;
    changed[k + 1] = 1;
  }
}

// kept flag of position p
__device__ __forceinline__ bool kept_at(const uint8_t* flags,
                                        const uint8_t* marks, long long p,
                                        long long L, long long stop) {
  return p < L && marks[p] && (flags[p] & kComplete) && p < stop;
}

__global__ void walk_count(const uint8_t* __restrict__ flags,
                           const uint8_t* __restrict__ marks, long long L,
                           long long stop, int32_t* __restrict__ tile_count,
                           int32_t* walk) {
  const long long p0 = static_cast<long long>(blockIdx.x) * kTile +
                       4 * threadIdx.x;
  int kept = 0;
  int bad = 0;
  long long tail = -1;
  for (int k = 0; k < 4; ++k) {
    const long long p = p0 + k;
    if (p >= L || !marks[p]) continue;
    const uint8_t f = flags[p];
    if (f & kComplete) {
      kept += p < stop;
    } else {
      if (tail < 0) tail = p;
      bad |= (f & kBadSize) != 0;
    }
  }
  if (tail >= 0) atomicMin(&walk[1], static_cast<int32_t>(tail));
  if (bad) atomicOr(&walk[2], 1);
  __shared__ int warp_sum[kThreads / 32];
  int v = kept;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
    tile_count[blockIdx.x] = s;
  }
}

// exclusive scan of n tile counts in place; walk[0] = their sum
__global__ void walk_scan(int32_t* __restrict__ tile_count, int n,
                          int32_t* __restrict__ walk) {
  __shared__ int warp_tot[kScanThreads / 32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < n; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n ? tile_count[i] : 0;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int s = warp_tot[lane];
      int t = s;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
        if (lane >= o) t += y;
      }
      warp_tot[lane] = t - s;
    }
    __syncthreads();
    const int excl = carry + warp_tot[warp] + x - v;
    if (i < n) tile_count[i] = excl;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) walk[0] = carry;
}

__global__ void walk_write(const uint8_t* __restrict__ flags,
                           const uint8_t* __restrict__ marks, long long L,
                           long long stop,
                           const int32_t* __restrict__ tile_base, int R,
                           int32_t* __restrict__ offs) {
  __shared__ int warp_tot[kThreads / 32];
  const long long p0 = static_cast<long long>(blockIdx.x) * kTile +
                       4 * threadIdx.x;
  bool keep[4];
  int v = 0;
  for (int k = 0; k < 4; ++k) {
    keep[k] = kept_at(flags, marks, p0 + k, L, stop);
    v += keep[k];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kThreads / 32 ? warp_tot[lane] : 0;
    int t = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kThreads / 32) warp_tot[lane] = t - s;
  }
  __syncthreads();
  long long rank = static_cast<long long>(tile_base[blockIdx.x]) +
                   warp_tot[warp] + x - v;
  for (int k = 0; k < 4; ++k) {
    if (!keep[k]) continue;
    if (rank < R) offs[rank] = static_cast<int32_t>(p0 + k);
    ++rank;
  }
}

}  // namespace

// Scratch, allocated by the caller (ops/inflate_device.py::walk_scratch):
// jumps [2, L + 1] i32, bytes [2L + 1] u8 (flags, then marks), words
// [rounds + 1 + ceil(L / 1024)] i32 (changed words, then tile counts).
// ``rounds`` is ceil(log2(L / 36 + 2)), computed by the caller.
extern "C" int hbam_record_walk(const void* buf, int64_t L,
                                const void* total, int64_t start,
                                int64_t stop, int64_t R, int64_t rounds,
                                void* offs, void* walk, void* jumps,
                                void* bytes, void* words, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (L <= 0 || L >= (1LL << 31) - 8 || start < 0 || R < 0 || rounds < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (L + kTile - 1) / kTile;
  int32_t* jump_a = static_cast<int32_t*>(jumps);
  int32_t* jump_b = jump_a + (L + 1);
  uint8_t* flags = static_cast<uint8_t*>(bytes);
  uint8_t* marks = flags + L;
  int32_t* changed = static_cast<int32_t*>(words);
  int32_t* tile_count = changed + rounds + 1;
  int32_t* w = static_cast<int32_t*>(walk);
  const uint8_t* b = static_cast<const uint8_t*>(buf);

  if (R > 0) {
    cudaError_t err = cudaMemsetAsync(offs, 0, 4 * R, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((L + 1 + kThreads - 1) /
                                              kThreads);
  walk_init<<<grid, kThreads, 0, stream>>>(
      b, L, static_cast<const int32_t*>(total), start, jump_a, flags, marks,
      changed, static_cast<int>(rounds), w);
  for (int k = 0; k < rounds; ++k) {
    walk_round<<<grid, kThreads, 0, stream>>>(jump_a, jump_b, marks, changed,
                                              k, L);
    int32_t* t = jump_a;
    jump_a = jump_b;
    jump_b = t;
  }
  walk_count<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      flags, marks, L, stop, tile_count, w);
  walk_scan<<<1, kScanThreads, 0, stream>>>(tile_count,
                                            static_cast<int>(tiles), w);
  walk_write<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      flags, marks, L, stop, tile_count, static_cast<int>(R),
      static_cast<int32_t*>(offs));
  return static_cast<int>(cudaGetLastError());
}
