// K9: the BAM record walk over a contiguous inflated buffer, for Hopper
// (sm_90a).
//
// Replaces hadoop_bam_tpu/ops/inflate_device.py::_walk_records_device
// (:176): the record chain offset[i+1] = offset[i] + 4 + block_size[i]
// walked from ``start`` by pointer doubling, instead of a serial walk.
//
// In: buf [L] u8, total (device i32: bytes of buf that are data), start,
// stop, R.  Out: offs [R] i32 (the kept records in rank order, rows past
// min(n_all, R) zero) and walk [3] i32 = (n_all unclamped, tail, bad).
// Per position p, with bs the little-endian int32 at p (zeros past L):
//   bs_ok    = p + 4 <= total && 32 <= bs <= L
//   complete = bs_ok && p + 4 + bs <= total
//   next     = complete ? min(p + 4 + bs, L) : L   (L is the sink)
// reached = the chain from min(start, L); tail = min(total, the reached p
// that is not complete); bad = that p has p + 4 <= total and bs < 32;
// kept = reached && complete && p < stop.  A chain node is followed only
// when complete, so the one reached p that is not complete ends it.
//
// Only complete positions ("candidates", ~3.5% of a BAM's bytes) can be
// on the chain before its end, so the work runs over them, in tiles of
// kW positions (all launches on the caller's stream, no host sync):
//   A  walk_tiles, one CTA per tile: the tile's bytes staged in shared
//      memory by one bulk copy, a candidate bitmask by warp ballots and
//      per-word prefix counts, each candidate's successor when it is a
//      candidate of the same tile, pointer doubling in shared memory to
//      each candidate's exit: the position where its chain leaves the
//      tile or ends.  Jumps are indexed by position: a candidate's jump
//      is its exit when that is a candidate (of a later tile; its bytes
//      read from global memory), else -1.  Candidates with a jump are
//      listed per tile ("live"); the rest never move a mark.  The one
//      pass over all of buf.
//   B  walk_jump, `rounds` launches of radix-4 doubling over the live
//      candidates: a marked node marks the nodes 1, 2 and 3 jumps on and
//      its jump becomes the 4th.  Every jump leaves its tile for a later
//      one, so the path holds at most one candidate per tile (its entry
//      there) and 4^rounds >= tiles rounds mark all of them; a round that
//      adds no mark makes the later ones return at once.
//   C  walk_emit, per tile with an entry (staged again): the path walked
//      serially in shared memory from the entry, its kept positions
//      stored, and the term settled (also one past a long jump: the tile
//      that jumps there settles it); the last CTA to finish scans the
//      per-tile counts.  walk_write then writes offsets in rank order and
//      zeros past them.
// 3 + rounds launches.  Launch sizes and scratch: ops/inflate_device.py::
// walk_launch.  Bound: bytes -- buf's data bytes (min(L, total)) read
// once, offs written once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kW = 1 << 13;             // positions per tile (WALK_W)
constexpr int kWords = kW / 32;
constexpr int kAThreads = kWords;       // phase A: one mask word a thread
constexpr int kThreads = 256;           // phases B and C
constexpr int kMinRecord = 36;          // block_size field + 32-byte core
constexpr int kPathCap = (kW - 1) / kMinRecord + 1;
constexpr int kStage = kW + 16;         // a tile's bytes and the 3 after it
constexpr int kStageOff = 16;           // past the mbarrier
// phase A's shared memory: mbarrier, bytes, mask, prefix counts, local
// successors and the candidates' offsets (u16 each: W <= 65536)
constexpr int kASmem = kStageOff + kStage + 4 * kWords + 2 * kWords +
                       2 * kW + 2 * kW;
static_assert(kW % 32 == 0 && kW <= 65536 && (kW & (kW - 1)) == 0,
              "tile width");

struct Scratch {
  int32_t* jump_a;   // [E] by position: the candidate 4^k jumps on, or -1
  int32_t* jump_b;   // [E] (double buffer)
  int32_t* live;     // [E] per tile: the candidates with a jump
  int32_t* nlive;    // [T]
  int32_t* entry;    // [T] the path's first position in the tile, or -1
  int32_t* kcount;   // [T] kept path nodes per tile
  int32_t* kbase;    // [T] exclusive scan of kcount
  int32_t* path;     // [T * kPathCap] kept positions per tile
  int32_t* changed;  // [rounds + 1] a round added a mark
  int32_t* ticket;   // [1] phase C's finished CTAs
  uint8_t* marks;    // [E] by position
};

// a staged tile in offsets from its first position t0 (32-bit: L < 2^31)
struct TileView {
  const uint32_t* w;   // the staged bytes as words
  int lim;             // offsets inside buf: min(kW, L - t0)
  int rest;            // L - t0, the sink's offset
  uint32_t tr;         // total - t0, >= 4 in a staged tile
  int32_t L;
  __device__ __forceinline__ int32_t bs(int o) const {
    return static_cast<int32_t>(
        __funnelshift_r(w[o >> 2], w[(o >> 2) + 1], (o & 3) * 8));
  }
  // complete at offset o with block_size b (b >= 32 makes the unsigned
  // sum exact; p + 4 <= total follows from p + 4 + b <= total)
  __device__ __forceinline__ bool complete(int o, int32_t b) const {
    return o < lim && b >= 32 && b <= L &&
           static_cast<uint32_t>(o) + 4u + static_cast<uint32_t>(b) <= tr;
  }
};

__device__ __forceinline__ TileView tile_view(const uint8_t* bytes,
                                              long long L, long long total,
                                              long long t0) {
  TileView v;
  v.w = reinterpret_cast<const uint32_t*>(bytes);
  v.rest = static_cast<int>(L - t0);
  v.lim = v.rest < kW ? v.rest : kW;
  v.tr = static_cast<uint32_t>(total - t0);
  v.L = static_cast<int32_t>(L);
  return v;
}

// block_size at p from global memory, zeros past L
__device__ __forceinline__ int32_t le32_global(const uint8_t* buf,
                                               long long L, long long p) {
  uint32_t v = 0;
  for (int k = 3; k >= 0; --k)
    v = (v << 8) | (p + k < L ? buf[p + k] : 0u);
  return static_cast<int32_t>(v);
}

__device__ __forceinline__ bool complete_at(long long p, int32_t bs,
                                            long long L, long long total) {
  return p < L && p + 4 <= total && bs >= 32 && bs <= L &&
         p + 4 + bs <= total;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes [t0, t0 + kStage) of buf into dst (zeros past L): the 16-byte
// multiple by one bulk copy on an mbarrier when buf + t0 is 16-byte
// aligned, the rest by the threads
__device__ void stage_tile(uint8_t* dst, const uint8_t* buf, long long L,
                           long long t0, uint64_t* bar) {
  const long long avail = L - t0;
  const int n = avail < kStage ? static_cast<int>(avail) : kStage;
  const uint8_t* src = buf + t0;
  const int n16 =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? (n & ~15) : 0;
  if (threadIdx.x == 0 && n16 > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_u32(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(smem_u32(bar)),
                 "r"(n16)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(n16), "r"(smem_u32(bar))
        : "memory");
  }
  for (int i = n16 + threadIdx.x; i < kStage; i += blockDim.x)
    dst[i] = i < n ? src[i] : 0;
  __syncthreads();
  if (n16 > 0) {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
          "[%1], 0; selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(smem_u32(bar))
          : "memory");
  }
}

// position x (global) is a candidate
__device__ __forceinline__ bool candidate_global(const uint8_t* buf,
                                                 long long L, long long total,
                                                 long long x) {
  return x < L && complete_at(x, le32_global(buf, L, x), L, total);
}

// exclusive block scan of one int per thread; *sum gets the total
template <int kN>
__device__ int block_excl_scan(int v, int* warp_tot, int* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kN / 32 ? warp_tot[lane] : 0;
    int t = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kN / 32) warp_tot[lane] = t - w;
    if (lane == kN / 32 - 1) *sum = t;
  }
  __syncthreads();
  return warp_tot[warp] + x - v;
}

__global__ void __launch_bounds__(kAThreads, 2)
    walk_tiles(const uint8_t* __restrict__ buf, long long L,
               const int32_t* __restrict__ total_ptr, long long start,
               int rounds, Scratch s, int32_t* __restrict__ walk) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* bytes = smem + kStageOff;
  uint32_t* mask = reinterpret_cast<uint32_t*>(bytes + kStage);
  uint16_t* pref = reinterpret_cast<uint16_t*>(mask + kWords);
  uint16_t* ptr = pref + kWords;
  uint16_t* pos = ptr + kW;
  __shared__ int warp_tot[32];
  __shared__ int count, root, nlive;

  const long long total = *total_ptr;
  const int t = blockIdx.x;
  const long long t0 = static_cast<long long>(t) * kW;
  const int tid = threadIdx.x;
  if (t == 0 && tid == 0) {
    walk[0] = 0;
    walk[1] = static_cast<int32_t>(total);
    walk[2] = 0;
    s.changed[0] = 1;
    for (int k = 1; k <= rounds; ++k) s.changed[k] = 0;
    s.ticket[0] = 0;
  }
  if (t0 + 4 > total) {   // no position here has a readable block_size
    if (tid == 0) {
      s.nlive[t] = 0;
      s.entry[t] = -1;
    }
    return;
  }
  stage_tile(bytes, buf, L, t0, bar);
  const TileView v = tile_view(bytes, L, total, t0);

  // candidate bits: warp w reads words 32w .. 32w + 31, lane l keeps word
  // 32w + l (= tid)
  const int lane = tid & 31, warp = tid >> 5;
  uint32_t mine = 0;
  for (int i = 0; i < 32; ++i) {
    const int off = (warp * 32 + i) * 32 + lane;
    const uint32_t word =
        __ballot_sync(0xFFFFFFFFu, v.complete(off, v.bs(off)));
    if (lane == i) mine = word;
  }
  mask[tid] = mine;
  if (tid == 0) {
    root = -1;
    nlive = 0;
  }
  int idx = block_excl_scan<kAThreads>(__popc(mine), warp_tot, &count);
  pref[tid] = static_cast<uint16_t>(idx);
  __syncthreads();

  // each candidate's offset and local successor (itself when its next
  // node leaves the tile or is not a candidate)
  for (uint32_t m = mine; m; m &= m - 1, ++idx) {
    const int off = tid * 32 + __ffs(m) - 1;
    const long long p = t0 + off;
    const uint32_t n = off + 4u + static_cast<uint32_t>(v.bs(off));
    uint16_t succ = static_cast<uint16_t>(idx);
    if (n < static_cast<uint32_t>(v.lim)) {
      const int no = static_cast<int>(n);
      const uint32_t nm = mask[no >> 5];
      const uint32_t bit = no & 31;
      if ((nm >> bit) & 1u)
        succ = static_cast<uint16_t>(pref[no >> 5] +
                                     __popc(nm & ((1u << bit) - 1u)));
    }
    pos[idx] = static_cast<uint16_t>(off);
    ptr[idx] = succ;
    if (p == start) root = static_cast<int>(p);
  }
  __syncthreads();

  // local pointer doubling, in place.  Safe: ptr[i] is only ever a node
  // of i's own chain at or past its old value, whichever of a racing
  // old or new ptr[ptr[i]] a thread reads, so after round k every ptr is
  // at least 2^k hops on or at its chain's last node (u16 shared stores
  // do not tear).  It ends when a round moves nothing.
  const int c = count;
  for (;;) {
    bool moved = false;
    for (int i = tid; i < c; i += kAThreads) {
      const uint16_t j = ptr[i];
      const uint16_t jj = ptr[j];
      if (jj != j) {
        ptr[i] = jj;
        moved = true;
      }
    }
    if (!__syncthreads_or(moved)) break;
  }

  // each candidate's jump: its exit when that is a candidate (it lies in
  // a later tile: an exit inside the tile is not one), else -1
  int32_t* live = s.live + static_cast<long long>(t) * kW;
  for (int i = tid; i < c; i += kAThreads) {
    const long long p = t0 + pos[i];
    const int off = pos[ptr[i]];
    const uint32_t xo = off + 4u + static_cast<uint32_t>(v.bs(off));
    const long long x = t0 + xo;
    const int32_t j = xo >= static_cast<uint32_t>(kW) &&
                              candidate_global(buf, L, total, x)
                          ? static_cast<int32_t>(x)
                          : -1;
    s.jump_a[p] = j;
    s.jump_b[p] = j;
    s.marks[p] = p == start;
    if (j >= 0) live[atomicAdd(&nlive, 1)] = static_cast<int32_t>(p);
  }
  __syncthreads();
  if (tid == 0) {
    s.nlive[t] = nlive;
    s.entry[t] = root;
  }
}

// one radix-4 round over the live candidates.  Jumps are double-buffered
// (an in-place jump could overshoot a node that then never gets its
// mark); marks are in place (a mark read early is still a path node).
// A candidate that is not live reads -1 in both buffers.
__global__ void __launch_bounds__(kThreads)
    walk_jump(Scratch s, const int32_t* __restrict__ in,
              int32_t* __restrict__ out, int k) {
  if (!s.changed[k]) return;   // converged in an earlier round
  const int t = blockIdx.x;
  const int n = s.nlive[t];
  const int32_t* live = s.live + static_cast<long long>(t) * kW;
  bool added = false;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int32_t c = live[i];
    const bool marked = s.marks[c];
    int32_t j = in[c];
    for (int h = 0; h < 3 && j >= 0; ++h) {
      if (marked && !s.marks[j]) {
        s.marks[j] = 1;
        s.entry[j / kW] = j;
        added = true;
      }
      j = in[j];
    }
    out[c] = j;
  }
  if (added) s.changed[k + 1] = 1;
}

// the chain's one reached position that is not complete
__device__ void settle_term(const uint8_t* buf, long long L, long long total,
                            long long term, int32_t* walk) {
  atomicMin(&walk[1], static_cast<int32_t>(term));
  if (term + 4 <= total && le32_global(buf, L, term) < 32)
    atomicOr(&walk[2], 1);
}

__global__ void __launch_bounds__(kThreads)
    walk_emit(const uint8_t* __restrict__ buf, long long L,
              const int32_t* __restrict__ total_ptr, long long start,
              long long stop, int tiles, Scratch s, int32_t* walk) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint8_t* bytes = smem + kStageOff;
  __shared__ int warp_tot[32];
  __shared__ int carry, sum;
  __shared__ bool last;
  const long long total = *total_ptr;
  const int t = blockIdx.x;
  const long long t0 = static_cast<long long>(t) * kW;
  const int e = s.entry[t];
  if (e >= 0) {
    stage_tile(bytes, buf, L, t0, bar);
    if (threadIdx.x == 0) {
      const TileView v = tile_view(bytes, L, total, t0);
      const long long sr = stop - t0;
      const int stop_o = sr < 0 ? 0 : (sr > kW ? kW : static_cast<int>(sr));
      int32_t* path = s.path + static_cast<long long>(t) * kPathCap;
      int o = static_cast<int>(e - t0);
      int32_t b = v.bs(o);
      int kept = 0;
      long long term = -1;
      for (;;) {   // o is a complete node of this tile, b its block_size
        if (o < stop_o) path[kept++] = static_cast<int32_t>(t0 + o);
        const uint32_t n = o + 4u + static_cast<uint32_t>(b);
        if (n >= static_cast<uint32_t>(v.rest)) break;   // the sink
        if (n < static_cast<uint32_t>(kW)) {
          b = v.bs(static_cast<int>(n));
          if (v.complete(static_cast<int>(n), b)) {
            o = static_cast<int>(n);
            continue;
          }
          term = t0 + n;
        } else if (!candidate_global(buf, L, total, t0 + n)) {
          term = t0 + n;   // in a tile this jump skips into: settled here
        }
        break;
      }
      s.kcount[t] = kept;
      if (term >= 0) settle_term(buf, L, total, term, walk);
    }
  } else if (threadIdx.x == 0) {
    s.kcount[t] = 0;
  }
  if (threadIdx.x == 0 && start < L && start / kW == t &&
      !candidate_global(buf, L, total, start))
    settle_term(buf, L, total, start, walk);   // the path is start alone

  // the last CTA to finish scans the kept counts
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(s.ticket, 1) == tiles - 1;
    carry = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = 0; b < tiles; b += kThreads) {
    const int i = b + threadIdx.x;
    const int v = i < tiles ? __ldcg(&s.kcount[i]) : 0;
    const int x = block_excl_scan<kThreads>(v, warp_tot, &sum);
    if (i < tiles) s.kbase[i] = carry + x;
    __syncthreads();
    if (threadIdx.x == 0) carry += sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) walk[0] = carry;
}

__global__ void __launch_bounds__(kThreads)
    walk_write(Scratch s, const int32_t* __restrict__ walk, long long R,
               int tiles, int32_t* __restrict__ offs) {
  const int t = blockIdx.x;
  const int n = s.kcount[t];
  const long long base = s.kbase[t];
  const int32_t* path = s.path + static_cast<long long>(t) * kPathCap;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (base + i < R) offs[base + i] = path[i];
  const long long n_all = walk[0];
  for (long long r = (n_all < R ? n_all : R) +
                     static_cast<long long>(t) * kThreads + threadIdx.x;
       r < R; r += static_cast<long long>(tiles) * kThreads)
    offs[r] = 0;
}

}  // namespace

// Launch sizes and scratch from ops/inflate_device.py::walk_launch
// (``W``, ``tiles``, ``rounds``, ``path_cap``; ``words`` int32 [n_words]
// and ``marks`` u8 [n_marks] in the layout below): sizes that do not fit
// this build's tile or this L, or scratch too small, are an invalid value.
extern "C" int hbam_record_walk(const void* buf, int64_t L,
                                const void* total, int64_t start,
                                int64_t stop, int64_t R, void* offs,
                                void* walk, void* words, int64_t n_words,
                                void* marks, int64_t n_marks, int64_t W,
                                int64_t tiles, int64_t rounds,
                                int64_t path_cap, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (L <= 0 || L >= (1LL << 31) - kW || start < 0 || R < 0 || W != kW ||
      path_cap != kPathCap || tiles != (L + kW - 1) / kW || rounds < 0 ||
      rounds > 16 || (1LL << (2 * rounds)) < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t E = tiles * kW;
  if (n_words < 3 * E + 4 * tiles + tiles * kPathCap + rounds + 2 ||
      n_marks < E)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = static_cast<int>(tiles);
  int32_t* w = static_cast<int32_t*>(words);
  Scratch s;
  s.jump_a = w;
  s.jump_b = s.jump_a + E;
  s.live = s.jump_b + E;
  s.nlive = s.live + E;
  s.entry = s.nlive + tiles;
  s.kcount = s.entry + tiles;
  s.kbase = s.kcount + tiles;
  s.path = s.kbase + tiles;
  s.changed = s.path + static_cast<int64_t>(tiles) * kPathCap;
  s.ticket = s.changed + rounds + 1;
  s.marks = static_cast<uint8_t*>(marks);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const int32_t* tot = static_cast<const int32_t*>(total);
  int32_t* out = static_cast<int32_t*>(walk);

  cudaError_t err = cudaFuncSetAttribute(
      walk_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, kASmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_tiles<<<T, kAThreads, kASmem, stream>>>(
      b, L, tot, start, static_cast<int>(rounds), s, out);
  int32_t* in = s.jump_a;
  int32_t* nxt = s.jump_b;
  for (int k = 0; k < static_cast<int>(rounds); ++k) {
    walk_jump<<<T, kThreads, 0, stream>>>(s, in, nxt, k);
    int32_t* tmp = in;
    in = nxt;
    nxt = tmp;
  }
  walk_emit<<<T, kThreads, kStageOff + kStage, stream>>>(b, L, tot, start,
                                                         stop, T, s, out);
  walk_write<<<T, kThreads, 0, stream>>>(s, out, R, T,
                                         static_cast<int32_t*>(offs));
  return static_cast<int>(cudaGetLastError());
}
