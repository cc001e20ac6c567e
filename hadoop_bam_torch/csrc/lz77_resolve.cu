// K7+K8: LZ77 token resolve + contiguous pack, for Hopper (sm_90a).
//
// Replaces hadoop_bam_tpu/ops/inflate_device.py::resolve_tokens (:98, the
// scatter-marks + cumsum + take_along_axis token expansion and the
// pointer-doubling while_loop) fused with _pack_contiguous (:144, the
// cumsum + searchsorted slice/pack), as resolve_tokens_packed (:165) runs
// them.  Token format (from native/hbam_native.cpp's tokenizer): bit 31
// set is a copy, length in bits 16-24, distance - 1 in bits 0-15; bit 31
// clear is a literal byte in bits 0-7.
//
// In: tokens [B, T] u32, n_tokens [B] i32, isize [B] i32, P (bytes per
// block row, P <= 65536).  Out: out [B*P] u8 holding block b's first
// iz[b] = clamp(isize[b], 0, P) resolved bytes at ubase[b] = sum of iz[<b],
// zeros from total = sum of iz to B*P; total_out [1] i32.
//
// Bound: bytes.  The tokens are read once, the counts and sizes once, the
// [B x P] buffer written once: 4,111,716 B at the main path's chunk (17
// BGZF blocks shipped as 32 rows of 29,952 tokens, P = 65,536), 0.0012 ms
// at 3.35 TB/s.  Everything else stays in shared memory.
//
// The kernel this one replaced ran one 1024-thread CTA per row with 192 KiB
// of shared memory: 17 of 132 SMs busy at the main path's chunk, the tokens
// expanded 1,024 at a time in ~30 dependent steps, and doubling passes over
// all 65,536 positions.  Here one thread block cluster of C CTAs takes a
// row (ops/inflate_device.py::resolve_launch sets C, the segment S, the
// threads, the window and the shared memory; this entry point checks
// them).  CTA r owns positions [r*S, (r+1)*S): a u16 source pointer and a
// byte per position, and a window for the row's bytes before them.
//   1. Tokens: CTA r takes the r-th of C equal shares of the row's tokens;
//      the CTAs' token lengths are exchanged under one cluster barrier.
//      Then each warp takes 32 * kTok tokens (lane l the l-th of every 32,
//      coalesced), one warp scan a round of 32 and one block scan place
//      them.  One pass for the main path's rows.
//   2. The bytes of each round's tokens of at most kLong bytes are written
//      32 a step, each lane finding its byte's token by a binary search
//      over the lanes; longer tokens are queued and written a warp each,
//      so 258-byte copies neither serialise a lane nor idle a warp.  A
//      literal points at itself; a copy byte p points at p - d or, where
//      p - d falls inside the same copy, at the same byte of the period
//      before it (start - d + (p - start) % d), so a run is one hop from
//      its source.  A position of another CTA is written through
//      distributed shared memory.  Bytes past the tokens' total take the
//      last token.
//   3. Doubling inside the segment until __syncthreads_or sees no change; a
//      pointer that leaves the segment stops.  The pointers form a forest
//      rooted at literals (a copy's source is earlier), so a racing read
//      only jumps less far.  The positions with a root in the segment take
//      its literal.
//   4. The positions whose pointer left, in rank order: a CTA's bytes are
//      final once its own such positions are; it then pushes them with one
//      bulk copy to each later CTA, completing on that CTA's mbarrier.  A
//      CTA with such positions waits for its window and reads them there.
//      This chain of C - 1 hand-offs, not bytes, is what C trades against
//      the SMs a row keeps busy.
//   5. out[ubase + p] in 16-byte stores with a head and a tail per segment;
//      the zeros past total are 16-byte stores too, one S-byte stripe per
//      CTA.
//
// Tokens past a row's total length follow the reference's rule: bytes in
// [sum of token lengths, iz) take the last token (index n_nonzero - 1,
// clipped to [0, T - 1]).  Zero-length tokens never come from the
// tokenizer; the kernel treats them as the bytes they cover (none).  A
// row whose iz is 0 reads no token (the pad rows of a chunk are never
// written).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kTok = 8;          // RESOLVE_TOKENS_PER_THREAD
constexpr int kMaxCluster = 16;
constexpr int kMinSegment = 64;  // RESOLVE_MIN_SEGMENT
constexpr int kMaxPerThread = 64;
constexpr int kMaxP = 1 << 16;   // BGZF's cap on a block's inflated size
constexpr int kLong = 32;        // longer tokens are written a warp each
constexpr int kQueue = kMaxP / (kLong + 1) + 1;
constexpr int kMaxSmem = 3 * kMaxP;   // C = 1: S = 65,536, no window;
                                      // (C + 2) * S below it for C > 1
constexpr int kStamps = 9;       // clock64 stamps per CTA (phase split)
constexpr uint32_t kNoToken = 0x80000000u;   // a copy of length 0

// The phase split: thread 0 of each CTA records clock64() at the phase
// boundaries when the caller passes a buffer (chip_smoke.py's timings);
// nullptr on the main path.
__device__ __forceinline__ void stamp(long long* clocks, int k) {
  if (clocks != nullptr && threadIdx.x == 0)
    clocks[static_cast<long long>(blockIdx.x) * kStamps + k] = clock64();
}

__device__ __forceinline__ int token_length(uint32_t w) {
  return (w >> 31) ? static_cast<int>((w >> 16) & 0x1FFu) : 1;
}

// Position p under token w, which starts at `start`: a literal points at
// itself and holds its byte; a copy byte points at p - d (clipped at 0,
// as the reference clips) or, where p - d falls inside the copy itself,
// at the same byte of the period before the copy, start - d +
// (p - start) % d, so a run of one byte is one hop from its source
// instead of a chain.  A position of this CTA's segment is a shared
// store; another CTA's goes through distributed shared memory.
__device__ __forceinline__ void write_byte(
    uint16_t* src, uint8_t* lit, uint16_t* const* src_of,
    uint8_t* const* lit_of, int r, int shift, uint32_t w, int start, int p) {
  const int o = p >> shift, q = p & ((1 << shift) - 1);
  uint16_t* sp = o == r ? src + q : src_of[o] + q;
  uint8_t* lp = o == r ? lit + q : lit_of[o] + q;
  if (w >> 31) {
    const int d = static_cast<int>(w & 0xFFFFu) + 1;
    *sp = static_cast<uint16_t>(start >= d && p - d >= start
                                    ? start - d + (p - start) % d
                                    : max(p - d, 0));
    if (p == 0) *lp = 0;           // a copy at 0 is its own root
  } else {
    *sp = static_cast<uint16_t>(p);
    *lp = static_cast<uint8_t>(w & 0xFFu);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `p`'s counterpart in CTA `rank`.
__device__ __forceinline__ uint32_t cluster_u32(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
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

// Block-wide sum of two 64-bit values; every thread gets both sums.
__device__ void block_sum2(long long& a, long long& b, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, o);
    b += __shfl_down_sync(0xFFFFFFFFu, b, o);
  }
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < warps ? scratch[lane] : 0;
    b = lane < warps ? scratch[32 + lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xFFFFFFFFu, a, o);
      b += __shfl_down_sync(0xFFFFFFFFu, b, o);
    }
    if (lane == 0) {
      scratch[0] = a;
      scratch[32] = b;
    }
  }
  __syncthreads();
  a = scratch[0];
  b = scratch[32];
  __syncthreads();
}

// Exclusive scan of one 64-bit value per thread over the block; *sum gets
// the total.  Ends with a barrier, so the scratch may be reused right
// after.
__device__ long long block_exclusive_scan(long long v, long long* warp_tot,
                                          long long* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const long long s = lane < warps ? warp_tot[lane] : 0;
    long long t = s;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, t, o);
      if (lane >= o) t += y;
    }
    warp_tot[lane] = t - s;
    if (lane == 31) warp_tot[32] = t;
  }
  __syncthreads();
  const long long r = warp_tot[warp] + x - v;
  *sum = warp_tot[32];
  __syncthreads();
  return r;
}

// Zeros over out[lo, hi): 16-byte stores between a head and a tail.
__device__ void zero_range(uint8_t* out, long long lo, long long hi) {
  if (lo >= hi) return;
  const long long head = min(hi - lo, static_cast<long long>(
      (16 - (reinterpret_cast<uintptr_t>(out + lo) & 15)) & 15));
  const long long a0 = lo + head;
  const long long n16 = (hi - a0) >> 4;
  const long long tail = a0 + (n16 << 4);
  if (threadIdx.x < head) out[lo + threadIdx.x] = 0;
  if (threadIdx.x < hi - tail) out[tail + threadIdx.x] = 0;
  for (long long c = threadIdx.x; c < n16; c += blockDim.x)
    *reinterpret_cast<uint4*>(out + a0 + (c << 4)) = make_uint4(0, 0, 0, 0);
}

// One pass of a CTA's token share from token p0: warp v takes the
// 32 * kTok tokens from p0 + 32 * kTok * v, lane l the l-th of each 32
// (coalesced loads; kNoToken past `end`).  at[j] gets each token's start
// in the pass, *pass_len and *pass_nz the pass's total length and its
// non-empty tokens.
__device__ void scan_pass(const uint32_t* row, int p0, int end,
                          uint32_t (&w)[kTok], int (&at)[kTok],
                          int& pass_len, int& pass_nz, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = p0 + warp * (32 * kTok) + lane;
  int run = 0, nz = 0;
#pragma unroll
  for (int j = 0; j < kTok; ++j) {
    const int t = first + 32 * j;
    w[j] = t < end ? row[t] : kNoToken;
    const int l = token_length(w[j]);
    int x = l;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    at[j] = run + x - l;
    run += __shfl_sync(0xFFFFFFFFu, x, 31);
    nz += __popc(__ballot_sync(0xFFFFFFFFu, l > 0));
  }
  long long sum;
  const long long e = block_exclusive_scan(
      lane == 0 ? static_cast<long long>(run) |
                      (static_cast<long long>(nz) << 32)
                : 0,
      scratch, &sum);
  const int off = static_cast<int>(
      __shfl_sync(0xFFFFFFFFu, e, 0) & 0xFFFFFFFFll);
#pragma unroll
  for (int j = 0; j < kTok; ++j) at[j] += off;
  pass_len = static_cast<int>(sum & 0xFFFFFFFFll);
  pass_nz = static_cast<int>(sum >> 32);
}

__global__ void __launch_bounds__(kMaxThreads)
lz77_resolve_kernel(const uint32_t* __restrict__ tokens,
                    const int32_t* __restrict__ n_tokens,
                    const int32_t* __restrict__ isize, int B, int T, int P,
                    int shift, uint8_t* __restrict__ out,
                    int32_t* __restrict__ total_out, long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 1 << shift;
  uint16_t* src = reinterpret_cast<uint16_t*>(smem);   // [S]
  uint8_t* lit = smem + 2 * static_cast<size_t>(S);    // [S]
  uint8_t* win = lit + S;   // [r * S]: the row's bytes before the segment
  __shared__ uint16_t* src_of[kMaxCluster];
  __shared__ uint8_t* lit_of[kMaxCluster];
  __shared__ long long scratch[64];
  __shared__ int seg_info[2];    // this CTA's token length and non-empty
  __shared__ int row_info[3];    // its first position, the row's totals
  // step 2: the pass's tokens of more than kLong bytes: their disjoint
  // spans inside [0, iz) hold at most 65,536 bytes, so fewer than kQueue
  __shared__ int n_long;
  __shared__ int long_at[kQueue];
  __shared__ uint32_t long_w[kQueue];
  __shared__ __align__(8) uint64_t win_bar;   // step 4: window complete

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;
  stamp(clocks, 0);

  // ubase[b] and total from the clamped sizes of all rows
  long long base = 0, total = 0;
  for (int i = tid; i < B; i += nt) {
    const long long iz = min(max(isize[i], 0), P);
    total += iz;
    if (i < b) base += iz;
  }
  block_sum2(base, total, scratch);
  if (blockIdx.x == 0 && tid == 0) *total_out = static_cast<int32_t>(total);

  // zeros past total: one S-byte stripe of out per CTA
  const long long stripe = static_cast<long long>(blockIdx.x) * S;
  zero_range(out, max(stripe, total),
             min(stripe + S, static_cast<long long>(B) * P));

  stamp(clocks, 1);
  const int iz = min(max(isize[b], 0), P);
  if (iz == 0) return;   // uniform over the cluster: no shared memory used

  if (tid < C) {
    src_of[tid] = cluster.map_shared_rank(src, tid);
    lit_of[tid] = cluster.map_shared_rank(lit, tid);
  }

  // 1. this CTA's share of the row's tokens: their lengths, summed
  const uint32_t* row = tokens + static_cast<long long>(b) * T;
  const int n = min(max(n_tokens[b], 0), T);
  const int share = (n + C - 1) / C;
  const int t_lo = min(r * share, n), t_hi = min(t_lo + share, n);
  const int per_pass = nt * kTok;
  long long cta_len = 0, cta_nz = 0;
  for (int t = t_lo + tid; t < t_hi; t += nt) {
    const int l = token_length(row[t]);
    cta_len += l;
    cta_nz += l > 0;
  }
  block_sum2(cta_len, cta_nz, scratch);
  // the CTAs' totals across the cluster; the window's barrier expects
  // the row's bytes before the segment, [0, lo), from the earlier CTAs
  const int lo = r * S;
  if (tid == 0) {
    seg_info[0] = static_cast<int>(cta_len);
    seg_info[1] = static_cast<int>(cta_nz);
    n_long = 0;
    if (lo > 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(&win_bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_u32(&win_bar)), "r"(lo)
                   : "memory");
    }
  }
  cluster.sync();
  if (tid < 32) {
    int len = 0, nz = 0;
    if (tid < C) {
      const int* other = cluster.map_shared_rank(seg_info, tid);
      len = other[0];
      nz = other[1];
    }
    int before = tid < r ? len : 0;
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_down_sync(0xFFFFFFFFu, before, o);
      len += __shfl_down_sync(0xFFFFFFFFu, len, o);
      nz += __shfl_down_sync(0xFFFFFFFFu, nz, o);
    }
    if (tid == 0) {
      row_info[0] = before;
      row_info[1] = len;
      row_info[2] = nz;
    }
  }
  __syncthreads();
  const int row_total = row_info[1], row_nz = row_info[2];
  stamp(clocks, 2);

  // 2. every token's positions into the CTA that owns them: shared
  // stores for this CTA's segment, distributed shared memory for another's
  const int lane = tid & 31;
  const int hi = min(lo + S, iz);
  int pass_start = row_info[0];
  for (int p0 = t_lo; p0 < t_hi; p0 += per_pass) {
    uint32_t w[kTok];
    int at[kTok], plen, pnz;
    scan_pass(row, p0, t_hi, w, at, plen, pnz, scratch);
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      // the warp's j-th 32 tokens: the bytes of those of at most kLong
      // bytes (clipped to iz), 32 a step; the longer ones are queued
      const int a = pass_start + at[j];
      const int cl = max(min(a + token_length(w[j]), iz) - a, 0);
      const bool queued = cl > kLong;
      if (queued) {
        const int k = atomicAdd(&n_long, 1);
        long_at[k] = a;
        long_w[k] = w[j];
      }
      const int sl = queued ? 0 : cl;
      int x = sl;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
      }
      const int so = x - sl;       // this lane's first short byte
      const int n_short = __shfl_sync(0xFFFFFFFFu, x, 31);
      for (int c = 0; c < n_short; c += 32) {
        // byte c + lane's token: the last lane whose first short byte is
        // at or before it, by binary search over the lanes
        const int k = c + lane;
        int L = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int oc = __shfl_sync(0xFFFFFFFFu, so, L + step);
          if (oc <= k) L += step;
        }
        const uint32_t wl = __shfl_sync(0xFFFFFFFFu, w[j], L);
        const int al = __shfl_sync(0xFFFFFFFFu, a, L);
        const int ol = __shfl_sync(0xFFFFFFFFu, so, L);
        if (k < n_short)
          write_byte(src, lit, src_of, lit_of, r, shift, wl, al, al + k - ol);
      }
    }
    // the queued tokens, one warp each, 32 bytes a step
    __syncthreads();
    for (int k = tid >> 5; k < n_long; k += nt >> 5) {
      const int a = long_at[k];
      const uint32_t wl = long_w[k];
      const int e = min(a + token_length(wl), iz);
      for (int p = a + lane; p < e; p += 32)
        write_byte(src, lit, src_of, lit_of, r, shift, wl, a, p);
    }
    __syncthreads();
    if (tid == 0) n_long = 0;
    pass_start += plen;
  }
  // bytes of this segment past the tokens' total take the last token
  if (row_total < hi) {
    const uint32_t wt = row[min(max(row_nz - 1, 0), T - 1)];
    for (int p = max(lo, row_total) + tid; p < hi; p += nt)
      write_byte(src, lit, src_of, lit_of, r, shift, wt, p, p);
  }
  cluster.sync();   // every position of the row has its pointer
  stamp(clocks, 3);

  // 3. doubling inside the segment; a pointer that leaves the segment
  // stops, and a position whose pointer is a root or has left drops out
  const int mine = max(0, min(S / nt, (hi - lo - tid + nt - 1) / nt));
  unsigned long long live = mine >= 64 ? ~0ull : (1ull << mine) - 1;
  for (;;) {
    int changed = 0;
    for (int i = 0; i < mine; i += 2) {   // two loads in flight
      const bool l0 = (live >> i) & 1;
      const bool l1 = i + 1 < mine && ((live >> (i + 1)) & 1);
      if (!(l0 || l1)) continue;
      const int q0 = tid + i * nt, q1 = q0 + nt;
      const int s0 = l0 ? src[q0] : lo, s1 = l1 ? src[q1] : lo;
      const int t0 = s0 >= lo ? src[s0 - lo] : s0;
      const int t1 = s1 >= lo ? src[s1 - lo] : s1;
      if (l0) {
        if (t0 == s0) live &= ~(1ull << i);
        else { src[q0] = static_cast<uint16_t>(t0); changed = 1; }
      }
      if (l1) {
        if (t1 == s1) live &= ~(1ull << (i + 1));
        else { src[q1] = static_cast<uint16_t>(t1); changed = 1; }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  // the bytes of the positions with a root here: the root's literal, in
  // place (a root's own literal never changes); the others left
  unsigned long long left = 0;
  for (int i = 0; i < mine; ++i) {
    const int q = tid + i * nt;
    const int s = src[q];
    if (s >= lo) lit[q] = lit[s - lo];
    else left |= 1ull << i;
  }
  __syncthreads();
  stamp(clocks, 4);

  // 4. the positions that left, in rank order.  A CTA's bytes are final
  // once its own positions that left are; it then pushes them, one bulk
  // copy each, into the window of every later CTA, completing on that
  // CTA's barrier.  A CTA with such positions waits for its window (the
  // whole row before it) and reads them there; one without (rank 0, a
  // stored block) is final at once.
  const bool waits = __syncthreads_or(left != 0);
  if (waits) {
    mbar_wait(&win_bar, 0);
    stamp(clocks, 5);
    for (int i = 0; i < mine; ++i)
      if ((left >> i) & 1) lit[tid + i * nt] = win[src[tid + i * nt]];
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int c = r + 1; c < C; ++c)
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
          "::bytes [%0], [%1], %2, [%3];" ::"r"(cluster_u32(win + lo, c)),
          "r"(smem_u32(lit)), "r"(S), "r"(cluster_u32(&win_bar, c))
          : "memory");
  }
  if (!waits) stamp(clocks, 5);
  stamp(clocks, 6);
  // bytes pushed here land before this CTA may leave
  if (!waits && lo > 0) mbar_wait(&win_bar, 0);

  // 5. the resolved bytes to their place in the contiguous buffer
  if (lo < hi) {
    uint8_t* dst = out + base;
    const int head = min(hi - lo, static_cast<int>(
        (16 - (reinterpret_cast<uintptr_t>(dst + lo) & 15)) & 15));
    const int a0 = lo + head;
    const int n16 = (hi - a0) >> 4;
    const int tail = a0 + (n16 << 4);
    if (tid < head) dst[lo + tid] = lit[tid];
    if (tid < hi - tail) dst[tail + tid] = lit[tail - lo + tid];
    for (int c = tid; c < n16; c += nt) {
      const uint8_t* x = lit + (a0 - lo) + (c << 4);
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = x[4 * k] | (x[4 * k + 1] << 8) | (x[4 * k + 2] << 16) |
               (static_cast<uint32_t>(x[4 * k + 3]) << 24);
      *reinterpret_cast<uint4*>(dst + a0 + (c << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  stamp(clocks, 7);
  cluster.sync();   // no CTA leaves while another may read its memory
  stamp(clocks, 8);
}

}  // namespace

// C, S, threads, tokens (the most tokens one CTA's share holds) and smem
// (dynamic shared memory bytes) come from resolve_launch; any that do not
// fit this build are refused with cudaErrorInvalidValue.  clocks is
// nullptr, or int64 [B * C * 9] for the phase split (see stamp).
extern "C" int hbam_lz77_resolve(const void* tokens, int64_t B, int64_t T,
                                 int64_t P, const void* n_tokens,
                                 const void* isize, void* out,
                                 void* total_out, int64_t C, int64_t S,
                                 int64_t threads, int64_t tokens_per_cta,
                                 int64_t smem, void* clocks, void* stream) {
  if (B <= 0) return 0;
  int shift = 0;
  while ((int64_t{1} << shift) < S) ++shift;
  const bool ok =
      P >= 1 && P <= kMaxP && T >= 1 && C >= 1 && C <= kMaxCluster &&
      S >= kMinSegment && (int64_t{1} << shift) == S && C * S >= P &&
      (C - 1) * S < P && threads >= 64 && threads <= kMaxThreads &&
      threads % 32 == 0 && S % threads == 0 &&
      S / threads <= kMaxPerThread && tokens_per_cta == (T + C - 1) / C &&
      smem == (C + 2) * S && smem <= kMaxSmem &&
      B * C < (int64_t{1} << 31);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // always the largest size, so launches from several threads never see
  // a smaller limit set by another
  cudaError_t err = cudaFuncSetAttribute(
      lz77_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lz77_resolve_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * C));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, lz77_resolve_kernel, static_cast<const uint32_t*>(tokens),
      static_cast<const int32_t*>(n_tokens),
      static_cast<const int32_t*>(isize), static_cast<int>(B),
      static_cast<int>(T), static_cast<int>(P), shift,
      static_cast<uint8_t*>(out),
      static_cast<int32_t*>(total_out),
      static_cast<long long*>(clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
