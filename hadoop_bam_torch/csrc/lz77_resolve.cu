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
// Design: one block of 1024 threads per BGZF block row, everything in
// dynamic shared memory: a u16 source pointer per byte (P <= 65536 fits)
// and the literal byte per byte, 3 * P bytes (192 KiB at P = 65536).
//   1. Tokens are taken 1024 at a time in order, one per thread, coalesced
//      from device memory; a block-wide exclusive scan of their lengths
//      gives each token's output start, and the thread writes its token's
//      bytes: a literal points at itself, a copy byte p at p - dist.
//   2. Pointer doubling src[p] = src[src[p]] in shared memory until a pass
//      changes nothing (__syncthreads_or), with no host round trip.  The
//      pointers form a forest rooted at literals (a copy's source is
//      earlier), so in-place updates only ever shorten a path; a pass with
//      no change means every pointer is a root.
//   3. out[ubase + p] = lit[src[p]] for p < iz, coalesced.
// Bound: bytes -- the tokens are read once (4 B per inflated byte) and the
// output written once; the shared-memory rounds are what this simple
// design spends beyond that (see PERF.md).
//
// Tokens past a row's total length follow the reference's rule: bytes in
// [sum of token lengths, iz) take the last token (index n_nonzero - 1,
// clipped to [0, T - 1]).  Zero-length tokens never come from the
// tokenizer; the kernel treats them as the bytes they cover (none).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 1 << 16;   // BGZF's cap on a block's inflated size

__device__ __forceinline__ int token_length(uint32_t w) {
  return (w >> 31) ? static_cast<int>((w >> 16) & 0x1FFu) : 1;
}

// One byte's pointer and literal under token w at output position p.
__device__ __forceinline__ void put_byte(uint16_t* src, uint8_t* lit,
                                         uint32_t w, int p) {
  if (w >> 31) {
    const int dist = static_cast<int>(w & 0xFFFFu) + 1;
    src[p] = static_cast<uint16_t>(max(p - dist, 0));
    lit[p] = 0;
  } else {
    src[p] = static_cast<uint16_t>(p);
    lit[p] = static_cast<uint8_t>(w & 0xFFu);
  }
}

// Block-wide sum of two 64-bit values; every thread gets both sums.
__device__ void block_sum2(long long& a, long long& b, long long* scratch) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xFFFFFFFFu, a, o);
    b += __shfl_down_sync(0xFFFFFFFFu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = scratch[lane];
    b = scratch[kWarps + lane];
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xFFFFFFFFu, a, o);
      b += __shfl_down_sync(0xFFFFFFFFu, b, o);
    }
    if (lane == 0) {
      scratch[0] = a;
      scratch[kWarps] = b;
    }
  }
  __syncthreads();
  a = scratch[0];
  b = scratch[kWarps];
  __syncthreads();
}

// Exclusive scan of one int per thread over the block; *sum gets the total.
// Ends with a barrier, so the scratch may be reused right after.
__device__ int block_exclusive_scan(int v, int* warp_tot, int* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    if (lane == 31) *sum = t;
  }
  __syncthreads();
  const int r = warp_tot[warp] + x - v;
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads, 1)
lz77_resolve_kernel(const uint32_t* __restrict__ tokens,
                    const int32_t* __restrict__ n_tokens,
                    const int32_t* __restrict__ isize, int B, int T, int P,
                    uint8_t* __restrict__ out,
                    int32_t* __restrict__ total_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* src = reinterpret_cast<uint16_t*>(smem);
  uint8_t* lit = smem + 2 * static_cast<size_t>(P);
  __shared__ long long sums[2 * kWarps];
  __shared__ int warp_tot[kWarps];
  __shared__ int scan_sum;

  const int b = blockIdx.x;
  // ubase[b] and total from the clamped sizes of all rows
  long long base = 0, total = 0;
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const long long iz = min(max(isize[i], 0), P);
    total += iz;
    if (i < b) base += iz;
  }
  block_sum2(base, total, sums);
  if (b == 0 && threadIdx.x == 0) *total_out = static_cast<int32_t>(total);

  // zeros past total, each block over its own P-byte stripe of out
  const long long stripe = static_cast<long long>(b) * P;
  for (long long q = max(stripe, total) + threadIdx.x; q < stripe + P;
       q += kThreads)
    out[q] = 0;

  const int iz = min(max(isize[b], 0), P);
  if (iz == 0) return;   // uniform over the block

  // 1. token expansion, 1024 tokens per step, in order
  const uint32_t* row = tokens + static_cast<long long>(b) * T;
  const int n = min(max(n_tokens[b], 0), T);
  int pos = 0;           // output start of this step's first token
  int nonzero = 0;       // tokens of non-zero length so far
  for (int t0 = 0; t0 < n && pos < P; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    uint32_t w = 0;
    int len = 0;
    if (t < n) {
      w = row[t];
      len = token_length(w);
    }
    const int start = pos + block_exclusive_scan(len, warp_tot, &scan_sum);
    const int end = min(start + len, P);
    for (int p = start; p < end; ++p) put_byte(src, lit, w, p);
    pos += scan_sum;
    nonzero += __syncthreads_count(len > 0);
  }
  // bytes past the tokens' total length take the last token
  if (pos < iz) {
    const uint32_t w = row[min(max(nonzero - 1, 0), T - 1)];
    for (int p = max(pos, 0) + threadIdx.x; p < iz; p += kThreads)
      put_byte(src, lit, w, p);
  }
  __syncthreads();

  // 2. pointer doubling to the literal roots
  for (;;) {
    int changed = 0;
    for (int p = threadIdx.x; p < iz; p += kThreads) {
      const uint16_t s = src[p];
      const uint16_t s2 = src[s];
      if (s2 != s) {
        src[p] = s2;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  // 3. resolved bytes to their place in the contiguous buffer
  uint8_t* dst = out + base;
  for (int p = threadIdx.x; p < iz; p += kThreads) dst[p] = lit[src[p]];
}

}  // namespace

extern "C" int hbam_lz77_resolve(const void* tokens, int64_t B, int64_t T,
                                 int64_t P, const void* n_tokens,
                                 const void* isize, void* out,
                                 void* total_out, void* stream) {
  if (B <= 0) return 0;
  if (P <= 0 || P > kMaxP || T <= 0) return static_cast<int>(
      cudaErrorInvalidValue);
  const size_t smem = 3 * static_cast<size_t>(P);
  // always the largest size, so launches from several threads never see
  // a smaller limit set by another
  cudaError_t err = cudaFuncSetAttribute(
      lz77_resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      3 * kMaxP);
  if (err != cudaSuccess) return static_cast<int>(err);
  lz77_resolve_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tokens),
      static_cast<const int32_t*>(n_tokens),
      static_cast<const int32_t*>(isize), static_cast<int>(B),
      static_cast<int>(T), static_cast<int>(P),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(total_out));
  return static_cast<int>(cudaGetLastError());
}
