// K16a: the duplicate-signature columns of BAM record rows, for Hopper
// (sm_90a).
//
// Replaces: hadoop_bam_tpu/prep/markdup.py::markdup_columns (:69), the
//   jnp ops the reference's fused sort + markdup step
//   (_make_fused_sort_markdup_step :150, call :177) runs on each round's
//   [R, stride] row tile.  Its plain PyTorch version is
//   hadoop_bam_torch/prep/markdup.py::markdup_columns_plain.
//
// Per row r (uint32 arithmetic wrapping, int32 where the reference's is):
//   refid, pos, l_read_name, n_cigar, flag, l_seq, next_refid, next_pos
//           = the row's fixed fields (bytes 4-31)
//   op k    = the little-endian 4 bytes at flat tile index
//             r * stride + 36 + l_read_name + 4k, each byte index clamped
//             to the tile, for k < min(n_cigar, kmax)
//   lead    = the lengths of the ops before the first op that is not a
//             clip (S, H); trail = those after the last such op (every
//             op when all are clips); ref = the lengths of M D N = X ops
//   k1      = 1 + (flag & 16 ? pos + (n_cigar ? ref : l_seq) - 1 + trail
//                              : pos - lead)
//   score   = the sum of the quality bytes >= 15 in [qoff, qoff + l_seq)
//             cut to the row, qoff = 36 + l_read_name + 4 n_cigar +
//             floor((l_seq + 1) / 2) in int32
//   out[f * R + r], f = k0 (refid), k1, k2 (lib << 3 | mate_rev << 2 |
//   orient << 1 | pair), k3 (next_refid + 1, or 0), k4 (next_pos + 1, or
//   0), score; elig[r] = r < count and flag & 0x904 == 0.  Pad rows
//   (r >= count) are computed the same way.
//
// What bounds it on the card: bytes.  A row's 28 bytes of fixed fields
//   and 4-byte library number, each record's CIGAR words and quality run
//   read, 25 bytes written: 212,173,051 B at round 0's tile [1,000,448,
//   512] of a 1,000,000-read synth.write_markdup_bam file (151-base
//   reads), 0.063335 ms at 3.35 TB/s.  Read as whole 32-byte sectors
//   the same tile moves 283,309,792 B (the prefix's
//   sector, the CIGAR's, 5-6 of qualities, the library word, the
//   outputs), so 74.9% of that bound is the ceiling.
//
// What held the kernel back, measured on an H100 at a round's tile.  A
//   thread a record with its loads in order (the prefix, each CIGAR op,
//   one 16-byte quality word an iteration): the quality loop was three
//   quarters of its time.  Any design whose warp loads touch 16-32 rows
//   at once, 16 bytes each (a thread or a sub-warp of 2-16 lanes a
//   record, loads in registers or staged), took as long as reading
//   every byte of the tile, 0.16 ms or more; a warp reading one row's
//   words together reads only what it touches.  A sub-warp a record also
//   needs 58-92 registers and does each record's scalar work on every
//   lane.
//
// Design: the rows staged a batch ahead by whole lines, a thread a
//   record.
// - A persistent grid of kThreads-thread CTAs, as many as are resident
//   at once (shared memory sets it; fewer for a small tile).  CTA c
//   takes the batches of kThreads consecutive records c, c + G, ...;
//   thread t computes record t of its batch, so each output column's
//   store is a warp's 128-byte line.
// - Staging: a batch's rows' first kWin 16-byte words and its library
//   numbers, copied by cp.async with consecutive threads on consecutive
//   words (a warp copies whole lines), into one of two buffers while
//   the batch before is computed.  kWin is a template argument, a
//   kernel for each of 2..kWinMax; a launch takes the words below its
//   row_bytes (at least the fixed fields' two, at most the row's) and
//   sizes shared memory to them.  The pipeline passes host_row_bytes:
//   the 64-byte boundary past the median record's quality-run end, or
//   the furthest end where that is nearer.  The card moves a row's
//   bytes as if in 64-byte pieces, and a piece a record reads past the
//   stage costs about two staged ones: a round's tile staged to byte
//   256 instead of 288 took 1.17x as long; a tile of 30-40-byte names,
//   runs ending at bytes 297-331, took 0.135 ms staged to 320, 0.159 to
//   336 (a sixth piece for every row) and 0.165 to 288 (H100 80GB HBM3,
//   700 W).
// - The CIGAR walk and the quality run read the staged words, and the
//   tile where they lie past them (a row longer than the window): an op
//   by one or two aligned 32-bit loads and __funnelshift_r, its bytes
//   clamped to the tile where it would pass its end (ops are read from
//   the flat tile).
// - The quality sum: whole words, a byte >= 15 found with a SWAR compare
//   (no borrow crosses a byte: each byte has its top bit set first) and
//   summed with __dp4a, less the bytes outside [lo, hi) of the run's
//   first and last words.
//
// Output layout: out[f * R + r], elig[r] as above.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;       // a CTA and its batch of records
constexpr int kWinMax = 32;        // staged 16-byte words a row at most
constexpr uint32_t kRefOps = 0x18Du;   // M D N = X: ops 0 2 3 7 8

// a CTA's dynamic shared memory at kWin staged words a row: two batches
// of rows ([record * kWin + word]), then their library numbers
constexpr int stage_bytes(int win) {
  return 2 * kThreads * (16 * win + 4);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 4 little-endian bytes at flat position p >= 0 of the tile, each
// byte index clamped to [0, cap]
__device__ __forceinline__ uint32_t word_at(const uint8_t* tile, int64_t cap,
                                            int64_t p) {
  if (p + 3 <= cap) {
    // cap + 1 is a multiple of 16, so the aligned word after the one
    // holding p exists whenever p's window reaches into it
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tile + (p & ~int64_t(3)));
    const uint32_t sh = static_cast<uint32_t>(p & 3) * 8;
    const uint32_t lo = __ldg(w);
    return sh ? __funnelshift_r(lo, __ldg(w + 1), sh) : lo;
  }
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int64_t i = p + b;
    v |= static_cast<uint32_t>(__ldg(tile + (i > cap ? cap : i))) << (8 * b);
  }
  return v;
}

// the bytes [0, n) of a 4-byte lane, n clamped to [0, 4]
__device__ __forceinline__ uint32_t below(int n) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u,
                          8u * static_cast<uint32_t>(n < 0 ? 0 : n));
}

// acc plus the bytes of x that are >= 15 and kept (0x80 in keep): with
// its top bit set first, a byte minus 15 borrows from no neighbour, and
// keeps its top bit exactly when its low seven bits are >= 15
__device__ __forceinline__ uint32_t ge15_sum(uint32_t x, uint32_t keep,
                                             uint32_t acc) {
  const uint32_t t = (x | 0x80808080u) - 0x0F0F0F0Fu;
  return __dp4a(x, ((t | x) & keep) >> 7, acc);
}

// acc plus the bytes >= 15 of the 16-byte word x
__device__ __forceinline__ uint32_t word_sum(uint4 x, uint32_t acc) {
  acc = ge15_sum(x.x, 0x80808080u, acc);
  acc = ge15_sum(x.y, 0x80808080u, acc);
  acc = ge15_sum(x.z, 0x80808080u, acc);
  return ge15_sum(x.w, 0x80808080u, acc);
}

// the bytes >= 15 of the 16-byte word x that lie in [a, b)
__device__ __forceinline__ uint32_t range_sum(uint4 x, int a, int b) {
  uint32_t acc = ge15_sum(x.x, 0x80808080u & below(b) & ~below(a), 0u);
  acc = ge15_sum(x.y, 0x80808080u & below(b - 4) & ~below(a - 4), acc);
  acc = ge15_sum(x.z, 0x80808080u & below(b - 8) & ~below(a - 8), acc);
  return ge15_sum(x.w, 0x80808080u & below(b - 12) & ~below(a - 12), acc);
}

// kWin, the staged words a row, is the launch's (at most the row's)
template <int kWin>
__global__ void __launch_bounds__(kThreads)
markdup_cols_kernel(const uint8_t* __restrict__ rows, int64_t R,
                    int64_t stride, int64_t count, int64_t kmax,
                    const uint32_t* __restrict__ lib,
                    uint32_t* __restrict__ out, uint8_t* __restrict__ elig) {
  // buffer q's rows at st_row + q * kThreads * kWin (an array of the
  // two pointers would live in local memory)
  extern __shared__ uint4 st_row[];
  uint32_t* const st_lib =
      reinterpret_cast<uint32_t*>(st_row + 2 * kThreads * kWin);
  const int tid = threadIdx.x;
  const int64_t cap = R * stride - 1;
  const int64_t batches = (R + kThreads - 1) / kThreads;

  // batch b's rows into buffer buf, consecutive threads on consecutive
  // 16-byte words (a warp copies whole 128-byte lines)
  auto stage = [&](int64_t b, int buf) {
    const int64_t r0 = b * kThreads;
    for (int f = tid; f < kThreads * kWin; f += kThreads) {
      const int rec = f / kWin, w = f % kWin;
      if (r0 + rec < R)
        copy16(&st_row[buf * kThreads * kWin + f],
               rows + (r0 + rec) * stride + 16 * w);
    }
    if (r0 + tid < R) copy4(&st_lib[buf * kThreads + tid], lib + r0 + tid);
  };

  int64_t b = blockIdx.x;
  if (b < batches) stage(b, 0);
  commit();
  for (int i = 0; b < batches; ++i, b += gridDim.x) {
    const int buf = i & 1;
    // the next batch's rows fly while this one is computed
    if (b + gridDim.x < batches) stage(b + gridDim.x, buf ^ 1);
    commit();
    wait_groups<1>();
    __syncthreads();

    const int64_t r = b * kThreads + tid;
    if (r < R) {
      const uint4* my = &st_row[(buf * kThreads + tid) * kWin];
      const uint32_t* mw = reinterpret_cast<const uint32_t*>(my);
      const uint4 p0 = my[0], p1 = my[1];
      const int64_t row0 = r * stride;
      const uint32_t l_read_name = p0.w & 0xFFu, n_cigar = p1.x & 0xFFFFu;
      const uint32_t flag = p1.x >> 16, l_seq = p1.y;

      // the CIGAR walk: the maximal clip prefix and suffix, the reference
      // span; an op in the staged words is read there, else from the tile
      // with the reference's clamp (ops are read from the flat tile)
      uint32_t lead = 0, trail = 0, ref = 0;
      bool in_lead = true;
      const int64_t n_ops = static_cast<int64_t>(n_cigar) < kmax ? n_cigar : kmax;
      const int rel0 = 36 + static_cast<int>(l_read_name);
      for (int k = 0; k < n_ops; ++k) {
        const int rel = rel0 + 4 * k;
        uint32_t v;
        if (rel + 4 <= 16 * kWin) {
          const uint32_t lo = mw[rel >> 2];
          v = (rel & 3) ? __funnelshift_r(lo, mw[(rel >> 2) + 1], (rel & 3) * 8)
                        : lo;
        } else {
          v = word_at(rows, cap, row0 + rel);
        }
        const uint32_t op = v & 0xFu, ln = v >> 4;
        if (op == 4u || op == 5u) {
          if (in_lead) lead += ln;
          trail += ln;
        } else {
          in_lead = false;
          trail = 0;
        }
        if ((kRefOps >> op) & 1u) ref += ln;
      }
      const uint32_t ref_len = n_cigar == 0 ? l_seq : ref;
      const uint32_t orient = (flag >> 4) & 1u;
      const uint32_t upos = orient ? p0.z + ref_len - 1u + trail : p0.z - lead;

      // the quality run cut to the row (offsets wrap as int32 does): its
      // words whole, from the stage where staged, less the bytes outside
      // [lo, hi) of its first and last words
      const int32_t half = static_cast<int32_t>(l_seq + 1u) >> 1;  // floor
      const int32_t qoff = static_cast<int32_t>(
          36u + l_read_name + 4u * n_cigar + static_cast<uint32_t>(half));
      const int32_t qend = static_cast<int32_t>(static_cast<uint32_t>(qoff) + l_seq);
      const int lo = qoff < 0 ? 0 : qoff;
      const int hi = static_cast<int64_t>(qend) < stride ? qend : static_cast<int>(stride);
      uint32_t score = 0;
      if (lo < hi) {
        const uint4* q = reinterpret_cast<const uint4*>(rows + row0);
        const int w0 = lo >> 4, w1 = (hi - 1) >> 4;
        for (int w = w0; w <= w1; ++w)
          score = word_sum(w < kWin ? my[w] : __ldg(q + w), score);
        score -= range_sum(w0 < kWin ? my[w0] : __ldg(q + w0), 0, lo - (w0 << 4));
        score -= range_sum(w1 < kWin ? my[w1] : __ldg(q + w1), hi - (w1 << 4), 16);
      }

      const uint32_t pair = (flag & 0x1u) && !(flag & 0x8u) ? 1u : 0u;
      const uint32_t mate_rev = pair ? (flag >> 5) & 1u : 0u;
      out[r] = p0.y;
      out[R + r] = upos + 1u;
      out[2 * R + r] = (st_lib[buf * kThreads + tid] << 3) | (mate_rev << 2) | (orient << 1) | pair;
      out[3 * R + r] = pair ? p1.z + 1u : 0u;
      out[4 * R + r] = pair ? p1.w + 1u : 0u;
      out[5 * R + r] = score;
      elig[r] = (r < count && !(flag & 0x904u)) ? 1 : 0;
    }
    // the buffer is staged again two batches on
    __syncthreads();
  }
  wait_groups<0>();
}

using Kernel = void (*)(const uint8_t*, int64_t, int64_t, int64_t, int64_t,
                       const uint32_t*, uint32_t*, uint8_t*);

// the kernel staging win words a row, win in [2, kWinMax]
template <int... I>
Kernel kernel_at(int win, std::integer_sequence<int, I...>) {
  static const Kernel table[] = {markdup_cols_kernel<I + 2>...};
  return table[win - 2];
}

}  // namespace

extern "C" int hbam_markdup_cols(const void* rows, int64_t R, int64_t stride,
                                 int64_t count, int64_t kmax, const void* lib,
                                 int64_t row_bytes, void* out, void* elig,
                                 void* stream) {
  if (R > 0) {
    // the staged words: those below row_bytes, at least the fixed
    // fields' two, at most the row's and kWinMax
    int64_t w = (row_bytes + 15) / 16;
    if (w > stride / 16) w = stride / 16;
    if (w > kWinMax) w = kWinMax;
    const int win = w < 2 ? 2 : static_cast<int>(w);
    const int smem = stage_bytes(win);
    const Kernel kern =
        kernel_at(win, std::make_integer_sequence<int, kWinMax - 1>());
    // the persistent grid: as many CTAs as are resident at once at this
    // window, found once a device and window
    static int resident[64][kWinMax + 1];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    int cap = dev < 64 ? resident[dev][win] : 0;
    if (cap == 0) {
      int sms = 0, per_sm = 0;
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      cap = sms * per_sm > 0 ? sms * per_sm : 1;
      if (dev < 64) resident[dev][win] = cap;
    }
    const int64_t need = (R + kThreads - 1) / kThreads;   // batches
    const int64_t blocks = need < cap ? need : cap;
    kern<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), R, stride, count, kmax,
        static_cast<const uint32_t*>(lib), static_cast<uint32_t*>(out),
        static_cast<uint8_t*>(elig));
  }
  return static_cast<int>(cudaGetLastError());
}
