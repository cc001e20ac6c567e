// K10p: the segmented seq/qual gather of the device decode plane, for
// Hopper (sm_90a).
//
// Replaces the payload half of hadoop_bam_tpu/ops/inflate_device.py::
// resolve_walk_payload (:319-331): each kept record's packed 4-bit bases
// and quality bytes lifted from the inflated buffer into fixed-stride
// [R, seq_stride] / [R, qual_stride] tiles, the layout the K2 stats kernel
// reads.  In plain PyTorch this is an int64 index tensor of R x 256
// entries per chunk (268 MB at R = 131,072); here no index exists.
//
// Per row r (int32 arithmetic wrapping as the reference's does):
//   valid  = r < min(max(n_all, 0), R)
//   use    = valid ? clamp(l_seq, 0, max_len) : 0
//   seq_off = offs + 36 + l_read_name + 4 * n_cigar
//   nb     = (max(l_seq, 0) + 1) >> 1
//   seq[r, j]  = j < (use + 1) >> 1 ? buf[clamp(seq_off + j, 0, L - 1)] : 0
//   qual[r, j] = j < use ? buf[clamp(seq_off + nb + j, 0, L - 1)] : 0
//
// Bound: bytes.  The two tiles are written once (R rows, of which the
// walk fills a few percent: the rest are zeros), the four columns and
// n_all are read once, and so are the live rows' payload bytes.  So the
// kernel is a stream of zero stores with a few scattered reads beside it.
//
// Design: one persistent wave of kMinBlocks CTAs per SM (the wrapper's
// grid; fewer where the tiles are small), every CTA reading n_valid once
// from the card, its warps split by role:
//
// - kZeroWarps warps stream zeros.  Rows [n_valid, R) of each tile are
//   one contiguous byte range; the two ranges' aligned 16-byte words form
//   one flat index space walked grid-stride (64-bit adds and compares, no
//   division, no loads), and the at most 15 unaligned bytes at either
//   end of each range take byte stores.  Few threads stream best: on an
//   H100 the zeros of a 131,072-row chunk took about 0.018 ms from
//   270,336 threads and about 0.010 ms from 16,896 (PERF.md, section 6).
// - The other warps serve the live rows [0, n_valid), two rows a warp,
//   16 lanes a row and one lane a 16-byte output piece.  A piece whose
//   source bytes lie inside the 16-byte-aligned interior of buf
//   (measured from buf's address, so a view such as buf[3:] is safe) and
//   whose int32 index sums do not wrap loads the one or two aligned
//   16-byte words that hold them, shifts them into place with
//   __funnelshift_r and masks the bytes past the row's length; any other
//   piece (a window at either end of buf, a wrapped sum) reads its bytes
//   one by one with the reference's clamp.  The lane stores the piece as
//   one 16-byte vector where both tiles' rows are 16-byte aligned, byte
//   by byte otherwise.
//
// The live warps' loads are in flight while the zero warps stream, so
// the live rows cost little beyond the zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;   // CTAs per SM: the wave's width
constexpr int kZeroWarps = 1;   // warps of a CTA that stream zeros
constexpr int kEdgeThreads = 64;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// word q + i of w[0..7], q in [0, 3]: selects, no local memory
__device__ __forceinline__ uint32_t pick(const uint32_t (&w)[8], int q,
                                         int i) {
  uint32_t r = w[i];
  r = q == 1 ? w[i + 1] : r;
  r = q == 2 ? w[i + 2] : r;
  r = q == 3 ? w[i + 3] : r;
  return r;
}

// bytes [s, s + 16) of the 32 bytes x:y, the first c kept, the rest zero
__device__ __forceinline__ uint4 assemble(uint4 x, uint4 y, int s, int c) {
  const uint32_t w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  const int q = s >> 2;
  const uint32_t sh = static_cast<uint32_t>(s & 3) << 3;
  uint32_t a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) a[i] = pick(w, q, i);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = min(max(c - 4 * i, 0), 4);
    const uint32_t m = n == 4 ? 0xFFFFFFFFu : (1u << (8 * n)) - 1u;
    o[i] = __funnelshift_r(a[i], a[i + 1], sh) & m;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// the reference's rule byte by byte: the first c bytes of from + j0 ..,
// each index wrapped in int32 and clamped to [0, L - 1]
__device__ __forceinline__ uint4 gather_bytes(const uint8_t* buf,
                                              long long L, int32_t from,
                                              int j0, int c) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < c) {
      long long q = wrap_add(from, j0 + k);
      q = q < 0 ? 0 : (q > L - 1 ? L - 1 : q);
      o[k >> 2] |= static_cast<uint32_t>(buf[q]) << (8 * (k & 3));
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store_piece(uint8_t* dst, int j0, int width,
                                            uint4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst + j0) = v;
    return;
  }
  const uint32_t o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (j0 + k < width)
      dst[j0 + k] = static_cast<uint8_t>(o[k >> 2] >> (8 * (k & 3)));
}

// [start, end) of a tile as an aligned body and its unaligned ends:
// head [start, body), body [body, tail) in 16-byte words, tail [tail, end)
struct Range {
  uint8_t* start;
  uint8_t* body;
  uint8_t* tail;
  uint8_t* end;
};

__device__ __forceinline__ Range split_range(uint8_t* start, uint8_t* end) {
  const uintptr_t up =
      (reinterpret_cast<uintptr_t>(start) + 15) & ~uintptr_t(15);
  const uintptr_t down = reinterpret_cast<uintptr_t>(end) & ~uintptr_t(15);
  uint8_t* body = up <= reinterpret_cast<uintptr_t>(end)
                      ? reinterpret_cast<uint8_t*>(up) : end;
  uint8_t* tail = down >= reinterpret_cast<uintptr_t>(body)
                      ? reinterpret_cast<uint8_t*>(down) : body;
  return {start, body, tail, end};
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
payload_gather_kernel(
    const uint8_t* __restrict__ buf, long long L,
    const int32_t* __restrict__ offs, const int32_t* __restrict__ l_seq,
    const int32_t* __restrict__ l_read_name,
    const int32_t* __restrict__ n_cigar, const int32_t* __restrict__ n_all,
    int R, int max_len, int seq_stride, int qual_stride,
    uint8_t* __restrict__ seq, uint8_t* __restrict__ qual, bool vec) {
  const int n_valid = min(max(__ldg(n_all), 0), R);
  const int warp = threadIdx.x >> 5;
  if (warp < kZeroWarps) {
    // the zero stream: rows [n_valid, R) of both tiles
    const Range rs =
        split_range(seq + static_cast<long long>(n_valid) * seq_stride,
                    seq + static_cast<long long>(R) * seq_stride);
    const Range rq =
        split_range(qual + static_cast<long long>(n_valid) * qual_stride,
                    qual + static_cast<long long>(R) * qual_stride);
    const long long ns = (rs.tail - rs.body) >> 4;
    const long long nw = ns + ((rq.tail - rq.body) >> 4);
    constexpr int kZeroThreads = kZeroWarps * 32;
    const long long g =
        static_cast<long long>(blockIdx.x) * kZeroThreads + threadIdx.x;
    const long long step = static_cast<long long>(gridDim.x) * kZeroThreads;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    uint4* const sw = reinterpret_cast<uint4*>(rs.body);
    uint4* const qw = reinterpret_cast<uint4*>(rq.body) - ns;
#pragma unroll 4
    for (long long w = g; w < nw; w += step) (w < ns ? sw : qw)[w] = z;
    // seq head, seq tail, qual head, qual tail: 16 slots each
    for (long long e = g; e < kEdgeThreads; e += step) {
      const Range t = (e >> 5) ? rq : rs;
      const int k = static_cast<int>(e & 15);
      uint8_t* d = (e & 16) ? t.tail + k : t.start + k;
      if (d < ((e & 16) ? t.end : t.body)) *d = 0;
    }
    return;
  }
  // live rows: pairs of rows spread over the live warps of the whole
  // grid, CTA-minor so that every SM gets a share
  const int lane = threadIdx.x & 31;
  const int seq_pieces = (seq_stride + 15) >> 4;
  const int pieces = seq_pieces + ((qual_stride + 15) >> 4);
  // buf's 16-byte-aligned interior as indices [in_lo, in_hi)
  const uintptr_t base = reinterpret_cast<uintptr_t>(buf);
  const long long in_lo =
      static_cast<long long>(((base + 15) & ~uintptr_t(15)) - base);
  const long long in_hi =
      static_cast<long long>(((base + L) & ~uintptr_t(15)) - base);
  const int pairs = (n_valid + 1) >> 1;
  const int warps = gridDim.x * (kThreads / 32 - kZeroWarps);
  for (int p = (warp - kZeroWarps) * gridDim.x + blockIdx.x; p < pairs;
       p += warps) {
    const int r = 2 * p + (lane >> 4);
    if (r >= n_valid) break;
    const int32_t ls = __ldg(l_seq + r);
    const int use = min(max(ls, 0), max_len);
    const int32_t seq_off = wrap_add(
        wrap_add(__ldg(offs + r), 36),
        wrap_add(__ldg(l_read_name + r),
                 static_cast<int32_t>(static_cast<uint32_t>(
                                          __ldg(n_cigar + r)) * 4u)));
    const int32_t nb = wrap_add(max(ls, 0), 1) >> 1;
    for (int k = lane & 15; k < pieces; k += 16) {
      const bool is_seq = k < seq_pieces;
      const int j0 = (is_seq ? k : k - seq_pieces) << 4;
      const int32_t from = is_seq ? seq_off : wrap_add(seq_off, nb);
      const int limit = is_seq ? (use + 1) >> 1 : use;
      const int c = min(max(limit - j0, 0), 16);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c > 0) {
        const long long i0 = static_cast<long long>(from) + j0;
        if (i0 >= in_lo && i0 + c <= in_hi && i0 + c - 1 <= INT32_MAX) {
          const int s = static_cast<int>((base + i0) & 15);
          const uint4* w = reinterpret_cast<const uint4*>(buf + i0 - s);
          const uint4 x = __ldg(w);
          const uint4 y =
              s + c > 16 ? __ldg(w + 1) : make_uint4(0u, 0u, 0u, 0u);
          v = assemble(x, y, s, c);
        } else {
          v = gather_bytes(buf, L, from, j0, c);
        }
      }
      if (is_seq)
        store_piece(seq + static_cast<long long>(r) * seq_stride, j0,
                    seq_stride, v, vec);
      else
        store_piece(qual + static_cast<long long>(r) * qual_stride, j0,
                    qual_stride, v, vec);
    }
  }
}

}  // namespace

extern "C" int hbam_payload_gather(
    const void* buf, int64_t L, const void* offs, const void* l_seq,
    const void* l_read_name, const void* n_cigar, const void* n_all,
    int64_t R, int64_t max_len, int64_t seq_stride, int64_t qual_stride,
    void* seq, void* qual, int64_t grid, int64_t threads, void* stream) {
  if (R <= 0) return 0;
  if (L <= 0 || R > INT32_MAX || max_len < 0 || max_len > INT32_MAX ||
      seq_stride < 0 || seq_stride > INT32_MAX || qual_stride < 0 ||
      qual_stride > INT32_MAX || threads != kThreads || grid < 1 ||
      grid > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (seq_stride + qual_stride == 0) return 0;
  // 16-byte stores of live pieces need 16-byte aligned rows in both tiles
  const bool vec = seq_stride % 16 == 0 && qual_stride % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(seq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qual) % 16 == 0;
  payload_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), L,
      static_cast<const int32_t*>(offs), static_cast<const int32_t*>(l_seq),
      static_cast<const int32_t*>(l_read_name),
      static_cast<const int32_t*>(n_cigar),
      static_cast<const int32_t*>(n_all), static_cast<int>(R),
      static_cast<int>(max_len), static_cast<int>(seq_stride),
      static_cast<int>(qual_stride), static_cast<uint8_t*>(seq),
      static_cast<uint8_t*>(qual), vec);
  return static_cast<int>(cudaGetLastError());
}
