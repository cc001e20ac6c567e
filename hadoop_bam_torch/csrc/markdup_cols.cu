// K16a: the duplicate-signature columns of BAM record rows, for Hopper
// (sm_90a).
//
// Replaces: hadoop_bam_tpu/prep/markdup.py::markdup_columns (:69), the
//   jnp ops the reference's fused sort + markdup step
//   (_make_fused_sort_markdup_step :150, call :177) runs on each round's
//   [R, stride] row tile.  Its plain PyTorch version is
//   hadoop_bam_torch/prep/markdup.py::markdup_columns_plain.
//
// What bounds it on the card: bytes.  Per record it needs 28 bytes of
//   fixed fields (refid through next_pos, bytes 4-31; tlen is not
//   read), the CIGAR words (4 B an op), the quality run (l_seq bytes)
//   and its 4-byte library number, and writes 25 bytes (k0..k4
//   and score as uint32, elig as uint8); a few integer operations a
//   byte.  The reference's tile form reads and masks the whole
//   [R, stride] tile and a [R, kmax] CIGAR tile, so most of its bytes
//   are padding.
//
// What the design does about it: one thread a record, 256 threads a
//   block.  The fixed fields are two aligned 16-byte loads of the row's
//   bytes 0-31 (rows start 16-byte aligned: the wrapper checks base and
//   stride), the library number one 4-byte load.
//   The CIGAR is walked op by op up to min(n_cigar, kmax), each op one
//   or two aligned 4-byte loads joined by __funnelshift_r (ops sit at
//   any byte); an op whose bytes would pass the tile's end takes the
//   reference's rule, each byte index clamped to the tile (the reference
//   gathers from the flat tile).  The quality run is read as aligned
//   16-byte words over [qual_off, qual_off + l_seq) cut to the row; each
//   32-bit lane keeps the bytes >= 15 inside the run (__vcmpgeu4 and a
//   byte mask) and adds them with __dp4a.  Outputs are written column by
//   column, consecutive threads to consecutive addresses.  Integer
//   arithmetic wraps at 32 bits as the reference's int32 / uint32 does.
//
// Output layout: out[f * R + r], f = k0 (refid), k1 (unclipped 5'
//   position + 1), k2 (lib << 3 | mate_rev << 2 | orient << 1 | pair),
//   k3 (next_refID + 1, or 0), k4 (next_pos + 1, or 0), score; elig[r] =
//   1 when r < count and flag & 0x904 == 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// the 4 little-endian bytes at flat position p of the tile, each byte
// index clamped to [0, cap]
__device__ __forceinline__ uint32_t word_at(const uint8_t* __restrict__ tile,
                                            int64_t cap, int64_t p) {
  if (p >= 0 && p + 3 <= cap) {
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
    int64_t i = p + b;
    i = i < 0 ? 0 : (i > cap ? cap : i);
    v |= static_cast<uint32_t>(__ldg(tile + i)) << (8 * b);
  }
  return v;
}

// bytes [lo, hi) of a 4-byte lane (0 <= lo <= hi <= 4) as a byte mask
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  const uint32_t below_hi = hi >= 4 ? 0xFFFFFFFFu : ((1u << (8 * hi)) - 1u);
  const uint32_t below_lo = lo <= 0 ? 0u : ((1u << (8 * lo)) - 1u);
  return below_hi & ~below_lo;
}

__device__ __forceinline__ uint32_t qual_sum(uint32_t x, int64_t c0,
                                            int64_t lo, int64_t hi) {
  const int64_t a = lo - c0, b = hi - c0;
  const int l = a < 0 ? 0 : (a > 4 ? 4 : static_cast<int>(a));
  const int h = b < 0 ? 0 : (b > 4 ? 4 : static_cast<int>(b));
  if (l >= h) return 0u;
  const uint32_t keep = byte_mask(l, h) & __vcmpgeu4(x, 0x0F0F0F0Fu);
  return __dp4a(x & keep, 0x01010101u, 0u);
}

__global__ void __launch_bounds__(kThreads)
markdup_cols_kernel(const uint8_t* __restrict__ tile, int64_t R,
                    int64_t stride, int64_t count, int64_t kmax,
                    const uint32_t* __restrict__ lib,
                    uint32_t* __restrict__ out, uint8_t* __restrict__ elig) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= R) return;
  const int64_t cap = R * stride - 1;
  const uint8_t* row = tile + r * stride;
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(row));
  const uint4 b = __ldg(reinterpret_cast<const uint4*>(row) + 1);
  const uint32_t refid = a.y, pos = a.z;
  const uint32_t l_read_name = a.w & 0xFFu;
  const uint32_t n_cigar = b.x & 0xFFFFu, flag = b.x >> 16;
  const uint32_t l_seq = b.y, nref = b.z, npos = b.w;

  // the CIGAR walk: the maximal clip prefix and suffix, the reference span
  uint32_t lead = 0, trail = 0, ref_sum = 0;
  bool in_lead = true;
  const int64_t cig = r * stride + 36 + l_read_name;
  const int64_t n_ops = static_cast<int64_t>(n_cigar) < kmax ? n_cigar : kmax;
  for (int64_t k = 0; k < n_ops; ++k) {
    const uint32_t v = word_at(tile, cap, cig + 4 * k);
    const uint32_t op = v & 0xFu, ln = v >> 4;
    if (op == 4u || op == 5u) {
      if (in_lead) lead += ln;
      trail += ln;
    } else {
      in_lead = false;
      trail = 0;
    }
    if (op == 0u || op == 2u || op == 3u || op == 7u || op == 8u) ref_sum += ln;
  }
  const uint32_t ref_len = n_cigar == 0 ? l_seq : ref_sum;
  const uint32_t orient = (flag >> 4) & 1u;
  const uint32_t upos = orient ? pos + ref_len - 1u + trail : pos - lead;

  // the quality run, cut to the row; offsets wrap as int32 does
  const int32_t half = static_cast<int32_t>(l_seq + 1u) >> 1;  // floor
  const int32_t qoff = static_cast<int32_t>(36u + l_read_name + 4u * n_cigar +
                                            static_cast<uint32_t>(half));
  const int32_t qend = static_cast<int32_t>(static_cast<uint32_t>(qoff) + l_seq);
  const int64_t lo = qoff < 0 ? 0 : qoff;
  const int64_t hi = static_cast<int64_t>(qend) < stride ? qend : stride;
  uint32_t score = 0;
  if (lo < hi) {
    const uint4* q = reinterpret_cast<const uint4*>(row);
    for (int64_t w = lo >> 4; w <= (hi - 1) >> 4; ++w) {
      const uint4 x = __ldg(q + w);
      const int64_t c0 = w << 4;
      score += qual_sum(x.x, c0, lo, hi) + qual_sum(x.y, c0 + 4, lo, hi) +
               qual_sum(x.z, c0 + 8, lo, hi) + qual_sum(x.w, c0 + 12, lo, hi);
    }
  }

  const uint32_t pair = (flag & 0x1u) && !(flag & 0x8u) ? 1u : 0u;
  const uint32_t mate_rev = pair ? (flag >> 5) & 1u : 0u;
  out[r] = refid;
  out[R + r] = upos + 1u;
  out[2 * R + r] = (__ldg(lib + r) << 3) | (mate_rev << 2) | (orient << 1) | pair;
  out[3 * R + r] = pair ? nref + 1u : 0u;
  out[4 * R + r] = pair ? npos + 1u : 0u;
  out[5 * R + r] = score;
  elig[r] = (r < count && !(flag & 0x904u)) ? 1 : 0;
}

}  // namespace

extern "C" int hbam_markdup_cols(const void* rows, int64_t R, int64_t stride,
                                 int64_t count, int64_t kmax, const void* lib,
                                 void* out, void* elig, void* stream) {
  if (R > 0) {
    const int64_t blocks = (R + kThreads - 1) / kThreads;
    markdup_cols_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), R, stride, count, kmax,
        static_cast<const uint32_t*>(lib), static_cast<uint32_t*>(out),
        static_cast<uint8_t*>(elig));
  }
  return static_cast<int>(cudaGetLastError());
}
