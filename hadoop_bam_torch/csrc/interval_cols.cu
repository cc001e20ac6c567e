// K10i: the interval columns of the serve-tile device build, for Hopper
// (sm_90a).
//
// Replaces the interval half of hadoop_bam_tpu/ops/inflate_device.py::
// resolve_walk_intervals (:359-388): after the resolve (K7+K8), the record
// walk (K9) and the fixed-field gather (K1), each walked record's
// (rid, pos1, end1) in the 1-based inclusive form the serve tile filter
// compares, with end1 from the record's own CIGAR.  The reference gathers
// a [R, 64] tile of CIGAR words (256 bytes a row, whatever the CIGAR's
// length); here each row walks only its own ops.
//
// Per row r (int32 arithmetic wrapping as the reference's does):
//   valid   = r < min(n_all, R)
//   cig_off = offs + 36 + l_read_name
//   word k  = the 4 bytes at clamp(cig_off + 4k + j, 0, L - 1), j = 0..3,
//             little-endian (the CIGAR is not 4-aligned in the buffer)
//   span    = sum of (word >> 4) over k < min(n_cigar, cap) whose
//             op (word & 15) is M, D, N, = or X (0, 2, 3, 7, 8)
//   ref     = n_cigar > 0 ? span : max(l_seq, 0)
//   pos1    = min(pos, 2^31 - 2) + 1
//   end1    = pos1 + min(max(ref, 1) - 1, 2^31 - 1 - pos1)
//   out     = valid ? (refid, pos1, end1) : (-1, 0, 0)
//   over    = 1 when a valid row has n_cigar > cap, else 0
//
// Bound: bytes.  The three [R] outputs are written once; a valid row
// reads its five columns and offset once and its CIGAR bytes once; the
// rows past the walk's count read nothing.
//
// Design: one thread a row, grid-stride.  n_all is read on the card (no
// host sync before the launch).  A valid row reads its CIGAR with byte
// loads, at most cap words; the op lengths sum in uint32 (the reference's
// int32 sum wraps).  ``over`` is zeroed by a memset on the same stream,
// and each CTA that saw an over-cap row sets it with one atomicOr after a
// __syncthreads_or.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t as_i32(uint32_t x) {
  return static_cast<int32_t>(x);
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* buf, int64_t L,
                                            int32_t i) {
  const int64_t j = i < 0 ? 0 : (i >= L ? L - 1 : static_cast<int64_t>(i));
  return static_cast<uint32_t>(__ldg(buf + j));
}

__global__ void __launch_bounds__(kThreads) interval_cols_kernel(
    const uint8_t* __restrict__ buf, int64_t L,
    const int32_t* __restrict__ offs, const int32_t* __restrict__ refid,
    const int32_t* __restrict__ pos, const int32_t* __restrict__ l_read_name,
    const int32_t* __restrict__ n_cigar, const int32_t* __restrict__ l_seq,
    const int32_t* __restrict__ n_all, int R, int cap,
    int32_t* __restrict__ rid_out, int32_t* __restrict__ pos1_out,
    int32_t* __restrict__ end1_out, int32_t* __restrict__ over) {
  const int32_t na = __ldg(n_all);
  const int n_valid = na < R ? na : R;
  const int stride = gridDim.x * blockDim.x;
  int my_over = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R; r += stride) {
    if (r >= n_valid) {
      rid_out[r] = -1;
      pos1_out[r] = 0;
      end1_out[r] = 0;
      continue;
    }
    const int32_t nc = __ldg(n_cigar + r);
    const int32_t ls = __ldg(l_seq + r);
    my_over |= nc > cap;
    const int32_t k_end = nc < cap ? nc : cap;
    const uint32_t cig_off = static_cast<uint32_t>(__ldg(offs + r)) + 36u +
                             static_cast<uint32_t>(__ldg(l_read_name + r));
    uint32_t span = 0;
    for (int32_t k = 0; k < k_end; ++k) {
      const uint32_t w = cig_off + 4u * static_cast<uint32_t>(k);
      const uint32_t word = byte_at(buf, L, as_i32(w)) |
                            (byte_at(buf, L, as_i32(w + 1u)) << 8) |
                            (byte_at(buf, L, as_i32(w + 2u)) << 16) |
                            (byte_at(buf, L, as_i32(w + 3u)) << 24);
      const uint32_t op = word & 0xFu;
      if (op == 0u || op == 2u || op == 3u || op == 7u || op == 8u)
        span += word >> 4;
    }
    const int32_t ref = nc > 0 ? as_i32(span) : (ls > 0 ? ls : 0);
    const int32_t p = __ldg(pos + r);
    const int32_t pos1 = (p < INT32_MAX - 1 ? p : INT32_MAX - 1) + 1;
    const int32_t t = (ref > 1 ? ref : 1) - 1;
    const int32_t room =
        as_i32(static_cast<uint32_t>(INT32_MAX) - static_cast<uint32_t>(pos1));
    const int32_t m = t < room ? t : room;
    rid_out[r] = __ldg(refid + r);
    pos1_out[r] = pos1;
    end1_out[r] = as_i32(static_cast<uint32_t>(pos1) + static_cast<uint32_t>(m));
  }
  if (__syncthreads_or(my_over) && threadIdx.x == 0) atomicOr(over, 1);
}

}  // namespace

extern "C" int hbam_interval_cols(
    const void* buf, int64_t L, const void* offs, const void* refid,
    const void* pos, const void* l_read_name, const void* n_cigar,
    const void* l_seq, const void* n_all, int64_t R, int64_t cap, void* rid,
    void* pos1, void* end1, void* over, void* stream) {
  if (L <= 0 || R < 0 || R > INT32_MAX || cap < 0 || cap > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(over, 0, sizeof(int32_t), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (R == 0) return 0;
  const int64_t blocks = (R + kThreads - 1) / kThreads;
  interval_cols_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(buf), L, static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(refid), static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(l_read_name),
      static_cast<const int32_t*>(n_cigar), static_cast<const int32_t*>(l_seq),
      static_cast<const int32_t*>(n_all), static_cast<int>(R),
      static_cast<int>(cap), static_cast<int32_t*>(rid),
      static_cast<int32_t*>(pos1), static_cast<int32_t*>(end1),
      static_cast<int32_t*>(over));
  return static_cast<int>(cudaGetLastError());
}
