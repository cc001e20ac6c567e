// K1: fixed-field unpack of BAM records, for Hopper (sm_90a).
//
// Replaces: hadoop_bam_tpu/ops/unpack_bam.py::unpack_fixed_fields_pallas
//   (the Pallas kernel at :113, pallas_call :138, body :127-134), and its
//   jnp twin unpack_fixed_fields (:104), whose gather semantics it keeps.
//
// What bounds it on the card: bytes.  Per record it reads a 4-byte offset
//   and the record's 36-byte fixed prefix and writes twelve int32 columns
//   (48 bytes); there are a dozen integer operations per record, far
//   below the card's arithmetic rate.
//
// What the design does about it: one thread per record, 256 threads a
//   block, no padding of N to any multiple.  The prefix is read as ten
//   aligned 32-bit words covering it and shifted into place with
//   __funnelshift_r (records start at any byte, so byte loads would issue
//   36 loads per record instead of 10).  Each column is written by
//   consecutive threads to consecutive addresses (coalesced stores).
//   Records whose 40-byte window would leave the buffer take a byte path
//   with the reference's index rule: index = offset + k, plus D when
//   negative, then clamped to [0, D-1] (JAX gather semantics), so no load
//   ever leaves the buffer.
//
// Output layout: out[f * N + r] for field f in FIXED_FIELDS order
//   (block_size, refid, pos, l_read_name, mapq, bin, n_cigar, flag, l_seq,
//   mate_refid, mate_pos, tlen).  1- and 2-byte fields are zero-extended;
//   4-byte fields are reinterpreted as int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPrefix = 36;
constexpr int kFields = 12;

__device__ __forceinline__ uint32_t clamped_byte(const uint8_t* data,
                                                 int64_t d, int64_t i) {
  if (i < 0) i += d;
  i = i < 0 ? 0 : (i > d - 1 ? d - 1 : i);
  return __ldg(data + i);
}

__global__ void __launch_bounds__(kThreads)
unpack_fixed_fields_kernel(const uint8_t* __restrict__ data, int64_t d,
                           const int32_t* __restrict__ offsets, int64_t n,
                           int32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int64_t o = offsets[r];
  uint32_t w[9];  // the 36 prefix bytes as 9 little-endian words
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data) + o;
  const uint8_t* aligned =
      reinterpret_cast<const uint8_t*>(addr & ~static_cast<uintptr_t>(3));
  if (o >= 0 && aligned >= data && aligned + 40 <= data + d) {
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(aligned);
    const uint32_t sh = static_cast<uint32_t>(addr & 3) * 8;
    uint32_t raw[10];
#pragma unroll
    for (int j = 0; j < 10; ++j) raw[j] = __ldg(wp + j);
#pragma unroll
    for (int j = 0; j < 9; ++j) w[j] = __funnelshift_r(raw[j], raw[j + 1], sh);
  } else {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        v |= clamped_byte(data, d, o + 4 * j + b) << (8 * b);
      w[j] = v;
    }
  }
  int32_t f[kFields];
  f[0] = static_cast<int32_t>(w[0]);            // block_size
  f[1] = static_cast<int32_t>(w[1]);            // refid
  f[2] = static_cast<int32_t>(w[2]);            // pos
  f[3] = static_cast<int32_t>(w[3] & 0xFF);     // l_read_name
  f[4] = static_cast<int32_t>((w[3] >> 8) & 0xFF);  // mapq
  f[5] = static_cast<int32_t>(w[3] >> 16);      // bin
  f[6] = static_cast<int32_t>(w[4] & 0xFFFF);   // n_cigar
  f[7] = static_cast<int32_t>(w[4] >> 16);      // flag
  f[8] = static_cast<int32_t>(w[5]);            // l_seq
  f[9] = static_cast<int32_t>(w[6]);            // mate_refid
  f[10] = static_cast<int32_t>(w[7]);           // mate_pos
  f[11] = static_cast<int32_t>(w[8]);           // tlen
#pragma unroll
  for (int k = 0; k < kFields; ++k) out[k * n + r] = f[k];
}

}  // namespace

extern "C" int hbam_unpack_fixed_fields(const void* data, int64_t d,
                                        const void* offsets, int64_t n,
                                        void* out, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    unpack_fixed_fields_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), d,
        static_cast<const int32_t*>(offsets), n, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
