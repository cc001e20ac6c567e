// K11: the BCF device unpack, for Hopper (sm_90a): each record's CHROM and
// POS from its fixed prefix, and each sample's ALT dosage from its GT
// vector, read straight out of the resolved span buffer K7+K8 wrote.
//
// Replaces: hadoop_bam_tpu/ops/inflate_device.py::variant_prefix_device
//   (:391) and variant_gt_dosage_device (:413), whose index rule and
//   genotype semantics both kernels keep byte for byte:
//   - every byte index is start + k in int32 arithmetic (it wraps), then
//     clipped to [0, L - 1], so a pad start of 0 or below still gathers
//     and no load leaves the buffer;
//   - a GT entry is `width` (1, 2 or 4) little-endian bytes, sign
//     extended; the END_OF_VECTOR sentinel (MISSING + 1) trims ploidy;
//     any MISSING allele, or any allele value 0 or 1 (g >> 1 == 0), makes
//     the call -1; otherwise the call is the count of ALT alleles
//     ((g >> 1) - 1 > 0), saturated at 127.
//
// What bounds it on the card: bytes.  variant_prefix reads 8 bytes and a
//   4-byte start per record and writes 8; gt_dosage reads each group
//   row's width * count * n_sample genotype bytes, its 4-byte offset and
//   its 4-byte row index, and writes n_sample dosage bytes.  A few integer
//   operations a byte, far below the card's arithmetic rate.
//
// What the design does about it (a first, simple mapping): variant_prefix
//   takes one thread a record.  gt_dosage takes one CTA a group row and
//   its threads over the samples, byte loads of each sample's vector, and
//   stores each dosage at its row of the [R, s_pad] int8 tile directly:
//   no [rows, n_sample] intermediate, no scatter, no int64 index.
//   Consecutive threads read consecutive vectors (width * count bytes
//   apart) and store consecutive bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPrefixThreads = 256;
constexpr int kGtThreads = 256;

// byte (base + k) of buf by the reference's rule: the int32 sum wraps,
// then the index is clipped to the buffer
__device__ __forceinline__ uint32_t clip_byte(const uint8_t* buf, int64_t len,
                                              int32_t base, int64_t k) {
  const int32_t i = static_cast<int32_t>(static_cast<uint32_t>(base) +
                                         static_cast<uint32_t>(k));
  const int64_t c = i < 0 ? 0 : (i > len - 1 ? len - 1 : i);
  return __ldg(buf + c);
}

__global__ void __launch_bounds__(kPrefixThreads)
variant_prefix_kernel(const uint8_t* __restrict__ buf, int64_t len,
                      const int32_t* __restrict__ starts, int64_t n,
                      int32_t* __restrict__ chrom, int32_t* __restrict__ pos) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kPrefixThreads +
                    threadIdx.x;
  if (r >= n) return;
  const int32_t s = starts[r];
  uint32_t c = 0, p = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    c |= clip_byte(buf, len, s, 8 + b) << (8 * b);
    p |= clip_byte(buf, len, s, 12 + b) << (8 * b);
  }
  chrom[r] = static_cast<int32_t>(c);
  pos[r] = static_cast<int32_t>(p + 1u);  // 1-based, int32 wrap
}

__global__ void __launch_bounds__(kGtThreads)
gt_dosage_kernel(const uint8_t* __restrict__ buf, int64_t len,
                 const int32_t* __restrict__ gt_off,
                 const int32_t* __restrict__ rows, int width, int count,
                 int64_t n_sample, int8_t* __restrict__ dosage, int64_t n_rows,
                 int64_t s_pad) {
  const int64_t g_row = blockIdx.x;
  const int32_t row = rows[g_row];
  if (row < 0 || row >= n_rows) return;
  const int32_t off = gt_off[g_row];
  const int64_t stride = static_cast<int64_t>(width) * count;
  const int32_t missing = width == 1 ? -128 : (width == 2 ? -32768
                                                          : INT32_MIN);
  const int32_t eov = missing + 1;
  int8_t* out = dosage + static_cast<int64_t>(row) * s_pad;
  for (int64_t s = threadIdx.x; s < n_sample; s += kGtThreads) {
    const int64_t at = s * stride;
    bool any_present = false, any_missing = false;
    int alt = 0;
    for (int c = 0; c < count; ++c) {
      uint32_t v = 0;
      for (int b = 0; b < width; ++b)
        v |= clip_byte(buf, len, off, at + c * width + b) << (8 * b);
      int32_t g;
      if (width == 1)
        g = static_cast<int8_t>(v);
      else if (width == 2)
        g = static_cast<int16_t>(v);
      else
        g = static_cast<int32_t>(v);
      if (g == eov) continue;  // END_OF_VECTOR: not present
      any_present = true;
      if ((g >> 1) == 0 || g == missing) any_missing = true;
      if ((g >> 1) - 1 > 0) ++alt;
    }
    const int d = (any_present && !any_missing) ? (alt < 127 ? alt : 127)
                                                : -1;
    out[s] = static_cast<int8_t>(d);
  }
}

}  // namespace

// starts: int32 [n] record starts -> chrom, pos: int32 [n]
extern "C" int hbam_variant_prefix(const void* buf, int64_t len,
                                   const void* starts, int64_t n, void* chrom,
                                   void* pos, void* stream) {
  if (n <= 0) return 0;
  const int64_t grid = (n + kPrefixThreads - 1) / kPrefixThreads;
  variant_prefix_kernel<<<static_cast<unsigned>(grid), kPrefixThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), len,
      static_cast<const int32_t*>(starts), n, static_cast<int32_t*>(chrom),
      static_cast<int32_t*>(pos));
  return static_cast<int>(cudaGetLastError());
}

// gt_off, rows: int32 [g] -> dosage[rows[i], 0:n_sample] of the int8
// [n_rows, s_pad] tile; width 1, 2 or 4, count in [1, 256],
// n_sample <= s_pad
extern "C" int hbam_gt_dosage(const void* buf, int64_t len, const void* gt_off,
                              const void* rows, int64_t g, int64_t width,
                              int64_t count, int64_t n_sample, void* dosage,
                              int64_t n_rows, int64_t s_pad, void* stream) {
  if (g <= 0) return 0;
  if ((width != 1 && width != 2 && width != 4) || count < 1 || count > 256 ||
      n_sample < 0 || n_sample > s_pad || g > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  gt_dosage_kernel<<<static_cast<unsigned>(g), kGtThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), len,
      static_cast<const int32_t*>(gt_off), static_cast<const int32_t*>(rows),
      static_cast<int>(width), static_cast<int>(count), n_sample,
      static_cast<int8_t*>(dosage), n_rows, s_pad);
  return static_cast<int>(cudaGetLastError());
}
