// K10p: the segmented seq/qual gather of the device decode plane, for
// Hopper (sm_90a).
//
// Replaces the payload half of hadoop_bam_tpu/ops/inflate_device.py::
// resolve_walk_payload (:320-330): each kept record's packed 4-bit bases
// and quality bytes lifted from the inflated buffer into fixed-stride
// [R, seq_stride] / [R, qual_stride] tiles, the layout the K2 stats kernel
// reads.  In plain PyTorch this is an int64 index tensor of R x 256
// entries per chunk (268 MB at R = 131,072); here no index exists.
//
// Per row r (int32 arithmetic wrapping as the reference's does):
//   valid  = r < min(n_all, R)
//   use    = valid ? clamp(l_seq, 0, max_len) : 0
//   seq_off = offs + 36 + l_read_name + 4 * n_cigar
//   nb     = (max(l_seq, 0) + 1) >> 1
//   seq[r, j]  = j < (use + 1) >> 1 ? buf[clamp(seq_off + j, 0, L - 1)] : 0
//   qual[r, j] = j < use ? buf[clamp(seq_off + nb + j, 0, L - 1)] : 0
//
// Design: one thread per 16-byte piece of an output row (seq pieces, then
// qual pieces), consecutive threads on consecutive pieces of a row and
// rows after each other, so the stores are coalesced 16-byte vectors when
// the strides and base addresses allow, byte stores otherwise.  The
// source bytes of a row are contiguous, so a warp's loads fall on a few
// lines.  Bound: bytes -- the output tiles are written once (mostly
// zeros: R rows per chunk against the real records).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void payload_gather_kernel(
    const uint8_t* __restrict__ buf, long long L,
    const int32_t* __restrict__ offs, const int32_t* __restrict__ l_seq,
    const int32_t* __restrict__ l_read_name,
    const int32_t* __restrict__ n_cigar, const int32_t* __restrict__ n_all,
    int R, int max_len, int seq_stride, int qual_stride,
    uint8_t* __restrict__ seq, uint8_t* __restrict__ qual, bool vec) {
  const int seq_pieces = (seq_stride + 15) >> 4;
  const int pieces = seq_pieces + ((qual_stride + 15) >> 4);
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (g >= static_cast<long long>(R) * pieces) return;
  const int r = static_cast<int>(g / pieces);
  const int piece = static_cast<int>(g - static_cast<long long>(r) * pieces);
  const int n_valid = min(max(*n_all, 0), R);

  int use = 0;
  int32_t from = 0;
  int limit = 0;
  uint8_t* dst;
  int j0, width;
  const bool is_seq = piece < seq_pieces;
  if (is_seq) {
    j0 = piece << 4;
    width = seq_stride;
    dst = seq + static_cast<long long>(r) * seq_stride;
  } else {
    j0 = (piece - seq_pieces) << 4;
    width = qual_stride;
    dst = qual + static_cast<long long>(r) * qual_stride;
  }
  if (r < n_valid) {
    const int32_t ls = l_seq[r];
    use = min(max(ls, 0), max_len);
    const int32_t seq_off = wrap_add(
        wrap_add(offs[r], 36),
        wrap_add(l_read_name[r], static_cast<int32_t>(
                                     static_cast<uint32_t>(n_cigar[r]) * 4u)));
    if (is_seq) {
      from = seq_off;
      limit = (use + 1) >> 1;
    } else {
      const int32_t nb = wrap_add(max(ls, 0), 1) >> 1;
      from = wrap_add(seq_off, nb);
      limit = use;
    }
  }
  uint8_t v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int j = j0 + k;
    uint8_t x = 0;
    if (j < limit) {
      long long q = wrap_add(from, j);
      q = q < 0 ? 0 : (q > L - 1 ? L - 1 : q);
      x = buf[q];
    }
    v[k] = x;
  }
  if (vec && j0 + 16 <= width) {
    uint4 w;
    w.x = v[0] | (v[1] << 8) | (v[2] << 16) | (uint32_t(v[3]) << 24);
    w.y = v[4] | (v[5] << 8) | (v[6] << 16) | (uint32_t(v[7]) << 24);
    w.z = v[8] | (v[9] << 8) | (v[10] << 16) | (uint32_t(v[11]) << 24);
    w.w = v[12] | (v[13] << 8) | (v[14] << 16) | (uint32_t(v[15]) << 24);
    *reinterpret_cast<uint4*>(dst + j0) = w;
  } else {
    for (int k = 0; k < 16 && j0 + k < width; ++k) dst[j0 + k] = v[k];
  }
}

}  // namespace

extern "C" int hbam_payload_gather(
    const void* buf, int64_t L, const void* offs, const void* l_seq,
    const void* l_read_name, const void* n_cigar, const void* n_all,
    int64_t R, int64_t max_len, int64_t seq_stride, int64_t qual_stride,
    void* seq, void* qual, void* stream) {
  if (R <= 0) return 0;
  if (L <= 0 || seq_stride < 0 || qual_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pieces = ((seq_stride + 15) >> 4) + ((qual_stride + 15) >> 4);
  if (pieces == 0) return 0;
  // 16-byte stores need 16-byte aligned rows in both tiles
  const bool vec = seq_stride % 16 == 0 && qual_stride % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(seq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qual) % 16 == 0;
  const long long threads = R * pieces;
  const unsigned grid = static_cast<unsigned>((threads + kThreads - 1) /
                                              kThreads);
  payload_gather_kernel<<<grid, kThreads, 0,
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
