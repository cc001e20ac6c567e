// K11: the BCF device unpack, for Hopper (sm_90a), one launch a span: each
// record's CHROM and POS from its fixed prefix, each sample's ALT dosage
// from its GT vector, read straight out of the resolved span buffer K7+K8
// wrote, the dosage tile's pads and the flags column.
//
// Replaces: hadoop_bam_tpu/ops/inflate_device.py::variant_prefix_device
//   (:391) and variant_gt_dosage_device (:413), and the reference's -1 tile
//   and per-group scatter around them (parallel/variant_pipeline.py
//   :778-797).  Its index rule and genotype semantics are kept byte for
//   byte:
//   - every byte index is start + k in int32 arithmetic (it wraps), then
//     clipped to [0, L - 1], so a pad start of 0 or below still gathers
//     and no load leaves the buffer;
//   - a GT entry is `width` (1, 2 or 4) little-endian bytes, sign
//     extended; the END_OF_VECTOR sentinel (MISSING + 1) trims ploidy;
//     any MISSING allele, or any allele value 0 or 1 (g >> 1 == 0), makes
//     the call -1; otherwise the call is the count of ALT alleles
//     ((g >> 1) - 1 > 0), saturated at 127.
//
// Input: one packed int32 array (ops/inflate_device.pack_variant_meta),
//   copied to the card once:
//     [0] n      records (the packer gives every tile row an entry)
//     [1] P      row entries
//     [2] mode   bits: 1 CHROM/POS, 2 flags, 4 dosage, 8 every column
//     [3] starts word offset of the starts [R]
//     [4] flags  word offset of the flags (R bytes)
//     [5-7]      0
//     [8..8+4P)  the row entries, 16 bytes each: (GT offset, tile row,
//                width | count << 8, n_sample).  Width 0 writes -1: the
//                rows of no GT layout and the pad rows n..R-1.
//   Each entry carries its row's layout, so a task needs one 16-byte load
//   at a place known before the header arrives, and no table walk.  With
//   mode bit 8 a row's columns n_sample..s_pad-1 are -1 and every cell of
//   the [R, s_pad] tile is written once; without it only [0, n_sample)
//   (the gt_dosage entry point).
//
// Bound: bytes.  Each GT row reads width * count * n_sample bytes and its
//   16-byte entry; each row reads an 8-byte prefix, a 4-byte start and a
//   flag byte and writes 8 + 1 bytes; the tile's R * s_pad bytes are
//   written once.  About ten integer operations a call, far below the
//   card's arithmetic rate: the time is the chain of dependent loads
//   (entry, then GT bytes) and the loads in flight.
//
// Design.  A grid of up to 4 CTAs an SM (the launch bounds hold a thread
// to 64 registers) walks one flat task list by a grid stride: (row entry,
// 512 columns) first, a lane taking 16 columns, then 32 rows of CHROM /
// POS / flags (a lane a row).  A warp's first entry is loaded beside the
// header, and each next one before this task's work, so a task waits on
// its GT bytes only.
// - Layouts specialised at compile time: width 1 count 2 (diploid int8,
//   every full-width row of the 1000 Genomes layout: 32 GT bytes a lane)
//   and width 1 count 1 (haploid: 16).  Their calls are decoded four
//   bytes at a time (SWAR: carry-free byte adds give each byte's class in
//   its bit 7) and gathered by __byte_perm, with no loop.  Every other
//   (width, count) takes one generic instantiation a width (a loop over
//   count, byte loads).
// - Aligned vector loads: a GT row starts at any byte.  For an interior
//   row (off >= 0, off + width*count*n_sample <= L: the clip is the
//   identity) whose task's aligned 16-byte words lie in buf, lane i loads
//   words 2i and 2i + 1 (diploid; word i haploid) from the task's
//   aligned-down start, takes the next word from lane i + 1 by
//   __shfl_down_sync (lane 31 loads it) and joins its bytes with
//   __funnelshift_r.  Every other row takes the scalar path with the exact
//   int32 wrap and clip (the generic layouts load bytes, directly where
//   the row is interior).
// - Stores: 8-byte stores of 8 calls where the tile row is 8-byte aligned
//   (every row when s_pad % 8 == 0), else byte stores.
// - The prefix: a lane reads its row's two words as K10i does (aligned
//   32-bit loads and a funnel shift, the clip byte by byte where the 8
//   bytes leave buf) and copies its flag byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;      // CTAs an SM: 64 registers a thread
constexpr int kCols = 512;         // columns a task, 16 a lane
constexpr int kMaxDevices = 64;

enum : int {
  kHdrN = 0, kHdrRows, kHdrMode, kHdrStarts, kHdrFlags, kHdrWords = 8
};
enum : int { kPrefix = 1, kFlags = 2, kDosage = 4, kFill = 8 };

__device__ __forceinline__ int32_t as_i32(uint32_t x) {
  return static_cast<int32_t>(x);
}

// byte (base + k) of buf by the reference's rule: the int32 sum wraps,
// then the index is clipped to the buffer
__device__ __forceinline__ uint32_t clip_byte(const uint8_t* buf, int64_t L,
                                              int32_t base, int64_t k) {
  const int32_t i = as_i32(static_cast<uint32_t>(base) +
                           static_cast<uint32_t>(k));
  const int64_t c = i < 0 ? 0 : (i > L - 1 ? L - 1 : i);
  return __ldg(buf + c);
}

// The little-endian 4 bytes at int32 index b + j (j = 0..3, each index
// wrapped and clipped): one or two aligned loads and a funnel shift when
// they lie in buf, else four byte loads.
__device__ __forceinline__ uint32_t word_at(const uint8_t* buf, int64_t L,
                                            uint32_t b) {
  const int32_t s = as_i32(b);
  if (s >= 0 && static_cast<int64_t>(s) + 4 <= L) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(buf + s);
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    const uint32_t sh = static_cast<uint32_t>(a & 3) * 8;
    if (reinterpret_cast<const uint8_t*>(p) >= buf) {
      if (sh == 0) return __ldg(p);
      if (reinterpret_cast<const uint8_t*>(p + 2) <= buf + L)
        return __funnelshift_r(__ldg(p), __ldg(p + 1), sh);
    }
  }
  return clip_byte(buf, L, s, 0) | (clip_byte(buf, L, s, 1) << 8) |
         (clip_byte(buf, L, s, 2) << 16) | (clip_byte(buf, L, s, 3) << 24);
}

// The width-1 allele classes of the four bytes b of w, as bit 7 of each
// byte (SWAR, no carry crosses a byte): ALT (4 <= b <= 127), bad (MISSING
// 0x80, or allele value 0 or 1), END_OF_VECTOR (0x81).  Any other byte is
// present and not ALT.
__device__ __forceinline__ void classes(uint32_t w, uint32_t& alt,
                                        uint32_t& bad, uint32_t& eov) {
  alt = ((w & 0x7F7F7F7Fu) + 0x7C7C7C7Cu) & ~w & 0x80808080u;
  const uint32_t t = w & 0x7E7E7E7Eu;             // 0 for 0, 1, 0x80, 0x81
  const uint32_t z = ~((t + 0x7F7F7F7Fu) | t) & 0x80808080u;
  const uint32_t u = w ^ 0x81818181u;
  eov = ~(((u & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | u) & 0x80808080u;
  bad = z & ~eov;
}

// The diploid calls of the two samples in w (bytes 0-1, 2-3), in bytes 0
// and 2: -1 when an allele is bad or both are END_OF_VECTOR, else the ALT
// count.
__device__ __forceinline__ uint32_t calls2(uint32_t w) {
  uint32_t alt, bad, eov;
  classes(w, alt, bad, eov);
  const uint32_t off = bad | (bad >> 8) | (eov & (eov >> 8));
  const uint32_t n_alt =
      ((alt >> 7) & 0x00010001u) + ((alt >> 15) & 0x00010001u);
  return n_alt | (((off >> 7) & 0x00010001u) * 0xFFu);
}

// the haploid calls of the four samples in w, one a byte
__device__ __forceinline__ uint32_t calls1(uint32_t w) {
  uint32_t alt, bad, eov;
  classes(w, alt, bad, eov);
  return ((alt >> 7) & 0x01010101u) |
         ((((bad | eov) >> 7) & 0x01010101u) * 0xFFu);
}

// -1 in the bytes of call word k (calls 4k..4k+3) at or past nv valid calls
__device__ __forceinline__ uint32_t pad_calls(uint32_t d, int k, int nv) {
  const int m = nv - 4 * k;
  return m >= 4 ? d : (m <= 0 ? ~0u : d | (~0u << (8 * m)));
}

// A lane's 16 calls d (byte j of word j / 4) at columns [col, col + 16) of
// its tile row, the columns at or past cols left alone: 8-byte stores
// where the row is 8-byte aligned and the 8 columns whole, else bytes.
__device__ __forceinline__ void store_calls(int8_t* out, bool aligned,
                                            int col, int cols,
                                            const uint32_t (&d)[4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int c = col + 8 * k;
    if (c >= cols) return;
    if (aligned && c + 8 <= cols) {
      *reinterpret_cast<uint2*>(out + c) = make_uint2(d[2 * k], d[2 * k + 1]);
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (c + b < cols)
          out[c + b] = static_cast<int8_t>(
              (d[2 * k + (b >> 2)] >> (8 * (b & 3))) & 0xFFu);
    }
  }
}

// 16 bytes at byte shift sh (0..15) of the 32 bytes c:n
__device__ __forceinline__ void join16(const uint4& c, const uint4& n,
                                       uint32_t sh, uint32_t* v) {
  uint32_t t[5];
  switch (sh >> 2) {
    case 0: t[0] = c.x; t[1] = c.y; t[2] = c.z; t[3] = c.w; t[4] = n.x; break;
    case 1: t[0] = c.y; t[1] = c.z; t[2] = c.w; t[3] = n.x; t[4] = n.y; break;
    case 2: t[0] = c.z; t[1] = c.w; t[2] = n.x; t[3] = n.y; t[4] = n.z; break;
    default: t[0] = c.w; t[1] = n.x; t[2] = n.y; t[3] = n.z; t[4] = n.w; break;
  }
  const uint32_t r = (sh & 3u) * 8u;
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __funnelshift_r(t[k], t[k + 1], r);
}

// A width-1 row of count C (1 or 2), one task: lane i's 16 samples from
// s0 + 16i and their 16 * C GT bytes v (zero past the row), by aligned
// words where the row is interior and its words lie in buf.  Lanes whose
// samples lie past n_sample still take part in the shuffles.
template <int C>
__device__ __forceinline__ void load_w1(const uint8_t* buf, int64_t L,
                                        int32_t off, int ns, int s0,
                                        int lane, uint32_t (&v)[4 * C]) {
  const int s_end = s0 + kCols < ns ? s0 + kCols : ns;
  const int64_t nbytes = static_cast<int64_t>(C) * ns;
#pragma unroll
  for (int k = 0; k < 4 * C; ++k) v[k] = 0u;
  if (s_end <= s0) return;   // warp-uniform, as is the path below
  bool fast = off >= 0 && static_cast<int64_t>(off) + nbytes <= L;
  const uint8_t *p0 = buf, *p1 = buf;
  uintptr_t a0 = 0;
  if (fast) {
    p0 = buf + off + C * s0;
    p1 = buf + off + C * s_end;
    a0 = reinterpret_cast<uintptr_t>(p0) & ~static_cast<uintptr_t>(15);
    const uintptr_t a1 = (reinterpret_cast<uintptr_t>(p1) + 15) &
                         ~static_cast<uintptr_t>(15);
    fast = a0 >= reinterpret_cast<uintptr_t>(buf) &&
           a1 <= reinterpret_cast<uintptr_t>(buf + L);
  }
  if (fast) {
    const uint4* A = reinterpret_cast<const uint4*>(a0) + C * lane;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    uint4 w[C + 1];
#pragma unroll
    for (int k = 0; k < C; ++k)
      w[k] = reinterpret_cast<const uint8_t*>(A + k) < p1 ? __ldg(A + k) : z;
    w[C].x = __shfl_down_sync(0xFFFFFFFFu, w[0].x, 1);
    w[C].y = __shfl_down_sync(0xFFFFFFFFu, w[0].y, 1);
    w[C].z = __shfl_down_sync(0xFFFFFFFFu, w[0].z, 1);
    w[C].w = __shfl_down_sync(0xFFFFFFFFu, w[0].w, 1);
    if (lane == 31)
      w[C] = reinterpret_cast<const uint8_t*>(A + C) < p1 ? __ldg(A + C) : z;
    const uint32_t sh =
        static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p0) & 15);
#pragma unroll
    for (int k = 0; k < C; ++k) join16(w[k], w[k + 1], sh, v + 4 * k);
  } else {
    const int64_t b0 = static_cast<int64_t>(C) * (s0 + 16 * lane);
#pragma unroll
    for (int j = 0; j < 16 * C; ++j)
      if (b0 + j < nbytes)
        v[j >> 2] |= clip_byte(buf, L, off, b0 + j) << (8 * (j & 3));
  }
}

// lane's 16 calls of a width-1 row from its GT bytes v, -1 past n_sample
template <int C>
__device__ __forceinline__ void calls_w1(const uint32_t (&v)[4 * C], int nv,
                                         uint32_t (&d)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    d[k] = C == 2 ? __byte_perm(calls2(v[2 * k]), calls2(v[2 * k + 1]),
                                0x6420)
                  : calls1(v[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = pad_calls(d[k], k, nv);
}

// the allele of `width` little-endian bytes at GT byte k of a row
template <int W>
__device__ __forceinline__ int32_t allele(const uint8_t* buf, int64_t L,
                                          int32_t off, int64_t k,
                                          bool interior) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < W; ++b)
    v |= (interior ? static_cast<uint32_t>(__ldg(buf + off + k + b))
                   : clip_byte(buf, L, off, k + b)) << (8 * b);
  if (W == 1) return static_cast<int8_t>(v);
  if (W == 2) return static_cast<int16_t>(v);
  return as_i32(v);
}

// lane's 16 calls of a row of any layout: a loop over samples and count,
// byte loads (direct where the row is interior)
template <int W>
__device__ __forceinline__ void calls_generic(const uint8_t* buf, int64_t L,
                                              int32_t off, int count, int ns,
                                              int s_lane,
                                              uint32_t (&d)[4]) {
  constexpr int32_t kMissing = W == 1 ? -128 : (W == 2 ? -32768 : INT32_MIN);
  constexpr int32_t kEov = kMissing + 1;
  const int64_t stride = static_cast<int64_t>(W) * count;
  const bool interior =
      off >= 0 && static_cast<int64_t>(off) + stride * ns <= L;
  uint64_t lo = 0, hi = 0;
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    uint64_t x = 0xFFu;
    if (s_lane + j < ns) {
      bool any_present = false, any_bad = false;
      int alt = 0;
      const int64_t at = (s_lane + j) * stride;
      for (int c = 0; c < count; ++c) {
        const int32_t g = allele<W>(buf, L, off, at + W * c, interior);
        if (g == kEov) continue;
        any_present = true;
        any_bad |= (g >> 1) == 0 || g == kMissing;
        alt += (g >> 1) - 1 > 0;
      }
      if (any_present && !any_bad) x = alt < 127 ? alt : 127;
    }
    if (j < 8)
      lo |= x << (8 * j);
    else
      hi |= x << (8 * (j - 8));
  }
  d[0] = static_cast<uint32_t>(lo);
  d[1] = static_cast<uint32_t>(lo >> 32);
  d[2] = static_cast<uint32_t>(hi);
  d[3] = static_cast<uint32_t>(hi >> 32);
}

// One (row entry, 512 columns) task: lane's columns [s_lane, s_lane + 16)
__device__ __forceinline__ void row_task(const uint8_t* buf, int64_t L,
                                         const int4& e, int chunk, int R,
                                         int s_pad, bool fill,
                                         int8_t* dosage, int lane) {
  const int row = e.y, width = e.z & 0xFF, count = e.z >> 8;
  const int ns = e.w < 0 ? 0 : (e.w > s_pad ? s_pad : e.w);
  const int cols = (width == 0 || fill) ? s_pad : ns;
  const int s0 = chunk * kCols;
  if (row < 0 || row >= R || s0 >= cols) return;   // a scatter drops it
  int8_t* out = dosage + static_cast<int64_t>(row) * s_pad;
  const bool aligned = (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  const int s_lane = s0 + 16 * lane;
  uint32_t d[4] = {~0u, ~0u, ~0u, ~0u};
  if (width == 1 && count == 2) {
    uint32_t v[8];
    load_w1<2>(buf, L, e.x, ns, s0, lane, v);
    calls_w1<2>(v, ns - s_lane, d);
  } else if (width == 1 && count == 1) {
    uint32_t v[4];
    load_w1<1>(buf, L, e.x, ns, s0, lane, v);
    calls_w1<1>(v, ns - s_lane, d);
  } else if (count >= 1 && (width == 1 || width == 2 || width == 4)) {
    if (width == 1)
      calls_generic<1>(buf, L, e.x, count, ns, s_lane, d);
    else if (width == 2)
      calls_generic<2>(buf, L, e.x, count, ns, s_lane, d);
    else
      calls_generic<4>(buf, L, e.x, count, ns, s_lane, d);
  } else if (width != 0) {
    return;   // no such layout: the packer writes none
  }
  store_calls(out, aligned, s_lane, cols, d);
}

// t / chunks and t % chunks, in 32 bits where t fits
__device__ __forceinline__ void split_task(int64_t t, int chunks,
                                           int64_t& entry, int& chunk) {
  if (t <= INT32_MAX) {
    const uint32_t q = static_cast<uint32_t>(t) / static_cast<uint32_t>(chunks);
    entry = q;
    chunk = static_cast<int>(static_cast<uint32_t>(t) - q * chunks);
  } else {
    entry = t / chunks;
    chunk = static_cast<int>(t - entry * chunks);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
variant_unpack_kernel(const uint8_t* __restrict__ buf, int64_t L,
                      const int32_t* __restrict__ meta, int64_t meta_len,
                      int R, int s_pad, int allowed,
                      int32_t* __restrict__ chrom, int32_t* __restrict__ pos,
                      uint8_t* __restrict__ flags,
                      int8_t* __restrict__ dosage) {
  const int4* entries = reinterpret_cast<const int4*>(meta + kHdrWords);
  const int64_t room = (meta_len - kHdrWords) / 4;   // entries that fit
  const int chunks = (s_pad + kCols - 1) / kCols;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  // the first task's entry is loaded beside the header, not after it
  int64_t i = 0;
  int chunk = 0;
  if (chunks > 0) split_task(t, chunks, i, chunk);
  int4 e = chunks > 0 && i < room ? __ldg(entries + i) : make_int4(0, 0, 0, 0);
  const int4 h = __ldg(reinterpret_cast<const int4*>(meta));
  const int h_flags = __ldg(meta + kHdrFlags);
  const int P = h.y;
  const int mode = h.z & allowed;
  const int64_t at_starts = h.w, at_flags = h_flags;
  // a header that does not fit its array is the caller's fault (the
  // wrapper checks it on the host): trap rather than read past it
  if (((mode & kPrefix) && (at_starts < kHdrWords ||
                            at_starts + R > meta_len)) ||
      ((mode & kFlags) && (at_flags < kHdrWords ||
                           4 * at_flags + R > 4 * meta_len)) ||
      ((mode & kDosage) && (P < 0 || P > room)))
    __trap();
  const bool fill = (mode & kFill) != 0;
  const int64_t t_prefix =
      (mode & kDosage) ? static_cast<int64_t>(P) * chunks : 0;
  const int64_t total =
      t_prefix + ((mode & (kPrefix | kFlags)) ? (R + 31) / 32 : 0);
  for (; t < t_prefix; t += warps) {
    const int4 cur = e;
    const int cur_chunk = chunk;
    if (t + warps < t_prefix) {   // the next entry in flight meanwhile
      split_task(t + warps, chunks, i, chunk);
      e = __ldg(entries + i);
    }
    row_task(buf, L, cur, cur_chunk, R, s_pad, fill, dosage, lane);
  }
  for (; t < total; t += warps) {
    const int r = static_cast<int>(t - t_prefix) * 32 + lane;
    if (r >= R) continue;
    if (mode & kPrefix) {
      const uint32_t st = static_cast<uint32_t>(__ldg(meta + at_starts + r));
      chrom[r] = as_i32(word_at(buf, L, st + 8u));
      pos[r] = as_i32(word_at(buf, L, st + 12u) + 1u);   // 1-based, wraps
    }
    if (mode & kFlags)
      flags[r] = __ldg(reinterpret_cast<const uint8_t*>(meta + at_flags) + r);
  }
}

int g_ctas_per_sm[kMaxDevices];
int g_sms[kMaxDevices];

}  // namespace

// meta: int32 [meta_len], the packed array above, 16-byte aligned;
// chrom, pos: int32 [R], flags: uint8 [R], dosage: int8 [R, s_pad] (a null
// pointer takes its part out of the header's mode)
extern "C" int hbam_variant_unpack(const void* buf, int64_t L,
                                   const void* meta, int64_t meta_len,
                                   int64_t R, int64_t s_pad, void* chrom,
                                   void* pos, void* flags, void* dosage,
                                   void* stream) {
  // tile rows and columns, and a width-1 row's bytes, fit int32
  if (L <= 0 || L > INT32_MAX || R < 0 || R > INT32_MAX || s_pad < 0 ||
      s_pad > (1 << 28) || meta_len < kHdrWords)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(meta) & 15)   // read as int4
    return static_cast<int>(cudaErrorMisalignedAddress);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (g_ctas_per_sm[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, variant_unpack_kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_sms[dev] = sms;
    g_ctas_per_sm[dev] = per_sm > 0 ? per_sm : 1;
  }
  // a warp a task where the grid allows: the packer gives each of the R
  // rows one entry, cut in 512 columns, and the prefix takes R / 32
  const int64_t tasks = R * ((s_pad + kCols - 1) / kCols) + (R + 31) / 32;
  const int64_t want = (tasks + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(g_ctas_per_sm[dev]) * g_sms[dev];
  const int64_t blocks = want < 1 ? 1 : (want < cap ? want : cap);
  const int allowed = (chrom && pos ? kPrefix : 0) | (flags ? kFlags : 0) |
                      (dosage ? kDosage | kFill : 0);
  variant_unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), L, static_cast<const int32_t*>(meta),
      meta_len, static_cast<int>(R), static_cast<int>(s_pad), allowed,
      static_cast<int32_t*>(chrom), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(flags), static_cast<int8_t*>(dosage));
  return static_cast<int>(cudaGetLastError());
}
