// K10i: the interval columns of the serve-tile device build, for Hopper
// (sm_90a).
//
// Replaces the interval half of hadoop_bam_tpu/ops/inflate_device.py::
// resolve_walk_intervals (:335; the prefix gather :359-362 and the interval
// :363-386): after the resolve (K7+K8) and the record walk (K9), each
// walked record's (rid, pos1, end1) in the 1-based inclusive form the
// serve tile filter compares, with end1 from the record's own CIGAR.  It
// reads each record's fixed prefix itself, so the chain runs no K1 (the
// reference gathers its [R, 36] prefix tile inside the same jitted step).
//
// Per row r (int32 arithmetic wrapping as the reference's does; every
// byte index i, an int32, reads buf[clip(i, 0, L - 1)]):
//   valid   = r < min(n_all, R)
//   o       = offs[r]
//   refid, pos, l_seq = the little-endian int32 at o + 4, o + 8, o + 20
//   l_read_name = the byte at o + 12; n_cigar = the uint16 at o + 16
//   cig_off = o + 36 + l_read_name
//   word k  = the little-endian 4 bytes at cig_off + 4k
//   span    = sum of (word >> 4) over k < min(n_cigar, cap) whose
//             op (word & 15) is M, D, N, = or X (0, 2, 3, 7, 8)
//   ref     = n_cigar > 0 ? span : max(l_seq, 0)
//   pos1    = min(pos, 2^31 - 2) + 1
//   end1    = pos1 + min(max(ref, 1) - 1, 2^31 - 1 - pos1)
//   out     = valid ? (refid, pos1, end1) : (-1, 0, 0)
//   over    = 1 when a valid row has n_cigar > cap, else 0
//
// Bound: bytes.  Each valid row reads its 4-byte offset, its 20 prefix
// bytes (4-23) and its 4 * min(n_cigar, cap) CIGAR bytes once; the three
// [R] outputs are written once; n_all and over are 4 bytes each.
//
// Design.  The grid is ceil(R / 256) CTAs of 256 threads, sized from R
// alone: n_all is read on the card, no host sync.
// - Valid rows: eight lanes (a sub-warp) take a record, four records a
//   warp, records spread over the grid's sub-warps (grid-stride; one pass
//   while there are at most R / 8 records).  Lanes 0-4 each assemble one
//   prefix word from one or two aligned 32-bit loads and __funnelshift_r
//   (records start at any byte), and shuffle them to the sub-warp.  Lane
//   j takes CIGAR words j, j + 8, ...: when the whole CIGAR window lies in
//   buf, all of a lane's aligned loads (at most 8 words a lane for 64
//   ops) are issued before its sums; else each word takes byte loads with
//   the clip rule.  A lane sums the lengths of its M/D/N/=/X ops in
//   uint32, and one __reduce_add_sync over the sub-warp adds the lanes'
//   sums (uint32 addition is modular: the reference's wrapping int32 sum).
// - Pad rows [min(n_all, R), R): int4 stores of (-1, -1, -1, -1) and
//   zeros, four rows a thread, from the grid's last threads backwards (the
//   CTAs that walk are the first), a partial quad at either end by one
//   thread with scalar stores.
// - over, with no memset: each CTA adds 1 + (it saw an over-cap row) << 32
//   to a 64-bit word of scratch the wrapper keeps per stream (zero between
//   launches).  The CTA whose add brings the count to the grid's size
//   writes over from the sum and sets the word back to zero; launches on
//   one stream do not overlap, so no two launches share the word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                    // lanes a record
constexpr int kGroups = kThreads / kLanes;   // records a CTA a pass
constexpr int kSteps = 8;                    // CIGAR words a lane a batch

__device__ __forceinline__ int32_t as_i32(uint32_t x) {
  return static_cast<int32_t>(x);
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* buf, int64_t L,
                                            uint32_t i) {
  const int32_t s = as_i32(i);
  const int64_t j = s < 0 ? 0 : (s >= L ? L - 1 : static_cast<int64_t>(s));
  return static_cast<uint32_t>(__ldg(buf + j));
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
  return byte_at(buf, L, b) | (byte_at(buf, L, b + 1u) << 8) |
         (byte_at(buf, L, b + 2u) << 16) | (byte_at(buf, L, b + 3u) << 24);
}

__device__ __forceinline__ uint32_t ref_len(uint32_t word) {
  const uint32_t op = word & 0xFu;
  return (op == 0u || op == 2u || op == 3u || op == 7u || op == 8u)
             ? word >> 4
             : 0u;
}

// This lane's share of a record's reference span: words k = lane,
// lane + 8, ... below nw of the CIGAR at int32 index c.
__device__ __forceinline__ uint32_t cigar_part(const uint8_t* buf, int64_t L,
                                               uint32_t c, int32_t nw,
                                               int lane) {
  uint32_t part = 0;
  const int32_t s = as_i32(c);
  if (nw > 0 && s >= 0 && static_cast<int64_t>(s) + 4LL * nw <= L) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(buf + s);
    const uint32_t* p =
        reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    const uint32_t sh = static_cast<uint32_t>(a & 3) * 8;
    // the aligned words p[0 .. nw) and, when shifted, p[nw]
    if (reinterpret_cast<const uint8_t*>(p) >= buf &&
        reinterpret_cast<const uint8_t*>(p + nw + (sh ? 1 : 0)) <= buf + L) {
      for (int32_t k0 = 0; k0 < nw; k0 += kLanes * kSteps) {
        uint32_t lo[kSteps], hi[kSteps];
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          const int32_t k = k0 + lane + kLanes * i;
          lo[i] = k < nw ? __ldg(p + k) : 0u;
          hi[i] = (k < nw && sh) ? __ldg(p + k + 1) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          const int32_t k = k0 + lane + kLanes * i;
          if (k < nw) part += ref_len(__funnelshift_r(lo[i], hi[i], sh));
        }
      }
      return part;
    }
  }
  for (int32_t k = lane; k < nw; k += kLanes)
    part += ref_len(word_at(buf, L, c + 4u * static_cast<uint32_t>(k)));
  return part;
}

__global__ void __launch_bounds__(kThreads) interval_cols_kernel(
    const uint8_t* __restrict__ buf, int64_t L,
    const int32_t* __restrict__ offs, const int32_t* __restrict__ n_all,
    int64_t R, int cap, int32_t* __restrict__ rid_out,
    int32_t* __restrict__ pos1_out, int32_t* __restrict__ end1_out,
    int32_t* __restrict__ over,
    unsigned long long* __restrict__ done) {
  // the sub-warp's first row's offset is loaded beside n_all, not after
  // it: one round trip fewer on the walk's chain of dependent loads
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGroups +
                        threadIdx.x / kLanes;
  const int32_t o_first = first < R ? __ldg(offs + first) : 0;
  const int32_t na = __ldg(n_all);
  const int64_t n_valid = na < 0 ? 0 : (na < R ? na : R);
  const int lane = threadIdx.x & (kLanes - 1);
  const int group = (threadIdx.x & 31) / kLanes;
  const unsigned gmask = 0xFFu << (kLanes * group);
  int my_over = 0;

  // valid rows: one record a sub-warp
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroups;
  for (int64_t r = first; r < n_valid; r += stride) {
    const uint32_t o =
        static_cast<uint32_t>(r == first ? o_first : __ldg(offs + r));
    const uint32_t pw =
        lane < 5 ? word_at(buf, L, o + 4u + 4u * static_cast<uint32_t>(lane))
                 : 0u;
    const uint32_t w_pos = __shfl_sync(gmask, pw, 1, kLanes);
    const uint32_t w_names = __shfl_sync(gmask, pw, 2, kLanes);
    const uint32_t w_cigar = __shfl_sync(gmask, pw, 3, kLanes);
    const uint32_t w_seq = __shfl_sync(gmask, pw, 4, kLanes);
    const int32_t nc = static_cast<int32_t>(w_cigar & 0xFFFFu);
    const int32_t nw = nc < cap ? nc : cap;
    const uint32_t c = o + 36u + (w_names & 0xFFu);
    const uint32_t span =
        __reduce_add_sync(gmask, cigar_part(buf, L, c, nw, lane));
    if (lane == 0) {
      my_over |= nc > cap;
      const int32_t ls = as_i32(w_seq);
      const int32_t ref = nc > 0 ? as_i32(span) : (ls > 0 ? ls : 0);
      const int32_t p = as_i32(w_pos);
      const int32_t pos1 = (p < INT32_MAX - 1 ? p : INT32_MAX - 1) + 1;
      const int32_t t = (ref > 1 ? ref : 1) - 1;
      const int32_t room = as_i32(static_cast<uint32_t>(INT32_MAX) -
                                  static_cast<uint32_t>(pos1));
      const int32_t m = t < room ? t : room;
      rid_out[r] = as_i32(pw);
      pos1_out[r] = pos1;
      end1_out[r] = as_i32(static_cast<uint32_t>(pos1) +
                           static_cast<uint32_t>(m));
    }
  }

  // pad rows: whole quads [q_lo, q_hi) as int4, from the grid's end
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t back = threads - 1 -
                       (static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x);
  const int64_t q_lo = (n_valid + 3) >> 2, q_hi = R >> 2;
  for (int64_t q = q_lo + back; q < q_hi; q += threads) {
    reinterpret_cast<int4*>(rid_out)[q] = make_int4(-1, -1, -1, -1);
    reinterpret_cast<int4*>(pos1_out)[q] = make_int4(0, 0, 0, 0);
    reinterpret_cast<int4*>(end1_out)[q] = make_int4(0, 0, 0, 0);
  }
  if (back == 0) {   // the rows of a partial quad at either end
    const int64_t head_end = 4 * q_lo < R ? 4 * q_lo : R;
    const int64_t tail = 4 * q_hi > 4 * q_lo ? 4 * q_hi : 4 * q_lo;
    for (int64_t r = n_valid; r < head_end; ++r) {
      rid_out[r] = -1;
      pos1_out[r] = 0;
      end1_out[r] = 0;
    }
    for (int64_t r = tail; r < R; ++r) {
      rid_out[r] = -1;
      pos1_out[r] = 0;
      end1_out[r] = 0;
    }
  }

  // over: the last CTA to count itself in writes it
  const int any = __syncthreads_or(my_over);
  if (threadIdx.x == 0) {
    const unsigned long long old =
        atomicAdd(done, 1ull | (any ? 1ull << 32 : 0ull));
    if (static_cast<uint32_t>(old) == gridDim.x - 1) {
      *over = ((old >> 32) != 0 || any) ? 1 : 0;
      atomicExch(done, 0ull);
    }
  }
}

}  // namespace

extern "C" int hbam_interval_cols(const void* buf, int64_t L,
                                  const void* offs, const void* n_all,
                                  int64_t R, int64_t cap, void* rid,
                                  void* pos1, void* end1, void* over,
                                  void* done, void* stream) {
  if (L <= 0 || L > INT32_MAX || R < 0 || R > INT32_MAX || cap < 0 ||
      cap > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // the pad sweep stores int4: the three columns start 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(rid) | reinterpret_cast<uintptr_t>(pos1) |
       reinterpret_cast<uintptr_t>(end1)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t blocks = R > 0 ? (R + kThreads - 1) / kThreads : 1;
  interval_cols_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), L, static_cast<const int32_t*>(offs),
      static_cast<const int32_t*>(n_all), R, static_cast<int>(cap),
      static_cast<int32_t*>(rid), static_cast<int32_t*>(pos1),
      static_cast<int32_t*>(end1), static_cast<int32_t*>(over),
      static_cast<unsigned long long*>(done));
  return static_cast<int>(cudaGetLastError());
}
