// K17a: the per-variant GWAS columns of a joined cohort dosage tile, and
// K17b: the cohort slice step over a resident tile, for Hopper (sm_90a).
//
// Replaces: hadoop_bam_tpu/cohort/gwas.py::make_cohort_gwas_step (:40),
//   the XLA step whose per_device (:61) the reference runs under
//   shard_map on each [cap, samples_pad] tile group (entry point
//   hbam_cohort_stats; plain PyTorch version
//   hadoop_bam_torch/cohort/gwas.py::cohort_gwas_plain), and
//   hadoop_bam_tpu/cohort/serving.py::make_cohort_slice_step (:79), its
//   per_device (:96) (entry point hbam_cohort_slice; plain version
//   hadoop_bam_torch/cohort/serving.py::cohort_slice_plain).
//
// K17a, per row r < count, over the columns j < n_samples whose dosage
// d = dosage[r, j] (int8) is >= 0 (called):
//   af        = alt / (2 max(n_called, 1)), NaN with none called,
//               alt = the sum of d
//   call_rate = n_called * (1 / max(n_samples, 1)), the reciprocal
//               rounded to float32 first
//   hwe       = sum over k = 0, 1, 2 of (n_k - e_k)^2 / e_k where
//               e_k > 0, from the counts n_k of d == k (a dosage above 2
//               is called but left out of the table), m = n0 + n1 + n2,
//               p = (2 n2 + n1) / (2 max(m, 1)), e0 = (1 - p)^2 m,
//               e1 = 2 p (1 - p) m, e2 = p^2 m; NaN when m == 0
//   score     = U^2 / (Vy Vg) over the called columns whose phenotype y
//               is finite (n of them): U = Sgy - Sy Sg / n,
//               Vg = Sgg - Sg^2 / n, Vy = (Syy - Sy^2 / n) / n (n read
//               as max(n, 1)); NaN unless n > 1 and Vy Vg > 1e-12, and
//               NaN everywhere without a phenotype
// Rows r >= count are NaN in all four columns.  out[r] is the float4
// (af, call_rate, hwe, score).
//
// K17b, over every column of the tile (n_samples = samples_pad): af[r]
// as above (NaN past the count), keep[r] = r < count & chrom[r] == iv[0]
// & iv[1] <= pos[r] <= iv[2], hits = the kept rows, af_n = the kept
// rows with a defined af and af_sum = the sum of their af, added in
// float64 and rounded to float32 once: one launch, no memset.
//
// What bounds it on the card: bytes.  The tile's rows under the count
//   are read once, with the phenotype and the count, and 16 bytes a row
//   written: at the full GWAS tile [3,352, 2,504] 8,393,408 B of dosage,
//   10,016 B of phenotype and 53,632 B of output, 0.002524 ms at 3.35
//   TB/s.  Before this design the kernel did about 15 integer operations
//   a dosage byte, read the phenotype again for every row (32 B a dosage
//   word) and left the rows under a small count on a few SMs.
//
// Design:
// - A persistent grid of G CTAs of kWarps warps, as many as are resident
//   (fewer for a smaller tile).  Row r goes to CTA r mod G, so the rows
//   under the count land on different SMs whatever the tile's cap; a
//   CTA's j-th row (r = c + G j) goes to its warp j mod kWarps, a warp a
//   row.  (Teams of 2-16 warps a row at small counts, the row's words
//   over more lanes, were slower at every shape measured, the 200-row
//   tile included: PERF.md section 6.)
// - Lane l has the row's aligned 8-byte words l, l + 32, ...
//   (consecutive lanes on consecutive words, a warp's load one 256-byte
//   run), up to kWords of them in flight at once (10 cover 2,504
//   samples), a further pass for wider rows.  Words at or past
//   n_samples are not loaded but set to 0xFF bytes (uncalled); the one
//   word that holds n_samples has its bytes at or past it set so by a
//   mask computed once.
// - Counts a 32-bit word at a time (SWAR), exact integers, from neg
//   (0xFF an uncalled byte: one prmt in its sign mode) and xc = x & ~neg:
//   unc = -(uncalled bytes) and alt by __dp4a, and, while every called
//   value is 0, 1 or 2, q = the sum of squares by __dp4a (n2 = (q -
//   alt) / 2, n1 = alt - 2 n2, n0 = called - n1 - n2) with a flag of any
//   value above 2; a warp whose pass raised it counts that pass again by
//   the general sums over the called bytes below 4 (their number, sum,
//   sum of squares and 3s: n2, n1, n0 follow).  The called count is 8
//   a word read plus unc.
// - With a phenotype, each CTA stages it once into shared memory (when
//   samples_pad <= kStageMax; wider tiles read it from the phenotype's
//   vector as the rows need it): y' = y where finite and below
//   n_samples, else 0, as two float4 a word ([2][words], conflict-free
//   for consecutive lanes), and the finite mask f (0xFF a column) as a
//   uint2 a word; each thread's first word is loaded before the count
//   and staged while the CTA's first dosage loads are in flight.  n, Sg
//   and Sgg are __dp4a sums over xc & f; Sy, Sgy and Syy are float work
//   a byte: t = y' where called, Sy += t, Syy += t y', Sgy += g y' (g
//   the called value; y' is 0 where y is not finite).
// - The lanes' sums: __reduce_add_sync for the integers, a butterfly of
//   shuffles for the floats.  Lane 0 applies the
//   formulas above in the reference's float32 order, each step rounded
//   on its own (__f*_rn: no contraction into FMAs), so af and call_rate
//   are bit-equal to the reference's float32 results.
// - Rows at or past the count: written NaN (K17b: af NaN, keep 0) by a
//   grid-stride loop, never read.
// - K17b's sums: each warp's lane 0 adds its rows; the CTA adds its
//   warps in order and writes its partial (af_sum in float64, hits,
//   af_n) to a per-stream scratch; the last CTA to take a ticket (an
//   atomic counter in the same scratch, zero between launches) adds the
//   partials in CTA order, writes hits, af_n and af_sum, and resets the
//   ticket.  That order is fixed for a grid, so af_sum is deterministic.
//   It is also the rounded exact sum where the float64 sum is exact: an
//   AF is a float32 alt / 2n, n <= samples_pad, so a multiple of 2^-(k +
//   23) with 2^k the power of two at or above 2 samples_pad, and cap of
//   them add exactly while cap 2^k <= 2^30 (the serve's 4,096 x 2,504
//   tile: 2^12 2^13).  The scratch holds one partial a resident CTA
//   (hbam_cohort_slice_slots).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;                // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kWords = 10;                // 8-byte words a lane has in flight
constexpr int kStageMax = 9000;           // samples_pad staged (5 B a column)
constexpr unsigned kAll = 0xffffffffu;

// a CTA's partial of K17b's sums, and the per-stream scratch: the ticket
// in the first 16 bytes, then the partials
struct Partial {
  double af_sum;
  int hits;
  int af_n;
};

struct Args {
  const int8_t* dosage;
  int64_t cap;
  int64_t spad;
  const int32_t* count;
  const float* pheno;         // K17a: float32 [spad] or null
  int64_t n_samples;
  float4* out;                // K17a: [cap] (af, call_rate, hwe, score)
  const int32_t* chrom;       // K17b: [cap]
  const int32_t* pos;         // K17b: [cap]
  const int32_t* iv;          // K17b: [3] contig, beg, end
  float* af;                  // K17b: [cap]
  uint8_t* keep;              // K17b: [cap] (bool)
  int32_t* sums;              // K17b: hits, af_n, af_sum (float32 bits)
  Partial* part;              // K17b: [G]
  unsigned* ticket;           // K17b
};

// a lane's (then a row's) sums.  unc: minus the uncalled bytes; alt: the
// called values; ns, s1, s2, n3: over the called bytes below 4, their
// number, sum, sum of squares and number of 3s (n0, n1, n2 follow); n,
// sg, sgg: over the called bytes with a finite phenotype, their number,
// sum and sum of squares; sy, sgy, syy: the float sums
struct Counts {
  int unc, alt, ns, s1, s2, n3;
  int n, sg, sgg;
  float sy, sgy, syy;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(kAll, static_cast<unsigned>(v)));
}

// (obs - exp)^2 / max(exp, 1e-12) where exp > 0, else 0
__device__ __forceinline__ float hwe_term(float obs, float exp) {
  const float d = __fsub_rn(obs, exp);
  return exp > 0.0f ? __fdiv_rn(__fmul_rn(d, d), fmaxf(exp, 1e-12f)) : 0.0f;
}

// 0xFF in each byte of x that is negative (uncalled), else 0x00: one prmt
// in its sign-replicating mode
__device__ __forceinline__ uint32_t neg_bytes(uint32_t x) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(0xBA98u));
  return r;
#else
  return ((x & 0x80808080u) >> 7) * 0xFFu;
#endif
}

// the called values of one 32-bit word x (bytes at or past n_samples
// already 0xFF): the fast sums, exact while every called value is 0, 1 or
// 2 (big stays 0), over neg (0xFF an uncalled byte) and xc (x's called
// values): minus the uncalled bytes, their sum, sum of squares
__device__ __forceinline__ void count_fast(uint32_t neg, uint32_t xc,
                                           int& unc, int& alt, int& q,
                                           uint32_t& big) {
  unc = __dp4a(static_cast<int>(neg), 0x01010101, unc);
  alt = __dp4a(static_cast<int>(xc), 0x01010101, alt);
  q = __dp4a(static_cast<int>(xc), static_cast<int>(xc), q);
  big |= (xc & 0x7C7C7C7Cu) | ((xc + 0x01010101u) & 0x04040404u);
}

// the general sums over the called bytes below 4 (bits 2-7 clear): their
// number, sum, sum of squares and number of 3s
__device__ __forceinline__ void count_small(uint32_t x, Counts& a) {
  const uint32_t s80 =
      ~(((x & 0x7C7C7C7Cu) + 0x7C7C7C7Cu) | x) & 0x80808080u;
  const uint32_t s1 = s80 >> 7;
  const uint32_t lo = x & (s1 * 3u);
  a.ns = __dp4a(static_cast<int>(s1), 0x01010101, a.ns);
  a.s1 = __dp4a(static_cast<int>(lo), 0x01010101, a.s1);
  a.s2 = __dp4a(static_cast<int>(lo), static_cast<int>(lo), a.s2);
  a.n3 = __dp4a(static_cast<int>(lo & (lo >> 1) & 0x01010101u), 0x01010101,
                a.n3);
}

// the phenotype's sums over one 32-bit word (neg, xc as above), f its
// finite mask (0xFF a byte), y its y' (0 where y is not finite)
__device__ __forceinline__ void count_pheno(uint32_t neg,
                                            uint32_t xc, uint32_t f,
                                            const float* y, Counts& a) {
  const int xu = static_cast<int>(xc & f);
  a.n = __dp4a(static_cast<int>(f & ~neg & 0x01010101u), 0x01010101, a.n);
  a.sg = __dp4a(xu, 0x01010101, a.sg);
  a.sgg = __dp4a(xu, xu, a.sgg);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float t = (neg >> (8 * k)) & 1u ? 0.0f : y[k];
    a.sy = __fadd_rn(a.sy, t);
    a.syy = __fmaf_rn(t, y[k], a.syy);
    a.sgy = __fmaf_rn(static_cast<float>((xc >> (8 * k)) & 0xFFu), y[k],
                      a.sgy);
  }
}

// word wi's two 32-bit halves, the bytes at or past n_samples set to 0xFF
__device__ __forceinline__ void halves(uint2 v, int wi, int full,
                                      uint64_t tail, uint32_t& lo,
                                      uint32_t& hi) {
  lo = v.x;
  hi = v.y;
  if (wi == full) {
    lo |= static_cast<uint32_t>(tail);
    hi |= static_cast<uint32_t>(tail >> 32);
  }
}

// the phenotype of word w (columns 8w .. 8w + 7) from its two float4 p, q:
// y' and the finite mask
__device__ __forceinline__ void pheno_conv(float4 p, float4 q, int w,
                                           int64_t S, float (&y)[8],
                                           uint2& f) {
  const float raw[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
  uint32_t m[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool ok = isfinite(raw[k]) && 8 * static_cast<int64_t>(w) + k < S;
    y[k] = ok ? raw[k] : 0.0f;
    m[k >> 2] |= ok ? 0xFFu << (8 * (k & 3)) : 0u;
  }
  f = make_uint2(m[0], m[1]);
}

__device__ __forceinline__ float4 pheno4(const float* __restrict__ pheno,
                                         int i) {
  return __ldg(reinterpret_cast<const float4*>(pheno) + i);
}

template <bool kPheno, bool kStaged, bool kSlice>
__global__ void __launch_bounds__(kThreads, 2)
cohort_rows_kernel(const Args a) {
  extern __shared__ float4 stage[];   // y' [2][nw] float4, then f [nw] uint2
  __shared__ Partial cta[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = static_cast<int>(gridDim.x);
  const float nan = __int_as_float(0x7fc00000);
  const int nw = static_cast<int>(a.spad >> 3);
  // the first phenotype word this thread stages: loaded before the count,
  // on which it does not depend
  float4 p0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), q0 = p0;
  if (kStaged && static_cast<int>(threadIdx.x) < nw) {
    p0 = pheno4(a.pheno, 2 * threadIdx.x);
    q0 = pheno4(a.pheno, 2 * threadIdx.x + 1);
  }
  const int32_t c_raw = __ldg(a.count);
  const int live = c_raw < 0 ? 0 : static_cast<int>(c_raw < a.cap ? c_raw
                                                                  : a.cap);
  const int64_t S = a.n_samples < a.spad ? a.n_samples : a.spad;
  const int nw_s = static_cast<int>((S + 7) >> 3);   // words below S
  const int full = static_cast<int>(S >> 3);         // S's word
  const uint64_t tail = (S & 7) ? ~0ull << (8 * (S & 7)) : 0ull;
  // this CTA's live rows, blockIdx.x + G j for j < J (cap < 2^31)
  const int c = static_cast<int>(blockIdx.x);
  const int J = live > c ? (live - c + G - 1) / G : 0;
  const int steps = (J + kWarps - 1) / kWarps;

  // the rows at or past the count: NaN, by a grid-stride loop
  for (int64_t r = live + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       r < a.cap; r += G * kThreads) {
    if (kSlice) {
      a.af[r] = nan;
      a.keep[r] = 0;
    } else {
      a.out[r] = make_float4(nan, nan, nan, nan);
    }
  }

  float4* ys = stage;
  uint2* fm = reinterpret_cast<uint2*>(stage + 2 * nw);
  int hits = 0, an = 0;
  double asum = 0.0;
  int iv0 = 0, iv1 = 0, iv2 = 0;
  if (kSlice && lane == 0) {
    iv0 = __ldg(a.iv);
    iv1 = __ldg(a.iv + 1);
    iv2 = __ldg(a.iv + 2);
  }
  for (int s = 0; s < steps; ++s) {
    const int j = s * kWarps + warp;
    const bool on = j < J;
    const int row = c + G * j;
    int32_t crow = 0, prow = 0;
    if (kSlice && on && lane == 0) {
      crow = __ldg(a.chrom + row);
      prow = __ldg(a.pos + row);
    }
    const uint2* words =
        reinterpret_cast<const uint2*>(a.dosage + (on ? row : 0) * a.spad);
    Counts acc = {};
    for (int base = 0; base < nw; base += 32 * kWords) {
      uint2 v[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int wi = base + lane + 32 * u;
        v[u] = on && wi < nw_s ? __ldg(words + wi) : make_uint2(~0u, ~0u);
      }
      if (kStaged && s == 0 && base == 0) {
        // the CTA's one staging of the phenotype, its first loads in flight
        for (int w = threadIdx.x; w < nw; w += kThreads) {
          float y[8];
          uint2 f;
          const bool first = w == static_cast<int>(threadIdx.x);
          pheno_conv(first ? p0 : pheno4(a.pheno, 2 * w),
                     first ? q0 : pheno4(a.pheno, 2 * w + 1), w, S, y, f);
          ys[w] = make_float4(y[0], y[1], y[2], y[3]);
          ys[nw + w] = make_float4(y[4], y[5], y[6], y[7]);
          fm[w] = f;
        }
        __syncthreads();
      }
      int unc = 0, alt = 0, q = 0, nread = 0;
      uint32_t big = 0;
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int wi = base + lane + 32 * u;
        if (on && wi < nw_s) {
          uint32_t x[2];
          halves(v[u], wi, full, tail, x[0], x[1]);
          float y[8];
          uint2 f = make_uint2(0u, 0u);
          if (kPheno) {
            if (kStaged) {
              const float4 p = ys[wi], q4 = ys[nw + wi];
              y[0] = p.x; y[1] = p.y; y[2] = p.z; y[3] = p.w;
              y[4] = q4.x; y[5] = q4.y; y[6] = q4.z; y[7] = q4.w;
              f = fm[wi];
            } else {
              pheno_conv(pheno4(a.pheno, 2 * wi), pheno4(a.pheno, 2 * wi + 1),
                         wi, S, y, f);
            }
          }
          ++nread;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t neg = neg_bytes(x[h]);
            const uint32_t xc = x[h] & ~neg;
            count_fast(neg, xc, unc, alt, q, big);
            if (kPheno) count_pheno(neg, xc, h ? f.y : f.x, y + 4 * h, acc);
          }
        }
      }
      acc.unc += unc;
      acc.alt += alt;
      if (!__any_sync(kAll, big != 0u)) {
        // every called value of the warp's pass is 0, 1 or 2
        acc.ns += 8 * nread + unc;
        acc.s1 += alt;
        acc.s2 += q;
      } else {
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          const int wi = base + lane + 32 * u;
          if (on && wi < nw_s) {
            uint32_t x[2];
            halves(v[u], wi, full, tail, x[0], x[1]);
            count_small(x[0], acc);
            count_small(x[1], acc);
          }
        }
      }
    }
    acc.unc = warp_sum(acc.unc);
    acc.alt = warp_sum(acc.alt);
    acc.ns = warp_sum(acc.ns);
    acc.s1 = warp_sum(acc.s1);
    acc.s2 = warp_sum(acc.s2);
    acc.n3 = warp_sum(acc.n3);
    if (kPheno) {
      acc.n = warp_sum(acc.n);
      acc.sg = warp_sum(acc.sg);
      acc.sgg = warp_sum(acc.sgg);
      acc.sy = warp_sum(acc.sy);
      acc.sgy = warp_sum(acc.sgy);
      acc.syy = warp_sum(acc.syy);
    }
    if (!on || lane != 0) continue;
    // the warp read each of the row's nw_s words once, 8 bytes each
    const int called = 8 * nw_s + acc.unc;
    const float ncf = static_cast<float>(called);
    const float af =
        called > 0 ? __fdiv_rn(static_cast<float>(acc.alt),
                               __fmul_rn(2.0f, fmaxf(ncf, 1.0f)))
                   : nan;
    if (kSlice) {
      const bool k = crow == iv0 && prow >= iv1 && prow <= iv2;
      a.af[row] = af;
      a.keep[row] = k;
      hits += k;
      if (k && called > 0) {
        an += 1;
        asum += static_cast<double>(af);
      }
      continue;
    }
    // a multiply by the float32 reciprocal of the sample count: the
    // reference's compiled step rewrites its division by that constant so
    const float call_rate = __fmul_rn(
        ncf, __fdiv_rn(1.0f, static_cast<float>(
                                 a.n_samples > 1 ? a.n_samples : 1)));
    // s1 = n1 + 2 n2 + 3 n3, s2 = n1 + 4 n2 + 9 n3
    const int n2 = (acc.s2 - acc.s1 - 6 * acc.n3) >> 1;
    const int n1 = acc.s1 - 2 * n2 - 3 * acc.n3;
    const int n0 = acc.ns - n1 - n2 - acc.n3;
    const float f0 = static_cast<float>(n0), f1 = static_cast<float>(n1),
                f2 = static_cast<float>(n2);
    const float m = __fadd_rn(__fadd_rn(f0, f1), f2);
    const float p = __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, f2), f1),
                              __fmul_rn(2.0f, fmaxf(m, 1.0f)));
    const float q = __fsub_rn(1.0f, p);
    const float e0 = __fmul_rn(__fmul_rn(q, q), m);
    const float e1 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, p), q), m);
    const float e2 = __fmul_rn(__fmul_rn(p, p), m);
    const float hwe =
        m > 0.0f ? __fadd_rn(__fadd_rn(hwe_term(f0, e0), hwe_term(f1, e1)),
                             hwe_term(f2, e2))
                 : nan;
    float score = nan;
    if (kPheno) {
      const float nf = static_cast<float>(acc.n);
      const float ns = fmaxf(nf, 1.0f);
      const float sgf = static_cast<float>(acc.sg);
      const float sggf = static_cast<float>(acc.sgg);
      const float uu =
          __fsub_rn(acc.sgy, __fdiv_rn(__fmul_rn(acc.sy, sgf), ns));
      const float vg = __fsub_rn(sggf, __fdiv_rn(__fmul_rn(sgf, sgf), ns));
      const float vy = __fdiv_rn(
          __fsub_rn(acc.syy, __fdiv_rn(__fmul_rn(acc.sy, acc.sy), ns)), ns);
      const float denom = __fmul_rn(vy, vg);
      if (nf > 1.0f && denom > 1e-12f)
        score = __fdiv_rn(__fmul_rn(uu, uu), fmaxf(denom, 1e-12f));
    }
    a.out[row] = make_float4(af, call_rate, hwe, score);
  }

  if (!kSlice) return;
  // K17b's sums: the warps in order, then the CTAs in order by the last
  if (lane == 0) cta[warp] = Partial{asum, hits, an};
  __syncthreads();
  if (warp != 0) return;
  unsigned last = 0;
  if (lane == 0) {
    Partial p = cta[0];
    for (int k = 1; k < kWarps; ++k) {
      p.af_sum += cta[k].af_sum;
      p.hits += cta[k].hits;
      p.af_n += cta[k].af_n;
    }
    a.part[blockIdx.x] = p;
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  if (!__shfl_sync(kAll, last, 0)) return;
  __threadfence();
  double sum = 0.0;
  int h = 0, n = 0;
  for (int b = lane; b < G; b += 32) {
    sum += __ldcg(&a.part[b].af_sum);
    h += __ldcg(&a.part[b].hits);
    n += __ldcg(&a.part[b].af_n);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kAll, sum, o);
  h = warp_sum(h);
  n = warp_sum(n);
  if (lane == 0) {
    a.sums[0] = h;
    a.sums[1] = n;
    a.sums[2] = __float_as_int(__double2float_rn(sum));
    atomicExch(a.ticket, 0u);
  }
}

using Kernel = void (*)(const Args);

// the CTAs of kern resident at once (with the most shared memory a launch
// of it takes, occ_smem) on the current device, found once a device and
// kernel
cudaError_t resident(Kernel kern, int which, int occ_smem, int* res) {
  static int found[64][4];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  *res = dev < 64 ? found[dev][which] : 0;
  if (*res > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      occ_smem);
  if (e != cudaSuccess) return e;
  *res = sms * per_sm > 0 ? sms * per_sm : 1;
  if (dev < 64) found[dev][which] = *res;
  return cudaSuccess;
}

// the persistent grid: as many CTAs as are resident, at most the rows (at
// least one) and slots
cudaError_t launch(Kernel kern, int which, int smem, int occ_smem,
                   const Args& a, int64_t slots, void* stream) {
  int res = 0;
  cudaError_t e = resident(kern, which, occ_smem, &res);
  if (e != cudaSuccess) return e;
  int64_t blocks = a.cap > 0 ? a.cap : 1;
  if (blocks > res) blocks = res;
  if (blocks > slots) blocks = slots;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K17a.  dosage int8 [cap, spad] (spad a multiple of 8, 8-byte aligned),
// count int32 [1] on the card, pheno float32 [spad] (16-byte aligned) or
// null, out float32 [cap, 4] (16-byte aligned).  Returns
// cudaGetLastError().
extern "C" int hbam_cohort_stats(const void* dosage, int64_t cap,
                                 int64_t spad, const void* count,
                                 const void* pheno, int64_t n_samples,
                                 void* out, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  if (spad <= 0 || (spad & 7) || spad >= (int64_t{1} << 31) ||
      cap >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.dosage = static_cast<const int8_t*>(dosage);
  a.cap = cap;
  a.spad = spad;
  a.count = static_cast<const int32_t*>(count);
  a.pheno = static_cast<const float*>(pheno);
  a.n_samples = n_samples;
  a.out = static_cast<float4*>(out);
  const int64_t big = INT64_MAX;
  cudaError_t e;
  if (pheno == nullptr)
    e = launch(cohort_rows_kernel<false, false, false>, 0, 0, 0, a, big,
               stream);
  else if (spad <= kStageMax)
    e = launch(cohort_rows_kernel<true, true, false>, 1,
               static_cast<int>(5 * spad), 5 * kStageMax, a, big, stream);
  else
    e = launch(cohort_rows_kernel<true, false, false>, 2, 0, 0, a, big,
               stream);
  return static_cast<int>(e);
}

// K17b's scratch: the partials hbam_cohort_slice's grid needs on the
// current device (its resident CTAs), written to *slots (int64).
// Returns a CUDA error code.
extern "C" int hbam_cohort_slice_slots(void* slots) {
  int res = 0;
  const cudaError_t e =
      resident(cohort_rows_kernel<false, false, true>, 3, 0, &res);
  *static_cast<int64_t*>(slots) = res;
  return static_cast<int>(e);
}

// K17b.  chrom, pos int32 [cap], dosage int8 [cap, spad] (as above),
// count int32 [1], iv int32 [3], af float32 [cap], keep bool [cap], sums
// int32 [3] (hits, af_n, af_sum's float32 bits), scratch: 16 bytes whose
// first uint32 is zero between launches, then `slots` 16-byte partials
// (one a CTA: the grid is at most `slots` CTAs, and all resident with
// hbam_cohort_slice_slots' count).  Returns cudaGetLastError().
extern "C" int hbam_cohort_slice(const void* chrom, const void* pos,
                                 const void* dosage, int64_t cap,
                                 int64_t spad, const void* count,
                                 const void* iv, void* af, void* keep,
                                 void* sums, void* scratch, int64_t slots,
                                 void* stream) {
  if (cap < 0 || cap >= (int64_t{1} << 31) || spad < 0 || (spad & 7) ||
      spad >= (int64_t{1} << 31) || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.dosage = static_cast<const int8_t*>(dosage);
  a.cap = cap;
  a.spad = spad;
  a.count = static_cast<const int32_t*>(count);
  a.n_samples = spad;
  a.chrom = static_cast<const int32_t*>(chrom);
  a.pos = static_cast<const int32_t*>(pos);
  a.iv = static_cast<const int32_t*>(iv);
  a.af = static_cast<float*>(af);
  a.keep = static_cast<uint8_t*>(keep);
  a.sums = static_cast<int32_t*>(sums);
  a.ticket = static_cast<unsigned*>(scratch);
  a.part = reinterpret_cast<Partial*>(static_cast<char*>(scratch) + 16);
  return static_cast<int>(launch(cohort_rows_kernel<false, false, true>, 3,
                                 0, 0, a, slots, stream));
}
