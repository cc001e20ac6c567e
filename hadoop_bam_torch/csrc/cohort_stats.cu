// K17a: the per-variant GWAS columns of a joined cohort dosage tile, for
// Hopper (sm_90a).
//
// Replaces: hadoop_bam_tpu/cohort/gwas.py::make_cohort_gwas_step (:40),
//   the XLA step whose per_device (:61) the reference runs under
//   shard_map on each [cap, samples_pad] tile group.  Its plain PyTorch
//   version is hadoop_bam_torch/cohort/gwas.py::cohort_gwas_plain; the
//   cohort slice step (K17b, cohort/serving.py) reads column 0.
//
// Per row r < count, over the columns j < n_samples whose dosage
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
// Design: a warp a row.  Lane l reads the row's aligned 8-byte words
//   l, l + 32, ... (rows are samples_pad bytes, a multiple of 8, so every
//   row starts 8-byte aligned and a warp's load is one 256-byte run),
//   and counts called, n0, n1, n2 and the alt sum as exact integers in
//   registers; with a phenotype it also counts n, Sg and Sgg as integers
//   and sums Sy, Sgy and Syy in float, its columns' phenotype read by
//   two aligned float4 loads a word.  A butterfly of shuffles sums the
//   lanes; lane 0 applies the formulas above in the reference's float32
//   order, each step rounded on its own (__f*_rn: no contraction into
//   FMAs), and writes the row's float4.  The integer-derived columns
//   (af, call_rate) are exact to the reference's float32 results.
//
// What bounds it on the card: bytes.  The tile is read once: cap *
//   samples_pad int8, the phenotype and the count, and 16 bytes a row
//   written.  At the main path's tile [3,352, 2,504]: 8,393,408 B of
//   dosage, 10,016 B of phenotype, 4 B of count and 53,632 B of output,
//   0.002524 ms at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // rows a CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// (obs - exp)^2 / max(exp, 1e-12) where exp > 0, else 0
__device__ __forceinline__ float hwe_term(float obs, float exp) {
  const float d = __fsub_rn(obs, exp);
  return exp > 0.0f ? __fdiv_rn(__fmul_rn(d, d), fmaxf(exp, 1e-12f)) : 0.0f;
}

template <bool kPheno>
__global__ void __launch_bounds__(kThreads)
cohort_stats_kernel(const int8_t* __restrict__ dosage, int64_t cap,
                    int64_t spad, const int32_t* __restrict__ count,
                    const float* __restrict__ pheno, int64_t n_samples,
                    float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (row >= cap) return;
  const float nan = __int_as_float(0x7fc00000);
  if (row >= static_cast<int64_t>(__ldg(count))) {
    if (lane == 0) out[row] = make_float4(nan, nan, nan, nan);
    return;
  }
  // the columns that count: below n_samples (and in the row)
  const int64_t S = n_samples < spad ? n_samples : spad;
  const uint2* words = reinterpret_cast<const uint2*>(dosage + row * spad);
  const int64_t nw = spad >> 3;
  int called = 0, n0 = 0, n1 = 0, n2 = 0, alt = 0;
  int n = 0, sg = 0, sgg = 0;
  float sy = 0.0f, sgy = 0.0f, syy = 0.0f;
  // unrolled so that a lane has several words' loads in flight at once
#pragma unroll 4
  for (int64_t w = lane; w < nw; w += 32) {
    const uint2 v = __ldg(words + w);
    float y[8];
    if (kPheno) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(pheno) + 2 * w);
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(pheno) + 2 * w + 1);
      y[0] = a.x; y[1] = a.y; y[2] = a.z; y[3] = a.w;
      y[4] = b.x; y[5] = b.y; y[6] = b.z; y[7] = b.w;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t word = k < 4 ? v.x : v.y;
      const int d = static_cast<int8_t>(word >> (8 * (k & 3)));
      const bool in = w * 8 + k < S;
      const bool c = in && d >= 0;
      called += c;
      alt += c ? d : 0;
      n0 += c && d == 0;
      n1 += c && d == 1;
      n2 += c && d == 2;
      if (kPheno) {
        const bool use = c && isfinite(y[k]);
        if (use) {
          const float g = static_cast<float>(d);
          n += 1;
          sg += d;
          sgg += d * d;
          sy += y[k];
          sgy += g * y[k];
          syy += y[k] * y[k];
        }
      }
    }
  }
  called = warp_sum(called);
  alt = warp_sum(alt);
  n0 = warp_sum(n0);
  n1 = warp_sum(n1);
  n2 = warp_sum(n2);
  if (kPheno) {
    n = warp_sum(n);
    sg = warp_sum(sg);
    sgg = warp_sum(sgg);
    sy = warp_sum(sy);
    sgy = warp_sum(sgy);
    syy = warp_sum(syy);
  }
  if (lane != 0) return;
  const float ncf = static_cast<float>(called);
  const float af =
      called > 0
          ? __fdiv_rn(static_cast<float>(alt), __fmul_rn(2.0f, fmaxf(ncf, 1.0f)))
          : nan;
  // a multiply by the float32 reciprocal of the sample count: the
  // reference's compiled step rewrites its division by that constant so
  const float call_rate = __fmul_rn(
      ncf,
      __fdiv_rn(1.0f, static_cast<float>(n_samples > 1 ? n_samples : 1)));
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
    const float nf = static_cast<float>(n);
    const float ns = fmaxf(nf, 1.0f);
    const float sgf = static_cast<float>(sg);
    const float sggf = static_cast<float>(sgg);
    const float u = __fsub_rn(sgy, __fdiv_rn(__fmul_rn(sy, sgf), ns));
    const float vg = __fsub_rn(sggf, __fdiv_rn(__fmul_rn(sgf, sgf), ns));
    const float vy =
        __fdiv_rn(__fsub_rn(syy, __fdiv_rn(__fmul_rn(sy, sy), ns)), ns);
    const float denom = __fmul_rn(vy, vg);
    if (nf > 1.0f && denom > 1e-12f)
      score = __fdiv_rn(__fmul_rn(u, u), fmaxf(denom, 1e-12f));
  }
  out[row] = make_float4(af, call_rate, hwe, score);
}

}  // namespace

// dosage int8 [cap, spad] (spad a multiple of 8, 8-byte aligned), count
// int32 [1] on the card, pheno float32 [spad] (16-byte aligned) or null,
// out float32 [cap, 4] (16-byte aligned).  Returns cudaGetLastError().
extern "C" int hbam_cohort_stats(const void* dosage, int64_t cap,
                                 int64_t spad, const void* count,
                                 const void* pheno, int64_t n_samples,
                                 void* out, void* stream) {
  if (cap > 0) {
    const unsigned blocks =
        static_cast<unsigned>((cap + kWarps - 1) / kWarps);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* d = static_cast<const int8_t*>(dosage);
    const int32_t* c = static_cast<const int32_t*>(count);
    float4* o = static_cast<float4*>(out);
    if (pheno != nullptr)
      cohort_stats_kernel<true><<<blocks, kThreads, 0, s>>>(
          d, cap, spad, c, static_cast<const float*>(pheno), n_samples, o);
    else
      cohort_stats_kernel<false><<<blocks, kThreads, 0, s>>>(
          d, cap, spad, c, nullptr, n_samples, o);
  }
  return static_cast<int>(cudaGetLastError());
}
