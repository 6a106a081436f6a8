// The expected-entropy scoring pass shared by the EIG kernels
// (csrc/eig_score.cu: kernels 1, 2, 4, 5; csrc/eig_refresh_compute.cu:
// kernel 6's scoring launch) — the counterpart of _weighted_entropy_scores
// in coda_tpu/ops/pallas_eig.py.
//
// For one (c, n) row of H values s[h] it sums p*log2(p) with
//   p = max(mixture0[h] + pi[c] * (s[h] - rows[c, h]), 1e-12),
// every value widened to fp32 first (the cache may be stored as bf16), and
// p computed exactly as the plain PyTorch version computes it (the library
// is built with -fmad=false, so each p*t + c rounds twice). Two entropy
// flavours:
//   exact: each term t = p*log2(p) is within 4 * 2^-24 * max(|t|, p) of
//     its double-precision value for every fp32 p in [1e-12, 1] (checked
//     over all of them on the card: chip_smoke.py's log-term sweep through
//     eig_plogp_sweep_launch). For p <= 1/16, |log2 p| >= 4 and the
//     hardware's lg2.approx (MUFU.LG2, one instruction on the SFU pipe,
//     beside the fp32 pipe) is well inside that; above it the term is taken
//     in double precision, a branch the headline data (p ~ 1/H) never takes.
//     logf(p) * log2(e) in full precision costs about 20 instructions an
//     element, which bound kernels 1 and 2 once a bf16 cache halved their
//     bytes.
//   approx: the bit-manipulation log2_approx of ops/masked.py (exponent
//     from the IEEE-754 bits, degree-6 polynomial in the mantissa, Horner
//     with fp32 constants), constant for constant.
//
// Loads go VEC values at a time: VEC = 4 (float4) for an fp32 row and
// VEC = 8 (one 16-byte uint4 of bf16) for a bf16 row; fp32 operands read
// beside a bf16 row take two float4 loads. VEC = 1 is the unaligned
// fallback. The wrappers choose VEC from H and the pointers' alignment.
//
// Two passes share this header. The exact flavour's pass (score_warp): a
// warp scores kExactRows items of one class together, so the class's
// rows[c, :] and mixture0 vectors are loaded once for four rows instead of
// once a row (for a bf16 row they were 64 of every 80 bytes a lane
// loaded). The approx flavour keeps one row a warp
// (score_block_approx): a warp per (c, n) row, the rows' entropies meeting
// in shared memory; with its longer chain an element, grouped rows (one to
// four a warp) measured slower for it, in registers and code. In both, each
// row's lanes sum their strided share in h order and a shuffle butterfly
// finishes it, and each item's class mixture is summed in c order, so the
// scores do not depend on the pass.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace eig {

constexpr float kFloor = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;
// above this p the exact flavour takes p*log2(p) in double precision
constexpr float kWide = 0.0625f;
constexpr int kScoreWarps = 8;  // warps per scoring block
constexpr int kExactRows = 4;   // items a warp of the exact pass scores

// items a scoring block takes: kExactRows a warp in the exact pass, one a
// warp in the approx one
template <bool APPROX>
__host__ __device__ constexpr int score_items() {
  return kScoreWarps * (APPROX ? 1 : kExactRows);
}

// ops/masked.py log2_approx, constant for constant
__device__ __forceinline__ float log2_approx(float x) {
  const int xi = __float_as_int(x);
  const float e = (float)((xi >> 23) - 127);
  const float t = __int_as_float((xi & 0x007FFFFF) | 0x3F800000) - 1.0f;
  float p = -0.0248256066155325f;
  p = p * t + 0.11790518317842658f;
  p = p * t + -0.27235315795334314f;
  p = p * t + 0.45385624123395407f;
  p = p * t + -0.7169868747328294f;
  p = p * t + 1.4423954826705712f;
  p = p * t + 5.065333097742375e-06f;
  return e + p;
}

// MUFU.LG2; p >= 1e-12 is normal, so flushing subnormals costs nothing
__device__ __forceinline__ float lg2_hw(float p) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(p));
  return y;
}

__device__ __noinline__ float plogp_wide(float p) {
  const double d = p;
  return (float)(d * log2(d));
}

// The exact flavour's terms t = p*log2(p) of VEC values p in [1e-12, 1]:
// lg2.approx where p <= kWide, double precision above
template <int VEC>
__device__ __forceinline__ void exact_terms(const float (&p)[VEC],
                                            float (&t)[VEC]) {
  float pmax = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    t[k] = p[k] * lg2_hw(p[k]);
    pmax = fmaxf(pmax, p[k]);
  }
  if (pmax > kWide) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (p[k] > kWide) t[k] = plogp_wide(p[k]);
  }
}

// Adds the exact terms p*log2(p) of one vector of a row to acc, in order,
// with p = max(m + pi_c * (s - r), 1e-12)
template <int VEC>
__device__ __forceinline__ void add_exact_terms(const float (&s)[VEC],
                                                const float (&r)[VEC],
                                                const float (&m)[VEC],
                                                float pi_c, float& acc) {
  float p[VEC], t[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    p[k] = fmaxf(m[k] + pi_c * (s[k] - r[k]), kFloor);
  exact_terms<VEC>(p, t);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc += t[k];
}

// One approx term p*log2(p), p = max(m + pi_c * (s - r), 1e-12)
__device__ __forceinline__ float plogp_approx(float s, float r, float m,
                                              float pi_c) {
  const float p = fmaxf(m + pi_c * (s - r), kFloor);
  return p * log2_approx(p);
}

// VEC consecutive values, vector i of the row (elements i*VEC ..), as fp32
template <int VEC>
__device__ __forceinline__ void load(const float* p, int i, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = p[i];
  } else {
    static_assert(VEC % 4 == 0, "fp32 vectors are float4");
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(p)[i * (VEC / 4) + k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, int i,
                                     float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __bfloat162float(p[i]);
  } else {
    static_assert(VEC % 8 == 0, "bf16 vectors are 8 values in 16 bytes");
#pragma unroll
    for (int k = 0; k < VEC / 8; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i * (VEC / 8) + k];
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(b[j]);
        v[8 * k + 2 * j] = f.x;
        v[8 * k + 2 * j + 1] = f.y;
      }
    }
  }
}

// Store VEC fp32 values at the storage type, rounding to nearest even
// (as Tensor.to and jnp astype do), and leave the stored values in v: the
// scores use the rounded row. For fp32 storage both are the identity.
template <int VEC>
__device__ __forceinline__ void store_round(float* p, int i, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[i] = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      reinterpret_cast<float4*>(p)[i * (VEC / 4) + k] =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_round(__nv_bfloat16* p, int i,
                                            float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    const __nv_bfloat16 r = __float2bfloat16_rn(v[0]);
    p[i] = r;
    v[0] = __bfloat162float(r);
  } else {
#pragma unroll
    for (int k = 0; k < VEC / 8; ++k) {
      uint4 q;
      __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = __floats2bfloat162_rn(v[8 * k + 2 * j], v[8 * k + 2 * j + 1]);
        const float2 f = __bfloat1622float2(b[j]);
        v[8 * k + 2 * j] = f.x;
        v[8 * k + 2 * j + 1] = f.y;
      }
      reinterpret_cast<uint4*>(p)[i * (VEC / 8) + k] = q;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Per-lane sums of the exact p*log2(p) over K rows of one class, row j at
// src + min(j, nk - 1)*H (rows past the nk valid ones repeat the last):
// lane l takes vectors l, l+32, ... of each row in order. The class's
// rows[c, :] chunk (base) and mixture0 chunk are loaded once for the K
// rows. With a dst, each row is also stored at the same offset from dst,
// rounded to T, and scored as rounded (the refresh), after a division by
// den[j] if DIV (kernel 6's unnormalised rows). dst is a run-time pointer,
// so the refreshed row and the others share one loop where S is T.
template <int VEC, int K, bool DIV, typename S, typename T>
__device__ __forceinline__ void rows_plogp(const S* src,
                                           const float* __restrict__ base,
                                           const float* __restrict__ mix0,
                                           float pi_c, int H, int nk,
                                           int lane, const float (&den)[K],
                                           T* dst, float (&acc)[K]) {
  size_t off[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    off[j] = (size_t)min(j, nk - 1) * H;
    acc[j] = 0.f;
  }
  for (int i = lane; i < H / VEC; i += 32) {
    float s[K][VEC], b[VEC], m[VEC];
#pragma unroll
    for (int j = 0; j < K; ++j) load<VEC>(src + off[j], i, s[j]);
    load<VEC>(base, i, b);
    load<VEC>(mix0, i, m);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (dst) {
        if constexpr (DIV) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) s[j][k] = s[j][k] / den[j];
        }
        store_round<VEC>(dst + off[j], i, s[j]);
      }
      add_exact_terms<VEC>(s[j], b, m, pi_c, acc[j]);
    }
  }
}

// One warp's share of an exact scoring launch: items n0 .. n0+kExactRows-1
// (those below N) of replica rep, every class c in order, each item's
//   out[n] = h_before - sum_c pi_xi[n, c] * H2(p[c, n, :])
// with the class mixture summed in c order. FRESH = 0: every row comes
// from the cache hyp (C, N, H). FRESH = 1: the row of class c_ref comes
// from the fp32 (N, H) rows `fresh`, is stored into the cache rounded to T
// and scored as rounded (kernels 2 and 5); no other warp touches that
// row. FRESH = 2: the same with fresh[n, :] / den[n] (kernel 6). With
// FRESH, a class out of [0, C) gives NaN scores and writes nothing.
// Offsets are size_t; replica rep's slices start at rep*C*N*H (cache),
// rep*C*H (rows), rep*C (pi), rep*N*C (pi_xi), rep*H (mixture0) and rep*N
// (out, fresh rows, den).
template <typename T, int VEC, int FRESH>
__device__ __forceinline__ void score_warp(
    const float* __restrict__ rows, const T* hyp, T* hyp_w,
    const float* fresh, const float* __restrict__ den, int c_ref,
    const float* __restrict__ pi, const float* __restrict__ pi_xi,
    const float* __restrict__ mixture0, float h_before,
    float* __restrict__ out, int C, int N, int H, size_t rep, int n0,
    int lane) {
  constexpr int K = kExactRows;
  if (n0 >= N) return;
  const int nk = min(K, N - n0);
  const size_t item0 = rep * N + n0;  // the replica's first item
  if (FRESH && (unsigned)c_ref >= (unsigned)C) {
    if (lane < nk) out[item0 + lane] = NAN;
    return;
  }
  float d[K], mix[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    d[j] = FRESH == 2 ? den[item0 + min(j, nk - 1)] : 1.f;
    mix[j] = 0.f;
  }
  const float* mix0 = mixture0 + rep * H;
  for (int c = 0; c < C; ++c) {
    const size_t rc = rep * C + c;  // the replica's class row
    const size_t off = (rc * N + n0) * (size_t)H;
    const float* base = rows + rc * H;
    // the class weights, loaded before the rows so their latency hides
    // behind the row loop
    float w[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      w[j] = __ldg(pi_xi + (item0 + min(j, nk - 1)) * C + c);
    float acc[K];
    if (FRESH && c == c_ref)
      rows_plogp<VEC, K, FRESH == 2>(fresh + item0 * H, base, mix0, pi[rc],
                                     H, nk, lane, d, hyp_w + off, acc);
    else
      rows_plogp<VEC, K, FRESH == 2>(hyp + off, base, mix0, pi[rc], H, nk,
                                     lane, d, (T*)nullptr, acc);
#pragma unroll
    for (int j = 0; j < K; ++j) mix[j] += w[j] * -warp_sum(acc[j]);
  }
  float v = mix[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (lane == j) v = mix[j];
  if (lane < nk) out[item0 + lane] = h_before - v;
}

// The approx flavour's sum over h of p*log2(p) for one row: the 32 lanes
// of a warp stride over h, a shuffle butterfly finishes. With a dst the
// row's values are also stored there, rounded to T, and scored as rounded
// (the refresh), after a division by d if DIV.
template <int VEC, bool DIV, typename S, typename T>
__device__ float row_plogp_approx(const S* src, float d,
                                  const float* __restrict__ base,
                                  const float* __restrict__ mix0, float pi_c,
                                  int H, int lane, T* dst) {
  float acc = 0.f;
  for (int i = lane; i < H / VEC; i += 32) {
    float s[VEC], b[VEC], m[VEC];
    load<VEC>(src, i, s);
    load<VEC>(base, i, b);
    load<VEC>(mix0, i, m);
    if (dst) {
      if constexpr (DIV) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) s[k] = s[k] / d;
      }
      store_round<VEC>(dst, i, s);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc += plogp_approx(s[k], b[k], m[k], pi_c);
  }
  return warp_sum(acc);
}

// A block's share of an approx scoring launch, one row a warp: items
// n0 = blockIdx.x * kScoreWarps .. of replica rep, a warp per (c, n) row
// (warp w takes item n0 + w, class by class); lane 0 puts the row's
// entropy in h_after [kScoreWarps][C] (shared memory) and, after a
// barrier, one thread per item sums its class mixture in c order. FRESH,
// the operands and the offsets are score_warp's; h_before points at the
// replica's value, read by those threads only.
template <typename T, int VEC, int FRESH>
__device__ __forceinline__ void score_block_approx(
    const float* __restrict__ rows, const T* hyp, T* hyp_w,
    const float* fresh, const float* __restrict__ den, int c_ref,
    const float* __restrict__ pi, const float* __restrict__ pi_xi,
    const float* __restrict__ mixture0, const float* __restrict__ h_before,
    float* __restrict__ out, int C, int N, int H, size_t rep,
    float* h_after) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kScoreWarps;
  const float* mix0 = mixture0 + rep * H;
  for (int j = warp; j < kScoreWarps * C; j += kScoreWarps) {
    const int c = j / kScoreWarps, i = j % kScoreWarps, n = n0 + i;
    if (n >= N) continue;
    const size_t rc = rep * C + c;  // the replica's class row
    const size_t rn = rep * N + n;  // the replica's item
    const size_t off = (rc * N + n) * (size_t)H;
    const float* base = rows + rc * H;
    float acc;
    if (FRESH && c == c_ref)
      acc = row_plogp_approx<VEC, FRESH == 2>(
          fresh + rn * H, FRESH == 2 ? den[rn] : 1.f, base, mix0, pi[rc], H,
          lane, hyp_w + off);
    else
      acc = row_plogp_approx<VEC, FRESH == 2>(hyp + off, 1.f, base, mix0,
                                              pi[rc], H, lane, (T*)nullptr);
    if (lane == 0) h_after[i * C + c] = -acc;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kScoreWarps && n0 + i < N) {
    const size_t rn = rep * N + n0 + i;
    if (FRESH && (unsigned)c_ref >= (unsigned)C) {
      out[rn] = NAN;  // class index out of range: no row was refreshed
      return;
    }
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += pi_xi[rn * C + c] * h_after[i * C + c];
    out[rn] = *h_before - s;
  }
}

}  // namespace eig
