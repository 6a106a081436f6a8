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

// -- the class-chunk split (kernels 1, 2, 4, 5 and kernel 6's scoring) ------
// Where the item grid is too short to fill the card, a scoring launch
// becomes two: class_chunk_kernel over grid(item blocks, class chunks[, S])
// writes each (c, n) row's mixture term -H2 to an fp32 scratch ent (S, N,
// C), by score_warp's or score_block_approx's own row code, and
// class_mix_kernel adds each item's terms in c order. Scores and refreshed
// rows are bitwise the single launch's (csrc/eig_score.cu's header).

// The split's first launch: block (blockIdx.x, blockIdx.y) takes the items
// of a scoring block blockIdx.x and the classes [blockIdx.y * per,
// (blockIdx.y + 1) * per) below C, and writes each row's mixture term -H2
// to ent[n, c] (N, C). An exact warp scores kExactRows items together, an
// approx warp one item, as the single launch does. FRESH as in score_warp:
// with FRESH, the chunk that holds c_ref reads that row from `fresh` (and
// with FRESH = 2 divides it by den[n]), stores it rounded to T and scores
// it as rounded: that chunk is the row's only writer. BATCHED (kernels 4
// and 5): blockIdx.z is the replica s, whose slices start at score_warp's
// offsets and whose scratch is ent[s] (S, N, C); a replica whose class is
// out of [0, C) writes nothing, the others run on.
template <typename T, int VEC, int FRESH, bool APPROX, bool BATCHED>
__global__ void __launch_bounds__(kScoreWarps * 32)
class_chunk_kernel(const float* __restrict__ rows, const T* hyp, T* hyp_w,
                   const float* __restrict__ fresh,
                   const float* __restrict__ den,
                   const int* __restrict__ c_ptr,
                   const float* __restrict__ pi,
                   const float* __restrict__ mixture0,
                   float* __restrict__ ent, int C, int N, int H, int per) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the replica: blockIdx.z for kernels 4 and 5, the constant 0 otherwise
  const size_t rep = BATCHED ? blockIdx.z : 0;
  const int c_ref = FRESH ? c_ptr[rep] : -1;
  // a class out of [0, C) refreshes no row: class_mix_kernel writes NaN
  if (FRESH && (unsigned)c_ref >= (unsigned)C) return;
  // replica rep's slices, size_t from the first multiplication
  rows += rep * C * H;
  hyp += rep * C * N * H;
  hyp_w += rep * C * N * H;
  if (FRESH) fresh += rep * N * H;
  if (FRESH == 2) den += rep * N;
  pi += rep * C;
  mixture0 += rep * H;
  ent += rep * N * C;
  const int c0 = blockIdx.y * per, c1 = min(C, c0 + per);
  if constexpr (APPROX) {
    const int n = blockIdx.x * kScoreWarps + warp;
    if (n >= N) return;
    for (int c = c0; c < c1; ++c) {
      const size_t off = ((size_t)c * N + n) * H;
      const float* base = rows + (size_t)c * H;
      float acc;
      if (FRESH && c == c_ref)
        acc = row_plogp_approx<VEC, FRESH == 2>(
            fresh + (size_t)n * H, FRESH == 2 ? den[n] : 1.f, base,
            mixture0, pi[c], H, lane, hyp_w + off);
      else
        acc = row_plogp_approx<VEC, false>(hyp + off, 1.f, base, mixture0,
                                           pi[c], H, lane, (T*)nullptr);
      if (lane == 0) ent[(size_t)n * C + c] = -acc;
    }
  } else {
    constexpr int K = kExactRows;
    const int n0 = (blockIdx.x * kScoreWarps + warp) * K;
    if (n0 >= N) return;
    const int nk = min(K, N - n0);
    // kernel 6's row divisors, read by the chunk that holds c_ref only
    const bool div = FRESH == 2 && c_ref >= c0 && c_ref < c1;
    float d[K];
#pragma unroll
    for (int j = 0; j < K; ++j) d[j] = div ? den[n0 + min(j, nk - 1)] : 1.f;
    for (int c = c0; c < c1; ++c) {
      const size_t off = ((size_t)c * N + n0) * H;
      const float* base = rows + (size_t)c * H;
      float acc[K];
      if (FRESH && c == c_ref)
        rows_plogp<VEC, K, FRESH == 2>(fresh + (size_t)n0 * H, base,
                                       mixture0, pi[c], H, nk, lane, d,
                                       hyp_w + off, acc);
      else
        rows_plogp<VEC, K, false>(hyp + off, base, mixture0, pi[c], H, nk,
                                  lane, d, (T*)nullptr, acc);
      // every lane holds each row's sum after the butterfly; lane j
      // writes row j's term
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float e = -warp_sum(acc[j]);
        if (lane == j) v = e;
      }
      if (lane < nk) ent[(size_t)(n0 + lane) * C + c] = v;
    }
  }
}

constexpr int kMixWarps = 8;  // items a mixture block sums, one a warp

// The split's second launch: out[n] = h_before - sum_c pi_xi[n, c] *
// ent[n, c], a warp an item. Lane l forms the products of classes l, l +
// 32, ... (coalesced loads of both rows, the next 32 loaded while the last
// 32 are added), and every lane adds them from 0 in c order, each product
// taken by a shuffle from its lane: the single launch's order, and the same
// sum in every lane. REFRESH: NaN for every item when the class is out of
// [0, C). BATCHED: blockIdx.y is the replica s (pi_xi, ent and out (S, N,
// ...), h_before and the class (S,)), and only a replica whose own class is
// out of range gets NaN.
template <bool REFRESH, bool BATCHED>
__global__ void __launch_bounds__(kMixWarps * 32)
class_mix_kernel(const float* __restrict__ ent,
                 const float* __restrict__ pi_xi,
                 const float* __restrict__ h_before,
                 const int* __restrict__ c_ptr, float* __restrict__ out,
                 int C, int N) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kMixWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const size_t rep = BATCHED ? blockIdx.y : 0;
  const size_t item = rep * N + n;  // the replica's item
  if (REFRESH && (unsigned)c_ptr[rep] >= (unsigned)C) {
    if (lane == 0) out[item] = NAN;
    return;
  }
  const float* w = pi_xi + item * C;
  const float* e = ent + item * C;
  float p = lane < C ? w[lane] * e[lane] : 0.f;
  float s = 0.f;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + 32 + lane;
    const float wn = c < C ? w[c] : 0.f, en = c < C ? e[c] : 0.f;
    const int m = min(32, C - c0);
    if (m == 32) {
#pragma unroll
      for (int j = 0; j < 32; ++j) s += __shfl_sync(0xffffffffu, p, j);
    } else {
      for (int j = 0; j < m; ++j) s += __shfl_sync(0xffffffffu, p, j);
    }
    p = wn * en;
  }
  if (lane == 0) out[item] = h_before[rep] - s;
}

// A scoring launch (S replicas, or one) split over `chunks` class chunks of
// ceil(C / chunks) classes each (the last may hold fewer), through the
// scratch ent (S, N, C); FRESH, fresh and den as in class_chunk_kernel
template <typename T, int FRESH, bool APPROX, bool BATCHED>
int launch_split_t(const float* rows, const void* hyp, const float* fresh,
                   const float* den, const int* c, const float* pi,
                   const float* pi_xi, const float* mixture0,
                   const float* h_before, float* out, float* ent, int S,
                   int C, int N, int H, int vec, int chunks,
                   cudaStream_t stream) {
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  constexpr int kItems = score_items<APPROX>();
  const int per = (C + chunks - 1) / chunks;
  dim3 grid((N + kItems - 1) / kItems, (C + per - 1) / per, S),
      block(kScoreWarps * 32);
  const T* h = static_cast<const T*>(hyp);
  T* hw = const_cast<T*>(h);
  if (vec > 1)
    class_chunk_kernel<T, kVec, FRESH, APPROX, BATCHED>
        <<<grid, block, 0, stream>>>(rows, h, hw, fresh, den, c, pi,
                                     mixture0, ent, C, N, H, per);
  else
    class_chunk_kernel<T, 1, FRESH, APPROX, BATCHED>
        <<<grid, block, 0, stream>>>(rows, h, hw, fresh, den, c, pi,
                                     mixture0, ent, C, N, H, per);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  class_mix_kernel<FRESH != 0, BATCHED>
      <<<dim3((N + kMixWarps - 1) / kMixWarps, S), kMixWarps * 32, 0,
         stream>>>(ent, pi_xi, h_before, c, out, C, N);
  return (int)cudaGetLastError();
}

// launch_split_t at the storage type (bf16 != 0: bfloat16) and entropy
// flavour (approx != 0) given at run time
template <int FRESH, bool BATCHED>
int launch_split(const float* rows, const void* hyp, const float* fresh,
                 const float* den, const int* c, const float* pi,
                 const float* pi_xi, const float* mixture0,
                 const float* h_before, float* out, float* ent, int S, int C,
                 int N, int H, int vec, int bf16, int approx, int chunks,
                 cudaStream_t stream) {
#define EIG_LAUNCH(T, A)                                                   \
  return launch_split_t<T, FRESH, A, BATCHED>(                             \
      rows, hyp, fresh, den, c, pi, pi_xi, mixture0, h_before, out, ent, S, \
      C, N, H, vec, chunks, stream)
  if (bf16) {
    if (approx) EIG_LAUNCH(__nv_bfloat16, true);
    EIG_LAUNCH(__nv_bfloat16, false);
  }
  if (approx) EIG_LAUNCH(float, true);
  EIG_LAUNCH(float, false);
#undef EIG_LAUNCH
}

}  // namespace eig
