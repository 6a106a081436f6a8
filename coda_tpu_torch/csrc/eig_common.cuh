// The expected-entropy scoring tail shared by the EIG kernels
// (csrc/eig_score.cu: kernels 1 and 2; csrc/eig_refresh_compute.cu:
// kernel 6) — the counterpart of _weighted_entropy_scores in
// coda_tpu/ops/pallas_eig.py.
//
// For one (c, n) row of H values s[h] it sums p*log2(p) with
//   p = max(mixture0[h] + pi[c] * (s[h] - rows[c, h]), 1e-12),
// every value widened to fp32 first (the cache may be stored as bf16).
// Two entropy flavours: exact, log2 taken as logf(p) * log2(e) in full
// precision; approx, the bit-manipulation log2_approx of ops/masked.py
// (exponent from the IEEE-754 bits, degree-6 polynomial in the mantissa,
// Horner with fp32 constants). The library is built with -fmad=false, so
// each p*t + c rounds twice, as the plain PyTorch version computes it.
//
// Loads go VEC values at a time: VEC = 4 (float4) for an fp32 row and
// VEC = 8 (one 16-byte uint4 of bf16) for a bf16 row; fp32 operands read
// beside a bf16 row take two float4 loads. VEC = 1 is the unaligned
// fallback. The wrappers choose VEC from H and the pointers' alignment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace eig {

constexpr float kFloor = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;

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

template <bool APPROX>
__device__ __forceinline__ float plogp(float s, float r, float m, float pi_c) {
  const float p = fmaxf(m + pi_c * (s - r), kFloor);
  if (APPROX) return p * log2_approx(p);
  return p * (logf(p) * kLog2e);
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

// Sum over h of p*log2(p) for one row; the 32 lanes of a warp stride over
// h, a shuffle butterfly finishes. When dst is non-null the row's values
// are also stored there, rounded to T, and scored as rounded (the refresh).
template <int VEC, bool APPROX, typename S, typename T>
__device__ float row_plogp(const S* src, const float* __restrict__ base,
                           const float* __restrict__ mix0, float pi_c, int H,
                           int lane, T* dst) {
  float acc = 0.f;
  for (int i = lane; i < H / VEC; i += 32) {
    float s[VEC], b[VEC], m[VEC];
    load<VEC>(src, i, s);
    load<VEC>(base, i, b);
    load<VEC>(mix0, i, m);
    if (dst) store_round<VEC>(dst, i, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc += plogp<APPROX>(s[k], b[k], m[k], pi_c);
  }
  return warp_sum(acc);
}

}  // namespace eig
