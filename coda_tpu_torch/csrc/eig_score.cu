// Incremental-EIG scoring kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of coda_tpu/ops/pallas_eig.py:
//   kernel 1, _score_block_kernel (the init score-ahead), and
//   kernel 2, _refresh_score_kernel (every round: write the refreshed
//             class row c into the cache while scoring with it).
//
// Both compute, for every item n,
//   score[n] = h_before - sum_c pi_xi[n, c] * H2(p[c, n, :]),
//   p[c, n, h] = max(mixture0[h] + pi[c] * (hyp[c, n, h] - rows[c, h]), 1e-12)
// with H2 the base-2 entropy over h, log2 taken as logf(p) * log2(e) in
// full precision (as the Pallas kernel does; built without fast math).
//
// Bound on the card: bytes. Kernel 1 reads the (C, N, H) fp32 cache once
// (2.0 GB at C=10, N=50,000, H=1000) and does ~8 operations per element;
// kernel 2 reads the other C-1 rows, the new (N, H) row hyp_t and writes
// it into the cache (2.2 GB). Both are streams at the memory rate.
//
// Design: one warp per (c, n) row of H, which is contiguous in the
// (C, N, H) layout, so a warp's loads are coalesced (float4 per lane when
// H % 4 == 0). Each lane sums its strided share of p*log2(p); a shuffle
// butterfly finishes the row. A block owns kItems items and all C of
// their rows (kItems * C rows over kWarps warps, balanced for any C); the
// per-row entropies meet in shared memory, and one thread per item sums
// the class mixture in c order. Kernel 2 is the same loop with the row
// of class c read from hyp_t and stored into cache[c, n, :] by the warp
// that owns (c, n): no other warp touches that row, so blocks never race.
// The small operands (rows, mixture0: C*H + H floats) stay in L1/L2.
// mixture0 and h_before come from the wrapper, as the Pallas wrapper's
// _mixture_stats computes them outside its kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kItems = 8;   // items n per block
constexpr float kFloor = 1e-12f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float plogp(float s, float r, float m, float pi_c) {
  float p = fmaxf(m + pi_c * (s - r), kFloor);
  return p * (logf(p) * kLog2e);
}

// Sum over h of p*log2(p) for one row; lanes stride over h. When dst is
// non-null the row's source values are also stored there (the refresh).
template <int VEC>
__device__ float row_plogp(const float* src, const float* __restrict__ base,
                           const float* __restrict__ mix0, float pi_c, int H,
                           int lane, float* dst) {
  float acc = 0.f;
  if (VEC == 4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4* b4 = reinterpret_cast<const float4*>(base);
    const float4* m4 = reinterpret_cast<const float4*>(mix0);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = lane; i < H / 4; i += 32) {
      float4 s = s4[i], b = b4[i], m = m4[i];
      if (dst) d4[i] = s;
      acc += plogp(s.x, b.x, m.x, pi_c);
      acc += plogp(s.y, b.y, m.y, pi_c);
      acc += plogp(s.z, b.z, m.z, pi_c);
      acc += plogp(s.w, b.w, m.w, pi_c);
    }
  } else {
    for (int h = lane; h < H; h += 32) {
      float s = src[h];
      if (dst) dst[h] = s;
      acc += plogp(s, base[h], mix0[h], pi_c);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <int VEC, bool REFRESH>
__global__ void __launch_bounds__(kWarps * 32)
score_kernel(const float* __restrict__ rows, const float* hyp, float* hyp_w,
             const float* __restrict__ hyp_t, const int* __restrict__ c_ptr,
             const float* __restrict__ pi, const float* __restrict__ pi_xi,
             const float* __restrict__ mixture0,
             const float* __restrict__ h_before, float* __restrict__ out,
             int C, int N, int H) {
  extern __shared__ float h_after[];  // [kItems][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kItems;
  const int c_ref = REFRESH ? *c_ptr : -1;
  for (int j = warp; j < kItems * C; j += kWarps) {
    const int c = j / kItems, i = j % kItems, n = n0 + i;
    if (n >= N) continue;
    const size_t off = ((size_t)c * N + n) * (size_t)H;
    const float* src = hyp + off;
    float* dst = nullptr;
    if (REFRESH && c == c_ref) {
      src = hyp_t + (size_t)n * H;
      dst = hyp_w + off;
    }
    float acc = row_plogp<VEC>(src, rows + (size_t)c * H, mixture0, pi[c], H,
                               lane, dst);
    if (lane == 0) h_after[i * C + c] = -acc;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kItems && n0 + i < N) {
    const int n = n0 + i;
    if (REFRESH && (unsigned)c_ref >= (unsigned)C) {
      out[n] = NAN;  // class index out of range: no row was refreshed
      return;
    }
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += pi_xi[(size_t)n * C + c] * h_after[i * C + c];
    out[n] = h_before[0] - s;
  }
}

template <bool REFRESH>
int launch(const float* rows, const float* hyp, float* hyp_w,
           const float* hyp_t, const int* c, const float* pi,
           const float* pi_xi, const float* mixture0, const float* h_before,
           float* out, int C, int N, int H, int vec, cudaStream_t stream) {
  dim3 grid((N + kItems - 1) / kItems), block(kWarps * 32);
  size_t smem = sizeof(float) * kItems * C;
  if (vec == 4)
    score_kernel<4, REFRESH><<<grid, block, smem, stream>>>(
        rows, hyp, hyp_w, hyp_t, c, pi, pi_xi, mixture0, h_before, out, C, N, H);
  else
    score_kernel<1, REFRESH><<<grid, block, smem, stream>>>(
        rows, hyp, hyp_w, hyp_t, c, pi, pi_xi, mixture0, h_before, out, C, N, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int eig_score_launch(const float* rows, const float* hyp, const float* pi,
                     const float* pi_xi, const float* mixture0,
                     const float* h_before, float* out, int C, int N, int H,
                     int vec, void* stream) {
  return launch<false>(rows, hyp, nullptr, nullptr, nullptr, pi, pi_xi,
                       mixture0, h_before, out, C, N, H, vec,
                       (cudaStream_t)stream);
}

int eig_refresh_score_launch(const float* rows, float* hyp, const float* hyp_t,
                             const int* c, const float* pi, const float* pi_xi,
                             const float* mixture0, const float* h_before,
                             float* out, int C, int N, int H, int vec,
                             void* stream) {
  return launch<true>(rows, hyp, hyp, hyp_t, c, pi, pi_xi, mixture0, h_before,
                      out, C, N, H, vec, (cudaStream_t)stream);
}

}  // extern "C"
