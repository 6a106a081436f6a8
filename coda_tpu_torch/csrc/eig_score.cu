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
// with H2 the base-2 entropy over h (csrc/eig_common.cuh: exact, logf(p) *
// log2(e) in full precision, or the approx polynomial log2). The cache is
// stored as fp32 or bf16 (eig_cache_dtype); all arithmetic is fp32.
//
// Bound on the card: bytes. Kernel 1 reads the (C, N, H) cache once
// (2.0 GB fp32, 1.0 GB bf16 at C=10, N=50,000, H=1000) and does ~8
// operations per element; kernel 2 reads the other C-1 rows and the new
// fp32 (N, H) row hyp_t and writes that row into the cache (2.2 GB fp32,
// 1.2 GB bf16). Both are streams at the memory rate.
//
// Design: one warp per (c, n) row of H, which is contiguous in the
// (C, N, H) layout, so a warp's loads are coalesced (16 bytes per lane:
// float4 for fp32, 8 bf16 for bf16, when H and the pointers allow). Each
// lane sums its strided share of p*log2(p); a shuffle butterfly finishes
// the row. A block owns kItems items and all C of their rows (kItems * C
// rows over kWarps warps, balanced for any C); the per-row entropies meet
// in shared memory, and one thread per item sums the class mixture in c
// order. Kernel 2 is the same loop with the row of class c read from
// hyp_t, rounded to the storage type (round to nearest even), stored into
// cache[c, n, :] and scored as rounded, by the warp that owns (c, n): no
// other warp touches that row, so blocks never race. The small operands
// (rows, mixture0: C*H + H floats) stay in L1/L2. mixture0 and h_before
// come from the wrapper, as the Pallas wrapper's _mixture_stats computes
// them outside its kernel, in the same entropy flavour.

#include "eig_common.cuh"

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kItems = 8;   // items n per block

template <typename T, int VEC, bool REFRESH, bool APPROX>
__global__ void __launch_bounds__(kWarps * 32)
score_kernel(const float* __restrict__ rows, const T* hyp, T* hyp_w,
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
    const float* base = rows + (size_t)c * H;
    float acc;
    if (REFRESH && c == c_ref)
      acc = eig::row_plogp<VEC, APPROX>(hyp_t + (size_t)n * H, base, mixture0,
                                        pi[c], H, lane, hyp_w + off);
    else
      acc = eig::row_plogp<VEC, APPROX>(hyp + off, base, mixture0, pi[c], H,
                                        lane, (T*)nullptr);
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

template <typename T, bool REFRESH, bool APPROX>
int launch_t(const float* rows, const void* hyp, const float* hyp_t,
             const int* c, const float* pi, const float* pi_xi,
             const float* mixture0, const float* h_before, float* out, int C,
             int N, int H, int vec, cudaStream_t stream) {
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  dim3 grid((N + kItems - 1) / kItems), block(kWarps * 32);
  const size_t smem = sizeof(float) * kItems * C;
  const T* h = static_cast<const T*>(hyp);
  T* hw = const_cast<T*>(h);
  if (vec > 1)
    score_kernel<T, kVec, REFRESH, APPROX><<<grid, block, smem, stream>>>(
        rows, h, hw, hyp_t, c, pi, pi_xi, mixture0, h_before, out, C, N, H);
  else
    score_kernel<T, 1, REFRESH, APPROX><<<grid, block, smem, stream>>>(
        rows, h, hw, hyp_t, c, pi, pi_xi, mixture0, h_before, out, C, N, H);
  return (int)cudaGetLastError();
}

template <bool REFRESH>
int launch(const float* rows, const void* hyp, const float* hyp_t,
           const int* c, const float* pi, const float* pi_xi,
           const float* mixture0, const float* h_before, float* out, int C,
           int N, int H, int vec, int bf16, int approx, cudaStream_t stream) {
#define EIG_LAUNCH(T, A)                                                   \
  return launch_t<T, REFRESH, A>(rows, hyp, hyp_t, c, pi, pi_xi, mixture0, \
                                 h_before, out, C, N, H, vec, stream)
  if (bf16) {
    if (approx) EIG_LAUNCH(__nv_bfloat16, true);
    EIG_LAUNCH(__nv_bfloat16, false);
  }
  if (approx) EIG_LAUNCH(float, true);
  EIG_LAUNCH(float, false);
#undef EIG_LAUNCH
}

}  // namespace

extern "C" {

// hyp: (C, N, H) fp32 or, with bf16 != 0, bf16; approx != 0 selects the
// approx entropy; vec > 1 takes 16-byte loads (H % 4 == 0 for fp32,
// H % 8 == 0 for bf16, every row pointer 16-byte aligned).
int eig_score_launch(const float* rows, const void* hyp, const float* pi,
                     const float* pi_xi, const float* mixture0,
                     const float* h_before, float* out, int C, int N, int H,
                     int vec, int bf16, int approx, void* stream) {
  return launch<false>(rows, hyp, nullptr, nullptr, pi, pi_xi, mixture0,
                       h_before, out, C, N, H, vec, bf16, approx,
                       (cudaStream_t)stream);
}

int eig_refresh_score_launch(const float* rows, void* hyp, const float* hyp_t,
                             const int* c, const float* pi, const float* pi_xi,
                             const float* mixture0, const float* h_before,
                             float* out, int C, int N, int H, int vec,
                             int bf16, int approx, void* stream) {
  return launch<true>(rows, hyp, hyp_t, c, pi, pi_xi, mixture0, h_before, out,
                      C, N, H, vec, bf16, approx, (cudaStream_t)stream);
}

}  // extern "C"
