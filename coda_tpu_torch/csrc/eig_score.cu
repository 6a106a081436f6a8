// Incremental-EIG scoring kernels for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of coda_tpu/ops/pallas_eig.py:
//   kernel 1, _score_block_kernel (the init score-ahead),
//   kernel 2, _refresh_score_kernel (every round: write the refreshed
//             class row c into the cache while scoring with it), and
//             their seed-batched forms, one launch for S replicas:
//   kernel 4, _batched_score_kernel, and
//   kernel 5, _batched_refresh_kernel (each replica s refreshes its own
//             class row c[s]).
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
//
// Kernels 4 and 5 are the same kernel over a second grid axis: the TPU
// kernels' leading replica grid axis becomes blockIdx.y = s, and a block
// runs kernel 1's or kernel 2's body on replica s's slices (cache s*C*N*H,
// rows s*C*H, pi s*C, pi_xi s*N*C, mixture0 s*H, h_before s, out s*N,
// hyp_t s*N*H, class c[s]). The per-replica arithmetic is therefore
// kernel 1's or 2's exactly: each replica's scores and cache are bitwise
// those of the single-replica launch. Offsets are size_t from the first
// multiplication (S*C*N*H = 2.5e9 elements at S=5 and the headline shape)
// and fold the replica into the row and item indices the body computes
// anyway, so no offset pointer is kept in registers. The BATCHED template
// flag is off for kernels 1 and 2: their replica is the constant 0, every
// offset folds away at compile time and they carry no replica arithmetic
// (folding it in at run time cost them 8-32 registers a thread and a few
// per cent of speed). The bound is S times the single replica's, and so
// is the work: one launch replaces S.

#include "eig_common.cuh"

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kItems = 8;   // items n per block

template <typename T, int VEC, bool REFRESH, bool APPROX, bool BATCHED>
__global__ void __launch_bounds__(kWarps * 32)
score_kernel(const float* __restrict__ rows, const T* hyp, T* hyp_w,
             const float* __restrict__ hyp_t, const int* __restrict__ c_ptr,
             const float* __restrict__ pi, const float* __restrict__ pi_xi,
             const float* __restrict__ mixture0,
             const float* __restrict__ h_before, float* __restrict__ out,
             int C, int N, int H) {
  extern __shared__ float h_after[];  // [kItems][C]
  // the replica: blockIdx.y for kernels 4 and 5, the constant 0 otherwise
  const size_t rep = BATCHED ? blockIdx.y : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kItems;
  const int c_ref = REFRESH ? c_ptr[rep] : -1;
  const float* mix0 = mixture0 + rep * H;
  for (int j = warp; j < kItems * C; j += kWarps) {
    const int c = j / kItems, i = j % kItems, n = n0 + i;
    if (n >= N) continue;
    const size_t rc = rep * C + c;  // the replica's class row
    const size_t off = (rc * N + n) * (size_t)H;
    const float* base = rows + rc * H;
    float acc;
    if (REFRESH && c == c_ref)
      acc = eig::row_plogp<VEC, APPROX>(hyp_t + (rep * N + n) * H, base, mix0,
                                        pi[rc], H, lane, hyp_w + off);
    else
      acc = eig::row_plogp<VEC, APPROX>(hyp + off, base, mix0, pi[rc], H,
                                        lane, (T*)nullptr);
    if (lane == 0) h_after[i * C + c] = -acc;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kItems && n0 + i < N) {
    const size_t rn = rep * N + n0 + i;  // the replica's item
    if (REFRESH && (unsigned)c_ref >= (unsigned)C) {
      out[rn] = NAN;  // class index out of range: no row was refreshed
      return;
    }
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += pi_xi[rn * C + c] * h_after[i * C + c];
    out[rn] = h_before[rep] - s;
  }
}

template <typename T, bool REFRESH, bool APPROX, bool BATCHED>
int launch_t(const float* rows, const void* hyp, const float* hyp_t,
             const int* c, const float* pi, const float* pi_xi,
             const float* mixture0, const float* h_before, float* out, int S,
             int C, int N, int H, int vec, cudaStream_t stream) {
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  dim3 grid((N + kItems - 1) / kItems, S), block(kWarps * 32);
  const size_t smem = sizeof(float) * kItems * C;
  const T* h = static_cast<const T*>(hyp);
  T* hw = const_cast<T*>(h);
  if (vec > 1)
    score_kernel<T, kVec, REFRESH, APPROX, BATCHED>
        <<<grid, block, smem, stream>>>(rows, h, hw, hyp_t, c, pi, pi_xi,
                                        mixture0, h_before, out, C, N, H);
  else
    score_kernel<T, 1, REFRESH, APPROX, BATCHED>
        <<<grid, block, smem, stream>>>(rows, h, hw, hyp_t, c, pi, pi_xi,
                                        mixture0, h_before, out, C, N, H);
  return (int)cudaGetLastError();
}

template <bool REFRESH, bool BATCHED>
int launch(const float* rows, const void* hyp, const float* hyp_t,
           const int* c, const float* pi, const float* pi_xi,
           const float* mixture0, const float* h_before, float* out, int S,
           int C, int N, int H, int vec, int bf16, int approx,
           cudaStream_t stream) {
#define EIG_LAUNCH(T, A)                                                   \
  return launch_t<T, REFRESH, A, BATCHED>(rows, hyp, hyp_t, c, pi, pi_xi,  \
                                          mixture0, h_before, out, S, C, N, \
                                          H, vec, stream)
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
  return launch<false, false>(rows, hyp, nullptr, nullptr, pi, pi_xi,
                              mixture0, h_before, out, 1, C, N, H, vec, bf16,
                              approx, (cudaStream_t)stream);
}

int eig_refresh_score_launch(const float* rows, void* hyp, const float* hyp_t,
                             const int* c, const float* pi, const float* pi_xi,
                             const float* mixture0, const float* h_before,
                             float* out, int C, int N, int H, int vec,
                             int bf16, int approx, void* stream) {
  return launch<true, false>(rows, hyp, hyp_t, c, pi, pi_xi, mixture0,
                             h_before, out, 1, C, N, H, vec, bf16, approx,
                             (cudaStream_t)stream);
}

// Kernels 4 and 5: the same operands with a leading replica axis of S
// (1 <= S <= 65535, the grid's y limit): rows (S, C, H), hyp (S, C, N, H),
// pi (S, C), pi_xi (S, N, C), mixture0 (S, H), h_before (S,), out (S, N);
// for the refresh hyp_t (S, N, H) and c (S,).
int eig_score_batched_launch(const float* rows, const void* hyp,
                             const float* pi, const float* pi_xi,
                             const float* mixture0, const float* h_before,
                             float* out, int S, int C, int N, int H, int vec,
                             int bf16, int approx, void* stream) {
  return launch<false, true>(rows, hyp, nullptr, nullptr, pi, pi_xi,
                             mixture0, h_before, out, S, C, N, H, vec, bf16,
                             approx, (cudaStream_t)stream);
}

int eig_refresh_score_batched_launch(const float* rows, void* hyp,
                                     const float* hyp_t, const int* c,
                                     const float* pi, const float* pi_xi,
                                     const float* mixture0,
                                     const float* h_before, float* out, int S,
                                     int C, int N, int H, int vec, int bf16,
                                     int approx, void* stream) {
  return launch<true, true>(rows, hyp, hyp_t, c, pi, pi_xi, mixture0,
                            h_before, out, S, C, N, H, vec, bf16, approx,
                            (cudaStream_t)stream);
}

}  // extern "C"
