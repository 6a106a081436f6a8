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
// with H2 the base-2 entropy over h (csrc/eig_common.cuh: exact, each term
// within 4 * 2^-24 * max(|t|, p) of its double-precision value, or the
// approx polynomial log2). The cache is stored as fp32 or bf16
// (eig_cache_dtype); all arithmetic is fp32.
//
// Bound on the card: bytes. Kernel 1 reads the (C, N, H) cache once
// (2.0 GB fp32, 1.0 GB bf16 at C=10, N=50,000, H=1000) and does ~8
// operations per element; kernel 2 reads the other C-1 rows and the new
// fp32 (N, H) row hyp_t and writes that row into the cache (2.2 GB fp32,
// 1.2 GB bf16). Both are streams at the memory rate, provided each
// element costs few enough instructions: with a full-precision logf the
// bf16 flavours are bound by instruction issue (37 SASS instructions an
// element), so the exact flavour takes the log from the SFU's lg2.approx
// in one instruction (12 an element; scripts/torch_sass_count.py).
//
// Design: each (c, n) row of H is contiguous in the (C, N, H) layout, so a
// warp's loads are coalesced (16 bytes per lane: float4 for fp32, 8 bf16
// for bf16, when H and the pointers allow). Each lane sums its strided
// share of p*log2(p) in h order, a shuffle butterfly finishes the row, and
// each item's class mixture is summed in c order. The exact flavour
// (eig::score_warp): a warp scores eig::kExactRows consecutive items,
// class by class, loading the class's rows[c, :] and mixture0 vectors once
// for them; no shared memory, no barrier. The approx flavour
// (eig::score_block_approx): a warp per (c, n) row, the rows' entropies
// meeting in shared memory (8 items x C floats a block). Kernel 2 is the
// same pass with the row of class c read from hyp_t, rounded to the
// storage type (round to nearest even), stored into cache[c, n, :] and
// scored as rounded, by the warp that owns (c, n): no other warp touches
// that row, so blocks never race. The small operands (rows, mixture0: C*H
// + H floats) stay in L1/L2. mixture0 and h_before come from the wrapper,
// as the Pallas wrapper's _mixture_stats computes them outside its kernel,
// in the same entropy flavour.
//
// Kernels 4 and 5 are the same kernel over a second grid axis: the TPU
// kernels' leading replica grid axis becomes blockIdx.y = s, and a block
// runs kernel 1's or kernel 2's body on replica s's slices (cache s*C*N*H,
// rows s*C*H, pi s*C, pi_xi s*N*C, mixture0 s*H, h_before s, out s*N,
// hyp_t s*N*H, class c[s]). The per-replica arithmetic is therefore
// kernel 1's or 2's exactly: each replica's scores and cache are bitwise
// those of the single-replica launch. Offsets are size_t from the first
// multiplication (S*C*N*H = 2.5e9 elements at S=5 and the headline shape).
// The BATCHED template flag is off for kernels 1 and 2: their replica is
// the constant 0, every offset folds away at compile time and they carry
// no replica arithmetic (folding it in at run time cost them 8-32
// registers a thread and a few per cent of speed). The bound is S times
// the single replica's, and so is the work: one launch replaces S.
//
// Kernels 1, 2, 4 and 5 have a second decomposition, for item grids too
// short to fill the card (a short item axis at a wide C x H: 256 items give
// the exact pass 8 blocks for 132 SMs, each warp walking 1000 classes in
// turn, and 5 replicas of them 40). The launch becomes grid(item blocks,
// class chunks), and grid(item blocks, class chunks, S) for kernels 4 and
// 5: block (b, k, s) scores item block b's items of replica s over the
// classes of chunk k only, a contiguous range, and each warp writes each
// (c, n) row's term of the class mixture, -H2(p[c, n, :]), to an fp32
// scratch ent (S, N, C), laid out as pi_xi (8*S*C*N bytes of traffic: 2 MB
// a replica beside its 512 MB cache at C=1000, N=256, H=500). A row's term
// is computed by the single launch's own code (eig::rows_plogp for the
// exact flavour, eig::row_plogp_approx for the approx one: the same lane
// striding, kExactRows grouping and shuffle butterfly), so it is bitwise
// the value the single launch adds. A second small launch
// (class_mix_kernel over grid(N/8, S), a warp an item, both rows read
// coalesced) then sums each item's mixture from 0 in c order:
//   out[s, n] = h_before[s] - sum_c pi_xi[s, n, c] * ent[s, n, c],
// the single launch's arithmetic step for step (built with -fmad=false,
// each product and sum rounds as there). Scores and the refreshed rows are
// therefore bitwise the single launch's at every chunk count, and each
// replica's bitwise kernel 1's or 2's. In kernels 2 and 5 the chunk holding
// a replica's c_ref writes its refreshed row, one warp a row; a replica
// whose class is out of [0, C) writes nothing and gets NaN scores from the
// mixture launch, the other replicas running on. The wrapper picks the
// chunk count (ops/eig_kernels.choose_class_chunks): the split where the
// single launch holds too few rows in flight, S * N under 32 items an SM;
// one chunk is the single launch, unchanged. The two split kernels live in
// csrc/eig_common.cuh, where kernel 6's scoring launch takes them too.
//
// eig_plogp_sweep_launch evaluates the exact flavour's term on given p,
// for the log-term sweep that holds it to its error contract on the card.

#include "eig_common.cuh"

namespace {

template <typename T, int VEC, bool REFRESH, bool APPROX, bool BATCHED>
__global__ void __launch_bounds__(eig::kScoreWarps * 32)
score_kernel(const float* __restrict__ rows, const T* hyp, T* hyp_w,
             const float* __restrict__ hyp_t, const int* __restrict__ c_ptr,
             const float* __restrict__ pi, const float* __restrict__ pi_xi,
             const float* __restrict__ mixture0,
             const float* __restrict__ h_before, float* __restrict__ out,
             int C, int N, int H) {
  extern __shared__ float h_after[];  // the approx pass: [kScoreWarps][C]
  // the replica: blockIdx.y for kernels 4 and 5, the constant 0 otherwise
  const size_t rep = BATCHED ? blockIdx.y : 0;
  const int c_ref = REFRESH ? c_ptr[rep] : -1;
  if constexpr (APPROX) {
    eig::score_block_approx<T, VEC, REFRESH ? 1 : 0>(
        rows, hyp, hyp_w, hyp_t, nullptr, c_ref, pi, pi_xi, mixture0,
        h_before + rep, out, C, N, H, rep, h_after);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * eig::kScoreWarps + warp) * eig::kExactRows;
    eig::score_warp<T, VEC, REFRESH ? 1 : 0>(
        rows, hyp, hyp_w, hyp_t, nullptr, c_ref, pi, pi_xi, mixture0,
        h_before[rep], out, C, N, H, rep, n0, lane);
  }
}

// p*log2(p) for each p: the exact flavour's term as the scoring loop
// computes it (mode 0), the full-precision logf(p) * log2(e) * p (mode 1),
// or the bare lg2.approx term p * lg2(p) for every p (mode 2)
__global__ void plogp_sweep_kernel(const float* __restrict__ p,
                                   float* __restrict__ out, long long n,
                                   int mode) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float x[1] = {p[i]};
    float t[1];
    eig::exact_terms<1>(x, t);
    out[i] = mode == 0   ? t[0]
             : mode == 1 ? x[0] * (logf(x[0]) * eig::kLog2e)
                         : x[0] * eig::lg2_hw(x[0]);
  }
}

template <typename T, bool REFRESH, bool APPROX, bool BATCHED>
int launch_t(const float* rows, const void* hyp, const float* hyp_t,
             const int* c, const float* pi, const float* pi_xi,
             const float* mixture0, const float* h_before, float* out, int S,
             int C, int N, int H, int vec, cudaStream_t stream) {
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  constexpr int kItems = eig::score_items<APPROX>();
  dim3 grid((N + kItems - 1) / kItems, S), block(eig::kScoreWarps * 32);
  const size_t smem = APPROX ? sizeof(float) * eig::kScoreWarps * C : 0;
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

// Kernels 1 and 2 split over 2 <= chunks <= min(C, 65535) class chunks:
// the operands above, and ent an (N, C) fp32 scratch the launch overwrites
int eig_score_split_launch(const float* rows, const void* hyp,
                           const float* pi, const float* pi_xi,
                           const float* mixture0, const float* h_before,
                           float* out, float* ent, int C, int N, int H,
                           int vec, int bf16, int approx, int chunks,
                           void* stream) {
  return eig::launch_split<0, false>(rows, hyp, nullptr, nullptr, nullptr,
                                     pi, pi_xi, mixture0, h_before, out, ent,
                                     1, C, N, H, vec, bf16, approx, chunks,
                                     (cudaStream_t)stream);
}

int eig_refresh_score_split_launch(const float* rows, void* hyp,
                                   const float* hyp_t, const int* c,
                                   const float* pi, const float* pi_xi,
                                   const float* mixture0,
                                   const float* h_before, float* out,
                                   float* ent, int C, int N, int H, int vec,
                                   int bf16, int approx, int chunks,
                                   void* stream) {
  return eig::launch_split<1, false>(rows, hyp, hyp_t, nullptr, c, pi, pi_xi,
                                     mixture0, h_before, out, ent, 1, C, N, H,
                                     vec, bf16, approx, chunks,
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

// Kernels 4 and 5 split over 2 <= chunks <= min(C, 65535) class chunks,
// per replica: the batched operands above, and ent an (S, N, C) fp32
// scratch the launch overwrites
int eig_score_batched_split_launch(const float* rows, const void* hyp,
                                   const float* pi, const float* pi_xi,
                                   const float* mixture0,
                                   const float* h_before, float* out,
                                   float* ent, int S, int C, int N, int H,
                                   int vec, int bf16, int approx, int chunks,
                                   void* stream) {
  return eig::launch_split<0, true>(rows, hyp, nullptr, nullptr, nullptr,
                                    pi, pi_xi, mixture0, h_before, out, ent,
                                    S, C, N, H, vec, bf16, approx, chunks,
                                    (cudaStream_t)stream);
}

int eig_refresh_score_batched_split_launch(
    const float* rows, void* hyp, const float* hyp_t, const int* c,
    const float* pi, const float* pi_xi, const float* mixture0,
    const float* h_before, float* out, float* ent, int S, int C, int N,
    int H, int vec, int bf16, int approx, int chunks, void* stream) {
  return eig::launch_split<1, true>(rows, hyp, hyp_t, nullptr, c, pi, pi_xi,
                                    mixture0, h_before, out, ent, S, C, N, H,
                                    vec, bf16, approx, chunks,
                                    (cudaStream_t)stream);
}

// the log-term sweep: out[i] = the term of p[i] (mode: see
// plogp_sweep_kernel), p and out (n,) fp32
int eig_plogp_sweep_launch(const float* p, float* out, long long n, int mode,
                           void* stream) {
  plogp_sweep_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(p, out, n,
                                                                mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
