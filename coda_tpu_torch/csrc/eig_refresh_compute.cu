// Fused refresh-compute-score kernel for Hopper (sm_90a).
//
// Replaces coda_tpu/ops/pallas_eig.py:_refresh_compute_score_kernel
// (kernel 6, every round under eig_refresh='fused'). For the labelled
// class c it computes the hypothetical-P(best) row of every item n from
// the O(H*G) Beta grid tables, with eq = (hard_preds[n, :] == c):
//   S[g]   = S0[g] + sum_h eq[h] * dlogcdf[h, g]
//   S     -= max_g S
//   w[g]   = w_trapz[g] * exp(S[g])
//   row[h] = sum_g w[g] * F_u^T[g, h] + eq[h] * sum_g w[g] * dF^T[g, h]
//   row   /= max(sum_h row, 1e-30)
// rounds the row to the cache's storage type (fp32 or bf16, round to
// nearest even), stores it into cache[c, n, :] and scores the item with
// the rounded row, as kernel 2 does (csrc/eig_common.cuh). The (N, H)
// row, S and exp(S) never reach device memory.
//
// Bound on the card. eq is a 0/1 mask, so the function needs 2*N*H*G FLOP
// for the base product and, over the nnz pairs (n, h) where eq is 1,
// nnz*G adds for S and 2*nnz*G for the diff product, plus about 8 per
// scored element (8*C*N*H). At N=50,000, H=1000, G=256, C=10 and nnz about
// N*H/C that is 3.3e10 FLOP on the fp32 CUDA cores (TF32 stays off: the
// reference keeps these products at full fp32), >= 0.50 ms at 67 TFLOP/s.
// The bytes are ~2.2 GB with an fp32 cache (>= 0.66 ms at 3.35 TB/s, the
// bound) and ~1.2 GB with bf16 (>= 0.36 ms; operations bind). This kernel
// does the products densely, 6*N*H*G = 7.7e10 FLOP, as the reference's
// MXU dots do; chip_smoke.py computes the bound from its own inputs.
//
// Design (full fp32 on the CUDA cores; a tensor-core version is later
// work). A block of 256 threads owns kB = 16 items and runs five stages,
// with eq, S and the row in shared memory:
//   0. eq of the kB items as 0/1 floats, u[b][h];
//   1. S[b][g]: one thread per grid point g walks h in order with kB
//      accumulators, eq read four h at a time (float4 broadcast); the
//      table dlogcdf (1 MB) is read once per block, from L2;
//   2. per item, a warp takes max_g S and writes w = w_trapz * exp(S - max);
//   3. each thread takes two models h and walks g in order with four sets
//      of kB accumulators (the two products at each of its h), w read four
//      g at a time (one float4 from shared memory feeds 16 FMAs); F_u^T and
//      dF^T (2 MB) are read once per block, from L2; the thread then writes
//      base + eq * diff over its own eq entries (no other thread reads them);
//   4. per item, a warp sums the row over h, divides, rounds to the storage
//      type, stores row c of the cache and keeps the rounded row;
//   5. score all C rows of the kB items as kernel 2 does, row c from
//      shared memory, the other C-1 rows from the cache.
// A block takes kB*(G + H)*4 bytes of shared memory (82 KB at H=1000,
// G=256, opted in past the 48 KB default); two blocks fit an SM. The
// tables' L2 reads are N/kB * 3 MB = 9.4 GB per call at the headline.
// Stages 1 and 3 wait on shared-memory loads and on the L2 stream of the
// tables more than on the FMA pipes (built with -DK6_STAGES, thread 0 of a
// block stamps clock64() at the start of each stage and of the final class
// sum; scripts/torch_k6_stages.py prints the cycles per stage); PERF.md
// records what was tried. The block that
// computes row c of item n is that row's only reader and writer, so no
// two blocks race. c is read on the device (no host synchronisation); out
// of range gives NaN scores and writes nothing.

#include "eig_common.cuh"

namespace {

#ifdef K6_STAGES
constexpr int kStamps = 8, kStampBlocks = 1 << 14;
__device__ long long k6_stamps[kStampBlocks * kStamps];
#define K6_STAMP(k)                                        \
  do {                                                     \
    if (threadIdx.x == 0 && blockIdx.x < kStampBlocks)     \
      k6_stamps[blockIdx.x * kStamps + (k)] = clock64();   \
  } while (0)
#else
#define K6_STAMP(k) \
  do {              \
  } while (0)
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 16;  // items per block

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// shared-memory floats: w [kB][Gp], u [kB][Hp], h_after [kB][C]
__host__ __device__ inline size_t smem_bytes(int C, int H, int G) {
  return sizeof(float) *
         ((size_t)kB * round_up(G, 4) + (size_t)kB * round_up(H, 8) +
          (size_t)kB * C);
}

template <typename T, int VEC, bool APPROX>
__global__ void __launch_bounds__(kThreads, 2)
refresh_compute_kernel(const float* __restrict__ rows, T* hyp,
                       const int* __restrict__ hard_preds,
                       const int* __restrict__ c_ptr,
                       const float* __restrict__ s0,
                       const float* __restrict__ dlog,
                       const float* __restrict__ fu_t,
                       const float* __restrict__ df_t,
                       const float* __restrict__ w_trapz,
                       const float* __restrict__ pi,
                       const float* __restrict__ pi_xi,
                       const float* __restrict__ mixture0,
                       const float* __restrict__ h_before,
                       float* __restrict__ out, int C, int N, int H, int G) {
  extern __shared__ __align__(16) float smem[];
  const int Gp = round_up(G, 4), Hp = round_up(H, 8);
  float* w = smem;                 // [kB][Gp]: S, then w_trapz * exp(S - max)
  float* u = w + kB * Gp;          // [kB][Hp]: eq, then the row
  float* h_after = u + kB * Hp;    // [kB][C]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kB;
  const int nb = min(kB, N - n0);
  const int c = *c_ptr;
  if ((unsigned)c >= (unsigned)C) {
    if (tid < nb) out[n0 + tid] = NAN;
    return;
  }

  K6_STAMP(0);
  // 0. eq tile (items past N take eq = 0; their rows are never stored)
  for (int i = tid; i < kB * Hp; i += kThreads) {
    const int b = i / Hp, h = i % Hp;
    u[i] = (b < nb && h < H &&
            hard_preds[(size_t)(n0 + b) * H + h] == c) ? 1.f : 0.f;
  }
  __syncthreads();

  K6_STAMP(1);
  // 1. S[b][g] = S0[g] + sum_h eq[b][h] * dlogcdf[h][g], h in order
  for (int g = tid; g < G; g += kThreads) {
    float acc[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) acc[b] = 0.f;
    int h = 0;
#pragma unroll 2
    for (; h + 4 <= H; h += 4) {
      const float d0 = dlog[(size_t)h * G + g];
      const float d1 = dlog[(size_t)(h + 1) * G + g];
      const float d2 = dlog[(size_t)(h + 2) * G + g];
      const float d3 = dlog[(size_t)(h + 3) * G + g];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float4 e = *reinterpret_cast<const float4*>(&u[b * Hp + h]);
        acc[b] = fmaf(e.x, d0, acc[b]);
        acc[b] = fmaf(e.y, d1, acc[b]);
        acc[b] = fmaf(e.z, d2, acc[b]);
        acc[b] = fmaf(e.w, d3, acc[b]);
      }
    }
    for (; h < H; ++h) {
      const float d = dlog[(size_t)h * G + g];
#pragma unroll
      for (int b = 0; b < kB; ++b) acc[b] = fmaf(u[b * Hp + h], d, acc[b]);
    }
    const float s0g = s0[g];
#pragma unroll
    for (int b = 0; b < kB; ++b) w[b * Gp + g] = s0g + acc[b];
  }
  __syncthreads();

  K6_STAMP(2);
  // 2. w = w_trapz * exp(S - max_g S), one warp per item
  for (int b = warp; b < kB; b += kWarps) {
    float m = -INFINITY;
    for (int g = lane; g < G; g += 32) m = fmaxf(m, w[b * Gp + g]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int g = lane; g < G; g += 32)
      w[b * Gp + g] = w_trapz[g] * expf(w[b * Gp + g] - m);
  }
  __syncthreads();

  K6_STAMP(3);
  // 3. unnormalised row: base + eq * diff, g in order; a thread takes two
  //    models h0 and h1 = h0 + kThreads, so each w read from shared memory
  //    feeds four FMAs
  for (int h0 = tid; h0 < H; h0 += 2 * kThreads) {
    const int h1 = h0 + kThreads;
    const bool two = h1 < H;
    const int h1c = two ? h1 : h0;  // a valid address; results unused
    float base0[kB], diff0[kB], base1[kB], diff1[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b)
      base0[b] = diff0[b] = base1[b] = diff1[b] = 0.f;
    int g = 0;
    for (; g + 4 <= G; g += 4) {
      float f0[4], d0[4], f1[4], d1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f0[k] = fu_t[(size_t)(g + k) * H + h0];
        d0[k] = df_t[(size_t)(g + k) * H + h0];
        f1[k] = fu_t[(size_t)(g + k) * H + h1c];
        d1[k] = df_t[(size_t)(g + k) * H + h1c];
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float4 q = *reinterpret_cast<const float4*>(&w[b * Gp + g]);
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          base0[b] = fmaf(qv[k], f0[k], base0[b]);
          diff0[b] = fmaf(qv[k], d0[k], diff0[b]);
          base1[b] = fmaf(qv[k], f1[k], base1[b]);
          diff1[b] = fmaf(qv[k], d1[k], diff1[b]);
        }
      }
    }
    for (; g < G; ++g) {
      const float f0 = fu_t[(size_t)g * H + h0], d0 = df_t[(size_t)g * H + h0];
      const float f1 = fu_t[(size_t)g * H + h1c];
      const float d1 = df_t[(size_t)g * H + h1c];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float q = w[b * Gp + g];
        base0[b] = fmaf(q, f0, base0[b]);
        diff0[b] = fmaf(q, d0, diff0[b]);
        base1[b] = fmaf(q, f1, base1[b]);
        diff1[b] = fmaf(q, d1, diff1[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      float* ub = u + b * Hp;  // eq of this thread's models, then the row
      ub[h0] = ub[h0] != 0.f ? base0[b] + diff0[b] : base0[b];
      if (two) ub[h1] = ub[h1] != 0.f ? base1[b] + diff1[b] : base1[b];
    }
  }
  __syncthreads();

  K6_STAMP(4);
  // 4. normalise, round to the storage type, store row c, keep it rounded
  for (int b = warp; b < kB; b += kWarps) {
    float s = 0.f;
    for (int h = lane; h < H; h += 32) s += u[b * Hp + h];
    const float den = fmaxf(eig::warp_sum(s), 1e-30f);
    if (b < nb) {
      T* dst = hyp + ((size_t)c * N + n0 + b) * (size_t)H;
      for (int h = lane; h < H; h += 32) {
        float v[1] = {u[b * Hp + h] / den};
        eig::store_round<1>(dst, h, v);
        u[b * Hp + h] = v[0];
      }
    }
  }
  __syncthreads();

  K6_STAMP(5);
  // 5. score the kB items: row c from shared memory, the rest from the cache
  for (int j = warp; j < kB * C; j += kWarps) {
    const int cc = j / kB, b = j % kB;
    if (b >= nb) continue;
    const float* base = rows + (size_t)cc * H;
    float acc;
    if (cc == c)
      acc = eig::row_plogp<VEC, APPROX>(u + b * Hp, base, mixture0, pi[cc], H,
                                        lane, (float*)nullptr);
    else
      acc = eig::row_plogp<VEC, APPROX>(
          hyp + ((size_t)cc * N + n0 + b) * (size_t)H, base, mixture0, pi[cc],
          H, lane, (T*)nullptr);
    if (lane == 0) h_after[b * C + cc] = -acc;
  }
  __syncthreads();
  K6_STAMP(6);
  if (tid < nb) {
    const int n = n0 + tid;
    float s = 0.f;
    for (int cc = 0; cc < C; ++cc)
      s += pi_xi[(size_t)n * C + cc] * h_after[tid * C + cc];
    out[n] = h_before[0] - s;
  }
}

template <typename T, bool APPROX>
int launch_t(const float* rows, void* hyp, const int* hard_preds, const int* c,
             const float* s0, const float* dlog, const float* fu_t,
             const float* df_t, const float* w_trapz, const float* pi,
             const float* pi_xi, const float* mixture0, const float* h_before,
             float* out, int C, int N, int H, int G, int vec,
             cudaStream_t stream) {
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  const size_t smem = smem_bytes(C, H, G);
  dim3 grid((N + kB - 1) / kB), block(kThreads);
  T* h = static_cast<T*>(hyp);
  auto kernel = vec > 1 ? refresh_compute_kernel<T, kVec, APPROX>
                        : refresh_compute_kernel<T, 1, APPROX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, stream>>>(rows, h, hard_preds, c, s0, dlog,
                                        fu_t, df_t, w_trapz, pi, pi_xi,
                                        mixture0, h_before, out, C, N, H, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; the wrapper refuses shapes past
// the card's opt-in limit before launching.
long long eig_refresh_compute_smem(int C, int H, int G) {
  return (long long)smem_bytes(C, H, G);
}

#ifdef K6_STAGES
// The clock64() stamps of the last launch: 8 per block (stages 0-5 and the
// class sum, then one unused), for the first n / 8 blocks (n <= 8 * 16384).
int eig_refresh_compute_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k6_stamps, sizeof(long long) * n);
}
#endif

// hyp: (C, N, H) fp32 or, with bf16 != 0, bf16, written in row *c;
// hard_preds (N, H) int32; s0 (G,), dlog (H, G), fu_t and df_t (G, H),
// w_trapz (G,) fp32. vec > 1 takes 16-byte loads in the scoring stage.
int eig_refresh_compute_launch(
    const float* rows, void* hyp, const int* hard_preds, const int* c,
    const float* s0, const float* dlog, const float* fu_t, const float* df_t,
    const float* w_trapz, const float* pi, const float* pi_xi,
    const float* mixture0, const float* h_before, float* out, int C, int N,
    int H, int G, int vec, int bf16, int approx, void* stream) {
#define EIG_LAUNCH(T, A)                                                    \
  return launch_t<T, A>(rows, hyp, hard_preds, c, s0, dlog, fu_t, df_t,     \
                        w_trapz, pi, pi_xi, mixture0, h_before, out, C, N, \
                        H, G, vec, (cudaStream_t)stream)
  if (bf16) {
    if (approx) EIG_LAUNCH(__nv_bfloat16, true);
    EIG_LAUNCH(__nv_bfloat16, false);
  }
  if (approx) EIG_LAUNCH(float, true);
  EIG_LAUNCH(float, false);
#undef EIG_LAUNCH
}

}  // extern "C"
