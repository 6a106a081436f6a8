// Row gather-sum for the delta pi-hat update, for Hopper (sm_90a).
//
// Replaces coda_tpu/ops/pallas_gather.py:_gather_kernel (kernel 3, every
// round):
//   out[n] = sum_h src[s[h], h, n],  summed in h order from 0,
// the order of the Pallas kernel's accumulator. The seed-batched engine
// takes the same kernel with a replica axis: s (S, H) -> out (S, N), one
// launch for all S replicas (gridDim.y = S), each replica's row summed
// exactly as the single-replica launch sums it, so bitwise equal to it.
// (The reference takes XLA's gather under vmap instead; that was a TPU
// decision.)
//
// Bound on the card: bytes. One N-row per model, H*N*4 bytes read (0.2 GB
// at H=1000, N=50,000) plus the (N,) output; one add per element read.
// With S replicas, the distinct rows the replicas' classes select.
//
// Design: src is the (C, H, N) contiguous transpose of the predictions,
// built once per experiment. One thread per item n, so a warp's loads of
// a model row are 32 neighbouring floats (coalesced). The block first
// copies s into shared memory; every thread then walks h = 0..H-1, and
// the loop is unrolled so several independent row loads are in flight
// per thread. The TPU kernel's lane-padded (C*H, 1, Np) layout and its
// double-buffered DMA slots have no counterpart here. A class index out
// of [0, C) reads nothing and yields NaN for the item.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

// BATCHED: the replica is blockIdx.y; otherwise the constant 0, so the
// single-replica kernel carries no replica arithmetic
template <bool BATCHED>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ src, const int* __restrict__ s,
                  float* __restrict__ out, int C, int H, int N) {
  extern __shared__ int s_sh[];  // [H]
  const size_t rep = BATCHED ? blockIdx.y : 0;
  int bad = 0;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const int c = s[rep * H + h];
    s_sh[h] = c;
    bad |= (unsigned)c >= (unsigned)C;
  }
  // validated once per block, so the hot loop below has no branch and
  // its unrolled loads can all be in flight together
  bad = __syncthreads_or(bad);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  if (bad) {
    out[rep * N + n] = NAN;
    return;
  }
  const float* col = src + n;
  float acc = 0.f;
#pragma unroll 8
  for (int h = 0; h < H; ++h)
    acc += col[((size_t)s_sh[h] * H + h) * (size_t)N];
  out[rep * N + n] = acc;
}

template <bool BATCHED>
int launch(const float* src, const int* s, float* out, int S, int C, int H,
           int N, cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, S), block(kThreads);
  size_t smem = sizeof(int) * (size_t)H;
  row_gather_kernel<BATCHED><<<grid, block, smem, stream>>>(src, s, out, C,
                                                            H, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src (C, H, N) fp32, s (H,) int32 -> out (N,)
int row_gather_launch(const float* src, const int* s, float* out, int C,
                      int H, int N, void* stream) {
  return launch<false>(src, s, out, 1, C, H, N, (cudaStream_t)stream);
}

// the replica axis: s (S, H) int32 -> out (S, N), 1 <= S <= 65535
int row_gather_batched_launch(const float* src, const int* s, float* out,
                              int S, int C, int H, int N, void* stream) {
  return launch<true>(src, s, out, S, C, H, N, (cudaStream_t)stream);
}

}  // extern "C"
