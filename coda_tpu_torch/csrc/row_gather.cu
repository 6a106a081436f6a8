// Row gather-sum for the delta pi-hat update, for Hopper (sm_90a).
//
// Replaces coda_tpu/ops/pallas_gather.py:_gather_kernel (kernel 3, every
// round):
//   out[n] = sum_h src[s[h], h, n],  summed in h order from 0 in fp32,
// the order of the Pallas kernel's accumulator. The seed-batched engine
// takes the same kernel with a replica axis: s (S, H) -> out (S, N), one
// launch for all S replicas, each replica's row summed exactly as the
// single-replica launch sums it, so bitwise equal to it. (The reference
// takes XLA's gather under vmap instead; that was a TPU decision.)
//
// Bound on the card: bytes. One N-row per model, H*N*4 bytes read (0.2 GB
// at H=1000, N=50,000) plus the (N,) output; one add per element read.
// With S replicas, the distinct rows the replicas' classes select. What
// holds a stream of this size back is the bytes in flight: at 3.35 TB/s
// and about 0.7 us of latency the card needs about 2.3 MB in flight, some
// 18 KB an SM.
//
// Design: src is the (C, H, N) contiguous transpose of the predictions,
// built once per experiment. A block of 128 threads owns a tile of 128
// items, one per thread (391 tiles at N = 50,000). Two paths, chosen by
// the wrapper as kernels 1-2 choose their vector width:
//   aligned (N a multiple of 4, src 16-byte aligned, so every row segment
//     starts 16-byte aligned): the block streams the tile's 512-byte
//     segment of each selected row (s[h], h) through a ring of kDepth
//     stages of kRows rows in shared memory, filled by 16-byte cp.async
//     kDepth - 1 stages ahead of the stage being summed. Each thread then
//     adds its item's column of each stage in h order. One barrier a stage
//     both publishes the stage's copies and frees the slot the next copy
//     refills. 4 stages of 4 KB: 16 KB of shared memory a block, 12 KB in
//     flight; at 391 blocks all are resident (about 3 an SM, 36 KB in
//     flight an SM).
//   4-byte (a ragged N such as 50,001, where no row segment is 16-byte
//     aligned): each thread loads its item's value of kUnroll rows at once
//     into registers, then adds them in h order; the classes pass through
//     shared memory kClassChunk at a time.
// Either way the sum is the in-order sum. With a replica axis, the blocks
// of one tile's S replicas are neighbours in the grid (block b: replica
// b % S, tile b / S), so they run together and a row that several
// replicas select is read from device memory once and from L2 after. No H
// limit applies. A class index out of [0, C) reads nothing and yields NaN
// for the item. The TPU kernel's lane-padded (C*H, 1, Np) layout and its
// double-buffered DMA slots have no counterpart here.
//
// The register path holds fewer bytes in flight than the ring, so the
// ring is the faster path where both apply (scripts/torch_kernel_times.py
// times both at the headline: PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;     // items per block, one per thread
constexpr int kRows = 8;       // rows per stage of the ring
constexpr int kDepth = 4;      // stages in the ring
constexpr int kUnroll = 16;    // rows in flight a thread (4-byte path)
constexpr int kClassChunk = 2048;       // classes staged at a time (4-byte)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// The block's replica and tile. BATCHED: block b is replica b % S of tile
// b / S; otherwise the constant replica 0, so the single-replica kernel
// carries no replica arithmetic.
template <bool BATCHED>
__device__ __forceinline__ void place(int S, size_t& rep, int& tile) {
  rep = BATCHED ? blockIdx.x % S : 0;
  tile = BATCHED ? blockIdx.x / S : blockIdx.x;
}

// Any class of the replica out of [0, C)? Every thread of the block gets
// the answer; the copies below then need no check.
__device__ __forceinline__ bool any_bad(const int* sr, int C, int H) {
  int bad = 0;
  for (int h = threadIdx.x; h < H; h += kTile)
    bad |= (unsigned)sr[h] >= (unsigned)C;
  return __syncthreads_or(bad);
}

template <bool BATCHED>
__global__ void __launch_bounds__(kTile)
ring_gather_kernel(const float* __restrict__ src, const int* __restrict__ s,
                   float* __restrict__ out, int S, int C, int H, int N) {
  __shared__ __align__(16) float ring[kDepth][kRows][kTile];
  size_t rep;
  int tile;
  place<BATCHED>(S, rep, tile);
  const int* sr = s + rep * H;
  const int tid = threadIdx.x, n0 = tile * kTile, n = n0 + tid;
  if (any_bad(sr, C, H)) {
    if (n < N) out[rep * N + n] = NAN;
    return;
  }
  // stage st's rows h = st*kRows .. into slot st % kDepth; a group is
  // committed for every stage, empty past the last, so the waits count
  // stages
  constexpr int kPer = kTile / 4;  // 16-byte copies a row segment
  static_assert(kRows * kPer % kTile == 0, "whole copies a thread");
  auto issue = [&](int st) {
    float(*slot)[kTile] = ring[st % kDepth];
#pragma unroll
    for (int k = 0; k < kRows * kPer / kTile; ++k) {
      const int q = tid + k * kTile;
      const int r = q / kPer, i = (q % kPer) * 4, h = st * kRows + r;
      if (h < H && n0 + i < N)
        cp_async16(&slot[r][i], src + ((size_t)sr[h] * H + h) * N + n0 + i);
    }
    cp_async_commit();
  };
  const int stages = (H + kRows - 1) / kRows;
  for (int st = 0; st < kDepth - 1; ++st) issue(st);
  float acc = 0.f;
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kDepth - 2>();  // this thread's copies of stage st landed
    __syncthreads();              // everyone's; slot st - 1 is free
    issue(st + kDepth - 1);
    const float(*slot)[kTile] = ring[st % kDepth];
    if (st * kRows + kRows <= H) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc += slot[r][tid];
    } else {
      for (int r = 0; st * kRows + r < H; ++r) acc += slot[r][tid];
    }
  }
  if (n < N) out[rep * N + n] = acc;
}

template <bool BATCHED>
__global__ void __launch_bounds__(kTile)
reg_gather_kernel(const float* __restrict__ src, const int* __restrict__ s,
                  float* __restrict__ out, int S, int C, int H, int N) {
  __shared__ int s_sh[kClassChunk];
  size_t rep;
  int tile;
  place<BATCHED>(S, rep, tile);
  const int* sr = s + rep * H;
  const int n = tile * kTile + threadIdx.x;
  const bool bad = any_bad(sr, C, H);
  if (bad) {
    if (n < N) out[rep * N + n] = NAN;
    return;
  }
  // the classes pass through shared memory kClassChunk at a time, so any
  // H fits; threads past N keep to the barriers and load nothing
  const float* col = src + (n < N ? n : 0);
  float acc = 0.f;
  for (int h0 = 0; h0 < H; h0 += kClassChunk) {
    const int m = min(kClassChunk, H - h0);
    __syncthreads();
    for (int h = threadIdx.x; h < m; h += kTile) s_sh[h] = sr[h0 + h];
    __syncthreads();
    if (n >= N) continue;
    int h = 0;
    for (; h + kUnroll <= m; h += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = col[((size_t)s_sh[h + u] * H + h0 + h + u) * (size_t)N];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += v[u];
    }
    for (; h < m; ++h)
      acc += col[((size_t)s_sh[h] * H + h0 + h) * (size_t)N];
  }
  if (n < N) out[rep * N + n] = acc;
}

// aligned: the ring (16-byte copies), else the 4-byte register path
template <bool BATCHED>
int launch(const float* src, const int* s, float* out, int S, int C, int H,
           int N, int aligned, cudaStream_t stream) {
  const int grid = (N + kTile - 1) / kTile * S;
  if (aligned)
    ring_gather_kernel<BATCHED>
        <<<grid, kTile, 0, stream>>>(src, s, out, S, C, H, N);
  else
    reg_gather_kernel<BATCHED>
        <<<grid, kTile, 0, stream>>>(src, s, out, S, C, H, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src (C, H, N) fp32, s (H,) int32 -> out (N,); aligned != 0 takes the
// ring of 16-byte copies (N % 4 == 0 and src 16-byte aligned), else the
// 4-byte register path
int row_gather_launch(const float* src, const int* s, float* out, int C,
                      int H, int N, int aligned, void* stream) {
  return launch<false>(src, s, out, 1, C, H, N, aligned,
                       (cudaStream_t)stream);
}

// the replica axis: s (S, H) int32 -> out (S, N), 1 <= S <= 65535
int row_gather_batched_launch(const float* src, const int* s, float* out,
                              int S, int C, int H, int N, int aligned,
                              void* stream) {
  return launch<true>(src, s, out, S, C, H, N, aligned,
                      (cudaStream_t)stream);
}

}  // extern "C"
