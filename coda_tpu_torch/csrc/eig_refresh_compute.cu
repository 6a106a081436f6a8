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
// the rounded row, as kernel 2 does (csrc/eig_common.cuh).
//
// Bound on the card. eq is a 0/1 mask with about H/C ones per item, so the
// function needs 2*N*H*G FLOP for the base product and, over the nnz pairs
// (n, h) where eq is 1, nnz*G adds for S and 2*nnz*G for the diff product,
// plus about 8 per scored element (8*C*N*H): 3.3e10 FLOP at N=50,000,
// H=1000, G=256, C=10. This design runs the two products on the tensor
// cores in 3xTF32 (three TF32 products per product, 3*(2*N*H*G +
// 2*nnz*G) = 8.4e10 FLOP, >= 0.17 ms at 495 TFLOP/s) and S and the scoring
// on the fp32 CUDA cores (5.3e9 FLOP, >= 0.08 ms at 67 TFLOP/s). The bytes
// are ~2.2 GB with an fp32 cache (>= 0.66 ms at 3.35 TB/s) and ~1.2 GB
// with bf16 (>= 0.36 ms): bytes bind both. chip_smoke.py computes the
// bound from its own inputs.
//
// Design: two launches on the caller's stream.
//
// 1. refresh_compute_rows_kernel: a block of 256 threads owns kB = 64
//    items, so every table value it reads from L2 feeds 64 items (the
//    tables' L2 traffic is N/64 * 3 MB = 2.3 GB a call at the headline).
//    Shared memory holds w [64][G+4], eq of the tile as a bitmask
//    [64][H/32] and a ring of four 8.5 KB slots that cp.async fills two
//    stages ahead of the one consumed (one barrier a stage). Stages:
//      0. eq: a warp reads 32 models of 8 items at once, keeps the ballots;
//      1. S only where eq is 1, fp32 on the CUDA cores: a warp owns 8
//         items, a lane 8 grid points g = lane + 32k in registers; dlogcdf
//         arrives 8 rows a stage, and for each item the warp walks the set
//         bits of its mask (the same for every lane, so no divergence) in
//         ascending h with __ffs and adds the row. fmaf(0, d, acc) == acc
//         for the finite tables, so S is bitwise the dense in-order sum;
//         G > 256 takes more passes;
//      2. w = w_trapz * exp(S - max_g S), a warp per item;
//      then for each chunk of kHc = 128 models:
//      3. the base and diff products as one GEMM (64 items x 2 x 128
//         models x G) on the tensor cores: mma.sync m16n8k8 in 3xTF32
//         (each fp32 operand split into a TF32 high part and a TF32 rest;
//         hi*hi + hi*lo + lo*hi, fp32 sums), about 2^-20 relative, far
//         inside the row tolerance that single-pass TF32 fails. F_u^T and
//         dF^T arrive 8 grid points a stage (rows padded to 136 floats so
//         the fragments' shared loads meet no bank conflict); a warp owns
//         32 items x 32 models. The diff is dense: walking each set bit
//         with a warp dot product and reduction needs 10x fewer FLOP but
//         took more cycles than the dense SIMT product, and the dense
//         3xTF32 product takes fewer still (PERF.md, PR 4);
//      4. epilogue: base + diff where eq is 1, stored unnormalised to an
//         fp32 (N, H) scratch; each item's sum over h gathers in shared
//         memory in a fixed order (thread, its group of 4 by a butterfly,
//         the 4 warps of its rows, chunk), and after the last chunk
//         den = max(sum, 1e-30) goes to an (N,) scratch.
//    About 108 KB of shared memory at H=1000, G=256: two blocks (16
//    warps) an SM. The scratch keeps the row out of shared memory, so the
//    model count is bounded only by the mask (H <= 16,224 at G=256).
// 2. refresh_compute_score_kernel: kernel 2's scoring pass
//    (eig::score_warp, a warp scoring eig::kExactRows items class by
//    class; eig::score_block_approx, one row a warp, for the approx entropy):
//    row c is read from the scratch, divided by den, rounded to the
//    storage type, stored and scored as rounded; the C-1 other rows stream
//    from the cache. This stage is bound by bytes and runs at kernel 2's
//    occupancy.
//
// The scratch costs 0.4 GB of extra traffic (written once, read once). The
// block that computes or stores row c of item n is that row's only
// writer, so no two blocks race. c is read on the device (no host
// synchronisation); out of range gives NaN scores and writes nothing.
//
// Short item axes. At a few hundred items (the imagenet_sparse pool, C =
// 1000, N = 256, H = 500) launch 1 has N/64 = 4 blocks, each walking its
// model chunks in turn, and launch 2 N/32 = 8, each warp walking C classes
// in turn, on 132 SMs. Each launch then takes a second decomposition with
// the same bits (the wrapper, ops/eig_kernels.py, picks both):
// 1'. the row split: grid(item tiles, ceil(H / kHc)), where those blocks
//     fit one wave (ops/eig_kernels.choose_row_split). Each block repeats
//     stages 0-2 for its tile (the same code on the same inputs, so w is
//     bitwise the same), runs stages 3-4 for its one chunk, and writes its
//     items' chunk sums to an fp32 scratch part (chunks, N);
//     row_den_kernel adds them in ascending chunk order from 0 and clamps,
//     the single launch's rowsum order, so den is bitwise the same;
// 2'. the class split of kernels 1 and 2 (csrc/eig_common.cuh,
//     class_chunk_kernel with FRESH = 2, then class_mix_kernel): the chunk
//     holding c divides, rounds, stores and scores row c as launch 2 does.
// Built with -DK6_STAGES, thread 0 of each block of launch 1 adds the
// clock64() cycles of each stage, and apart those spent waiting for the
// ring's copies (scripts/torch_k6_stages.py prints them).

#include "eig_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 64;                 // items per block (launch 1)
constexpr int kItemsPerWarp = kB / kWarps;
constexpr int kHc = 128;               // models per chunk of the products
constexpr int kKc = 8;                 // grid points per GEMM stage
constexpr int kGb = 256;               // grid points per pass of S
constexpr int kDepth = 4;              // slots of the cp.async ring
constexpr int kAhead = 2;              // stages in flight beyond the one used
constexpr int kSR = 8;                 // dlogcdf rows per stage of S
constexpr int kBS = kHc + 8;           // row stride of a staged table tile
constexpr int kSlot = 2 * kKc * kBS;   // floats per slot
static_assert(kSR * kGb <= kSlot, "an S stage fits a slot");
static_assert(kAhead + 2 <= kDepth, "one barrier a stage needs two spare");

#ifdef K6_STAGES
// stages 0-4, then (5) the cycles of stages 1 and 3 spent waiting for the
// ring's copies to land and for the block's barrier after them
constexpr int kStages = 6, kStampBlocks = 1 << 14;
__device__ long long k6_cycles[kStampBlocks * kStages];
#define K6_MARK(k)                            \
  do {                                        \
    if (threadIdx.x == 0) {                   \
      const long long t_ = clock64();         \
      k6_acc[k] += t_ - k6_t;                 \
      k6_t = t_;                              \
    }                                         \
  } while (0)
#else
#define K6_MARK(k) \
  do {             \
  } while (0)
#endif

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// grid points padded to the GEMM stage, and w's row stride: +4 floats puts
// the two item groups a warp reads on different banks
__host__ __device__ inline int padded_points(int G) { return round_up(G, kKc); }
__host__ __device__ inline int w_stride(int G) { return padded_points(G) + 4; }

// shared memory of launch 1: w [kB][Gs], mask [kB][H/32], ring
// [kDepth][kSlot], rowsum [kB], the row sums of a chunk per warp column
// [4][kB]
__host__ __device__ inline size_t smem_bytes(int H, int G) {
  return sizeof(float) * ((size_t)kB * w_stride(G) +
                          (size_t)kB * ((H + 31) / 32) + kDepth * kSlot +
                          5 * kB);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until the oldest of the kAhead + 1 groups in flight has landed
__device__ __forceinline__ void cp_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
}

// Start copying the tile [r0, r0 + R) x [c0, c0 + W) of a row-major matrix
// (nrows x ncols, leading dimension ld) into dst [R][DLD]; elements outside
// the matrix are zero-filled. vec16: ld and c0 are multiples of 4 and src
// is 16-byte aligned, so four columns go in one 16-byte copy.
template <int R, int W, int DLD = W>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int ld, int r0, int nrows, int c0,
                                           int ncols, bool vec16) {
  static_assert(W % 4 == 0 && DLD % 4 == 0, "16-byte rows");
  if (vec16) {
    for (int e = threadIdx.x; e < R * W / 4; e += kThreads) {
      const int r = e / (W / 4), q = e % (W / 4) * 4;
      const bool ok = r0 + r < nrows && c0 + q < ncols;
      cp_async16(dst + r * DLD + q,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + q : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += kThreads) {
      const int r = e / W, q = e % W;
      const bool ok = r0 + r < nrows && c0 + q < ncols;
      cp_async4(dst + r * DLD + q,
                ok ? src + (size_t)(r0 + r) * ld + c0 + q : src, ok);
    }
  }
}

// x as a TF32 pair: hi = x cut to TF32's 10 mantissa bits, lo = the rest
// (x - hi is exact in fp32) cut likewise, so hi + lo carries x to about
// 2^-20 relative (three integer/float operations, no conversion
// instruction)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  constexpr unsigned kTf32 = 0xffffe000u;
  hi = __float_as_uint(x) & kTf32;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;
}

// d += a * b for one 16 x 8 x 8 TF32 tile on the tensor cores, fp32 sums
// (not volatile: the compiler may interleave independent tiles)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}



// Runs n stages through the ring: load(s, slot) starts the copies of stage
// s, use(s, slot) consumes it once it has landed, with kAhead stages in
// flight meanwhile. The slot refilled at stage s was last read at stage
// s - 2, and every thread has since passed stage s - 1's barrier, so one
// barrier a stage suffices; one more at the end frees the ring.
template <class Load, class Use>
__device__ __forceinline__ void pipeline(float* ring, int n, Load load,
                                         Use use, long long* waited) {
  for (int s = 0; s < kAhead; ++s) {
    if (s < n) load(s, ring + s * kSlot);
    cp_commit();
  }
  for (int s = 0; s < n; ++s) {
    const int next = s + kAhead;
    if (next < n) load(next, ring + (next % kDepth) * kSlot);
    cp_commit();
#ifdef K6_STAGES
    const long long t0 = clock64();
#endif
    cp_wait_oldest();
    __syncthreads();
#ifdef K6_STAGES
    if (threadIdx.x == 0) *waited += clock64() - t0;
#endif
    use(s, ring + (s % kDepth) * kSlot);
  }
  __syncthreads();
}

// SPLIT (the row split): block (blockIdx.x, blockIdx.y) runs stages 0-2 for
// its item tile as the single launch does, then stages 3-4 for the one
// model chunk blockIdx.y, and writes its items' sums over that chunk to
// part (chunks, N) instead of den (row_den_kernel adds them)
template <bool SPLIT>
__global__ void __launch_bounds__(kThreads, 2)
refresh_compute_rows_kernel(const int* __restrict__ hard_preds,
                            const int* __restrict__ c_ptr,
                            const float* __restrict__ s0,
                            const float* __restrict__ dlog,
                            const float* __restrict__ fu_t,
                            const float* __restrict__ df_t,
                            const float* __restrict__ w_trapz,
                            float* __restrict__ u, float* __restrict__ den,
                            float* __restrict__ part, int C, int N, int H,
                            int G, int vecG, int vecH) {
  extern __shared__ __align__(16) float smem[];
  const int Gp = padded_points(G), Gs = w_stride(G), Hw = (H + 31) / 32;
  float* w = smem;                                        // [kB][Gs]
  unsigned* mask = reinterpret_cast<unsigned*>(w + kB * Gs);  // [kB][Hw]
  float* ring = reinterpret_cast<float*>(mask + kB * Hw);  // [kDepth][kSlot]
  float* rowsum = ring + kDepth * kSlot;                  // [kB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kB;
  const int nb = min(kB, N - n0);
  const int b0 = warp * kItemsPerWarp;  // the warp's items in stages 0-2
  const int c = *c_ptr;
  if ((unsigned)c >= (unsigned)C) return;  // launch 2 writes the NaNs
#ifdef K6_STAGES
  long long k6_acc[kStages] = {0, 0, 0, 0, 0, 0};
  long long k6_t = clock64();
  long long* waited = &k6_acc[5];
#else
  long long* waited = nullptr;
#endif

  // 0. eq of the warp's items as a bitmask (items past N take no bits);
  //    32 loads in flight a lane (c >= 0, so -1 never matches)
  for (int j0 = 0; j0 < Hw; j0 += 4) {
    int v[kItemsPerWarp][4];
#pragma unroll
    for (int i = 0; i < kItemsPerWarp; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = (j0 + q) * 32 + lane;
        v[i][q] = b0 + i < nb && h < H
                      ? hard_preds[(size_t)(n0 + b0 + i) * H + h]
                      : -1;
      }
#pragma unroll
    for (int i = 0; i < kItemsPerWarp; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned m = __ballot_sync(0xffffffffu, v[i][q] == c);
        if (lane == 0 && j0 + q < Hw) mask[(b0 + i) * Hw + j0 + q] = m;
      }
  }
  if (tid < kB) rowsum[tid] = 0.f;
  __syncthreads();
  K6_MARK(0);

  // 1. S[b][g] = S0[g] + sum of dlogcdf[h][g] over the set bits h of item
  //    b, h ascending; a lane holds g = g0 + lane + 32k of the warp's items
  for (int g0 = 0; g0 < G; g0 += kGb) {
    float acc[kItemsPerWarp][kGb / 32];
#pragma unroll
    for (int i = 0; i < kItemsPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < kGb / 32; ++k) acc[i][k] = 0.f;
    pipeline(
        ring, (H + kSR - 1) / kSR,
        [&](int s, float* slot) {
          stage_tile<kSR, kGb>(slot, dlog, G, s * kSR, H, g0, G, vecG);
        },
        [&](int s, const float* slot) {
          const int h = s * kSR;
          const float* t = slot + lane;
#pragma unroll
          for (int i = 0; i < kItemsPerWarp; ++i) {
            unsigned bits = (mask[(b0 + i) * Hw + (h >> 5)] >> (h & 31)) &
                            ((1u << kSR) - 1u);
            while (bits) {
              const float* tr = t + (__ffs(bits) - 1) * kGb;
              bits &= bits - 1;
#pragma unroll
              for (int k = 0; k < kGb / 32; ++k) acc[i][k] += tr[32 * k];
            }
          }
        },
        waited);
#pragma unroll
    for (int i = 0; i < kItemsPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < kGb / 32; ++k) {
        const int g = g0 + lane + 32 * k;
        if (g < G) w[(b0 + i) * Gs + g] = s0[g] + acc[i][k];
      }
  }
  K6_MARK(1);

  // 2. w = w_trapz * exp(S - max_g S), each lane on the points it wrote;
  //    zero past G for the padded products
  for (int i = 0; i < kItemsPerWarp; ++i) {
    float* wb = w + (b0 + i) * Gs;
    float m = -INFINITY;
    for (int g = lane; g < G; g += 32) m = fmaxf(m, wb[g]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int g = lane; g < Gp; g += 32)
      wb[g] = g < G ? w_trapz[g] * expf(wb[g] - m) : 0.f;
  }
  __syncthreads();
  K6_MARK(2);

  // tensor-core fragments of m16n8k8: a warp owns items wm*32 .. + 32 (two
  // 16-row tiles) and models wn*32 .. + 32 of each chunk (four 8-column
  // tiles); gid and tig are the lane's group and place in it
  const int wm = warp & 1, wn = warp >> 1, gid = lane >> 2, tig = lane & 3;
  float* psum = rowsum + kB;  // [4][kB]: a chunk's row sums by wn
  const int h_first = SPLIT ? blockIdx.y * kHc : 0;
  const int h_last = SPLIT ? min(H, h_first + kHc) : H;
  for (int h0 = h_first; h0 < h_last; h0 += kHc) {
    // 3. base[b][h] = sum_g w[b][g] * F_u^T[g][h] and diff[b][h] = sum_g
    //    w[b][g] * dF^T[g][h] in 3xTF32 on the tensor cores, fp32 sums; a
    //    stage holds 8 grid points of both tables
    float base[2][4][4], diff[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) base[mi][ni][q] = diff[mi][ni][q] = 0.f;
    pipeline(
        ring, Gp / kKc,
        [&](int s, float* slot) {
          stage_tile<kKc, kHc, kBS>(slot, fu_t, H, s * kKc, G, h0, H, vecH);
          stage_tile<kKc, kHc, kBS>(slot + kKc * kBS, df_t, H, s * kKc, G, h0,
                                    H, vecH);
        },
        [&](int s, const float* slot) {
          unsigned ah[2][4], al[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const float* wa =
                w + (wm * 32 + mi * 16 + gid) * Gs + s * kKc + tig;
            split_tf32(wa[0], ah[mi][0], al[mi][0]);
            split_tf32(wa[8 * Gs], ah[mi][1], al[mi][1]);
            split_tf32(wa[4], ah[mi][2], al[mi][2]);
            split_tf32(wa[8 * Gs + 4], ah[mi][3], al[mi][3]);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            // 3xTF32: a*b ~ al*bh + ah*bl + ah*bh (al*bl, about 2^-20 of
            // a*b, dropped), the small terms first; each pass over the
            // four independent tiles (2 items x base, diff) before the next
            const float* bt = slot + tig * kBS + wn * 32 + ni * 8 + gid;
            unsigned bh[2][2], bl[2][2];  // [base, diff][k, k + 4]
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              split_tf32(bt[p * kKc * kBS], bh[p][0], bl[p][0]);
              split_tf32(bt[p * kKc * kBS + 4 * kBS], bh[p][1], bl[p][1]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(base[mi][ni], al[mi], bh[0]);
              mma_tf32(diff[mi][ni], al[mi], bh[1]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(base[mi][ni], ah[mi], bl[0]);
              mma_tf32(diff[mi][ni], ah[mi], bl[1]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(base[mi][ni], ah[mi], bh[0]);
              mma_tf32(diff[mi][ni], ah[mi], bh[1]);
            }
          }
        },
        waited);
    K6_MARK(3);

    // 4. row = base + diff where eq is 1, stored unnormalised to the
    //    scratch. Per-item sums in a fixed order: the thread's 8 models,
    //    the 4 threads of its group by a butterfly, the 4 warps of the
    //    item's rows, then chunk by chunk
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int b = wm * 32 + mi * 16 + hf * 8 + gid;
        float* ub = u + (size_t)(n0 + min(b, nb - 1)) * H;
        float part = 0.f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int h = h0 + wn * 32 + ni * 8 + tig * 2 + e;
            if (b < nb && h < H) {
              const bool eq = (mask[b * Hw + (h >> 5)] >> (h & 31)) & 1u;
              const float bv = base[mi][ni][hf * 2 + e];
              const float v = eq ? bv + diff[mi][ni][hf * 2 + e] : bv;
              ub[h] = v;
              part += v;
            }
          }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (tig == 0) psum[wn * kB + b] = part;
      }
    __syncthreads();
    if (tid < kB)
      rowsum[tid] += ((psum[tid] + psum[kB + tid]) + psum[2 * kB + tid]) +
                     psum[3 * kB + tid];
#ifdef K6_STAGES
    __syncthreads();  // stage boundaries for the stamps only
#endif
    K6_MARK(4);
  }
  __syncthreads();
  if (tid < nb) {
    if (SPLIT)
      part[(size_t)blockIdx.y * N + n0 + tid] = rowsum[tid];
    else
      den[n0 + tid] = fmaxf(rowsum[tid], 1e-30f);
  }
#ifdef K6_STAGES
  const int stamp = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0 && stamp < kStampBlocks)
    for (int k = 0; k < kStages; ++k)
      k6_cycles[stamp * kStages + k] = k6_acc[k];
#endif
}

// The row split's sums: den[n] = max(sum of part[k, n] over the chunks k in
// ascending order from 0, 1e-30), the single launch's rowsum order, so den
// is bitwise the single launch's
__global__ void row_den_kernel(const float* __restrict__ part,
                               float* __restrict__ den, int chunks, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += part[(size_t)k * N + n];
  den[n] = fmaxf(s, 1e-30f);
}

// Launch 2: kernel 2's scoring pass (eig::score_warp, or
// eig::score_block_approx for the approx entropy) with class row c read
// from the scratch u, divided by den[n], rounded to T, stored into the
// cache and scored as rounded (FRESH = 2)
static_assert(kWarps == eig::kScoreWarps, "launch 2 is a scoring block");
template <typename T, int VEC, bool APPROX>
__global__ void __launch_bounds__(kThreads)
refresh_compute_score_kernel(const float* __restrict__ rows, T* hyp,
                             const float* __restrict__ u,
                             const float* __restrict__ den,
                             const int* __restrict__ c_ptr,
                             const float* __restrict__ pi,
                             const float* __restrict__ pi_xi,
                             const float* __restrict__ mixture0,
                             const float* __restrict__ h_before,
                             float* __restrict__ out, int C, int N, int H) {
  extern __shared__ float h_after[];  // the approx pass: [kWarps][C]
  if constexpr (APPROX) {
    eig::score_block_approx<T, VEC, 2>(rows, hyp, hyp, u, den, *c_ptr, pi,
                                       pi_xi, mixture0, h_before, out, C, N,
                                       H, 0, h_after);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * kWarps + warp) * eig::kExactRows;
    eig::score_warp<T, VEC, 2>(rows, hyp, hyp, u, den, *c_ptr, pi, pi_xi,
                               mixture0, h_before[0], out, C, N, H, 0, n0,
                               lane);
  }
}

int rows_attribute(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      refresh_compute_rows_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(refresh_compute_rows_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  return (int)err;
}

template <typename T, bool APPROX>
int score_t(const float* rows, void* hyp, const float* u, const float* den,
            const int* c, const float* pi, const float* pi_xi,
            const float* mixture0, const float* h_before, float* out, int C,
            int N, int H, int vec, cudaStream_t stream) {
  constexpr int kVec = sizeof(T) == 2 ? 8 : 4;
  constexpr int kSItems = eig::score_items<APPROX>();  // items a block
  const int grid = (N + kSItems - 1) / kSItems;
  const size_t smem = APPROX ? sizeof(float) * kWarps * C : 0;
  T* h = static_cast<T*>(hyp);
  if (vec > 1)
    refresh_compute_score_kernel<T, kVec, APPROX>
        <<<grid, kThreads, smem, stream>>>(rows, h, u, den, c, pi, pi_xi,
                                           mixture0, h_before, out, C, N, H);
  else
    refresh_compute_score_kernel<T, 1, APPROX>
        <<<grid, kThreads, smem, stream>>>(rows, h, u, den, c, pi, pi_xi,
                                           mixture0, h_before, out, C, N, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The layout of launch 1 at (C, H, G), into out[6]: items per block,
// models per chunk, grid points per GEMM stage, dynamic shared memory per
// block in bytes, resident blocks per SM on the current device (0 when the
// block does not fit), and the largest H whose block fits the device's
// opt-in shared memory at this G. Returns a cudaError.
int eig_refresh_compute_layout(int C, int H, int G, long long* out) {
  (void)C;
  const size_t smem = smem_bytes(H, G);
  out[0] = kB;
  out[1] = kHc;
  out[2] = kKc;
  out[3] = (long long)smem;
  int dev = 0, optin = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const long long fixed = (long long)smem_bytes(0, G);
  out[5] = optin > fixed
               ? (optin - fixed) / (long long)(sizeof(float) * kB) * 32
               : 0;
  out[4] = 0;
  if ((long long)smem <= optin) {
    err = (cudaError_t)rows_attribute(smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, refresh_compute_rows_kernel<false>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    out[4] = blocks;
  }
  return 0;
}

#ifdef K6_STAGES
// Cycles of launch 1 of the last call per block and stage (6 a block:
// stages 0-4 and the ring's waits), for the first n / 6 blocks.
int eig_refresh_compute_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k6_cycles, sizeof(long long) * n);
}
#endif

// hyp: (C, N, H) fp32 or, with bf16 != 0, bf16, written in row *c;
// hard_preds (N, H) int32; s0 (G,), dlog (H, G), fu_t and df_t (G, H),
// w_trapz (G,) fp32; u (N, H) and den (N,) fp32 scratch the caller
// allocates. vec > 1 takes 16-byte loads in the scoring pass.
// row_split != 0 launches the row kernel over grid(item tiles,
// ceil(H / kHc)), one model chunk a block, through part, an (ceil(H / kHc),
// N) fp32 scratch; chunks (1 <= chunks <= min(C, 65535)) > 1 splits the
// scoring launch over that many class chunks through ent, an (N, C) fp32
// scratch. part and ent may be null where they are not used. Every path
// gives the same bits.
int eig_refresh_compute_launch(
    const float* rows, void* hyp, const int* hard_preds, const int* c,
    const float* s0, const float* dlog, const float* fu_t, const float* df_t,
    const float* w_trapz, const float* pi, const float* pi_xi,
    const float* mixture0, const float* h_before, float* u, float* den,
    float* part, float* ent, float* out, int C, int N, int H, int G, int vec,
    int bf16, int approx, int chunks, int row_split, void* stream) {
  if (G < 2 || chunks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(H, G);
  int err = rows_attribute(smem);
  if (err != 0) return err;
  auto aligned = [](const void* p) { return (size_t)p % 16 == 0; };
  const int vecG = G % 4 == 0 && aligned(dlog);
  const int vecH = H % 4 == 0 && aligned(fu_t) && aligned(df_t);
  const int tiles = (N + kB - 1) / kB;
  if (row_split) {
    const int hc = (H + kHc - 1) / kHc;
    refresh_compute_rows_kernel<true>
        <<<dim3(tiles, hc), kThreads, smem, st>>>(
        hard_preds, c, s0, dlog, fu_t, df_t, w_trapz, u, den, part, C, N, H,
        G, vecG, vecH);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    row_den_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
        part, den, hc, N);
  } else {
    refresh_compute_rows_kernel<false><<<tiles, kThreads, smem, st>>>(
        hard_preds, c, s0, dlog, fu_t, df_t, w_trapz, u, den, part, C, N, H,
        G, vecG, vecH);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (chunks > 1)
    return eig::launch_split<2, false>(rows, hyp, u, den, c, pi, pi_xi,
                                       mixture0, h_before, out, ent, 1, C, N,
                                       H, vec, bf16, approx, chunks, st);
#define EIG_SCORE(T, A)                                                       \
  return score_t<T, A>(rows, hyp, u, den, c, pi, pi_xi, mixture0, h_before, \
                       out, C, N, H, vec, st)
  if (bf16) {
    if (approx) EIG_SCORE(__nv_bfloat16, true);
    EIG_SCORE(__nv_bfloat16, false);
  }
  if (approx) EIG_SCORE(float, true);
  EIG_SCORE(float, false);
#undef EIG_SCORE
}

}  // extern "C"
