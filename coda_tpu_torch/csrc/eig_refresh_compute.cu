// Fused refresh-compute-score kernel for Hopper (sm_90a).
//
// Replaces coda_tpu/ops/pallas_eig.py:_refresh_compute_score_kernel
// (kernel 6, every round under eig_refresh='fused'). For the labelled
// class c it computes the hypothetical-P(best) row of every item n from
// the O(H*G) Beta grid tables, with eq = (hard_preds[n, :] == c):
//   S[g]   = S0[g] + sum_h eq[h] * dlogcdf[h, g]
//   S     -= max_g S
//   w[g]   = w_trapz[g] * exp(S[g])
//   row[h] = sum_g w[g] * F_u[h, g] + eq[h] * sum_g w[g] * dF[h, g]
//   row   /= max(sum_h row, 1e-30)
// rounds the row to the cache's storage type (fp32 or bf16, round to
// nearest even), stores it into cache[c, n, :] and scores the item with
// the rounded row and the C - 1 cached rows, as kernel 2 does
// (csrc/eig_common.cuh).
//
// Bound on the card. The function reads the cache once and writes row c
// (C*N*H elements), reads the hard predictions (N*H int32) and the class
// mixture weights: ~2.2 GB with an fp32 cache (>= 0.66 ms at 3.35 TB/s) and
// ~1.2 GB with bf16 (>= 0.36 ms) at (C, N, H) = (10, 50,000, 1000), G =
// 256. Its operations: 2*N*H*G for the base product and, over the nnz pairs
// (n, h) where eq is 1, nnz*G adds for S and 2*nnz*G for the diff product,
// plus about 8 per scored element: 3.3e10 FLOP, the bound chip_smoke.py
// computes from its own inputs. This design executes more: both products
// densely in 3xTF32, 3 * 4*N*H*G = 1.54e11 TF32 operations (>= 0.31 ms at
// 495 TFLOP/s), beside S and the scoring on the fp32 CUDA cores (5.3e9
// FLOP, >= 0.08 ms at 67 TFLOP/s). Bytes bind the function; the executed
// products are the next floor.
//
// Design: four launches on the caller's stream (PERF.md section 6 has the
// measurements behind each choice).
//
// 0. split_tables_kernel: F_u and dF (H, G), as refresh_tables returns
//    them (K-major for the products), become four (H, Gp) planes, Gp = G
//    rounded up to the 8-point k step and zero past G: the TF32 high parts
//    of F_u and dF, then their TF32 rests. Each value is split once a call
//    (4 MB at the headline) instead of in every block and k step.
// 1. refresh_s_kernel: eq, S and w, two 64-item blocks an SM (16 warps):
//    eq of the block's items as a bitmask (to shared memory and to an (N,
//    ceil(H/32) rounded to 4) scratch for launch 2); S only where eq is 1,
//    fp32 on the CUDA cores, a lane holding 8 grid points of its warp's 8
//    items in registers while dlogcdf arrives 32 rows a stage through a
//    cp.async ring and the warp walks the set bits of two items at once,
//    each item's in ascending h (fmaf(0, d, acc) == acc for the finite
//    tables, so S is bitwise the dense in-order sum; G > 256 takes more
//    passes); then w = w_trapz * exp(S - max_g S) to an (N, Gp) scratch.
//    The walk is a chain of dependent loads and adds, so it wants many
//    warps an SM: in the row launch's block, beside the products, it had 8
//    and took 0.59 of the block's cycles.
// 2. refresh_compute_rows_kernel, persistent (one block an SM at G = 256),
//    a block of one or two consumer warpgroups (64 items each: wgmma's M)
//    and one producer warp: two (128 items a tile) where the launch's work
//    items at 64-item tiles would not fit one round of the card, and where
//    two warpgroups' w and mask leave room for two ring stages (H up to
//    about 4,100 at G = 256); else one (ops/eig_kernels.row_plan). Per
//    tile: the tile's w [items][Gp + 4] fp32 and eq mask arrive by cp.async;
//    then for each chunk of 128 models (wgmma's N):
//      products: the producer's lane 0 keeps TMA loads of the planes in
//      flight into a ring of mbarrier-guarded stages (one stage: 8 grid
//      points of the hi and lo planes of both tables, 128 models each, 16
//      KB, 32-byte swizzle, four stages at the headline), which both
//      warpgroups read; each warpgroup runs wgmma.mma_async m64n128k8
//      .tf32 with A (w) from registers and B from the stage: lo(w)*hi(B),
//      hi(w)*lo(B), hi(w)*hi(B), base and diff each, the small terms first,
//      fp32 sums in ascending k (3xTF32, about 2^-20 relative, far inside
//      the row tolerance that single-pass TF32 fails). A's hi and lo parts
//      are cut from w in registers (four values a thread a k step): w
//      split in shared memory would take 256 KB a tile. A warpgroup issues
//      the products of kBatch stages together and waits for them before it
//      cuts the next A (the compiler may reuse an A register once the
//      instruction that reads it has issued); the slots are freed then.
//      Two warpgroups a block halve the planes' L2 traffic (1.6 GB a call
//      at the headline, against 3.3 GB with one).
//      epilogue: base + diff where eq is 1, stored unnormalised to an fp32
//      (N, H) scratch; each item's chunk sum over the thread's 32 models in
//      order, then its quad by a butterfly; chunk sums added in ascending
//      chunk order from 0, and den = max(sum, 1e-30) to an (N,) scratch.
//    Shared memory: the ring (two stages at least), w and the mask, so H
//    reaches 16,384 at G = 256 (one warpgroup, two stages).
// 3. scoring (kernel 2's pass, eig::score_warp / eig::score_block_approx,
//    or the class split's class_chunk_kernel / class_mix_kernel): row c is
//    read from the scratch, divided by den, rounded to the storage type,
//    stored and scored as rounded. Scoring the C - 1 cached classes (which
//    need nothing of the row launch) on a second stream beside launch 2
//    gave the same bits but measured slower (PERF.md section 6), so
//    the scoring follows the row launch on the caller's stream.
//
// The scratch costs 0.4 GB of extra traffic (written once, read once), w
// and the mask 0.06 GB. The block that computes or stores row c of item n
// is that row's only writer, so no two blocks race. c is read on the
// device (no host synchronisation); out of range gives NaN scores and
// writes nothing.
//
// Short item axes. Where the persistent grid finishes the tiles' model
// chunks in fewer rounds taken apart (the imagenet_sparse pool, C = 1000,
// N = 256, H = 500: 4 tiles on 132 SMs; C = 10, H = 1000 up to N =
// 12,000), launch 2 takes the row split (ops/eig_kernels.choose_row_split):
// a (tile, chunk) pair a work item, writing its chunk sums to an fp32
// scratch part (chunks, N); row_den_kernel adds them in ascending chunk
// order from 0 and clamps, the single launch's order, so den is bitwise the
// same. The scoring takes the class split at short item axes
// (csrc/eig_common.cuh). Every decomposition gives the same bits.
// Built with -DK6_STAGES, thread 0 of each row block adds the clock64()
// cycles of each stage of launch 2, those spent waiting for full stages,
// and the producer's waits for a free slot (scripts/torch_k6_stages.py
// prints them).

#include <cuda.h>

#include <algorithm>
#include <mutex>  // std::call_once
#include <type_traits>

#include "eig_common.cuh"

namespace {

// A row block is NWG consumer warpgroups (1 or 2), each owning kB items,
// and one producer warp; the warpgroups share every stage of B.
template <int NWG>
__host__ __device__ constexpr int threads_of() { return 128 * NWG + 32; }
constexpr int kB = 64;                 // items per warpgroup: wgmma's M
constexpr int kHc = 128;               // models per chunk: wgmma's N
constexpr int kKc = 8;                 // grid points per stage: wgmma's K
constexpr int kBatch = 2;              // stages a consumer issues at once
// S's ring: 32 dlogcdf rows (one mask word) of a 256-point pass a stage,
// three slots, one stage in flight beyond the one used: of 8, 16 and 32
// rows a stage, 128- and 256-point passes and three to eight slots, the
// fastest on the H100
constexpr int kGb = 256;               // grid points per pass of S
constexpr int kSR = 32;                // dlogcdf rows per stage of S
constexpr int kSDepth = 3;             // slots of S's cp.async ring
constexpr int kSAhead = kSDepth - 2;   // S stages in flight beyond the one used
// a stage's bits of a mask word
constexpr unsigned kSBits = kSR == 32 ? ~0u : (1u << kSR) - 1u;
constexpr int kSSlot = kSR * kGb;      // floats per slot of S's ring
// a stage of the products: [hi, lo] x [F_u, dF] x 128 models x 8 points
constexpr int kPlaneBytes = kHc * kKc * 4;          // 4 KB
constexpr int kStageBytes = 4 * kPlaneBytes;        // 16 KB
// ring stages wanted (fewer where H leaves no room, kMinStages at least)
constexpr int kMinStages = 2, kRingStages = 4;
static_assert(kSAhead + 2 <= kSDepth, "one barrier a stage needs two spare");

#ifdef K6_STAGES
// the row launch's (0) tile loads, (1) products, (2) epilogue, (3) the
// consumers' waits for full stages, (4) the producer's waits for free
// slots, (5) the block's work items
constexpr int kStamps = 6, kStampBlocks = 1 << 14;
__device__ long long k6_cycles[kStampBlocks * kStamps];
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

// grid points padded to the k step, and w's row stride: +4 floats puts
// the 8 rows of an A fragment's load on different banks
__host__ __device__ inline int padded_points(int G) { return round_up(G, kKc); }
__host__ __device__ inline int w_stride(int G) { return padded_points(G) + 4; }

// the eq mask's row stride: H/32 words rounded up to 16 bytes, so the row
// launch copies it 16 bytes at a time
__host__ __device__ inline int mask_stride(int H) {
  return round_up((H + 31) / 32, 4);
}

// shared memory of the row launch with `stages` ring stages and nwg
// consumer warpgroups: 1 KB to align the ring, the ring, w [nwg * kB][Gs],
// mask [nwg * kB][mask_stride(H)], two mbarriers a stage
__host__ __device__ inline size_t smem_bytes(int H, int G, int stages,
                                             int nwg) {
  return 1024 + (size_t)stages * kStageBytes +
         sizeof(float) * (size_t)nwg * kB *
             ((size_t)w_stride(G) + (size_t)mask_stride(H)) +
         16 * (size_t)stages;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until the oldest of the kSAhead + 1 groups in flight has landed
__device__ __forceinline__ void cp_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kSAhead) : "memory");
}

// -- mbarriers, TMA and wgmma -------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed; a
// wait past 2^35 cycles (tens of seconds) is a fault of the protocol and
// traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  } while (!done);
}

// the box {8 points, 128 models, 2 planes} at (k, h0, plane) of the planes'
// tensor map into dst, completing on bar
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int k, int h0, int plane,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(k), "r"(h0),
      "r"(plane), "r"(bar)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile of 32-byte rows (8
// tf32 values) in the 32-byte swizzle, 8-row groups 256 bytes apart
__device__ __forceinline__ unsigned long long desc_sw32(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((unsigned long long)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, fp32) += a (64 x 8, tf32, registers) * b (8 x 128, tf32,
// shared memory at desc): wgmma.mma_async m64n128k8. A's fragment of a
// thread: (row, k) = (gid, tig), (gid + 8, tig), (gid, tig + 4), (gid + 8,
// tig + 4) of its warp's 16 rows; d[4j + q]: row gid + 8 (q >> 1), column
// 8j + 2 tig + (q & 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// x as a TF32 pair: hi = x cut to TF32's 10 mantissa bits, lo = the rest
// (x - hi is exact in fp32) cut likewise, so hi + lo carries x to about
// 2^-20 relative (no conversion instruction)
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  constexpr unsigned kTf32 = 0xffffe000u;
  hi = __uint_as_float(__float_as_uint(x) & kTf32);
  lo = __uint_as_float(__float_as_uint(x - hi) & kTf32);
}

// -- launch 0: the tables' TF32 planes ------------------------------------

// planes (4, H, Gp): hi(F_u), hi(dF), lo(F_u), lo(dF), zero past G
__global__ void split_tables_kernel(const float* __restrict__ fu,
                                    const float* __restrict__ df,
                                    float* __restrict__ planes, int H, int G,
                                    int Gp) {
  const size_t n = (size_t)H * Gp;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int h = (int)(i / Gp), g = (int)(i % Gp);
    const bool in = g < G;
    float fh, fl, dh, dl;
    split_tf32(in ? fu[(size_t)h * G + g] : 0.f, fh, fl);
    split_tf32(in ? df[(size_t)h * G + g] : 0.f, dh, dl);
    planes[i] = fh;
    planes[n + i] = dh;
    planes[2 * n + i] = fl;
    planes[3 * n + i] = dl;
  }
}

// -- S's ring ---------------------------------------------------------------

// Start copying the tile [r0, r0 + R) x [c0, c0 + W) of a row-major matrix
// (nrows x ncols, leading dimension ld) into dst [R][W]; elements outside
// the matrix are zero-filled. vec16: ld and c0 are multiples of 4 and src
// is 16-byte aligned, so four columns go in one 16-byte copy.
template <int R, int W, int kThreads>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           int ld, int r0, int nrows, int c0,
                                           int ncols, bool vec16) {
  static_assert(W % 4 == 0, "16-byte rows");
  if (vec16) {
    for (int e = threadIdx.x; e < R * W / 4; e += kThreads) {
      const int r = e / (W / 4), q = e % (W / 4) * 4;
      const bool ok = r0 + r < nrows && c0 + q < ncols;
      cp_async16(dst + r * W + q,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + q : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += kThreads) {
      const int r = e / W, q = e % W;
      const bool ok = r0 + r < nrows && c0 + q < ncols;
      cp_async4(dst + r * W + q,
                ok ? src + (size_t)(r0 + r) * ld + c0 + q : src, ok);
    }
  }
}

// Runs n stages of S through its ring: load(s, slot) starts the copies of
// stage s, use(s, slot) consumes it once it has landed, with kSAhead stages
// in flight meanwhile. The slot refilled at stage s was last read at stage
// s - 2, and every thread has since passed stage s - 1's barrier, so one
// barrier a stage suffices; one more at the end frees the ring.
template <class Load, class Use>
__device__ __forceinline__ void pipeline(float* ring, int n, Load load,
                                         Use use, long long* waited) {
  for (int s = 0; s < kSAhead; ++s) {
    if (s < n) load(s, ring + s * kSSlot);
    cp_commit();
  }
  for (int s = 0; s < n; ++s) {
    const int next = s + kSAhead;
    if (next < n) load(next, ring + (next % kSDepth) * kSSlot);
    cp_commit();
#ifdef K6_STAGES
    const long long t0 = clock64();
#endif
    cp_wait_oldest();
    __syncthreads();
#ifdef K6_STAGES
    if (threadIdx.x == 0 && waited) *waited += clock64() - t0;
#endif
    use(s, ring + (s % kSDepth) * kSSlot);
  }
  __syncthreads();
}

// A lane's 8 grid points of S's pass: g0 + 4 lane + j and g0 + 128 + 4 lane
// + j (j < 4)
__device__ __forceinline__ int s_point(int lane, int k) {
  return (k >> 2) * (kGb / 2) + 4 * lane + (k & 3);
}

// acc[k] += the lane's 8 values of dlogcdf row r of the staged slot (t =
// slot + 4 lane): two 16-byte loads
__device__ __forceinline__ void add_row(float (&acc)[kGb / 32],
                                        const float* t, int r) {
  const float4* tr = reinterpret_cast<const float4*>(t + r * kGb);
  const float4 a = tr[0], b = tr[kGb / 8];
  acc[0] += a.x, acc[1] += a.y, acc[2] += a.z, acc[3] += a.w;
  acc[4] += b.x, acc[5] += b.y, acc[6] += b.z, acc[7] += b.w;
}

// -- launch 1: eq, S and w --------------------------------------------------

constexpr int kSThreads = 256;                 // 8 warps
constexpr int kSItemsPerWarp = 8;
constexpr int kSItems = kSThreads / 32 * kSItemsPerWarp;  // 64 a block

// shared memory of launch 1: S's ring and the block's eq mask
__host__ __device__ inline size_t s_smem_bytes(int H) {
  return sizeof(float) * ((size_t)kSDepth * kSSlot +
                          (size_t)kSItems * ((H + 31) / 32));
}

// A block owns kSItems items, a warp 8 of them:
//   0. eq as a bitmask into shared memory and maskg (N, mask_stride(H));
//   1. S[b][g] = S0[g] + the sum of dlogcdf[h][g] over the set bits h of
//      item b, h ascending, fp32 on the CUDA cores: a lane holds 8 grid
//      points (s_point) of its items in registers, dlogcdf arrives 32 rows
//      a stage through a cp.async ring, and the warp walks the set bits of
//      two items at once (two independent chains of 16-byte loads and
//      adds).
//      fmaf(0, d, acc) == acc for the finite tables, so S is bitwise the
//      dense in-order sum; G > 256 takes more passes. S goes to wg (N, Gp);
//   2. w = w_trapz * exp(S - max_g S) in place in wg, zero past G.
// Two such blocks share an SM (104 KB of shared memory each at H = 1000,
// 128 registers a thread), so the walk's load-and-add chains, which bound
// it, overlap across 16 warps.
__global__ void __launch_bounds__(kSThreads, 2)
refresh_s_kernel(const int* __restrict__ hard_preds,
                 const int* __restrict__ c_ptr, const float* __restrict__ s0,
                 const float* __restrict__ dlog,
                 const float* __restrict__ w_trapz, float* __restrict__ wg,
                 unsigned* __restrict__ maskg, int C, int N, int H, int G,
                 int vecG) {
  extern __shared__ __align__(16) float s_smem[];
  const int Gp = padded_points(G), Hw = (H + 31) / 32, Hm = mask_stride(H);
  float* ring = s_smem;                                     // [kSDepth][kSSlot]
  unsigned* mask = reinterpret_cast<unsigned*>(ring + kSDepth * kSSlot);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kSItems, nb = min(kSItems, N - n0);
  const int b0 = warp * kSItemsPerWarp;
  const int c = *c_ptr;
  if ((unsigned)c >= (unsigned)C) return;  // the scoring writes the NaNs

  // 0. eq of the warp's items (items past N take no bits); c >= 0, so -1
  //    never matches
  for (int j0 = 0; j0 < Hw; j0 += 4) {
    int v[kSItemsPerWarp][4];
#pragma unroll
    for (int i = 0; i < kSItemsPerWarp; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = (j0 + q) * 32 + lane;
        v[i][q] = b0 + i < nb && h < H
                      ? hard_preds[(size_t)(n0 + b0 + i) * H + h]
                      : -1;
      }
#pragma unroll
    for (int i = 0; i < kSItemsPerWarp; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned m = __ballot_sync(0xffffffffu, v[i][q] == c);
        if (lane == 0 && j0 + q < Hw) {
          mask[(b0 + i) * Hw + j0 + q] = m;
          if (b0 + i < nb) maskg[(size_t)(n0 + b0 + i) * Hm + j0 + q] = m;
        }
      }
  }
  __syncthreads();

  // 1. S, pass by pass over G
  for (int g0 = 0; g0 < G; g0 += kGb) {
    float acc[kSItemsPerWarp][kGb / 32];
#pragma unroll
    for (int i = 0; i < kSItemsPerWarp; ++i)
#pragma unroll
      for (int k = 0; k < kGb / 32; ++k) acc[i][k] = 0.f;
    pipeline(
        ring, (H + kSR - 1) / kSR,
        [&](int st, float* slot) {
          stage_tile<kSR, kGb, kSThreads>(slot, dlog, G, st * kSR, H, g0, G,
                                          vecG);
        },
        [&](int st, const float* slot) {
          const int h = st * kSR;
          const float* t = slot + 4 * lane;
#pragma unroll
          for (int i = 0; i < kSItemsPerWarp; i += 2) {
            const unsigned* m0 = mask + (b0 + i) * Hw + (h >> 5);
            unsigned ba = (m0[0] >> (h & 31)) & kSBits;
            unsigned bb = (m0[Hw] >> (h & 31)) & kSBits;
            while (ba && bb) {
              const int ra = __ffs(ba) - 1, rb = __ffs(bb) - 1;
              ba &= ba - 1;
              bb &= bb - 1;
              add_row(acc[i], t, ra);
              add_row(acc[i + 1], t, rb);
            }
            while (ba) {
              add_row(acc[i], t, __ffs(ba) - 1);
              ba &= ba - 1;
            }
            while (bb) {
              add_row(acc[i + 1], t, __ffs(bb) - 1);
              bb &= bb - 1;
            }
          }
        },
        nullptr);
#pragma unroll
    for (int i = 0; i < kSItemsPerWarp; ++i)
      if (b0 + i < nb)
#pragma unroll
        for (int k = 0; k < kGb / 32; ++k) {
          const int g = g0 + s_point(lane, k);
          if (g < G) wg[(size_t)(n0 + b0 + i) * Gp + g] = s0[g] + acc[i][k];
        }
  }
  __syncwarp();

  // 2. w = w_trapz * exp(S - max_g S), each warp on the rows it wrote
  for (int i = 0; i < kSItemsPerWarp && b0 + i < nb; ++i) {
    float* wb = wg + (size_t)(n0 + b0 + i) * Gp;
    float m = -INFINITY;
    for (int g = lane; g < G; g += 32) m = fmaxf(m, wb[g]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    __syncwarp();
    for (int g = lane; g < Gp; g += 32)
      wb[g] = g < G ? w_trapz[g] * expf(wb[g] - m) : 0.f;
  }
}

// -- launch 2: the rows -----------------------------------------------------

// SPLIT (the row split): the work items are (tile, model chunk) pairs, and
// each writes its items' sums over its chunk to part (chunks, N) instead of
// den (row_den_kernel adds them). `stages` ring stages of the products. A
// tile is NWG * kB items, whose w and eq mask launch 1 wrote to wg and
// maskg; two blocks an SM fit the registers with one warpgroup, one with
// two.
template <bool SPLIT, int NWG>
__global__ void __launch_bounds__(threads_of<NWG>(), NWG == 1 ? 2 : 1)
refresh_compute_rows_kernel(const __grid_constant__ CUtensorMap planes,
                            const int* __restrict__ c_ptr,
                            const float* __restrict__ wg,
                            const unsigned* __restrict__ maskg,
                            float* __restrict__ u, float* __restrict__ den,
                            float* __restrict__ part, int C, int N, int H,
                            int G, int stages) {
  constexpr int kThreads = threads_of<NWG>();
  constexpr int kWarps = 4 * NWG;  // consumer warps
  constexpr int kBt = NWG * kB;    // items per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Gp = padded_points(G), Gs = w_stride(G), Hm = mask_stride(H);
  // the ring first, aligned to 1 KB for the swizzle
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  float* ring = reinterpret_cast<float*>(base);          // stages x 16 KB
  float* w = ring + stages * (kStageBytes / 4);          // [kBt][Gs]
  unsigned* mask = reinterpret_cast<unsigned*>(w + kBt * Gs);  // [kBt][Hm]
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(mask + kBt * Hm);
  const unsigned ring_s = smem_u32(ring);
  const unsigned full0 = smem_u32(bars), empty0 = full0 + 8 * stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = *c_ptr;
  if ((unsigned)c >= (unsigned)C) return;  // the scoring writes the NaNs
  const int tiles = (N + kBt - 1) / kBt, chunks = (H + kHc - 1) / kHc;
  const int nk = Gp / kKc;  // stages of a chunk
  const int items = SPLIT ? tiles * chunks : tiles;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#ifdef K6_STAGES
  long long k6_acc[kStamps] = {0, 0, 0, 0, 0, 0};
  long long k6_t = clock64();
  long long* waited = &k6_acc[3];
#endif
  // the products' ring position, the same sequence in every role
  unsigned it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = SPLIT ? item % tiles : item;
    const int n0 = tile * kBt, nb = min(kBt, N - n0);
    const int h_first = SPLIT ? item / tiles * kHc : 0;
    const int h_last = SPLIT ? min(H, h_first + kHc) : H;
#ifdef K6_STAGES
    if (tid == 0) ++k6_acc[5];
#endif

    // 0. the tile's w [kBt][Gp] and eq mask [kBt][Hm] from launch 1, 16
    //    bytes a copy (zeros past N)
    for (int e = tid; e < kBt * (Gp / 4); e += kThreads) {
      const int b = e / (Gp / 4), q = e % (Gp / 4) * 4;
      const bool ok = b < nb;
      cp_async16(w + b * Gs + q, ok ? wg + (size_t)(n0 + b) * Gp + q : wg,
                 ok);
    }
    for (int e = tid; e < kBt * (Hm / 4); e += kThreads) {
      const int b = e / (Hm / 4), q = e % (Hm / 4) * 4;
      const bool ok = b < nb;
      cp_async16(reinterpret_cast<float*>(mask + b * Hm + q),
                 reinterpret_cast<const float*>(
                     ok ? maskg + (size_t)(n0 + b) * Hm + q : maskg),
                 ok);
    }
    cp_commit();
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    K6_MARK(0);

    const int n_chunks = (h_last - h_first + kHc - 1) / kHc;
    if (warp == kWarps) {
      // the producer: lane 0 keeps up to `stages` stages in flight
      if (lane == 0) {
#ifdef K6_STAGES
        long long t_wait = 0;
#endif
        unsigned p = it;
        for (int h0 = h_first; h0 < h_last; h0 += kHc)
          for (int j = 0; j < nk; ++j, ++p) {
            const unsigned slot = p % stages, par = (p / stages) & 1u;
#ifdef K6_STAGES
            const long long t0 = clock64();
#endif
            mbar_wait(empty0 + 8 * slot, par ^ 1u);
#ifdef K6_STAGES
            t_wait += clock64() - t0;
#endif
            const unsigned dst = ring_s + slot * kStageBytes;
            mbar_expect_tx(full0 + 8 * slot, kStageBytes);
            tma_load(dst, &planes, j * kKc, h0, 0, full0 + 8 * slot);
            tma_load(dst + 2 * kPlaneBytes, &planes, j * kKc, h0, 2,
                     full0 + 8 * slot);
          }
#ifdef K6_STAGES
        k6_acc[4] += t_wait;
#endif
      }
    } else {
      // the consumers: wgmma on each stage, the epilogue after each chunk
      const int gid = lane >> 2, tig = lane & 3;
      // the thread's rows r0 and r0 + 8: warpgroup warp / 4 owns kB rows,
      // its warp warp % 4 sixteen of them
      const int r0 = warp * 16 + gid;
      const float* wa = w + r0 * Gs + tig;
      const bool even_h = H % 2 == 0;
      float rs[2] = {0.f, 0.f};  // the rows' sums over the chunks so far
      unsigned p = it;
      for (int h0 = h_first; h0 < h_last; h0 += kHc) {
        float base[64], diff[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) base[e] = diff[e] = 0.f;
        // K stages at once: cut A of their k steps, wait for the stages,
        // issue their six products each, wait for them all (the compiler
        // sees an asm operand as read at issue, so no A register may be
        // rewritten while a product that reads it is in flight), free the
        // slots
        auto batch = [&](int j, auto kk) {
          constexpr int K = decltype(kk)::value;
          unsigned ah[K][4], al[K][4];
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const float* a = wa + (j + t) * kKc;
            const float x[4] = {a[0], a[8 * Gs], a[4], a[8 * Gs + 4]};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float hi, lo;
              split_tf32(x[q], hi, lo);
              ah[t][q] = __float_as_uint(hi);
              al[t][q] = __float_as_uint(lo);
            }
          }
#ifdef K6_STAGES
          const long long t0 = clock64();
#endif
#pragma unroll
          for (int t = 0; t < K; ++t)
            mbar_wait(full0 + 8 * ((p + t) % stages),
                      ((p + t) / stages) & 1u);
#ifdef K6_STAGES
          if (tid == 0) *waited += clock64() - t0;
#endif
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < K; ++t) {
            const unsigned st = ring_s + ((p + t) % stages) * kStageBytes;
            wgmma_tf32(base, al[t], desc_sw32(st));
            wgmma_tf32(diff, al[t], desc_sw32(st + kPlaneBytes));
            wgmma_tf32(base, ah[t], desc_sw32(st + 2 * kPlaneBytes));
            wgmma_tf32(diff, ah[t], desc_sw32(st + 3 * kPlaneBytes));
            wgmma_tf32(base, ah[t], desc_sw32(st));
            wgmma_tf32(diff, ah[t], desc_sw32(st + kPlaneBytes));
          }
          wgmma_commit();
          wgmma_wait<0>();
          if (lane == 0)
#pragma unroll
            for (int t = 0; t < K; ++t)
              mbar_arrive(empty0 + 8 * ((p + t) % stages));
          p += K;
        };
        int j = 0;
        for (; j + kBatch <= nk; j += kBatch)
          batch(j, std::integral_constant<int, kBatch>());
        for (; j < nk; ++j) batch(j, std::integral_constant<int, 1>());
        K6_MARK(1);

        // 2. row = base + diff where eq is 1, stored unnormalised to the
        //    scratch (8 bytes a store where H is even); each row's chunk
        //    sum over the thread's 32 models in order, then its quad by a
        //    butterfly. The chunk's models are mask words h0/32 .. + 3.
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int b = r0 + 8 * hf;
          const bool in = b < nb;
          float* ub = u + (size_t)(n0 + min(b, nb - 1)) * H;
          const unsigned* mb = mask + b * Hm + (h0 >> 5);
          float sum = 0.f;
#pragma unroll
          for (int jw = 0; jw < kHc / 32; ++jw) {
            const unsigned word = mb[jw];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int jn = 4 * jw + jj, hl = 8 * jn + 2 * tig;
              const int h = h0 + hl;
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float bv = base[4 * jn + 2 * hf + e];
                v[e] = (word >> ((hl + e) & 31)) & 1u
                           ? bv + diff[4 * jn + 2 * hf + e]
                           : bv;
              }
              if (in && h + 1 < H && even_h) {
                *reinterpret_cast<float2*>(ub + h) = make_float2(v[0], v[1]);
              } else if (in) {
                if (h < H) ub[h] = v[0];
                if (h + 1 < H) ub[h + 1] = v[1];
              }
              if (in && h < H) sum += v[0];
              if (in && h + 1 < H) sum += v[1];
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          rs[hf] += sum;
        }
        K6_MARK(2);
      }
      if (tig == 0)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int b = r0 + 8 * hf;
          if (b < nb) {
            if (SPLIT)
              part[(size_t)(h_first / kHc) * N + n0 + b] = rs[hf];
            else
              den[n0 + b] = fmaxf(rs[hf], 1e-30f);
          }
        }
    }
    it += (unsigned)(n_chunks * nk);
    // every stage consumed and every product landed: the next work item may
    // overwrite the tile's w and mask
    __syncthreads();
  }
#ifdef K6_STAGES
  if (tid == kWarps * 32 && blockIdx.x < kStampBlocks)
    k6_cycles[blockIdx.x * kStamps + 4] = k6_acc[4];
  if (tid == 0 && blockIdx.x < kStampBlocks)
    for (int k = 0; k < kStamps; ++k)
      if (k != 4) k6_cycles[blockIdx.x * kStamps + k] = k6_acc[k];
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

// The single scoring launch: kernel 2's scoring pass (eig::score_warp, or
// eig::score_block_approx for the approx entropy) with class row c read
// from the scratch u, divided by den[n], rounded to T, stored into the
// cache and scored as rounded (FRESH = 2)
constexpr int kScoreThreads = eig::kScoreWarps * 32;
template <typename T, int VEC, bool APPROX>
__global__ void __launch_bounds__(kScoreThreads)
refresh_compute_score_kernel(const float* __restrict__ rows, T* hyp,
                             const float* __restrict__ u,
                             const float* __restrict__ den,
                             const int* __restrict__ c_ptr,
                             const float* __restrict__ pi,
                             const float* __restrict__ pi_xi,
                             const float* __restrict__ mixture0,
                             const float* __restrict__ h_before,
                             float* __restrict__ out, int C, int N, int H) {
  extern __shared__ float h_after[];  // the approx pass: [warps][C]
  if constexpr (APPROX) {
    eig::score_block_approx<T, VEC, 2>(rows, hyp, hyp, u, den, *c_ptr, pi,
                                       pi_xi, mixture0, h_before, out, C, N,
                                       H, 0, h_after);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * eig::kScoreWarps + warp) * eig::kExactRows;
    eig::score_warp<T, VEC, 2>(rows, hyp, hyp, u, den, *c_ptr, pi, pi_xi,
                               mixture0, h_before[0], out, C, N, H, 0, n0,
                               lane);
  }
}

template <int NWG>
int rows_attribute(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      refresh_compute_rows_kernel<false, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(refresh_compute_rows_kernel<true, NWG>,
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
  constexpr int kItems = eig::score_items<APPROX>();  // items a block
  const int grid = (N + kItems - 1) / kItems;
  const size_t smem = APPROX ? sizeof(float) * eig::kScoreWarps * C : 0;
  T* h = static_cast<T*>(hyp);
  if (vec > 1)
    refresh_compute_score_kernel<T, kVec, APPROX>
        <<<grid, kScoreThreads, smem, stream>>>(
            rows, h, u, den, c, pi, pi_xi, mixture0, h_before, out, C, N, H);
  else
    refresh_compute_score_kernel<T, 1, APPROX>
        <<<grid, kScoreThreads, smem, stream>>>(
            rows, h, u, den, c, pi, pi_xi, mixture0, h_before, out, C, N, H);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, a libcuda entry point found once through the
// runtime (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  });
  return fn;
}

// the row block's shape at (H, G) on a card whose blocks may opt in to
// optin bytes: nwg consumer warpgroups (the wanted count, or one where two
// do not fit with the fewest stages) and as many ring stages as fit, at
// most kRingStages
void row_shape(int H, int G, long long optin, int* nwg, int* stages) {
  if (*nwg != 1 &&
      (long long)smem_bytes(H, G, kMinStages, 2) <= optin)
    *nwg = 2;
  else
    *nwg = 1;
  int d = kRingStages;
  while (d > kMinStages && (long long)smem_bytes(H, G, d, *nwg) > optin) --d;
  *stages = d;
}

int optin_bytes(int* dev, int* optin) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
  return (int)err;
}

template <int NWG>
int launch_rows(const CUtensorMap& map, const int* c, const float* wg,
                const unsigned* maskg, float* u, float* den, float* part,
                int C, int N, int H, int G, int stages, int row_split,
                int blocks, cudaStream_t st) {
  const size_t smem = smem_bytes(H, G, stages, NWG);
  int err = rows_attribute<NWG>(smem);
  if (err != 0) return err;
  constexpr int kThr = threads_of<NWG>();
  if (row_split)
    refresh_compute_rows_kernel<true, NWG><<<blocks, kThr, smem, st>>>(
        map, c, wg, maskg, u, den, part, C, N, H, G, stages);
  else
    refresh_compute_rows_kernel<false, NWG><<<blocks, kThr, smem, st>>>(
        map, c, wg, maskg, u, den, part, C, N, H, G, stages);
  return (int)cudaGetLastError();
}

template <int NWG>
int occupancy(size_t smem, int* blocks) {
  int err = rows_attribute<NWG>(smem);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, refresh_compute_rows_kernel<false, NWG>, threads_of<NWG>(),
      smem);
}

}  // namespace

extern "C" {

// The layout of launch 2 at (C, H, G) with `nwg` consumer warpgroups
// wanted (1 or 2), into out[8]: items per block, models per chunk, grid
// points per stage, dynamic shared memory per block in bytes, resident
// blocks per SM on the current device (0 when the block does not fit), the
// largest H whose block fits the device's opt-in shared memory at this G
// (one warpgroup, the fewest stages), the ring stages taken (as many as
// fit, at most kRingStages) and the warpgroups taken (one where two do not
// fit). Returns a cudaError.
int eig_refresh_compute_layout(int C, int H, int G, int nwg, long long* out) {
  (void)C;
  int dev = 0, optin = 0, blocks = 0, stages = 0;
  int err = optin_bytes(&dev, &optin);
  if (err != 0) return err;
  row_shape(H, G, optin, &nwg, &stages);
  const size_t smem = smem_bytes(H, G, stages, nwg);
  out[0] = (long long)kB * nwg;
  out[1] = kHc;
  out[2] = kKc;
  out[3] = (long long)smem;
  const long long fixed = (long long)smem_bytes(0, G, kMinStages, 1);
  // whole 16-byte groups of mask words a row
  out[5] = optin > fixed
               ? (optin - fixed) / (long long)(sizeof(float) * kB) / 4 * 128
               : 0;
  out[6] = stages;
  out[7] = nwg;
  out[4] = 0;
  if ((long long)smem <= optin) {
    err = nwg == 2 ? occupancy<2>(smem, &blocks) : occupancy<1>(smem, &blocks);
    if (err != 0) return err;
    out[4] = blocks;
  }
  return 0;
}

#ifdef K6_STAGES
// Cycles of launch 2 of the last call per block (6 a block: the tile loads,
// the products, the epilogue, the consumers' waits, the producer's waits,
// the block's work items), for the first n / 6 blocks.
int eig_refresh_compute_stamps(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, k6_cycles, sizeof(long long) * n);
}
#endif

// Launch 0 alone: fu and df (H, G) fp32 into planes (4, H, Gp) as
// split_tables_kernel writes them.
int eig_split_tables_launch(const float* fu, const float* df, float* planes,
                            int H, int G, void* stream) {
  const int Gp = padded_points(G);
  const long long n = (long long)H * Gp;
  const int grid = (int)std::max(1LL, std::min((n + 255) / 256, 4096LL));
  split_tables_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      fu, df, planes, H, G, Gp);
  return (int)cudaGetLastError();
}

// hyp: (C, N, H) fp32 or, with bf16 != 0, bf16, written in row *c;
// hard_preds (N, H) int32; s0 (G,), dlog, fu and df (H, G), w_trapz (G,)
// fp32; planes (4, H, Gp), wg (N, Gp), u (N, H) and den (N,) fp32 and
// maskg (N, mask_stride(H)) uint32 scratch the caller allocates. vec > 1
// takes 16-byte loads in the scoring pass.
// row_split != 0 walks (tile, model chunk) pairs through part, an
// (ceil(H / kHc), N) fp32 scratch; chunks (1 <= chunks <= min(C, 65535)) > 1
// splits the scoring over that many class chunks through ent, an (N, C)
// fp32 scratch. part and ent may be null where they are not used. blocks:
// the row launch's persistent grid; nwg: its consumer warpgroups wanted
// (1 or 2; cut to what fits, as eig_refresh_compute_layout reports). Every
// path gives the same bits.
int eig_refresh_compute_launch(
    const float* rows, void* hyp, const int* hard_preds, const int* c,
    const float* s0, const float* dlog, const float* fu, const float* df,
    const float* w_trapz, const float* pi, const float* pi_xi,
    const float* mixture0, const float* h_before, float* planes, float* wg,
    unsigned* maskg, float* u, float* den, float* part, float* ent,
    float* out, int C, int N, int H, int G, int vec, int bf16, int approx,
    int chunks, int row_split, int blocks, int nwg, void* stream) {
  if (G < 2 || chunks < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, optin = 0, stages = 0;
  int err = optin_bytes(&dev, &optin);
  if (err != 0) return err;
  row_shape(H, G, optin, &nwg, &stages);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int Gp = padded_points(G);
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)Gp, (cuuint64_t)H, 4};
  const cuuint64_t strides[2] = {(cuuint64_t)Gp * 4,
                                 (cuuint64_t)H * Gp * 4};
  const cuuint32_t box[3] = {kKc, kHc, 2}, elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, planes, dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int vecG = G % 4 == 0 && (size_t)dlog % 16 == 0;

  err = eig_split_tables_launch(fu, df, planes, H, G, stream);
  if (err != 0) return err;
  const size_t s_smem = s_smem_bytes(H);
  err = (int)cudaFuncSetAttribute(refresh_s_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)s_smem);
  if (err != 0) return err;
  refresh_s_kernel<<<(N + kSItems - 1) / kSItems, kSThreads, s_smem, st>>>(
      hard_preds, c, s0, dlog, w_trapz, wg, maskg, C, N, H, G, vecG);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = nwg == 2 ? launch_rows<2>(map, c, wg, maskg, u, den, part, C, N, H,
                                  G, stages, row_split, blocks, st)
                 : launch_rows<1>(map, c, wg, maskg, u, den, part, C, N, H,
                                  G, stages, row_split, blocks, st);
  if (err != 0) return err;
  if (row_split) {
    row_den_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, den,
                                                    (H + kHc - 1) / kHc, N);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
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
