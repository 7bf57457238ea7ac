// The float32 whitening of many right-hand sides on Hopper's tensor cores:
// X = L^-1 B for one lower-triangular L (n x n) and B (n x m), with the
// inverses of L's 64 x 64 diagonal tiles (the blocked Cholesky's Dinv)
// given.
//
// Replaces no Pallas kernel: the JAX package left this solve
// (erl_gaussian_process_tpu/ops/blocked_solve.py::blocked_solve_lower) to
// XLA. It is added because the whitening of the exact GP's variance was
// ~95% of a test at n = 8192 and m = 10 000 queries (PERF.md), where it ran
// as 128 thin FP32 cuBLAS products.
//
// What one call computes, over outer blocks of R = 512 rows (the block of
// blocked_solve.py) and, inside each, 64-row tiles k (the factor's tile):
//
//   panel : Y = B[K] - L[K, :K] X[:K]                 (rows K of the block)
//   block : X_k = Dinv_k (Y_k - L[k, K0:k] X[K0:k])   k = 0 .. 7 in order
//
// What bounds it on this card: n^2 m multiply-adds (6.7e11 operations at n
// = 8192, m = 10 000). At the FP32 SIMT peak (67 TFLOP/s) that is 10.0 ms
// however it is blocked. The products here run on the tensor cores in
// 3xTF32: each float32 operand is split into hi + lo TF32 parts (cvt.rna)
// and a product taken as lo*hi + hi*lo + hi*hi with FP32 accumulation, the
// convention of the factorization's own updates (csrc/wgmma_tf32.cuh); the
// least time of the same work is then 3 x 6.7e11 / 495e12 = 4.07 ms.
// One-pass TF32 would keep three decimal digits, which the variance near
// the training points does not survive.
//
// The tensor cores add into their accumulator with truncation: a running
// sum over 8192 terms drifts by ~6e-5 of its size (NVIDIA H100, PERF.md),
// where float32 FMAs drift by ~6e-8. So every partial product here starts
// from zero and is added into the running sum by an FP32 add: each pair of
// 32-deep chunks in the panel, each chunk in the in-block solve.
//
// The design:
//   0. Two short passes split L, once a solve, into hi and lo TF32 tiles
//      in wgmma's core-matrix layout, in the order the products read them
//      (the wrapper's scratch, 0.27 GB at n = 8192): the panels, then
//      each block's own rows and its Dinv tiles.
//   1. The panel product carries ~94% of the work: a GEMM of depth K0 (the
//      rows solved so far), with wgmma (sm_90a) at the card's full TF32
//      rate. It is taken transposed, Y^T = X^T L^T, so that both operands
//      are read as they lie: X^T is the register operand (64 queries a
//      warpgroup, split in registers), L's split tiles the shared-memory
//      operand, K-major as wgmma's TF32 form requires. A thread block of two
//      warpgroups owns 128 queries x 128 rows of the block. Each chunk of L
//      (32 deep) comes in one bulk copy, two chunks ahead, through a ring
//      whose stages barriers in shared memory (mbarrier) order; each warp
//      streams the 32 x 16 of X that only it reads through its own cp.async
//      ring. No warp waits on another but for L's stages, so one warpgroup
//      multiplies while the other folds and loads. (A single loading warp
//      spent more time issuing X's rows than the products took.) The row
//      tiles of one query strip are neighbours in launch order, so a strip
//      of X comes from memory once a step and the panel of L stays in L2.
//   2. The in-block solve, the same products on 64 queries a thread block
//      (one warpgroup): tile by tile, the rows of X solved before (written
//      to X and re-read once final) times L's tile row, then the factor's
//      own Dinv tile times the residual, which passes from the
//      accumulator to the register operand without leaving the registers.
//      The Dinv tiles keep the products rounding as the factorization's
//      did, so the variance's cancellation near the training points
//      survives.
//   3. A block of n <= R rows is one in-block solve alone. The last block
//      and the last tile are masked for a ragged n (rows past n read as 0,
//      nothing past n is written); any m is masked at the edge.
// At most 2 + 2 ceil(n / R) - 1 launches a solve, on the caller's stream,
// with no allocation and no host synchronisation: a CUDA graph captures it.
// Sums run in a fixed order with no atomics: two calls on one input are
// bitwise equal.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "wgmma_tf32.cuh"

namespace egp {

constexpr int kTrsmR = 512;  // rows of an outer block
constexpr int kTrsmT = 64;   // the factor's tile: rows of Dinv_k
constexpr int kTrsmK = kCoreK;  // depth of one chunk (32)

// ---- the panel product (wgmma) ---------------------------------------------

constexpr int kPanelQ = 128;  // queries a thread block: 2 warpgroups of 64
constexpr int kPanelN = 128;  // rows of L a thread block: wgmma's N
constexpr int kPanelThreads = 256;
constexpr int kPanelStages = 4;   // chunks of L: 2 ahead, 2 being freed
constexpr int kPanelXStages = 4;                     // a warp's chunks of X
constexpr int kPanelXLd = 16 + 8;  // a warp's 16 queries: conflict-free
constexpr int kPanelXStage = kTrsmK * kPanelXLd;
constexpr int kPanelCore = kPanelN * kTrsmK;  // one hi or lo tile (floats)
constexpr int kPanelSmem =
    (kPanelStages * 2 * kPanelCore +
     kPanelThreads / 32 * kPanelXStages * kPanelXStage) *
        (int)sizeof(float) +
    2 * kPanelStages * 8;
constexpr unsigned kChunkBytes = 2 * kPanelCore * sizeof(float);

// The split panel of L (the wrapper's scratch): for each 128-row tile t of
// the blocks past the first, its chunks c of 32 columns left of its block,
// each the hi tile then the lo tile in the core layout, tile after tile.
// Tile t = 4 K + j of block K has 16 K chunks.
__host__ __device__ __forceinline__ long long split_chunks_before(int t) {
  const long long K = t / 4, j = t % 4;
  return 16 * K * (2 * K - 2 + j);
}

// floats of the split panels of a solve of n rows
__host__ __device__ __forceinline__ long long split_panel_floats(int n) {
  const int tiles = (n + kPanelN - 1) / kPanelN;
  return tiles > 4 ? split_chunks_before(tiles) * 2 * kPanelCore : 0;
}

// L's panels split into hi and lo TF32 tiles once a solve: grid (chunk,
// row tile from 4 on), each thread 16 values of one row.
__global__ void __launch_bounds__(256)
    trsm_split_kernel(const float* __restrict__ L, float* __restrict__ Lc,
                      int n) {
  const int t = 4 + blockIdx.y;
  const int c = blockIdx.x;
  if (c >= 16 * (t / 4)) return;
  float* hi = Lc + (split_chunks_before(t) + c) * 2 * kPanelCore;
  float* lo = hi + kPanelCore;
  const int r = threadIdx.x >> 1;
  const int kb = (threadIdx.x & 1) * 16;
  const int row = t * kPanelN + r;
  const float* src = L + (size_t)row * n + c * kTrsmK + kb;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_rna(row < n ? __ldg(src + 4 * q + e) : 0.f, h[e], l[e]);
    const int at = core_index(r, kb + 4 * q);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global src to
// shared dst by the copy engine, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// Y = B - L[r0 + i, :r0] X[:r0] for the block's rows i < rows, written into
// X's rows r0 + i; Lc the split panels. Grid: (row tiles, query tiles), row
// tiles fastest. Two warpgroups of 64 queries. The split chunks of L stream
// through a 4-stage ring, one bulk copy each, issued by thread 0 two chunks
// ahead (a stage's full barrier counts its bytes; its empty barrier the
// warps that are done with it, two chunks before it is filled again, so
// the issuing warp hardly ever waits). Each warp streams the 32 x 16 of X
// that only it reads through its own cp.async ring. So the warpgroups run
// apart, one multiplying while the other folds and loads.
__global__ void __launch_bounds__(kPanelThreads, 1)
    trsm_panel_kernel(const float* __restrict__ Lc,
                      const float* __restrict__ B, float* __restrict__ X,
                      int m, int r0, int rows, int vec_x) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* core = reinterpret_cast<float*>(smem_raw);  // [stage][hi, lo]
  float* xring = core + kPanelStages * 2 * kPanelCore;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      xring + kPanelThreads / 32 * kPanelXStages * kPanelXStage);
  uint64_t* empty = full + kPanelStages;
  const int t = r0 / kPanelN + blockIdx.x;
  const int i0 = blockIdx.x * kPanelN;
  const int j0 = blockIdx.y * kPanelQ;
  const int nch = r0 / kTrsmK;  // r0 is a multiple of R
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPanelStages; ++s) {
      mbar_init(full + s, 1);   // the issuing thread's arrival, the bytes
      mbar_init(empty + s, 8);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const float* chunks = Lc + split_chunks_before(t) * 2 * kPanelCore;
  // chunk c of L into its stage, once the warps are done with chunk c - 4
  auto load_l = [&](int c) {
    const int s = c % kPanelStages;
    if (c >= kPanelStages) mbar_wait(empty + s, (c / kPanelStages - 1) & 1);
    mbar_expect_tx(full + s, kChunkBytes);
    bulk_copy(core + s * 2 * kPanelCore, chunks + (size_t)c * 2 * kPanelCore,
              kChunkBytes, full + s);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < 2 && c < nch; ++c) load_l(c);
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int jw = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's queries
  float* xw = xring + warp * kPanelXStages * kPanelXStage;
  // chunk c's 32 rows of the warp's 16 queries of X, zero past m
  auto load_x = [&](int c) {
    float* xs = xw + (c % kPanelXStages) * kPanelXStage;
    const int k0 = c * kTrsmK;
    if (vec_x) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (lane >> 2) + 8 * i;
        const int j = j0 + jw + 4 * (lane & 3);
        cp_async<16>(xs + r * kPanelXLd + 4 * (lane & 3),
                     j < m ? X + (size_t)(k0 + r) * m + j : X, j < m);
      }
    } else {
      for (int e = lane; e < kTrsmK * 16; e += 32) {
        const int r = e >> 4;
        const int j = j0 + jw + (e & 15);
        cp_async<4>(xs + r * kPanelXLd + (e & 15),
                    j < m ? X + (size_t)(k0 + r) * m + j : X, j < m);
      }
    }
  };
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
#pragma unroll
  for (int st = 0; st < kPanelXStages - 1; ++st) {
    if (st < nch) load_x(st);
    cp_commit();
  }
  // chunks in pairs (nch is even): a fresh partial a pair, so that a
  // warpgroup has 24 products in flight between its waits
  for (int c = 0; c < nch; c += 2) {
    unsigned ahi[2][4][4], alo[2][4][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c + h;
      if (threadIdx.x == 0 && cc + 2 < nch) load_l(cc + 2);
      __syncwarp();  // the warp is done with its slot of chunk cc - 1
      if (cc + kPanelXStages - 1 < nch) load_x(cc + kPanelXStages - 1);
      cp_commit();
      cp_wait<kPanelXStages - 1>();  // chunk cc's X is in
      __syncwarp();
      const float* xs = xw + (cc % kPanelXStages) * kPanelXStage;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* x = xs + (kk * 8 + tq) * kPanelXLd + g;
        split_rna(x[0], ahi[h][kk][0], alo[h][kk][0]);
        split_rna(x[8], ahi[h][kk][1], alo[h][kk][1]);
        split_rna(x[4 * kPanelXLd], ahi[h][kk][2], alo[h][kk][2]);
        split_rna(x[4 * kPanelXLd + 8], ahi[h][kk][3], alo[h][kk][3]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c + h;
      const int s = cc % kPanelStages;
      mbar_wait(full + s, (cc / kPanelStages) & 1);
      const float* hi = core + s * 2 * kPanelCore;
      const float* lo = hi + kPanelCore;
      // the small terms first
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_n128(part, alo[h][kk], core_desc(hi, kk),
                        h == 0 && kk == 0);
        wgmma_tf32_n128(part, ahi[h][kk], core_desc(lo, kk), 0);
        wgmma_tf32_n128(part, ahi[h][kk], core_desc(hi, kk), 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty + c % kPanelStages);
      mbar_arrive(empty + (c + 1) % kPanelStages);
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
  }
  cp_wait<0>();
  // acc[4 j + e]: query jw + g + 8 (e / 2), row 8 j + 2 tq + e % 2
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * j + 2 * tq + (e & 1);
      const int q = j0 + jw + g + 8 * (e >> 1);
      if (i < rows && q < m) {
        const size_t at = (size_t)(r0 + i) * m + q;
        X[at] = B[at] - acc[4 * j + e];
      }
    }
}

// ---- the in-block solve (wgmma) --------------------------------------------

constexpr int kBlockQ = 64;         // queries a thread block: one warpgroup
constexpr int kBlockThreads = 128;
constexpr int kBlockStages = 4;     // chunks of L or Dinv in flight
constexpr int kBlockXStages = 4;    // chunks of X in flight
constexpr int kBlockXLd = kBlockQ + 8;  // X rows: conflict-free fragments
constexpr int kBlockCore = kTrsmT * kTrsmK;  // a 64-row hi or lo tile
constexpr int kBlockChunks = (kTrsmR / kTrsmT) * (kTrsmR / kTrsmT + 1);
constexpr int kBlockSmem =
    (kBlockStages * 2 * kBlockCore + kBlockXStages * kTrsmK * kBlockXLd) *
        (int)sizeof(float) +
    kBlockStages * 8;

// The split chunks of the blocks' own rows, after the panels' (the same
// scratch): block b, tile k (64 rows), chunk q: L[k, K0 + 32 q ..] for q <
// 2k, then Dinv_k's two halves, 64 x 32 hi and lo in the core layout. In
// Dinv's chunks the columns of each 8 are in the order 0 2 4 6 1 3 5 7:
// the residual enters the product as the register operand straight from
// the accumulator of the sum before it, whose thread holds columns 2 tq
// and 2 tq + 1 where the operand wants tq and tq + 4.
__host__ __device__ __forceinline__ long long diag_chunk(int b, int k,
                                                         int q) {
  return (long long)b * kBlockChunks + k * (k + 1) + q;
}

// grid (chunk slot of a block, block), each thread 8 values of one row
__global__ void __launch_bounds__(256)
    trsm_split_diag_kernel(const float* __restrict__ L,
                           const float* __restrict__ dinv,
                           float* __restrict__ Ld, int n) {
  const int b = blockIdx.y;
  const int r0 = b * kTrsmR;
  int k = 0;
  while ((k + 1) * (k + 2) <= (int)blockIdx.x) ++k;
  const int q = blockIdx.x - k * (k + 1);
  if (r0 + k * kTrsmT >= n) return;  // past the last tile of the block
  float* hi = Ld + diag_chunk(b, k, q) * 2 * kBlockCore;
  float* lo = hi + kBlockCore;
  const int r = threadIdx.x >> 2;
  const int kb = (threadIdx.x & 3) * 8;
  const int row = r0 + k * kTrsmT + r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned vh[4], vl[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = kb + 4 * h + e;  // the position in the chunk
      float v;
      if (q < 2 * k) {
        v = row < n ? __ldg(L + (size_t)row * n + r0 + q * kTrsmK + p) : 0.f;
      } else {
        const int p8 = p & 7;
        const int col = (p & ~7) + (p8 < 4 ? 2 * p8 : 2 * (p8 - 4) + 1);
        v = __ldg(dinv + (size_t)row * kTrsmT + (q - 2 * k) * kTrsmK + col);
      }
      split_rna(v, vh[e], vl[e]);
    }
    const int at = core_index(r, kb + 4 * h);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(vh[0], vh[1], vh[2],
                                                    vh[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(vl[0], vl[1], vl[2],
                                                    vl[3]);
  }
}

// wait until at most `pending` (0 .. 3) of this thread's cp.async groups
// are in flight
__device__ __forceinline__ void cp_wait_n(int pending) {
  if (pending <= 0)
    cp_wait<0>();
  else if (pending == 1)
    cp_wait<1>();
  else if (pending == 2)
    cp_wait<2>();
  else
    cp_wait<3>();
}

// X[r0 + i] for the block's rows i < rows and 64 queries a thread block,
// from Y = Y0[i] (B's or the panel's rows r0 ..; may be X itself: each
// entry is read before it is written, by the thread that writes it). Taken
// transposed as the panel is, X_k^T = (Y_k^T - X[K0:k]^T L[k, K0:k]^T)
// Dinv_k^T, tile after tile: the split chunks of L and Dinv come by bulk
// copy, the rows of X solved before (written to X, re-read by cp.async
// once they are final) as the register operand, the residual from the
// accumulator into the register operand of Dinv's product.
__global__ void __launch_bounds__(kBlockThreads)
    trsm_block_kernel(const float* __restrict__ Ld, const float* Y0,
                      float* X, int n, int m, int r0, int vec_x) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* core = reinterpret_cast<float*>(smem_raw);  // [stage][hi, lo]
  float* xring = core + kBlockStages * 2 * kBlockCore;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      xring + kBlockXStages * kTrsmK * kBlockXLd);
  const int b = r0 / kTrsmR;
  const int rows = min(kTrsmR, n - r0);
  const int ntile = (rows + kTrsmT - 1) / kTrsmT;
  const int nchunk = ntile * (ntile + 1);      // L and Dinv chunks
  const int nxchunk = ntile * (ntile - 1);     // X chunks: 2k in tile k
  const int j0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int jq = j0 + warp * 16 + g;  // the thread's queries jq, jq + 8
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBlockStages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const float* chunks = Ld + diag_chunk(b, 0, 0) * 2 * kBlockCore;
  auto load_c = [&](int G) {  // chunk G of L or Dinv (thread 0)
    const int s = G % kBlockStages;
    mbar_expect_tx(full + s, 2 * kBlockCore * sizeof(float));
    bulk_copy(core + s * 2 * kBlockCore, chunks + (size_t)G * 2 * kBlockCore,
              2 * kBlockCore * sizeof(float), full + s);
  };
  // X chunk H (tile k, chunk c: H = k (k - 1) + c): the block's rows 32 c
  // .. of the thread block's queries, zero past m
  auto load_x = [&](int H) {
    int k = 1;
    while ((k + 1) * k <= H) ++k;
    const int c = H - k * (k - 1);
    float* xs = xring + (H % kBlockXStages) * kTrsmK * kBlockXLd;
    const float* src = X + (size_t)(r0 + c * kTrsmK) * m;
    if (vec_x) {
      for (int e = threadIdx.x; e < kTrsmK * kBlockQ / 4; e += 128) {
        const int r = e >> 4, j = j0 + 4 * (e & 15);
        cp_async<16>(xs + r * kBlockXLd + 4 * (e & 15),
                     j < m ? src + (size_t)r * m + j : X, j < m);
      }
    } else {
      for (int e = threadIdx.x; e < kTrsmK * kBlockQ; e += 128) {
        const int r = e >> 6, j = j0 + (e & 63);
        cp_async<4>(xs + r * kBlockXLd + (e & 63),
                    j < m ? src + (size_t)r * m + j : X, j < m);
      }
    }
  };
  int x_issued = 0;  // X chunks issued so far, in order
  // issue X chunks up to H_last whose rows are solved (rows_done)
  auto issue_x = [&](int H_last, int rows_done) {
    while (x_issued < nxchunk && x_issued <= H_last) {
      int k = 1;
      while ((k + 1) * k <= x_issued) ++k;
      const int c = x_issued - k * (k - 1);
      if ((c + 1) * kTrsmK > rows_done) break;
      load_x(x_issued);
      cp_commit();
      ++x_issued;
    }
  };
  if (threadIdx.x == 0)
    for (int G = 0; G < kBlockStages - 1 && G < nchunk; ++G) load_c(G);
  float acc[32], part[32], res[32];
  for (int k = 0; k < ntile; ++k) {
    const int t0 = k * kTrsmT;
    // Y_k^T at the accumulator's places: acc[4 j + e] is query jq + 8 (e /
    // 2) and row t0 + 8 j + 2 tq + e % 2
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = t0 + 8 * j + 2 * tq + (e & 1);
        const int q = jq + 8 * (e >> 1);
        res[4 * j + e] = i < rows && q < m
                             ? Y0[(size_t)(r0 + i) * m + q] : 0.f;
        acc[4 * j + e] = 0.f;
      }
    for (int qc = 0; qc < 2 * k + 2; ++qc) {
      const int G = k * (k + 1) + qc;
      const int s = G % kBlockStages;
      __syncthreads();  // every warp is done with chunk G - 1's stages
      if (threadIdx.x == 0 && G + kBlockStages - 1 < nchunk)
        load_c(G + kBlockStages - 1);
      unsigned ahi[4][4], alo[4][4];
      if (qc < 2 * k) {
        const int H = k * (k - 1) + qc;
        issue_x(H + kBlockXStages - 1, t0);
        cp_wait_n(x_issued - 1 - H);
        __syncthreads();  // every thread's part of X chunk H is in
        const float* xs = xring + (H % kBlockXStages) * kTrsmK * kBlockXLd;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* x = xs + (kk * 8 + tq) * kBlockXLd + warp * 16 + g;
          split_rna(x[0], ahi[kk][0], alo[kk][0]);
          split_rna(x[8], ahi[kk][1], alo[kk][1]);
          split_rna(x[4 * kBlockXLd], ahi[kk][2], alo[kk][2]);
          split_rna(x[4 * kBlockXLd + 8], ahi[kk][3], alo[kk][3]);
        }
      } else {
        if (qc == 2 * k) {  // the residual Y_k^T - X[K0:k]^T L[k, K0:k]^T
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            res[e] -= acc[e];
            acc[e] = 0.f;
          }
        }
        // Dinv's chunk h takes the residual's columns 32 h .. (4 steps of
        // 8), each step's register operand from its accumulator places
        // (unrolled so that the residual is indexed by constants)
        if (qc == 2 * k) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            split_rna(res[4 * kk + 0], ahi[kk][0], alo[kk][0]);
            split_rna(res[4 * kk + 2], ahi[kk][1], alo[kk][1]);
            split_rna(res[4 * kk + 1], ahi[kk][2], alo[kk][2]);
            split_rna(res[4 * kk + 3], ahi[kk][3], alo[kk][3]);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            split_rna(res[16 + 4 * kk + 0], ahi[kk][0], alo[kk][0]);
            split_rna(res[16 + 4 * kk + 2], ahi[kk][1], alo[kk][1]);
            split_rna(res[16 + 4 * kk + 1], ahi[kk][2], alo[kk][2]);
            split_rna(res[16 + 4 * kk + 3], ahi[kk][3], alo[kk][3]);
          }
        }
      }
      mbar_wait(full + s, (G / kBlockStages) & 1);
      const float* hi = core + s * 2 * kBlockCore;
      const float* lo = hi + kBlockCore;
      wgmma_fence();
      // a fresh partial: the small terms first
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_n64(part, alo[kk], core_desc(hi, kk), kk == 0);
        wgmma_tf32_n64(part, ahi[kk], core_desc(lo, kk), 0);
        wgmma_tf32_n64(part, ahi[kk], core_desc(hi, kk), 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
    }
    // X_k^T = acc: into X, where the next tiles' chunks re-read it
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = t0 + 8 * j + 2 * tq + (e & 1);
        const int q = jq + 8 * (e >> 1);
        if (i < rows && q < m) X[(size_t)(r0 + i) * m + q] = acc[4 * j + e];
      }
    __threadfence_block();
    __syncthreads();  // X_k is written before any thread copies it
  }
  cp_wait<0>();
}

static bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

static int launch_trsm(const float* L, const float* dinv, const float* B,
                       float* X, float* Lc, int n, int m, int device,
                       cudaStream_t stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(trsm_panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPanelSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(trsm_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBlockSmem);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies of B's and X's rows
  const int vec_b = m % 4 == 0 && aligned(B, 16) && aligned(X, 16);
  const int tiles = (n + kPanelN - 1) / kPanelN;
  const int blocks = (n + kTrsmR - 1) / kTrsmR;
  float* Ld = Lc + split_panel_floats(n);
  if (tiles > 4) {
    trsm_split_kernel<<<dim3(16 * ((tiles - 1) / 4), tiles - 4), 256, 0,
                        stream>>>(L, Lc, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  trsm_split_diag_kernel<<<dim3(kBlockChunks, blocks), 256, 0, stream>>>(
      L, dinv, Ld, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int strips = (m + kBlockQ - 1) / kBlockQ;
  for (int r0 = 0; r0 < n; r0 += kTrsmR) {
    const int rows = n - r0 < kTrsmR ? n - r0 : kTrsmR;
    if (r0 > 0) {
      const dim3 grid((rows + kPanelN - 1) / kPanelN,
                      (m + kPanelQ - 1) / kPanelQ);
      trsm_panel_kernel<<<grid, kPanelThreads, kPanelSmem, stream>>>(
          Lc, B, X, m, r0, rows, vec_b);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    trsm_block_kernel<<<strips, kBlockThreads, kBlockSmem, stream>>>(
        Ld, r0 > 0 ? X : B, X, n, m, r0, vec_b);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace egp

// Floats of the scratch a solve of n rows needs: the split panels of L,
// then the split chunks of the blocks' own rows and of Dinv.
extern "C" long long egp_trsm_scratch_floats(int n) {
  const int blocks = (n + egp::kTrsmR - 1) / egp::kTrsmR;
  return egp::split_panel_floats(n) +
         egp::diag_chunk(blocks, 0, 0) * 2 * egp::kBlockCore;
}

// X = L^-1 B: L (n x n, row-major, lower triangular), dinv (ceil(n / 64) *
// 64 x 64, the inverses of L's diagonal tiles, the last identity-padded), B
// and X (n x m, row-major, not overlapping), Lc egp_trsm_scratch_floats(n)
// floats of scratch (16-byte aligned). Returns 0 or a CUDA error.
extern "C" int egp_trsm_f32(const float* L, const float* dinv, const float* B,
                            float* X, float* Lc, int n, int m, int device,
                            void* stream) {
  return egp::launch_trsm(L, dinv, B, X, Lc, n, m, device,
                          (cudaStream_t)stream);
}
