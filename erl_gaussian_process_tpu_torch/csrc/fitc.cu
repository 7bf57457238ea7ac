// Rank-N FITC update (dQ_M, dalpha) on Hopper.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_fitc.py::_fitc_kernel (via
// _fitc_update_padded / pallas_fitc_update), the hot loop of the SPGP
// occupancy map. For pseudo points P (M, d), L_inv = chol(K_M)^{-1} (M, M,
// lower triangular with exact zeros above the diagonal: only the 64 x 64
// tiles on and below it are read, the diagonal tiles whole) and one pose's
// samples x (N, d), y (N, q), var (N,), mask (N,):
//
//   kmn    = k(P, x)                                   (M, N)
//   beta   = L_inv kmn                                 (M, N)
//   lam_j  = max(1 - ||beta_:j||^2, 0)
//   w_j    = mask_j ? 1 / (lam_j + var_j) : 0
//   dQ     = (kmn diag(w)) kmn^T                       (M, M), symmetric
//   dalpha = (kmn diag(w)) (mask ? y : 0)              (M, q)
//
// What bounds it on an H100: arithmetic. At the hotel-0 shape (M = 1152, N
// = 2048) the triangular L_inv product is M^2 N = 2.7 GFLOP and the lower
// half of the weighted SYRK another ~2.9 GFLOP, against ~25 MB of operand
// and result traffic: hundreds of FLOP per byte, far above the card's ridge.
//
// Design: three launches on one stream, no float atomics (two calls are
// bitwise equal; the drift check relies on that):
//
//   (1) kmn_kernel: kmn into a scratch buffer the caller allocates, one
//       thread per element, family math from family.cuh; block 0 also zeroes
//       the integer arrival counters of (2) and (3).
//   (2) beta: 64 x 64 tiles of beta = L_inv kmn over k < the tile's last
//       row + 1 (L_inv is lower triangular: half the products of a full
//       GEMM), the longest row blocks launched first. Each block writes the
//       sum of squares of its 64 beta rows per column to partial[row block,
//       j] (float64); the last of a column block's row blocks to arrive (an
//       integer counter decides which, never the order of a sum) sums the
//       column's partials in row-block order and writes w_j, lam and the
//       division in float64: the weight pass of the first design, folded
//       in.
//   (3) SYRK: the lower tiles of dQ, each summed over fixed N-ranges of
//       its samples into split partials in a workspace; the last of a
//       tile's blocks to arrive sums them in sample order and stores each
//       result with row >= col at (row, col) and (col, row), the mirror
//       through shared memory so both stores are coalesced: dQ is exactly
//       symmetric (chol(Q_M) relies on that) and every entry is written
//       once. Float32: 128 x 128 super-tiles, one block an SM with an equal
//       share of the (super-tile, 64-sample panel) units, a segment of
//       panels for each super-tile it meets (ops/fitc.py::fitc_plan: 45
//       super-tiles x 32 panels over 132 blocks at the hotel-0 shape, so no
//       SM waits on a wave the tiles fill in part). The diagonal
//       super-tiles' segments sum dalpha from the same chunks (two threads
//       a row; q <= kDaQ, else one warp a (row, column) pair before the
//       stream). Float64: 64 x 64 tiles, S fixed N-chunks
//       each, and extra blocks for dalpha, one warp per (row, output
//       column) with a fixed-order shuffle reduction over N.
//
// Float32 reads its operands through rings in shared memory that the copy
// engine (TMA) or cp.async (csrc/async_copy.cuh) fill. beta takes float64
// products and sums of the float32 operands on the FP64 tensor cores
// (mma.sync m8n8k4): the weight
// 1 / (lam + var) amplifies beta's rounding by up to 1/var (1e4 on the
// map), and with 3xTF32 products (the tensor cores' FP32 accumulation
// aligns and truncates each step's terms) or SIMT FP32 sums, the map's
// float32 weights were 2-7x further from the float64 update than the
// float32 plain version's (PERF.md). The SYRK runs in 3xTF32 on Hopper's
// warpgroup products (wgmma m64n128k8, csrc/wgmma_tf32.cuh), each 64-deep
// panel summed into a fresh partial and then folded into the running sum
// (the two-level sum that brought the hotel-0 drift from 0.34 to 0.076
// with the first, SIMT kernel); its segment partials are a third level.
// Each block splits its column strip into hi and lo TF32 tiles once, in
// shared memory (the mma.sync kernel before it re-split both operands in
// every warp at every 8-deep step, PERF.md); the weights scale the row
// strip, the register operand, as it is read, rounding kmn * w to float32
// as the plain version does. Float64 keeps SIMT FMAs in the same three
// launches, with a fresh partial per 16-deep step. The TPU kernel's bf16x3
// split was its MXU's counterpart of 3xTF32. Masked samples are dropped by
// the explicit mask rather than by var = +inf, so the result does not
// depend on IEEE inf arithmetic. Any M and N (ragged edges masked here,
// f64 states are not padded).
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda.h>

#include "async_copy.cuh"
#include "family.cuh"
#include "wgmma_tf32.cuh"

namespace egp {

constexpr int kTile = 64;       // tile edge of beta and of dQ
constexpr int kTileElems = kTile * kTile;
constexpr int kTrLd = kTile + 1;  // row stride of a tile transposed in smem
constexpr int kDaPairs = 8;     // dalpha (row, column) pairs per warp

// float32 beta: 4 warps, each 32 x 32 outputs (4 x 4 m8n8 tiles), 32-deep
// k-chunks through a 3-stage cp.async ring
constexpr int kTcThreads = 128;
constexpr int kTcK = 32;
constexpr int kTcStages = 3;
constexpr int kALd = kTcK + 4;   // a row-major staged operand: conflict-free
constexpr int kBLd = kTile + 8;  // beta's k-major staged kmn: conflict-free
constexpr int kBetaStage = kTile * kALd + kTcK * kBLd;        // floats
constexpr int kBetaSmem = kTcStages * kBetaStage * (int)sizeof(float);
static_assert(kBetaStage * kTcStages >= 2 * kTile, "sums fit the ring");

// float32 SYRK: two warpgroups a block on a 128 x 128 super-tile of dQ,
// 32-deep chunks of samples through a 4-stage ring (2 in flight, 2 in use),
// the column strip's hi and lo core tiles double-buffered; one block an SM
constexpr int kSyEdge = 2 * kTile;                    // 128
constexpr int kSyEdgeElems = kSyEdge * kSyEdge;
constexpr int kSyLd = kSyEdge + 1;  // row stride of the summed super-tile
constexpr int kSyThreads = 256;
constexpr int kSyK = kCoreK;                          // samples a chunk (32)
constexpr int kSyStages = 4;
constexpr int kSyStrip = kSyEdge * kSyK;              // a strip's floats
constexpr int kDaQ = 2;  // dalpha's columns the stream carries (more: pairs)
// a ring stage: the row and the column strip (1024-byte aligned, as the
// copy engine's 128-byte swizzle wants), and apart from them the weights
// and y
constexpr int kSyStage = 2 * kSyStrip;
constexpr int kSySmall = kSyK + kSyK * kDaQ;
constexpr int kSyrkSmem =
    (2 * 2 * kSyStrip + kSyStages * (kSyStage + kSySmall)) *
        (int)sizeof(float) +
    1024;  // to align the base
constexpr int kSyMaxSpan = 64;  // super-tiles a block may meet
static_assert(kSyStages * kSyStage >= kSyEdge * kSyLd, "tile fits the ring");

// The float32 SYRK's operands as the copy engine (TMA) reads them: kmn (m x
// n, n % 4 == 0) in 128-row x 32-sample boxes with the 128-byte swizzle
// (the layout of stage_index below), w and y (n q floats) in 32-sample
// boxes; whatever lies past m or n reads as zero.
struct SyrkMaps {
  CUtensorMap kmn, w, y;
};

// float64 SIMT kernels: 16 x 16 threads, 4 x 4 outputs each, 16-deep steps
constexpr int kSimtThreads = 256;
constexpr int kDepth = 16;
constexpr int kSimtSmem = 2 * kDepth * (kTile + 1) * (int)sizeof(double);
constexpr int kSyrk64Smem =
    kSimtSmem > kTile * kTrLd * (int)sizeof(double)
        ? kSimtSmem
        : kTile * kTrLd * (int)sizeof(double);

template <typename T>
__global__ void __launch_bounds__(256)
    kmn_kernel(const T* __restrict__ pseudo, const T* __restrict__ x,
               T* __restrict__ kmn, int* __restrict__ counters, int ncount,
               int m, int n, int d, FamilyConsts<T> fc) {
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < ncount;
         i += blockDim.x * blockDim.y)
      counters[i] = 0;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y * blockDim.y + threadIdx.y;
  if (a >= m || j >= n) return;
  kmn[(size_t)a * n + j] = kernel_entry<T>(fc, pseudo + (size_t)a * d,
                                           x + (size_t)j * d, d);
}

// ---- (2) beta and the weights ----

// The block's column sums are in partial[row block][c0 ..]: the last of the
// column block's row blocks to arrive sums the column's partials in
// row-block order and writes w for its columns. The sums, lam and the
// division are float64 at both dtypes.
template <typename T>
__device__ void weights_if_last(const double* partial,
                                const T* __restrict__ var,
                                const unsigned char* __restrict__ mask,
                                T* __restrict__ w, int* counter, int n,
                                int row_blocks, int c0, int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == row_blocks - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int j = c0 + threadIdx.x;
  if (threadIdx.x >= kTile || j >= n) return;
  double s = 0.0;
  for (int b = 0; b < row_blocks; ++b) s += __ldcg(partial + (size_t)b * n + j);
  double lam = 1.0 - s;
  lam = lam < 0.0 ? 0.0 : lam;  // clamp to the math, NaN passes through
  w[j] = mask[j] ? T(1.0 / (lam + (double)var[j])) : T(0);
}

// c (8 x 8) += a (8 x 4) b (4 x 8) on the FP64 tensor cores; lane 4 g + t
// holds a (g, t), b (t, g) and c (g, 2 t), (g, 2 t + 1)
__device__ __forceinline__ void mma_f64(double c[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// grid (ceil(n / 64), ceil(m / 64)); row block gridDim.y - 1 - blockIdx.y.
// float32 operands, each product exact in float64 and summed in float64 on
// the FP64 tensor cores (m8n8k4): the weights' 1 / (lam + var) amplifies
// beta's rounding by up to 1e4 at the map's variance, and float64 sums keep
// lam to the float32 inputs' own accuracy.
__global__ void __launch_bounds__(kTcThreads)
    beta_tc_kernel(const float* __restrict__ linv,
                   const float* __restrict__ kmn, double* partial,
                   const float* __restrict__ var,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ w, int* counters, int m, int n,
                   int vec_m, int vec_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  __shared__ int last;
  const int rb = gridDim.y - 1 - blockIdx.y;
  const int r0 = rb * kTile;
  const int c0 = blockIdx.x * kTile;
  // L_inv[r][k] = 0 for k > r: the tiles right of the diagonal one are
  // skipped, the diagonal tile's zeros are read and multiplied
  const int kend = min(m, r0 + kTile);
  const int nch = (kend + kTcK - 1) / kTcK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wr = (warp & 1) * 32;
  const int wc = (warp >> 1) * 32;
  auto load = [&](int ch) {
    float* As = ring + (ch % kTcStages) * kBetaStage;
    float* Bs = As + kTile * kALd;
    const int k0 = ch * kTcK;
    cp_tile<float, kTile, kTcK, kALd, kTcThreads>(As, linv, m, r0, k0, m, kend,
                                                  vec_m != 0);
    cp_tile<float, kTcK, kTile, kBLd, kTcThreads>(Bs, kmn, n, k0, c0, kend, n,
                                                  vec_n != 0);
  };
  // the warp's 32 x 32 outputs: rows wr + 8 ri + g, columns wc + 8 ci +
  // 2 tq + e
  double acc[4][4][2];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) acc[ri][ci][0] = acc[ri][ci][1] = 0.0;
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < nch) load(st);
    cp_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait<kTcStages - 2>();
    __syncthreads();
    if (ch + kTcStages - 1 < nch) load(ch + kTcStages - 1);
    cp_commit();
    const float* As = ring + (ch % kTcStages) * kBetaStage;
    const float* Bs = As + kTile * kALd;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 4) {
      double a[4], b[4];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
        a[ri] = As[(wr + 8 * ri + g) * kALd + kk + tq];
#pragma unroll
      for (int ci = 0; ci < 4; ++ci)
        b[ci] = Bs[(kk + tq) * kBLd + wc + 8 * ci + g];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
#pragma unroll
        for (int ci = 0; ci < 4; ++ci) mma_f64(acc[ri][ci], a[ri], b[ci]);
    }
  }
  cp_wait<0>();
  __syncthreads();
  // per column: the sum of squares of the thread's four rows, then over the
  // eight row groups g of the warp (an xor butterfly gives every lane the
  // same bits), then over the two row halves of the tile
  double* red = reinterpret_cast<double*>(ring);  // [2][64]
#pragma unroll
  for (int ci = 0; ci < 4; ++ci)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      double s = 0.0;
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) s += acc[ri][ci][e] * acc[ri][ci][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) red[(warp & 1) * kTile + wc + ci * 8 + 2 * tq + e] = s;
    }
  __syncthreads();
  if (threadIdx.x < kTile && c0 + threadIdx.x < n)
    partial[(size_t)rb * n + c0 + threadIdx.x] =
        red[threadIdx.x] + red[kTile + threadIdx.x];
  weights_if_last<float>(partial, var, mask, w, counters + blockIdx.x, n,
                         gridDim.y, c0, &last);
}

// acc[i][j] += sum_kk As[kk][ty + 16 i] * Bs[kk][tx + 16 j], summed
// first into a fresh partial per 16-deep step (the float64 kernels)
__device__ __forceinline__ void accumulate_step(double (*As)[kTile + 1],
                                                double (*Bs)[kTile + 1],
                                                int tx, int ty,
                                                double (&acc)[4][4]) {
  double part[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    double av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] += av[i] * bv[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

// float64 beta: the same grid and epilogue, SIMT
__global__ void __launch_bounds__(kSimtThreads)
    beta_f64_kernel(const double* __restrict__ linv,
                    const double* __restrict__ kmn, double* partial,
                    const double* __restrict__ var,
                    const unsigned char* __restrict__ mask,
                    double* __restrict__ w, int* counters, int m, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double(*As)[kTile + 1] = reinterpret_cast<double(*)[kTile + 1]>(smem_raw);
  double(*Bs)[kTile + 1] = As + kDepth;
  __shared__ double red[16][kTile];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int rb = gridDim.y - 1 - blockIdx.y;
  const int a0 = rb * kTile;
  const int c0 = blockIdx.x * kTile;
  const int kend = min(m, a0 + kTile);
  double acc[4][4] = {};
  for (int k0 = 0; k0 < kend; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < (kTile * kDepth) / kSimtThreads; ++l) {
      const int idx = tid + kSimtThreads * l;
      const int r = idx / kDepth, kk = idx % kDepth;  // A: row-major rows
      const int gr = a0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < kend) ? linv[(size_t)gr * m + gk] : 0.0;
      const int kb = idx / kTile, c = idx % kTile;    // B: row-major cols
      const int gkb = k0 + kb, gc = c0 + c;
      Bs[kb][c] = (gkb < kend && gc < n) ? kmn[(size_t)gkb * n + gc] : 0.0;
    }
    __syncthreads();
    accumulate_step(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < 4; ++i) s += acc[i][j] * acc[i][j];
    red[ty][tx + 16 * j] = s;
  }
  __syncthreads();
  if (tid < kTile && c0 + tid < n) {
    double s = 0.0;
    for (int t = 0; t < 16; ++t) s += red[t][tid];
    partial[(size_t)rb * n + c0 + tid] = s;
  }
  weights_if_last<double>(partial, var, mask, w, counters + blockIdx.x, n,
                          gridDim.y, c0, &last);
}

// ---- (3) SYRK and dalpha ----

// lower tile b of the tile grid: (tr, tc), tc <= tr, row by row
// (ops/fitc.py::lower_tile mirrors it)
__device__ __forceinline__ void lower_tile(int b, int& tr, int& tc) {
  tr = (int)((sqrt(8.0 * b + 1.0) - 1.0) * 0.5);
  while (tr * (tr + 1) / 2 > b) --tr;
  while ((tr + 1) * (tr + 2) / 2 <= b) ++tr;
  tc = b - tr * (tr + 1) / 2;
}

// Every thread has stored its part of the block's partial tile into ws:
// the last of the tile's S split blocks to arrive sums the S partials in
// split order into Tsh (shared, 64 x kTrLd) and writes the tile's entries
// with row >= col and their mirror, each store coalesced.
template <typename T>
__device__ void finish_tile(const T* ws, int t, int S, int* counter,
                            T* __restrict__ dq, int m, int r0, int q0, T* Tsh,
                            int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == S - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const T* wt = ws + (size_t)t * S * kTileElems;
  for (int e = threadIdx.x; e < kTileElems; e += blockDim.x) {
    T v = T(0);
    for (int s = 0; s < S; ++s) v += __ldcg(wt + (size_t)s * kTileElems + e);
    Tsh[(e / kTile) * kTrLd + e % kTile] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTileElems; e += blockDim.x) {
    const int r = e / kTile;
    const int c = e % kTile;
    // (r0 + r, q0 + c) and the mirror entry (q0 + r, r0 + c)
    if (r0 + r < m && q0 + c < m && r0 + r >= q0 + c)
      dq[(size_t)(r0 + r) * m + q0 + c] = Tsh[r * kTrLd + c];
    if (r0 + c < m && q0 + r < m && r0 + c > q0 + r)
      dq[(size_t)(q0 + r) * m + r0 + c] = Tsh[c * kTrLd + r];
  }
}

// da[a, c] = sum_j (kmn[a, j] w_j) (mask_j ? y[j, c] : 0): one warp per
// (a, c) pair, warps [first, first + total) of the launch's dalpha blocks
template <typename T>
__device__ void dalpha_warps(const T* __restrict__ kmn, const T* __restrict__ w,
                             const T* __restrict__ y,
                             const unsigned char* __restrict__ mask,
                             T* __restrict__ da, int m, int n, int q,
                             long first, long total) {
  const int lane = threadIdx.x & 31;
  for (long pair = first + (threadIdx.x >> 5); pair < (long)m * q;
       pair += total) {
    const int a = (int)(pair / q), c = (int)(pair % q);
    T s = T(0);
    for (int j = lane; j < n; j += 32) {
      const T yv = mask[j] ? y[(size_t)j * q + c] : T(0);
      s += (kmn[(size_t)a * n + j] * w[j]) * yv;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) da[(size_t)a * q + c] = s;
  }
}

struct SyrkGrid {
  int tiles;   // lower 64 x 64 tiles of dQ
  int splits;  // N-chunks per tile
  int chunk;   // samples per chunk, a multiple of 64
  int da_blocks;
};

// The float32 SYRK's grid: the units of work are (super-tile, 64-sample
// panel) pairs, tile by tile and panel by panel; block b takes the units
// [b U / blocks, (b + 1) U / blocks), U = tiles x panels, one segment of
// consecutive panels for each super-tile it meets (at most span of them).
// The strips come through the copy engine where the wrapper says so (n % 4
// == 0, and y on 16 bytes where the stream reads it), else by cp.async.
struct StreamGrid {
  int tiles;   // lower 128 x 128 super-tiles of dQ
  int panels;  // 64-sample panels of N
  int blocks;  // one an SM
  int span;    // ws slots a block
  int copy_engine;
  __device__ __forceinline__ long long units() const {
    return (long long)tiles * panels;
  }
  __device__ __forceinline__ long long first_unit(int b) const {
    return (long long)b * units() / blocks;
  }
  // the block whose units hold unit u
  __device__ __forceinline__ int block_of(long long u) const {
    return (int)(((u + 1) * blocks - 1) / units());
  }
  // the ws slot of super-tile t's segment in block b
  __device__ __forceinline__ long long slot(int b, int t) const {
    return (long long)b * span + t - first_unit(b) / panels;
  }
};

// The copy engine's part of the float32 SYRK: a stage's barrier counts the
// bytes of its boxes; the consumers wait for its phase.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
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

// the box of map at (x, y) into dst, completing on bar
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int x, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// Element (r, k) of a strip (rows of kSyK floats): 16-byte unit k / 4 of
// row r at position (k / 4) ^ (r % 8), the copy engine's 128-byte swizzle,
// so that the fragment reads and the column split below are conflict-free.
__device__ __forceinline__ int stage_index(int r, int k) {
  return r * kSyK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

// Super-tile t's segments are all in ws: sum them in panel order (the
// blocks' order), two segments' sixteen 16-byte loads a thread in flight,
// and write the entries with row >= col from the registers and their
// mirror through Tsh (shared, 128 x kSyLd), each store coalesced; on the
// diagonal, dalpha's rows too.
__device__ void finish_super_tile(const float* ws, const float* da_ws,
                                  const StreamGrid& sg, int t,
                                  float* __restrict__ dq,
                                  float* __restrict__ da, int m, int q,
                                  float* Tsh) {
  int tr, tc;
  lower_tile(t, tr, tc);
  const int r0 = tr * kSyEdge;
  const int q0 = tc * kSyEdge;
  const int b0 = sg.block_of((long long)t * sg.panels);
  const int b1 = sg.block_of((long long)(t + 1) * sg.panels - 1);
  if (da_ws && tr == tc) {  // dalpha's rows r0 .., summed the same way
    for (int e = threadIdx.x; e < kSyEdge * q; e += kSyThreads) {
      float v = 0.f;
      for (int b = b0; b <= b1; ++b)
        v += __ldcg(da_ws + (size_t)sg.slot(b, t) * kSyEdge * q + e);
      if (r0 + e / q < m) da[(size_t)r0 * q + e] = v;
    }
  }
  constexpr int kUnits = kSyEdgeElems / 4 / kSyThreads;
  float4 v[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the segments in order, two at a time in flight
  for (int b = b0; b <= b1; b += 2) {
    const float4* p0 = reinterpret_cast<const float4*>(
        ws + (size_t)sg.slot(b, t) * kSyEdgeElems);
    const float4* p1 = b < b1 ? reinterpret_cast<const float4*>(
                                    ws + (size_t)sg.slot(b + 1, t) *
                                             kSyEdgeElems)
                              : nullptr;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int at = threadIdx.x + u * kSyThreads;
      const float4 x = __ldcg(p0 + at);
      const float4 z = p1 ? __ldcg(p1 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[u].x += x.x;
      v[u].y += x.y;
      v[u].z += x.z;
      v[u].w += x.w;
      if (p1) {
        v[u].x += z.x;
        v[u].y += z.y;
        v[u].z += z.z;
        v[u].w += z.w;
      }
    }
  }
  // entries (r0 + r, q0 + c .. c + 3) with row >= col from the registers,
  // 16-byte stores where all four are; the mirror (q0 + r, r0 + c .. c +
  // 3) of the entries (r0 + c .., q0 + r) with row > col through Tsh
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(dq) % 16 == 0;
  __syncthreads();  // Tsh is free
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int e = 4 * (threadIdx.x + u * kSyThreads);
    const int r = e / kSyEdge, c = e % kSyEdge;
    float* d = Tsh + r * kSyLd + c;
    d[0] = v[u].x;
    d[1] = v[u].y;
    d[2] = v[u].z;
    d[3] = v[u].w;
    const int gr = r0 + r, gc = q0 + c;
    if (gr >= m) continue;
    float* out = dq + (size_t)gr * m + gc;
    if (vec && gc + 3 < m && gr >= gc + 3) {
      *reinterpret_cast<float4*>(out) = v[u];
    } else {
      const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (gc + i < m && gr >= gc + i) out[i] = x[i];
    }
  }
  __syncthreads();
  for (int e = 4 * threadIdx.x; e < kSyEdgeElems; e += 4 * kSyThreads) {
    const int r = e / kSyEdge, c = e % kSyEdge;
    const int gr = q0 + r, gc = r0 + c;
    if (gr >= m) continue;
    const float x[4] = {Tsh[c * kSyLd + r], Tsh[(c + 1) * kSyLd + r],
                        Tsh[(c + 2) * kSyLd + r], Tsh[(c + 3) * kSyLd + r]};
    float* out = dq + (size_t)gr * m + gc;
    if (vec && gc + 3 < m && gc > gr) {
      *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (gc + i < m && gc + i > gr) out[i] = x[i];
    }
  }
}

// float32: 3xTF32 on wgmma (sm_90a), one block an SM, each with an equal
// share of the (super-tile, panel) units (StreamGrid). The block's units
// are one stream of 32-sample chunks, two a panel, through a 4-stage ring
// (two chunks in flight, two in use); a chunk of super-tile t (rows r0 ..
// r0 + 127, columns q0 .. q0 + 127) brings kmn's row strip, its column
// strip, the weights and, on the diagonal, y. kTma (n % 4 == 0, so that
// kmn's rows start on 16 bytes, and y on 16 bytes): one thread has the
// copy engine fetch a chunk as three or four boxes (SyrkMaps), counted on
// the stage's barrier; else every thread copies its part by 4-byte
// cp.async (112 us against 59 at the hotel-0 shape, PERF.md).
//   - the row strip is the register operand: warpgroup w takes rows r0 +
//     64 w .., each thread scales its fragment by the weights (kmn * w
//     rounded to float32, as the plain version) and splits it into hi and
//     lo TF32 parts in registers;
//   - the column strip is the shared-memory operand: the block splits it
//     once, a chunk ahead, into hi and lo tiles in wgmma's core layout,
//     double-buffered, for both warpgroups.
// Each chunk is 12 m64n128k8 products a warpgroup (lo*hi, hi*lo, hi*hi for
// each 8-deep step) into a partial that starts from zero with each 64-deep
// panel and is then added into the running sum by FP32 adds; the copies of
// the chunk three ahead and the split of the next chunk's column strip run
// while the products do. One barrier a chunk: after it the products of the
// chunk before are done (their ring stage and column tiles are refilled).
// At the end of a super-tile's segment the running sum goes to the block's
// ws slot for it and the block arrives on the tile's counter; the last of a
// tile's segments to arrive (the counter decides, and is set back to 0 for
// the next launch) sums the tile after the stream, when the ring is free.
// On a diagonal super-tile the quadrant above the diagonal is computed with
// the rest and not stored, as the upper half of each 64 x 64 diagonal
// tile: wgmma's smallest product is 64 rows deep, and a product under a
// branch serializes the warpgroup's products.
// What bounds it (PERF.md, NVIDIA H100 80GB HBM3): a chunk's products alone
// take ~1.0 us of an SM, and the column split and the A fragments, which
// overlap them little, ~0.7 us more; at the hotel-0 shape ~59 us in all
// against 16.5 us for the lower half's 3xTF32 operations.
template <bool kTma>
__global__ void __launch_bounds__(kSyThreads, 1)
    syrk_tc_kernel(const float* __restrict__ kmn, const float* __restrict__ w,
                   const float* __restrict__ y,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ dq, float* __restrict__ da, float* ws,
                   int* counters, int m, int n, int q, StreamGrid sg,
                   const __grid_constant__ SyrkMaps maps) {
  extern __shared__ __align__(1024) unsigned char sy_smem[];
  float* core = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(sy_smem) + 1023) & ~uintptr_t(1023));
  float* ring = core + 2 * 2 * kSyStrip;            // [stage] rows, column
  float* small = ring + kSyStages * kSyStage;       // [stage] w, y
  __shared__ uint64_t full[kSyStages];
  __shared__ int finish[kSyMaxSpan];  // tiles this block sums, -1 none
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r = wg * 64 + warp * 16 + g;  // the fragments' rows r, r + 8
  // dalpha in the stream (q <= kDaQ): the diagonal super-tiles' segments
  // sum their rows' dalpha from the chunks too, threads 2 a and 2 a + 1 row
  // a of the super-tile, the first and the second half of each chunk's
  // samples, every column, each a fresh partial a panel as the products; at
  // the segment's end the pair adds its two sums (first + second) beside
  // the partial tile in ws (da_ws), and the tile's finisher sums the
  // segments
  float* da_ws = q <= kDaQ ? ws + (size_t)sg.blocks * sg.span * kSyEdgeElems
                           : nullptr;
  const int da_a = threadIdx.x >> 1;
  const int da_s = threadIdx.x & 1;
  float da_part[kDaQ] = {}, da_acc[kDaQ] = {};
  const long long u0 = sg.first_unit(blockIdx.x);
  const int nch = 2 * (int)(sg.first_unit(blockIdx.x + 1) - u0);
  const int t0 = (int)(u0 / sg.panels);
  if (threadIdx.x < kSyMaxSpan) finish[threadIdx.x] = -1;
  if (kTma && threadIdx.x == 0) {
    for (int i = 0; i < kSyStages; ++i) bar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (const CUtensorMap* map : {&maps.kmn, &maps.w, &maps.y})
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
  }
  __syncthreads();
  // Where the stream is: super-tile t = (tr, tc) and its panel p. One
  // cursor for the copies, one for the products; both step a panel at a
  // time, in unit order.
  struct Cursor {
    int t, p, tr, tc;
  };
  Cursor at{t0, (int)(u0 - (long long)t0 * sg.panels), 0, 0};
  lower_tile(t0, at.tr, at.tc);
  auto next_panel = [&](Cursor& x) {
    if (++x.p < sg.panels) return;
    x.p = 0;
    ++x.t;
    if (++x.tc > x.tr) {
      ++x.tr;
      x.tc = 0;
    }
  };
  Cursor ld = at;
  // chunk c (the copies' cursor's panel, half c & 1) into its ring stage:
  // the row strip, the column strip, the weights and (diagonal, dalpha in
  // the stream) y; rows past m and samples past n zero
  auto load_chunk = [&](int c) {
    float* st = ring + (c % kSyStages) * kSyStage;
    float* sm = small + (c % kSyStages) * kSySmall;
    const int k0 = ld.p * kTile + (c & 1) * kSyK;
    const bool with_y = da_ws && ld.tr == ld.tc;
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        uint64_t* bar = full + c % kSyStages;
        bar_expect(bar, (2 * kSyStrip + kSyK + (with_y ? kSyK * q : 0)) *
                            (unsigned)sizeof(float));
        tma_box(st, &maps.kmn, k0, ld.tr * kSyEdge, bar);
        tma_box(st + kSyStrip, &maps.kmn, k0, ld.tc * kSyEdge, bar);
        tma_box(sm, &maps.w, k0, bar);
        if (with_y) tma_box(sm + kSyK, &maps.y, k0 * q, bar);
      }
    } else {
      const int r0 = ld.tr * kSyEdge, q0 = ld.tc * kSyEdge;
      for (int e = threadIdx.x; e < 2 * kSyStrip; e += kSyThreads) {
        const int rr = e / kSyK;
        const int k = e - rr * kSyK;
        const int gr = rr < kSyEdge ? r0 + rr : q0 + rr - kSyEdge;
        const bool ok = gr < m && k0 + k < n;
        cp_async<4>(st + stage_index(rr, k),
                    ok ? kmn + (size_t)gr * n + k0 + k : kmn, ok);
      }
      if (threadIdx.x < kSyK) {
        const bool ok = k0 + (int)threadIdx.x < n;
        cp_async<4>(sm + threadIdx.x, ok ? w + k0 + threadIdx.x : w, ok);
      }
      if (with_y && threadIdx.x < kSyK * q) {
        const bool ok = k0 + (int)threadIdx.x / q < n;
        cp_async<4>(sm + kSyK + threadIdx.x,
                    ok ? y + (size_t)k0 * q + threadIdx.x : y, ok);
      }
      cp_commit();
    }
    if (c & 1) next_panel(ld);  // the panel is in flight: on to the next
  };
  // chunk c is in: its stage's barrier (kTma), else this thread's copies
  // (cp_wait) and the barrier that follows
  auto wait_chunk = [&](int c) {
    if constexpr (kTma) bar_wait(full + c % kSyStages, (c / kSyStages) & 1);
  };
  // chunk c's column strip, landed, split into its hi and lo core tiles:
  // each thread four units of four values; eight consecutive threads the
  // same unit of eight rows (conflict-free both ways)
  auto stage_col = [&](int c) {
    const float* raw = ring + (c % kSyStages) * kSyStage + kSyStrip;
    float* hi = core + (c & 1) * 2 * kSyStrip;
    float* lo = hi + kSyStrip;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int uu = (threadIdx.x >> 5) + 8 * h;
      const int rr = (uu & 15) * 8 + (lane & 7);
      const int k = (uu / 16 * 4 + (lane >> 3)) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(raw + stage_index(rr, k));
      unsigned vh[4], vl[4];
      split_rna(v.x, vh[0], vl[0]);
      split_rna(v.y, vh[1], vl[1]);
      split_rna(v.z, vh[2], vl[2]);
      split_rna(v.w, vh[3], vl[3]);
      const int off = core_index(rr, k);
      *reinterpret_cast<uint4*>(hi + off) =
          make_uint4(vh[0], vh[1], vh[2], vh[3]);
      *reinterpret_cast<uint4*>(lo + off) =
          make_uint4(vl[0], vl[1], vl[2], vl[3]);
    }
    fence_proxy_async();
  };
  for (int st = 0; st < kSyStages - 1; ++st) {
    if (st < nch) {
      load_chunk(st);
    } else if constexpr (!kTma) {
      cp_commit();
    }
  }
  if (!da_ws)  // the block's dalpha pairs while the first chunks come in
    dalpha_warps<float>(kmn, w, y, mask, da, m, n, q,
                        (long)blockIdx.x * (kSyThreads / 32),
                        (long)sg.blocks * (kSyThreads / 32));
  // chunk c's A fragments, kmn * w rounded to float32 and split (the
  // registers of chunk c + 1 are filled while chunk c's products run)
  unsigned ahi[2][4][4], alo[2][4][4];
  auto split_a = [&](int c, unsigned (&hi)[4][4], unsigned (&lo)[4][4]) {
    const float* st = ring + (c % kSyStages) * kSyStage;
    const float* wc = small + (c % kSyStages) * kSySmall;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 8 * kk + tq;
      const float w0 = wc[k];
      const float w1 = wc[k + 4];
      split_rna(__fmul_rn(st[stage_index(r, k)], w0), hi[kk][0], lo[kk][0]);
      split_rna(__fmul_rn(st[stage_index(r + 8, k)], w0), hi[kk][1],
                lo[kk][1]);
      split_rna(__fmul_rn(st[stage_index(r, k + 4)], w1), hi[kk][2],
                lo[kk][2]);
      split_rna(__fmul_rn(st[stage_index(r + 8, k + 4)], w1), hi[kk][3],
                lo[kk][3]);
    }
  };
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  if constexpr (!kTma) cp_wait<kSyStages - 2>();
  wait_chunk(0);
  __syncthreads();
  stage_col(0);
  split_a(0, ahi[0], alo[0]);
  // two chunks a panel: h = c & 1 picks the column tiles and the A
  // registers at compile time
  for (int c0 = 0; c0 < nch; c0 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h;
      if constexpr (!kTma) cp_wait<kSyStages - 3>();  // chunks c, c + 1 in
      __syncthreads();
      const float* hi = core + h * 2 * kSyStrip;
      const float* lo = hi + kSyStrip;
      // the copies of chunk c + 3 (into chunk c - 1's stage, free since the
      // barrier)
      if (c + kSyStages - 1 < nch) {
        load_chunk(c + kSyStages - 1);
      } else if constexpr (!kTma) {
        cp_commit();
      }
      // the products, the small terms first, a panel's first from zero;
      // while they run, the next chunk's column tiles (their buffer was
      // read by chunk c - 1's products) and its A fragments
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_n128(part, alo[h][kk], core_desc(hi, kk), h == 0 && kk == 0);
        wgmma_tf32_n128(part, ahi[h][kk], core_desc(lo, kk), 0);
        wgmma_tf32_n128(part, ahi[h][kk], core_desc(hi, kk), 0);
      }
      wgmma_commit();
      if (da_ws && at.tr == at.tc) {
        // dalpha's terms (kmn w) y of row da_a, the thread's half of the
        // chunk's samples in order, four at a time; a sample whose weight
        // is 0 (masked) adds 0 whatever its y
        const float* st = ring + (c % kSyStages) * kSyStage;
        const float* wc = small + (c % kSyStages) * kSySmall;
        const float* yc = wc + kSyK;
#pragma unroll
        for (int i = 0; i < kSyK / 8; ++i) {
          const int k = 4 * (kSyK / 8 * da_s + i);
          const float4 kv =
              *reinterpret_cast<const float4*>(st + stage_index(da_a, k));
          const float4 wv = *reinterpret_cast<const float4*>(wc + k);
          const float4 y0 = *reinterpret_cast<const float4*>(yc + k * q);
          const float4 y1 = *reinterpret_cast<const float4*>(yc + k * q + 4);
          const float kw[4] = {__fmul_rn(kv.x, wv.x), __fmul_rn(kv.y, wv.y),
                               __fmul_rn(kv.z, wv.z), __fmul_rn(kv.w, wv.w)};
          const bool on[4] = {wv.x != 0.f, wv.y != 0.f, wv.z != 0.f,
                              wv.w != 0.f};
          // y of sample e, column j: element q e + j of y0, y1
          const float ys[8] = {y0.x, y0.y, y0.z, y0.w,
                               y1.x, y1.y, y1.z, y1.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (q == 1) {
              da_part[0] = __fmaf_rn(kw[e], on[e] ? ys[e] : 0.f, da_part[0]);
            } else {
#pragma unroll
              for (int j = 0; j < kDaQ; ++j)
                da_part[j] = __fmaf_rn(kw[e], on[e] ? ys[2 * e + j] : 0.f,
                                       da_part[j]);
            }
          }
        }
      }
      if (c + 1 < nch) {
        wait_chunk(c + 1);
        stage_col(c + 1);
        split_a(c + 1, ahi[1 - h], alo[1 - h]);
      }
      wgmma_wait_all();
    }
    // a 64-deep panel ends: fold it in
    const int c = c0 + 1;
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
#pragma unroll
    for (int i = 0; i < kDaQ; ++i) {
      da_acc[i] += da_part[i];
      da_part[i] = 0.f;
    }
    const int t = at.t;
    const bool diag = at.tr == at.tc;
    next_panel(at);
    if (at.t == t && c + 1 < nch) continue;
    // the segment of super-tile t ends: acc[4 i + e] is row r + 8 (e / 2),
    // column 8 i + 2 tq + e % 2 of its partial
    float* out = ws + (size_t)sg.slot(blockIdx.x, t) * kSyEdgeElems;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * tq;
      *reinterpret_cast<float2*>(out + r * kSyEdge + col) =
          make_float2(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<float2*>(out + (r + 8) * kSyEdge + col) =
          make_float2(acc[4 * i + 2], acc[4 * i + 3]);
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    if (da_ws && diag) {
      float* dout = da_ws + (size_t)sg.slot(blockIdx.x, t) * kSyEdge * q;
#pragma unroll
      for (int i = 0; i < kDaQ; ++i) {
        const float other = __shfl_xor_sync(0xffffffffu, da_acc[i], 1);
        if (i < q && da_s == 0) dout[da_a * q + i] = da_acc[i] + other;
        da_acc[i] = 0.f;
      }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int b0 = sg.block_of((long long)t * sg.panels);
      const int b1 = sg.block_of((long long)(t + 1) * sg.panels - 1);
      if (atomicAdd(counters + t, 1) == b1 - b0) {
        counters[t] = 0;
        finish[t - t0] = t;
      }
    }
  }
  if constexpr (!kTma) cp_wait<0>();
  __syncthreads();
  __threadfence();
  for (int i = 0; i < sg.span; ++i)
    if (finish[i] >= 0)
      finish_super_tile(ws, da_ws, sg, finish[i], dq, da, m, q, ring);
}

// float64 SYRK and dalpha: the same grid and epilogue, SIMT
__global__ void __launch_bounds__(kSimtThreads)
    syrk_f64_kernel(const double* __restrict__ kmn,
                    const double* __restrict__ w,
                    const double* __restrict__ y,
                    const unsigned char* __restrict__ mask,
                    double* __restrict__ dq, double* __restrict__ da,
                    double* ws, int* counters, int m, int n, int q,
                    SyrkGrid sg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double(*As)[kTile + 1] = reinterpret_cast<double(*)[kTile + 1]>(smem_raw);
  double(*Bs)[kTile + 1] = As + kDepth;
  __shared__ int last;
  const int bid = blockIdx.x;
  const int nsyrk = sg.tiles * sg.splits;
  if (bid >= nsyrk) {
    const long wpb = kSimtThreads / 32;
    dalpha_warps<double>(kmn, w, y, mask, da, m, n, q, (bid - nsyrk) * wpb,
                         sg.da_blocks * wpb);
    return;
  }
  const int t = bid / sg.splits;
  const int s = bid % sg.splits;
  int tr, tc;
  lower_tile(t, tr, tc);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int r0 = tr * kTile;
  const int q0 = tc * kTile;
  const int jend = min(n, (s + 1) * sg.chunk);
  double acc[4][4] = {};
  for (int j0 = s * sg.chunk; j0 < jend; j0 += kDepth) {
#pragma unroll
    for (int l = 0; l < (kTile * kDepth) / kSimtThreads; ++l) {
      const int idx = tid + kSimtThreads * l;
      const int r = idx / kDepth, kk = idx % kDepth;
      const int gj = j0 + kk;
      const bool jok = gj < jend;
      const int ga = r0 + r, gb = q0 + r;
      As[kk][r] = (ga < m && jok) ? kmn[(size_t)ga * n + gj] * w[gj] : 0.0;
      Bs[kk][r] = (gb < m && jok) ? kmn[(size_t)gb * n + gj] : 0.0;
    }
    __syncthreads();
    accumulate_step(As, Bs, tx, ty, acc);
    __syncthreads();
  }
  double* out = ws + (size_t)bid * kTileElems;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(ty + 16 * i) * kTile + tx + 16 * j] = acc[i][j];
  __syncthreads();
  finish_tile<double>(ws, t, sg.splits, counters + t, dq, m, r0, q0,
                      reinterpret_cast<double*>(smem_raw), &last);
}

// ---- host side ----

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the kernels' dynamic shared memory beyond 48 KB, opted into once per
// device
static cudaError_t opt_in(int device) {
  static bool done[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(beta_tc_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kBetaSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(syrk_tc_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSyrkSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(syrk_tc_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSyrkSmem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(syrk_f64_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSyrk64Smem)) != cudaSuccess)
    return err;
  done[device] = true;
  return cudaSuccess;
}

static cudaError_t launch_beta(const float* linv, const float* kmn,
                               double* partial, const float* var,
                               const unsigned char* mask, float* w,
                               int* counters, int m, int n, dim3 grid,
                               cudaStream_t stream) {
  const int vec_m = m % 4 == 0 && aligned16(linv);
  const int vec_n = n % 4 == 0 && aligned16(kmn);
  beta_tc_kernel<<<grid, kTcThreads, kBetaSmem, stream>>>(
      linv, kmn, partial, var, mask, w, counters, m, n, vec_m, vec_n);
  return cudaGetLastError();
}

static cudaError_t launch_beta(const double* linv, const double* kmn,
                               double* partial, const double* var,
                               const unsigned char* mask, double* w,
                               int* counters, int m, int n, dim3 grid,
                               cudaStream_t stream) {
  beta_f64_kernel<<<grid, kSimtThreads, kSimtSmem, stream>>>(
      linv, kmn, partial, var, mask, w, counters, m, n);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a float32 map of rank 1 (dims[0] elements) or 2 (dims[1] rows of dims[0],
// row stride dims[0]), boxes of box[] with zeros past the ends
static bool encode(CUtensorMap* map, const float* base, int rank,
                   const cuuint64_t* dims, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  const cuuint64_t stride[1] = {dims[0] * sizeof(float)};
  const cuuint32_t one[2] = {1, 1};
  return fn && fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                  const_cast<float*>(base), dims, stride, box, one,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the copy engine feeds the stream where the wrapper says so
// (sg.copy_engine: n % 4 == 0, and kmn, w and the y it reads start on 16
// bytes), else the threads copy
static cudaError_t launch_syrk(const float* kmn, const float* w,
                               const float* y, const unsigned char* mask,
                               float* dq, float* da, float* ws, int* counters,
                               int m, int n, int q, StreamGrid sg,
                               cudaStream_t stream) {
  SyrkMaps maps{};
  if (sg.copy_engine) {
    if (!aligned16(kmn) || !aligned16(w) || (q <= kDaQ && !aligned16(y)))
      return cudaErrorInvalidValue;
    const cuuint64_t dk[2] = {(cuuint64_t)n, (cuuint64_t)m};
    const cuuint32_t bk[2] = {kSyK, kSyEdge};
    const cuuint64_t dw[1] = {(cuuint64_t)n};
    const cuuint32_t bw[1] = {kSyK};
    const cuuint64_t dy[1] = {(cuuint64_t)n * q};
    const cuuint32_t by[1] = {(cuuint32_t)(kSyK * q)};
    if (!encode(&maps.kmn, kmn, 2, dk, bk, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode(&maps.w, w, 1, dw, bw, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        (q <= kDaQ &&
         !encode(&maps.y, y, 1, dy, by, CU_TENSOR_MAP_SWIZZLE_NONE)))
      return cudaErrorInvalidValue;
    syrk_tc_kernel<true><<<sg.blocks, kSyThreads, kSyrkSmem, stream>>>(
        kmn, w, y, mask, dq, da, ws, counters, m, n, q, sg, maps);
  } else {
    syrk_tc_kernel<false><<<sg.blocks, kSyThreads, kSyrkSmem, stream>>>(
        kmn, w, y, mask, dq, da, ws, counters, m, n, q, sg, maps);
  }
  return cudaGetLastError();
}

static cudaError_t launch_syrk(const double* kmn, const double* w,
                               const double* y, const unsigned char* mask,
                               double* dq, double* da, double* ws,
                               int* counters, int m, int n, int q, SyrkGrid sg,
                               cudaStream_t stream) {
  sg.da_blocks = (int)(((long)m * q + (kSimtThreads / 32) * kDaPairs - 1) /
                       ((kSimtThreads / 32) * kDaPairs));
  syrk_f64_kernel<<<sg.tiles * sg.splits + sg.da_blocks, kSimtThreads,
                    kSyrk64Smem, stream>>>(kmn, w, y, mask, dq, da, ws,
                                           counters, m, n, q, sg);
  return cudaGetLastError();
}

static long lower_tiles(int m, int edge) {
  const long rows = (m + edge - 1) / edge;
  return rows * (rows + 1) / 2;
}

// The SYRK's grid from the plan (ops/fitc.py::fitc_plan), checked. Float32:
// blocks (at most one a unit), span, ws slots a block (at least the
// super-tiles that ceil(units / blocks) consecutive units can meet), and
// whether the copy engine feeds the stream (only where n % 4 == 0).
static bool make_grid(int m, int n, int blocks, int span, int copy_engine,
                      StreamGrid* g) {
  const long tiles = lower_tiles(m, kSyEdge);
  const long panels = (n + kTile - 1) / kTile;
  if (tiles > (1L << 30) || blocks < 1 || blocks > tiles * panels ||
      blocks > (1 << 20) || (copy_engine && n % 4 != 0))
    return false;
  const long per = (tiles * panels + blocks - 1) / blocks;
  if (span < (per + panels - 2) / panels + 1 || span > kSyMaxSpan)
    return false;
  *g = StreamGrid{(int)tiles, (int)panels, blocks, span, copy_engine != 0};
  return true;
}

// Float64: splits of chunk samples over the 64 x 64 tiles, every split
// non-empty, (splits - 1) * chunk < n <= splits * chunk (no third int).
static bool make_grid(int m, int n, int splits, int chunk, int none,
                      SyrkGrid* g) {
  const long tiles = lower_tiles(m, kTile);
  if (none != 0 || splits < 1 || chunk < kTile || chunk % kTile != 0 ||
      (long)(splits - 1) * chunk >= n || (long)splits * chunk < n ||
      tiles * splits > (1L << 30))
    return false;
  *g = SyrkGrid{(int)tiles, splits, chunk, 0};
  return true;
}

template <typename T>
using SyrkGridOf =
    std::conditional_t<std::is_same_v<T, float>, StreamGrid, SyrkGrid>;

// Scratch from the caller (ops/fitc.py): kmn (m, n); partial (ceil(m/64),
// n, float64 at both dtypes); w (n); ws (blocks * span super-tiles and,
// for q <= kDaQ, blocks * span * 128 * q dalpha partials at float32, tiles
// * splits 64 x 64 tiles at float64); counters (ceil(n/64) +
// the SYRK's tiles ints). g0, g1, g2: the SYRK's grid, blocks, span and
// the copy engine at float32, splits, chunk and 0 at float64 (make_grid).
template <typename T>
static int launch_fitc(const T* pseudo, const T* linv, const T* x, const T* y,
                       const T* var, const unsigned char* mask, T* kmn,
                       double* partial, T* w, T* dq, T* da, T* ws, int* counters,
                       int m, int n, int d, int q, int g0, int g1, int g2,
                       int family, int ncomp, const double* coefs,
                       const double* weights, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FamilyConsts<T> fc;
  SyrkGridOf<T> sg;
  if (m <= 0 || n <= 0 || d <= 0 || q <= 0 ||
      !make_family<T>(family, ncomp, coefs, weights, &fc))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (m + kTile - 1) / kTile;
  const int col_blocks = (n + kTile - 1) / kTile;
  if ((m + 7) / 8 > 65535 || row_blocks > 65535 ||
      !make_grid(m, n, g0, g1, g2, &sg))
    return (int)cudaErrorInvalidValue;
  if ((err = opt_in(device)) != cudaSuccess) return (int)err;

  kmn_kernel<T><<<dim3((n + 31) / 32, (m + 7) / 8), dim3(32, 8), 0, stream>>>(
      pseudo, x, kmn, counters, col_blocks + sg.tiles, m, n, d, fc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_beta(linv, kmn, partial, var, mask, w, counters, m, n,
                         dim3(col_blocks, row_blocks), stream)) != cudaSuccess)
    return (int)err;
  return (int)launch_syrk(kmn, w, y, mask, dq, da, ws, counters + col_blocks,
                          m, n, q, sg, stream);
}

// The float32 SYRK and dalpha launch alone, on kmn and w computed
// beforehand, for timing it by itself (ops/fitc.py::fitc_syrk_alone): the
// caller zeroes its super-tiles' arrival counters once (the kernel sets
// each back to 0 when its tile is done).
static int launch_syrk_alone(const float* kmn, const float* w, const float* y,
                             const unsigned char* mask, float* dq, float* da,
                             float* ws, int* counters, int m, int n, int q,
                             int blocks, int span, int copy_engine,
                             int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StreamGrid sg;
  if (m <= 0 || n <= 0 || q <= 0 ||
      !make_grid(m, n, blocks, span, copy_engine, &sg))
    return (int)cudaErrorInvalidValue;
  if ((err = opt_in(device)) != cudaSuccess) return (int)err;
  return (int)launch_syrk(kmn, w, y, mask, dq, da, ws, counters, m, n, q, sg,
                          stream);
}

}  // namespace egp

extern "C" int egp_fitc_syrk_f32(const float* kmn, const float* w,
                                 const float* y, const unsigned char* mask,
                                 float* dq, float* da, float* ws,
                                 int* counters, int m, int n, int q,
                                 int blocks, int span, int copy_engine,
                                 int device, void* stream) {
  return egp::launch_syrk_alone(kmn, w, y, mask, dq, da, ws, counters, m, n,
                                q, blocks, span, copy_engine, device,
                                (cudaStream_t)stream);
}

extern "C" int egp_fitc_f32(const float* pseudo, const float* linv,
                            const float* x, const float* y, const float* var,
                            const unsigned char* mask, float* kmn,
                            double* partial, float* w, float* dq, float* da,
                            float* ws, int* counters, int m, int n, int d,
                            int q, int blocks, int span, int copy_engine,
                            int family, int ncomp, const double* coefs,
                            const double* weights, int device, void* stream) {
  return egp::launch_fitc<float>(pseudo, linv, x, y, var, mask, kmn, partial,
                                 w, dq, da, ws, counters, m, n, d, q, blocks,
                                 span, copy_engine, family, ncomp, coefs,
                                 weights, device, (cudaStream_t)stream);
}

extern "C" int egp_fitc_f64(const double* pseudo, const double* linv,
                            const double* x, const double* y,
                            const double* var, const unsigned char* mask,
                            double* kmn, double* partial, double* w,
                            double* dq, double* da, double* ws, int* counters,
                            int m, int n, int d, int q, int splits, int chunk,
                            int none, int family, int ncomp,
                            const double* coefs, const double* weights,
                            int device, void* stream) {
  return egp::launch_fitc<double>(pseudo, linv, x, y, var, mask, kmn, partial,
                                  w, dq, da, ws, counters, m, n, d, q, splits,
                                  chunk, none, family, ncomp, coefs, weights,
                                  device, (cudaStream_t)stream);
}
