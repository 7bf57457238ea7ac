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
//   (3) SYRK: the lower 64 x 64 tiles of dQ, each split over S fixed
//       N-chunks (ops/fitc.py::fitc_plan: up to 3 blocks per SM, 342 blocks
//       at the hotel-0 shape where one block per tile gave 171 on 132
//       SMs);
//       every block writes its partial tile to a workspace, and the last of
//       a tile's S blocks to arrive sums the S partials in split order and
//       stores each result with row >= col at (row, col) and (col, row), the
//       mirror through shared memory so both stores are coalesced: dQ is
//       exactly symmetric (chol(Q_M) relies on that) and every entry is
//       written once. Extra blocks of the same launch compute dalpha, one
//       warp per (row, output column) with a fixed-order shuffle reduction
//       over N.
//
// Float32 reads its operands through a 3-stage cp.async ring
// (csrc/async_copy.cuh). beta takes float64 products and sums of the
// float32 operands on the FP64 tensor cores (mma.sync m8n8k4): the weight
// 1 / (lam + var) amplifies beta's rounding by up to 1/var (1e4 on the
// map), and with 3xTF32 products (the tensor cores' FP32 accumulation
// aligns and truncates each step's terms) or SIMT FP32 sums, the map's
// float32 weights were 2-7x further from the float64 update than the
// float32 plain version's (PERF.md). The SYRK runs in 3xTF32 (mma.sync
// m16n8k8, csrc/mma_tf32.cuh), each 64-deep panel summed into a fresh
// partial and then folded into the running sum (the two-level sum that
// brought the hotel-0 drift from 0.34 to 0.076 with the first, SIMT
// kernel); its split partials are a third level. The weights scale the
// SYRK's left operand as it is read, rounding kmn * w to float32 as the
// plain version does. Float64 keeps SIMT FMAs in the same three launches,
// with a fresh partial per 16-deep step. The TPU kernel's bf16x3 split was
// its MXU's counterpart of 3xTF32. Masked samples are dropped by the
// explicit mask rather than by var = +inf, so the result does not depend
// on IEEE inf arithmetic. Any M and N (ragged edges masked here, f64
// states are not padded).
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "family.cuh"
#include "mma_tf32.cuh"

namespace egp {

constexpr int kTile = 64;       // tile edge of beta and of dQ
constexpr int kTileElems = kTile * kTile;
constexpr int kTrLd = kTile + 1;  // row stride of a tile transposed in smem
constexpr int kDaPairs = 8;     // dalpha (row, column) pairs per warp

// float32 tensor-core kernels: 4 warps, each 32 x 32 outputs (2 x 4 m16n8
// tiles), 32-deep k-chunks through a 3-stage cp.async ring
constexpr int kTcThreads = 128;
constexpr int kTcK = 32;
constexpr int kTcStages = 3;
constexpr int kALd = kTcK + 4;   // a row-major staged operand: conflict-free
constexpr int kBLd = kTile + 8;  // beta's k-major staged kmn: conflict-free
constexpr int kBetaStage = kTile * kALd + kTcK * kBLd;        // floats
constexpr int kSyrkStage = 2 * kTile * kALd + kTcK;           // + weights
constexpr int kBetaSmem = kTcStages * kBetaStage * (int)sizeof(float);
constexpr int kSyrkSmem = kTcStages * kSyrkStage * (int)sizeof(float);
static_assert(kSyrkStage * kTcStages >= kTile * kTrLd, "tile fits the ring");
static_assert(kBetaStage * kTcStages >= 2 * kTile, "sums fit the ring");

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

// blocks [0, tiles * splits): tile b / splits, split b % splits; the rest
// compute dalpha
__global__ void __launch_bounds__(kTcThreads)
    syrk_tc_kernel(const float* __restrict__ kmn, const float* __restrict__ w,
                   const float* __restrict__ y,
                   const unsigned char* __restrict__ mask,
                   float* __restrict__ dq, float* __restrict__ da, float* ws,
                   int* counters, int m, int n, int q, SyrkGrid sg,
                   int vec_n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  __shared__ int last;
  const int bid = blockIdx.x;
  const int nsyrk = sg.tiles * sg.splits;
  if (bid >= nsyrk) {
    const long wpb = kTcThreads / 32;
    dalpha_warps<float>(kmn, w, y, mask, da, m, n, q, (bid - nsyrk) * wpb,
                        sg.da_blocks * wpb);
    return;
  }
  const int t = bid / sg.splits;
  const int s = bid % sg.splits;
  int tr, tc;
  lower_tile(t, tr, tc);
  const int r0 = tr * kTile;
  const int q0 = tc * kTile;
  const int j0 = s * sg.chunk;
  const int jend = min(n, j0 + sg.chunk);
  const int nch = (jend - j0 + kTcK - 1) / kTcK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wr = (warp & 1) * 32;
  const int wc = (warp >> 1) * 32;
  auto load = [&](int ch) {
    float* As = ring + (ch % kTcStages) * kSyrkStage;
    float* Bs = As + kTile * kALd;
    float* Ws = Bs + kTile * kALd;
    const int k0 = j0 + ch * kTcK;
    cp_tile<float, kTile, kTcK, kALd, kTcThreads>(As, kmn, n, r0, k0, m, jend,
                                                  vec_n != 0);
    cp_tile<float, kTile, kTcK, kALd, kTcThreads>(Bs, kmn, n, q0, k0, m, jend,
                                                  vec_n != 0);
    cp_tile<float, 1, kTcK, kTcK, kTcThreads>(Ws, w, n, 0, k0, 1, jend,
                                              vec_n != 0);
  };
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;
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
    const float* As = ring + (ch % kTcStages) * kSyrkStage;
    const float* Bs = As + kTile * kALd;
    const float* Ws = Bs + kTile * kALd;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 8) {
      unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
      const float w0 = Ws[kk + tq];
      const float w1 = Ws[kk + tq + 4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {  // the left operand is kmn * w
        const float* a = As + (wr + mi * 16 + g) * kALd + kk + tq;
        split_tf32(a[0] * w0, ahi[mi][0], alo[mi][0]);
        split_tf32(a[8 * kALd] * w0, ahi[mi][1], alo[mi][1]);
        split_tf32(a[4] * w1, ahi[mi][2], alo[mi][2]);
        split_tf32(a[8 * kALd + 4] * w1, ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* b = Bs + (wc + ni * 8 + g) * kALd + kk + tq;
        split_tf32(b[0], bhi[ni][0], blo[ni][0]);
        split_tf32(b[4], bhi[ni][1], blo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(part[mi][ni], alo[mi], bhi[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(part[mi][ni], ahi[mi], blo[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_tf32(part[mi][ni], ahi[mi], bhi[ni]);
    }
    if ((ch & 1) || ch == nch - 1) {  // a 64-deep panel ends: fold it in
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += part[mi][ni][e];
            part[mi][ni][e] = 0.f;
          }
    }
  }
  cp_wait<0>();
  float* out = ws + (size_t)bid * kTileElems;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wr + mi * 16 + g;
      const int c = wc + ni * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out + r * kTile + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * kTile + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();  // the ring is free: the summed tile goes there
  finish_tile<float>(ws, t, sg.splits, counters + t, dq, m, r0, q0, ring,
                     &last);
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
      (err = cudaFuncSetAttribute(syrk_tc_kernel,
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

static cudaError_t launch_syrk(const float* kmn, const float* w,
                               const float* y, const unsigned char* mask,
                               float* dq, float* da, float* ws, int* counters,
                               int m, int n, int q, SyrkGrid sg,
                               cudaStream_t stream) {
  sg.da_blocks = (int)(((long)m * q + (kTcThreads / 32) * kDaPairs - 1) /
                       ((kTcThreads / 32) * kDaPairs));
  const int vec_n = n % 4 == 0 && aligned16(kmn) && aligned16(w);
  syrk_tc_kernel<<<sg.tiles * sg.splits + sg.da_blocks, kTcThreads, kSyrkSmem,
                   stream>>>(kmn, w, y, mask, dq, da, ws, counters, m, n, q,
                             sg, vec_n);
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

// Scratch from the caller (ops/fitc.py): kmn (m, n); partial (ceil(m/64),
// n, float64 at both dtypes); w (n); ws (tiles * splits * 64^2); counters (ceil(n/64) + tiles
// ints). splits and chunk: the plan's N-split of the SYRK
// (ops/fitc.py::fitc_plan), (splits - 1) * chunk < n <= splits * chunk.
template <typename T>
static int launch_fitc(const T* pseudo, const T* linv, const T* x, const T* y,
                       const T* var, const unsigned char* mask, T* kmn,
                       double* partial, T* w, T* dq, T* da, T* ws, int* counters,
                       int m, int n, int d, int q, int splits, int chunk,
                       int family, int ncomp, const double* coefs,
                       const double* weights, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FamilyConsts<T> fc;
  if (m <= 0 || n <= 0 || d <= 0 || q <= 0 ||
      !make_family<T>(family, ncomp, coefs, weights, &fc))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (m + kTile - 1) / kTile;
  const int col_blocks = (n + kTile - 1) / kTile;
  const int tiles = row_blocks * (row_blocks + 1) / 2;
  if ((m + 7) / 8 > 65535 || row_blocks > 65535 || splits < 1 ||
      chunk < kTile || chunk % kTile != 0 || (long)(splits - 1) * chunk >= n ||
      (long)splits * chunk < n || (long)tiles * splits > (1L << 30))
    return (int)cudaErrorInvalidValue;
  if ((err = opt_in(device)) != cudaSuccess) return (int)err;

  kmn_kernel<T><<<dim3((n + 31) / 32, (m + 7) / 8), dim3(32, 8), 0, stream>>>(
      pseudo, x, kmn, counters, col_blocks + tiles, m, n, d, fc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_beta(linv, kmn, partial, var, mask, w, counters, m, n,
                         dim3(col_blocks, row_blocks), stream)) != cudaSuccess)
    return (int)err;
  SyrkGrid sg{tiles, splits, chunk, 0};
  return (int)launch_syrk(kmn, w, y, mask, dq, da, ws, counters + col_blocks,
                          m, n, q, sg, stream);
}

}  // namespace egp

extern "C" int egp_fitc_f32(const float* pseudo, const float* linv,
                            const float* x, const float* y, const float* var,
                            const unsigned char* mask, float* kmn,
                            double* partial, float* w, float* dq, float* da,
                            float* ws, int* counters, int m, int n, int d,
                            int q, int splits, int chunk, int family,
                            int ncomp, const double* coefs,
                            const double* weights, int device, void* stream) {
  return egp::launch_fitc<float>(pseudo, linv, x, y, var, mask, kmn, partial,
                                 w, dq, da, ws, counters, m, n, d, q, splits,
                                 chunk, family, ncomp, coefs, weights, device,
                                 (cudaStream_t)stream);
}

extern "C" int egp_fitc_f64(const double* pseudo, const double* linv,
                            const double* x, const double* y,
                            const double* var, const unsigned char* mask,
                            double* kmn, double* partial, double* w,
                            double* dq, double* da, double* ws, int* counters,
                            int m, int n, int d, int q, int splits, int chunk,
                            int family, int ncomp, const double* coefs,
                            const double* weights, int device, void* stream) {
  return egp::launch_fitc<double>(pseudo, linv, x, y, var, mask, kmn, partial,
                                  w, dq, da, ws, counters, m, n, d, q, splits,
                                  chunk, family, ncomp, coefs, weights, device,
                                  (cudaStream_t)stream);
}
