// Rank-N FITC update (dQ_M, dalpha) on Hopper.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_fitc.py::_fitc_kernel (via
// _fitc_update_padded / pallas_fitc_update), the hot loop of the SPGP
// occupancy map. For pseudo points P (M, d), L_inv = chol(K_M)^{-1} (M, M)
// and one pose's samples x (N, d), y (N, q), var (N,), mask (N,):
//
//   kmn    = k(P, x)                                   (M, N)
//   beta   = L_inv kmn                                 (M, N)
//   lam_j  = max(1 - ||beta_:j||^2, 0)
//   w_j    = mask_j ? 1 / (lam_j + var_j) : 0
//   dQ     = (kmn diag(w)) kmn^T                       (M, M), symmetric
//   dalpha = (kmn diag(w)) (mask ? y : 0)              (M, q)
//
// What bounds it on an H100: arithmetic. At the hotel-0 shape (M=1152,
// N=2048) the L_inv product is 2 M^2 N = 5.4 GFLOP and the lower half of
// the weighted SYRK another ~2.9 GFLOP, against ~25 MB of operand and
// result traffic: hundreds of FLOP per byte, far above the card's ridge.
//
// Design. The TPU kernel walks N-tiles in order and accumulates into one
// VMEM-resident M x M block, zeroed at grid step 0. Hopper runs blocks in
// parallel and in no order, so the update is split into passes on one
// stream, each a plain SIMT kernel with shared-memory tiles:
//
//   (1) kmn_kernel: kmn into a scratch buffer the wrapper allocates, one
//       thread per element, family math from family.cuh.
//   (2) beta_partial_kernel: 64x64 tiles of beta = L_inv kmn (16-deep
//       k-steps in shared memory, 4x4 outputs per thread); each block
//       writes the sum of squares of its 64 beta rows per column to
//       partial[row_block, j]. Nothing is accumulated across blocks.
//   (3) weight_kernel: w_j from the partials, summed over row blocks in a
//       fixed order. No float atomics anywhere, so the result is the same
//       from run to run (the drift check relies on that).
//   (4) syrk_kernel: only the lower-triangular 64x64 tiles of dQ, with N as
//       the in-block loop; each result with row >= col is stored at
//       (row, col) and (col, row), so dQ is exactly symmetric
//       (chol(Q_M) relies on that) and every entry is written once.
//   (5) dalpha_kernel: one warp per (row, output column), a fixed-order
//       shuffle reduction over N.
//
// Precision: true FP32 (or FP64) FMAs. The TPU kernel's bf16x3 split of
// L_inv and kmn was a workaround for the MXU and is not carried over.
// Masked samples are dropped by the explicit mask rather than by
// var = +inf, so the result does not depend on IEEE inf arithmetic.
// Templated over float and double; any M and N (ragged edges masked here,
// f64 states are not padded).
#include <cstddef>

#include "family.cuh"

namespace egp {

constexpr int kTile = 64;      // output tile edge
constexpr int kDepth = 16;     // k-step held in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(256)
    kmn_kernel(const T* __restrict__ pseudo, const T* __restrict__ x,
               T* __restrict__ kmn, int m, int n, int d, FamilyArgs fa,
               T scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y * blockDim.y + threadIdx.y;
  if (a >= m || j >= n) return;
  kmn[(size_t)a * n + j] = kernel_entry<T>(fa, pseudo + (size_t)a * d,
                                           x + (size_t)j * d, d, scale);
}

// acc[i][j] += sum_kk As[kk][ty + 16 i] * Bs[kk][tx + 16 j], summed
// first into a fresh partial per k-step: a two-level sum whose rounding
// grows with K/16 + 16 terms instead of K (K = 1152 or 2048 here; the FITC
// weight 1/(lambda + var) amplifies the rounding of ||beta||^2).
template <typename T>
__device__ __forceinline__ void accumulate_step(T (*As)[kTile + 1],
                                                T (*Bs)[kTile + 1], int tx,
                                                int ty, T (&acc)[4][4]) {
  T part[4][4] = {};
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk) {
    T av[4], bv[4];
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

// grid (ceil(n/64), ceil(m/64)): partial[blockIdx.y, j] =
//   sum over the block's 64 rows r of (L_inv kmn)[r, j]^2
template <typename T>
__global__ void __launch_bounds__(256)
    beta_partial_kernel(const T* __restrict__ linv, const T* __restrict__ kmn,
                        T* __restrict__ partial, int m, int n) {
  __shared__ T As[kDepth][kTile + 1];
  __shared__ T Bs[kDepth][kTile + 1];
  __shared__ T red[16][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 16 + tx;
  const int a0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  T acc[4][4] = {};
  for (int k0 = 0; k0 < m; k0 += kDepth) {
#pragma unroll
    for (int l = 0; l < (kTile * kDepth) / kThreads; ++l) {
      const int idx = tid + kThreads * l;
      const int r = idx / kDepth, kk = idx % kDepth;  // A: row-major rows
      const int gr = a0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < m) ? linv[(size_t)gr * m + gk] : T(0);
      const int kb = idx / kTile, c = idx % kTile;    // B: row-major cols
      const int gkb = k0 + kb, gc = c0 + c;
      Bs[kb][c] = (gkb < m && gc < n) ? kmn[(size_t)gkb * n + gc] : T(0);
    }
    __syncthreads();
    accumulate_step<T>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) s += acc[i][j] * acc[i][j];
    red[ty][tx + 16 * j] = s;
  }
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      T s = T(0);
      for (int t = 0; t < 16; ++t) s += red[t][c];
      if (c0 + c < n) partial[(size_t)blockIdx.y * n + c0 + c] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    weight_kernel(const T* __restrict__ partial, const T* __restrict__ var,
                  const unsigned char* __restrict__ mask, T* __restrict__ w,
                  int n, int row_blocks) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  T s = T(0);
  for (int b = 0; b < row_blocks; ++b) s += partial[(size_t)b * n + j];
  T lam = T(1) - s;
  lam = lam < T(0) ? T(0) : lam;  // clamp to the math, NaN passes through
  w[j] = mask[j] ? T(1) / (lam + var[j]) : T(0);
}

// One block per lower-triangular 64x64 tile of dQ (tile row >= tile col).
template <typename T>
__global__ void __launch_bounds__(256)
    syrk_kernel(const T* __restrict__ kmn, const T* __restrict__ w,
                T* __restrict__ dq, int m, int n) {
  __shared__ T As[kDepth][kTile + 1];
  __shared__ T Bs[kDepth][kTile + 1];
  const int b = blockIdx.x;
  int tr = (int)((sqrt(8.0 * b + 1.0) - 1.0) * 0.5);
  while (tr * (tr + 1) / 2 > b) --tr;
  while ((tr + 1) * (tr + 2) / 2 <= b) ++tr;
  const int tc = b - tr * (tr + 1) / 2;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 16 + tx;
  const int r0 = tr * kTile, q0 = tc * kTile;
  T acc[4][4] = {};
  for (int j0 = 0; j0 < n; j0 += kDepth) {
#pragma unroll
    for (int l = 0; l < (kTile * kDepth) / kThreads; ++l) {
      const int idx = tid + kThreads * l;
      const int r = idx / kDepth, kk = idx % kDepth;
      const int gj = j0 + kk;
      const bool jok = gj < n;
      const int ga = r0 + r, gb = q0 + r;
      As[kk][r] = (ga < m && jok) ? kmn[(size_t)ga * n + gj] * w[gj] : T(0);
      Bs[kk][r] = (gb < m && jok) ? kmn[(size_t)gb * n + gj] : T(0);
    }
    __syncthreads();
    accumulate_step<T>(As, Bs, tx, ty, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = q0 + tx + 16 * j;
      if (row < m && col < m && row >= col) {
        dq[(size_t)row * m + col] = acc[i][j];
        dq[(size_t)col * m + row] = acc[i][j];
      }
    }
  }
}

// One warp per (a, c): da[a, c] = sum_j (kmn[a, j] w_j) (mask_j ? y[j, c] : 0)
template <typename T>
__global__ void __launch_bounds__(256)
    dalpha_kernel(const T* __restrict__ kmn, const T* __restrict__ w,
                  const T* __restrict__ y,
                  const unsigned char* __restrict__ mask,
                  T* __restrict__ da, int m, int n, int q) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (long)m * q) return;
  const int a = (int)(warp / q), c = (int)(warp % q);
  T s = T(0);
  for (int j = lane; j < n; j += 32) {
    const T yv = mask[j] ? y[(size_t)j * q + c] : T(0);
    s += (kmn[(size_t)a * n + j] * w[j]) * yv;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) da[(size_t)a * q + c] = s;
}

template <typename T>
static int launch_fitc(const T* pseudo, const T* linv, const T* x, const T* y,
                       const T* var, const unsigned char* mask, T* kmn,
                       T* partial, T* w, T* dq, T* da, int m, int n, int d,
                       int q, int family, int ncomp, const double* ratios,
                       const double* weights, double scale, int device,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FamilyArgs fa;
  if (m <= 0 || n <= 0 || d <= 0 || q <= 0 ||
      !make_family_args(family, ncomp, ratios, weights, &fa))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (m + kTile - 1) / kTile;
  const int col_blocks = (n + kTile - 1) / kTile;
  if ((m + 7) / 8 > 65535 || row_blocks > 65535)
    return (int)cudaErrorInvalidValue;

  kmn_kernel<T><<<dim3((n + 31) / 32, (m + 7) / 8), dim3(32, 8), 0, stream>>>(
      pseudo, x, kmn, m, n, d, fa, (T)scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  beta_partial_kernel<T><<<dim3(col_blocks, row_blocks), dim3(16, 16), 0,
                           stream>>>(linv, kmn, partial, m, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  weight_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(partial, var, mask, w,
                                                        n, row_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int lower_tiles = row_blocks * (row_blocks + 1) / 2;
  syrk_kernel<T><<<lower_tiles, dim3(16, 16), 0, stream>>>(kmn, w, dq, m, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long warps = (long)m * q;
  dalpha_kernel<T><<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      kmn, w, y, mask, da, m, n, q);
  return (int)cudaGetLastError();
}

}  // namespace egp

extern "C" int egp_fitc_f32(const float* pseudo, const float* linv,
                            const float* x, const float* y, const float* var,
                            const unsigned char* mask, float* kmn,
                            float* partial, float* w, float* dq, float* da,
                            int m, int n, int d, int q, int family, int ncomp,
                            const double* ratios, const double* weights,
                            double scale, int device, void* stream) {
  return egp::launch_fitc<float>(pseudo, linv, x, y, var, mask, kmn, partial,
                                 w, dq, da, m, n, d, q, family, ncomp, ratios,
                                 weights, scale, device,
                                 (cudaStream_t)stream);
}

extern "C" int egp_fitc_f64(const double* pseudo, const double* linv,
                            const double* x, const double* y,
                            const double* var, const unsigned char* mask,
                            double* kmn, double* partial, double* w,
                            double* dq, double* da, int m, int n, int d, int q,
                            int family, int ncomp, const double* ratios,
                            const double* weights, double scale, int device,
                            void* stream) {
  return egp::launch_fitc<double>(pseudo, linv, x, y, var, mask, kmn, partial,
                                  w, dq, da, m, n, d, q, family, ncomp, ratios,
                                  weights, scale, device,
                                  (cudaStream_t)stream);
}
