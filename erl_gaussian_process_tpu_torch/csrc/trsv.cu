// Triangular solves with few right-hand sides on Hopper: L x = b and
// L^T x = b for one lower-triangular L, with the inverses of its diagonal
// blocks given.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_trsv.py::_fwd_kernel and
// ::_bwd_kernel (via _call / solve_lower / solve_lower_t / cho_solve_vec).
// On the exact-GP and NIGP paths these are the two solves of alpha = K^{-1}
// y after the blocked Cholesky: n = 8192 or 7680 rows, q = 1 column.
//
// What one direction computes, over blocks of B = 64 rows (the Cholesky's
// tile, so its Dinv output serves as it is):
//
//   forward, k = 0 .. nb-1 : x_k = Dinv_k b_k;   b_i -= L[i, k] x_k  (i > k)
//   backward, k = nb-1 .. 0: x_k = Dinv_k^T b_k; b_i -= L[k, i]^T x_k (i < k)
//
// The TPU kept the solution resident in VMEM across one sequential grid.
// The card's blocks run in no order, so here each block k is one launch in
// which every thread block recomputes x_k (B x B x q, a few microseconds of
// work) from the not yet touched rows of block k and then updates only its
// own 64 rows (forward) or columns (backward) of the rest: no cross-block
// reduction, no atomics, so two calls on one input are bitwise equal, and
// each row's sum is a two-level one (a fresh partial per block of B terms).
// The first thread block writes x_k.
//
// Bounds on this card: each direction reads L's lower triangle once (n^2 / 2
// values: 134 MB at n = 8192 float32, ~40 us at 3.35 TB/s) and does n^2 q
// multiply-adds; with nb = n / B dependent steps, one launch each, the solve
// is bound by the launch chain (nb launches of a few microseconds), not by
// the bytes. The L block each thread block needs, and Dinv_k, are staged
// through shared memory so the reads are coalesced. Right-hand sides are taken 32 columns
// per launch; wider b loops over column chunks.
#include <cmath>
#include <cstddef>

#include <cuda_runtime.h>

namespace egp {

constexpr int B = 64;             // rows per block: the Cholesky's tile
constexpr int kTrsvRows = 64;     // rows (columns) each thread block updates
constexpr int kTrsvQc = 32;       // right-hand-side columns per launch
constexpr int kTrsvThreads = 256;

// x_k = Dinv_k b_k (trans: Dinv_k^T b_k) into xk; Dinv_k is first staged
// in Ds (B x (B + 1), reused afterwards for the L block) with coalesced
// loads, so the per-row dot products read shared memory only.
template <typename T>
__device__ __forceinline__ void block_solution(const T* __restrict__ inv,
                                               const T* __restrict__ work,
                                               T* bk, T* xk, T* Ds, int n,
                                               int q, int ldq, int k,
                                               bool trans) {
  const int base = k * B;
  for (int e = threadIdx.x; e < B * q; e += kTrsvThreads) {
    const int r = e / q;
    const int c = e - r * q;
    bk[e] = base + r < n ? work[(size_t)(base + r) * ldq + c] : T(0);
  }
  for (int e = threadIdx.x; e < B * B; e += kTrsvThreads) {
    const int r = e / B;
    Ds[r * (B + 1) + e - r * B] = inv[(size_t)base * B + e];
  }
  __syncthreads();
  // Dinv_k is lower triangular: row r has entries t <= r, column r t >= r
  for (int e = threadIdx.x; e < B * q; e += kTrsvThreads) {
    const int r = e / q;
    const int c = e - r * q;
    T s = T(0);
    if (trans) {
      for (int t = r; t < B; ++t) s += Ds[t * (B + 1) + r] * bk[t * q + c];
    } else {
      for (int t = 0; t <= r; ++t) s += Ds[r * (B + 1) + t] * bk[t * q + c];
    }
    xk[e] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kTrsvThreads)
    trsv_fwd_kernel(const T* __restrict__ L, const T* __restrict__ inv,
                    T* __restrict__ work, T* __restrict__ x, int n, int q,
                    int ldq, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bk = reinterpret_cast<T*>(smem_raw);
  T* xk = bk + B * kTrsvQc;
  T* Ls = xk + B * kTrsvQc;  // kTrsvRows x (B + 1)
  block_solution<T>(inv, work, bk, xk, Ls, n, q, ldq, k, false);
  const int base = k * B;
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < B * q; e += kTrsvThreads) {
      const int r = e / q;
      if (base + r < n) x[(size_t)(base + r) * ldq + e - r * q] = xk[e];
    }
  }
  const int row0 = base + B + blockIdx.x * kTrsvRows;
  if (row0 >= n) return;
  for (int e = threadIdx.x; e < kTrsvRows * B; e += kTrsvThreads) {
    const int r = e / B;
    const int t = e - r * B;
    const int gr = row0 + r;
    Ls[r * (B + 1) + t] =
        gr < n && base + t < n ? L[(size_t)gr * n + base + t] : T(0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTrsvRows * q; e += kTrsvThreads) {
    const int r = e / q;
    const int c = e - r * q;
    const int gr = row0 + r;
    if (gr >= n) continue;
    T s = T(0);
    for (int t = 0; t < B; ++t) s += Ls[r * (B + 1) + t] * xk[t * q + c];
    work[(size_t)gr * ldq + c] -= s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTrsvThreads)
    trsv_bwd_kernel(const T* __restrict__ L, const T* __restrict__ inv,
                    T* __restrict__ work, T* __restrict__ x, int n, int q,
                    int ldq, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bk = reinterpret_cast<T*>(smem_raw);
  T* xk = bk + B * kTrsvQc;
  T* Ls = xk + B * kTrsvQc;  // B x (kTrsvRows + 1)
  block_solution<T>(inv, work, bk, xk, Ls, n, q, ldq, k, true);
  const int base = k * B;
  if (blockIdx.x == 0) {
    for (int e = threadIdx.x; e < B * q; e += kTrsvThreads) {
      const int r = e / q;
      if (base + r < n) x[(size_t)(base + r) * ldq + e - r * q] = xk[e];
    }
  }
  const int col0 = blockIdx.x * kTrsvRows;
  if (col0 >= base) return;
  // rows base .. base + B of L, columns col0 .. col0 + 64 (all < base)
  for (int e = threadIdx.x; e < B * kTrsvRows; e += kTrsvThreads) {
    const int t = e / kTrsvRows;
    const int i = e - t * kTrsvRows;
    Ls[t * (kTrsvRows + 1) + i] = base + t < n && col0 + i < base
                                      ? L[(size_t)(base + t) * n + col0 + i]
                                      : T(0);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTrsvRows * q; e += kTrsvThreads) {
    const int i = e / q;
    const int c = e - i * q;
    const int gi = col0 + i;
    if (gi >= base) continue;
    T s = T(0);
    for (int t = 0; t < B; ++t) s += Ls[t * (kTrsvRows + 1) + i] * xk[t * q + c];
    work[(size_t)gi * ldq + c] -= s;
  }
}

template <typename T>
static int launch_trsv(const T* L, const T* inv, T* work, T* x, int n, int q,
                       bool trans, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || q <= 0) return (int)cudaErrorInvalidValue;
  // the L block, kTrsvRows x (B + 1) forward and B x (kTrsvRows + 1)
  // backward, and before it Dinv_k, B x (B + 1)
  const int smem =
      (2 * B * kTrsvQc + (kTrsvRows + 1) * (B + 1)) * (int)sizeof(T);
  auto kernel = trans ? trsv_bwd_kernel<T> : trsv_fwd_kernel<T>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + B - 1) / B;
  for (int c0 = 0; c0 < q; c0 += kTrsvQc) {
    const int qc = q - c0 < kTrsvQc ? q - c0 : kTrsvQc;
    for (int s = 0; s < nb; ++s) {
      const int k = trans ? nb - 1 - s : s;
      const int rest = trans ? k * B : n - (k + 1) * B;
      const int grid = rest > 0 ? (rest + kTrsvRows - 1) / kTrsvRows : 1;
      kernel<<<grid, kTrsvThreads, smem, stream>>>(L, inv, work + c0, x + c0,
                                                    n, qc, q, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace egp

// work holds b on entry (n x q, row-major) and is overwritten; x receives
// the solution. trans = 0 solves L x = b, 1 solves L^T x = b.
extern "C" int egp_trsv_f32(const float* L, const float* inv, float* work,
                            float* x, int n, int q, int trans, int device,
                            void* stream) {
  return egp::launch_trsv<float>(L, inv, work, x, n, q, trans != 0, device,
                                 (cudaStream_t)stream);
}

extern "C" int egp_trsv_f64(const double* L, const double* inv, double* work,
                            double* x, int n, int q, int trans, int device,
                            void* stream) {
  return egp::launch_trsv<double>(L, inv, work, x, n, q, trans != 0, device,
                                  (cudaStream_t)stream);
}
