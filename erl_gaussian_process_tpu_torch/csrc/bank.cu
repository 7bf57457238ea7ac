// Bank fit and bank Cholesky on Hopper: B small exact GPs factored at once.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_bank.py::_fit_kernel (via
// _fit_raw / bank_fit_fused) and ::_chol_kernel (via _chol_raw /
// bank_cholesky_solve_fused). On the 3D range-sensor GP's path every scan
// is one bank fit of (rows x cols) partitions: 736 members of n = 100 at the
// reference lidar protocol.
//
// What one member computes, for the gram A (n x n) and E = I:
//
//   fit : A = k(x, x) + diag(var), masked rows and columns exact identity
//         rows (the TPU kernel's far-point padding, here an explicit mask)
//   chol: A = the given gram, read from its lower triangle
//
// then the augmented right-looking elimination [A | E] -> [L^T | L^{-1}] in
// the order of pallas_bank.py::_elimination, for j = 0 .. n-1:
//
//   s = sqrt(A[j][j]);  row j of [A | E] /= s;  A[j][j] = s
//   rows r > j:  [A | E][r] -= A[j][r] * [A | E][j]
//
// Design: one thread block per member, no float atomics and no cross-block
// reduction, so a member's factor is bit for bit the same whatever batch it
// is fit in. The trailing block of A stays exactly symmetric (a product of
// two floats is commutative), so only its upper triangle is updated and the
// multiplier of row r is the already scaled A[j][r]: the same values the TPU
// kernel's lane-reduced column gives, with half the work. E stays exactly
// lower triangular, so its update runs over columns 0..j only. The slab
// lives in dynamic shared memory when 2 n^2 values fit in the card's opt-in
// per-block limit (227 KB on an H100: n <= 170 in float32, n <= 120 in
// float64) and in the outputs themselves (global memory) beyond that; one
// code path serves both. A pivot that is not positive makes the whole member NaN, as
// rsqrt does on the TPU and as the plain version's failed Cholesky does; it
// is never clamped. alpha = K^{-1} y is two batched products against L^{-1}
// outside the kernel, as in the JAX package.
//
// The TPU design's members-per-step G, 128-lane padding, size gate and
// opt-in rank-2 elimination were VMEM/VPU tuning and are not carried over.
#include <cmath>
#include <cstddef>

#include "family.cuh"

namespace egp {

constexpr int kBankTx = 32;
constexpr int kBankTy = 8;
constexpr int kBankThreads = kBankTx * kBankTy;

// Augmented elimination of one member: A and E are n x n, row-major, E = I
// on entry; only A's upper triangle (diagonal included) is read. On exit
// A's upper triangle holds L^T and E holds L^{-1}. Returns false when a
// pivot is not positive; every thread reads the same pivot after the same
// barrier, so all threads return together.
template <typename T>
__device__ bool eliminate(T* A, T* E, int n) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kBankTx + tx;
  for (int j = 0; j < n; ++j) {
    T* Aj = A + (size_t)j * n;
    T* Ej = E + (size_t)j * n;
    const T d = Aj[j];
    if (!(d > T(0))) return false;
    const T s = sqrt_(d);
    const T inv = T(1) / s;
    for (int c = tid; c < n; c += kBankThreads) {
      if (c > j)
        Aj[c] *= inv;
      else
        Ej[c] *= inv;
    }
    __syncthreads();
    if (tid == 0) Aj[j] = s;
    for (int r = j + 1 + ty; r < n; r += kBankTy) {
      const T l = Aj[r];
      T* Ar = A + (size_t)r * n;
      T* Er = E + (size_t)r * n;
      for (int c = r + tx; c < n; c += kBankTx) Ar[c] -= l * Aj[c];
      for (int c = tx; c <= j; c += kBankTx) Er[c] -= l * Ej[c];
    }
    __syncthreads();
  }
  return true;
}

// Write one member's L (lower, zeros above) and L^{-1}. With the slab in
// shared memory A/E are copied out; otherwise A is L's own storage and its
// upper triangle is moved into the lower one in place (each pair (i, k),
// i > k, is owned by one thread, so nothing races).
template <typename T>
__device__ void finish(const T* A, const T* E, T* L, T* Linv, int n, bool ok,
                       bool in_smem) {
  const int tid = threadIdx.y * kBankTx + threadIdx.x;
  const size_t nn = (size_t)n * n;
  if (!ok) {
    const T nan = T(NAN);
    for (size_t idx = tid; idx < nn; idx += kBankThreads) {
      L[idx] = nan;
      Linv[idx] = nan;
    }
    return;
  }
  for (size_t idx = tid; idx < nn; idx += kBankThreads) {
    const int i = (int)(idx / n);
    const int k = (int)(idx - (size_t)i * n);
    if (in_smem) {
      L[idx] = k <= i ? A[(size_t)k * n + i] : T(0);
      Linv[idx] = E[idx];
    } else if (i > k) {
      const T v = L[(size_t)k * n + i];
      L[idx] = v;
      L[(size_t)k * n + i] = T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBankThreads)
    bank_fit_kernel(const T* __restrict__ x, const T* __restrict__ var,
                    const unsigned char* __restrict__ mask, T* L, T* Linv,
                    int n, int d, FamilyArgs fa, T scale, bool in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n * n;
  T* Lb = L + b * nn;
  T* Linvb = Linv + b * nn;
  T* A = in_smem ? reinterpret_cast<T*>(smem_raw) : Lb;
  T* E = in_smem ? A + nn : Linvb;
  const T* xb = x + b * n * d;
  const T* vb = var + b * n;
  const unsigned char* mb = mask + b * n;
  const int tid = threadIdx.y * kBankTx + threadIdx.x;
  for (size_t idx = tid; idx < nn; idx += kBankThreads) {
    const int i = (int)(idx / n);
    const int k = (int)(idx - (size_t)i * n);
    if (k >= i) {
      T a;
      if (mb[i] && mb[k]) {
        a = kernel_entry<T>(fa, xb + (size_t)i * d, xb + (size_t)k * d, d,
                            scale);
        if (i == k) a += vb[i];
      } else {
        a = i == k ? T(1) : T(0);
      }
      A[idx] = a;
    }
    E[idx] = i == k ? T(1) : T(0);
  }
  __syncthreads();
  const bool ok = eliminate<T>(A, E, n);
  __syncthreads();
  finish<T>(A, E, Lb, Linvb, n, ok, in_smem);
}

template <typename T>
__global__ void __launch_bounds__(kBankThreads)
    bank_chol_kernel(const T* __restrict__ K, T* L, T* Linv, int n,
                     bool in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n * n;
  T* Lb = L + b * nn;
  T* Linvb = Linv + b * nn;
  T* A = in_smem ? reinterpret_cast<T*>(smem_raw) : Lb;
  T* E = in_smem ? A + nn : Linvb;
  const T* Kb = K + b * nn;
  const int tid = threadIdx.y * kBankTx + threadIdx.x;
  // row k of K, coalesced; its lower part is column k of A's upper part
  for (size_t idx = tid; idx < nn; idx += kBankThreads) {
    const int k = (int)(idx / n);
    const int i = (int)(idx - (size_t)k * n);
    if (i <= k) A[(size_t)i * n + k] = Kb[idx];
    E[idx] = i == k ? T(1) : T(0);
  }
  __syncthreads();
  const bool ok = eliminate<T>(A, E, n);
  __syncthreads();
  finish<T>(A, E, Lb, Linvb, n, ok, in_smem);
}

// Shared memory of one member's slab if it fits the card's opt-in per-block
// limit, else 0 (the slab then lives in the outputs).
template <typename T, typename Kernel>
static int slab_smem(Kernel kernel, int n, int device, size_t* bytes) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t need = 2 * (size_t)n * n * sizeof(T);
  *bytes = need <= (size_t)limit ? need : 0;
  if (*bytes > 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
static int launch_bank_fit(const T* x, const T* var, const unsigned char* mask,
                           T* L, T* Linv, int batch, int n, int d, int family,
                           int ncomp, const double* ratios,
                           const double* weights, double scale, int device,
                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FamilyArgs fa;
  if (batch <= 0 || n <= 0 || d <= 0 ||
      !make_family_args(family, ncomp, ratios, weights, &fa))
    return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int code = slab_smem<T>(bank_fit_kernel<T>, n, device, &bytes);
  if (code != 0) return code;
  bank_fit_kernel<T><<<batch, dim3(kBankTx, kBankTy), bytes, stream>>>(
      x, var, mask, L, Linv, n, d, fa, (T)scale, bytes > 0);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bank_chol(const T* K, T* L, T* Linv, int batch, int n,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const int code = slab_smem<T>(bank_chol_kernel<T>, n, device, &bytes);
  if (code != 0) return code;
  bank_chol_kernel<T><<<batch, dim3(kBankTx, kBankTy), bytes, stream>>>(
      K, L, Linv, n, bytes > 0);
  return (int)cudaGetLastError();
}

}  // namespace egp

extern "C" int egp_bank_fit_f32(const float* x, const float* var,
                                const unsigned char* mask, float* L,
                                float* Linv, int batch, int n, int d,
                                int family, int ncomp, const double* ratios,
                                const double* weights, double scale,
                                int device, void* stream) {
  return egp::launch_bank_fit<float>(x, var, mask, L, Linv, batch, n, d,
                                     family, ncomp, ratios, weights, scale,
                                     device, (cudaStream_t)stream);
}

extern "C" int egp_bank_fit_f64(const double* x, const double* var,
                                const unsigned char* mask, double* L,
                                double* Linv, int batch, int n, int d,
                                int family, int ncomp, const double* ratios,
                                const double* weights, double scale,
                                int device, void* stream) {
  return egp::launch_bank_fit<double>(x, var, mask, L, Linv, batch, n, d,
                                      family, ncomp, ratios, weights, scale,
                                      device, (cudaStream_t)stream);
}

extern "C" int egp_bank_chol_f32(const float* K, float* L, float* Linv,
                                 int batch, int n, int device, void* stream) {
  return egp::launch_bank_chol<float>(K, L, Linv, batch, n, device,
                                      (cudaStream_t)stream);
}

extern "C" int egp_bank_chol_f64(const double* K, double* L, double* Linv,
                                 int batch, int n, int device, void* stream) {
  return egp::launch_bank_chol<double>(K, L, Linv, batch, n, device,
                                       (cudaStream_t)stream);
}
