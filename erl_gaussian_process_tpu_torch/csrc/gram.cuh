// Cross-gram K[i, j] = k(x1_i, x2_j) on Hopper, with an optional row mask:
// the kernel and its launch, instantiated for float32 by gram.cu and for
// float64 by gram_f64.cu (two sources that nvcc compiles side by side: the
// 27 instantiations of each dtype take tens of seconds to compile).
//
// Replaces erl_gaussian_process_tpu/ops/pallas_gram.py::_gram_kernel (via
// _pallas_cross_gram_padded / pallas_cross_gram) and the jnp.where that
// kernels/stationary.py::cross_gram applies after it: a row whose mask is
// false is written as exactly 0 without being computed (the semantics of
// where(mask1[:, None], k, 0), NaN inputs included). Its paths: the SPGP
// predict's k(P, x*) at (1152, n_query, d = 3), the exact GP's test k(X, X*)
// (8192 x 4096, d = 2, the state's train mask) and, over a leading member
// axis, the sensor-GP banks' routed predict (688 members of 100 x 128, d =
// 2, the members' sample masks).
//
// What bounds it on an H100: the output write (3.35 TB/s), then the
// special-function units' issue rate, 16 results a clock on each SM: an
// element costs one exp a component plus, for ou and matern32, one square
// root (csrc/family.cuh); at 8192 x 4096 a three-component mixture's 4
// results an element come to ~0.036 ms against the write's 0.040 ms.
//
// Design:
//   - A block of 256 threads computes a 64-row x 128-column output tile.
//     It stages its x1 rows and x2 rows (contiguous in the (m, d) row-major
//     layout, read coalesced) into shared memory as d planes, 8 planes at a
//     time, and its rows' mask bytes.
//   - Each thread holds an 8-row x 4-column micro-tile of squared distances
//     in registers: warp w takes rows 8w .. 8w + 7, lane l columns 4l ..
//     4l + 3; per plane it reads its 4 x2 values in one 16-byte shared load
//     and its 8 x1 values as two broadcast loads, and reuses each across
//     the micro-tile.
//   - d <= 8 is a template parameter (one pass over the planes, unrolled);
//     d > 8 runs the same kernel with a runtime d, 8 planes a pass.
//   - The family is a template parameter (family.cuh's family_value_of), its
//     constants arrive from the host; a masked row skips it (the mask is
//     uniform across the warp, which owns the row).
//   - Each row segment leaves as 16-byte stores (float4; two double2 at
//     f64). A row whose start is not 16-byte aligned (n % 4 != 0 at f32)
//     shifts each lane's store window back by the misalignment and takes
//     the values it lacks from the lane before by a shuffle; lane 0's head
//     and lane 31's tail, and any window past column n, go out as scalar
//     stores.
//   - Plain stores, not streaming ones (st.global.cs): the next product
//     reads the gram, and on the card streaming stores made the gram and
//     that product 3-9% slower at 8192 x 4096 and at 688 x 100 x 128, and
//     at most 0.001 ms faster at 1152 x 2048, than plain ones (PERF.md).
//   - One grid axis flattens (member, row tile, column tile), so a bank of
//     688 small members fills the 132 SMs and any number of members takes
//     one launch. No atomics: two launches give the same bits.
#pragma once

#include <cstddef>
#include <cstdint>

#include "family.cuh"

namespace egp {

constexpr int kGramThreads = 256;
constexpr int kGramRows = 64;       // a block's output rows
constexpr int kGramCols = 128;      // a block's output columns
constexpr int kThreadRows = 8;      // rows of a thread's micro-tile
constexpr int kPlanes = 8;          // coordinate planes staged a pass
constexpr int kLd1 = kGramRows + 4; // plane strides (16-byte multiples)
constexpr int kLd2 = kGramCols + 4;
static_assert(kGramThreads / 32 * kThreadRows == kGramRows, "rows");
static_assert(32 * 4 == kGramCols, "columns");

__device__ __forceinline__ void lds4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void lds4(const double* p, double v[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// four values to a 16-byte aligned p
__device__ __forceinline__ void st4(float* p, const float w[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void st4(double* p, const double w[4]) {
  double2* p2 = reinterpret_cast<double2*>(p);
  p2[0] = make_double2(w[0], w[1]);
  p2[1] = make_double2(w[2], w[3]);
}

// Lane l's values v[0..3] are columns j0 + 4l .. j0 + 4l + 3 of a row. The
// row's elements j0 .. j0 + 127 leave in 16-byte stores: with s the
// elements by which row + j0 misses 16-byte alignment, lane l >= 1 stores
// the window j0 + 4l - s .. j0 + 4l - s + 3, whose first s values lane l - 1
// holds; lane 0 stores its first 4 - s values, lane 31 its last s, one by
// one. Columns >= n are not stored.
template <typename T>
__device__ __forceinline__ void store_row(T* row, int j0, int n, int lane,
                                          const T v[4]) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int s = (int)((reinterpret_cast<uintptr_t>(row + j0) / sizeof(T)) &
                      (kVec - 1));
  T w[4];
  if (s == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = v[e];
  } else {
    T p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __shfl_up_sync(0xffffffffu, v[e], 1);
    if (s == 1) {
      w[0] = p[3]; w[1] = v[0]; w[2] = v[1]; w[3] = v[2];
    } else if (s == 2) {
      w[0] = p[2]; w[1] = p[3]; w[2] = v[0]; w[3] = v[1];
    } else {
      w[0] = p[1]; w[1] = p[2]; w[2] = p[3]; w[3] = v[0];
    }
  }
  const int c0 = j0 + 4 * lane - s;
  if ((lane > 0 || s == 0) && c0 + 4 <= n) {
    st4(row + c0, w);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((lane > 0 || e >= s) && c0 + e < n) row[c0 + e] = w[e];
  }
  if (lane == 31 && s > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e >= 4 - s && j0 + 4 * lane + e < n)
        row[j0 + 4 * lane + e] = v[e];
  }
}

// Block t of the flat grid: member t / (tiles_m * tiles_n), then row tile,
// then column tile. x1 (batch, m, d), x2 (batch, n, d), mask1 (batch, m)
// bytes or null, out (batch, m, n).
template <typename T, int F, int D>
__global__ void __launch_bounds__(kGramThreads)
    gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                const unsigned char* __restrict__ mask1, T* __restrict__ out,
                int m, int n, int d_runtime, int tiles_m, int tiles_n,
                FamilyConsts<T> fc) {
  __shared__ __align__(16) T s1[kPlanes][kLd1];
  __shared__ __align__(16) T s2[kPlanes][kLd2];
  __shared__ unsigned char live[kGramRows];
  const int d = D > 0 ? D : d_runtime;
  const long long t = blockIdx.x;
  const long long per_member = (long long)tiles_m * tiles_n;
  const long long b = t / per_member;
  const int in_member = (int)(t - b * per_member);
  const int i0 = (in_member / tiles_n) * kGramRows;
  const int j0 = (in_member % tiles_n) * kGramCols;
  const int rows = min(kGramRows, m - i0);
  const int cols = min(kGramCols, n - j0);
  x1 += (size_t)b * m * d + (size_t)i0 * d;
  x2 += (size_t)b * n * d + (size_t)j0 * d;
  out += (size_t)b * m * n + (size_t)i0 * n;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid < kGramRows)
    live[tid] = tid < rows &&
                (mask1 == nullptr || mask1[(size_t)b * m + i0 + tid] != 0);

  T r2[kThreadRows][4];
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) r2[r][e] = T(0);

  for (int k0 = 0; k0 < d; k0 += kPlanes) {
    const int kc = D > 0 ? D : min(kPlanes, d - k0);
    if (k0 > 0) __syncthreads();
    for (int idx = tid; idx < kGramRows * kc; idx += kGramThreads) {
      const int r = idx / kc;
      const int k = idx - r * kc;
      s1[k][r] = r < rows ? x1[(size_t)r * d + k0 + k] : T(0);
    }
    for (int idx = tid; idx < kGramCols * kc; idx += kGramThreads) {
      const int c = idx / kc;
      const int k = idx - c * kc;
      s2[k][c] = c < cols ? x2[(size_t)c * d + k0 + k] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < (D > 0 ? D : kPlanes); ++k) {
      if (D == 0 && k >= kc) break;
      T bv[4], a[kThreadRows];
      lds4(&s2[k][4 * lane], bv);
      lds4(&s1[k][kThreadRows * warp], a);
      lds4(&s1[k][kThreadRows * warp + 4], a + 4);
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T diff = a[r] - bv[e];
          r2[r][e] += diff * diff;
        }
    }
  }
  // live[] was written before the staging loop's barrier
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
    const int lr = kThreadRows * warp + r;
    if (lr >= rows) break;
    T v[4];
    if (live[lr]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = family_value_of<F, T>(fc, r2[r][e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = T(0);
    }
    store_row(out + (size_t)lr * n, j0, n, lane, v);
  }
}

template <typename T, int F, int D>
static cudaError_t launch_tiles(const T* x1, const T* x2,
                                const unsigned char* mask1, T* out,
                                long long blocks, int m, int n, int d,
                                int tiles_m, int tiles_n,
                                const FamilyConsts<T>& fc,
                                cudaStream_t stream) {
  gram_kernel<T, F, D><<<(unsigned)blocks, kGramThreads, 0, stream>>>(
      x1, x2, mask1, out, m, n, d, tiles_m, tiles_n, fc);
  return cudaGetLastError();
}

template <typename T, int F>
static cudaError_t launch_dim(const T* x1, const T* x2,
                              const unsigned char* mask1, T* out,
                              long long blocks, int m, int n, int d,
                              int tiles_m, int tiles_n,
                              const FamilyConsts<T>& fc,
                              cudaStream_t stream) {
#define EGP_GRAM_D(DD)                                                    \
  case DD:                                                                \
    return launch_tiles<T, F, DD>(x1, x2, mask1, out, blocks, m, n, d,    \
                                  tiles_m, tiles_n, fc, stream);
  switch (d) {
    EGP_GRAM_D(1)
    EGP_GRAM_D(2)
    EGP_GRAM_D(3)
    EGP_GRAM_D(4)
    EGP_GRAM_D(5)
    EGP_GRAM_D(6)
    EGP_GRAM_D(7)
    EGP_GRAM_D(8)
    default:
      return launch_tiles<T, F, 0>(x1, x2, mask1, out, blocks, m, n, d,
                                   tiles_m, tiles_n, fc, stream);
  }
#undef EGP_GRAM_D
}

template <typename T>
static int launch_gram(const T* x1, const T* x2, const unsigned char* mask1,
                       T* out, int batch, int m, int n, int d, int family,
                       int ncomp, const double* coefs, const double* weights,
                       int device, cudaStream_t stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  FamilyConsts<T> fc;
  if (batch <= 0 || m <= 0 || n <= 0 || d <= 0 ||
      !make_family<T>(family, ncomp, coefs, weights, &fc))
    return (int)cudaErrorInvalidValue;
  const int tiles_m = (m + kGramRows - 1) / kGramRows;
  const int tiles_n = (n + kGramCols - 1) / kGramCols;
  const long long blocks = (long long)batch * tiles_m * tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (family) {
    case kRbf:
      err = launch_dim<T, kRbf>(x1, x2, mask1, out, blocks, m, n, d, tiles_m,
                                tiles_n, fc, stream);
      break;
    case kOu:
      err = launch_dim<T, kOu>(x1, x2, mask1, out, blocks, m, n, d, tiles_m,
                               tiles_n, fc, stream);
      break;
    default:
      err = launch_dim<T, kMatern32>(x1, x2, mask1, out, blocks, m, n, d,
                                     tiles_m, tiles_n, fc, stream);
  }
  return (int)err;
}

}  // namespace egp
