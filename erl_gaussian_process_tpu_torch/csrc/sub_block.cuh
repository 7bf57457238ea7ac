// The 16 x 16 diagonal sub-block of a blocked Cholesky, factored in one
// warp's registers with its inverse alongside; shared by csrc/chol.cu (the
// sub-blocks of each 64 x 64 diagonal tile) and csrc/bank.cu (the diagonal
// tile of each 16-column panel of a bank member). The caller's layout comes
// in as index functors: At[ai(r, c)] and D[di(r, c)] are element (r, c) of
// the sub-block and of its inverse.
#pragma once

#include <cuda_runtime.h>

#include "family.cuh"

namespace egp {

constexpr int kSub = 16;  // the sub-block's edge

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return ::fma(a, b, c);
}

// (o + r) * ld + o + c: a sub-block at offset o of a row-major tile
struct StridedIdx {
  int o;
  int ld;
  __device__ __forceinline__ int operator()(int r, int c) const {
    return (o + r) * ld + o + c;
  }
};

// The sub-block's lower triangle in At, in one warp (lanes 16-31 repeat
// lanes 0-15). Lane r holds row r in registers and the 16 pivots run
// unrolled with shuffles: the pivot row, scaled by 1/sqrt(pivot), is
// broadcast column by column and every row less its multiple of it (one
// shuffle and one FMA a column). Then lane c forms column c of the inverse
// by forward substitution, X[i][c] = (delta_ic - sum_k L[i][k] X[k][c]) /
// L[i][i], reading L back from shared memory. Writes L into At's lower
// triangle (its upper part is neither read nor written) and the whole
// inverse, zeros above the diagonal, into D, which must not overlap At;
// returns false (in every lane) on a non-positive pivot. (Eliminating
// [A | I] instead doubled the work on the serial pivot chain, and a rolled
// step loop ran 2-3x slower, PERF.md.)
template <typename T, typename AIdx, typename DIdx>
__device__ __forceinline__ bool factor_sub_block(T* At, T* D, AIdx ai,
                                                 DIdx di) {
  const int rr = threadIdx.x & 15;
  T a[kSub], inv[kSub];
#pragma unroll
  for (int c = 0; c < kSub; ++c)
    a[c] = c <= rr ? At[ai(rr, c)] : At[ai(c, rr)];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const T d = __shfl_sync(0xffffffffu, a[j], j);
    ok = ok && d > T(0);
    const T s = sqrt_(d);
    inv[j] = T(1) / s;
    const T lr = a[j] * inv[j];
    // every row less its multiple of the scaled pivot row (rows <= j
    // change only their upper part, which is never read)
#pragma unroll
    for (int c = j + 1; c < kSub; ++c)
      a[c] = fma_(-lr, __shfl_sync(0xffffffffu, a[c], j) * inv[j], a[c]);
    a[j] = rr > j ? lr : (rr == j ? s : a[j]);
  }
  if ((threadIdx.x & 31) < kSub) {
#pragma unroll
    for (int c = 0; c < kSub; ++c)
      if (c <= rr) At[ai(rr, c)] = a[c];
  }
  __syncwarp();
  T x[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    T acc = i == rr ? T(1) : T(0);
#pragma unroll
    for (int k = 0; k < i; ++k) acc = fma_(-At[ai(i, k)], x[k], acc);
    x[i] = i >= rr ? acc * inv[i] : T(0);
  }
  if ((threadIdx.x & 31) < kSub) {
#pragma unroll
    for (int i = 0; i < kSub; ++i) D[di(i, rr)] = x[i];
  }
  return ok;
}

}  // namespace egp
