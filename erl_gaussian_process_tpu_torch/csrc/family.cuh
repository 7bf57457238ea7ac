// Kernel-family math shared by gram.cu and fitc.cu.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_gram.py::_apply_family, the
// per-element kernel value every Pallas kernel of the JAX package reuses:
//
//   rbf      : k(r) = exp(-r^2 / (2 s^2))
//   ou       : k(r) = exp(-r / s)
//   matern32 : k(r) = (1 + c r) exp(-c r),  c = sqrt(3) / s
//
// and scale mixtures sum_i w_i k(r; s * ratio_i) with normalized weights
// (kernels/base.py::mixture_params resolves them on the host; the family
// id, ratios and weights arrive here as a FamilyArgs value).
//
// Precision: full-precision expf/exp and sqrtf/sqrt. The build never uses
// --use_fast_math: __expf would cost accuracy that the FITC weight
// 1/(lambda + var) amplifies. Squared distances use the difference form
// sum_k (a_k - b_k)^2, never |a|^2 + |b|^2 - 2 a.b: far-point padded pseudo
// points sit at coordinates up to ~1e17, where the expanded form cancels
// catastrophically, while the difference form stays finite (< 1e35 in f32)
// and every family maps it to exactly +0.0.
#pragma once

#include <cuda_runtime.h>

namespace egp {

constexpr int kMaxComponents = 8;
enum Family : int { kRbf = 0, kOu = 1, kMatern32 = 2 };

struct FamilyArgs {
  int family;
  int ncomp;
  double ratio[kMaxComponents];
  double weight[kMaxComponents];
};

// Host side: validate and pack the family arguments. Returns false on a
// family id or component count the device code does not take.
inline bool make_family_args(int family, int ncomp, const double* ratios,
                             const double* weights, FamilyArgs* out) {
  if (family < kRbf || family > kMatern32) return false;
  if (ncomp < 1 || ncomp > kMaxComponents) return false;
  out->family = family;
  out->ncomp = ncomp;
  for (int i = 0; i < kMaxComponents; ++i) {
    out->ratio[i] = i < ncomp ? ratios[i] : 1.0;
    out->weight[i] = i < ncomp ? weights[i] : 0.0;
  }
  return true;
}

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return ::exp(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return ::sqrt(v); }

template <typename T>
__device__ __forceinline__ T base_value(int family, T r2, T scale) {
  if (family == kRbf) return exp_(r2 * (T(-0.5) / (scale * scale)));
  const T r = sqrt_(r2);
  if (family == kOu) return exp_(-r / scale);
  const T c = T(1.7320508075688772) / scale;
  const T cr = c * r;
  return (T(1) + cr) * exp_(-cr);
}

template <typename T>
__device__ __forceinline__ T family_value(const FamilyArgs& fa, T r2,
                                          T scale) {
  T out = T(fa.weight[0]) * base_value<T>(fa.family, r2,
                                          scale * T(fa.ratio[0]));
  for (int i = 1; i < fa.ncomp; ++i)
    out += T(fa.weight[i]) * base_value<T>(fa.family, r2,
                                           scale * T(fa.ratio[i]));
  return out;
}

// k(a, b) for two points of dimension d, stored contiguously.
template <typename T>
__device__ __forceinline__ T kernel_entry(const FamilyArgs& fa,
                                          const T* __restrict__ a,
                                          const T* __restrict__ b, int d,
                                          T scale) {
  T r2 = T(0);
  for (int k = 0; k < d; ++k) {
    const T diff = a[k] - b[k];
    r2 += diff * diff;
  }
  return family_value<T>(fa, r2, scale);
}

}  // namespace egp
