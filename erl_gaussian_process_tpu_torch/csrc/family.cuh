// Kernel-family math shared by every kernel that builds a gram entry
// (gram.cuh, fitc.cu's kmn, bank.cu's tile build, chol.cu's gram tiles).
//
// Replaces erl_gaussian_process_tpu/ops/pallas_gram.py::_apply_family, the
// per-element kernel value every Pallas kernel of the JAX package reuses:
//
//   rbf      : k(r) = exp(-r^2 / (2 s^2))
//   ou       : k(r) = exp(-r / s)
//   matern32 : k(r) = (1 + c r) exp(-c r),  c = sqrt(3) / s
//
// and scale mixtures sum_i w_i k(r; s * ratio_i) with normalized weights.
//
// Constants from the host: a launch takes, per mixture component i, one
// coefficient (rbf -0.5 / s_i^2, ou 1 / s_i, matern32 sqrt(3) / s_i, with
// s_i = scale * ratio_i) and the weight w_i, computed in double on the host
// (ops/gram.py::family_components) and cast to T once, in the launch
// (make_family). The device math then has no division and no double per
// element: rbf one multiply and an exp; ou a square root, a multiply and an
// exp; matern32 a square root, a multiply, an exp and an FMA. The plain
// version (ops/gram.py::apply_family) computes its formulas itself.
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

// A launch's family constants (see above), by value in the kernel's
// parameters.
template <typename T>
struct FamilyConsts {
  int family;
  int ncomp;
  T coef[kMaxComponents];
  T weight[kMaxComponents];
};

// Host side: cast the host's double constants to T. Returns false on a
// family id or component count the device code does not take.
template <typename T>
inline bool make_family(int family, int ncomp, const double* coefs,
                        const double* weights, FamilyConsts<T>* out) {
  if (family < kRbf || family > kMatern32) return false;
  if (ncomp < 1 || ncomp > kMaxComponents) return false;
  out->family = family;
  out->ncomp = ncomp;
  for (int i = 0; i < kMaxComponents; ++i) {
    out->coef[i] = i < ncomp ? (T)coefs[i] : T(0);
    out->weight[i] = i < ncomp ? (T)weights[i] : T(0);
  }
  return true;
}

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return ::exp(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return ::sqrt(v); }

// One component at coefficient c; r = sqrt(r2) (unused by rbf).
template <int F, typename T>
__device__ __forceinline__ T component(T r2, T r, T c) {
  if constexpr (F == kRbf) {
    return exp_(r2 * c);
  } else if constexpr (F == kOu) {
    return exp_(-(r * c));
  } else {
    const T cr = r * c;
    const T e = exp_(-cr);
    return cr * e + e;
  }
}

// a[i] by constant indices only: indexing a kernel parameter's array with
// a variable makes every thread copy the whole struct to local memory first
// (a 72-byte stack frame that tripled the one-entry-a-thread kmn kernel's
// time on the H100). The selects cost only mixtures. Unrolling the
// component loop over kMaxComponents instead (constant indices, no helper,
// but seven guarded branches an element where a single family had one loop
// test) doubled the gram's device time at 8192 x 4096 rbf, slowed kmn by
// 14% and the build by 29 s on the H100.
template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxComponents], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < kMaxComponents; ++k) v = i == k ? a[k] : v;
  return v;
}

// k(r2) of family F: the gram kernel's entry, one instantiation a family.
template <int F, typename T>
__device__ __forceinline__ T family_value_of(const FamilyConsts<T>& fc,
                                             T r2) {
  const T r = F == kRbf ? r2 : sqrt_(r2);
  T out = fc.weight[0] * component<F, T>(r2, r, fc.coef[0]);
  for (int i = 1; i < fc.ncomp; ++i)
    out += pick(fc.weight, i) * component<F, T>(r2, r, pick(fc.coef, i));
  return out;
}

// k(r2) with the family chosen at run time (one uniform branch), for the
// kernels that take the family as an argument.
template <typename T>
__device__ __forceinline__ T family_value(const FamilyConsts<T>& fc, T r2) {
  if (fc.family == kRbf) return family_value_of<kRbf, T>(fc, r2);
  if (fc.family == kOu) return family_value_of<kOu, T>(fc, r2);
  return family_value_of<kMatern32, T>(fc, r2);
}

// k(a, b) for two points of dimension d, stored contiguously.
template <typename T>
__device__ __forceinline__ T kernel_entry(const FamilyConsts<T>& fc,
                                          const T* __restrict__ a,
                                          const T* __restrict__ b, int d) {
  T r2 = T(0);
  for (int k = 0; k < d; ++k) {
    const T diff = a[k] - b[k];
    r2 += diff * diff;
  }
  return family_value<T>(fc, r2);
}

}  // namespace egp
