// Blocked Cholesky of one large SPD matrix on Hopper, with the inverses of
// the diagonal tiles as a second output.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_chol.py:
//   - _chol_kernel (via _chol_padded / chol_blocked): A read from memory;
//   - _chol_gram_kernel (via _chol_gram_padded / chol_blocked_gram): A =
//     k(x, x) + diag(var), masked rows exact identity rows, built per tile
//     from the coordinates;
//   - _chol_gram_kernel with joint=True (_joint_tile / chol_blocked_gram_joint):
//     A = the joint value/gradient gram of the NIGP, rows [values(n0);
//     d/dx_0 (n0); ...; d/dx_{d-1} (n0)], built per tile from the coordinates
//     and each row's (sample, type) index.
// On the exact-GP path the system is n = 8192 (float32); on the NIGP path
// it is (1 + d) n0 = 7680 (float32) and 7500 (the float64 golden).
//
// What one call computes, left-looking over T x T tiles (T = 64 at both
// dtypes; n needs no padding: indices past n read as identity rows):
//
//   for each column j of tiles:
//     update: P_s[i] = sum_{p in split s} L[i, p] L[j, p]^T  for i >= j
//     diag  : L[j, j], Dinv[j] = factor(A[j, j] - sum_s P_s[j])
//     apply : L[i, j] = (A[i, j] - sum_s P_s[i]) Dinv[j]^T    for i > j
//
// The TPU ran this as one sequential grid with a 4-deep DMA window and
// deferred writes; here the card's blocks run in no order, so each column
// is three launches. A tile of A is only ever built inside the diag and
// apply launches (from memory, or from coordinates for the gram-fused
// variants) and used at once: the (n, n) gram is never written to device
// memory, which is what the left-looking order buys. A right-looking
// trailing update would have to store it.
//
// Bounds on this card: the update holds n^3 / 6 of the n^3 / 6 + O(n^2 T)
// fused multiply-adds, so the factorization is bound by FP32 (FP64) FMA
// throughput, 67 (34) TFLOP/s; the diag launches are a serial chain of n / T
// single-block eliminations that no width hides. Design against both: the
// update splits each column's prefix over several blocks (the split count
// fills ~2 blocks per SM), each block a T x T SIMT tile of 4 x 4 outputs
// per thread from shared memory in 16-byte loads, the next k-chunk loaded
// while the current one is multiplied; the split partials are summed by the
// consumer in a fixed order (no atomics: two calls on one input are bitwise
// equal). The diag's augmented T x 2T tile lives in shared memory, one
// block of 512 threads, one barrier per elimination step; a step's loads
// are issued before its stores. In the exact-GP fit on the H100 a diagonal
// launch took 222 us at T = 128 and 70 us at T = 64 with two barriers a
// step and in-place read-modify-writes, and takes 44 us this way (PERF.md).
// Precision: true FP32 FMA, never TF32, and a two-level sum: each block
// sums one T-wide panel into a fresh partial before adding it to its
// running sum, and the splits are a third level (a single running float32
// sum over 2048 terms broke the FITC drift gate, PERF.md).
//
// The diagonal tile is factored by the augmented elimination [A | I] ->
// [L^T | L^{-1}] of csrc/bank.cu; L^{-1} is Dinv[j], which the apply
// launch uses as it is and the triangular solves slice their block inverses
// from (ops/trsv.py). A pivot that is not positive writes the tile's lower
// part and Dinv[j] as NaN, and NaN then reaches every later column and the
// solve; it is never clamped. The strict upper part of L is written as
// exact zeros by the same launches (no memset).
#include <cmath>
#include <cstddef>

#include "family.cuh"

namespace egp {

constexpr int kTile = 64;             // T: the factorization's tile edge
constexpr int kKc = 16;               // apply: k-chunk staged in shared memory
constexpr int kGemmThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kDiagTx = 32;
constexpr int kDiagTy = 16;
constexpr int kDiagThreads = kDiagTx * kDiagTy;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return ::fma(a, b, c);
}

// ---- tile sources: A(r, c) for r >= c (the lower triangle is read) ----

template <typename T>
struct PlainSource {
  const T* A;
  int n;
  __device__ __forceinline__ T operator()(int r, int c) const {
    if (r < n && c < n) return A[(size_t)r * n + c];
    return r == c ? T(1) : T(0);
  }
};

template <typename T>
struct GramSource {
  const T* x;
  const T* var;
  const unsigned char* mask;
  int n;
  int d;
  FamilyArgs fa;
  T scale;
  __device__ __forceinline__ T operator()(int r, int c) const {
    if (r >= n || c >= n || !(mask[r] && mask[c])) return r == c ? T(1) : T(0);
    T a = kernel_entry<T>(fa, x + (size_t)r * d, x + (size_t)c * d, d, scale);
    if (r == c) a += var[r];
    return a;
  }
};

// Joint row r = type * n0 + sample; type 0 is a value row, type k >= 1 the
// derivative along coordinate k - 1. Closed forms (diff = x_row - x_col,
// kernels/gradient.py): value/value k; value/grad_l dk/dx2_l; grad_k/value
// -dk/dx2_k; grad_k/grad_l d2k/dx1_k dx2_l.
template <typename T>
struct JointSource {
  const T* x;
  const T* var_v;
  const T* var_g;
  const unsigned char* smask;
  const unsigned char* gmask;
  int n0;
  int d;
  int n;  // (1 + d) n0
  int family;
  T scale;
  __device__ __forceinline__ T operator()(int r, int c) const {
    if (r >= n || c >= n) return r == c ? T(1) : T(0);
    const int tr = r / n0, tc = c / n0;
    const int sr = r - tr * n0, sc = c - tc * n0;
    const bool vr = tr == 0 ? smask[sr] != 0 : gmask[sr] != 0;
    const bool vc = tc == 0 ? smask[sc] != 0 : gmask[sc] != 0;
    if (!(vr && vc)) return r == c ? T(1) : T(0);
    const T* xr = x + (size_t)sr * d;
    const T* xc = x + (size_t)sc * d;
    T r2 = T(0), dr = T(0), dc = T(0);
    for (int k = 0; k < d; ++k) {
      const T diff = xr[k] - xc[k];
      r2 += diff * diff;
      if (k + 1 == tr) dr = diff;
      if (k + 1 == tc) dc = diff;
    }
    T out;
    if (family == kRbf) {
      const T inv_s2 = T(1) / (scale * scale);
      const T kv = exp_(r2 * (T(-0.5) * inv_s2));
      const T u = tr > 0 ? -dr * inv_s2 : T(1);
      const T v = tc > 0 ? dc * inv_s2 : T(1);
      const T eq = (tr == tc && tr > 0) ? inv_s2 : T(0);
      out = kv * (u * v + eq);
    } else {  // matern32
      const T cc = T(1.7320508075688772) / scale;
      const T rr = sqrt_(r2);
      const T e = exp_(-cc * rr);
      if (tr > 0 && tc > 0) {
        const T safe = rr > T(0) ? rr : T(1);
        const T eq = tr == tc ? T(1) : T(0);
        out = cc * cc * e * (eq - cc * dr * dc / safe);
      } else if (tr > 0 || tc > 0) {
        const T u = tr > 0 ? -dr : T(1);
        const T v = tc > 0 ? dc : T(1);
        out = cc * cc * u * v * e;
      } else {
        out = (T(1) + cc * rr) * e;
      }
    }
    if (r == c) out += tr == 0 ? var_v[sr] : var_g[sr];
    return out;
  }
};

// ---- update: split partials of the column's prefix products ----

// k-chunk of the update: 32 at float32, 16 at float64 (the two staged
// buffers of both operands then fit the 48 KB of static shared memory)
template <typename T>
struct UpdateChunk {
  static constexpr int kK = sizeof(T) == 4 ? 32 : 16;
};
constexpr int kUpad = 4;  // row padding that keeps 16-byte alignment

// four consecutive values from shared memory in 16-byte loads
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

// ws[s][t] (T x T) = sum over panels p of split s of L[(j+t)T.., pT..]
// L[jT.., pT..]^T, for row tiles t = 0 .. nb - j - 1. Grid (nb - j,
// splits), one T x T tile per block, each thread 4 x 4 neighbouring
// outputs. The next k-chunk is loaded into registers while the current one
// is multiplied from shared memory (two buffers, one barrier a chunk).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    chol_update_kernel(const T* __restrict__ L, T* __restrict__ ws, int n,
                       int j, int pps) {
  constexpr int KU = UpdateChunk<T>::kK;
  constexpr int kLoads = kTile * KU / kGemmThreads;  // per thread, operand
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  __shared__ __align__(16) T As[2][KU][kTile + kUpad];
  __shared__ __align__(16) T Bs[2][KU][kTile + kUpad];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = (j + t) * kTile;
  const int col0 = j * kTile;
  const int kbeg = s * pps * kTile;
  const int kend = min(j, (s + 1) * pps) * kTile;
  T ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + kGemmThreads * i;
      const int r = e / KU;
      const int kk = e - r * KU;
      ra[i] = row0 + r < n ? L[(size_t)(row0 + r) * n + k0 + kk] : T(0);
      rb[i] = col0 + r < n ? L[(size_t)(col0 + r) * n + k0 + kk] : T(0);
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + kGemmThreads * i;
      const int r = e / KU;
      const int kk = e - r * KU;
      As[buf][kk][r] = ra[i];
      Bs[buf][kk][r] = rb[i];
    }
  };
  T acc[4][4], part[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = part[a][b] = T(0);
  if (kbeg < kend) {
    load(kbeg);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += KU) {
    const int kn = k0 + KU;
    if (kn < kend) load(kn);
#pragma unroll
    for (int kk = 0; kk < KU; ++kk) {
      T av[4], bv[4];
      lds4(&As[buf][kk][ty * 4], av);
      lds4(&Bs[buf][kk][tx * 4], bv);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          part[a][b] = fma_(av[a], bv[b], part[a][b]);
    }
    if (kn % kTile == 0) {  // a panel ends: fold its fresh partial in
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] += part[a][b];
          part[a][b] = T(0);
        }
    }
    if (kn < kend) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  T* out = ws + ((size_t)s * gridDim.x + t) * kTile * kTile;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[(ty * 4 + a) * kTile + tx * 4 + b] = acc[a][b];
}

// ---- diag: factor the reduced diagonal tile ----

// [A | E] -> [L^T | L^{-1}] (A's upper triangle, E = I on entry), the
// elimination of csrc/bank.cu with one barrier a step: row j is read
// unscaled by every thread at step j and never written again; its scaled
// copy goes to separate output rows (Lo, Eo), and every product uses the
// same scaled values the in-place form stores, so the result is bitwise
// that of csrc/bank.cu's order. Each thread holds rows ty + kDiagTy * ri
// and columns tx + kDiagTx * ci, and issues all loads of a step before its
// stores (in place, the compiler may not reorder them). Returns false on a
// non-positive pivot; every thread reads the same pivot after the same
// barrier.
template <typename T>
__device__ bool tile_eliminate(T* A, T* E, T* Lo, T* Eo) {
  constexpr int kRows = kTile / kDiagTy;
  constexpr int kCols = kTile / kDiagTx;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (int j = 0; j < kTile; ++j) {
    const T* Aj = A + j * kTile;
    const T* Ej = E + j * kTile;
    const T d = Aj[j];
    if (!(d > T(0))) return false;
    const T s = sqrt_(d);
    const T inv = T(1) / s;
    T aj[kCols], ej[kCols], l[kRows], va[kRows][kCols], ve[kRows][kCols];
#pragma unroll
    for (int ci = 0; ci < kCols; ++ci) {
      aj[ci] = Aj[tx + kDiagTx * ci];
      ej[ci] = Ej[tx + kDiagTx * ci];
    }
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) {
      const int r = ty + kDiagTy * ri;
      l[ri] = Aj[r];
#pragma unroll
      for (int ci = 0; ci < kCols; ++ci) {
        va[ri][ci] = A[r * kTile + tx + kDiagTx * ci];
        ve[ri][ci] = E[r * kTile + tx + kDiagTx * ci];
      }
    }
    if (ty == j % kDiagTy) {
#pragma unroll
      for (int ci = 0; ci < kCols; ++ci) {
        const int c = tx + kDiagTx * ci;
        Lo[j * kTile + c] = c > j ? aj[ci] * inv : (c == j ? s : T(0));
        Eo[j * kTile + c] = c <= j ? ej[ci] * inv : T(0);
      }
    }
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) {
      const int r = ty + kDiagTy * ri;
      if (r <= j) continue;
      const T lr = l[ri] * inv;
#pragma unroll
      for (int ci = 0; ci < kCols; ++ci) {
        const int c = tx + kDiagTx * ci;
        if (c >= r) A[r * kTile + c] = va[ri][ci] - lr * (aj[ci] * inv);
        if (c <= j) E[r * kTile + c] = ve[ri][ci] - lr * (ej[ci] * inv);
      }
    }
    __syncthreads();
  }
  return true;
}

template <typename T, typename Src>
__global__ void __launch_bounds__(kDiagThreads)
    chol_diag_kernel(Src src, T* __restrict__ L, T* __restrict__ Dinv,
                     const T* __restrict__ ws, int n, int j, int nsplit,
                     size_t split_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);
  T* E = A + kTile * kTile;
  T* Lo = E + kTile * kTile;
  T* Eo = Lo + kTile * kTile;
  const int tid = threadIdx.y * kDiagTx + threadIdx.x;
  const int base = j * kTile;
  for (int idx = tid; idx < kTile * kTile; idx += kDiagThreads) {
    const int r = idx / kTile;
    const int c = idx - r * kTile;
    if (c >= r) {  // A[r][c] of the upper triangle = Acc[c][r] of the lower
      T a = src(base + c, base + r);
      for (int s = 0; s < nsplit; ++s) a -= ws[s * split_stride + c * kTile + r];
      A[idx] = a;
    }
    E[idx] = r == c ? T(1) : T(0);
  }
  __syncthreads();
  const bool ok = tile_eliminate<T>(A, E, Lo, Eo);
  __syncthreads();
  const T nan = T(NAN);
  for (int idx = tid; idx < kTile * kTile; idx += kDiagThreads) {
    const int r = idx / kTile;
    const int c = idx - r * kTile;
    const int gr = base + r;
    const int gc = base + c;
    if (gr < n && gc < n)
      L[(size_t)gr * n + gc] = c > r ? T(0) : (ok ? Lo[c * kTile + r] : nan);
    Dinv[(size_t)gr * kTile + c] = ok ? Eo[idx] : nan;
  }
}

// ---- apply: L[i, j] = (A[i, j] - sum_s P_s[i]) Dinv[j]^T ----

template <typename T, typename Src>
__global__ void __launch_bounds__(kGemmThreads)
    chol_apply_kernel(Src src, T* __restrict__ L, const T* __restrict__ Dinv,
                      const T* __restrict__ ws, int n, int j, int nsplit,
                      size_t split_stride) {
  const int t = blockIdx.x + 1;  // row tile j + t, ws tile t
  __shared__ T As[kKc][kTile + 1];
  __shared__ T Bs[kKc][kTile + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = (j + t) * kTile;
  const int col0 = j * kTile;
  const T* wst = ws + (size_t)t * kTile * kTile;
  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);
  for (int k0 = 0; k0 < kTile; k0 += kKc) {
    for (int e = threadIdx.x; e < kTile * kKc; e += kGemmThreads) {
      const int r = e / kKc;
      const int kk = e - r * kKc;
      const int gr = row0 + r;
      T a = T(0);
      if (gr < n) {
        a = src(gr, col0 + k0 + kk);
        const size_t off = (size_t)r * kTile + k0 + kk;
        for (int s = 0; s < nsplit; ++s) a -= wst[s * split_stride + off];
      }
      As[kk][r] = a;
      Bs[kk][r] = Dinv[(size_t)(col0 + r) * kTile + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKc; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fma_(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
  // the column tile j < nb - 1 is full, so every column index is < n
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gr = row0 + ty + 16 * a;
    if (gr >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      L[(size_t)gr * n + col0 + tx + 16 * b] = acc[a][b];
  }
  // the mirrored tile of the strict upper part: exact zeros
  for (int e = threadIdx.x; e < kTile * kTile; e += kGemmThreads) {
    const int r = e / kTile;
    const int c = e - r * kTile;
    if (row0 + c < n) L[(size_t)(col0 + r) * n + row0 + c] = T(0);
  }
}

// ---- host side ----

// Splits of column j's prefix: as many as keep its blocks within one wave
// of ~2 per SM (a few blocks more would take a second wave and double the
// launch's time), each split at least one panel, at most kMaxSplits (the
// diag and apply launches sum the partials of a tile in one block).
// Returns the split count; *pps = panels per split.
constexpr int kMaxSplits = 16;

static int chol_splits(int nb, int j, int sms, int* pps) {
  int ns = 2 * sms / (nb - j);
  if (ns < 1) ns = 1;
  if (ns > kMaxSplits) ns = kMaxSplits;
  if (ns > j) ns = j;
  *pps = (j + ns - 1) / ns;
  return (j + *pps - 1) / *pps;
}

static int device_sms(int device, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

static long long chol_workspace(int n, int sms) {
  const int nb = (n + kTile - 1) / kTile;
  long long most = 1;
  for (int j = 1; j < nb; ++j) {
    int pps = 0;
    const int ns = chol_splits(nb, j, sms, &pps);
    const long long need = (long long)ns * (nb - j) * kTile * kTile;
    if (need > most) most = need;
  }
  return most;
}

template <typename T, typename Src>
static int run_chol(Src src, T* L, T* Dinv, T* ws, int n, int device,
                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int code = device_sms(device, &sms);
  if (code != 0) return code;
  // [A | E] of the diagonal tile and its scaled output rows: 64 KB at
  // float32, 128 KB at float64
  const int smem = 4 * kTile * kTile * (int)sizeof(T);
  err = cudaFuncSetAttribute(chol_diag_kernel<T, Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int nb = (n + kTile - 1) / kTile;
  for (int j = 0; j < nb; ++j) {
    const size_t stride = (size_t)(nb - j) * kTile * kTile;
    int nsplit = 0;
    if (j > 0) {
      int pps = 0;
      nsplit = chol_splits(nb, j, sms, &pps);
      chol_update_kernel<T><<<dim3(nb - j, nsplit), kGemmThreads, 0,
                              stream>>>(L, ws, n, j, pps);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    chol_diag_kernel<T, Src><<<1, dim3(kDiagTx, kDiagTy), smem, stream>>>(
        src, L, Dinv, ws, n, j, nsplit, stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (j < nb - 1) {
      chol_apply_kernel<T, Src><<<nb - j - 1, kGemmThreads, 0, stream>>>(
          src, L, Dinv, ws, n, j, nsplit, stride);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

template <typename T>
static int launch_chol(const T* A, T* L, T* Dinv, T* ws, int n, int device,
                       cudaStream_t stream) {
  PlainSource<T> src{A, n};
  return run_chol<T>(src, L, Dinv, ws, n, device, stream);
}

template <typename T>
static int launch_chol_gram(const T* x, const T* var, const unsigned char* mask,
                            T* L, T* Dinv, T* ws, int n, int d, int family,
                            int ncomp, const double* ratios,
                            const double* weights, double scale, int device,
                            cudaStream_t stream) {
  GramSource<T> src;
  if (d <= 0 || !make_family_args(family, ncomp, ratios, weights, &src.fa))
    return (int)cudaErrorInvalidValue;
  src.x = x;
  src.var = var;
  src.mask = mask;
  src.n = n;
  src.d = d;
  src.scale = (T)scale;
  return run_chol<T>(src, L, Dinv, ws, n, device, stream);
}

template <typename T>
static int launch_chol_joint(const T* x, const T* var_v, const T* var_g,
                             const unsigned char* smask,
                             const unsigned char* gmask, T* L, T* Dinv, T* ws,
                             int n0, int d, int family, double scale,
                             int device, cudaStream_t stream) {
  if (n0 <= 0 || d <= 0 || (family != kRbf && family != kMatern32))
    return (int)cudaErrorInvalidValue;
  JointSource<T> src{x, var_v, var_g, smask, gmask, n0, d, (1 + d) * n0,
                     family, (T)scale};
  return run_chol<T>(src, L, Dinv, ws, (1 + d) * n0, device, stream);
}

}  // namespace egp

// Elements of the split-partial workspace a call at size n needs (at least
// 1), or minus a CUDA error code.
extern "C" long long egp_chol_workspace(int n, int device) {
  int sms = 0;
  const int code = egp::device_sms(device, &sms);
  if (code != 0) return -(long long)code;
  return egp::chol_workspace(n, sms);
}

extern "C" int egp_chol_f32(const float* A, float* L, float* Dinv, float* ws,
                            int n, int device, void* stream) {
  return egp::launch_chol<float>(A, L, Dinv, ws, n, device,
                                 (cudaStream_t)stream);
}

extern "C" int egp_chol_f64(const double* A, double* L, double* Dinv,
                            double* ws, int n, int device, void* stream) {
  return egp::launch_chol<double>(A, L, Dinv, ws, n, device,
                                  (cudaStream_t)stream);
}

extern "C" int egp_chol_gram_f32(const float* x, const float* var,
                                 const unsigned char* mask, float* L,
                                 float* Dinv, float* ws, int n, int d,
                                 int family, int ncomp, const double* ratios,
                                 const double* weights, double scale,
                                 int device, void* stream) {
  return egp::launch_chol_gram<float>(x, var, mask, L, Dinv, ws, n, d, family,
                                      ncomp, ratios, weights, scale, device,
                                      (cudaStream_t)stream);
}

extern "C" int egp_chol_gram_f64(const double* x, const double* var,
                                 const unsigned char* mask, double* L,
                                 double* Dinv, double* ws, int n, int d,
                                 int family, int ncomp, const double* ratios,
                                 const double* weights, double scale,
                                 int device, void* stream) {
  return egp::launch_chol_gram<double>(x, var, mask, L, Dinv, ws, n, d, family,
                                       ncomp, ratios, weights, scale, device,
                                       (cudaStream_t)stream);
}

extern "C" int egp_chol_joint_f32(const float* x, const float* var_v,
                                  const float* var_g,
                                  const unsigned char* smask,
                                  const unsigned char* gmask, float* L,
                                  float* Dinv, float* ws, int n0, int d,
                                  int family, double scale, int device,
                                  void* stream) {
  return egp::launch_chol_joint<float>(x, var_v, var_g, smask, gmask, L, Dinv,
                                       ws, n0, d, family, scale, device,
                                       (cudaStream_t)stream);
}

extern "C" int egp_chol_joint_f64(const double* x, const double* var_v,
                                  const double* var_g,
                                  const unsigned char* smask,
                                  const unsigned char* gmask, double* L,
                                  double* Dinv, double* ws, int n0, int d,
                                  int family, double scale, int device,
                                  void* stream) {
  return egp::launch_chol_joint<double>(x, var_v, var_g, smask, gmask, L, Dinv,
                                        ws, n0, d, family, scale, device,
                                        (cudaStream_t)stream);
}
