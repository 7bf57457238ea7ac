// Bank fit and bank Cholesky on Hopper: B small exact GPs factored at once.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_bank.py::_fit_kernel (via
// _fit_raw / bank_fit_fused) and ::_chol_kernel (via _chol_raw /
// bank_cholesky_solve_fused). On the 3D range-sensor GP's path every scan
// is one bank fit of (rows x cols) partitions: 736 members of n = 100 at the
// reference lidar protocol, 408 of n = 144 at the default-grouped scan;
// BatchGPBank.solve factors (1000, 104).
//
// What one member computes, for the gram A (n x n) and y (n x q): L (lower,
// zeros above), L^{-1} and alpha = A^{-1} y_hat, where
//
//   fit : A = k(x, x) + diag(var), masked rows and columns exact identity
//         rows (the TPU kernel's far-point padding, here an explicit mask
//         that need not be a prefix); y_hat is y with masked rows zeroed
//   chol: A = the given gram, read from its lower triangle; y_hat = y
//
// A pivot that is not positive makes the whole member NaN (L, L^{-1} and
// alpha), as rsqrt does on the TPU and as the plain version's failed
// Cholesky does; it is never clamped. alpha is formed in the kernel from the
// member's final L^{-1}, w = L^{-1} y_hat then alpha = L^{-T} w, in FP32 (or
// FP64) SIMT FMAs in a fixed order. No float atomics and no cross-member
// reduction: a member's L, L^{-1} and alpha are bit for bit the same
// whatever bank they are computed in (the JAX package's two batched
// products outside the kernel, on cuBLAS, picked their algorithm by the
// batch count).
//
// Two designs, picked per call by the host (ops/bank.py::bank_chol_plan):
//
// (1) The augmented elimination (float64, and float32 members whose tiles do
//     not fit a block's shared memory, n > 320 on an H100): one thread block
//     per member, [A | E] -> [L^T | L^{-1}] right-looking in the order of
//     pallas_bank.py::_elimination, for j = 0 .. n-1:
//
//       s = sqrt(A[j][j]);  row j of [A | E] /= s;  A[j][j] = s
//       rows r > j:  [A | E][r] -= A[j][r] * [A | E][j]
//
//     The trailing block of A stays exactly symmetric (a product of two
//     floats is commutative), so only its upper triangle is updated and the
//     multiplier of row r is the already scaled A[j][r]: the same values the
//     TPU kernel's lane-reduced column gives, with half the work. E stays
//     exactly lower triangular, so its update runs over columns 0..j only.
//     The slab lives in dynamic shared memory when 2 n^2 values fit in the
//     card's opt-in per-block limit (227 KB on an H100: n <= 170 in
//     float32, n <= 120 in float64) and in the outputs themselves (global
//     memory) beyond that; one code path serves both. It is latency-bound:
//     a chain of n pivots with two block barriers each.
//
// (2) The blocked factorization (float32 bank fit and bank Cholesky): one
//     warp per member, several members per block, the member padded to P =
//     ceil(n / 16) tiles a side with identity rows (which leave the leading
//     n x n factor exactly as it is) and only its P (P + 1) / 2 lower 16 x 16
//     tiles held in shared memory (28 KB at n = 104). The tiles come from one
//     of two sources, the only difference between the two entries:
//       - TileFromK (bank Cholesky): cp.async copies of the gram's tiles;
//       - TileBuilt (bank fit): each entry built in place from the member's
//         x, var and mask with family.cuh's kernel_entry, all tiles but the
//         last diagonal one in a loop of their own before the panels (the
//         family math is not live beside the fragment code).
//     For each 16-column panel k, right-looking:
//       - the diagonal tile factored in the warp's registers by shuffles,
//         its inverse alongside (csrc/sub_block.cuh, as csrc/chol.cu's
//         diagonal sub-blocks), L_kk written out and Inv_kk kept in its slot;
//       - the panel below, L[i, k] = A[i, k] Inv_kk^T;
//       - the trailing lower tiles, A[i, j] -= L[i, k] L[j, k]^T, each a
//         fresh 16-deep product subtracted from A (a two-level sum);
//     every product in 3xTF32 on the tensor cores (csrc/mma_tf32.cuh). The
//     chain is P panel steps instead of n pivots, with no block barrier.
//     L^{-1} is then formed in place row by row: M[i, p] = Inv_ii L[i, p],
//     X[i, k] = -sum_{k <= p < i} M[i, p] X[p, k] for k ascending (X[k, k] =
//     Inv_kk), each X[i, k] over the slot of M[i, k], which no later k reads.
//     The factor's scratch tile is a slot whose contents are already in the
//     output (the last diagonal tile, loaded or built after the first panel,
//     then the sub-diagonal tile of the panel before, restored from L before
//     the inversion), so no slot beyond the lower triangle is held. Every
//     tile of L, of L^{-1} and of the zeros above their diagonals is stored
//     as soon as it is final, so the stores drain while the warp computes;
//     alpha then reads L^{-1} from the member's tiles, w held in alpha's own
//     output until alpha overwrites it block by block.
//     Bound on the card: bytes (L and L^{-1} written, K read for the bank
//     Cholesky: 0.0178 ms at B = 736, n = 100 for the fit); the tensor-core
//     work is a small part of it. What holds it above that is the serial
//     panel chain of each warp, hidden by as many members an SM as fit.
//
// The TPU design's members-per-step G, 128-lane padding, size gate and
// opt-in rank-2 elimination were VMEM/VPU tuning and are not carried over.
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "family.cuh"
#include "mma_tf32.cuh"
#include "sub_block.cuh"

namespace egp {

constexpr int kBankTx = 32;
constexpr int kBankTy = 8;
constexpr int kBankThreads = kBankTx * kBankTy;
constexpr unsigned kFull = 0xffffffffu;

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
// i > k, is owned by one thread, so nothing races). A failed member is NaN
// in L, L^{-1} and alpha.
template <typename T>
__device__ void finish(const T* A, const T* E, T* L, T* Linv, T* alpha,
                       int n, int q, bool ok, bool in_smem) {
  const int tid = threadIdx.y * kBankTx + threadIdx.x;
  const size_t nn = (size_t)n * n;
  if (!ok) {
    const T nan = T(NAN);
    for (size_t idx = tid; idx < nn; idx += kBankThreads) {
      L[idx] = nan;
      Linv[idx] = nan;
    }
    for (size_t idx = tid; idx < (size_t)n * q; idx += kBankThreads)
      alpha[idx] = nan;
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

// alpha = E^T (E y_hat) for one member from its final E = L^{-1} (shared or
// global memory), y_hat = y with the rows where mask is 0 zeroed (mask may
// be null: no row masked). w = E y_hat goes to alpha's own storage: one
// warp a row, its lanes over the row's columns, then a fixed-order xor
// butterfly (every lane ends with the same bits). alpha = E^T w then in
// chunks of the block's threads, ascending: chunk [c0, c0 + 256) reads w_i
// for i >= c0 only, so it overwrites w there once every thread has read.
template <typename T>
__device__ void alpha_from_inverse(const T* E, const T* __restrict__ y,
                                   const unsigned char* __restrict__ mask,
                                   T* alpha, int n, int q) {
  const int tid = threadIdx.y * kBankTx + threadIdx.x;
  const int lane = threadIdx.x;
  for (int col = 0; col < q; ++col) {
    for (int r = threadIdx.y; r < n; r += kBankTy) {
      T s = T(0);
      for (int c = lane; c <= r; c += kBankTx)
        if (!mask || mask[c])
          s = fma_(E[(size_t)r * n + c], y[(size_t)c * q + col], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) alpha[(size_t)r * q + col] = s;
    }
    __syncthreads();
    for (int c0 = 0; c0 < n; c0 += kBankThreads) {
      const int c = c0 + tid;
      T s = T(0);
      if (c < n)
        for (int i = c; i < n; ++i)
          s = fma_(E[(size_t)i * n + c], alpha[(size_t)i * q + col], s);
      __syncthreads();
      if (c < n) alpha[(size_t)c * q + col] = s;
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBankThreads)
    bank_fit_kernel(const T* __restrict__ x, const T* __restrict__ var,
                    const unsigned char* __restrict__ mask,
                    const T* __restrict__ y, T* L, T* Linv, T* alpha, int n,
                    int d, int q, FamilyConsts<T> fc, bool in_smem) {
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
        a = kernel_entry<T>(fc, xb + (size_t)i * d, xb + (size_t)k * d, d);
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
  T* ab = alpha + b * n * q;
  finish<T>(A, E, Lb, Linvb, ab, n, q, ok, in_smem);
  if (!ok) return;
  __syncthreads();
  alpha_from_inverse<T>(E, y + b * n * q, mb, ab, n, q);
}

template <typename T>
__global__ void __launch_bounds__(kBankThreads)
    bank_chol_kernel(const T* __restrict__ K, const T* __restrict__ y, T* L,
                     T* Linv, T* alpha, int n, int q, bool in_smem) {
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
  T* ab = alpha + b * n * q;
  finish<T>(A, E, Lb, Linvb, ab, n, q, ok, in_smem);
  if (!ok) return;
  __syncthreads();
  alpha_from_inverse<T>(E, y + b * n * q, nullptr, ab, n, q);
}

// ---- (2) the blocked float32 member factorization ----

constexpr int kPt = kSub;  // the panel and tile edge
constexpr int kPtElems = kPt * kPt;
constexpr int kMaxMembers = 8;  // members (warps) per block

// Element (r, c) of a 16 x 16 tile in shared memory: row-major, the columns
// XOR-swizzled by row pair, so that an m16n8k8 fragment read (rows g and
// g + 8, columns tq and tq + 4) hits 32 distinct banks. Four aligned
// neighbours in a row stay four aligned neighbours.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kPt + (c ^ (((r >> 1) & 3) << 2));
}
struct SwzIdx {
  __device__ __forceinline__ int operator()(int r, int c) const {
    return swz(r, c);
  }
};

// slot of the lower tile (i, j), j <= i, in a member's packed slab
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// A lane's fragment offsets in a swizzled tile, the same for every tile:
// row g (row g + 8 is + 128; the two m16n8 tiles of a B^T operand are rows
// g and g + 8 of Y, + 128 too), so every fragment read is one shared load
// at a register plus an immediate.
struct Frag {
  int a[4];      // A (and B^T): row g, columns tq, tq + 4, tq + 8, tq + 12
  int b[2][2];   // B: rows tq (+ 8: + 128) and tq + 4 (+ 8), column nb 8 + g
  int c[2];      // C: row g, columns nb 8 + 2 tq (+ 1)
  __device__ __forceinline__ Frag() {
    const int g = (threadIdx.x & 31) >> 2;
    const int tq = threadIdx.x & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = swz(g, tq + 4 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) b[h][nb] = swz(tq + 4 * h, nb * 8 + g);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) c[nb] = swz(g, nb * 8 + 2 * tq);
  }
};

// hi/lo A fragments of the 8 columns kk.. (kk = 0 or 8) of tile X
__device__ __forceinline__ void a_frag(const Frag& f, const float* X, int kk,
                                      unsigned hi[4], unsigned lo[4]) {
  const int q = kk / 4;
  split_tf32(X[f.a[q]], hi[0], lo[0]);
  split_tf32(X[f.a[q] + 128], hi[1], lo[1]);
  split_tf32(X[f.a[q + 1]], hi[2], lo[2]);
  split_tf32(X[f.a[q + 1] + 128], hi[3], lo[3]);
}

// hi/lo B fragments, depth kk.., of both m16n8 tiles of op(Y): B(k, n) =
// Y(n, k) when kT (the product X Y^T), Y(k, n) otherwise (X Y)
template <bool kT>
__device__ __forceinline__ void b_frag(const Frag& f, const float* Y, int kk,
                                       unsigned hi[2][2], unsigned lo[2][2]) {
  const int q = kk / 4;
  const int r = kk == 0 ? 0 : 128;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) {
    if (kT) {
      split_tf32(Y[f.a[q] + 128 * nb], hi[nb][0], lo[nb][0]);
      split_tf32(Y[f.a[q + 1] + 128 * nb], hi[nb][1], lo[nb][1]);
    } else {
      split_tf32(Y[f.b[0][nb] + r], hi[nb][0], lo[nb][0]);
      split_tf32(Y[f.b[1][nb] + r], hi[nb][1], lo[nb][1]);
    }
  }
}

// c += one 16 x 16 x 8 step in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float c[2][4], const unsigned ahi[4],
                                     const unsigned alo[4], unsigned bhi[2][2],
                                     unsigned blo[2][2]) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) mma_tf32(c[nb], alo, bhi[nb]);
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) mma_tf32(c[nb], ahi, blo[nb]);
#pragma unroll
  for (int nb = 0; nb < 2; ++nb) mma_tf32(c[nb], ahi, bhi[nb]);
}

// c += X op(Y) over 16 x 16 tiles
template <bool kT>
__device__ __forceinline__ void tile_mma(const Frag& f, const float* X,
                                         const float* Y, float c[2][4]) {
#pragma unroll
  for (int kk = 0; kk < kPt; kk += 8) {
    unsigned ahi[4], alo[4], bhi[2][2], blo[2][2];
    a_frag(f, X, kk, ahi, alo);
    b_frag<kT>(f, Y, kk, bhi, blo);
    mma3(c, ahi, alo, bhi, blo);
  }
}

// offset of C fragment element e of m16n8 tile nb
__device__ __forceinline__ int c_off(const Frag& f, int nb, int e) {
  return f.c[nb] + (e & 1) + 128 * (e >> 1);
}

// the warp's C fragments into tile T, times sign
__device__ __forceinline__ void store_frag(const Frag& f, float* T,
                                           const float c[2][4], float sign) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) T[c_off(f, nb, e)] = sign * c[nb][e];
}

// tile (i, j) of a member's row-major n x n matrix M into shared tile t by
// cp.async, entries past n zero: 16-byte copies when n % 4 == 0 (vec)
__device__ __forceinline__ void load_tile(float* t, const float* M, int n,
                                          int i, int j, bool vec) {
  const int lane = threadIdx.x & 31;
  const int step = vec ? 4 : 1;
  for (int e = lane * step; e < kPtElems; e += 32 * step) {
    const int r = e / kPt;
    const int c = e % kPt;
    const int gr = i * kPt + r;
    const int gc = j * kPt + c;
    const bool ok = gr < n && gc < n;
    const float* src = ok ? M + (size_t)gr * n + gc : M;
    if (vec)
      cp_async<16>(t + swz(r, c), src, ok);
    else
      cp_async<4>(t + swz(r, c), src, ok);
  }
}

// M[tile (i, j)] = v(r, c), entries past n skipped; float4 stores when vec
template <typename F>
__device__ __forceinline__ void store_tile(float* M, int n, int i, int j,
                                           bool vec, F v) {
  const int lane = threadIdx.x & 31;
  const int step = vec ? 4 : 1;
  for (int e = lane * step; e < kPtElems; e += 32 * step) {
    const int r = e / kPt;
    const int c = e % kPt;
    const int gr = i * kPt + r;
    const int gc = j * kPt + c;
    if (gr >= n || gc >= n) continue;
    float* dst = M + (size_t)gr * n + gc;
    if (vec)
      *reinterpret_cast<float4*>(dst) =
          make_float4(v(r, c), v(r, c + 1), v(r, c + 2), v(r, c + 3));
    else
      *dst = v(r, c);
  }
}

// the identity padding of the last diagonal tile
__device__ __forceinline__ void pad_identity(float* t, int n, int last) {
  const int lane = threadIdx.x & 31;
  if (lane < kPt && last * kPt + lane >= n) t[swz(lane, lane)] = 1.f;
}

// The bank Cholesky's tile source: the gram's tiles by cp.async (the caller
// commits and waits).
struct TileFromK {
  const float* K;  // the member's n x n gram
  int n;
  bool vec;
  __device__ __forceinline__ void operator()(float* t, int i, int j) const {
    load_tile(t, K, n, i, j, vec);
  }
};

// The bank fit's tile source: tile (i, j) of the gram built in place.
// Entry (gr, gc), gr >= gc, is k(x_gr, x_gc) + [gr == gc] var_gr when both
// rows are unmasked, [gr == gc] when either is masked, and the identity
// past n; the upper part of a diagonal tile, which the factorization never
// reads, is 0. Reads x, var and mask of rows < n of this member only (rows
// past n read row n - 1 and discard it). Lane l builds column l % 16 of
// the tile, rows l / 16 + 2 k for k = 0 .. 7, the eight entries side by
// side with no branch around their loads and math (kernel_entry's sums in
// its order, family.cuh's family_value): one entry at a time behind its
// mask test left each lane's chain of loads and special functions exposed,
// and the build took half of a member's time on the card (PERF.md).
struct TileBuilt {
  const float* x;  // the member's (n, d)
  const float* var;
  const unsigned char* mask;
  int n;
  int d;
  FamilyConsts<float> fc;
  __device__ __forceinline__ void operator()(float* t, int i, int j) const {
    constexpr int kRows = kPtElems / 32;
    const int lane = threadIdx.x & 31;
    const int c = lane & 15;
    const int gc = j * kPt + c;
    const int cc = gc < n ? gc : n - 1;
    const bool col = gc < n && __ldg(mask + cc);
    int rows[kRows];
    float r2[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int gr = i * kPt + (lane >> 4) + 2 * k;
      rows[k] = gr < n ? gr : n - 1;
      r2[k] = 0.f;
    }
    for (int e = 0; e < d; ++e) {
      const float xc = __ldg(x + (size_t)cc * d + e);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float diff = __ldg(x + (size_t)rows[k] * d + e) - xc;
        r2[k] += diff * diff;
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = (lane >> 4) + 2 * k;
      const int gr = i * kPt + r;
      const float kv = family_value<float>(fc, r2[k]);
      const bool both = col && gr < n && __ldg(mask + rows[k]);
      float a = gr == gc ? 1.f : 0.f;
      if (both && (i != j || c <= r))
        a = gr == gc ? kv + __ldg(var + rows[k]) : kv;
      t[swz(r, c)] = a;
    }
  }
};

// One member's L, L^{-1} and alpha by one warp (design (2) above). S is the
// member's slab of P (P + 1) / 2 tiles (plus one scratch tile when P = 1),
// src fills a tile, y (n, q) and mask (n, or null) give y_hat.
template <typename Src>
__device__ __forceinline__ void factor_member(
    const Src src, float* S, float* Lb, float* Xb, const float* yb,
    const unsigned char* mb, float* ab, int n, int q, int P, bool vec) {
  const int lane = threadIdx.x & 31;
  auto tile = [&](int i, int j) { return S + tri(i, j) * kPtElems; };
  const size_t nn = (size_t)n * n;
  const int last = P - 1;
  const Frag f;
  auto zero = [](int, int) { return 0.f; };

  // the lower tiles; the last diagonal one waits while its slot is the
  // first panel's scratch
  for (int i = 0; i < P; ++i)
    for (int j = 0; j <= i; ++j)
      if (P == 1 || j != last) src(tile(i, j), i, j);
  cp_commit();
  cp_wait<0>();
  __syncwarp();
  if (P == 1) {
    pad_identity(tile(0, 0), n, 0);
    __syncwarp();
  }

  bool ok = true;
  for (int k = 0; k < P; ++k) {
    float* Dk = tile(k, k);
    float* scratch = P == 1 ? S + kPtElems
                            : (k == 0 ? tile(last, last) : tile(k, k - 1));
    ok = factor_sub_block<float>(Dk, scratch, SwzIdx{}, SwzIdx{});
    if (!ok) break;  // the pivot was shuffled to every lane: warp-uniform
    __syncwarp();
    store_tile(Lb, n, k, k, vec, [&](int r, int c) {
      return c <= r ? Dk[swz(r, c)] : 0.f;
    });
    __syncwarp();
    for (int e = lane; e < kPtElems; e += 32) Dk[e] = scratch[e];  // Inv_kk
    __syncwarp();
    if (k == 0 && P > 1) {
      src(tile(last, last), last, last);
      cp_commit();
    }
    // the panel: L[i, k] = A[i, k] Inv_kk^T
    for (int i = k + 1; i < P; ++i) {
      float* T = tile(i, k);
      float c[2][4] = {};
      tile_mma<true>(f, T, Dk, c);
      __syncwarp();
      store_frag(f, T, c, 1.f);
      __syncwarp();
      store_tile(Lb, n, i, k, vec, [&](int r, int cc) { return T[swz(r, cc)]; });
    }
    // block row k's tiles above the diagonal: zeros in both outputs, stored
    // while the warp computes (no store phase at the end)
    for (int j = k + 1; j < P; ++j) {
      store_tile(Lb, n, k, j, vec, zero);
      store_tile(Xb, n, k, j, vec, zero);
    }
    if (k == 0 && P > 1) {
      cp_wait<0>();
      __syncwarp();
      pad_identity(tile(last, last), n, last);
      __syncwarp();
    }
    // the trailing lower tiles: A[i, j] -= L[i, k] L[j, k]^T, a fresh
    // 16-deep product each; L[j, k]'s fragments held across i
    for (int j = k + 1; j < P; ++j) {
      unsigned bhi[2][2][2], blo[2][2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b_frag<true>(f, tile(j, k), 8 * h, bhi[h], blo[h]);
      for (int i = j; i < P; ++i) {
        const float* Li = tile(i, k);
        float c[2][4] = {};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned ahi[4], alo[4];
          a_frag(f, Li, 8 * h, ahi, alo);
          mma3(c, ahi, alo, bhi[h], blo[h]);
        }
        float* A = tile(i, j);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) A[c_off(f, nb, e)] -= c[nb][e];
      }
    }
    __syncwarp();
  }
  if (!ok) {
    const float nan = NAN;
    for (size_t idx = lane; idx < nn; idx += 32) {
      Lb[idx] = nan;
      Xb[idx] = nan;
    }
    for (size_t idx = lane; idx < (size_t)n * q; idx += 32) ab[idx] = nan;
    return;
  }

  // the scratch slots of panels 1.. back from L (already written out)
  for (int k = 1; k < P; ++k) {
    float* T = tile(k, k - 1);
    for (int e = lane; e < kPtElems; e += 32) {
      const int gr = k * kPt + e / kPt;
      const int gc = (k - 1) * kPt + e % kPt;
      T[swz(e / kPt, e % kPt)] =
          gr < n && gc < n ? __ldcg(Lb + (size_t)gr * n + gc) : 0.f;
    }
  }
  __syncwarp();

  // L^{-1} in place, row by row: M[i, p] = Inv_ii L[i, p]; then X[i, k] =
  // -sum_{k <= p < i} M[i, p] X[p, k], k ascending, over M[i, k]'s slot (no
  // later k reads it); each row stored as soon as it is done
  auto store_x = [&](int i, int j) {
    const float* T = tile(i, j);
    store_tile(Xb, n, i, j, vec, [&](int r, int c) { return T[swz(r, c)]; });
  };
  store_x(0, 0);
  for (int i = 1; i < P; ++i) {
    const float* Dii = tile(i, i);
    for (int p = 0; p < i; ++p) {
      float* T = tile(i, p);
      float c[2][4] = {};
      tile_mma<false>(f, Dii, T, c);
      __syncwarp();
      store_frag(f, T, c, 1.f);
    }
    __syncwarp();
    for (int k = 0; k < i; ++k) {
      float c[2][4] = {};
      for (int p = k; p < i; ++p)
        tile_mma<false>(f, tile(i, p), tile(p, k), c);
      __syncwarp();
      store_frag(f, tile(i, k), c, -1.f);
      __syncwarp();
    }
    for (int k = 0; k <= i; ++k) store_x(i, k);
  }
  __syncwarp();

  // alpha = X^T (X y_hat), X = L^{-1} in the slab, column by column. Lane
  // 16 h + r works on row (or column) r of a 16-block over the tiles of
  // parity h; the two halves' sums meet by one xor shuffle (both orders of
  // one addition: the same bits). w = X y_hat goes to alpha's storage; then
  // alpha's block j, ascending, reads w's blocks i >= j and overwrites w_j.
  const int h = lane >> 4;
  const int r = lane & 15;
  for (int col = 0; col < q; ++col) {
    for (int i = 0; i < P; ++i) {
      float s = 0.f;
      for (int k0 = 0; k0 <= i; k0 += 2) {
        const int k = k0 + h;
        const int gc = k * kPt + r;
        const float yv = k <= i && gc < n && (!mb || mb[gc])
                             ? yb[(size_t)gc * q + col] : 0.f;
        const float* T = tile(i, k <= i ? k : i);
#pragma unroll
        for (int c = 0; c < kPt; ++c) {
          const float yc = __shfl_sync(kFull, yv, (lane & 16) + c);
          if (k <= i) s = fmaf(T[swz(r, c)], yc, s);
        }
      }
      s += __shfl_xor_sync(kFull, s, 16);
      const int gr = i * kPt + r;
      if (h == 0 && gr < n) ab[(size_t)gr * q + col] = s;
    }
    __syncwarp();
    for (int j = 0; j < P; ++j) {
      float s = 0.f;
      for (int i0 = j; i0 < P; i0 += 2) {
        const int i = i0 + h;
        const int gr = i * kPt + r;
        const float wv = i < P && gr < n ? __ldcg(ab + (size_t)gr * q + col)
                                         : 0.f;
        const float* T = tile(i < P ? i : j, j);
#pragma unroll
        for (int rr = 0; rr < kPt; ++rr) {
          const float wr = __shfl_sync(kFull, wv, (lane & 16) + rr);
          if (i < P) s = fmaf(T[swz(rr, r)], wr, s);
        }
      }
      s += __shfl_xor_sync(kFull, s, 16);
      __syncwarp();
      const int gc = j * kPt + r;
      if (h == 0 && gc < n) ab[(size_t)gc * q + col] = s;
      __syncwarp();
    }
  }
}

// One warp per member, blockDim.x / 32 members a block; the slab of warp w
// is at w x slab tiles. Warps never wait on one another: no block barrier.
// (A group of two warps per member, sharing each step's tiles at a named
// barrier, ran no faster at B = 1000, n = 104: PERF.md.)
__global__ void __launch_bounds__(kMaxMembers * 32)
    bank_chol_tc_kernel(const float* __restrict__ K,
                        const float* __restrict__ y, float* __restrict__ L,
                        float* __restrict__ Linv, float* alpha, int batch,
                        int n, int q, bool vec, int P, int slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;
  float* S = reinterpret_cast<float*>(smem_raw) + (size_t)warp * slab * kPtElems;
  const size_t nn = (size_t)n * n;
  factor_member(TileFromK{K + b * nn, n, vec}, S, L + b * nn, Linv + b * nn,
                y + b * n * q, nullptr, alpha + b * n * q, n, q, P, vec);
}

__global__ void __launch_bounds__(kMaxMembers * 32)
    bank_fit_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ var,
                       const unsigned char* __restrict__ mask,
                       const float* __restrict__ y, float* __restrict__ L,
                       float* __restrict__ Linv, float* alpha, int batch,
                       int n, int d, int q, FamilyConsts<float> fc,
                       bool vec, int P, int slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;
  float* S = reinterpret_cast<float*>(smem_raw) + (size_t)warp * slab * kPtElems;
  const size_t nn = (size_t)n * n;
  const TileBuilt src{x + b * n * d, var + b * n, mask + b * n, n, d, fc};
  factor_member(src, S, L + b * nn, Linv + b * nn, y + b * n * q,
                mask + b * n, alpha + b * n * q, n, q, P, vec);
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

// Tiles of one member's slab on the blocked path (ops/bank.py mirrors it)
static int member_tiles(int n) {
  const int P = (n + kPt - 1) / kPt;
  return P * (P + 1) / 2 + (P == 1 ? 1 : 0);
}

// The blocked kernel's launch: members_per_block warps a block, refused
// unless their slabs fit the card's opt-in shared memory (opted into once
// per device and kernel, in opted[]); the kernel takes args then P and the
// slab's tiles.
template <typename Kernel, typename... Args>
static int launch_blocked(Kernel kernel, bool* opted, int batch, int n,
                          int members_per_block, int device,
                          cudaStream_t stream, Args... args) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const int slab = member_tiles(n);
  const size_t bytes =
      (size_t)members_per_block * slab * kPtElems * sizeof(float);
  if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return (int)err;
    opted[device] = true;
  }
  const int grid = (batch + members_per_block - 1) / members_per_block;
  kernel<<<grid, members_per_block * 32, bytes, stream>>>(
      args..., (n + kPt - 1) / kPt, slab);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The plan (ops/bank.py::bank_chol_plan): members_per_block 0 takes the
// augmented elimination, one block per member; m > 0 the blocked float32
// kernel with m members (warps) a block.
template <typename T>
static int launch_bank_fit(const T* x, const T* var, const unsigned char* mask,
                           const T* y, T* L, T* Linv, T* alpha, int batch,
                           int n, int d, int q, int family, int ncomp,
                           const double* coefs, const double* weights,
                           int members_per_block, int device,
                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FamilyConsts<T> fc;
  if (batch <= 0 || n <= 0 || d <= 0 || q <= 0 || members_per_block < 0 ||
      members_per_block > kMaxMembers ||
      !make_family<T>(family, ncomp, coefs, weights, &fc))
    return (int)cudaErrorInvalidValue;
  if (members_per_block == 0) {
    size_t bytes = 0;
    const int code = slab_smem<T>(bank_fit_kernel<T>, n, device, &bytes);
    if (code != 0) return code;
    bank_fit_kernel<T><<<batch, dim3(kBankTx, kBankTy), bytes, stream>>>(
        x, var, mask, y, L, Linv, alpha, n, d, q, fc, bytes > 0);
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof(T) != sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  } else {
    static bool opted[64];
    const bool vec = n % 4 == 0 && aligned16(L) && aligned16(Linv);
    return launch_blocked(bank_fit_tc_kernel, opted, batch, n,
                          members_per_block, device, stream, x, var, mask, y,
                          L, Linv, alpha, batch, n, d, q, fc, vec);
  }
}

template <typename T>
static int launch_bank_chol(const T* K, const T* y, T* L, T* Linv, T* alpha,
                            int batch, int n, int q, int members_per_block,
                            int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || n <= 0 || q <= 0 || members_per_block < 0 ||
      members_per_block > kMaxMembers)
    return (int)cudaErrorInvalidValue;
  if (members_per_block == 0) {
    size_t bytes = 0;
    const int code = slab_smem<T>(bank_chol_kernel<T>, n, device, &bytes);
    if (code != 0) return code;
    bank_chol_kernel<T><<<batch, dim3(kBankTx, kBankTy), bytes, stream>>>(
        K, y, L, Linv, alpha, n, q, bytes > 0);
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof(T) != sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  } else {
    static bool opted[64];
    const bool vec = n % 4 == 0 && aligned16(K) && aligned16(L) &&
                     aligned16(Linv);
    return launch_blocked(bank_chol_tc_kernel, opted, batch, n,
                          members_per_block, device, stream, K, y, L, Linv,
                          alpha, batch, n, q, vec);
  }
}

}  // namespace egp

// members_per_block: 0 for the augmented elimination, else the blocked
// float32 kernel's members (warps) per block (ops/bank.py::bank_chol_plan)
extern "C" int egp_bank_fit_f32(const float* x, const float* var,
                                const unsigned char* mask, const float* y,
                                float* L, float* Linv, float* alpha, int batch,
                                int n, int d, int q, int family, int ncomp,
                                const double* coefs, const double* weights,
                                int members_per_block, int device,
                                void* stream) {
  return egp::launch_bank_fit<float>(x, var, mask, y, L, Linv, alpha, batch,
                                     n, d, q, family, ncomp, coefs, weights,
                                     members_per_block, device,
                                     (cudaStream_t)stream);
}

extern "C" int egp_bank_fit_f64(const double* x, const double* var,
                                const unsigned char* mask, const double* y,
                                double* L, double* Linv, double* alpha,
                                int batch, int n, int d, int q, int family,
                                int ncomp, const double* coefs,
                                const double* weights, int members_per_block,
                                int device, void* stream) {
  return egp::launch_bank_fit<double>(x, var, mask, y, L, Linv, alpha, batch,
                                      n, d, q, family, ncomp, coefs, weights,
                                      members_per_block, device,
                                      (cudaStream_t)stream);
}

extern "C" int egp_bank_chol_f32(const float* K, const float* y, float* L,
                                 float* Linv, float* alpha, int batch, int n,
                                 int q, int members_per_block, int device,
                                 void* stream) {
  return egp::launch_bank_chol<float>(K, y, L, Linv, alpha, batch, n, q,
                                      members_per_block, device,
                                      (cudaStream_t)stream);
}

extern "C" int egp_bank_chol_f64(const double* K, const double* y, double* L,
                                 double* Linv, double* alpha, int batch, int n,
                                 int q, int members_per_block, int device,
                                 void* stream) {
  return egp::launch_bank_chol<double>(K, y, L, Linv, alpha, batch, n, q,
                                       members_per_block, device,
                                       (cudaStream_t)stream);
}

// the card's opt-in shared memory per block in bytes, or -(CUDA error)
extern "C" int egp_smem_optin(int device) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? limit : -(int)err;
}
