// Bank fit and bank Cholesky on Hopper: B small exact GPs factored at once.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_bank.py::_fit_kernel (via
// _fit_raw / bank_fit_fused) and ::_chol_kernel (via _chol_raw /
// bank_cholesky_solve_fused). On the 3D range-sensor GP's path every scan
// is one bank fit of (rows x cols) partitions: 736 members of n = 100 at the
// reference lidar protocol; BatchGPBank.solve factors (1000, 104).
//
// What one member computes, for the gram A (n x n): L (lower, zeros above)
// and L^{-1}, where
//
//   fit : A = k(x, x) + diag(var), masked rows and columns exact identity
//         rows (the TPU kernel's far-point padding, here an explicit mask)
//   chol: A = the given gram, read from its lower triangle
//
// A pivot that is not positive makes the whole member NaN, as rsqrt does on
// the TPU and as the plain version's failed Cholesky does; it is never
// clamped. alpha = K^{-1} y is two batched products against L^{-1} outside
// the kernel, as in the JAX package. No float atomics and no cross-member
// reduction: a member's factor is bit for bit the same whatever batch it is
// factored in.
//
// Two designs, picked per call by the host (ops/bank.py::bank_chol_plan):
//
// (1) The augmented elimination (bank fit at both dtypes; bank Cholesky at
//     float64 and where a float32 member's tiles do not fit shared memory):
//     one thread block per member, [A | E] -> [L^T | L^{-1}] right-looking
//     in the order of pallas_bank.py::_elimination, for j = 0 .. n-1:
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
//     a chain of n pivots with two block barriers each (1.18 ms at B = 1000,
//     n = 104, PERF.md).
//
// (2) The blocked factorization (bank Cholesky, float32): one warp per
//     member, several members per block, the member padded to P = ceil(n /
//     16) tiles a side with identity rows (which leave the leading n x n
//     factor exactly as it is) and only its P (P + 1) / 2 lower 16 x 16
//     tiles held in shared memory (28 KB at n = 104, so 8 members fit a
//     block and B = 1000 one wave of 125 blocks on 132 SMs). For each
//     16-column panel k, right-looking:
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
//     output (the last diagonal tile, loaded after the first panel, then
//     the sub-diagonal tile of the panel before, restored from L before the
//     inversion), so no slot beyond the lower triangle is held. Every tile
//     of L, of L^{-1} and of the zeros above their diagonals is stored as
//     soon as it is final, so the stores drain while the warp computes.
//     Bound on the card: bytes (K read, L and L^{-1} written: 0.039 ms at B
//     = 1000, n = 104); the tensor-core work is ~1e-3 ms of it.
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

// ---- (2) the blocked float32 bank Cholesky ----

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

// One warp per member, blockDim.x / 32 members a block; the slab of warp w
// is the P (P + 1) / 2 tiles (plus one scratch tile when P = 1) at w x slab
// tiles. Warps never wait on one another: no block barrier. (A group of two
// warps per member, sharing each step's tiles at a named barrier, ran no
// faster at B = 1000, n = 104: PERF.md.)
__global__ void __launch_bounds__(kMaxMembers * 32)
    bank_chol_tc_kernel(const float* __restrict__ K, float* __restrict__ L,
                        float* __restrict__ Linv, int batch, int n, int P,
                        int slab, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= batch) return;
  float* S = reinterpret_cast<float*>(smem_raw) + (size_t)warp * slab * kPtElems;
  auto tile = [&](int i, int j) { return S + tri(i, j) * kPtElems; };
  const size_t nn = (size_t)n * n;
  const float* Kb = K + b * nn;
  float* Lb = L + b * nn;
  float* Xb = Linv + b * nn;
  const int last = P - 1;
  const Frag f;
  auto zero = [](int, int) { return 0.f; };

  // the lower tiles of K; the last diagonal one waits while its slot is
  // the first panel's scratch
  for (int i = 0; i < P; ++i)
    for (int j = 0; j <= i; ++j)
      if (P == 1 || j != last) load_tile(tile(i, j), Kb, n, i, j, vec);
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
      load_tile(tile(last, last), Kb, n, last, last, vec);
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

// Tiles of one member's slab on the blocked path (ops/bank.py mirrors it)
static int member_tiles(int n) {
  const int P = (n + kPt - 1) / kPt;
  return P * (P + 1) / 2 + (P == 1 ? 1 : 0);
}

// The plan (ops/bank.py::bank_chol_plan): members_per_block 0 takes the
// augmented elimination, one block per member; m > 0 the blocked float32
// kernel with m members (warps) a block, refused unless they fit shared
// memory.
template <typename T>
static int launch_bank_chol(const T* K, T* L, T* Linv, int batch, int n,
                            int members_per_block, int device,
                            cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0 || n <= 0 || members_per_block < 0 ||
      members_per_block > kMaxMembers)
    return (int)cudaErrorInvalidValue;
  if (members_per_block == 0) {
    size_t bytes = 0;
    const int code = slab_smem<T>(bank_chol_kernel<T>, n, device, &bytes);
    if (code != 0) return code;
    bank_chol_kernel<T><<<batch, dim3(kBankTx, kBankTy), bytes, stream>>>(
        K, L, Linv, n, bytes > 0);
    return (int)cudaGetLastError();
  }
  if constexpr (sizeof(T) != sizeof(float)) {
    return (int)cudaErrorInvalidValue;
  } else {
    int limit = 0;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return (int)err;
    const int slab = member_tiles(n);
    const size_t bytes =
        (size_t)members_per_block * slab * kPtElems * sizeof(float);
    if (bytes > (size_t)limit) return (int)cudaErrorInvalidValue;
    static bool opted[64];  // the opt-in limit, once per device
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (!opted[device]) {
      err = cudaFuncSetAttribute(bank_chol_tc_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit);
      if (err != cudaSuccess) return (int)err;
      opted[device] = true;
    }
    const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Linv) % 16 == 0;
    const int grid = (batch + members_per_block - 1) / members_per_block;
    bank_chol_tc_kernel<<<grid, members_per_block * 32, bytes, stream>>>(
        K, L, Linv, batch, n, (n + kPt - 1) / kPt, slab, vec);
    return (int)cudaGetLastError();
  }
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

// members_per_block: 0 for the augmented elimination, else the blocked
// float32 kernel's members (warps) per block (ops/bank.py::bank_chol_plan)
extern "C" int egp_bank_chol_f32(const float* K, float* L, float* Linv,
                                 int batch, int n, int members_per_block,
                                 int device, void* stream) {
  return egp::launch_bank_chol<float>(K, L, Linv, batch, n, members_per_block,
                                      device, (cudaStream_t)stream);
}

extern "C" int egp_bank_chol_f64(const double* K, double* L, double* Linv,
                                 int batch, int n, int members_per_block,
                                 int device, void* stream) {
  return egp::launch_bank_chol<double>(K, L, Linv, batch, n,
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
