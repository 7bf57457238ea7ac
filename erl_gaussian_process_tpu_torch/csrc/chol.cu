// Blocked Cholesky of one large SPD matrix on Hopper, with the inverses of
// the diagonal tiles as a second output.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_chol.py:
//   - _chol_kernel (via _chol_padded / chol_blocked): A read from memory;
//   - _chol_gram_kernel (via _chol_gram_padded / chol_blocked_gram): A =
//     k(x, x) + diag(var), masked rows exact identity rows, built per tile
//     from the coordinates;
//   - _chol_gram_kernel with joint=True (_joint_tile /
//     chol_blocked_gram_joint):
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
//     update: W_0[i] = A[i, j]; W_s[i] = sum_{p in split s} L[i, p] L[j, p]^T
//             for i >= j, over the panels p < j - 1 (the look-ahead part)
//     diag  : L[j, j], Dinv[j] = factor(W_0[j] - sum_{s>0} W_s[j]
//                                        - L[j, j-1] L[j, j-1]^T)
//     apply : L[i, j] = (W_0[i] - sum_{s>0} W_s[i] - L[i, j-1] L[j, j-1]^T)
//                       Dinv[j]^T                                  for i > j
//
// A tile of A is built (from memory, or from coordinates for the
// gram-fused variants) by blocks of the update launch into the column's
// workspace and consumed by the diag and apply launches that follow: the
// (n, n) gram is never stored, only the current column's tiles, which is
// what the left-looking order buys. A right-looking trailing update would
// store it.
//
// What bounds it on this card: the update holds n^3 / 6 of the n^3 / 6 +
// O(n^2 T) multiply-adds, and the diagonal tiles are a serial chain of n / T
// factorizations that no width hides; with the update off the chain, the
// chain of diag and apply launches bounds the call. The first version
// (PERF.md; NVIDIA H100 80GB HBM3, 700 W) ran the update as a SIMT FP32
// tile (~19 TFLOP/s of the 67), factored each diagonal tile by a 64-step
// elimination with one block barrier a step (44 us a tile, 131 of 132 SMs
// idle) and ran the three launches of each column in strict sequence. The
// design now:
//   1. The float32 update runs on Hopper's warpgroup products (wgmma) in
//      3xTF32: each operand is split into hi + lo TF32 parts, the product
//      taken as lo*hi + hi*lo + hi*hi with FP32 accumulation (the
//      counterpart of the JAX kernel's bf16x3 _dot3x, csrc/wgmma_tf32.cuh).
//      Column j's update is a skinny product, (n - jT) rows x (j - 1) T deep
//      x T wide, so it is bound by the rows of L it streams: at n = 8192
//      5.59 GB over the columns (L is 268 MB, past the 50 MB L2), 1.67 ms at
//      3.35 TB/s, against 1.08 ms for its 5.37e11 TF32 operations at 495
//      TFLOP/s. A block owns 128 rows and reads each row of its strip once;
//      the rows are the register operand, split in registers, and the
//      column's own strip, which every block of the column shares, is split
//      once a chunk into shared memory. Float64 keeps a SIMT update.
//   2. The diagonal tile is factored blocked, as the JAX _factor_tile does:
//      four 16-column sub-blocks, each factored in one warp's registers
//      with shuffles (csrc/sub_block.cuh; no block barrier a pivot) and
//      inverted by forward
//      substitution, its panel formed by a product with the sub-block's
//      inverse, the rest by rank-16 updates; the rows of L^-1 ride along as
//      the right half of [A | I] (Dinv with no pass of its own).
//   3. Look-ahead: the update of column j covers the panels p < j - 1 and
//      runs on a low-priority side stream while column j - 1's diag and
//      apply run on a high-priority stream (CUDA events order the two);
//      only the last panel's rank-T term, L[., j-1] L[j, j-1]^T, is on the
//      critical path, folded into the diag and apply launches. The tiles of
//      A come from the update too, by blocks of their own beside the
//      product blocks, so the chain never evaluates the source. The
//      workspace is double-buffered by column parity. A float32 update
//      block holds most of an SM (128 KB of shared memory, ~150 registers
//      a thread), so the split plan gives a column's update at most three
//      quarters of the SMs, one block each: the rest stay free for the diag
//      and apply blocks of the chain, which otherwise waited for an update
//      block to end (PERF.md).
//   4. The apply sums each tile's split partials once, into registers (four
//      splits' loads in flight), and takes both of its T x T x T products
//      from shared memory.
// Sums stay in a fixed order (per element: A, the splits in order, the last
// panel), with no atomics: two calls on one input are bitwise equal. Each
// update block sums one T-wide panel into a fresh partial before adding it
// to its running sum (a two-level sum; a single running float32 sum over
// 2048 terms broke the FITC drift gate, PERF.md), the splits are a third
// level. The split plan (panels per split for each column, sized to keep
// the update within a few blocks per SM) and the workspace come from the
// caller (ops/chol.py::chol_plan).
//
// A pivot that is not positive writes the tile's lower part and Dinv[j] as
// NaN, and NaN then reaches every later column and the solve; it is never
// clamped. The strict upper part of L is written as exact zeros by the same
// launches (no memset). Dinv[j] = inv(L[j, j]) (the last one of L padded with
// identity) is used by the apply as it is, and the triangular solves and
// the float32 whitening slice their block inverses from it (ops/trsv.py,
// models/gp_core.py).
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "async_copy.cuh"
#include "family.cuh"
#include "sub_block.cuh"
#include "wgmma_tf32.cuh"

namespace egp {

constexpr int kTile = 64;      // T: the factorization's tile edge
constexpr int kThreads = 256;  // diag and apply: 16 x 16 threads
constexpr int kKL = kTile + 4; // row stride of a k-major staged operand
constexpr int kDL = kTile + 1; // row stride of the diagonal tile
constexpr int kMaxSplits = 16; // split buffers a consumer sums

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
  FamilyConsts<T> fc;
  __device__ __forceinline__ T operator()(int r, int c) const {
    if (r >= n || c >= n || !(mask[r] && mask[c])) return r == c ? T(1) : T(0);
    T a = kernel_entry<T>(fc, x + (size_t)r * d, x + (size_t)c * d, d);
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

// ---- update: split partials of the column's look-ahead prefix ----

// Block (., s) writes ws[s][t] (T x T, t < nt = nb - j) for row tile j + t
// against row tile j: the float64 grid is (nt, 1 + splits), one tile a
// block; the float32 grid (ceil(nt / 2), 1 + splits), two. Split 0 is the
// tile of A, built off the critical path by blocks of its own (beside the
// product blocks, not after them), so the diag and apply launches never
// evaluate the source; for the diagonal tile, t = 0, only its lower part (A
// is read from its lower triangle). Split s >= 1 sums the panels
// [(s - 1) pps, min(npan, s pps)), npan = max(0, j - 1).

// float32: 3xTF32 on wgmma (sm_90a). A block of two warpgroups owns 128
// rows, row tiles j + t and j + t + 1 (t = 2 blockIdx.x), against the
// column's 64: warpgroup w the 64 x 64 product of row tile j + t + w. Both
// operands are read from L as they lie, 32-deep chunks at a time, through
// one cp.async ring of kUpStages chunks (16-byte units swizzled by row, so
// that the reads below are conflict-free):
//   - the row strip L[rows, chunk] is the register operand: each thread
//     splits its fragment into hi and lo TF32 parts in registers;
//   - the column's own strip L[jT .. jT + T, chunk], the same for every
//     block, is the shared-memory operand: the block splits it once, a chunk
//     ahead, into hi and lo tiles in wgmma's core layout, double-buffered.
// Each chunk is 12 products (lo*hi, hi*lo, hi*hi for each 8-deep step) into
// a partial that starts from zero with each T-wide panel (two chunks) and is
// then added into the running sum by FP32 adds. One barrier a chunk: after
// it the chunk's rows and column tiles are in, and both warpgroups are done
// with the chunk before (whose ring stage and column tiles are refilled).
// Both warpgroups run every product, the second on zero rows in the last
// block of an odd count of row tiles (it writes nothing): a product issued
// under a branch serializes the warpgroup's products.
constexpr int kUpRows = 2 * kTile;    // rows a block: two warpgroups of 64
constexpr int kUpThreads = 256;
constexpr int kUpK = kCoreK;          // depth of a chunk (32)
constexpr int kUpStages = 4;          // chunks: 2 in flight, 2 in use
constexpr int kUpRowStage = kUpRows * kUpK;           // the rows' floats
constexpr int kUpStage = kUpRowStage + kTile * kUpK;  // and the column's
constexpr int kUpCore = kTile * kUpK;  // a hi or lo column tile
constexpr int kUpSmem =
    (2 * 2 * kUpCore + kUpStages * kUpStage) * (int)sizeof(float);

template <typename T, typename Src, int kThr>
__device__ __forceinline__ void a_tile(Src src, T* out, int t, int r0,
                                       int c0) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThr) {
    const int r = e / kTile;
    const int c = e - r * kTile;
    out[e] = t > 0 || c <= r ? src(r0 + r, c0 + c) : T(0);
  }
}

// Element (r, k) of a ring stage (rows of kUpK floats): 16-byte unit k / 4
// of row r at position (k / 4) ^ (r % 8).
__device__ __forceinline__ int row_stage_index(int r, int k) {
  return r * kUpK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3);
}

template <typename Src>
__global__ void __launch_bounds__(kUpThreads, 1)
    chol_update_wgmma_kernel(Src src, const float* __restrict__ L,
                             float* __restrict__ ws, int n, int j, int nt,
                             int pps, int vec) {
  extern __shared__ __align__(128) unsigned char up_smem[];
  float* core = reinterpret_cast<float*>(up_smem);  // [2][hi, lo]
  float* ring = core + 2 * 2 * kUpCore;              // [stage] rows, column
  const int t = 2 * blockIdx.x;
  const int s = blockIdx.y;
  const int col0 = j * kTile;
  if (s == 0) {
    for (int h = 0; h < 2 && t + h < nt; ++h)
      a_tile<float, Src, kUpThreads>(
          src, ws + (size_t)(t + h) * kTile * kTile, t + h,
          (j + t + h) * kTile, col0);
    return;
  }
  const int row0 = (j + t) * kTile;
  const int npan = max(0, j - 1);
  const int kbeg = (s - 1) * pps * kTile;
  const int kend = min(npan, s * pps) * kTile;
  const int nch = (kend - kbeg) / kUpK;  // even: whole panels
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // warpgroup 1 of the last block of an odd count of row tiles has no tile
  const bool live = t + wg < nt;
  // chunk c of the row strip and of the column's strip into its ring
  // stage, rows past n zero
  auto load_chunk = [&](int c) {
    float* st = ring + (c % kUpStages) * kUpStage;
    const int k0 = kbeg + c * kUpK;
    if (vec) {
#pragma unroll
      for (int i = 0; i < kUpStage / 4 / kUpThreads; ++i) {
        const int e = threadIdx.x + i * kUpThreads;
        const int r = e >> 3;  // rows 0 .. 127 the strip's, then the column's
        const int k = (e & 7) * 4;
        const int gr = r < kUpRows ? row0 + r : col0 + r - kUpRows;
        const bool ok = gr < n;
        cp_async<16>(st + row_stage_index(r, k),
                     ok ? L + (size_t)gr * n + k0 + k : L, ok);
      }
    } else {
      for (int e = threadIdx.x; e < kUpStage; e += kUpThreads) {
        const int r = e / kUpK;
        const int k = e - r * kUpK;
        const int gr = r < kUpRows ? row0 + r : col0 + r - kUpRows;
        const bool ok = gr < n;
        cp_async<4>(st + row_stage_index(r, k),
                    ok ? L + (size_t)gr * n + k0 + k : L, ok);
      }
    }
  };
  // chunk c's column strip, landed, split into its hi and lo core tiles:
  // each thread two units of four values; eight consecutive threads the
  // same unit of eight rows (conflict-free both ways)
  auto stage_col = [&](int c) {
    const float* raw = ring + (c % kUpStages) * kUpStage + kUpRowStage;
    float* hi = core + (c & 1) * 2 * kUpCore;
    float* lo = hi + kUpCore;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = (threadIdx.x >> 5) + 8 * h;
      const int r = (w & 7) * 8 + (lane & 7);
      const int k = (w / 8 * 4 + (lane >> 3)) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(raw + row_stage_index(r, k));
      unsigned vh[4], vl[4];
      split_rna(v.x, vh[0], vl[0]);
      split_rna(v.y, vh[1], vl[1]);
      split_rna(v.z, vh[2], vl[2]);
      split_rna(v.w, vh[3], vl[3]);
      const int at = core_index(r, k);
      *reinterpret_cast<uint4*>(hi + at) = make_uint4(vh[0], vh[1], vh[2],
                                                      vh[3]);
      *reinterpret_cast<uint4*>(lo + at) = make_uint4(vl[0], vl[1], vl[2],
                                                      vl[3]);
    }
    fence_proxy_async();
  };
  float acc[32], part[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = part[e] = 0.f;
#pragma unroll
  for (int st = 0; st < kUpStages - 1; ++st) {
    if (st < nch) load_chunk(st);
    cp_commit();
  }
  cp_wait<kUpStages - 2>();
  __syncthreads();
  stage_col(0);  // nch is even and at least 2: whole panels
  const int r = wg * 64 + warp * 16 + g;  // the fragments' rows r, r + 8
  for (int c = 0; c < nch; ++c) {
    cp_wait<kUpStages - 3>();  // chunks c and c + 1 are in
    __syncthreads();
    if (c + kUpStages - 1 < nch) load_chunk(c + kUpStages - 1);
    cp_commit();
    const float* st = ring + (c % kUpStages) * kUpStage;
    const float* hi = core + (c & 1) * 2 * kUpCore;
    const float* lo = hi + kUpCore;
    unsigned ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 8 * kk + tq;
      split_rna(st[row_stage_index(r, k)], ahi[kk][0], alo[kk][0]);
      split_rna(st[row_stage_index(r + 8, k)], ahi[kk][1], alo[kk][1]);
      split_rna(st[row_stage_index(r, k + 4)], ahi[kk][2], alo[kk][2]);
      split_rna(st[row_stage_index(r + 8, k + 4)], ahi[kk][3], alo[kk][3]);
    }
    wgmma_fence();
    // the small terms first; a panel's first product starts from zero
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32_n64(part, alo[kk], core_desc(hi, kk),
                     (c & 1) == 0 && kk == 0);
      wgmma_tf32_n64(part, ahi[kk], core_desc(lo, kk), 0);
      wgmma_tf32_n64(part, ahi[kk], core_desc(hi, kk), 0);
    }
    wgmma_commit();
    // the next chunk's column tiles while the products run (their buffer
    // was read by chunk c - 1's, done before the barrier)
    if (c + 1 < nch) stage_col(c + 1);
    wgmma_wait_all();
    if (c & 1) {  // a T-wide panel ends: fold its fresh partial in
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
    }
  }
  cp_wait<0>();
  if (!live) return;
  // acc[4 i + e]: row warp 16 + g + 8 (e / 2), column 8 i + 2 tq + e % 2
  float* out = ws + ((size_t)s * nt + t + wg) * kTile * kTile;
  const int orow = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * tq;
    *reinterpret_cast<float2*>(out + orow * kTile + c) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(out + (orow + 8) * kTile + c) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// float64: a SIMT T x T tile, each of 256 threads 4 x 4 neighbouring
// outputs from shared memory in 16-byte loads, the next 16-deep k-chunk
// loaded into registers while the current one is multiplied.
constexpr int kUK64 = 16;

template <typename Src>
__global__ void __launch_bounds__(kThreads)
    chol_update_f64_kernel(Src src, const double* __restrict__ L,
                           double* __restrict__ ws, int n, int j, int pps) {
  constexpr int kLoads = kTile * kUK64 / kThreads;  // per thread, operand
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  __shared__ __align__(16) double As[2][kUK64][kKL];
  __shared__ __align__(16) double Bs[2][kUK64][kKL];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = (j + t) * kTile;
  const int col0 = j * kTile;
  double* out = ws + ((size_t)s * gridDim.x + t) * kTile * kTile;
  if (s == 0) {
    a_tile<double, Src, kThreads>(src, out, t, row0, col0);
    return;
  }
  const int kbeg = (s - 1) * pps * kTile;
  const int kend = min(max(0, j - 1), s * pps) * kTile;
  double ra[kLoads], rb[kLoads];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / kUK64;
      const int kk = e - r * kUK64;
      ra[i] = row0 + r < n ? L[(size_t)(row0 + r) * n + k0 + kk] : 0.0;
      rb[i] = col0 + r < n ? L[(size_t)(col0 + r) * n + k0 + kk] : 0.0;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / kUK64;
      const int kk = e - r * kUK64;
      As[buf][kk][r] = ra[i];
      Bs[buf][kk][r] = rb[i];
    }
  };
  double acc[4][4], part[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = part[a][b] = 0.0;
  if (kbeg < kend) {
    load(kbeg);
    stage(0);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kUK64) {
    const int kn = k0 + kUK64;
    if (kn < kend) load(kn);
#pragma unroll
    for (int kk = 0; kk < kUK64; ++kk) {
      double av[4], bv[4];
      lds4(&As[buf][kk][ty * 4], av);
      lds4(&Bs[buf][kk][tx * 4], bv);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) part[a][b] = fma_(av[a], bv[b], part[a][b]);
    }
    if (kn % kTile == 0) {  // a panel ends: fold its fresh partial in
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] += part[a][b];
          part[a][b] = 0.0;
        }
    }
    if (kn < kend) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[(ty * 4 + a) * kTile + tx * 4 + b] = acc[a][b];
}

// ---- the reduced tile, shared by diag and apply ----

// S[k][r] = M[r0 + r][c0 + k] (0 for rows past nrows): a T x T block of a
// row-major matrix staged k-major, for tile_product
template <typename T>
__device__ __forceinline__ void stage_kmajor(T* S, const T* M, size_t ld,
                                             int r0, int c0, int nrows) {
  constexpr int kPer = kTile * kTile / kThreads;
  T v[kPer];  // every load in flight before the first store
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    const int r = e / kTile;
    v[q] = r0 + r < nrows ? M[(size_t)(r0 + r) * ld + c0 + e % kTile] : T(0);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kThreads;
    S[(e % kTile) * kKL + e / kTile] = v[q];
  }
}

// The 16 elements of a T x T tile each of the 256 threads of diag and
// apply holds, e = 0 .. 15: a 4 x 4 block of neighbours, rows row(0) ..,
// columns col(0) ...
__device__ __forceinline__ int elem_row(int e) {
  return (threadIdx.x / 16) * 4 + e / 4;
}
__device__ __forceinline__ int elem_col(int e) {
  return (threadIdx.x % 16) * 4 + e % 4;
}

// v[e] = tile[row(e)][col(e)] of a row-major T x T tile in global memory,
// four neighbours a 16-byte load
__device__ __forceinline__ void load_elems(const float* tile, float v[16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(
        tile + elem_row(4 * a) * kTile + elem_col(0)));
    v[4 * a] = q.x;
    v[4 * a + 1] = q.y;
    v[4 * a + 2] = q.z;
    v[4 * a + 3] = q.w;
  }
}
__device__ __forceinline__ void load_elems(const double* tile, double v[16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const double2* p = reinterpret_cast<const double2*>(
        tile + elem_row(4 * a) * kTile + elem_col(0));
    const double2 q0 = __ldg(p);
    const double2 q1 = __ldg(p + 1);
    v[4 * a] = q0.x;
    v[4 * a + 1] = q0.y;
    v[4 * a + 2] = q1.x;
    v[4 * a + 3] = q1.y;
  }
}

// out[e] = sum_k SA[k][row(e)] SB[k][col(e)], k < T: one T x T x T product
// of two k-major staged operands, SIMT FMA from 16-byte shared loads (on the
// tensor cores, in 3xTF32, these small products made the chain slower,
// PERF.md)
template <typename T>
__device__ __forceinline__ void tile_product(const T* SA, const T* SB,
                                             T out[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = T(0);
#pragma unroll 8
  for (int k = 0; k < kTile; ++k) {
    T av[4], bv[4];
    lds4(SA + k * kKL + elem_row(0), av);
    lds4(SB + k * kKL + elem_col(0), bv);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[a * 4 + b] = fma_(av[a], bv[b], out[a * 4 + b]);
  }
}

// v[e] = A[t] - sum_{s >= 1} P_s[t] - L[i, j-1] L[j, j-1]^T at element e
// (i = j + t), the splits summed in order, four in flight. SA and SB are
// scratch; ends with them free.
template <typename T>
__device__ __forceinline__ void reduced_tile(const T* L, const T* ws, int n,
                                             int j, int t, int nsplit,
                                             size_t split_stride, T* SA,
                                             T* SB, T v[16]) {
  const T* wt = ws + (size_t)t * kTile * kTile;
  load_elems(wt, v);  // split 0, the tile of A: overlaps the staging
  T last[16];
  if (j > 0) {  // the diagonal tile (t = 0) stages its one operand once
    stage_kmajor<T>(SA, L, n, (j + t) * kTile, (j - 1) * kTile, n);
    if (t > 0) stage_kmajor<T>(SB, L, n, j * kTile, (j - 1) * kTile, n);
    __syncthreads();
    tile_product<T>(SA, t > 0 ? SB : SA, last);
    __syncthreads();
  }
#pragma unroll 4
  for (int s = 1; s < nsplit; ++s) {
    T w[16];
    load_elems(wt + s * split_stride, w);
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] -= w[e];
  }
  if (j > 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] -= last[e];
  }
}

// ---- diag: factor the reduced diagonal tile ----

// The T x T tile in At (lower triangle) -> L in At, L^-1 in D (whose
// strict lower part is 0 on entry): right-looking over four sub-blocks of
// 16 columns on [A | E], E = I. For sub-block o: warp 0 factors its
// diagonal block (L_oo and Inv_oo); then the panel below, L[r, o] =
// A[r, o] Inv_oo^T, and block row o of L^-1 left of the diagonal,
// Inv_oo E[o, :o]; then the trailing update of both, A[r, c] -= L[r, o]
// L[c, o]^T and E[r, :o+16] -= L[r, o] E[o, :o+16] for the rows below.
// Returns false (in every thread) on a non-positive pivot.
template <typename T>
__device__ bool factor_tile(T* At, T* D, int* fail) {
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int sb = 0; sb < kTile / kSub; ++sb) {
    const int o = sb * kSub;
    const int r0 = o + kSub;
    const int rows = kTile - r0;
    if (tid < 32) {
      const bool ok = factor_sub_block<T>(At, D, StridedIdx{o, kDL},
                                          StridedIdx{o, kDL});
      if (tid == 0 && !ok) *fail = 1;
    }
    __syncthreads();
    // rows * 16 panel entries and 16 * o entries of L^-1: 768 in all
    T pv[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int e = tid + q * kThreads;
      T s = T(0);
      if (e < rows * kSub) {  // L[r][o + c] = sum_{k <= c} A[r][o+k] Inv[c][k]
        const int r = r0 + e / kSub;
        const int c = e % kSub;
#pragma unroll
        for (int k = 0; k < kSub; ++k)
          if (k <= c)
            s = fma_(At[r * kDL + o + k], D[(o + c) * kDL + o + k], s);
      } else {  // Inv[o + r][c] = sum_{k <= r} Inv_oo[r][k] E[o + k][c]
        const int f = e - rows * kSub;
        const int r = f / (o > 0 ? o : 1);
        const int c = f - r * o;
#pragma unroll
        for (int k = 0; k < kSub; ++k)
          if (k <= r)
            s = fma_(D[(o + r) * kDL + o + k], D[(o + k) * kDL + c], s);
      }
      pv[q] = s;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int e = tid + q * kThreads;
      if (e < rows * kSub) {
        At[(r0 + e / kSub) * kDL + o + e % kSub] = pv[q];
      } else {
        const int f = e - rows * kSub;
        const int r = f / (o > 0 ? o : 1);
        D[(o + r) * kDL + f - r * o] = pv[q];
      }
    }
    __syncthreads();
    if (rows == 0) break;
    // trailing: rows r0.. of A (lower part, columns r0..) and of E
    // (columns 0 .. r0 - 1), each less its rank-16 product with the panel.
    // Thread t keeps column c = t % 64 and its 16 panel values in
    // registers and walks the rows r0 + t / 64, + 4, ...
    const int c = tid % kTile;
    const bool on_a = c >= r0;
    T col[kSub];
#pragma unroll
    for (int k = 0; k < kSub; ++k)
      col[k] = on_a ? At[c * kDL + o + k] : D[(o + k) * kDL + c];
    T* out = on_a ? At : D;
#pragma unroll 2
    for (int r = r0 + tid / kTile; r < kTile; r += kThreads / kTile) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < kSub; ++k) s = fma_(At[r * kDL + o + k], col[k], s);
      if (!on_a || c <= r) out[r * kDL + c] -= s;
    }
    __syncthreads();
  }
  return *fail == 0;
}

template <typename T>
constexpr int diag_smem() {
  return (2 * kTile * kKL + 2 * kTile * kDL) * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    chol_diag_kernel(T* __restrict__ L, T* __restrict__ Dinv,
                     const T* __restrict__ ws, int n, int j, int nsplit,
                     size_t split_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* SA = reinterpret_cast<T*>(smem_raw);
  T* SB = SA + kTile * kKL;
  T* At = SB + kTile * kKL;
  T* D = At + kTile * kDL;
  __shared__ int fail;
  if (threadIdx.x == 0) fail = 0;
  for (int e = threadIdx.x; e < kTile * kDL; e += kThreads) D[e] = T(0);
  T v[16];
  reduced_tile<T>(L, ws, n, j, 0, nsplit, split_stride, SA, SB, v);
#pragma unroll
  for (int e = 0; e < 16; ++e)
    At[elem_row(e) * kDL + elem_col(e)] = v[e];
  __syncthreads();
  const bool ok = factor_tile<T>(At, D, &fail);
  const T nan = T(NAN);
  const int base = j * kTile;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    const int r = idx / kTile;
    const int c = idx - r * kTile;
    const int gr = base + r;
    const int gc = base + c;
    if (gr < n && gc < n)
      L[(size_t)gr * n + gc] = c > r ? T(0) : (ok ? At[r * kDL + c] : nan);
    Dinv[(size_t)gr * kTile + c] = ok ? (c > r ? T(0) : D[r * kDL + c]) : nan;
  }
}

// ---- apply: L[i, j] = (reduced A[i, j]) Dinv[j]^T, i > j ----

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    chol_apply_kernel(T* __restrict__ L, const T* __restrict__ Dinv,
                      const T* __restrict__ ws, int n, int j, int nsplit,
                      size_t split_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* SA = reinterpret_cast<T*>(smem_raw);
  T* SB = SA + kTile * kKL;
  const int t = blockIdx.x + 1;  // row tile j + t, ws tile t
  T v[16];
  reduced_tile<T>(L, ws, n, j, t, nsplit, split_stride, SA, SB, v);
  // SA[k][r] = reduced(r, k); SB[k][c] = Dinv[jT + c][k]
#pragma unroll
  for (int e = 0; e < 16; ++e)
    SA[elem_col(e) * kKL + elem_row(e)] = v[e];
  stage_kmajor<T>(SB, Dinv, kTile, j * kTile, 0, (j + 1) * kTile);
  __syncthreads();
  T out[16];
  tile_product<T>(SA, SB, out);
  // the column tile j < nb - 1 is full, so every column index is < n
  const int row0 = (j + t) * kTile;
  const int col0 = j * kTile;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int gr = row0 + elem_row(e);
    if (gr < n) L[(size_t)gr * n + col0 + elem_col(e)] = out[e];
  }
  // the mirrored tile of the strict upper part: exact zeros
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile;
    const int c = e - r * kTile;
    if (row0 + c < n) L[(size_t)(col0 + r) * n + row0 + c] = T(0);
  }
}

// ---- host side ----

// The streams of the look-ahead, one set per device: diag and apply on a
// high-priority stream, the update on a low-priority side stream, ordered
// by events (updated[j % 2]: column j's update is done; applied[j % 2]:
// column j's apply is done, so column j + 2's update may overwrite the
// split buffer it read and read the panel it wrote).
struct LookAhead {
  bool ready = false;
  cudaStream_t hi, side;
  cudaEvent_t start, done, updated[2], applied[2];
};

static cudaError_t look_ahead(int device, LookAhead** out) {
  static LookAhead per_device[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  LookAhead& la = per_device[device];
  *out = &la;
  if (la.ready) return cudaSuccess;
  int least = 0, greatest = 0;
  cudaError_t err = cudaDeviceGetStreamPriorityRange(&least, &greatest);
  if (err != cudaSuccess) return err;
  if ((err = cudaStreamCreateWithPriority(&la.hi, cudaStreamNonBlocking,
                                          greatest)) != cudaSuccess ||
      (err = cudaStreamCreateWithPriority(&la.side, cudaStreamNonBlocking,
                                          least)) != cudaSuccess)
    return err;
  for (int k = 0; k < 2; ++k)
    if ((err = cudaEventCreateWithFlags(&la.updated[k],
                                        cudaEventDisableTiming)) !=
            cudaSuccess ||
        (err = cudaEventCreateWithFlags(&la.applied[k],
                                        cudaEventDisableTiming)) !=
            cudaSuccess)
      return err;
  if ((err = cudaEventCreateWithFlags(&la.start, cudaEventDisableTiming)) !=
          cudaSuccess ||
      (err = cudaEventCreateWithFlags(&la.done, cudaEventDisableTiming)) !=
          cudaSuccess)
    return err;
  la.ready = true;
  return cudaSuccess;
}

// the split buffers of column j under the caller's plan: the tile of A and
// the panel splits of its update
static int column_splits(const int* pps, int j) {
  return 1 + (j >= 2 ? (j - 1 + pps[j] - 1) / pps[j] : 0);
}

template <typename Src>
static cudaError_t launch_update(Src src, const float* L, float* ws, int n,
                                 int j, int nt, int ns, int pps,
                                 cudaStream_t s) {
  const int vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  chol_update_wgmma_kernel<Src>
      <<<dim3((nt + 1) / 2, ns), kUpThreads, kUpSmem, s>>>(src, L, ws, n, j,
                                                           nt, pps, vec);
  return cudaGetLastError();
}

template <typename Src>
static cudaError_t launch_update(Src src, const double* L, double* ws, int n,
                                 int j, int nt, int ns, int pps,
                                 cudaStream_t s) {
  chol_update_f64_kernel<Src><<<dim3(nt, ns), kThreads, 0, s>>>(src, L, ws, n,
                                                                j, pps);
  return cudaGetLastError();
}

#define EGP_TRY(call)                      \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

template <typename T, typename Src>
static int run_chol(Src src, T* L, T* Dinv, T* ws, long long ws_half,
                    const int* pps, int n, int device, cudaStream_t stream) {
  EGP_TRY(cudaSetDevice(device));
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int nb = (n + kTile - 1) / kTile;
  for (int j = 0; j < nb; ++j) {  // the caller's plan must fit
    if (j >= 2 && pps[j] < 1) return (int)cudaErrorInvalidValue;
    const int ns = column_splits(pps, j);
    if (ns > kMaxSplits || (long long)ns * (nb - j) * kTile * kTile > ws_half)
      return (int)cudaErrorInvalidValue;
  }
  LookAhead* la = nullptr;
  EGP_TRY(look_ahead(device, &la));
  if constexpr (std::is_same<T, float>::value)
    EGP_TRY(cudaFuncSetAttribute(chol_update_wgmma_kernel<Src>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kUpSmem));
  EGP_TRY(cudaFuncSetAttribute(chol_diag_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               diag_smem<T>()));
  const int apply_smem = 2 * kTile * kKL * (int)sizeof(T);
  EGP_TRY(cudaFuncSetAttribute(chol_apply_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               apply_smem));
  EGP_TRY(cudaEventRecord(la->start, stream));
  EGP_TRY(cudaStreamWaitEvent(la->hi, la->start, 0));
  EGP_TRY(cudaStreamWaitEvent(la->side, la->start, 0));
  for (int j = 0; j < nb; ++j) {
    const int nt = nb - j;
    const int ns = column_splits(pps, j);
    const size_t stride = (size_t)nt * kTile * kTile;
    const int b = j & 1;  // the buffer and events of this column's parity
    T* wj = ws + b * ws_half;
    // columns 0 and 1 write this call's own workspace; the events of their
    // parity were last recorded by an earlier call on these same in-order
    // streams, so a wait on them orders nothing, and a CUDA graph's
    // capture may wait only on events recorded inside it
    if (j >= 2) EGP_TRY(cudaStreamWaitEvent(la->side, la->applied[b], 0));
    EGP_TRY(launch_update(src, L, wj, n, j, nt, ns, j >= 2 ? pps[j] : 1,
                          la->side));
    EGP_TRY(cudaEventRecord(la->updated[b], la->side));
    EGP_TRY(cudaStreamWaitEvent(la->hi, la->updated[b], 0));
    chol_diag_kernel<T><<<1, kThreads, diag_smem<T>(), la->hi>>>(
        L, Dinv, wj, n, j, ns, stride);
    EGP_TRY(cudaGetLastError());
    if (j < nb - 1) {
      chol_apply_kernel<T><<<nt - 1, kThreads, apply_smem, la->hi>>>(
          L, Dinv, wj, n, j, ns, stride);
      EGP_TRY(cudaGetLastError());
    }
    EGP_TRY(cudaEventRecord(la->applied[b], la->hi));
  }
  EGP_TRY(cudaEventRecord(la->done, la->hi));
  EGP_TRY(cudaStreamWaitEvent(stream, la->done, 0));
  return 0;
}

template <typename T>
static int launch_chol(const T* A, T* L, T* Dinv, T* ws, long long ws_half,
                       const int* pps, int n, int device,
                       cudaStream_t stream) {
  PlainSource<T> src{A, n};
  return run_chol<T>(src, L, Dinv, ws, ws_half, pps, n, device, stream);
}

template <typename T>
static int launch_chol_gram(const T* x, const T* var, const unsigned char* mask,
                            T* L, T* Dinv, T* ws, long long ws_half,
                            const int* pps, int n, int d, int family,
                            int ncomp, const double* coefs,
                            const double* weights, int device,
                            cudaStream_t stream) {
  GramSource<T> src;
  if (d <= 0 || !make_family<T>(family, ncomp, coefs, weights, &src.fc))
    return (int)cudaErrorInvalidValue;
  src.x = x;
  src.var = var;
  src.mask = mask;
  src.n = n;
  src.d = d;
  return run_chol<T>(src, L, Dinv, ws, ws_half, pps, n, device, stream);
}

template <typename T>
static int launch_chol_joint(const T* x, const T* var_v, const T* var_g,
                             const unsigned char* smask,
                             const unsigned char* gmask, T* L, T* Dinv, T* ws,
                             long long ws_half, const int* pps, int n0, int d,
                             int family, double scale, int device,
                             cudaStream_t stream) {
  if (n0 <= 0 || d <= 0 || (family != kRbf && family != kMatern32))
    return (int)cudaErrorInvalidValue;
  JointSource<T> src{x, var_v, var_g, smask, gmask, n0, d, (1 + d) * n0,
                     family, (T)scale};
  return run_chol<T>(src, L, Dinv, ws, ws_half, pps, (1 + d) * n0, device,
                     stream);
}

}  // namespace egp

// Every entry: ws holds 2 * ws_half elements (the split buffers of the two
// column parities); pps[j] (host memory, nb = ceil(n / 64) entries) is the
// number of panels per split of column j's update, read for j >= 2
// (ops/chol.py::chol_plan).
extern "C" int egp_chol_f32(const float* A, float* L, float* Dinv, float* ws,
                            long long ws_half, const int* pps, int n,
                            int device, void* stream) {
  return egp::launch_chol<float>(A, L, Dinv, ws, ws_half, pps, n, device,
                                 (cudaStream_t)stream);
}

extern "C" int egp_chol_f64(const double* A, double* L, double* Dinv,
                            double* ws, long long ws_half, const int* pps,
                            int n, int device, void* stream) {
  return egp::launch_chol<double>(A, L, Dinv, ws, ws_half, pps, n, device,
                                  (cudaStream_t)stream);
}

extern "C" int egp_chol_gram_f32(const float* x, const float* var,
                                 const unsigned char* mask, float* L,
                                 float* Dinv, float* ws, long long ws_half,
                                 const int* pps, int n, int d, int family,
                                 int ncomp, const double* coefs,
                                 const double* weights, int device,
                                 void* stream) {
  return egp::launch_chol_gram<float>(x, var, mask, L, Dinv, ws, ws_half, pps,
                                      n, d, family, ncomp, coefs, weights,
                                      device, (cudaStream_t)stream);
}

extern "C" int egp_chol_gram_f64(const double* x, const double* var,
                                 const unsigned char* mask, double* L,
                                 double* Dinv, double* ws, long long ws_half,
                                 const int* pps, int n, int d, int family,
                                 int ncomp, const double* coefs,
                                 const double* weights, int device,
                                 void* stream) {
  return egp::launch_chol_gram<double>(x, var, mask, L, Dinv, ws, ws_half,
                                       pps, n, d, family, ncomp, coefs,
                                       weights, device, (cudaStream_t)stream);
}

extern "C" int egp_chol_joint_f32(const float* x, const float* var_v,
                                  const float* var_g,
                                  const unsigned char* smask,
                                  const unsigned char* gmask, float* L,
                                  float* Dinv, float* ws, long long ws_half,
                                  const int* pps, int n0, int d, int family,
                                  double scale, int device, void* stream) {
  return egp::launch_chol_joint<float>(x, var_v, var_g, smask, gmask, L, Dinv,
                                       ws, ws_half, pps, n0, d, family, scale,
                                       device, (cudaStream_t)stream);
}

extern "C" int egp_chol_joint_f64(const double* x, const double* var_v,
                                  const double* var_g,
                                  const unsigned char* smask,
                                  const unsigned char* gmask, double* L,
                                  double* Dinv, double* ws, long long ws_half,
                                  const int* pps, int n0, int d, int family,
                                  double scale, int device, void* stream) {
  return egp::launch_chol_joint<double>(x, var_v, var_g, smask, gmask, L,
                                        Dinv, ws, ws_half, pps, n0, d, family,
                                        scale, device, (cudaStream_t)stream);
}
