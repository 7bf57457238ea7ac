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
//   forward,  i = 0 .. nb-1: x_i = Dinv_i   (b_i - sum_{k < i} L[i, k]   x_k)
//   backward, i = nb-1 .. 0: x_i = Dinv_i^T (b_i - sum_{k > i} L[k, i]^T x_k)
//
// What bounds it on this card: each direction reads L's lower triangle once
// (n^2 / 2 values: 134 MB at n = 8192 float32, ~40 us at 3.35 TB/s) and does
// n^2 q multiply-adds, but x_i needs every x_k before it, so the solve is a
// chain of nb dependent steps. One launch per step (the first version) made
// it a chain of nb launches, ~8 us each (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md). The design: ONE cooperative launch per direction (and per 32
// right-hand-side columns) of persistent thread blocks, all resident at
// once (the grid is at most the co-resident count; the cooperative launch
// refuses a larger one instead of hanging). Row block i belongs to thread
// block i mod grid, each taking its row blocks in solving order. A thread
// block streams the tiles its rows need (L[i, k], then Dinv_i; they do not
// depend on x) through a ring of shared-memory stages with cp.async, ahead
// of need, so HBM latency stays off the chain; for each k in solving order
// it stages x_k as soon as it is published and adds the tile's product as
// a fresh partial (a two-level sum: a partial per 64 terms). Then x_i is
// formed and published: each 32-bit part of a value goes beside a ready
// mark in one 64-bit word, which the readers poll, so the value and its
// readiness travel together (no fence, no separate flag; an acquire/release
// flag per row block and a fence took ~2.6 us a step on the same card,
// PERF.md). The step on the critical path is one hop through L2 plus two
// 64 x 64 products.
// The smallest unsolved row block always has all its inputs, so the solve
// cannot deadlock. Each row's sum runs in a fixed k order with a fixed
// reduction tree, whatever the grid: results are bitwise the same for every
// grid size, with no atomics.
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace egp {

constexpr int B = 64;             // rows per block: the Cholesky's tile
constexpr int kTrsvQc = 32;       // right-hand-side columns per launch
constexpr int kTrsvThreads = 256; // 4 threads per row, 16 terms each
constexpr int kLd = B + 4;        // shared row stride of a staged tile

template <typename T>
struct TrsvStages {  // ring depth: 86 KB (f32, 2 blocks/SM), 138 KB (f64)
  static constexpr int k = sizeof(T) == 4 ? 4 : 3;
};

template <typename T, int QC>
constexpr int trsv_smem() {
  constexpr int xld = QC == 1 ? 1 : QC + 1;
  return (TrsvStages<T>::k * B * kLd + 2 * B * xld) * (int)sizeof(T);
}

// x is published to the other thread blocks word by word: each 32-bit part
// of a value beside a 1 in one aligned 64-bit word (the words are 0 on
// entry). A 64-bit access is single-copy atomic, so a reader that sees the
// 1 sees the part: no fence, no separate flag, and the poll that finds x_k
// ready also brings it.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

constexpr unsigned long long kReady = 1ull << 32;

__device__ __forceinline__ unsigned await_part(const unsigned long long* p) {
  unsigned long long v;
  do {
    v = ld_relaxed(p);
  } while (v < kReady);
  return (unsigned)v;
}

__device__ __forceinline__ void publish(unsigned long long* w, float v) {
  st_relaxed(w, kReady | __float_as_uint(v));
}
__device__ __forceinline__ void publish(unsigned long long* w, double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v);
  st_relaxed(w, kReady | (b & 0xffffffffull));
  st_relaxed(w + 1, kReady | (b >> 32));
}

template <typename T>
__device__ __forceinline__ T await(const unsigned long long* w);
template <>
__device__ __forceinline__ float await<float>(const unsigned long long* w) {
  return __uint_as_float(await_part(w));
}
template <>
__device__ __forceinline__ double await<double>(const unsigned long long* w) {
  const unsigned long long lo = await_part(w);
  const unsigned long long hi = await_part(w + 1);
  return __longlong_as_double((long long)(hi << 32 | lo));
}

// part[c] = sum_t M(r, t) X[t][c] over the 64 terms of one staged tile,
// M(r, t) = Ms[r][t] (TRANS: Ms[t][r]); thread (r, p) takes t = 4 s + p
// (conflict-free shared reads), and the four partials of a row are summed
// by two shuffles: every lane of the group holds the same value.
template <typename T, int QC, bool TRANS>
__device__ __forceinline__ void tile_gemv(const T* Ms, const T* X, int r,
                                          int p, T part[QC]) {
  constexpr int xld = QC == 1 ? 1 : QC + 1;
#pragma unroll
  for (int c = 0; c < QC; ++c) part[c] = T(0);
#pragma unroll
  for (int s = 0; s < B / 4; ++s) {
    const int t = 4 * s + p;
    const T m = TRANS ? Ms[t * kLd + r] : Ms[r * kLd + t];
#pragma unroll
    for (int c = 0; c < QC; ++c) part[c] = fma(m, X[t * xld + c], part[c]);
  }
#pragma unroll
  for (int c = 0; c < QC; ++c) {
    part[c] += __shfl_xor_sync(0xffffffffu, part[c], 1);
    part[c] += __shfl_xor_sync(0xffffffffu, part[c], 2);
  }
}

// b, x: n x q row-major; this launch solves columns c0 .. c0 + qc - 1
// (qc <= QC). words: x published, sizeof(T) / 4 words per value of x at
// ((row * q + column) * sizeof(T) / 4), 0 on entry.
template <typename T, int QC, bool TRANS>
__global__ void __launch_bounds__(kTrsvThreads)
    trsv_kernel(const T* __restrict__ L, const T* __restrict__ inv,
                const T* __restrict__ b, T* __restrict__ x,
                unsigned long long* __restrict__ words, int n, int q, int qc,
                int c0, int vec) {
  constexpr int R = sizeof(T) / 4;
  constexpr int S = TrsvStages<T>::k;
  constexpr int xld = QC == 1 ? 1 : QC + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* xs = ring + S * B * kLd;  // x_k, B x QC
  T* rs = xs + B * xld;        // b_i - sum, B x QC
  const int nb = (n + B - 1) / B;
  const int G = gridDim.x;
  const int r = threadIdx.x >> 2;
  const int p = threadIdx.x & 3;

  // the m-th row block of this thread block in solving order (-1: done);
  // its tiles: the nt - 1 L tiles in solving order of k, then Dinv_i
  auto row_block = [&](int m) {
    const int s = blockIdx.x + m * G;
    return s < nb ? (TRANS ? nb - 1 - s : s) : -1;
  };
  auto ntiles = [&](int i) { return TRANS ? nb - i : i + 1; };
  auto tile_k = [&](int t) { return TRANS ? nb - 1 - t : t; };
  auto issue = [&](int i, int t, T* dst) {
    if (t == ntiles(i) - 1) {
      cp_tile<T, B, B, kLd, kTrsvThreads>(dst, inv, B, i * B, 0, nb * B, B,
                                          true);
    } else {
      const int k = tile_k(t);
      const int row0 = (TRANS ? k : i) * B;
      const int col0 = (TRANS ? i : k) * B;
      cp_tile<T, B, B, kLd, kTrsvThreads>(dst, L, n, row0, col0, n, n,
                                          vec != 0);
    }
  };

  // producer: the next tile to copy, S - 1 tiles ahead of the consumer
  int pm = 0, pi = row_block(0), pt = 0, pslot = 0;
  auto produce = [&]() {
    if (pi >= 0) {
      issue(pi, pt, ring + pslot * B * kLd);
      if (++pt == ntiles(pi)) {
        pt = 0;
        pi = row_block(++pm);
      }
    }
    cp_commit();
    pslot = pslot + 1 == S ? 0 : pslot + 1;
  };
  for (int s = 0; s < S - 1; ++s) produce();

  int cslot = 0;
  for (int m = 0;; ++m) {
    const int i = row_block(m);
    if (i < 0) break;
    const int nt = ntiles(i);
    T acc[QC];
#pragma unroll
    for (int c = 0; c < QC; ++c) acc[c] = T(0);
    for (int t = 0; t < nt; ++t) {
      produce();  // into the slot the previous step freed
      cp_wait<S - 1>();
      const T* tile = ring + cslot * B * kLd;
      cslot = cslot + 1 == S ? 0 : cslot + 1;
      if (t < nt - 1) {
        const int k = tile_k(t);
        for (int e = threadIdx.x; e < B * qc; e += kTrsvThreads) {
          const int rr = e / qc;
          const int c = e - rr * qc;
          const int g = k * B + rr;
          xs[rr * xld + c] =
              g < n ? await<T>(words + ((size_t)g * q + c0 + c) * R) : T(0);
        }
        __syncthreads();
        T part[QC];
        tile_gemv<T, QC, TRANS>(tile, xs, r, p, part);
#pragma unroll
        for (int c = 0; c < QC; ++c) acc[c] += part[c];
      } else {
        const int g = i * B + r;
        if (p == 0) {
#pragma unroll
          for (int c = 0; c < QC; ++c)
            if (c < qc)
              rs[r * xld + c] =
                  g < n ? b[(size_t)g * q + c0 + c] - acc[c] : T(0);
        }
        __syncthreads();
        T xi[QC];
        tile_gemv<T, QC, TRANS>(tile, rs, r, p, xi);
        if (p == 0 && g < n) {
#pragma unroll
          for (int c = 0; c < QC; ++c)
            if (c < qc) {
              publish(words + ((size_t)g * q + c0 + c) * R, xi[c]);
              x[(size_t)g * q + c0 + c] = xi[c];
            }
        }
      }
      __syncthreads();  // the slot and xs are free for the next step
    }
  }
  cp_wait<0>();
}

template <typename T, int QC, bool TRANS>
static cudaError_t prepare(int device, int* most) {
  const int smem = trsv_smem<T, QC>();
  cudaError_t err = cudaFuncSetAttribute(
      trsv_kernel<T, QC, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, trsv_kernel<T, QC, TRANS>, kTrsvThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm * sms < *most) *most = per_sm * sms;
  return cudaSuccess;
}

// the largest grid every instance of the kernel keeps co-resident
template <typename T>
static cudaError_t max_grid(int device, int* most) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  *most = 1 << 30;
  if ((err = prepare<T, 1, false>(device, most)) != cudaSuccess) return err;
  if ((err = prepare<T, 1, true>(device, most)) != cudaSuccess) return err;
  if ((err = prepare<T, kTrsvQc, false>(device, most)) != cudaSuccess)
    return err;
  return prepare<T, kTrsvQc, true>(device, most);
}

template <typename T, int QC, bool TRANS>
static cudaError_t launch_one(const T* L, const T* inv, const T* b, T* x,
                              unsigned long long* words, int n, int q, int qc,
                              int c0, int vec, int grid, cudaStream_t stream) {
  void* args[] = {&L, &inv, &b, &x, &words, &n, &q, &qc, &c0, &vec};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(trsv_kernel<T, QC, TRANS>), dim3(grid),
      dim3(kTrsvThreads), args, trsv_smem<T, QC>(), stream);
}

template <typename T>
static int launch_trsv(const T* L, const T* inv, const T* b, T* x,
                       unsigned long long* words, int n, int q, bool trans,
                       int grid, int device, cudaStream_t stream) {
  if (n <= 0 || q <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  int most = 0;
  cudaError_t err = max_grid<T>(device, &most);  // sets the shared memory
  if (err != cudaSuccess) return (int)err;
  if (grid > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int vec = n % (16 / (int)sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(L) % 16 == 0;
  for (int c0 = 0; c0 < q; c0 += kTrsvQc) {
    const int qc = q - c0 < kTrsvQc ? q - c0 : kTrsvQc;
    if (qc == 1)
      err = trans ? launch_one<T, 1, true>(L, inv, b, x, words, n, q, qc, c0,
                                           vec, grid, stream)
                  : launch_one<T, 1, false>(L, inv, b, x, words, n, q, qc, c0,
                                            vec, grid, stream);
    else
      err = trans ? launch_one<T, kTrsvQc, true>(L, inv, b, x, words, n, q,
                                                 qc, c0, vec, grid, stream)
                  : launch_one<T, kTrsvQc, false>(L, inv, b, x, words, n, q,
                                                  qc, c0, vec, grid, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace egp

// The largest grid (thread blocks, all co-resident) the solve may be given
// at this dtype (f64 = 0 or 1) on this device, or minus a CUDA error code.
extern "C" int egp_trsv_max_grid(int f64, int device) {
  int most = 0;
  const cudaError_t err = f64 ? egp::max_grid<double>(device, &most)
                              : egp::max_grid<float>(device, &most);
  return err == cudaSuccess ? most : -(int)err;
}

// b (n x q, row-major) is read; x receives the solution; words holds
// n * q * sizeof(T) / 4 zeros (64-bit). trans = 0 solves L x = b, 1 solves
// L^T x = b; grid thread blocks, at most egp_trsv_max_grid.
extern "C" int egp_trsv_f32(const float* L, const float* inv, const float* b,
                            float* x, unsigned long long* words, int n, int q,
                            int trans, int grid, int device, void* stream) {
  return egp::launch_trsv<float>(L, inv, b, x, words, n, q, trans != 0, grid,
                                 device, (cudaStream_t)stream);
}

extern "C" int egp_trsv_f64(const double* L, const double* inv,
                            const double* b, double* x,
                            unsigned long long* words, int n, int q,
                            int trans, int grid, int device, void* stream) {
  return egp::launch_trsv<double>(L, inv, b, x, words, n, q, trans != 0, grid,
                                  device, (cudaStream_t)stream);
}
