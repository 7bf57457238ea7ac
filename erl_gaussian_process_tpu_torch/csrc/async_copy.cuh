// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by csrc/trsv.cu and csrc/chol.cu: a ring of tiles in shared memory is
// filled ahead of need, each thread copying its own pieces and waiting for
// its own groups; a __syncthreads() after the wait makes every thread's
// pieces visible to the block.
#pragma once

#include <cuda_runtime.h>

namespace egp {

// BYTES (4, 8 or 16) from src to dst; zero-filled, src not read, when
// !valid (src must still be a valid address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int nbytes = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(nbytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(BYTES), "r"(nbytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one R x W tile of a row-major matrix (leading dimension ld, rows r0..,
// columns c0..) into shared memory at stride kLd, entries past (nrows,
// ncols) zero: 16-byte copies when every row start is 16-byte aligned
// (vec), element copies otherwise
template <typename T, int R, int W, int kLd, int kThreads>
__device__ __forceinline__ void cp_tile(T* dst, const T* src, size_t ld,
                                        int r0, int c0, int nrows, int ncols,
                                        bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < R * W / V; e += kThreads) {
      const int r = e / (W / V);
      const int c = (e - r * (W / V)) * V;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async<16>(dst + r * kLd + c,
                   ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += kThreads) {
      const int r = e / W;
      const int c = e - r * W;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async<sizeof(T)>(dst + r * kLd + c,
                          ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

}  // namespace egp
