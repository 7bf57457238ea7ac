// 3xTF32 on Hopper's warpgroup products (wgmma, sm_90a), shared by
// csrc/trsm.cu, csrc/chol.cu and csrc/fitc.cu: the split of a float32 value into hi + lo
// TF32 parts, the core-matrix layout of a K-major shared-memory operand and
// its descriptor, and the m64nNk8 TF32 products with the A operand in
// registers. A product is taken as lo*hi + hi*lo + hi*hi with FP32
// accumulation (the convention of csrc/mma_tf32.cuh's mma.sync kernels).
//
// The tensor cores add into their accumulator with truncation, so a caller
// starts each partial product from zero (the products' `zero` flag) and
// adds it into its running sum by an FP32 add.
//
// Fragments, lane = 4 g + tq of warp w (0 .. 3) of the warpgroup:
//   A (64 x 8, registers): a0 (16 w + g, tq), a1 (16 w + g + 8, tq),
//                          a2 (16 w + g, tq + 4), a3 (16 w + g + 8, tq + 4)
//   D (64 x N)           : d[4 i + e] at row 16 w + g + 8 (e / 2), column
//                          8 i + 2 tq + e % 2
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace egp {

constexpr int kCoreK = 32;  // depth of one operand tile in the core layout

// split_tf32 (csrc/mma_tf32.cuh) by integer rounding: the same bits as
// cvt.rna (to nearest, ties away from zero) on the full-rate pipes
__device__ __forceinline__ unsigned rna_tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_rna(float v, unsigned& hi,
                                          unsigned& lo) {
  hi = rna_tf32_bits(v);
  lo = rna_tf32_bits(v - __uint_as_float(hi));
}

// A K-major operand tile of wgmma without swizzle, kCoreK deep: 8-row x
// 16-byte core matrices, core (r / 8, k / 4) at ((r / 8) 8 + k / 4) 128
// bytes, so cores adjacent along K lie 128 bytes apart (the descriptor's
// leading offset) and 8-row groups 1024 bytes apart (its stride offset).
__device__ __forceinline__ int core_index(int r, int k) {
  return ((r >> 3) * (kCoreK / 4) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
}

// the descriptor of the 8-deep step kk (0 .. 3) of a core tile
__device__ __forceinline__ uint64_t core_desc(const float* tile, int kk) {
  const unsigned a =
      (unsigned)__cvta_generic_to_shared(tile) + kk * 2 * 128;  // k8 step
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)(128 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// this thread's writes to shared memory, visible to the products (which
// read it through the async proxy) after the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128 over the warpgroup) = a (64 x 8, registers) b (8 x 128, the
// core tile at desc) + (zero ? 0 : d)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const unsigned (&a)[4],
                                                uint64_t desc, int zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(zero));
}

// d (64 x 64 over the warpgroup) = a (64 x 8, registers) b (8 x 64, the
// core tile at desc) + (zero ? 0 : d)
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t desc, int zero) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(zero));
}

}  // namespace egp
