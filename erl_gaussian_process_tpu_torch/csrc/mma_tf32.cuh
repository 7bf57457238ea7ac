// 3xTF32 on the tensor cores (mma.sync m16n8k8, FP32 accumulation), used
// by csrc/bank.cu: each float32 operand is
// split into hi + lo TF32 parts (cvt.rna) and a product taken as lo*hi +
// hi*lo + hi*hi, the counterpart of the JAX kernels' bf16x3 _dot3x. Keeps
// about FP32 accuracy at the tensor cores' rate; plain TF32 (one product)
// would keep three decimal digits.
//
// Fragments of one m16n8k8 product, lane = 4 g + tq:
//   A (16 x 8, row): a0 (g, tq), a1 (g + 8, tq), a2 (g, tq + 4),
//                    a3 (g + 8, tq + 4)
//   B (8 x 8, col) : b0 (tq, g), b1 (tq + 4, g)
//   C (16 x 8)     : c0 (g, 2 tq), c1 (g, 2 tq + 1), c2 (g + 8, 2 tq),
//                    c3 (g + 8, 2 tq + 1)
#pragma once

#include <cuda_runtime.h>

namespace egp {

__device__ __forceinline__ unsigned to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace egp
