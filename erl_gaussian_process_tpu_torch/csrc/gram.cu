// Cross-gram K[i, j] = k(x1_i, x2_j) on Hopper.
//
// Replaces erl_gaussian_process_tpu/ops/pallas_gram.py::_gram_kernel (via
// _pallas_cross_gram_padded / pallas_cross_gram). On the main path it builds
// predict's k(P, x*) at (1152, n_query, d=3).
//
// What bounds it on an H100: the output write. Each element reads d
// coordinates that stay in L1/L2 and costs one exp (plus one sqrt), so at
// (1152, 2048) f32 the 9.4 MB write at 3.35 TB/s (~3 us) is the floor;
// the exp rate of the SFUs sits well above it.
//
// Design: one thread per output element, a 32-wide warp along the output
// row so the stores coalesce. A leading member axis (grid z) gives the
// batched entry that the sensor-GP banks' routed predict uses: member b's
// (m, n) gram of x1[b] (m, d) against x2[b] (n, d). x1 and x2 keep the JAX layout, (m, d) and
// (n, d) row-major; the kernel masks the ragged edge itself, so any m and n
// work and nothing is padded. The TPU kernel's transposed (d, n) operands
// and 256x512 tiles were VMEM/lane layout choices and are not carried over.
// Templated over float and double.
#include <cstddef>

#include "family.cuh"

namespace egp {

template <typename T>
__global__ void __launch_bounds__(256)
    gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                T* __restrict__ out, int m, int n, int d, FamilyArgs fa,
                T scale) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= m || j >= n) return;
  const size_t b = blockIdx.z;
  x1 += b * m * d;
  x2 += b * n * d;
  out += b * m * n;
  out[(size_t)i * n + j] = kernel_entry<T>(fa, x1 + (size_t)i * d,
                                           x2 + (size_t)j * d, d, scale);
}

template <typename T>
static int launch_gram(const T* x1, const T* x2, T* out, int batch, int m,
                       int n, int d, int family, int ncomp,
                       const double* ratios, const double* weights,
                       double scale, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FamilyArgs fa;
  if (batch <= 0 || m <= 0 || n <= 0 || d <= 0 ||
      !make_family_args(family, ncomp, ratios, weights, &fa))
    return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const int rows = (m + 7) / 8;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  // grid z takes at most 65535 members per launch
  for (int b0 = 0; b0 < batch; b0 += 65535) {
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    const dim3 grid((n + 31) / 32, rows, nb);
    gram_kernel<T><<<grid, block, 0, stream>>>(
        x1 + (size_t)b0 * m * d, x2 + (size_t)b0 * n * d,
        out + (size_t)b0 * m * n, m, n, d, fa, (T)scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace egp

extern "C" int egp_gram_f32(const float* x1, const float* x2, float* out,
                            int batch, int m, int n, int d, int family,
                            int ncomp, const double* ratios,
                            const double* weights, double scale, int device,
                            void* stream) {
  return egp::launch_gram<float>(x1, x2, out, batch, m, n, d, family, ncomp,
                                 ratios, weights, scale, device,
                                 (cudaStream_t)stream);
}

extern "C" int egp_gram_f64(const double* x1, const double* x2, double* out,
                            int batch, int m, int n, int d, int family,
                            int ncomp, const double* ratios,
                            const double* weights, double scale, int device,
                            void* stream) {
  return egp::launch_gram<double>(x1, x2, out, batch, m, n, d, family, ncomp,
                                  ratios, weights, scale, device,
                                  (cudaStream_t)stream);
}

extern "C" const char* egp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
