// The float32 entry of the cross-gram kernel (gram.cuh) and the library's
// error strings.
#include "gram.cuh"

// mask1: (batch, m) bytes, 0 for a row written as 0, or null.
extern "C" int egp_gram_f32(const float* x1, const float* x2,
                            const unsigned char* mask1, float* out, int batch,
                            int m, int n, int d, int family, int ncomp,
                            const double* coefs, const double* weights,
                            int device, void* stream) {
  return egp::launch_gram<float>(x1, x2, mask1, out, batch, m, n, d, family,
                                 ncomp, coefs, weights, device,
                                 (cudaStream_t)stream);
}

extern "C" const char* egp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
