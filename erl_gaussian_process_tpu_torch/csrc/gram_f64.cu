// The float64 entry of the cross-gram kernel (gram.cuh).
#include "gram.cuh"

// as egp_gram_f32 (gram.cu)
extern "C" int egp_gram_f64(const double* x1, const double* x2,
                            const unsigned char* mask1, double* out,
                            int batch, int m, int n, int d, int family,
                            int ncomp, const double* coefs,
                            const double* weights, int device,
                            void* stream) {
  return egp::launch_gram<double>(x1, x2, mask1, out, batch, m, n, d, family,
                                  ncomp, coefs, weights, device,
                                  (cudaStream_t)stream);
}
