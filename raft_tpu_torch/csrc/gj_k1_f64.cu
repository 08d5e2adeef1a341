// K1: fused impedance solve, float64 (see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_impedance_gj_f64(const double* w, const double* M,
                                     const double* B, const double* C,
                                     const double* F, double* X, int nb,
                                     int nw, int n, int refine,
                                     void* stream) {
  return gjk::impedance<double, double>(w, M, B, C, F, X, nullptr, nullptr,
                                        nb, nw, n, refine, 0.0, stream);
}

extern "C" const char* raft_gj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
