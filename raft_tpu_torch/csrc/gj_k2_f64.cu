// K2: batched real solve, float64 (see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_gj_solve_f64(const double* A, const double* b,
                                 double* x, int lanes, int n, int k,
                                 int refine, void* stream) {
  return gjk::gj<double, double>(A, b, x, nullptr, nullptr, lanes, n, k,
                                 refine, 0.0, stream);
}
