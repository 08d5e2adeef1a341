// K4: batched real solve, mixed ladder, bf16 elimination (see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_gj_solve_mixed_bf16(const double* A, const double* b,
                                     double* x, double* rn, int* promoted,
                                     int lanes, int n, int k, int refine,
                                     double tol, void* stream) {
  return gjk::gj<double, gjl::bf16r>(A, b, x, rn, promoted, lanes, n, k, refine,
                              tol, stream);
}
