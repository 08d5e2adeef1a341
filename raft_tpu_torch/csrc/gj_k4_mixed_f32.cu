// K4: batched real solve, mixed ladder, f32 elimination (see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_gj_solve_mixed_f32(const double* A, const double* b,
                                     double* x, double* rn, int* promoted,
                                     int lanes, int n, int k, int refine,
                                     double tol, void* stream) {
  return gjk::gj<double, float>(A, b, x, rn, promoted, lanes, n, k, refine,
                              tol, stream);
}
