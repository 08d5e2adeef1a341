// K3: fused impedance solve, mixed ladder, bf16 elimination (see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_impedance_gj_mixed_bf16(
    const double* w, const double* M, const double* B, const double* C,
    const double* F, double* X, double* rn, int* promoted, int nb, int nw,
    int n, int refine, double tol, void* stream) {
  return gjk::impedance<double, gjl::bf16r>(w, M, B, C, F, X, rn, promoted, nb,
                                     nw, n, refine, tol, stream);
}
