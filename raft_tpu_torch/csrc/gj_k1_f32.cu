// K1 at float32 (RAFT_TPU_PRECISION=f32; see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_impedance_gj_f32(const float* w, const float* M,
                                     const float* B, const float* C,
                                     const float* F, float* X, int nb,
                                     int nw, int n, int refine,
                                     void* stream) {
  return gjk::impedance<float, float>(w, M, B, C, F, X, nullptr, nullptr,
                                      nb, nw, n, refine, 0.0, stream);
}
