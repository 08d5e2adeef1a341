// K2 at float32 (RAFT_TPU_PRECISION=f32; see gj_kernels.cuh).
#include "gj_kernels.cuh"

extern "C" int raft_gj_solve_f32(const float* A, const float* b,
                                 float* x, int lanes, int n, int k,
                                 int refine, void* stream) {
  return gjk::gj<float, float>(A, b, x, nullptr, nullptr, lanes, n, k,
                               refine, 0.0, stream);
}
