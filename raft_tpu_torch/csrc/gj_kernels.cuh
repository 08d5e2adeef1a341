// Gauss-Jordan solve kernels for Hopper (sm_90a): the kernel templates and
// their launch dispatch, shared by the translation units gj_k*.cu (one per
// kernel and width, compiled in parallel by ops/kernels/_build.py).
//
// K1  impedance, T = E = double: replaces raft_tpu/ops/pallas/gj_solve.py:
//     impedance_gj_solve (pallas_call at :402; body _impedance_kernel /
//     _assemble_embedding).  Per lane (case x frequency) the real 2n x 2n
//     embedding of Z = -w^2 M + i w B + C is assembled from M, B, C and w
//     (Z is never written to memory), equilibrated, eliminated with
//     partial pivoting and refined.
// K2  gj, T = E = double: replaces gj_solve.py:gj_solve (pallas_call at
//     :216; body _gj_kernel / _gj_batchlast), the batched real solve
//     A x = b behind inv_complex / solve_complex.
// K3  impedance, T = double, E = float or bf16r: replaces the mixed
//     ladder of impedance_gj_solve (pallas_call at :424, body
//     _impedance_mixed_kernel, promotion pass :435-454).
// K4  gj, T = double, E = float or bf16r: replaces gj_solve(precision=
//     "mixed") (pallas_call at :233, body _gj_mixed_kernel, promotion
//     _promote_lanes_gj :247-267).
// K1 and K2 at T = E = float are the f32 instantiations
// (RAFT_TPU_PRECISION=f32).
//
// What bounds them on this card: each thread's serial latency.  One
// thread owns one lane and runs three eliminations of a 12 x 13 (K1) or
// 12 x 18 (K2, k = 6) block that lives in local memory; the card measured
// 0.07-0.17 ms per launch at 80-5120 lanes, 4-9x a prediction made from
// launch cost, with bytes and the FP64 rate both far below (bound
// 2e-5-4e-3 ms).  What the mixed ladder does about it: the three
// eliminations run in f32 (or bf16 rounded in f32 registers) on a working
// block half the size, so more of it stays in registers and each
// operation has the f32 pipe's latency; the residual and correction stay
// in FP64.  A lane whose residual misses the tolerance is promoted in
// the same thread (a full FP64 solve of its own inputs), so there is no
// second launch, no masking and no host sync, and the promoted count is
// one warp-aggregated atomicAdd.  The shared-memory / warp-per-lane
// redesign that shortens the serial chain itself is later work.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of cudaGetLastError()
// read right after the launch (cudaErrorInvalidValue for a shape that has
// no instantiation).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "gj_lane.cuh"

namespace gjk {

constexpr int kThreads = 32;

// add this warp's promoted lanes to *promoted with one atomic
__device__ inline void count_promoted(int* promoted, bool p) {
  unsigned active = __activemask();
  unsigned m = __ballot_sync(active, p);
  if (m && static_cast<int>(threadIdx.x & 31u) == __ffs(active) - 1)
    atomicAdd(promoted, __popc(m));
}

template <typename T, typename E, int N>
__global__ void impedance_kernel(const T* __restrict__ w,
                                 const T* __restrict__ M,
                                 const T* __restrict__ B,
                                 const T* __restrict__ C,
                                 const T* __restrict__ F, T* __restrict__ X,
                                 T* __restrict__ rn, int* promoted,
                                 int lanes, int nw, int refine, double tol) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  bool p = gjl::impedance_lane<T, E, N>(w, M, B, C, F, X, rn, nw, lane,
                                        refine, tol);
  if constexpr (!std::is_same<T, E>::value) count_promoted(promoted, p);
}

template <typename T, typename E, int N, int K>
__global__ void gj_kernel(const T* __restrict__ A, const T* __restrict__ b,
                          T* __restrict__ x, T* __restrict__ rn,
                          int* promoted, int lanes, int refine, double tol) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  bool p = gjl::gj_lane<T, E, N, K>(A, b, x, rn, lane, refine, tol);
  if constexpr (!std::is_same<T, E>::value) count_promoted(promoted, p);
}

#define GJK_IMP_CASE(NN)                                                  \
  case NN:                                                                \
    impedance_kernel<T, E, NN><<<grid, kThreads, 0, s>>>(                 \
        w, M, B, C, F, X, rn, promoted, lanes, nw, refine, tol);          \
    break;

// K1 / K3 for n = 1..8 (2n <= 16)
template <typename T, typename E>
int impedance(const T* w, const T* M, const T* B, const T* C, const T* F,
              T* X, T* rn, int* promoted, int nb, int nw, int n, int refine,
              double tol, void* stream) {
  int lanes = nb * nw;
  if (lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = (lanes + kThreads - 1) / kThreads;
  switch (n) {
    GJK_IMP_CASE(1)
    GJK_IMP_CASE(2)
    GJK_IMP_CASE(3)
    GJK_IMP_CASE(4)
    GJK_IMP_CASE(5)
    GJK_IMP_CASE(6)
    GJK_IMP_CASE(7)
    GJK_IMP_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// systems of size N with k = 1 or k = N/2 right-hand sides (solve_complex
// of one vector, inv_complex); the Python wrapper splits other k
template <typename T, typename E, int N>
int gj_n(const T* A, const T* b, T* x, T* rn, int* promoted, int lanes,
         int k, int refine, double tol, cudaStream_t s) {
  int grid = (lanes + kThreads - 1) / kThreads;
  if (k == 1) {
    gj_kernel<T, E, N, 1><<<grid, kThreads, 0, s>>>(A, b, x, rn, promoted,
                                                    lanes, refine, tol);
  } else if (k == N / 2) {
    gj_kernel<T, E, N, (N / 2 > 1 ? N / 2 : 1)><<<grid, kThreads, 0, s>>>(
        A, b, x, rn, promoted, lanes, refine, tol);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 / K4 for even n <= 16 (every real embedding of a complex n/2 system)
template <typename T, typename E>
int gj(const T* A, const T* b, T* x, T* rn, int* promoted, int lanes, int n,
       int k, int refine, double tol, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return gj_n<T, E, 2>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 4: return gj_n<T, E, 4>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 6: return gj_n<T, E, 6>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 8: return gj_n<T, E, 8>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 10: return gj_n<T, E, 10>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 12: return gj_n<T, E, 12>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 14: return gj_n<T, E, 14>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    case 16: return gj_n<T, E, 16>(A, b, x, rn, promoted, lanes, k, refine, tol, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gjk
