// Batched Gauss-Jordan solve kernels for Hopper (sm_90a), plain C interface.
//
// K1  raft_impedance_gj_f64 replaces raft_tpu/ops/pallas/gj_solve.py:
//     impedance_gj_solve (body _impedance_kernel / _assemble_embedding):
//     per lane (case x frequency) the real 2n x 2n embedding of
//     Z = -w^2 M + i w B + C is assembled in registers from M, B, C and w
//     (Z is never written to memory), then equilibrated, eliminated with
//     partial pivoting and refined once.
// K2  raft_gj_solve_f64 replaces raft_tpu/ops/pallas/gj_solve.py:gj_solve
//     (body _gj_kernel / _gj_batchlast): the batched real solve A x = b
//     behind inv_complex / solve_complex.
//
// What bounds them on this card: at the shapes of the single-case path
// (one OC3 case = 80 lanes, about 0.8 KB of input per lane for K1) the
// work is far below one warp per SM, so the bound is launch latency, not
// the FP64 rate and not memory bytes.  The design is the simple one: one
// thread per lane, the per-lane arithmetic of gj_lane.cuh, the working
// block in local memory (it spills at n = 12), M and B read in their
// public (..., n, n, nw) layout so neighbouring threads (neighbouring
// frequencies) read neighbouring addresses.  A shared-memory,
// lane-fastest layout is the later redesign for large lane counts.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of cudaGetLastError()
// read right after the launch (cudaErrorInvalidValue for a shape that has
// no instantiation).
#include <cuda_runtime.h>

#include "gj_lane.cuh"

namespace {

constexpr int kThreads = 32;

template <int N>
__global__ void impedance_gj_kernel(const double* __restrict__ w,
                                    const double* __restrict__ M,
                                    const double* __restrict__ B,
                                    const double* __restrict__ C,
                                    const double* __restrict__ F,
                                    double* __restrict__ X, int lanes,
                                    int nw, int refine) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  gjl::impedance_lane<N>(w, M, B, C, F, X, nw, lane, refine);
}

template <int N, int K>
__global__ void gj_kernel(const double* __restrict__ A,
                          const double* __restrict__ b,
                          double* __restrict__ x, int lanes, int refine) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  gjl::gj_lane<N, K>(A, b, x, lane, refine);
}

template <int N>
void launch_impedance(const double* w, const double* M, const double* B,
                      const double* C, const double* F, double* X,
                      int lanes, int nw, int refine, cudaStream_t s) {
  int grid = (lanes + kThreads - 1) / kThreads;
  impedance_gj_kernel<N><<<grid, kThreads, 0, s>>>(w, M, B, C, F, X, lanes,
                                                   nw, refine);
}

template <int N, int K>
void launch_gj(const double* A, const double* b, double* x, int lanes,
               int refine, cudaStream_t s) {
  int grid = (lanes + kThreads - 1) / kThreads;
  gj_kernel<N, K><<<grid, kThreads, 0, s>>>(A, b, x, lanes, refine);
}

}  // namespace

extern "C" int raft_impedance_gj_f64(const double* w, const double* M,
                                     const double* B, const double* C,
                                     const double* F, double* X, int nb,
                                     int nw, int n, int refine,
                                     void* stream) {
  int lanes = nb * nw;
  if (lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch_impedance<1>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 2: launch_impedance<2>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 3: launch_impedance<3>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 4: launch_impedance<4>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 5: launch_impedance<5>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 6: launch_impedance<6>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 7: launch_impedance<7>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    case 8: launch_impedance<8>(w, M, B, C, F, X, lanes, nw, refine, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#define RAFT_GJ_CASE(NN)                                             \
  case NN:                                                          \
    if (k == 1) {                                                   \
      launch_gj<NN, 1>(A, b, x, lanes, refine, s);                  \
    } else if (k == (NN) / 2) {                                     \
      launch_gj<NN, ((NN) / 2 > 1 ? (NN) / 2 : 1)>(A, b, x, lanes,  \
                                                   refine, s);      \
    } else {                                                        \
      return static_cast<int>(cudaErrorInvalidValue);               \
    }                                                               \
    break;

// Systems of even size n <= 16 (every real embedding of a complex n/2
// system) with k = 1 or k = n/2 right-hand sides (solve_complex of one
// vector, inv_complex); the Python wrapper splits other k into chunks.
extern "C" int raft_gj_solve_f64(const double* A, const double* b,
                                 double* x, int lanes, int n, int k,
                                 int refine, void* stream) {
  if (lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    RAFT_GJ_CASE(2)
    RAFT_GJ_CASE(4)
    RAFT_GJ_CASE(6)
    RAFT_GJ_CASE(8)
    RAFT_GJ_CASE(10)
    RAFT_GJ_CASE(12)
    RAFT_GJ_CASE(14)
    RAFT_GJ_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raft_gj_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
