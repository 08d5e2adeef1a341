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
// K1 / K3 (impedance_group_kernel): one block per case and 8 consecutive
// frequencies (128 threads), one group of 16 threads per (case,
// frequency) lane, one row of the 2n x 2n block per thread (2n <= 16),
// the per-row arithmetic in gj_imp_group.cuh.  The block copies its slices
// of M, B, F and the case's C into shared memory with neighbouring threads
// on neighbouring addresses, each thread assembles and equilibrates its
// own row there (Z never reaches device memory), pivots by a width-16
// shuffle max-reduction over (|a|, position) and takes the pivot row from
// a shared slot of its group; rows keep their place and swap logical
// positions.  A refinement eliminates the same matrix again, so it
// replays only the right-hand-side column with the first elimination's
// pivots and multipliers (the same operations, bit for bit).  The
// ladder's residual (a group max) and the promotion to a T-width re-solve
// stay inside the group, in the same launch; X goes back through shared
// memory so its stores coalesce too.  Every register array is indexed by
// compile-time constants, each row's As waits in shared memory, and no
// division calls a subroutine (gjg::quot), so nothing lives in local
// memory.
//
// What bounded the design it replaces (one lane a thread, the
// 12 x 13 block a per-thread array, pivot rows picked at run time): local
// memory.  Its ~1.25 KB (f64) a thread, ~100 MB at 81,920 lanes, exceeds
// L1 and the 50 MB L2, so every pivot step's read-modify-write went to HBM:
// on NVIDIA H100 80GB HBM3 (700 W) K1 f64 took 1.461 ms of device time at
// 81,920 lanes against a 0.0189 ms byte bound (77x) and 4.4x
// torch.linalg.solve's time on the same systems; K3 f32 1.085 ms.
// What bounds this one, on the same card (chip_smoke.py): neither bytes
// (K1 f64 at 81,920 lanes sits several times above its byte bound) nor
// FP64, but issuing each pivot step's exchange - a shuffle butterfly over
// (key, position), the pivot row through shared memory, one division a
// thread, two __syncwarp - for about 13 FMAs a thread, with a quarter of
// each group idle at n = 6.  Occupancy is what moved it most: the per-n
// launch bounds below and the As rows in shared memory keep the main
// paths' n = 6 kernels at 6 blocks an SM.
//
// K2 / K4 (gj_kernel) are still one lane a thread with the working block
// in local memory (gj_lane.cuh), bound by each thread's serial latency:
// 0.13-0.16 ms per launch at 80-5120 lanes against bounds of 5.5e-5 to
// 3.5e-3 ms.  The mixed ladder there runs the eliminations in f32 (or
// bf16 rounded in f32 registers) and promotes a lane in the same thread.
// In both, the promoted count is one warp-aggregated atomicAdd.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of cudaGetLastError()
// read right after the launch (cudaErrorInvalidValue for a shape that has
// no instantiation).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "gj_imp_group.cuh"
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

// ---- K1 / K3: one lane a group of 16 threads, one row a thread ----

constexpr int kImpThreads = gjg::kGroup * gjg::kTileF;  // 128
constexpr int kSlot = gjg::kGroup + 1;                  // [As | rhs] columns

// a group's exchange slots in shared memory: the pivot row as its owner
// wrote it and normalised (one column a thread), at either width (two
// __syncwarp a step order every write after the reads of the step before,
// so one buffer each suffices); a refinement step's normalised right-hand
// side (one __syncwarp a step: two buffers, alternating by step); the
// solution vector; and each row's equilibrated As (each thread reads only
// its own), which would otherwise hold 2n registers at T.
template <typename T>
struct GroupSlots {
  double rawd[kSlot];
  double outd[kSlot];
  float rawf[kSlot];
  float outf[kSlot];
  double rhsd[2];
  float rhsf[2];
  T xs[gjg::kGroup];
  T as[gjg::kGroup][kSlot];  // each row's As (stride kSlot: no bank conflict)
};

// The card's group policy for gjg::solve_lane (see gj_imp_group.cuh): the
// thread holds its own row (kLanes = 1); the 16 threads of a group meet in
// width-16 shuffles and the group's shared slots.  Both groups of a warp
// run every exchange together (the ragged edge's idle group solves a copy
// of a live lane, and a promoted re-solve runs if either group needs it),
// so every shuffle and __syncwarp takes the full warp mask, which the
// compiler issues without a convergence sequence.
template <typename T>
struct DevGroup {
  static constexpr int kLanes = 1;
  static constexpr unsigned mask = 0xffffffffu;
  GroupSlots<T>& sl;
  int r;

  __device__ __forceinline__ DevGroup(GroupSlots<T>& s, int tid)
      : sl(s), r(tid & (gjg::kGroup - 1)) {}

  __device__ __forceinline__ int rank(int) const { return r; }

  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(mask, p);
  }

  template <typename F>
  __device__ __forceinline__ gjg::Key argmax(F key) const {
    gjg::Key k = key(0);
#pragma unroll
    for (int o = gjg::kGroup / 2; o > 0; o >>= 1) {
      gjg::Key q;
      q.key = __shfl_xor_sync(mask, k.key, o, gjg::kGroup);
      q.pos = __shfl_xor_sync(mask, k.pos, o, gjg::kGroup);
      if (gjg::better(q, k)) k = q;
    }
    return k;
  }

  template <typename F>
  __device__ __forceinline__ auto max(F v) const -> decltype(v(0)) {
    auto m = v(0);
#pragma unroll
    for (int o = gjg::kGroup / 2; o > 0; o >>= 1)
      m = gjl::nan_max(m, __shfl_xor_sync(mask, m, o, gjg::kGroup));
    return m;
  }

  template <int KK, typename W, int S>
  __device__ __forceinline__ const gjg::slot_t<W>* pivot_row(
      const gjg::Work<W, S>* wk) {
    gjg::slot_t<W>* raw;
    gjg::slot_t<W>* out;
    if constexpr (std::is_same<gjg::slot_t<W>, double>::value) {
      raw = sl.rawd;
      out = sl.outd;
    } else {
      raw = sl.rawf;
      out = sl.outf;
    }
    if (wk[0].pos == KK) {
#pragma unroll
      for (int j = KK; j <= S; ++j) raw[j] = gjg::to_slot(wk[0].a[j]);
    }
    __syncwarp(mask);
    const int j = KK + 1 + r;
    if (j <= S) out[j] = gjg::pivot_entry<W>(raw[j], raw[KK]);
    __syncwarp(mask);
    return out;
  }

  template <typename>
  __device__ __forceinline__ T* x() {
    return sl.xs;
  }

  template <typename>
  __device__ __forceinline__ T* row_store(int) {
    return sl.as[r];
  }

  // the row at position i adds its component into x_i (positions are
  // unique, so the group's rows never write one entry twice)
  template <int KK, typename W, int S>
  __device__ __forceinline__ gjg::slot_t<W> pivot_rhs(
      const gjg::Work<W, S>* wk) {
    gjg::slot_t<W>* d;
    if constexpr (std::is_same<gjg::slot_t<W>, double>::value)
      d = &sl.rhsd[KK & 1];
    else
      d = &sl.rhsf[KK & 1];
    if (wk[0].pos == KK)
      *d = gjg::pivot_entry<W>(gjg::to_slot(wk[0].a[S]),
                               gjg::to_slot(wk[0].c[KK]));
    __syncwarp(mask);
    return *d;
  }

  template <typename W, int S>
  __device__ __forceinline__ void publish_x(const gjg::Work<W, S>* wk,
                                            const gjg::Row<T, S>* rw,
                                            bool first, bool keep) {
    if (keep && rw[0].active) {
      const T d = gjl::to<T>(wk[0].a[S]);
      sl.xs[wk[0].pos] = first ? d : sl.xs[wk[0].pos] + d;
    }
    __syncwarp(mask);
  }
};

// Resident blocks an SM asked of ptxas for size n: as many as the largest
// register budget that n fits without a stack frame or spill (65,536
// registers / (128 threads x blocks): 85 at 6 blocks, 102 at 5, 128 at 4);
// left to its default, ptxas held some instantiations at 64 registers and
// spilled a few values.
constexpr int imp_min_blocks(int n) { return n <= 6 ? 6 : (n == 7 ? 5 : 4); }

// One block: case b, frequencies f0 .. f0 + 7, group g on frequency f0 + g.
// w (nw); M, B (nb, N, N, nw); C (nb, N, N); F, X (nb, N, nw) complex,
// interleaved (re, im); rn (nb * nw) case-major, read only on the ladder.
template <typename T, typename E, int N>
__global__ void __launch_bounds__(kImpThreads, imp_min_blocks(N))
    impedance_group_kernel(const T* __restrict__ w, const T* __restrict__ M,
                           const T* __restrict__ B, const T* __restrict__ C,
                           const T* __restrict__ F, T* __restrict__ X,
                           T* __restrict__ rn, int* promoted, int nw,
                           int refine, double tol) {
  __shared__ gjg::Tile<T, N> tile;
  __shared__ GroupSlots<T> slots[gjg::kTileF];
  const int ntile = (nw + gjg::kTileF - 1) / gjg::kTileF;
  const int b = blockIdx.x / ntile;
  const int f0 = (blockIdx.x - b * ntile) * gjg::kTileF;
  const int grp = threadIdx.x / gjg::kGroup;
  gjg::stage(tile, w, M, B, C, F, b, f0, nw, threadIdx.x, blockDim.x);
  __syncthreads();
  // a group past the last frequency solves the tile's last live lane again
  // and writes nothing
  const bool live = f0 + grp < nw;
  DevGroup<T> g(slots[grp], threadIdx.x);
  T r;
  const bool p = gjg::solve_lane<T, E, N>(g, tile, live ? grp : nw - 1 - f0,
                                          live, refine, tol, &r);
  const bool lead = live && g.r == 0 && p;
  if constexpr (!std::is_same<T, E>::value)
    if (live && g.r == 0) rn[(size_t)b * nw + f0 + grp] = r;
  __syncthreads();
  gjg::writeback(tile, X, b, f0, nw, threadIdx.x, blockDim.x);
  if constexpr (!std::is_same<T, E>::value) count_promoted(promoted, lead);
}

// ---- K2 / K4: one lane a thread ----

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
    impedance_group_kernel<T, E, NN><<<grid, kImpThreads, 0, s>>>(        \
        w, M, B, C, F, X, rn, promoted, nw, refine, tol);                 \
    break;

// K1 / K3 for n = 1..8 (2n <= 16): one block per case and 8 frequencies
template <typename T, typename E>
int impedance(const T* w, const T* M, const T* B, const T* C, const T* F,
              T* X, T* rn, int* promoted, int nb, int nw, int n, int refine,
              double tol, void* stream) {
  if (nb <= 0 || nw <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = nb * ((nw + gjg::kTileF - 1) / gjg::kTileF);
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
