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
// All four are one design: one lane per group of 16 threads, one row of
// the lane's system per thread (at most 16 rows), 8 lanes a block of 128
// threads, the per-row arithmetic in gj_group.cuh.  The block copies its
// 8 lanes' operands into shared memory with neighbouring threads on
// neighbouring addresses; each thread builds its own row there (K1/K3
// assemble it from the case's M, B, C and w, so Z never reaches device
// memory; K2/K4 equilibrate their staged row of A and b in place), pivots
// by a width-16 shuffle max-reduction over (|a|, position) and takes the
// normalised pivot row from a shared slot of its group; rows keep their
// place and swap logical positions.  A refinement eliminates the same
// matrix again, so it replays only the right-hand-side columns with the
// first elimination's pivots and multipliers (the same operations, bit for
// bit).  The ladder's residual (a group max over rows and right-hand
// sides) and the promotion to a T-width re-solve stay inside the group, in
// the same launch; the promoted count is one warp-aggregated atomicAdd.
// Every register array is indexed by compile-time constants, each row's
// As waits in shared memory, and no division calls a subroutine
// (gjg::quot), so nothing lives in local memory.
//
// What bounded the one-lane-a-thread design this replaced (each thread's
// working block a per-thread array with rows swapped at run-time pivots):
// local memory.  K1 f64's ~1.25 KB a thread at 81,920 lanes exceeded L1
// and L2, so every pivot step's read-modify-write went to HBM (1.461 ms
// against a 0.0189 ms byte bound); K2/K4 at n = 12, k = 6 ran 80 lanes as
// 80 threads on 3 SMs, each thread's 12 x 18 block in local memory (K2 f64
// 254 registers and 564 bytes of spill, K4 f32 1504 bytes), so a launch
// cost one thread's serial latency, 0.13-0.63 ms, against byte bounds of
// 5.5e-5 to 3.5e-3 ms (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
// What bounds this one on the same card: neither bytes nor FP64, but
// issuing each pivot step's exchange - a shuffle butterfly over (key,
// position), the pivot row through shared memory, one division a thread,
// two __syncwarp - for a few FMAs a thread, with the rows past n idle (a
// quarter of each group at K1's n = 6 and K2's n = 12), and the occupancy
// that hides its latency: the per-size launch bounds below.  K2 f64 at
// n = 12, k = 6 compiles to 3000 static instructions (538 FP64, 144
// shuffles, no local access): 0.0079 ms of device time at 80 lanes, one
// group's chain of 12 pivot steps and 12 refinement steps behind a launch,
// and 0.0171 ms at 5120 lanes (640 blocks, all resident at 8 an SM),
// against byte bounds of 5.5e-5 and 3.5e-3 ms.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing, and returns the cudaError_t of cudaGetLastError()
// read right after the launch (cudaErrorInvalidValue for a shape that has
// no instantiation).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "gj_group.cuh"
#include "gj_lane.cuh"

namespace gjk {

constexpr int kThreads = gjg::kGroup * gjg::kTileF;  // 128, 8 lanes a block
constexpr int kSlot = gjg::kGroup + 1;  // K1/K3's [As | rhs] columns

// add this warp's promoted lanes to *promoted with one atomic
__device__ inline void count_promoted(int* promoted, bool p) {
  unsigned active = __activemask();
  unsigned m = __ballot_sync(active, p);
  if (m && static_cast<int>(threadIdx.x & 31u) == __ffs(active) - 1)
    atomicAdd(promoted, __popc(m));
}

// A group's exchange slots in shared memory: the pivot row as its owner
// wrote it and normalised (one column a thread), at either width (two
// __syncwarp a step order every write after the reads of the step before,
// so one buffer each suffices); a K = 1 refinement step's normalised
// right-hand side (one __syncwarp a step: two buffers, alternating by
// step; K > 1 refinements pass theirs through the pivot-row buffers); and
// the solution, S x K row-major.  C: [As | rhs] columns; X: S * K.
template <typename T, int C, int X>
struct Slots {
  double rawd[C];
  double outd[C];
  float rawf[C];
  float outf[C];
  double rhsd[2];
  float rhsf[2];
  T xs[X];
};

// K1/K3's slots also hold each row's equilibrated As (each thread reads
// only its own), which would otherwise take 2n registers at T.
template <typename T>
struct ImpSlots : Slots<T, kSlot, gjg::kGroup> {
  T as[gjg::kGroup][kSlot];  // stride kSlot: no bank conflict
};

// The card's group policy for the body of gj_group.cuh: the thread holds
// its own row (kLanes = 1); the 16 threads of a group meet in width-16
// shuffles and the group's shared slots SL.  Both groups of a warp run
// every exchange together (the ragged edge's idle group solves a copy of
// a live lane, and a promoted re-solve runs if either group needs it), so
// every shuffle and __syncwarp takes the full warp mask, which the
// compiler issues without a convergence sequence.
template <typename T, typename SL>
struct DevGroup {
  static constexpr int kLanes = 1;
  static constexpr unsigned mask = 0xffffffffu;
  SL& sl;
  int r;

  __device__ __forceinline__ DevGroup(SL& s, int tid)
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

  template <typename W>
  __device__ __forceinline__ void buffers(gjg::slot_t<W>*& raw,
                                          gjg::slot_t<W>*& out) {
    if constexpr (std::is_same<gjg::slot_t<W>, double>::value) {
      raw = sl.rawd;
      out = sl.outd;
    } else {
      raw = sl.rawf;
      out = sl.outf;
    }
  }

  // columns KK+1 .. S+K-1 normalised, one a thread (two where the row is
  // wider than the group)
  template <int KK, typename W, int S, int K>
  __device__ __forceinline__ const gjg::slot_t<W>* pivot_row(
      const gjg::Work<W, S, K>* wk) {
    gjg::slot_t<W>* raw;
    gjg::slot_t<W>* out;
    buffers<W>(raw, out);
    if (wk[0].pos == KK) {
#pragma unroll
      for (int j = KK; j < S + K; ++j) raw[j] = gjg::to_slot(wk[0].a[j]);
    }
    __syncwarp(mask);
    const int j = KK + 1 + r;
    if (j < S + K) out[j] = gjg::pivot_entry<W>(raw[j], raw[KK]);
    if constexpr (S + K - 1 - KK > gjg::kGroup) {
      const int j2 = j + gjg::kGroup;
      if (j2 < S + K) out[j2] = gjg::pivot_entry<W>(raw[j2], raw[KK]);
    }
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

  // the pivot row's K right-hand sides normalised: at K = 1 by the pivot
  // thread (one __syncwarp), else one a thread through the pivot-row
  // buffers (two)
  template <int KK, typename W, int S, int K>
  __device__ __forceinline__ const gjg::slot_t<W>* pivot_rhs(
      const gjg::Work<W, S, K>* wk) {
    if constexpr (K == 1) {
      gjg::slot_t<W>* d;
      if constexpr (std::is_same<gjg::slot_t<W>, double>::value)
        d = &sl.rhsd[KK & 1];
      else
        d = &sl.rhsf[KK & 1];
      if (wk[0].pos == KK)
        *d = gjg::pivot_entry<W>(gjg::to_slot(wk[0].a[S]),
                                 gjg::to_slot(wk[0].c[KK]));
      __syncwarp(mask);
      return d;
    } else {
      gjg::slot_t<W>* raw;
      gjg::slot_t<W>* out;
      buffers<W>(raw, out);
      if (wk[0].pos == KK) {
        raw[KK] = gjg::to_slot(wk[0].c[KK]);
#pragma unroll
        for (int c = 0; c < K; ++c) raw[S + c] = gjg::to_slot(wk[0].a[S + c]);
      }
      __syncwarp(mask);
      if (r < K) out[S + r] = gjg::pivot_entry<W>(raw[S + r], raw[KK]);
      __syncwarp(mask);
      return out + S;
    }
  }

  // the row at position i adds its components into row i of x (positions
  // are unique, so the group's rows never write one entry twice)
  template <typename W, int S, int K, typename R>
  __device__ __forceinline__ void publish_x(const gjg::Work<W, S, K>* wk,
                                            const R* rw, bool first,
                                            bool keep) {
    if (keep && rw[0].active) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const T d = gjl::to<T>(wk[0].a[S + c]);
        T& xe = sl.xs[wk[0].pos * K + c];
        xe = first ? d : xe + d;
      }
    }
    __syncwarp(mask);
  }
};

// ---- K1 / K3: impedance, one (case, frequency) lane a group ----

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
__global__ void __launch_bounds__(kThreads, imp_min_blocks(N))
    impedance_group_kernel(const T* __restrict__ w, const T* __restrict__ M,
                           const T* __restrict__ B, const T* __restrict__ C,
                           const T* __restrict__ F, T* __restrict__ X,
                           T* __restrict__ rn, int* promoted, int nw,
                           int refine, double tol) {
  __shared__ gjg::Tile<T, N> tile;
  __shared__ ImpSlots<T> slots[gjg::kTileF];
  const int ntile = (nw + gjg::kTileF - 1) / gjg::kTileF;
  const int b = blockIdx.x / ntile;
  const int f0 = (blockIdx.x - b * ntile) * gjg::kTileF;
  const int grp = threadIdx.x / gjg::kGroup;
  gjg::stage(tile, w, M, B, C, F, b, f0, nw, threadIdx.x, blockDim.x);
  __syncthreads();
  // a group past the last frequency solves the tile's last live lane again
  // and writes nothing
  const bool live = f0 + grp < nw;
  DevGroup<T, ImpSlots<T>> g(slots[grp], threadIdx.x);
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

// ---- K2 / K4: batched A x = b, one system a group ----

// Resident blocks an SM asked of ptxas for an n x n system with k
// right-hand sides at width T (`ladder`: a float or bf16 elimination and a
// T-width re-solve in one kernel): the most that each instantiation fits
// without a stack frame or spill, of 3, 4, 5, 6 and 8 blocks (65,536
// registers / (128 threads x blocks): 64 at 8, 80 at 6, 96 at 5, 128 at 4,
// 168 at 3), as -Xptxas -v reported them for sm_90a; at n = 16 the f64
// tile (~40 KB at k = 8) holds 5 blocks an SM in shared memory anyway.
// The need does not grow evenly with n and k (the ladder spills at
// (10, 5) and (14, 7) where it fits (12, 6) at 8), so this is a table.
constexpr int gj_min_blocks(int n, int k, int bytes, bool ladder) {
  if (bytes == 4 || n <= 8) return 8;
  if (n == 16) return 5;
  if (n == 14) return ladder && k > 1 ? 3 : 6;
  if (!ladder) return 8;
  if (n == 10) return k == 1 ? 8 : 5;
  return k == 1 ? 6 : 8;  // n = 12
}

// One block: systems lane0 .. lane0 + 7, group g on system lane0 + g.
// A (lanes, N, N), b and x (lanes, N, K) row-major; rn (lanes), read only
// on the ladder.
template <typename T, typename E, int N, int K>
__global__ void __launch_bounds__(
    kThreads, gj_min_blocks(N, K, sizeof(T), !std::is_same<T, E>::value))
    gj_group_kernel(const T* __restrict__ A, const T* __restrict__ b,
                    T* __restrict__ x, T* __restrict__ rn, int* promoted,
                    int lanes, int refine, double tol) {
  using SL = Slots<T, N + K, N * K>;
  __shared__ gjg::GjTile<T, N, K> tile;
  __shared__ SL slots[gjg::kTileL];
  const int lane0 = blockIdx.x * gjg::kTileL;
  const int grp = threadIdx.x / gjg::kGroup;
  gjg::stage_gj(tile, A, b, lane0, lanes, threadIdx.x, blockDim.x);
  __syncthreads();
  // a group past the last system solves a copy of it and writes nothing
  const bool live = lane0 + grp < lanes;
  DevGroup<T, SL> g(slots[grp], threadIdx.x);
  T r;
  const bool p = gjg::solve_system<T, E, N, K>(g, tile, grp, refine, tol, &r);
  if (live)
    gjg::store_x<N * K>(g.sl.xs, x + (size_t)(lane0 + grp) * N * K, g.r,
                        gjg::kGroup);
  const bool lead = live && g.r == 0 && p;
  if constexpr (!std::is_same<T, E>::value)
    if (live && g.r == 0) rn[lane0 + grp] = r;
  if constexpr (!std::is_same<T, E>::value) count_promoted(promoted, lead);
}

#define GJK_IMP_CASE(NN)                                                  \
  case NN:                                                                \
    impedance_group_kernel<T, E, NN><<<grid, kThreads, 0, s>>>(           \
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
  int grid = (lanes + gjg::kTileL - 1) / gjg::kTileL;
  if (k == 1) {
    gj_group_kernel<T, E, N, 1><<<grid, kThreads, 0, s>>>(
        A, b, x, rn, promoted, lanes, refine, tol);
  } else if (k == N / 2) {
    gj_group_kernel<T, E, N, N / 2><<<grid, kThreads, 0, s>>>(
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
