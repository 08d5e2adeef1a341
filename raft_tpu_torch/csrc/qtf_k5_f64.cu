// K5: the slender-body QTF pair grid, float64 (see qtf_pair.cuh for what
// it computes, what bounds it and the design).
//
// One call launches three kernels on the caller's stream:
//  1. qtf_k5_records: one thread per (frequency, submerged node) writes
//     that record into the scratch (frequency fastest, so the lane-last
//     inputs are read and the records written coalesced); the thread of
//     frequency 0 also writes the node's record; further blocks write
//     each pair's constants (one thread a pair) and its own terms,
//     Pinkster IV and the waterline members (qtf::kLanes lanes a pair,
//     summed by a shuffle tree);
//  2. qtf_k5_pairs: a block per (tile of kT x kT pairs, share of the
//     submerged nodes) of 2 kT^2 threads, two a pair: warps 0-7 take part
//     A of each node's wrench, warps 8-15 part B (qtf::node_pair_a, _b),
//     so each thread's state fits 128 registers and no warp diverges; the
//     share's nodes are staged one at a time into shared memory with
//     cp.async, double-buffered, and each thread adds its part in node
//     order into its 12 running sums in shared memory; the two parts' sums
//     (A + B) are stored as the share's partial sum;
//  3. qtf_k5_finish: qtf::kLanes lanes a pair add the shares' partial sums,
//     lane by lane, then by a shuffle tree, and lane 0 adds the pair's own
//     terms and writes Q.
// No floating-point atomics: every sum runs in a fixed order.
#include <cuda_runtime.h>

#include <stdint.h>

#include "qtf_pair.cuh"

namespace {

using qtf::cd;

// the record pass: 128 threads a block, at least 4 blocks an SM, which
// caps it at 128 registers a thread
constexpr int kRecordThreads = 128;

// the shuffle tree over a pair's qtf::kLanes lanes (lane 0 ends with the
// sum; qtf::lane_tree is its order)
__device__ __forceinline__ void lanes_sum(double* v) {
#pragma unroll
  for (int d = qtf::kLanes / 2; d > 0; d /= 2)
#pragma unroll
    for (int c = 0; c < 12; ++c)
      v[c] += __shfl_down_sync(0xffffffffu, v[c], d, qtf::kLanes);
}

// Blocks [0, nrb) write the records (thread t: frequency t % nw2 of
// submerged node t / nw2; frequency 0's thread also the node's record);
// blocks [nrb, nrb + ncb) the pair constants (thread t: pair t; constant
// c at consts[c npair + t]); the rest each pair's own terms (kLanes lanes
// a pair).
__global__ void __launch_bounds__(kRecordThreads, 4)
qtf_k5_records(qtf::Fields a, cd* scratch, int nrb, int ncb) {
  const int nw2 = a.nw2, npair = nw2 * nw2;
  const int blk = blockIdx.x;
  if (blk < nrb) {
    const int t = blk * kRecordThreads + threadIdx.x;
    if (t >= a.nsub * nw2) return;
    const int f = t % nw2, j = t / nw2;
    qtf::record_fill(a, f, j, scratch + qtf::record_offset(j, 0, f, nw2),
                     static_cast<size_t>(nw2));
    if (f == 0)
      qtf::node_fill(a, j, reinterpret_cast<double*>(
                               scratch + qtf::node_offset(j, nw2, a.nsub)));
    return;
  }
  if (blk < nrb + ncb) {
    const int t = (blk - nrb) * kRecordThreads + threadIdx.x;
    if (t >= npair) return;
    double c[qtf::kPairConsts];
    qtf::pair_consts(a, t / nw2, t % nw2, c);
    double* dst = reinterpret_cast<double*>(
        scratch + qtf::consts_offset(nw2, a.nsub));
#pragma unroll
    for (int i = 0; i < qtf::kPairConsts; ++i)
      dst[(size_t)i * npair + t] = c[i];
    return;
  }
  // lanes past the last pair stay for the shuffles and add nothing
  const int lane = threadIdx.x % qtf::kLanes;
  const int t = (blk - nrb - ncb) * (kRecordThreads / qtf::kLanes) +
                threadIdx.x / qtf::kLanes;
  double v[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) v[c] = 0.0;
  if (t < npair) qtf::pair_terms_lane(a, t / nw2, t % nw2, lane, v);
  lanes_sum(v);
  if (lane == 0 && t < npair) {
    double* dst = reinterpret_cast<double*>(
        scratch + qtf::terms_offset(nw2, a.nsub)) + (size_t)t * 12;
#pragma unroll
    for (int c = 0; c < 12; ++c) dst[c] = v[c];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the pair pass's block: two threads a pair of its kT x kT tile; each
// thread stages the granules threadIdx.x + g kPairBlock of every node
constexpr int kPairBlock = 2 * qtf::kPairThreads;
constexpr int kThreadGranules = (qtf::kGranules + kPairBlock - 1) / kPairBlock;

// The pair pass's shared memory: two stages; each thread's 12 running
// sums (by sum, then thread); each pair's constants (qtf::kPairConsts
// doubles by pair) and the tile's 2 kT frequencies.  Nothing but the
// node body's own values occupies a register across the node loop.
// 108,352 bytes, dynamic; at <= 128 registers a thread one block of
// kPairBlock = 512 threads (16 warps) fits an SM.
constexpr size_t kPairSmem =
    sizeof(cd) * 2 * qtf::kStage +
    sizeof(double) * (12 * kPairBlock + qtf::kPairConsts * qtf::kPairThreads +
                      qtf::kSlots);

// the block barrier in the form that may sit in code that only some warps
// run (each warp whole): the two parts' node loops are separate code, so
// each is register-allocated alone, and both meet at every barrier
__device__ __forceinline__ void block_barrier() {
  asm volatile("barrier.sync 0;\n" ::: "memory");
}

// Stage node j into st: thread t copies granules t, t + kPairBlock, ...
// (the granule map of qtf::stage_granule)
__device__ __forceinline__ void stage_node(const cd* scratch, int j, int r0,
                                           int c0, int nw2, int nsub, cd* st) {
#pragma unroll
  for (int g = 0; g < kThreadGranules; ++g) {
    const int idx = threadIdx.x + g * kPairBlock;
    if (idx < qtf::kGranules) {
      int src, step;
      qtf::stage_granule(idx, r0, c0, nw2, nsub, &src, &step);
      cp_async16(st + idx, scratch + (src + (size_t)j * step));
    }
  }
  cp_async_commit();
}

// walk nodes [j0, j1) (node j0 already staged in stage 0), adding part
// kPart of each node's wrench for this thread's pair into its sums
template <int kPart>
__device__ __forceinline__ void walk_nodes(const cd* scratch, cd* st0,
                                           double* acc, const double* pc,
                                           const double* wt, int j0, int j1,
                                           int r0, int c0, int nw2, int nsub,
                                           int pt, double mrho) {
  const int ty = pt / qtf::kT, tx = pt % qtf::kT;
  for (int j = j0; j < j1; ++j) {
    const int b = (j - j0) & 1;
    if (j + 1 < j1) {
      stage_node(scratch, j + 1, r0, c0, nw2, nsub,
                 st0 + (b ^ 1) * qtf::kStage);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    block_barrier();
    const cd* s = st0 + b * qtf::kStage;
    const double* nr =
        reinterpret_cast<const double*>(s + qtf::kRec * qtf::kSlots);
    if constexpr (kPart == 0) {
      const qtf::Pair P = qtf::pair_from(pc + pt, qtf::kPairThreads, wt[ty],
                                         wt[qtf::kT + tx]);
      qtf::node_pair_a<qtf::kSlots>(s + ty, s + qtf::kT + tx, nr, P, acc,
                                    kPairBlock);
    } else {
      qtf::node_pair_b<qtf::kSlots>(s + ty, s + qtf::kT + tx, nr, mrho, acc,
                                    kPairBlock);
    }
    block_barrier();
  }
}

__global__ void __launch_bounds__(kPairBlock, 1)
qtf_k5_pairs(qtf::Fields a, const cd* scratch, double* part, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  cd* st0 = reinterpret_cast<cd*>(smem);
  double* accs = reinterpret_cast<double*>(st0 + 2 * qtf::kStage);
  double* pc = accs + 12 * kPairBlock;
  double* wt = pc + qtf::kPairConsts * qtf::kPairThreads;
  const int nw2 = a.nw2, nsub = a.nsub;
  const int ntc = (nw2 + qtf::kT - 1) / qtf::kT;
  const int r0 = (blockIdx.x / ntc) * qtf::kT;
  const int c0 = (blockIdx.x % ntc) * qtf::kT;
  // part A in warps 0-7, part B in warps 8-15: a warp-uniform role
  const int role = threadIdx.x / qtf::kPairThreads;
  const int pt = threadIdx.x % qtf::kPairThreads;
  const int i1 = r0 + pt / qtf::kT, i2 = c0 + pt % qtf::kT;
  const int j0 = blockIdx.y * per;
  const int j1 = min(nsub, j0 + per);
  stage_node(scratch, j0, r0, c0, nw2, nsub, st0);
  // this thread's sums: accs[c kPairBlock + threadIdx.x]
  double* acc = accs + threadIdx.x;
#pragma unroll
  for (int c = 0; c < 12; ++c) acc[c * kPairBlock] = 0.0;
  if (threadIdx.x < qtf::kPairThreads) {
    const int npair = nw2 * nw2;
    const int t = (i1 < nw2 ? i1 : nw2 - 1) * nw2 + (i2 < nw2 ? i2 : nw2 - 1);
    const double* c = reinterpret_cast<const double*>(
                          scratch + qtf::consts_offset(nw2, nsub)) + t;
#pragma unroll
    for (int i = 0; i < qtf::kPairConsts; ++i)
      pc[i * qtf::kPairThreads + pt] = c[(size_t)i * npair];
  }
  if (static_cast<int>(threadIdx.x) >= kPairBlock - qtf::kSlots) {
    const int k = threadIdx.x - (kPairBlock - qtf::kSlots);
    const int f = k < qtf::kT ? r0 + k : c0 + k - qtf::kT;
    wt[k] = a.w[f < nw2 ? f : nw2 - 1];
  }
  if (role == 0)
    walk_nodes<0>(scratch, st0, acc, pc, wt, j0, j1, r0, c0, nw2, nsub, pt,
                  0.0);
  else
    walk_nodes<1>(scratch, st0, acc, pc, wt, j0, j1, r0, c0, nw2, nsub, pt,
                  -a.rho);
  // both parts' sums are in shared memory: A + B is the share's sum
  if (role == 0 && i1 < nw2 && i2 < nw2) {
    double* out = part + ((size_t)blockIdx.y * nw2 * nw2 +
                          (size_t)i1 * nw2 + i2) * 12;
#pragma unroll
    for (int c = 0; c < 12; ++c)
      out[c] = acc[c * kPairBlock] + acc[c * kPairBlock + qtf::kPairThreads];
  }
}

// kLanes lanes a pair, 256 threads a block; at least 2 blocks an SM caps
// the pass at 128 registers a thread
constexpr int kFinishThreads = 256;
constexpr int kFinishPairs = kFinishThreads / qtf::kLanes;

__global__ void __launch_bounds__(kFinishThreads, 2)
qtf_k5_finish(int nw2, const double* terms, const double* part, int splits,
              cd* Q) {
  const int lane = threadIdx.x % qtf::kLanes;
  const int t = blockIdx.x * kFinishPairs + threadIdx.x / qtf::kLanes;
  const int npair = nw2 * nw2;
  // lanes past the last pair stay for the shuffles and add nothing
  double v[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) v[c] = 0.0;
  if (t < npair) {
#pragma unroll 4
    for (int s = lane; s < splits; s += qtf::kLanes) {
      const double* p = part + ((size_t)s * npair + t) * 12;
#pragma unroll
      for (int c = 0; c < 12; ++c) v[c] += p[c];
    }
  }
  lanes_sum(v);
  if (lane == 0 && t < npair)
    qtf::finish_write(terms + (size_t)t * 12, v, Q + (size_t)t * 6);
}

}  // namespace

// complex values (16 bytes each) of scratch a call needs
extern "C" long long raft_qtf_k5_scratch(int nw2, int nsub, int per) {
  const int splits = nsub > 0 ? (nsub + per - 1) / per : 0;
  return static_cast<long long>(qtf::scratch_len(nw2, nsub, splits));
}

// The raw pair grid Q (nw2, nw2, 6) complex: the three kernels on
// `stream`.  `sub` holds the nsub submerged nodes' indices; `per` is how
// many of them one pair-pass block takes (the wrapper's node split);
// `scratch` holds raft_qtf_k5_scratch(nw2, nsub, per) complex values.
// Returns the first non-zero cudaError_t of the launches, else 0.
extern "C" int raft_qtf_k5_f64(
    const double* w, const double* k, const double* Xi, const double* F1st,
    const double* u, const double* dr, const double* nv, const double* nax,
    const double* gu, const double* gp, const double* q, const double* off,
    const double* pos, const double* Minert, const double* CaMat,
    const double* ptMat, const double* qMat, const double* nsc,
    const double* wlc, const double* wleta, const double* wlmats,
    const double* wlgeo, const int* sub, double* scratch,
    long long scratch_len, double* Q, int nw2, int N, int nm, int nsub,
    int per, double beta, double h, double rho, double g, void* stream) {
  if (nw2 <= 0 || nw2 > 32768 || N < 0 || nm < 0 || nsub < 0 || nsub > N ||
      per <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = nsub > 0 ? (nsub + per - 1) / per : 0;
  if (splits > 65535 ||
      scratch_len < static_cast<long long>(qtf::scratch_len(nw2, nsub,
                                                            splits)))
    return static_cast<int>(cudaErrorInvalidValue);
  qtf::Fields a;
  a.nw2 = nw2;
  a.N = N;
  a.nm = nm;
  a.nsub = nsub;
  a.cosb = cos(beta);
  a.sinb = sin(beta);
  a.h = h;
  a.rho = rho;
  a.g = g;
  a.w = w;
  a.k = k;
  a.Xi = reinterpret_cast<const cd*>(Xi);
  a.F1st = reinterpret_cast<const cd*>(F1st);
  a.u = reinterpret_cast<const cd*>(u);
  a.dr = reinterpret_cast<const cd*>(dr);
  a.nv = reinterpret_cast<const cd*>(nv);
  a.nax = reinterpret_cast<const cd*>(nax);
  a.gu = reinterpret_cast<const cd*>(gu);
  a.gp = reinterpret_cast<const cd*>(gp);
  a.q = q;
  a.off = off;
  a.pos = pos;
  a.Minert = Minert;
  a.CaMat = CaMat;
  a.ptMat = ptMat;
  a.qMat = qMat;
  a.nsc = nsc;
  a.wlc = reinterpret_cast<const cd*>(wlc);
  a.wleta = reinterpret_cast<const cd*>(wleta);
  a.wlmats = wlmats;
  a.wlgeo = wlgeo;
  a.sub = sub;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cd* scr = reinterpret_cast<cd*>(scratch);
  double* part = reinterpret_cast<double*>(scr + qtf::part_offset(nw2, nsub));
  const int npair = nw2 * nw2;
  const int nrb = (nsub * nw2 + kRecordThreads - 1) / kRecordThreads;
  const int ncb = (npair + kRecordThreads - 1) / kRecordThreads;
  const int lanes_per_block = kRecordThreads / qtf::kLanes;
  const int ntb = (npair + lanes_per_block - 1) / lanes_per_block;
  cudaError_t err;
  qtf_k5_records<<<nrb + ncb + ntb, kRecordThreads, 0, s>>>(a, scr, nrb,
                                                            ncb);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  if (nsub > 0) {
    static bool smem_set = false;
    if (!smem_set) {
      err = cudaFuncSetAttribute(qtf_k5_pairs,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kPairSmem));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = true;
    }
    const int ntc = (nw2 + qtf::kT - 1) / qtf::kT;
    qtf_k5_pairs<<<dim3(ntc * ntc, splits), kPairBlock, kPairSmem, s>>>(
        a, scr, part, per);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  double* terms =
      reinterpret_cast<double*>(scr + qtf::terms_offset(nw2, nsub));
  qtf_k5_finish<<<(npair + kFinishPairs - 1) / kFinishPairs, kFinishThreads,
                  0, s>>>(nw2, terms, part, splits, reinterpret_cast<cd*>(Q));
  return static_cast<int>(cudaGetLastError());
}
