// K5: the slender-body QTF pair grid, float64 (see qtf_pair.cuh).
//
// One block per (i1, i2) pair (grid nw2 x nw2, blockIdx.y = i1); the
// threads stride over the strip nodes, each keeping its nodes' wrench in
// 12 registers; a warp-shuffle then shared-memory reduction in a fixed
// order gives the node sum, and thread 0 adds Pinkster IV and the
// waterline terms and writes Q[i1, i2, :].
#include <cuda_runtime.h>

#include "qtf_pair.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
qtf_pair_kernel(qtf::Args a) {
  const int i2 = blockIdx.x, i1 = blockIdx.y;
  const qtf::Pair P = qtf::pair_setup(a, i1, i2);
  double acc[12];
  for (int j = 0; j < 12; ++j) acc[j] = 0.0;
  for (int n = threadIdx.x; n < a.N; n += kThreads)
    qtf::node_wrench(a, P, i1, i2, n, acc);
  for (int j = 0; j < 12; ++j)
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  __shared__ double part[kThreads / 32][12];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int j = 0; j < 12; ++j) part[warp][j] = acc[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    double side[12];
    for (int j = 0; j < 12; ++j) {
      double s = 0.0;
      for (int wp = 0; wp < kThreads / 32; ++wp) s += part[wp][j];
      side[j] = s;
    }
    qtf::pair_finish(a, P, i1, i2, side);
  }
}

}  // namespace

extern "C" int raft_qtf_pair_f64(
    const double* w, const double* k, const double* Xi, const double* F1st,
    const double* u, const double* dr, const double* nv, const double* nax,
    const double* gu, const double* gp, const double* q, const double* off,
    const double* pos, const double* Minert, const double* CaMat,
    const double* ptMat, const double* qMat, const double* nsc,
    const double* wlc, const double* wleta, const double* wlmats,
    const double* wlgeo, double* Q, int nw2, int N, int nm, double beta,
    double h, double rho, double g, void* stream) {
  if (nw2 <= 0 || nw2 > 65535 || N < 0 || nm < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using qtf::cd;
  qtf::Args a;
  a.nw2 = nw2;
  a.N = N;
  a.nm = nm;
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
  a.Q = reinterpret_cast<cd*>(Q);
  dim3 grid(nw2, nw2);
  qtf_pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
