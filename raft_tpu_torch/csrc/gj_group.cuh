// Per-row arithmetic of the Gauss-Jordan solve kernels, one row of a
// system per thread and one lane per group of 16 threads: the fused
// impedance solve (K1, and K3 under the mixed ladder), whose lane is a
// (case, frequency) pair and whose rows are assembled from M, B, C and w,
// and the batched solve A x = b (K2, and K4 under the ladder), whose lane
// is one system with k right-hand sides and whose rows are loaded from A
// and b.  One body serves both: the row types (ImpRow, GjRow) say where a
// row comes from, and everything after that is generic in the system size
// S and the right-hand-side count K (K1/K3: K = 1).
//
// Everything here is __host__ __device__ and plain C++, so nvcc compiles
// it into the kernels of gj_kernels.cuh and a host compiler (with
// __host__/__device__ defined empty) into the library that
// tests/test_torch_kernel_body.py holds against the plain versions of
// raft_tpu_torch/ops/kernels/gj_solve.py.  What differs between the two
// is the division (quot: IEEE a / b on the host, its call-free fast path
// on the card) and the exchange between the rows of a lane, which sits
// behind a group policy P:
//   P::kLanes   rows this copy of the code holds: 1 on the card (a thread
//               holds its own row), 16 on the host (one loop steps the 16
//               "threads" of a group in lockstep);
//   rank(t)     the row index of held row t;
//   argmax(f)   the best pivot key over the group (f(t): key of row t);
//   max(f)      the NaN-propagating max over the group;
//   pivot_row<KK>(wk)  the pivot row's columns KK+1 .. S+K-1, normalised
//               (pivot_entry), from the row at position KK;
//   pivot_rhs<KK>(wk)  the same for the K right-hand-side columns alone
//               (refinements);
//   any(p)      whether p holds anywhere the exchanges reach (the warp);
//   publish_x(wk, rw, first, keep)  x_i += (or =) the solution row of the
//               row at position i, into the group's solution (nothing when
//               !keep);
//   x<T>()      that solution, S x K row-major, read by every row;
//   row_store<T>(t)  where held row t of an impedance lane keeps its
//               equilibrated row of As (a K2 row keeps it in the staged A).
// The card's policy (gjk::DevGroup in gj_kernels.cuh) does these with
// shuffles and a shared-memory slot per group; HostGroup below with loops.
//
// Algorithm (raft_tpu/ops/pallas/gj_solve.py:_gj_batchlast): each row of
// the lane's system is equilibrated by 1/max|row| of the matrix, floored
// at eq_eps, and eliminated with partial pivoting, first maximal row
// winning (a NaN magnitude counts as the largest, first NaN winning).
// Rows never move: each keeps its logical position, and a pivot exchange
// swaps two positions, which gives the row order of a physical swap.
// `refine` residual re-solves run at the input width T; under the ladder
// (E narrower than T) the lane's relative residual rn = max|rhs - As x| /
// (max|rhs| + eps), over every row and every right-hand side, is a group
// max, and a lane with !(rn <= tol) is re-solved at T by its own group, in
// the same launch.  A refinement eliminates the same matrix, so after the
// first elimination only the right-hand-side columns are replayed, with
// the pivots, positions and multipliers that elimination recorded.
// Every array is indexed by compile-time constants only (the elimination
// step is a template parameter), the solution and the As rows live in
// shared memory, and no division calls a subroutine, so the kernels hold
// their working rows in registers and have no local memory.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "gj_lane.cuh"

// every function of the body is inlined into the kernel: a row passed by
// pointer to a call that stays would live in local memory
#ifdef __CUDACC__
#define GJG_FN __host__ __device__ __forceinline__
#else
#define GJG_FN inline
#endif

namespace gjg {

using gjl::bf16r;
using gjl::nan_max;
using gjl::quot;
using gjl::row_scale;
using gjl::to;
using gjl::value;

// threads (rows) per lane; frequencies per impedance tile and systems per
// K2 tile (one tile a block)
constexpr int kGroup = 16;
constexpr int kTileF = 8;
constexpr int kTileL = 8;
// padded stride of one M / B element's tile row in shared memory
constexpr int kStrideF = kTileF + 1;

// v rounded up to an odd count: a row stride at which the 16 rows of a
// group start in 16 different banks
constexpr int odd(int v) { return v | 1; }

// ---------------------------------------------------------------------------
// the impedance tile: one case's operands for kTileF consecutive frequencies
// ---------------------------------------------------------------------------

// M, B: element e = ii * N + jj at [e * kStrideF + fl]; C: [e];
// F and X interleaved (re, im) as the arrays lie: [(ir * kTileF + fl) * 2
// + part]; w: [fl].  Frequencies past nw are staged as 0 and never read.
template <typename T, int N>
struct Tile {
  T M[N * N * kStrideF];
  T B[N * N * kStrideF];
  T C[N * N];
  T F[N * kTileF * 2];
  T X[N * kTileF * 2];
  T w[kTileF];
};

// Copy the tile of case b at frequencies f0.. from M, B (nb, N, N, nw),
// C (nb, N, N), F (nb, N, nw, 2) and w (nw) into s; thread tid of nthr,
// neighbouring threads on neighbouring addresses.
template <typename T, int N>
GJG_FN void stage(Tile<T, N>& s, const T* w, const T* M, const T* B,
                  const T* C, const T* F, int b, int f0, int nw, int tid,
                  int nthr) {
  const T* Mb = M + (size_t)b * N * N * nw;
  const T* Bb = B + (size_t)b * N * N * nw;
  const T* Cb = C + (size_t)b * N * N;
  const T* Fb = F + (size_t)b * N * nw * 2;
  for (int i = tid; i < N * N * kTileF; i += nthr) {
    const int e = i / kTileF;
    const int fl = i - e * kTileF;
    const bool in = f0 + fl < nw;
    s.M[e * kStrideF + fl] = in ? Mb[(size_t)e * nw + f0 + fl] : T(0);
    s.B[e * kStrideF + fl] = in ? Bb[(size_t)e * nw + f0 + fl] : T(0);
  }
  for (int i = tid; i < N * N; i += nthr) s.C[i] = Cb[i];
  for (int i = tid; i < N * kTileF * 2; i += nthr) {
    const int ir = i / (kTileF * 2);
    const int q = i - ir * kTileF * 2;
    s.F[i] = f0 + q / 2 < nw ? Fb[((size_t)ir * nw + f0) * 2 + q] : T(0);
  }
  for (int i = tid; i < kTileF; i += nthr)
    s.w[i] = f0 + i < nw ? w[f0 + i] : T(0);
}

// Write the tile's solutions into X (nb, N, nw, 2).
template <typename T, int N>
GJG_FN void writeback(const Tile<T, N>& s, T* X, int b, int f0, int nw,
                      int tid, int nthr) {
  T* Xb = X + (size_t)b * N * nw * 2;
  for (int i = tid; i < N * kTileF * 2; i += nthr) {
    const int ir = i / (kTileF * 2);
    const int q = i - ir * kTileF * 2;
    if (f0 + q / 2 < nw) Xb[((size_t)ir * nw + f0) * 2 + q] = s.X[i];
  }
}

// ---------------------------------------------------------------------------
// the K2 tile: kTileL consecutive systems' A (N x N) and b (N x K)
// ---------------------------------------------------------------------------

// Each row padded to an odd stride.  Slots past the last system hold a
// copy of it (its group re-solves it and writes nothing), so no two
// groups share a row: each row is equilibrated in place.
template <typename T, int N, int K>
struct GjTile {
  T A[kTileL][N][odd(N)];
  T b[kTileL][N][odd(K)];
};

// Copy systems lane0 .. lane0 + kTileL - 1 of A (lanes, N, N) and
// b (lanes, N, K) into s; thread tid of nthr, neighbouring threads on
// neighbouring addresses.
template <typename T, int N, int K>
GJG_FN void stage_gj(GjTile<T, N, K>& s, const T* A, const T* b, int lane0,
                     int lanes, int tid, int nthr) {
  for (int i = tid; i < kTileL * N * N; i += nthr) {
    const int l = i / (N * N);
    const int e = i - l * (N * N);
    const int gl = lane0 + l < lanes ? lane0 + l : lanes - 1;
    s.A[l][e / N][e % N] = A[(size_t)gl * N * N + e];
  }
  for (int i = tid; i < kTileL * N * K; i += nthr) {
    const int l = i / (N * K);
    const int e = i - l * (N * K);
    const int gl = lane0 + l < lanes ? lane0 + l : lanes - 1;
    s.b[l][e / K][e % K] = b[(size_t)gl * N * K + e];
  }
}

// Entries first, first + step, .. of a lane's solution (NK values, S x K
// row-major) into out.
template <int NK, typename T>
GJG_FN void store_x(const T* xs, T* out, int first, int step) {
  for (int e = first; e < NK; e += step) out[e] = xs[e];
}

// ---------------------------------------------------------------------------
// per-row state
// ---------------------------------------------------------------------------

// A row of an impedance lane at the input width T: its equilibrated row
// of the matrix (in the policy's row store: shared memory on the card,
// which keeps the registers for the working rows) and right-hand side.
template <typename T, int S>
struct ImpRow {
  using type = T;
  static constexpr int kS = S;
  static constexpr int kK = 1;
  T* as;
  T f;
  int r;
  bool active;  // r < S; rows S..15 of the group idle along
  GJG_FN T rhs(int) const { return f; }
};

// A row of a K2 system at the input width T: its row of A and of b in the
// staged tile, both equilibrated in place.
template <typename T, int S, int K>
struct GjRow {
  using type = T;
  static constexpr int kS = S;
  static constexpr int kK = K;
  T* as;
  T* b;
  int r;
  bool active;  // r < S; rows S..15 of the group idle along
  GJG_FN T rhs(int c) const { return b[c]; }
};

// A row's working copy for the eliminations at width W: [As | rhs], its
// logical position, and a[KK] as it stood at each step KK of the first
// elimination (the row's multiplier, or its pivot at the step it was the
// pivot row), which the refinement passes reuse.
template <typename W, int S, int K>
struct Work {
  W a[S + K];
  W c[S];
  int pos;
};

// pivot-row values travel at float for float and bf16 (exactly), at
// double for double
template <typename W>
struct slot_of {
  using type = double;
};
template <>
struct slot_of<float> {
  using type = float;
};
template <>
struct slot_of<bf16r> {
  using type = float;
};
template <typename W>
using slot_t = typename slot_of<W>::type;

template <typename W>
GJG_FN slot_t<W> to_slot(W v) {
  return value(v);
}
template <typename W>
GJG_FN W from_slot(slot_t<W> v) {
  if constexpr (std::is_same<W, bf16r>::value) {
    W e;
    e.v = v;  // already a bf16 value: no second rounding
    return e;
  } else {
    return v;
  }
}

// Assemble row r of the embedding for tile frequency fl and equilibrate
// it: as = row * scale, rhs = F * scale, scale = 1 / max(max|row|, eps).
template <typename T, int N>
GJG_FN void assemble_row(ImpRow<T, 2 * N>& me, const Tile<T, N>& s, int fl,
                         int r) {
  constexpr int S = 2 * N;
  me.r = r;
  me.active = r < S;
  const bool top = r < N;
  const int ii = !me.active ? 0 : (top ? r : r - N);
  const T w = s.w[fl];
  T raw[S];
#pragma unroll
  for (int jj = 0; jj < N; ++jj) {
    const int e = ii * N + jj;
    const T re = s.C[e] - (w * w) * s.M[e * kStrideF + fl];
    const T im = w * s.B[e * kStrideF + fl];
    raw[jj] = me.active ? (top ? re : im) : T(0);
    raw[N + jj] = me.active ? (top ? -im : re) : T(0);
  }
  T m = T(0);
#pragma unroll
  for (int j = 0; j < S; ++j)
    m = nan_max(m, static_cast<T>(fabs(raw[j])));
  const T scale = row_scale(m);
#pragma unroll
  for (int j = 0; j < S; ++j) me.as[j] = raw[j] * scale;
  me.f = me.active ? s.F[(ii * kTileF + fl) * 2 + (top ? 0 : 1)] * scale
                   : T(0);
}

// Point row r of tile system l at its staged rows and equilibrate them in
// place: as = A_r * scale, b = b_r * scale.  Idle rows read row 0 (as it
// stands: what they compute from it is never read) and write nothing.
template <typename T, int N, int K>
GJG_FN void load_row(GjRow<T, N, K>& me, GjTile<T, N, K>& s, int l, int r) {
  me.r = r;
  me.active = r < N;
  const int rr = me.active ? r : 0;
  me.as = s.A[l][rr];
  me.b = s.b[l][rr];
  T m = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j)
    m = nan_max(m, static_cast<T>(fabs(me.as[j])));
  const T scale = row_scale(m);
  if (me.active) {
#pragma unroll
    for (int j = 0; j < N; ++j) me.as[j] = me.as[j] * scale;
#pragma unroll
    for (int c = 0; c < K; ++c) me.b[c] = me.b[c] * scale;
  }
}

// this row of As times column c of the solution x (S x K), in
// eliminate's sum order
template <typename R>
GJG_FN typename R::type row_times_x(const R& me, const typename R::type* x,
                                    int c) {
  using T = typename R::type;
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < R::kS; ++j) acc = acc + me.as[j] * x[j * R::kK + c];
  return acc;
}

// Load the working row for the first elimination: [As | rhs] at width W.
template <typename W, int S, int K, typename R>
GJG_FN void load_work(Work<W, S, K>& wk, const R& me) {
#pragma unroll
  for (int j = 0; j < S; ++j) wk.a[j] = to<W>(me.as[j]);
#pragma unroll
  for (int c = 0; c < K; ++c) wk.a[S + c] = to<W>(me.rhs(c));
  wk.pos = me.r;
}

// Load a refinement's right-hand sides, the residual rhs - As x at T.
template <typename W, int S, int K, typename R>
GJG_FN void load_residual(Work<W, S, K>& wk, const R& me,
                          const typename R::type* x) {
#pragma unroll
  for (int c = 0; c < K; ++c)
    wk.a[S + c] = to<W>(me.rhs(c) - row_times_x(me, x, c));
}

// The pivot key of a row at step KK: (|a[KK]| as ordered bits + 1, with
// NaN one canonical value above every magnitude, position); 0 for rows
// that are no candidates (position < KK, or idle).
struct Key {
  unsigned long long key;
  int pos;
};

GJG_FN bool better(Key a, Key b) {
  return a.key > b.key || (a.key == b.key && a.pos < b.pos);
}

template <int KK, typename W, int S, int K>
GJG_FN Key pivot_key(const Work<W, S, K>& wk, bool active) {
  if (!active || wk.pos < KK) return Key{0ull, wk.pos};
  const double m = fabs(static_cast<double>(value(wk.a[KK])));
  unsigned long long u = 0x7ff8000000000000ull;
  if (m == m) memcpy(&u, &m, sizeof u);
  return Key{u + 1ull, wk.pos};
}

// one entry of the normalised pivot row, a_p[j] / piv (eliminate's
// operation, at width W); on the card the group's threads take one
// column each
template <typename W>
GJG_FN slot_t<W> pivot_entry(slot_t<W> aj, slot_t<W> piv) {
  if constexpr (std::is_same<W, bf16r>::value)
    return gjl::round_bf16(quot(aj, piv));
  else
    return quot(aj, piv);
}

// One row's share of step KK against the normalised pivot row p: the
// pivot row takes p (1 at KK), every other row a[j] - a[KK] p[j] (0 at
// KK), eliminate's operations.  Both are computed and one is selected, so
// the group runs one instruction stream; idle rows (all zero or a copy of
// row 0) go along and are never read.
template <int KK, typename W, int S, int K>
GJG_FN void eliminate_row(Work<W, S, K>& wk, const slot_t<W>* prow) {
  const bool pivot = wk.pos == KK;
  const W c = wk.a[KK];
  wk.c[KK] = c;
#pragma unroll
  for (int j = KK + 1; j < S + K; ++j) {
    const W p = from_slot<W>(prow[j]);
    const W u = wk.a[j] - c * p;
    wk.a[j] = pivot ? p : u;
  }
  wk.a[KK] = to<W>(pivot ? 1.0 : 0.0);
}

// One row's share of step KK of a refinement: the same eliminate on the
// right-hand-side columns alone.  A refinement eliminates the same matrix
// as the first pass (the same As at width W), so its pivots, positions
// and multipliers repeat the first pass's bit for bit; only the
// right-hand sides are new: the pivot row takes d = rhs / piv (from
// pivot_rhs), every other row rhs - c d.
template <int KK, typename W, int S, int K>
GJG_FN void substitute_row(Work<W, S, K>& wk, const slot_t<W>* d) {
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const W dv = from_slot<W>(d[c]);
    const W u = wk.a[S + c] - wk.c[KK] * dv;
    wk.a[S + c] = wk.pos == KK ? dv : u;
  }
}

// ---------------------------------------------------------------------------
// the lane's solve, over a group policy P
// ---------------------------------------------------------------------------

// Gauss-Jordan step KK.. S-1 on the group's working rows.
template <int KK, int S>
struct Elim {
  template <typename P, typename W, int K, typename R>
  GJG_FN static void run(P& g, Work<W, S, K>* wk, const R* rw) {
    if constexpr (KK < S) {
      const Key best = g.argmax(
          [&](int t) { return pivot_key<KK>(wk[t], rw[t].active); });
      const int p = best.pos;
#pragma unroll
      for (int t = 0; t < P::kLanes; ++t) {
        if (wk[t].pos == p)
          wk[t].pos = KK;
        else if (wk[t].pos == KK)
          wk[t].pos = p;
      }
      const slot_t<W>* prow = g.template pivot_row<KK>(wk);
#pragma unroll
      for (int t = 0; t < P::kLanes; ++t) eliminate_row<KK>(wk[t], prow);
      Elim<KK + 1, S>::run(g, wk, rw);
    }
  }
};

// Step KK.. S-1 of a refinement's elimination (substitute_row).
template <int KK, int S>
struct Subst {
  template <typename P, typename W, int K>
  GJG_FN static void run(P& g, Work<W, S, K>* wk) {
    if constexpr (KK < S) {
      const slot_t<W>* d = g.template pivot_rhs<KK>(wk);
#pragma unroll
      for (int t = 0; t < P::kLanes; ++t) substitute_row<KK>(wk[t], d);
      Subst<KK + 1, S>::run(g, wk);
    }
  }
};

// Solve at width W with `refine` residual re-solves at T into the
// group's solution; with keep false the group runs the solve (its
// warp-mate needs it) and leaves its solution as it was.
template <typename W, typename P, typename R>
GJG_FN void solve_width(P& g, R* rw, int refine, bool keep) {
  using T = typename R::type;
  Work<W, R::kS, R::kK> wk[P::kLanes];
#pragma unroll
  for (int t = 0; t < P::kLanes; ++t) load_work(wk[t], rw[t]);
  Elim<0, R::kS>::run(g, wk, rw);
  g.publish_x(wk, rw, true, keep);
  for (int it = 0; it < refine; ++it) {
#pragma unroll
    for (int t = 0; t < P::kLanes; ++t)
      load_residual(wk[t], rw[t], g.template x<T>());
    Subst<0, R::kS>::run(g, wk);
    g.publish_x(wk, rw, false, keep);
  }
}

// the lane's relative residual max|rhs - As x| / (max|rhs| + eps), over
// every row and right-hand side
template <typename P, typename R>
GJG_FN typename R::type residual_norm(P& g, const R* rw) {
  using T = typename R::type;
  T rloc[P::kLanes];
  T bloc[P::kLanes];
#pragma unroll
  for (int t = 0; t < P::kLanes; ++t) {
    const T* x = g.template x<T>();
    T rm = static_cast<T>(fabs(rw[t].rhs(0) - row_times_x(rw[t], x, 0)));
    T bm = static_cast<T>(fabs(rw[t].rhs(0)));
#pragma unroll
    for (int c = 1; c < R::kK; ++c) {
      rm = nan_max(rm, static_cast<T>(
                           fabs(rw[t].rhs(c) - row_times_x(rw[t], x, c))));
      bm = nan_max(bm, static_cast<T>(fabs(rw[t].rhs(c))));
    }
    rloc[t] = rw[t].active ? rm : T(0);
    bloc[t] = rw[t].active ? bm : T(0);
  }
  const T rmax = g.max([&](int t) { return rloc[t]; });
  const T bmax = g.max([&](int t) { return bloc[t]; });
  return quot(rmax, bmax + gjl::eq_eps<T>());
}

// Solve the lane whose rows rw hold: a single-width solve when E is T;
// otherwise the ladder, with *rn its residual at E, and the promotion to
// a T-width solve.  Returns whether the lane was promoted (*rn = 0 at a
// single width).  The promoted solve runs wherever g.any finds a promoted
// lane (on the card: in either group of the warp), so every exchange
// stays warp-uniform.
template <typename E, typename P, typename R>
GJG_FN bool solve_rows(P& g, R* rw, int refine, double tol,
                       typename R::type* rn) {
  using T = typename R::type;
  bool promoted = false;
  *rn = T(0);
  solve_width<E>(g, rw, refine, true);
  if constexpr (!std::is_same<T, E>::value) {
    *rn = residual_norm(g, rw);
    promoted = !(static_cast<double>(*rn) <= tol);
    if (g.any(promoted)) solve_width<T>(g, rw, refine, promoted);
  }
  return promoted;
}

// Solve tile frequency fl of s (K1/K3): assemble, equilibrate, solve, and,
// when `live`, leave each row's x_r in s.X.
template <typename T, typename E, int N, typename P>
GJG_FN bool solve_lane(P& g, Tile<T, N>& s, int fl, bool live, int refine,
                       double tol, T* rn) {
  constexpr int S = 2 * N;
  ImpRow<T, S> rw[P::kLanes];
#pragma unroll
  for (int t = 0; t < P::kLanes; ++t)
  {
    rw[t].as = g.template row_store<T>(t);
    assemble_row<T, N>(rw[t], s, fl, g.rank(t));
  }
  const bool promoted = solve_rows<E>(g, rw, refine, tol, rn);
#pragma unroll
  for (int t = 0; t < P::kLanes; ++t) {
    const int r = rw[t].r;
    if (live && rw[t].active) {
      const int ir = r < N ? r : r - N;
      s.X[(ir * kTileF + fl) * 2 + (r < N ? 0 : 1)] = g.template x<T>()[r];
    }
  }
  return promoted;
}

// Solve tile system l of s (K2/K4): load and equilibrate its rows in
// place, solve; the solution stays in the group's x<T>().
template <typename T, typename E, int N, int K, typename P>
GJG_FN bool solve_system(P& g, GjTile<T, N, K>& s, int l, int refine,
                         double tol, T* rn) {
  GjRow<T, N, K> rw[P::kLanes];
#pragma unroll
  for (int t = 0; t < P::kLanes; ++t) load_row(rw[t], s, l, g.rank(t));
  return solve_rows<E>(g, rw, refine, tol, rn);
}

// ---------------------------------------------------------------------------
// the host's group policy: 16 rows stepped in lockstep
// ---------------------------------------------------------------------------

struct HostGroup {
  static constexpr int kLanes = kGroup;
  // the widest system: S = 16 rows with K = 8 right-hand sides
  static constexpr int kMaxK = kGroup / 2;
  double xsd[kGroup * kMaxK];
  float xsf[kGroup * kMaxK];
  double asd[kGroup][kGroup];
  float asf[kGroup][kGroup];
  double pivd[kGroup + kMaxK];
  float pivf[kGroup + kMaxK];

  int rank(int t) const { return t; }

  bool any(bool p) const { return p; }

  template <typename F>
  Key argmax(F key) const {
    Key best = key(0);
    for (int t = 1; t < kLanes; ++t) {
      const Key k = key(t);
      if (better(k, best)) best = k;
    }
    return best;
  }

  template <typename F>
  auto max(F v) const -> decltype(v(0)) {
    auto m = v(0);
    for (int t = 1; t < kLanes; ++t) m = nan_max(m, v(t));
    return m;
  }

  template <typename W>
  slot_t<W>* piv() {
    if constexpr (std::is_same<slot_t<W>, double>::value)
      return pivd;
    else
      return pivf;
  }

  template <int KK, typename W, int S, int K>
  const slot_t<W>* pivot_row(const Work<W, S, K>* wk) {
    slot_t<W>* out = piv<W>();
    for (int t = 0; t < kLanes; ++t)
      if (wk[t].pos == KK)
        for (int j = KK + 1; j < S + K; ++j)
          out[j] = pivot_entry<W>(to_slot(wk[t].a[j]), to_slot(wk[t].a[KK]));
    return out;
  }

  template <typename T>
  T* row_store(int t) {
    if constexpr (std::is_same<T, double>::value)
      return asd[t];
    else
      return asf[t];
  }

  template <int KK, typename W, int S, int K>
  const slot_t<W>* pivot_rhs(const Work<W, S, K>* wk) {
    slot_t<W>* d = piv<W>();
    for (int t = 0; t < kLanes; ++t)
      if (wk[t].pos == KK)
        for (int c = 0; c < K; ++c)
          d[c] = pivot_entry<W>(to_slot(wk[t].a[S + c]), to_slot(wk[t].c[KK]));
    return d;
  }

  template <typename T>
  T* x() {
    if constexpr (std::is_same<T, double>::value)
      return xsd;
    else
      return xsf;
  }

  template <typename W, int S, int K, typename R>
  void publish_x(const Work<W, S, K>* wk, const R* rw, bool first,
                 bool keep) {
    using T = typename R::type;
    T* xs = x<T>();
    for (int t = 0; t < kLanes; ++t) {
      if (!keep || !rw[t].active) continue;
      for (int c = 0; c < K; ++c) {
        const T d = to<T>(wk[t].a[S + c]);
        T& xe = xs[wk[t].pos * K + c];
        xe = first ? d : xe + d;
      }
    }
  }
};

}  // namespace gjg
