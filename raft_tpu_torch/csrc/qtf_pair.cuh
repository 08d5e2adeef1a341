// K5: the slender-body QTF pair grid for Hopper (sm_90a), float64.
//
// Replaces raft_tpu/ops/pallas/qtf_pair.py:qtf_pair_grid (pallas_call at
// :381, body _qtf_pair_kernel :97-295).  For every difference-frequency
// pair (i1, i2) of the second-order grid it sums, over the submerged strip
// nodes, the raw slender-body wrench of Rainey's equation plus Pinkster's
// terms: the second-order potential, convective acceleration, axial
// divergence, body motion in the first-order field, the Rainey
// body-rotation terms and the axial/end pressure terms (with the moment
// about the PRP), then adds Pinkster IV and the relative wave-elevation
// term of each waterline-crossing member.  No Hermitian completion and no
// Kim & Yue correction: the caller applies them.
//
// Everything computed per (frequency, node), per node, per pair and per
// (pair, node) lives here as __host__ __device__ functions on a
// two-double complex struct, so g++ builds the same arithmetic for the CPU
// tests (tests/test_torch_kernel_body.py); qtf_k5_f64.cu adds the three
// kernels that run them, the staging into shared memory and the launch.
//
// Inputs, lane-last as models/qtf.py:qtf_fields builds them (frequency
// fastest, contiguous): w, k (nw2); Xi, F1st (6, nw2); u, dr, nv (N, 3,
// nw2); nax (N, nw2); gu (N, 3, 3, nw2); gp (N, 3, nw2) complex; q, off,
// pos (N, 3); Minert, CaMat, ptMat, qMat (N, 3, 3); nsc (N, 4) = [v_side
// (submergence-scaled), v_end * Ca_End, a_i, submerged] real; waterline
// members: wlc (nm, 3, 3, nw2) complex = [udw, aw, g_e1][xyz], wleta (nm,
// nw2) complex, wlmats (nm, 2, 3, 3) = [Minert, CaMat] of the member's
// last submerged node, wlgeo (nm, 4) = [area, r_int - r_PRP]; sub (nsub)
// the submerged nodes' indices, in order.  Output Q (nw2, nw2, 6) complex.
//
// What bounds it on this card: FP64 arithmetic.  Every term of the wrench
// is a product of one field of the w1 side and the conjugate of one of the
// w2 side, so the work that depends on one frequency and one node (u - nv,
// CaMat and ptMat on it, its part off the axis q, dw/dz, o x q, V = grad u
// + skew(o), the potential's phase) is done once per (frequency, submerged
// node) by the record pass, the per-node matrices are folded once per
// node (rho v_i Minert + rho v_end Ca_End qMat, rho v_i CaMat, rho v_i
// (I - qMat), with the reference's 0.25 of every product), and each
// pair's own work (the potential's constants, Pinkster IV, the waterline
// members) once per pair, also in the record pass.  What remains per
// (pair, node) is the two-sided products, ~800 FP64 operations
// (chip_smoke.py:QTF_PAIR_NODE_OPS), plus the potential's cosh/sinh of
// |k1 - k2| (z + h), which do not factor without cancellation.
//
// The pair pass gives a block a tile of kT x kT pairs and a share of the
// submerged nodes, and walks the nodes one at a time: each node's kT row
// records, kT column records and node record are copied into shared
// memory asynchronously, double-buffered, so one record read from L2
// serves kT pairs; a warp holds two rows of the tile, so its row-side
// reads are broadcasts and its column-side reads are 16 consecutive
// records.  The body needs more than the 128 registers that let an SM
// hold 16 warps, so two threads share a pair: warps 0-7 run part A
// (node_pair_a), warps 8-15 part B (node_pair_b), each adding into its
// own running sums, which live in shared memory with the pair constants,
// so that nothing but the body's values holds a register across the node
// loop.  The node split gives small grids enough blocks; the finishing
// pass adds each pair's shares and own terms in a fixed order: no
// atomics, so two calls give bitwise equal Q.  What keeps it above the
// bound is the issue rate of one thread's dependent FP64 chain at 16
// warps an SM (the pair pass runs at about 45 % of the scalar FP64 peak
// at nw2 = 80) and, at small grids, the three launches and each block's
// staging latency (PERF.md has the card's numbers).
//
// Why scalar FP64 and not the FP64 tensor cores (mma.sync f64): every
// non-potential term is a bilinear form in (w1-side field, conj of a w2-
// side field), so the grid is a complex product over the (node, field)
// axis; but written as one it needs ~34 w2-side basis fields per node,
// ~1,600 FP64 operations per (pair, node) against the ~800 of the hoisted
// scalar form, at twice the rate (67 against 34 TFLOP/s on the H100 SXM):
// no gain, and another summation order.
#pragma once

#include <math.h>
#include <stddef.h>

#include "gj_lane.cuh"

// every function of the body is inlined into its kernel, so nothing is
// passed through a call frame, and every loop over a small array is
// unrolled, so the array stays in registers
#ifdef __CUDACC__
#define QTF_FN __host__ __device__ __forceinline__
#define QTF_UNROLL _Pragma("unroll")
#else
#define QTF_FN inline
#define QTF_UNROLL
#endif

namespace qtf {

constexpr double kKhDeep = 89.4;   // raft_tpu/ops/waves.py _KH_DEEP
constexpr double kPi = 3.14159265358979323846;
constexpr double kInvPi = 0.318309886183790671538;

// the pair pass's tile: kT x kT pairs, one a thread; 2 kT records staged
// per node (the tile's kT rows, then its kT columns)
constexpr int kT = 16;
constexpr int kPairThreads = kT * kT;
constexpr int kSlots = 2 * kT;

// one (frequency, submerged node) record: complex values, by field
enum : int {
  R_U = 0,      // u
  R_DR = 3,     // dr
  R_GU = 6,     // grad u, row-major
  R_V = 15,     // V = grad u + skew(o), o = i w Xi[3:], so V x = gu x + o x x
  R_GP = 24,    // grad p
  R_PT = 27,    // ptMat ua, ua = u - nv
  R_CU = 30,    // CaMat ua
  R_UAT = 33,   // (I - qMat) ua
  R_T = 36,     // t = (u - (u.q) q) - (nv - (nv.q) q)
  R_OQ = 39,    // o x q
  R_DWDZ = 42,  // q . (grad u q)
  R_NAX = 43,   // the axial relative velocity
  R_PH = 44,    // exp(-i k (cos(beta) x + sin(beta) y)), the potential's phase
  kRec = 45
};
// one submerged node's record: doubles.  The reference scales every
// two-sided product by 0.25; that factor is folded into the matrices and
// a_i here (and 4 into the pair's potential constants), so the pair pass
// sums the products unscaled.
enum : int {
  N_MQ = 0,     // sub (rho v_i Minert + rho v_end Ca_End qMat) / 4
  N_CAR = 9,    // sub rho v_i CaMat / 4
  N_IQ = 18,    // sub rho v_i (I - qMat) / 4
  N_Q = 27,     // q
  N_OFF = 30,   // r - r_PRP
  N_AI = 33,    // sub a_i / 4
  N_ZH = 34,    // z + h
  N_PM = 35,    // 1 where z <= 0 (the potential acts), else 0
  kNodeRec = 36
};

struct alignas(16) cd {
  double re, im;
};

QTF_FN cd operator+(cd a, cd b) { return cd{a.re + b.re, a.im + b.im}; }
QTF_FN cd operator-(cd a, cd b) { return cd{a.re - b.re, a.im - b.im}; }
QTF_FN cd operator*(cd a, cd b) {
  return cd{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
QTF_FN cd operator*(double s, cd a) { return cd{s * a.re, s * a.im}; }
QTF_FN cd operator*(cd a, double s) { return cd{s * a.re, s * a.im}; }
QTF_FN cd conj(cd a) { return cd{a.re, -a.im}; }
// i * a
QTF_FN cd mul_i(cd a) { return cd{-a.im, a.re}; }

// exp(-i pi t): sincospi reduces its argument exactly, so the card needs no
// Payne-Hanek reduction (and no local memory) for a large phase
QTF_FN cd expmipi(double t) {
  double s, c;
#ifdef __CUDA_ARCH__
  sincospi(t, &s, &c);
#else
  s = sin(kPi * t);
  c = cos(kPi * t);
#endif
  return cd{c, -s};
}

struct cv3 {
  cd x[3];
};

QTF_FN cv3 add(cv3 a, cv3 b) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) r.x[i] = a.x[i] + b.x[i];
  return r;
}
QTF_FN cv3 sub(cv3 a, cv3 b) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) r.x[i] = a.x[i] - b.x[i];
  return r;
}
QTF_FN cv3 scale(double s, cv3 a) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) r.x[i] = s * a.x[i];
  return r;
}
QTF_FN cv3 scale(cd s, cv3 a) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) r.x[i] = s * a.x[i];
  return r;
}
// a complex scalar times a real vector
QTF_FN cv3 cr3(cd s, const double* q) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) r.x[i] = s * q[i];
  return r;
}
// real 3x3 (row-major) times complex vector
QTF_FN cv3 rmv(const double* M, cv3 v) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i)
    r.x[i] = M[3 * i] * v.x[0] + M[3 * i + 1] * v.x[1] + M[3 * i + 2] * v.x[2];
  return r;
}
// a x b, complex
QTF_FN cv3 cross(cv3 a, cv3 b) {
  cv3 r;
  r.x[0] = a.x[1] * b.x[2] - a.x[2] * b.x[1];
  r.x[1] = a.x[2] * b.x[0] - a.x[0] * b.x[2];
  r.x[2] = a.x[0] * b.x[1] - a.x[1] * b.x[0];
  return r;
}
// a x b with a real
QTF_FN cv3 rcross(const double* a, cv3 b) {
  cv3 r;
  r.x[0] = a[1] * b.x[2] - a[2] * b.x[1];
  r.x[1] = a[2] * b.x[0] - a[0] * b.x[2];
  r.x[2] = a[0] * b.x[1] - a[1] * b.x[0];
  return r;
}
// sum_i a_i q_i with q real (no conjugation)
QTF_FN cd dotr(cv3 a, const double* q) {
  return a.x[0] * q[0] + a.x[1] * q[1] + a.x[2] * q[2];
}
// sum_i a_i b_i (no conjugation)
QTF_FN cd dot(cv3 a, cv3 b) {
  return a.x[0] * b.x[0] + a.x[1] * b.x[1] + a.x[2] * b.x[2];
}
// v - (v . q) q: the part of v transverse to the member axis q
QTF_FN cv3 transverse(cv3 v, const double* q) {
  return sub(v, cr3(dotr(v, q), q));
}

// the inputs (lane-last, see the head of this file)
struct Fields {
  int nw2, N, nm, nsub;
  double cosb, sinb, h, rho, g;
  const double* w;
  const double* k;
  const cd* Xi;
  const cd* F1st;
  const cd* u;
  const cd* dr;
  const cd* nv;
  const cd* nax;
  const cd* gu;
  const cd* gp;
  const double* q;
  const double* off;
  const double* pos;
  const double* Minert;
  const double* CaMat;
  const double* ptMat;
  const double* qMat;
  const double* nsc;
  const cd* wlc;
  const cd* wleta;
  const double* wlmats;
  const double* wlgeo;
  const int* sub;
};

// component c of node n's lane-last (N, 3, nw2) field at frequency f
QTF_FN cd at3(const Fields& a, const cd* x, int n, int c, int f) {
  return x[((size_t)n * 3 + c) * a.nw2 + f];
}

// ---------------------------------------------------------------------------
// the record pass: once per (frequency, submerged node) and per node
// ---------------------------------------------------------------------------

// The record of frequency f at submerged node j: element e written to
// out[e * stride].
QTF_FN void record_fill(const Fields& a, int f, int j, cd* out,
                        size_t stride) {
  // three rounds, each loading all it needs before it stores anything:
  // out may alias the inputs as far as the compiler knows, so a load
  // after a store waits for it, and a round costs one load latency
  const int n = a.sub[j];
  const double* q = a.q + 3 * n;
  const double q0 = q[0], q1 = q[1], q2 = q[2];
  const double qv[3] = {q0, q1, q2};
  // ---- round 1: the velocities, grad p, the axial terms, the phase ----
  const double w = a.w[f];
  const double kx = a.k[f] * (a.cosb * a.pos[3 * n] +
                              a.sinb * a.pos[3 * n + 1]);
  const cd nax = a.nax[(size_t)n * a.nw2 + f];
  cv3 o, u, nv, dr, gp;
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    o.x[c] = mul_i(w * a.Xi[(size_t)(3 + c) * a.nw2 + f]);
    u.x[c] = at3(a, a.u, n, c, f);
    nv.x[c] = at3(a, a.nv, n, c, f);
    dr.x[c] = at3(a, a.dr, n, c, f);
    gp.x[c] = at3(a, a.gp, n, c, f);
  }
  const cv3 oq = cross(o, cr3(cd{1.0, 0.0}, qv));
  const cv3 t = sub(transverse(u, qv), transverse(nv, qv));
  const cv3 ua = sub(u, nv);
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    out[(R_U + c) * stride] = u.x[c];
    out[(R_DR + c) * stride] = dr.x[c];
    out[(R_GP + c) * stride] = gp.x[c];
    out[(R_OQ + c) * stride] = oq.x[c];
    out[(R_T + c) * stride] = t.x[c];
  }
  out[R_NAX * stride] = nax;
  out[R_PH * stride] = expmipi(kx * kInvPi);
  // ---- round 2: grad u, V = grad u + skew(o) (o x v = skew(o) v) and
  //      dw/dz = q . (grad u q) ----
  cd gu[9];
  QTF_UNROLL
  for (int i = 0; i < 9; ++i) gu[i] = a.gu[((size_t)n * 9 + i) * a.nw2 + f];
  const cd z{0.0, 0.0};
  const cd skew[9] = {z, -1.0 * o.x[2], o.x[1], o.x[2], z, -1.0 * o.x[0],
                      -1.0 * o.x[1], o.x[0], z};
  cd dwdz{0.0, 0.0};
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) {
    const cd gq = gu[3 * i] * q0 + gu[3 * i + 1] * q1 + gu[3 * i + 2] * q2;
    dwdz = i == 0 ? gq * q0 : dwdz + gq * qv[i];
  }
  QTF_UNROLL
  for (int i = 0; i < 9; ++i) {
    out[(R_GU + i) * stride] = gu[i];
    out[(R_V + i) * stride] = gu[i] + skew[i];
  }
  out[R_DWDZ * stride] = dwdz;
  // ---- round 3: ptMat, CaMat and (I - qMat) on ua = u - nv ----
  double Pt[9], Ca[9], Qm[9];
  QTF_UNROLL
  for (int i = 0; i < 9; ++i) {
    Pt[i] = a.ptMat[9 * n + i];
    Ca[i] = a.CaMat[9 * n + i];
    Qm[i] = a.qMat[9 * n + i];
  }
  const cv3 pt = rmv(Pt, ua), cu = rmv(Ca, ua);
  const cv3 uat = sub(ua, rmv(Qm, ua));
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    out[(R_PT + c) * stride] = pt.x[c];
    out[(R_CU + c) * stride] = cu.x[c];
    out[(R_UAT + c) * stride] = uat.x[c];
  }
}

// The record of submerged node j.  `sub` (1 for a submerged node) scales
// the node's force, so it is folded into the matrices and a_i.
QTF_FN void node_fill(const Fields& a, int j, double* out) {
  const int n = a.sub[j];
  const double* ns = a.nsc + 4 * n;
  const double rv = a.rho * ns[0], re = a.rho * ns[1], sb = ns[3];
  const double* Mi = a.Minert + 9 * n;
  const double* Ca = a.CaMat + 9 * n;
  const double* Qm = a.qMat + 9 * n;
  const double sq = 0.25 * sb;
  QTF_UNROLL
  for (int i = 0; i < 9; ++i) {
    out[N_MQ + i] = sq * (rv * Mi[i] + re * Qm[i]);
    out[N_CAR + i] = sq * (rv * Ca[i]);
    out[N_IQ + i] = sq * (rv * ((i % 4 == 0 ? 1.0 : 0.0) - Qm[i]));
  }
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    out[N_Q + c] = a.q[3 * n + c];
    out[N_OFF + c] = a.off[3 * n + c];
  }
  out[N_AI] = sq * ns[2];
  out[N_ZH] = a.pos[3 * n + 2] + a.h;
  out[N_PM] = a.pos[3 * n + 2] <= 0.0 ? 1.0 : 0.0;
}

// ---------------------------------------------------------------------------
// the pair pass
// ---------------------------------------------------------------------------

// what every node of one pair shares: raft_tpu/ops/waves.py:
// wave_pot_2nd_order's pair-only part (both headings beta).  The pair's
// potential factor 0.5 (gamma21 + conj(gamma12)) is purely imaginary, i a;
// with ic = 1 / cosh(min(|dk| h, kKhDeep)) the potential's acceleration
// and pressure at a node are i a ic (dw dkx, dw dky, i dw |dk| sh/ch) ch
// ph and a ic rho dw ch ph, ch and sh the node's cosh and sinh.  The
// constants below carry a factor 4 (see the node record).
struct Pair {
  double w1, w2;
  bool pot;            // the 2nd-order potential is active for this pair
  double nk;           // |dk|
  double cx, cy, cz;   // 4 a ic dw dkx, 4 a ic dw dky, 4 a ic dw |dk|
  double cp;           // 4 a ic rho dw
};

QTF_FN Pair pair_setup(const Fields& a, int i1, int i2) {
  Pair P;
  const double w1 = a.w[i1], w2 = a.w[i2], k1 = a.k[i1], k2 = a.k[i2];
  P.w1 = w1;
  P.w2 = w2;
  const double dkx = k1 * a.cosb - k2 * a.cosb;
  const double dky = k1 * a.sinb - k2 * a.sinb;
  const double nk = sqrt(dkx * dkx + dky * dky);
  const double dw = w1 - w2;
  P.pot = (k1 > 0.0) && (k2 > 0.0) && (w1 != w2);
  P.nk = nk;
  double aic = 0.0;
  if (P.pot) {
    const double h = a.h, g = a.g;
    const double th1 = tanh(k1 * h), th2 = tanh(k2 * h), thn = tanh(nk * h);
    // quot: the division without a call to its slow path on the card
    // (w1, w2 > 0 and the operands are normal here)
    using gjl::quot;
    double den12 = quot(dw * dw, g) - nk * thn;
    if (den12 == 0.0) den12 = 1.0;
    // (-i g / (2 w)) * real / den12: purely imaginary
    const double g12 = quot(-quot(g, 2.0 * w1) *
                                ((k1 * k1) * (1.0 - th1 * th1) -
                                 2.0 * k1 * k2 * (1.0 + th1 * th2)),
                            den12);
    const double g21 = quot(-quot(g, 2.0 * w2) *
                                ((k2 * k2) * (1.0 - th2 * th2) -
                                 2.0 * k2 * k1 * (1.0 + th2 * th1)),
                            den12);
    // 0.5 * (i g21 + conj(i g12)) = 0.5 i (g21 - g12), times 4
    aic = quot(2.0 * (g21 - g12), cosh(fmin(nk * h, kKhDeep)));
  }
  P.cx = aic * (dw * dkx);
  P.cy = aic * (dw * dky);
  P.cz = aic * (dw * nk);
  P.cp = aic * (a.rho * dw);
  return P;
}

// conj(M) v and M v for a complex 3x3 row-major M held as a record's
// field at stride S: the two sides of a two-sided product
template <int S>
QTF_FN cd row_dot(const cd* M, int i, cv3 v) {
  return M[(3 * i) * S] * v.x[0] + M[(3 * i + 1) * S] * v.x[1] +
         M[(3 * i + 2) * S] * v.x[2];
}
template <int S>
QTF_FN cd row_dot_conj(const cd* M, int i, cv3 v) {
  return conj(M[(3 * i) * S]) * v.x[0] + conj(M[(3 * i + 1) * S]) * v.x[1] +
         conj(M[(3 * i + 2) * S]) * v.x[2];
}
template <int S>
QTF_FN cv3 ld3(const cd* R, int e) {
  cv3 v;
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) v.x[c] = R[(e + c) * S];
  return v;
}
template <int S>
QTF_FN cv3 ld3c(const cd* R, int e) {
  cv3 v;
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) v.x[c] = conj(R[(e + c) * S]);
  return v;
}
// M1 v2c + conj(M2) v1: a two-sided product with the complex 3x3 field at
// e of both records, one multiply-add chain a component
template <int S>
QTF_FN cv3 two_sided(const cd* R1, const cd* R2, int e, cv3 v2c, cv3 v1) {
  cv3 r;
  QTF_UNROLL
  for (int i = 0; i < 3; ++i) {
    const cd* m1 = R1 + (e + 3 * i) * S;
    const cd* m2 = R2 + (e + 3 * i) * S;
    cd s = m1[0] * v2c.x[0];
    s = s + m1[S] * v2c.x[1];
    s = s + m1[2 * S] * v2c.x[2];
    s = s + conj(m2[0]) * v1.x[0];
    s = s + conj(m2[S]) * v1.x[1];
    s = s + conj(m2[2 * S]) * v1.x[2];
    r.x[i] = s;
  }
  return r;
}
// f + M v with M real 3x3 (row-major): M v formed, then added (an
// accumulating chain instead makes ptxas spill in the pair pass)
QTF_FN cv3 rmv_add(cv3 f, const double* M, cv3 v) { return add(f, rmv(M, v)); }

// The raw wrench of one submerged node for one pair, in two parts that
// two threads (two warps of a block) compute for the same pair, each
// added to its own 12 running sums [force (re, im) x 3, moment about the
// PRP (re, im) x 3] (sum c at acc[c * as]); the pair's wrench is their
// sum.  R1 is the w1 side's
// record and R2 the w2 side's (element e at [e * S]), NR the node's
// record; the w2 side enters conjugated throughout.  Reference:
// raft_tpu/models/qtf.py:456-577 (raft/raft_fowt.py:1541-1601).
// the node's force f and its moment added to the running sums (sum c at
// acc[c * as])
QTF_FN void add_wrench(const double* NR, cv3 f, double* acc, int as) {
  const cv3 m = rcross(NR + N_OFF, f);
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    acc[(2 * c) * as] += f.x[c].re;
    acc[(2 * c + 1) * as] += f.x[c].im;
    acc[(6 + 2 * c) * as] += m.x[c].re;
    acc[(6 + 2 * c + 1) * as] += m.x[c].im;
  }
}

// Part A: what rho v_i Minert + rho v_end Ca_End qMat takes (convective
// acceleration, body motion in the first-order field, the second-order
// potential), the potential's end pressure, and what rho v_i CaMat takes
// of the Rainey axial divergence and rotation terms.  Everything is 4x
// the reference's, the node record 1/4 of it.
template <int S>
QTF_FN void node_pair_a(const cd* R1, const cd* R2, const double* NR,
                        const Pair& P, double* acc, int as) {
  const double* q = NR + N_Q;
  // gu1 (conj u2 + i w1 conj dr2) + conj(gu2) (u1 - i w2 dr1)
  cv3 v1, v2c;
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    const cd u1 = R1[(R_U + c) * S], d1 = R1[(R_DR + c) * S];
    const cd u2 = R2[(R_U + c) * S], d2 = R2[(R_DR + c) * S];
    v1.x[c] = cd{u1.re + P.w2 * d1.im, u1.im - P.w2 * d1.re};
    v2c.x[c] = cd{u2.re + P.w1 * d2.im, P.w1 * d2.re - u2.im};
  }
  cv3 A = two_sided<S>(R1, R2, R_GU, v2c, v1);
  cd p{0.0, 0.0};
  if (P.pot && NR[N_PM] != 0.0) {
    // cosh and sinh of min(|dk| (z + h), kKhDeep), from one exp; the
    // phase exp(-i (dkx x + dky y)) = ph1 conj(ph2)
    const double e = exp(fmin(P.nk * NR[N_ZH], kKhDeep));
    const double ie = gjl::quot(1.0, e);
    const cd ph = R1[R_PH * S] * conj(R2[R_PH * S]);
    const cd tc = (0.5 * (e + ie)) * ph;
    const cd ts = (0.5 * (e - ie)) * ph;
    A.x[0] = A.x[0] + mul_i(tc) * P.cx;
    A.x[1] = A.x[1] + mul_i(tc) * P.cy;
    A.x[2] = A.x[2] - ts * P.cz;
    p = tc * P.cp;
  }
  cv3 f = rmv_add(cr3(NR[N_AI] * p, q), NR + N_MQ, A);
  // the axial divergence's part off the axis, less half the rotation term
  const cd dz1 = R1[R_DWDZ * S], dz2c = conj(R2[R_DWDZ * S]);
  const cv3 axdv = add(scale(dz1, ld3c<S>(R2, R_T)),
                       scale(dz2c, ld3<S>(R1, R_T)));
  const cd nax1 = R1[R_NAX * S], nax2c = conj(R2[R_NAX * S]);
  const cv3 rot = add(scale(nax2c, ld3<S>(R1, R_OQ)),
                      scale(nax1, ld3c<S>(R2, R_OQ)));
  f = rmv_add(f, NR + N_CAR, sub(transverse(axdv, q), scale(2.0, rot)));
  add_wrench(NR, f, acc, as);
}

// Part B: the first-order field's end pressures (ptMat ua1 . conj(CaMat
// ua2), grad p on dr) and the V products that rho v_i CaMat and rho v_i
// (I - qMat) take (4x, as part A).
template <int S>
QTF_FN void node_pair_b(const cd* R1, const cd* R2, const double* NR,
                        double mrho, double* acc, int as) {
  const double* q = NR + N_Q;
  // ptMat ua1 . conj(CaMat ua2), grad p1 . conj(dr2) + conj(grad p2) . dr1
  const cd p = mrho * dot(ld3<S>(R1, R_PT), ld3c<S>(R2, R_CU)) +
               (dot(ld3<S>(R1, R_GP), ld3c<S>(R2, R_DR)) +
                dot(ld3c<S>(R2, R_GP), ld3<S>(R1, R_DR)));
  cv3 f = cr3(NR[N_AI] * p, q);
  f = rmv_add(f, NR + N_CAR, scale(-1.0, two_sided<S>(R1, R2, R_V,
                                                      ld3c<S>(R2, R_UAT),
                                                      ld3<S>(R1, R_UAT))));
  f = rmv_add(f, NR + N_IQ, two_sided<S>(R1, R2, R_V, ld3c<S>(R2, R_CU),
                                         ld3<S>(R1, R_CU)));
  add_wrench(NR, f, acc, as);
}

// The staging of one node into a block's shared memory: granule idx (one
// 16-byte complex) of kGranules comes from scratch[*src] and goes to
// stage[*dst] (both counted in complex values).  The scratch holds the
// records field by field, frequency fastest (record element e of
// frequency f at submerged node j at (j kRec + e) nw2 + f), then the node
// records; a stage holds the 2 kT records element-major ([e][slot]) and
// then the node record.  Rows and columns past nw2 (a ragged tile) stage
// the last frequency's record, whose pairs are not stored.
constexpr int kGranules = kRec * kSlots + kNodeRec / 2;
constexpr int kStage = kGranules;   // complex values in one stage

QTF_FN size_t record_offset(int j, int e, int f, int nw2) {
  return ((size_t)j * kRec + e) * nw2 + f;
}
QTF_FN size_t node_offset(int j, int nw2, int nsub) {
  return (size_t)nsub * kRec * nw2 + (size_t)j * (kNodeRec / 2);
}
// granule idx of the node j's stage comes from scratch[src + j * step]:
// only the node moves the source, so a thread works out (src, step) of
// its granules once
QTF_FN void stage_granule(int idx, int r0, int c0, int nw2, int nsub,
                          int* src, int* step) {
  if (idx < kRec * kSlots) {
    const int e = idx / kSlots, slot = idx % kSlots;
    int f = slot < kT ? r0 + slot : c0 + slot - kT;
    f = f < nw2 ? f : nw2 - 1;
    *src = e * nw2 + f;
    *step = kRec * nw2;
  } else {
    *src = nsub * kRec * nw2 + (idx - kRec * kSlots);
    *step = kNodeRec / 2;
  }
}

// The pair constants of the pair pass, 6 doubles a pair (the record pass
// computes them): [pot (1 or 0), |dk|, cx, cy, cz, cp] of pair_setup
constexpr int kPairConsts = 6;

QTF_FN void pair_consts(const Fields& a, int i1, int i2, double* out) {
  const Pair P = pair_setup(a, i1, i2);
  out[0] = P.pot ? 1.0 : 0.0;
  out[1] = P.nk;
  out[2] = P.cx;
  out[3] = P.cy;
  out[4] = P.cz;
  out[5] = P.cp;
}
// pair_setup's values from pair_consts' c (element i at c[i * stride])
QTF_FN Pair pair_from(const double* c, int stride, double w1, double w2) {
  Pair P;
  P.w1 = w1;
  P.w2 = w2;
  P.pot = c[0] != 0.0;
  P.nk = c[stride];
  P.cx = c[2 * stride];
  P.cy = c[3 * stride];
  P.cz = c[4 * stride];
  P.cp = c[5 * stride];
  return P;
}

// The scratch, in complex values: the records, the node records, the
// pair constants (kPairConsts doubles a pair), each pair's own terms
// (Pinkster IV and the waterline members: 12 doubles = 6 complex a pair)
// and the node-split partial sums of every pair (6 complex a pair and
// share).
QTF_FN size_t consts_offset(int nw2, int nsub) {
  return node_offset(nsub, nw2, nsub);
}
QTF_FN size_t terms_offset(int nw2, int nsub) {
  return consts_offset(nw2, nsub) + (size_t)nw2 * nw2 * (kPairConsts / 2);
}
QTF_FN size_t part_offset(int nw2, int nsub) {
  return terms_offset(nw2, nsub) + (size_t)nw2 * nw2 * 6;
}
QTF_FN size_t scratch_len(int nw2, int nsub, int splits) {
  return part_offset(nw2, nsub) + (size_t)splits * nw2 * nw2 * 6;
}

// ---------------------------------------------------------------------------
// the finishing pass: once per pair
// ---------------------------------------------------------------------------

// Pinkster IV of pair (i1, i2) (reference :1449-1456) added to acc[12]
// = [force (re, im) x 3, moment (re, im) x 3]
QTF_FN void pinkster_add(const Fields& a, int i1, int i2, double* acc) {
  const int nw2 = a.nw2;
  cv3 xr1, xr2c, F1, F2c, M1, M2c;
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    xr1.x[c] = a.Xi[(size_t)(3 + c) * nw2 + i1];
    xr2c.x[c] = conj(a.Xi[(size_t)(3 + c) * nw2 + i2]);
    F1.x[c] = a.F1st[(size_t)c * nw2 + i1];
    F2c.x[c] = conj(a.F1st[(size_t)c * nw2 + i2]);
    M1.x[c] = a.F1st[(size_t)(3 + c) * nw2 + i1];
    M2c.x[c] = conj(a.F1st[(size_t)(3 + c) * nw2 + i2]);
  }
  const cv3 rotF = scale(0.25, add(cross(xr1, F2c), cross(xr2c, F1)));
  const cv3 rotM = scale(0.25, add(cross(xr1, M2c), cross(xr2c, M1)));
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    acc[2 * c] += rotF.x[c].re;
    acc[2 * c + 1] += rotF.x[c].im;
    acc[6 + 2 * c] += rotM.x[c].re;
    acc[6 + 2 * c + 1] += rotM.x[c].im;
  }
}

// the relative wave-elevation term of waterline member im for pair (i1,
// i2) (reference :1603-1631; Ca of the member's last submerged node),
// added to acc[12]
QTF_FN void member_add(const Fields& a, int im, int i1, int i2,
                       double* acc) {
  const int nw2 = a.nw2;
  const cd er1 = a.wleta[(size_t)im * nw2 + i1];
  const cd er2c = conj(a.wleta[(size_t)im * nw2 + i2]);
  // 0.25 (conj(er2) c1 + er1 conj(c2)) for field t of [udw, aw, g_e1]
  auto two = [&](int t) {
    cv3 r;
    QTF_UNROLL
    for (int c = 0; c < 3; ++c) {
      const size_t base = (((size_t)im * 3 + t) * 3 + c) * nw2;
      r.x[c] = 0.25 * (er2c * a.wlc[base + i1] + er1 * conj(a.wlc[base + i2]));
    }
    return r;
  };
  const double* geo = a.wlgeo + 4 * im;
  const double* Mw = a.wlmats + 18 * im;
  const double rA = a.rho * geo[0];
  cv3 fe = scale(rA, rmv(Mw, two(0)));
  fe = sub(fe, scale(rA, rmv(Mw + 9, two(1))));
  fe = sub(fe, scale(rA, two(2)));
  const cv3 me = rcross(geo + 1, fe);
  QTF_UNROLL
  for (int c = 0; c < 3; ++c) {
    acc[2 * c] += fe.x[c].re;
    acc[2 * c + 1] += fe.x[c].im;
    acc[6 + 2 * c] += me.x[c].re;
    acc[6 + 2 * c + 1] += me.x[c].im;
  }
}

// A pair's own terms and the finishing pass run kLanes lanes a pair, and
// the lanes' sums meet by a shuffle tree (lane l takes lane l + d's, d =
// kLanes / 2, ..., 1; lane_tree below is its order).  The terms: lane l
// adds the waterline members l, l + kLanes, ..., and lane kLanes - 1
// Pinkster IV after its members.  The finish: lane l adds the node-split
// partial sums l, l + kLanes, ..., and lane 0 writes Q = terms + the sum.
constexpr int kLanes = 8;

QTF_FN void pair_terms_lane(const Fields& a, int i1, int i2, int lane,
                            double* v) {
  for (int im = lane; im < a.nm; im += kLanes) member_add(a, im, i1, i2, v);
  if (lane == kLanes - 1) pinkster_add(a, i1, i2, v);
}

// the shuffle tree's sum of v[kLanes][n], in lane 0's order
QTF_FN void lane_tree(double (*v)[12], int n) {
  for (int d = kLanes / 2; d > 0; d /= 2)
    for (int l = 0; l + d < kLanes; ++l)
      for (int c = 0; c < n; ++c) v[l][c] += v[l + d][c];
}

QTF_FN void finish_write(const double* terms, const double* v, cd* Q) {
  QTF_UNROLL
  for (int c = 0; c < 6; ++c)
    Q[c] = cd{terms[2 * c] + v[2 * c], terms[2 * c + 1] + v[2 * c + 1]};
}

}  // namespace qtf
