// K5: the slender-body QTF pair grid for Hopper (sm_90a), float64.
//
// Replaces raft_tpu/ops/pallas/qtf_pair.py:qtf_pair_grid (pallas_call at
// :381, body _qtf_pair_kernel :97-295).  For every difference-frequency
// pair (i1, i2) of the second-order grid it sums, over the strip nodes,
// the raw slender-body wrench of Rainey's equation plus Pinkster's terms:
// the second-order potential, convective acceleration, axial divergence,
// body motion in the first-order field, the Rainey body-rotation terms and
// the axial/end pressure terms (per node, masked to submerged nodes, with
// the moment about the PRP), then adds Pinkster IV and the relative
// wave-elevation term of each waterline-crossing member.  No Hermitian
// completion and no Kim & Yue correction: the caller applies them.
//
// Everything computed per (pair, node) or per pair lives here as
// __host__ __device__ functions on a two-double complex struct, so g++
// builds the same arithmetic for the CPU tests
// (tests/test_torch_kernel_body.py) and qtf_k5_f64.cu only adds the
// block reduction and the launch.
//
// Layout (frequency-major, so a block's loads of one frequency's node
// fields are contiguous): w, k (nw2); Xi, F1st (nw2, 6); u, dr, nv
// (nw2, N, 3); nax (nw2, N); gu (nw2, N, 3, 3); gp (nw2, N, 3) complex;
// q, off, pos (N, 3); Minert, CaMat, ptMat, qMat (N, 3, 3); nsc (N, 4) =
// [v_side (submergence-scaled), v_end * Ca_End, a_i, submerged] real;
// waterline members: wlc (nw2, nm, 3, 3) complex = [udw, aw, g_e1][xyz],
// wleta (nw2, nm) complex, wlmats (nm, 2, 3, 3) = [Minert, CaMat] of the
// member's last submerged node, wlgeo (nm, 4) = [area, r_int - r_PRP].
// Output Q (nw2, nw2, 6) complex.
//
// What bounds it on this card: FP64 arithmetic.  The function needs
// about 800 FP64 operations per (pair, submerged node) (counted in
// chip_smoke.py:qtf_ops) on ~1.2 KB of node fields that are shared by a
// whole row or column of the pair grid and stay in L2, so bytes from HBM
// are ~1/nw2 of what the threads read.  The body below does about 2,100
// there: it redoes per pair the work that depends on one frequency
// (dw/dz, the transverse and (I - qMat) projections, CaMat and ptMat on
// u - nv, the axis products) and applies each matrix to each term on its
// own.  The design: one block per pair, the threads striding over the
// nodes with the wrench in 12 registers, nodes above water skipped (their
// wrench is multiplied by zero), one warp-shuffle and shared-memory
// reduction, and one thread adding the per-pair terms.  What keeps it
// above that bound is the repeated work and each thread's serial chain
// through the node body at the register limit (PERF.md has the card's
// numbers); hoisting the per-frequency node terms into a first pass,
// sharing them across a row's blocks and splitting the body over lanes
// is later work.
#pragma once

#include <math.h>
#include <stddef.h>

namespace qtf {

constexpr double kKhDeep = 89.4;   // raft_tpu/ops/waves.py _KH_DEEP

struct alignas(16) cd {
  double re, im;
};

__host__ __device__ inline cd operator+(cd a, cd b) {
  return cd{a.re + b.re, a.im + b.im};
}
__host__ __device__ inline cd operator-(cd a, cd b) {
  return cd{a.re - b.re, a.im - b.im};
}
__host__ __device__ inline cd operator*(cd a, cd b) {
  return cd{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__host__ __device__ inline cd operator*(double s, cd a) {
  return cd{s * a.re, s * a.im};
}
__host__ __device__ inline cd operator*(cd a, double s) {
  return cd{s * a.re, s * a.im};
}
__host__ __device__ inline cd conj(cd a) { return cd{a.re, -a.im}; }
// i * a
__host__ __device__ inline cd mul_i(cd a) { return cd{-a.im, a.re}; }
// exp(i t)
__host__ __device__ inline cd expi(double t) { return cd{cos(t), sin(t)}; }

struct cv3 {
  cd x[3];
};

__host__ __device__ inline cv3 load3(const cd* p) {
  cv3 v;
  for (int i = 0; i < 3; ++i) v.x[i] = p[i];
  return v;
}
__host__ __device__ inline cv3 zero3() {
  cv3 v;
  for (int i = 0; i < 3; ++i) v.x[i] = cd{0.0, 0.0};
  return v;
}
__host__ __device__ inline cv3 add(cv3 a, cv3 b) {
  cv3 r;
  for (int i = 0; i < 3; ++i) r.x[i] = a.x[i] + b.x[i];
  return r;
}
__host__ __device__ inline cv3 sub(cv3 a, cv3 b) {
  cv3 r;
  for (int i = 0; i < 3; ++i) r.x[i] = a.x[i] - b.x[i];
  return r;
}
__host__ __device__ inline cv3 scale(double s, cv3 a) {
  cv3 r;
  for (int i = 0; i < 3; ++i) r.x[i] = s * a.x[i];
  return r;
}
__host__ __device__ inline cv3 scale(cd s, cv3 a) {
  cv3 r;
  for (int i = 0; i < 3; ++i) r.x[i] = s * a.x[i];
  return r;
}
__host__ __device__ inline cv3 conj3(cv3 a) {
  cv3 r;
  for (int i = 0; i < 3; ++i) r.x[i] = conj(a.x[i]);
  return r;
}
// a complex scalar times a real vector
__host__ __device__ inline cv3 cr3(cd s, const double* q) {
  cv3 r;
  for (int i = 0; i < 3; ++i) r.x[i] = s * q[i];
  return r;
}
// real 3x3 (row-major) times complex vector
__host__ __device__ inline cv3 rmv(const double* M, cv3 v) {
  cv3 r;
  for (int i = 0; i < 3; ++i)
    r.x[i] = M[3 * i] * v.x[0] + M[3 * i + 1] * v.x[1] + M[3 * i + 2] * v.x[2];
  return r;
}
// complex 3x3 (row-major) times complex vector; conj_m conjugates M
__host__ __device__ inline cv3 cmv(const cd* M, cv3 v, bool conj_m) {
  cv3 r;
  for (int i = 0; i < 3; ++i) {
    cd s{0.0, 0.0};
    for (int j = 0; j < 3; ++j)
      s = s + (conj_m ? conj(M[3 * i + j]) : M[3 * i + j]) * v.x[j];
    r.x[i] = s;
  }
  return r;
}
// a x b, complex
__host__ __device__ inline cv3 cross(cv3 a, cv3 b) {
  cv3 r;
  r.x[0] = a.x[1] * b.x[2] - a.x[2] * b.x[1];
  r.x[1] = a.x[2] * b.x[0] - a.x[0] * b.x[2];
  r.x[2] = a.x[0] * b.x[1] - a.x[1] * b.x[0];
  return r;
}
// a x b with a real
__host__ __device__ inline cv3 rcross(const double* a, cv3 b) {
  cv3 r;
  r.x[0] = a[1] * b.x[2] - a[2] * b.x[1];
  r.x[1] = a[2] * b.x[0] - a[0] * b.x[2];
  r.x[2] = a[0] * b.x[1] - a[1] * b.x[0];
  return r;
}
// sum_i a_i q_i with q real (no conjugation)
__host__ __device__ inline cd dotr(cv3 a, const double* q) {
  return a.x[0] * q[0] + a.x[1] * q[1] + a.x[2] * q[2];
}
// sum_i a_i b_i (no conjugation)
__host__ __device__ inline cd dot(cv3 a, cv3 b) {
  return a.x[0] * b.x[0] + a.x[1] * b.x[1] + a.x[2] * b.x[2];
}
// v - (v . q) q: the part of v transverse to the member axis q
__host__ __device__ inline cv3 transverse(cv3 v, const double* q) {
  return sub(v, cr3(dotr(v, q), q));
}

struct Args {
  int nw2, N, nm;
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
  cd* Q;
};

// what every node of one pair shares
struct Pair {
  double w1, w2;
  bool pot;            // the 2nd-order potential is active for this pair
  double dkx, dky, nk, dw, cosh_nkh;
  cd aux;              // 0.5 (gamma21 + conj(gamma12))
  cv3 o1;              // i w1 Xi1[3:]
  cv3 o2c;             // conj(i w2 Xi2[3:])
};

// raft_tpu/ops/waves.py:wave_pot_2nd_order, the pair-only part (both
// headings beta), and the body-rotation vectors of the Rainey terms
__host__ __device__ inline Pair pair_setup(const Args& a, int i1, int i2) {
  Pair P;
  double w1 = a.w[i1], w2 = a.w[i2], k1 = a.k[i1], k2 = a.k[i2];
  P.w1 = w1;
  P.w2 = w2;
  P.dkx = k1 * a.cosb - k2 * a.cosb;
  P.dky = k1 * a.sinb - k2 * a.sinb;
  P.nk = sqrt(P.dkx * P.dkx + P.dky * P.dky);
  P.dw = w1 - w2;
  P.pot = (k1 > 0.0) && (k2 > 0.0) && (w1 != w2);
  P.aux = cd{0.0, 0.0};
  P.cosh_nkh = 1.0;
  if (P.pot) {
    double h = a.h, g = a.g;
    double th1 = tanh(k1 * h), th2 = tanh(k2 * h), thn = tanh(P.nk * h);
    double den12 = P.dw * P.dw / g - P.nk * thn;
    if (den12 == 0.0) den12 = 1.0;
    // (-i g / (2 w)) * real / den12: purely imaginary
    double g12 = -(g / (2.0 * w1)) *
                 ((k1 * k1) * (1.0 - th1 * th1) -
                  2.0 * k1 * k2 * (1.0 + th1 * th2)) / den12;
    double g21 = -(g / (2.0 * w2)) *
                 ((k2 * k2) * (1.0 - th2 * th2) -
                  2.0 * k2 * k1 * (1.0 + th2 * th1)) / den12;
    // 0.5 * (i g21 + conj(i g12)) = 0.5 i (g21 - g12)
    P.aux = cd{0.0, 0.5 * (g21 - g12)};
    P.cosh_nkh = cosh(fmin(P.nk * h, kKhDeep));
  }
  const cd* X1 = a.Xi + 6 * i1;
  const cd* X2 = a.Xi + 6 * i2;
  for (int c = 0; c < 3; ++c) {
    P.o1.x[c] = mul_i(w1 * X1[3 + c]);
    P.o2c.x[c] = conj(mul_i(w2 * X2[3 + c]));
  }
  return P;
}

// the raw wrench of node n for pair (i1, i2), added to acc[12] =
// [force (re, im) x 3, moment about the PRP (re, im) x 3]
__host__ __device__ inline void node_wrench(const Args& a, const Pair& P,
                                            int i1, int i2, int n,
                                            double* acc) {
  const double* ns = a.nsc + 4 * n;
  // above water: the wrench is masked to 0.  Skipping the node equals
  // multiplying by 0 only for finite fields, which qtf_fields checks
  // (ops/kernels/qtf_pair.py:check_dry_nodes).
  if (ns[3] == 0.0) return;
  const int N = a.N;
  const double rho = a.rho;
  const double rv = rho * ns[0];          // rho v_i
  const double re = rho * ns[1];          // rho v_end Ca_End
  const double ai = ns[2];
  const double* q = a.q + 3 * n;
  const double* pos = a.pos + 3 * n;
  const double* Mi = a.Minert + 9 * n;
  const double* Ca = a.CaMat + 9 * n;
  const double* Pt = a.ptMat + 9 * n;
  const double* Qm = a.qMat + 9 * n;
  const size_t f1 = (size_t)i1 * N + n, f2 = (size_t)i2 * N + n;
  cv3 u1 = load3(a.u + 3 * f1), u2 = load3(a.u + 3 * f2);
  cv3 dr1 = load3(a.dr + 3 * f1), dr2 = load3(a.dr + 3 * f2);
  cv3 nv1 = load3(a.nv + 3 * f1), nv2 = load3(a.nv + 3 * f2);
  cv3 gp1 = load3(a.gp + 3 * f1), gp2 = load3(a.gp + 3 * f2);
  cd nax1 = a.nax[f1], nax2 = a.nax[f2];
  const cd* gu1 = a.gu + 9 * f1;
  const cd* gu2 = a.gu + 9 * f2;

  // ---- 2nd-order potential (reference :1541-1544, :1578-1582) ----
  cv3 acc2 = zero3();
  cd p2{0.0, 0.0};
  if (P.pot && pos[2] <= 0.0) {
    double nkzh = fmin(P.nk * (pos[2] + a.h), kKhDeep);
    double kxy = cosh(nkzh) / P.cosh_nkh;
    double kz = sinh(nkzh) / P.cosh_nkh;
    cd ph = expi(-(P.dkx * pos[0] + P.dky * pos[1]));
    cd bxy = P.aux * kxy * ph;
    acc2.x[0] = bxy * (P.dw * P.dkx);
    acc2.x[1] = bxy * (P.dw * P.dky);
    acc2.x[2] = mul_i(P.aux * kz * ph) * (P.dw * P.nk);
    p2 = mul_i(bxy) * (-rho * P.dw);
  }
  cv3 f = add(add(scale(rv, rmv(Mi, acc2)), cr3(ai * p2, q)),
              scale(re, rmv(Qm, acc2)));

  // ---- convective acceleration (reference :1546-1548, :1598-1601) ----
  cv3 ca = scale(0.25, add(cmv(gu1, conj3(u2), false), cmv(gu2, u1, true)));
  cv3 u1a = sub(u1, nv1), u2a = sub(u2, nv2);
  cv3 cu1 = rmv(Ca, u1a), cu2 = rmv(Ca, u2a);
  cd pdrop = (-0.25 * rho) * dot(rmv(Pt, u1a), conj3(cu2));
  f = add(f, add(add(scale(rv, rmv(Mi, ca)), scale(re, rmv(Qm, ca))),
                 cr3(ai * pdrop, q)));

  // ---- Rainey axial divergence (reference :1550-1551) ----
  cd dwdz1 = dotr(cmv(gu1, cr3(cd{1.0, 0.0}, q), false), q);
  cd dwdz2 = dotr(cmv(gu2, cr3(cd{1.0, 0.0}, q), false), q);
  cv3 t1 = sub(transverse(u1, q), transverse(nv1, q));
  cv3 t2 = sub(transverse(u2, q), transverse(nv2, q));
  cv3 axdv = scale(0.25, add(scale(dwdz1, conj3(t2)), scale(conj(dwdz2), t1)));
  f = add(f, scale(rv, rmv(Ca, transverse(axdv, q))));

  // ---- body motion in the first-order field (reference :1553-1555,
  //      :1590-1596); grad(du) = i w grad(u) ----
  cv3 an = scale(0.25, add(scale(mul_i(cd{P.w1, 0.0}), cmv(gu1, conj3(dr2), false)),
                           scale(conj(mul_i(cd{P.w2, 0.0})), cmv(gu2, dr1, true))));
  cd pn = 0.25 * (dot(gp1, conj3(dr2)) + dot(conj3(gp2), dr1));
  f = add(f, add(add(scale(rv, rmv(Mi, an)), scale(re, rmv(Qm, an))),
                 cr3(ai * pn, q)));

  // ---- Rainey body-rotation terms (reference :1557-1576): OM1 x =
  //      o1 x x, conj(OM2) x = o2c x x ----
  cv3 vec1 = cr3(nax1, q), vec2 = cr3(nax2, q);
  cv3 rot = add(cross(P.o1, conj3(vec2)), cross(P.o2c, vec1));
  cv3 fr = scale(-0.5 * rv, rmv(Ca, rot));
  // V1 x = gu1 x + o1 x x;  conj(V2) x = conj(gu2) x + o2c x x
  cv3 cu2c = conj3(cu2);
  cv3 aux = scale(0.25, add(add(cmv(gu1, cu2c, false), cross(P.o1, cu2c)),
                            add(cmv(gu2, cu1, true), cross(P.o2c, cu1))));
  aux = sub(aux, rmv(Qm, aux));
  fr = add(fr, scale(rv, aux));
  cv3 u1at = sub(u1a, rmv(Qm, u1a)), u2at = sub(u2a, rmv(Qm, u2a));
  cv3 u2atc = conj3(u2at);
  cv3 v1u = add(cmv(gu1, u2atc, false), cross(P.o1, u2atc));
  cv3 v2u = add(cmv(gu2, u1at, true), cross(P.o2c, u1at));
  cv3 aux2 = scale(0.25, add(rmv(Ca, v1u), rmv(Ca, v2u)));
  fr = sub(fr, scale(rv, aux2));
  f = add(f, fr);

  // ---- wrench about the PRP ----
  f = scale(ns[3], f);
  cv3 m = rcross(a.off + 3 * n, f);
  for (int c = 0; c < 3; ++c) {
    acc[2 * c] += f.x[c].re;
    acc[2 * c + 1] += f.x[c].im;
    acc[6 + 2 * c] += m.x[c].re;
    acc[6 + 2 * c + 1] += m.x[c].im;
  }
}

// Pinkster IV and the waterline terms of pair (i1, i2) added to the node
// sum side[12]; writes Q[i1, i2, :]
__host__ __device__ inline void pair_finish(const Args& a, const Pair& P,
                                            int i1, int i2,
                                            const double* side) {
  const double rho = a.rho;
  // ---- Pinkster IV (reference :1449-1456) ----
  const cd* X1 = a.Xi + 6 * i1;
  const cd* X2 = a.Xi + 6 * i2;
  const cd* F1 = a.F1st + 6 * i1;
  const cd* F2 = a.F1st + 6 * i2;
  cv3 xr1 = load3(X1 + 3), xr2c = conj3(load3(X2 + 3));
  cv3 rotF = scale(0.25, add(cross(xr1, conj3(load3(F2))),
                             cross(xr2c, load3(F1))));
  cv3 rotM = scale(0.25, add(cross(xr1, conj3(load3(F2 + 3))),
                             cross(xr2c, load3(F1 + 3))));
  cd out[6];
  for (int c = 0; c < 3; ++c) {
    out[c] = rotF.x[c] + cd{side[2 * c], side[2 * c + 1]};
    out[3 + c] = rotM.x[c] + cd{side[6 + 2 * c], side[6 + 2 * c + 1]};
  }
  // ---- relative wave elevation per waterline member (reference
  //      :1603-1631); Ca of the member's last submerged node ----
  cv3 eF = zero3(), eM = zero3();
  for (int im = 0; im < a.nm; ++im) {
    const cd* c1 = a.wlc + ((size_t)i1 * a.nm + im) * 9;
    const cd* c2 = a.wlc + ((size_t)i2 * a.nm + im) * 9;
    cd er1 = a.wleta[(size_t)i1 * a.nm + im];
    cd er2c = conj(a.wleta[(size_t)i2 * a.nm + im]);
    const double* geo = a.wlgeo + 4 * im;
    const double* Mw = a.wlmats + 18 * im;
    const double* Cw = Mw + 9;
    double rA = rho * geo[0];
    cv3 fe = scale(0.25, add(scale(er2c, load3(c1)), scale(er1, conj3(load3(c2)))));
    fe = scale(rA, rmv(Mw, fe));
    cv3 ae = scale(0.25, add(scale(er2c, load3(c1 + 3)),
                             scale(er1, conj3(load3(c2 + 3)))));
    fe = sub(fe, scale(rA, rmv(Cw, ae)));
    fe = sub(fe, scale(0.25 * rA, add(scale(er2c, load3(c1 + 6)),
                                      scale(er1, conj3(load3(c2 + 6))))));
    eF = add(eF, fe);
    eM = add(eM, rcross(geo + 1, fe));
  }
  cd* Q = a.Q + ((size_t)i1 * a.nw2 + i2) * 6;
  for (int c = 0; c < 3; ++c) {
    Q[c] = out[c] + eF.x[c];
    Q[3 + c] = out[3 + c] + eM.x[c];
  }
}

}  // namespace qtf
