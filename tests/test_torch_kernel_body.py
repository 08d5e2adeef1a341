"""The CUDA kernels' per-lane arithmetic, compiled for the host.

``raft_tpu_torch/csrc/gj_group.cuh`` holds everything the Gauss-Jordan
kernels compute per row of a lane — the impedance solve (K1/K3) and the
batched solve A x = b (K2/K4), one body for both — and
``csrc/qtf_pair.cuh`` everything the QTF pair-grid kernel (K5) computes
per (pair, node) and per pair, as ``__host__ __device__`` functions.
Here they are compiled with g++ (``__host__``/``__device__`` defined
empty) into small C libraries in ``tmp_path``, loaded with ctypes, and
held against the port's plain PyTorch versions — the only check of the
kernels' arithmetic (row exchanges and all) that can run without a card.
A lane's rows meet through a group policy; here ``gjg::HostGroup`` steps
a lane's 16 rows in lockstep where the card's shuffles and shared slots
exchange them, and divides with ``a / b`` where the card takes the
division's fast path (``gjl::quot``).  The kernels themselves are checked
against the same plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raft_tpu_torch.models import qtf_cases as QC
from raft_tpu_torch.ops.kernels.gj_solve import (
    gj_solve_plain, impedance_gj_solve_plain)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "raft_tpu_torch", "csrc")

#: the kernel's real row swap vs the plain version's arithmetic swap, and
#: sum orders, differ by rounding only
TOL = 1e-10

_HOST_SRC = r"""
#include "gj_group.cuh"
// K1/K3: the kernel's tiles in turn, each staged, solved group by group
// (gjg::HostGroup: the 16 rows of a lane in lockstep) and written back.
// width: 0 = float64 (K1), 1 = mixed with float32 elimination, 2 = mixed
// with bf16 elimination (K3/K4); returns the promoted count.
template <typename T, typename E, int N, typename P>
static int imp_group(P& g, const T* w, const T* M, const T* B, const T* C,
    const T* F, T* X, T* rn, int nb, int nw, int refine, double tol) {
  int promoted = 0;
  gjg::Tile<T, N> tile;
  const int ntile = (nw + gjg::kTileF - 1) / gjg::kTileF;
  for (int b = 0; b < nb; ++b)
    for (int tb = 0; tb < ntile; ++tb) {
      const int f0 = tb * gjg::kTileF;
      gjg::stage(tile, w, M, B, C, F, b, f0, nw, 0, 1);
      for (int fl = 0; fl < gjg::kTileF && f0 + fl < nw; ++fl) {
        T r;
        promoted += gjg::solve_lane<T, E, N>(g, tile, fl, true, refine, tol,
                                             &r);
        if (rn) rn[b * nw + f0 + fl] = r;
      }
      gjg::writeback(tile, X, b, f0, nw, 0, 1);
    }
  return promoted;
}
template <int N>
static int imp_n(const double* w, const double* M, const double* B,
    const double* C, const double* F, double* X, double* rn, int nb, int nw,
    int refine, int width, double tol) {
  gjg::HostGroup g;
  if (width == 0)
    return imp_group<double, double, N>(g, w, M, B, C, F, X, nullptr, nb, nw,
                                        refine, tol);
  if (width == 1)
    return imp_group<double, float, N>(g, w, M, B, C, F, X, rn, nb, nw,
                                       refine, tol);
  return imp_group<double, gjl::bf16r, N>(g, w, M, B, C, F, X, rn, nb, nw,
                                          refine, tol);
}
#define IMP_N(NN) \
  if (n == NN) return imp_n<NN>(w, M, B, C, F, X, rn, nb, nw, refine, width, tol);
extern "C" int host_impedance(const double* w, const double* M,
    const double* B, const double* C, const double* F, double* X, double* rn,
    int nb, int nw, int n, int refine, int width, double tol) {
  IMP_N(1) IMP_N(2) IMP_N(3) IMP_N(4) IMP_N(5) IMP_N(6) IMP_N(7) IMP_N(8)
  return -1;
}
extern "C" void host_impedance_f32(const float* w, const float* M,
    const float* B, const float* C, const float* F, float* X, int nb, int nw,
    int refine) {
  gjg::HostGroup g;
  imp_group<float, float, 6>(g, w, M, B, C, F, X, nullptr, nb, nw, refine,
                             0.0);
}
// the pivot positions that every elimination step of a lane chose, in
// order (the first elimination's S steps first)
struct TraceGroup : gjg::HostGroup {
  int* log;
  int n = 0;
  template <typename Fn>
  gjg::Key argmax(Fn key) {
    gjg::Key k = gjg::HostGroup::argmax(key);
    log[n++] = k.pos;
    return k;
  }
};
extern "C" int host_impedance_pivots(const double* w, const double* M,
    const double* B, const double* C, const double* F, double* X, int nw,
    int* log) {
  TraceGroup g;
  g.log = log;
  imp_group<double, double, 3>(g, w, M, B, C, F, X, nullptr, 1, nw, 0, 0.0);
  return g.n;
}
// K2/K4: the kernel's tiles of 8 systems in turn, each staged and solved
// group by group (gjg::HostGroup), the solutions stored from the group's
// slot.  width as for host_impedance; returns the promoted count.
template <typename T, typename E, int N, int K, typename P>
static int gj_group(P& g, const T* A, const T* b, T* x, T* rn, int lanes,
    int refine, double tol) {
  int promoted = 0;
  static gjg::GjTile<T, N, K> tile;
  for (int lane0 = 0; lane0 < lanes; lane0 += gjg::kTileL) {
    gjg::stage_gj(tile, A, b, lane0, lanes, 0, 1);
    for (int l = 0; l < gjg::kTileL && lane0 + l < lanes; ++l) {
      T r;
      promoted += gjg::solve_system<T, E, N, K>(g, tile, l, refine, tol, &r);
      gjg::store_x<N * K>(g.template x<T>(), x + (size_t)(lane0 + l) * N * K,
                          0, 1);
      if (rn) rn[lane0 + l] = r;
    }
  }
  return promoted;
}
template <int N, int K>
static int gj_nk(const double* A, const double* b, double* x, double* rn,
    int lanes, int refine, int width, double tol) {
  gjg::HostGroup g;
  if (width == 0)
    return gj_group<double, double, N, K>(g, A, b, x, nullptr, lanes, refine,
                                          tol);
  if (width == 1)
    return gj_group<double, float, N, K>(g, A, b, x, rn, lanes, refine, tol);
  return gj_group<double, gjl::bf16r, N, K>(g, A, b, x, rn, lanes, refine,
                                            tol);
}
#define GJ_NK(NN, KK) \
  if (n == NN && k == KK) return gj_nk<NN, KK>(A, b, x, rn, lanes, refine, width, tol);
// the (n, k) the tests take: even n = 2..16 with k = 1 and n/2
extern "C" int host_gj(const double* A, const double* b, double* x,
    double* rn, int lanes, int n, int k, int refine, int width, double tol) {
  GJ_NK(2, 1) GJ_NK(4, 1) GJ_NK(4, 2) GJ_NK(6, 1) GJ_NK(6, 3) GJ_NK(8, 1)
  GJ_NK(8, 4) GJ_NK(10, 1) GJ_NK(10, 5) GJ_NK(12, 1) GJ_NK(12, 6)
  GJ_NK(14, 1) GJ_NK(14, 7) GJ_NK(16, 1) GJ_NK(16, 8)
  return -1;
}
extern "C" void host_gj_f32(const float* A, const float* b, float* x,
    int lanes, int refine) {
  gjg::HostGroup g;
  gj_group<float, float, 12, 6>(g, A, b, x, nullptr, lanes, refine, 0.0);
}
extern "C" int host_gj_pivots(const double* A, const double* b, double* x,
    int lanes, int* log) {
  TraceGroup g;
  g.log = log;
  gj_group<double, double, 12, 6>(g, A, b, x, nullptr, lanes, 0, 0.0);
  return g.n;
}
extern "C" float host_round_bf16(float v) { return gjl::round_bf16(v); }
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available to compile the kernel body")
    d = tmp_path_factory.mktemp("gj_body")
    src = d / "host_gj.cpp"
    src.write_text(_HOST_SRC)
    so = d / "libhost_gj.so"
    # -O1: the body's unrolled instantiations build in half -O2's time,
    # with the same IEEE arithmetic
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", CSRC,
                    "-o", str(so), str(src)], check=True)
    L = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    D, Fl = ctypes.c_double, ctypes.c_float
    L.host_impedance.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, D]
    L.host_impedance.restype = I
    L.host_impedance_f32.argtypes = [P, P, P, P, P, P, I, I, I]
    L.host_impedance_pivots.argtypes = [P, P, P, P, P, P, I, P]
    L.host_impedance_pivots.restype = I
    L.host_gj.argtypes = [P, P, P, P, I, I, I, I, I, D]
    L.host_gj.restype = I
    L.host_gj_f32.argtypes = [P, P, P, I, I]
    L.host_gj_pivots.argtypes = [P, P, P, I, P]
    L.host_gj_pivots.restype = I
    L.host_round_bf16.argtypes = [Fl]
    L.host_round_bf16.restype = Fl
    return L


def _ptr(a):
    return a.ctypes.data


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _gj_body(lib, A, b, refine=1, width=0, tol=1e-9):
    """The kernel body's solve of every lane: x, or (x, rn, promoted)
    for the mixed widths (1: float32 elimination, 2: bf16)."""
    lanes, n, _ = A.shape
    k = b.shape[-1]
    A = np.ascontiguousarray(A)
    b = np.ascontiguousarray(b)
    x = np.zeros((lanes, n, k))
    rn = np.zeros(lanes)
    promoted = lib.host_gj(_ptr(A), _ptr(b), _ptr(x), _ptr(rn), lanes, n, k,
                           refine, width, tol)
    assert promoted >= 0
    return x if width == 0 else (x, rn, promoted)


def _pivot_stack(rng, lanes, n):
    """Systems whose leading entries are zero, so every lane pivots."""
    P = np.stack([np.eye(n)[rng.permutation(n)] for _ in range(lanes)])
    return P * rng.uniform(1.0, 3.0, (lanes, n, 1)) \
        + 0.05 * rng.standard_normal((lanes, n, n)) * (P == 0)


@pytest.mark.parametrize("case", ["random", "pivoting", "row_scales"])
@pytest.mark.parametrize("nk", [(12, 6), (12, 1), (4, 2)])
def test_gj_lane_matches_plain(lib, case, nk):
    n, k = nk
    rng = np.random.default_rng(7)
    lanes = 37
    if case == "random":
        A = rng.standard_normal((lanes, n, n)) + 4.0 * np.eye(n)
    elif case == "pivoting":
        A = _pivot_stack(rng, lanes, n)
    else:
        A = (0.1 * rng.standard_normal((lanes, n, n)) + np.eye(n)) \
            * 10.0 ** rng.uniform(3, 10, (lanes, n, 1))
    b = rng.standard_normal((lanes, n, k)) * 1e3
    x_body = _gj_body(lib, A, b)
    x_plain = gj_solve_plain(torch.tensor(A), torch.tensor(b)).numpy()
    assert _rel(x_body, x_plain) < TOL


def _imp_inputs(rng, n, nb, nw):
    w = np.linspace(0.1, 2.5, nw)
    M = rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[None, :, :, None]
    B = 0.3 * rng.standard_normal((nb, n, n, nw))
    C = rng.standard_normal((nb, n, n)) + 10.0 * np.eye(n)
    F = rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal((nb, n, nw))
    return w, M, B, C, F


def _tie(M, B, C, case=0):
    """Make every lane of ``case`` Z = C with |C[i, 0]| = 4 the largest
    entry of every row: after equilibration the first pivot column ties
    exactly at magnitude 1 over the top n rows (signs alternate)."""
    n = C.shape[-1]
    M[case] = 0.0
    B[case] = 0.0
    C[case] = np.clip(C[case], -1.0, 1.0)
    C[case][:, 0] = 4.0 * (-1.0) ** np.arange(n)
    return M, B, C


def _imp_body(lib, w, M, B, C, F, refine=1, width=0, tol=1e-9):
    """The group body's solve of every lane: X, or (X, rn, promoted) for
    the mixed widths (1: float32 elimination, 2: bf16)."""
    nb, n, nw = F.shape
    X = np.zeros((nb, n, nw), dtype=complex)
    rn = np.zeros(nb * nw)
    promoted = lib.host_impedance(
        _ptr(w), _ptr(np.ascontiguousarray(M)), _ptr(np.ascontiguousarray(B)),
        _ptr(np.ascontiguousarray(C)), _ptr(np.ascontiguousarray(F)), _ptr(X),
        _ptr(rn), nb, nw, n, refine, width, tol)
    assert promoted >= 0
    return X if width == 0 else (X, rn, promoted)


def _imp_plain(w, M, B, C, F, **kw):
    out = impedance_gj_solve_plain(torch.tensor(w), torch.tensor(M),
                                   torch.tensor(B), torch.tensor(C),
                                   torch.tensor(F), **kw)
    return out.numpy() if not isinstance(out, tuple) else (out[0].numpy(),
                                                           out[1])


@pytest.mark.parametrize("n,nb,nw", [(6, 3, 17), (3, 2, 5), (1, 2, 9),
                                     (2, 3, 8), (7, 2, 11), (8, 2, 13)])
def test_impedance_lane_matches_plain(lib, n, nb, nw):
    """K1's group body (one row a "thread", positions swapped for rows)
    against the plain version, ragged tiles (nw not a multiple of 8)
    included."""
    w, M, B, C, F = _imp_inputs(np.random.default_rng(11), n, nb, nw)
    X = _imp_body(lib, w, M, B, C, F)
    assert _rel(X, _imp_plain(w, M, B, C, F)) < TOL


@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 8])
@pytest.mark.parametrize("width", [0, 1, 2])
def test_impedance_tie_lanes_match_plain(lib, width, n):
    """A case whose first pivot column ties exactly on every lane: the
    first maximal row wins on both sides, X and the promoted count agree."""
    w, M, B, C, F = _imp_inputs(np.random.default_rng(31), n, 2, 10)
    M, B, C = _tie(M, B, C)
    if width == 0:
        X = _imp_body(lib, w, M, B, C, F)
        assert _rel(X, _imp_plain(w, M, B, C, F)) < TOL
        return
    X, _, promoted = _imp_body(lib, w, M, B, C, F, refine=2, width=width)
    Xp, st = _imp_plain(w, M, B, C, F, refine=2, precision="mixed",
                        factor_dtype=_WIDTHS[width], promote_tol=1e-9,
                        return_stats=True)
    assert promoted == int(st["promoted"])
    assert _rel(X, Xp) < (1e-10 if width == 1 else 1e-7)


def test_impedance_pivots_first_maximal_row(lib):
    """The pivot position each elimination step of the group body took,
    against a scan that takes the first maximal row (numpy's argmax) over
    the same equilibrated embedding: on the tie lanes the first of the
    tied rows, every step."""
    rng = np.random.default_rng(37)
    n, nw = 3, 4
    w, M, B, C, F = _imp_inputs(rng, n, 1, nw)
    M, B, C = _tie(M, B, C)
    X = np.zeros((1, n, nw), dtype=complex)
    log = np.zeros(2 * n * nw, dtype=np.int32)
    steps = lib.host_impedance_pivots(
        _ptr(w), _ptr(np.ascontiguousarray(M)), _ptr(np.ascontiguousarray(B)),
        _ptr(np.ascontiguousarray(C)), _ptr(np.ascontiguousarray(F)), _ptr(X),
        nw, _ptr(log))
    assert steps == 2 * n * nw
    want = []
    for f in range(nw):
        Z = C[0] - w[f] ** 2 * M[0, :, :, f] + 1j * w[f] * B[0, :, :, f]
        A = np.block([[Z.real, -Z.imag], [Z.imag, Z.real]])
        A = A / np.maximum(np.max(np.abs(A), axis=1, keepdims=True), 1e-300)
        for kk in range(2 * n):
            p = kk + int(np.argmax(np.abs(A[kk:, kk])))
            want.append(p)
            A[[kk, p]] = A[[p, kk]]
            A[kk] = A[kk] / A[kk, kk]
            for i in range(2 * n):
                if i != kk:
                    A[i] = A[i] - A[i, kk] * A[kk]
    assert want[0] == 0 and want[2 * n] == 0    # ties: the first row
    assert log.tolist() == want


@pytest.mark.parametrize("width", [0, 1, 2])
def test_impedance_nan_lane_matches_plain(lib, width):
    """A NaN in M at one lane: that lane's X is NaN in full on both sides
    (its row's scale is NaN and the NaN row wins the first pivot), every
    other lane agrees, and under the ladder the NaN lane promotes."""
    n, nb, nw = 6, 2, 9
    w, M, B, C, F = _imp_inputs(np.random.default_rng(41), n, nb, nw)
    M[1, 2, 4, 5] = np.nan
    kw = {} if width == 0 else dict(
        refine=2, precision="mixed", factor_dtype=_WIDTHS[width],
        promote_tol=1e-9, return_stats=True)
    out = _imp_body(lib, w, M, B, C, F, refine=kw.get("refine", 1),
                    width=width)
    X = out if width == 0 else out[0]
    Xp = _imp_plain(w, M, B, C, F, **kw)
    if width:
        Xp, st = Xp
        assert out[2] == int(st["promoted"]) >= 1
        assert np.isnan(out[1][1 * nw + 5])
    bad = np.isnan(Xp)
    assert bad[1, :, 5].all() and bad.sum() == n
    np.testing.assert_array_equal(np.isnan(X), bad)
    assert _rel(np.where(bad, 0, X), np.where(bad, 0, Xp)) < (
        1e-7 if width == 2 else TOL)


def test_impedance_lane_f32_matches_plain(lib):
    """K1's float32 instantiation against the plain float32 solve."""
    w, M, B, C, F = _imp_inputs(np.random.default_rng(43), 6, 2, 12)
    f32 = [np.ascontiguousarray(a.astype(np.float32)) for a in (w, M, B, C)]
    Fc = np.ascontiguousarray(F.astype(np.complex64))
    X = np.zeros(Fc.shape, np.complex64)
    lib.host_impedance_f32(*(_ptr(a) for a in f32), _ptr(Fc), _ptr(X), 2, 12,
                           1)
    Xp = impedance_gj_solve_plain(*(torch.tensor(a) for a in f32),
                                  torch.tensor(Fc)).numpy()
    assert Xp.dtype == np.complex64
    assert _rel(X, Xp) < 1e-4


# ---------------------------------------------------------------------------
# the mixed ladder (K3/K4) and the float32 instantiation
# ---------------------------------------------------------------------------

#: elimination width of the host library -> torch dtype of the plain one
_WIDTHS = {1: torch.float32, 2: torch.bfloat16}


def _ill(rng, A, lanes, cond=1e9):
    """SVD-condition the first ``lanes`` systems to ``cond``: the f32 rung
    cannot refine these below the default tolerance, so they promote."""
    n = A.shape[-1]
    for i in range(lanes):
        U, _, Vt = np.linalg.svd(A[i])
        A[i] = (U * np.geomspace(1.0, 1.0 / cond, n)) @ Vt
    return A


def test_round_bf16_matches_torch(lib):
    """The bf16 rung's rounding is torch's (round to nearest even)."""
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.standard_normal(500) * 10.0 ** rng.uniform(
        -30, 30, 500), [0.0, -0.0, 1.0, 3.0e38, -3.4e38, np.inf, -np.inf]])
    v = v.astype(np.float32)
    body = np.array([lib.host_round_bf16(float(x)) for x in v], np.float32)
    ref = torch.tensor(v).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(body, ref)
    assert np.isnan(lib.host_round_bf16(float("nan")))


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("case", ["random", "pivoting", "row_scales",
                                  "svd_ill"])
@pytest.mark.parametrize("nk", [(12, 6), (12, 1), (8, 1)])
def test_gj_lane_mixed_matches_plain(lib, width, case, nk):
    """K4's lane arithmetic: X at f64 level and the promoted count exact
    against the plain ladder, on each stressor."""
    n, k = nk
    rng = np.random.default_rng(17)
    lanes = 40
    if case == "pivoting":
        A = _pivot_stack(rng, lanes, n)
    elif case == "row_scales":
        A = (0.1 * rng.standard_normal((lanes, n, n)) + np.eye(n)) \
            * 10.0 ** rng.uniform(3, 10, (lanes, n, 1))
    else:
        A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
        if case == "svd_ill":
            A = _ill(rng, A, 9)
    b = rng.standard_normal((lanes, n, k)) * 1e3
    x_body, rn_body, promoted = _gj_body(lib, A, b, refine=2, width=width)
    x_plain, st = gj_solve_plain(torch.tensor(A), torch.tensor(b), refine=2,
                                 precision="mixed",
                                 factor_dtype=_WIDTHS[width],
                                 promote_tol=1e-9, return_stats=True)
    assert promoted == int(st["promoted"])
    x_plain = x_plain.numpy()
    tol = 1e-10 if width == 1 else 1e-7
    if case == "svd_ill":
        assert promoted >= 9
        # the promoted cond-1e9 lanes are solved at f64 by both, with
        # real vs arithmetic row swaps: they agree to cond * eps, not 1e-10
        assert _rel(x_body[:9], x_plain[:9]) < 1e9 * 2.2e-16 * 10
        x_body, x_plain = x_body[9:], x_plain[9:]
    assert _rel(x_body, x_plain) < tol
    # the promotion decision rests on rn: both sides agree on which side
    # of the tolerance every lane falls
    np.testing.assert_array_equal(~(rn_body <= 1e-9),
                                  ~(st["rn"].numpy() <= 1e-9))


@pytest.mark.parametrize("n", [6, 1, 2, 3, 7, 8])
@pytest.mark.parametrize("width", [1, 2])
def test_impedance_lane_mixed_matches_plain(lib, width, n):
    """K3's group body against the plain ladder, with one case made
    near-singular so its lanes promote (for n = 1 no case can be: the
    embedding of a 1 x 1 complex Z is a scaled rotation, cond 1)."""
    rng = np.random.default_rng(23)
    nb, nw = 3, 17
    w, M, B, C, F = _imp_inputs(rng, n, nb, nw)
    # case 1: Z = C with cond(C) = 1e9 at every bin -> all its lanes
    # promote
    M[1] = 0.0
    B[1] = 0.0
    C[1] = _ill(rng, C[1:2].copy(), 1)[0]
    X, rn, promoted = _imp_body(lib, w, M, B, C, F, refine=2, width=width)
    X_plain, st = _imp_plain(w, M, B, C, F, refine=2, precision="mixed",
                             factor_dtype=_WIDTHS[width], promote_tol=1e-9,
                             return_stats=True)
    assert promoted == int(st["promoted"])
    assert n == 1 or promoted >= nw
    np.testing.assert_array_equal(~(rn <= 1e-9), ~(st["rn"].numpy() <= 1e-9))
    # the promoted cond-1e9 case agrees to cond * eps (positions swapped vs
    # arithmetic row swaps), the others at the ladder's accuracy
    assert _rel(X[1], X_plain[1]) < 1e9 * 2.2e-16 * 10
    assert _rel(X[[0, 2]], X_plain[[0, 2]]) < (1e-10 if width == 1 else 1e-7)


def test_gj_lane_f32_matches_plain(lib):
    """K2's float32 instantiation against the plain float32 solve."""
    rng = np.random.default_rng(29)
    lanes, n, k = 33, 12, 6
    A = (rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((lanes, n, k)).astype(np.float32)
    x = np.zeros((lanes, n, k), np.float32)
    lib.host_gj_f32(_ptr(A), _ptr(b), _ptr(x), lanes, 1)
    x_plain = gj_solve_plain(torch.tensor(A), torch.tensor(b)).numpy()
    assert x_plain.dtype == np.float32
    assert _rel(x, x_plain) < 1e-4


# ---------------------------------------------------------------------------
# K2/K4's group body at every instantiated size
# ---------------------------------------------------------------------------

#: every (n, k) the K2/K4 kernels instantiate: even n <= 16, k = 1 and n/2
GJ_NK = sorted({(n, k) for n in range(2, 17, 2) for k in (1, n // 2)})


def _gj_plain(A, b, width=0, refine=None):
    """The plain version's x (and its stats under the ladder)."""
    if width == 0:
        return gj_solve_plain(torch.tensor(A), torch.tensor(b),
                              refine=refine or 1).numpy()
    x, st = gj_solve_plain(torch.tensor(A), torch.tensor(b),
                           refine=refine or 2, precision="mixed",
                           factor_dtype=_WIDTHS[width], promote_tol=1e-9,
                           return_stats=True)
    return x.numpy(), st


@pytest.mark.parametrize("n,k", GJ_NK)
def test_gj_group_every_n_matches_plain(lib, n, k):
    """K2's group body at every instantiated (n, k) against the plain
    version: 21 systems (a ragged last tile of 8), random and pivoting
    ones."""
    rng = np.random.default_rng(50 + n + k)
    lanes = 21
    A = np.concatenate([rng.standard_normal((11, n, n)) + 4.0 * np.eye(n),
                        _pivot_stack(rng, lanes - 11, n)])
    b = rng.standard_normal((lanes, n, k)) * 1e3
    x = _gj_body(lib, A, b)
    assert _rel(x, _gj_plain(A, b)) < TOL


@pytest.mark.parametrize("n,k", GJ_NK)
@pytest.mark.parametrize("width", [1, 2])
def test_gj_group_every_n_mixed_matches_plain(lib, width, n, k):
    """K4's group body at every instantiated (n, k): 21 systems, every
    fourth conditioned to 1e9 so that it promotes among lanes that do not;
    the promoted count and which side of the tolerance each lane's
    residual falls equal the plain ladder's."""
    rng = np.random.default_rng(60 + n + k)
    lanes = 21
    A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
    ill = np.arange(0, lanes, 4)
    A[ill] = _ill(rng, A[ill].copy(), len(ill))
    b = rng.standard_normal((lanes, n, k)) * 1e3
    x, rn, promoted = _gj_body(lib, A, b, refine=2, width=width)
    xp, st = _gj_plain(A, b, width)
    assert promoted == int(st["promoted"]) >= len(ill)
    np.testing.assert_array_equal(~(rn <= 1e-9), ~(st["rn"].numpy() <= 1e-9))
    well = np.setdiff1d(np.arange(lanes), ill)
    assert _rel(x[ill], xp[ill]) < 1e9 * 2.2e-16 * 10
    assert _rel(x[well], xp[well]) < (1e-10 if width == 1 else 1e-7)


def _gj_tie(rng, lanes, n):
    """Systems whose every row has |A[i, 0]| = 4 as its largest entry:
    after equilibration the first pivot column ties exactly at magnitude 1
    over all n rows (signs alternate)."""
    A = rng.uniform(-1.0, 1.0, (lanes, n, n))
    A[:, :, 0] = 4.0 * (-1.0) ** np.arange(n)
    return A


@pytest.mark.parametrize("n,k", [(2, 1), (6, 3), (12, 6), (16, 8)])
@pytest.mark.parametrize("width", [0, 1, 2])
def test_gj_tie_lanes_match_plain(lib, width, n, k):
    """Systems whose first pivot column ties exactly on every row: the
    first maximal row wins on both sides, x and the promoted count
    agree."""
    rng = np.random.default_rng(70 + n)
    A = _gj_tie(rng, 19, n)
    b = rng.standard_normal((19, n, k))
    if width == 0:
        assert _rel(_gj_body(lib, A, b), _gj_plain(A, b)) < TOL
        return
    x, _, promoted = _gj_body(lib, A, b, refine=2, width=width)
    xp, st = _gj_plain(A, b, width)
    assert promoted == int(st["promoted"])
    # the promoted lanes are solved at f64 on both sides
    assert _rel(x, xp) < (1e-10 if width == 1 else 1e-7)


def test_gj_pivots_first_maximal_row(lib):
    """The pivot position each elimination step of K2's group body took
    (n = 12, k = 6), against a scan that takes the first maximal row
    (numpy's argmax) of the same equilibrated system: on the tie lanes
    the first of the tied rows."""
    rng = np.random.default_rng(73)
    n, k, lanes = 12, 6, 3
    A = _gj_tie(rng, lanes, n)
    b = rng.standard_normal((lanes, n, k))
    x = np.zeros((lanes, n, k))
    log = np.zeros(n * lanes, dtype=np.int32)
    steps = lib.host_gj_pivots(_ptr(A), _ptr(b), _ptr(x), lanes, _ptr(log))
    assert steps == n * lanes
    want = []
    for lane in range(lanes):
        a = A[lane] / np.maximum(np.max(np.abs(A[lane]), axis=1,
                                        keepdims=True), 1e-300)
        for kk in range(n):
            p = kk + int(np.argmax(np.abs(a[kk:, kk])))
            want.append(p)
            a[[kk, p]] = a[[p, kk]]
            a[kk] = a[kk] / a[kk, kk]
            for i in range(n):
                if i != kk:
                    a[i] = a[i] - a[i, kk] * a[kk]
    assert want[0] == 0 and want[n] == 0    # ties: the first row
    assert log.tolist() == want


@pytest.mark.parametrize("width", [0, 1, 2])
def test_gj_nan_lane_matches_plain(lib, width):
    """A NaN in A at one system: its x is NaN in full on both sides (its
    row's scale is NaN and the NaN row wins the first pivot), every other
    system agrees, and under the ladder the NaN system promotes."""
    n, k, lanes = 12, 6, 13
    rng = np.random.default_rng(79)
    A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
    A[9, 4, 7] = np.nan
    b = rng.standard_normal((lanes, n, k))
    out = _gj_body(lib, A, b, refine=2 if width else 1, width=width)
    x = out if width == 0 else out[0]
    xp = _gj_plain(A, b, width)
    if width:
        xp, st = xp
        assert out[2] == int(st["promoted"]) >= 1
        assert np.isnan(out[1][9])
    bad = np.isnan(xp)
    assert bad[9].all() and bad.sum() == n * k
    np.testing.assert_array_equal(np.isnan(x), bad)
    assert _rel(np.where(bad, 0, x), np.where(bad, 0, xp)) < (
        1e-7 if width == 2 else TOL)



# ---------------------------------------------------------------------------
# K5: the QTF pair grid (csrc/qtf_pair.cuh)
# ---------------------------------------------------------------------------

#: the node sum runs in another order than the plain version's
QTF_TOL = 1e-12

_QTF_HOST_SRC = r"""
#include <vector>
#include "qtf_pair.cuh"
// The three K5 kernels in order, as the card runs them: the record pass
// over (frequency, submerged node), and over the pairs for their
// constants and own terms; the pair pass block by block (tile of kT x kT
// pairs, share of `per` nodes), each node staged into a block's
// shared-memory layout by the kernel's own granule map and added to every
// pair of the tile in node order, parts A and B apart, then A + B; the
// pairs' own terms and the finishing pass, their lanes' sums met in the
// shuffle tree's order.
extern "C" void host_qtf(const double* w, const double* k, const double* Xi,
    const double* F1st, const double* u, const double* dr, const double* nv,
    const double* nax, const double* gu, const double* gp, const double* q,
    const double* off, const double* pos, const double* Minert,
    const double* CaMat, const double* ptMat, const double* qMat,
    const double* nsc, const double* wlc, const double* wleta,
    const double* wlmats, const double* wlgeo, const int* sub, int nsub,
    int per, double* Q, int nw2, int N, int nm, double beta, double h,
    double rho, double g) {
  using namespace qtf;
  Fields a;
  a.nw2 = nw2; a.N = N; a.nm = nm; a.nsub = nsub; a.cosb = cos(beta);
  a.sinb = sin(beta); a.h = h; a.rho = rho; a.g = g; a.w = w; a.k = k;
  a.Xi = (const cd*)Xi; a.F1st = (const cd*)F1st; a.u = (const cd*)u;
  a.dr = (const cd*)dr; a.nv = (const cd*)nv; a.nax = (const cd*)nax;
  a.gu = (const cd*)gu; a.gp = (const cd*)gp; a.q = q; a.off = off;
  a.pos = pos; a.Minert = Minert; a.CaMat = CaMat; a.ptMat = ptMat;
  a.qMat = qMat; a.nsc = nsc; a.wlc = (const cd*)wlc;
  a.wleta = (const cd*)wleta; a.wlmats = wlmats; a.wlgeo = wlgeo;
  a.sub = sub;
  const int npair = nw2 * nw2;
  const int splits = nsub > 0 ? (nsub + per - 1) / per : 0;
  std::vector<cd> scr(scratch_len(nw2, nsub, splits));
  for (int j = 0; j < nsub; ++j)
    for (int f = 0; f < nw2; ++f) {
      record_fill(a, f, j, scr.data() + record_offset(j, 0, f, nw2), nw2);
      if (f == 0)
        node_fill(a, j, (double*)(scr.data() + node_offset(j, nw2, nsub)));
    }
  double* consts = (double*)(scr.data() + consts_offset(nw2, nsub));
  for (int t = 0; t < npair; ++t) {
    double c[kPairConsts];
    pair_consts(a, t / nw2, t % nw2, c);
    for (int i = 0; i < kPairConsts; ++i) consts[(size_t)i * npair + t] = c[i];
  }
  double* part = (double*)(scr.data() + part_offset(nw2, nsub));
  std::vector<cd> st(kStage);
  std::vector<double> accA(kPairThreads * 12), accB(kPairThreads * 12);
  std::vector<Pair> P(kPairThreads);
  const int ntc = (nw2 + kT - 1) / kT;
  for (int bx = 0; bx < ntc * ntc; ++bx)
    for (int s = 0; s < splits; ++s) {
      const int r0 = (bx / ntc) * kT, c0 = (bx % ntc) * kT;
      for (int th = 0; th < kPairThreads; ++th) {
        int i1 = r0 + th / kT, i2 = c0 + th % kT;
        i1 = i1 < nw2 ? i1 : nw2 - 1;
        i2 = i2 < nw2 ? i2 : nw2 - 1;
        P[th] = pair_from(consts + i1 * nw2 + i2, npair, w[i1], w[i2]);
        for (int c = 0; c < 12; ++c)
          accA[th * 12 + c] = accB[th * 12 + c] = 0.0;
      }
      const int j0 = s * per, j1 = j0 + per < nsub ? j0 + per : nsub;
      for (int j = j0; j < j1; ++j) {
        for (int idx = 0; idx < kGranules; ++idx) {
          int src, step;
          stage_granule(idx, r0, c0, nw2, nsub, &src, &step);
          st[idx] = scr[src + (size_t)j * step];
        }
        const double* nr = (const double*)(st.data() + kRec * kSlots);
        for (int th = 0; th < kPairThreads; ++th) {
          const cd* R1 = st.data() + th / kT;
          const cd* R2 = st.data() + kT + th % kT;
          node_pair_a<kSlots>(R1, R2, nr, P[th], &accA[th * 12], 1);
          node_pair_b<kSlots>(R1, R2, nr, -rho, &accB[th * 12], 1);
        }
      }
      for (int th = 0; th < kPairThreads; ++th) {
        const int i1 = r0 + th / kT, i2 = c0 + th % kT;
        if (i1 >= nw2 || i2 >= nw2) continue;
        for (int c = 0; c < 12; ++c)
          part[((size_t)s * npair + (size_t)i1 * nw2 + i2) * 12 + c] =
              accA[th * 12 + c] + accB[th * 12 + c];
      }
    }
  double* terms = (double*)(scr.data() + terms_offset(nw2, nsub));
  for (int t = 0; t < npair; ++t) {
    double v[kLanes][12] = {};
    for (int l = 0; l < kLanes; ++l)
      pair_terms_lane(a, t / nw2, t % nw2, l, v[l]);
    lane_tree(v, 12);
    for (int c = 0; c < 12; ++c) terms[(size_t)t * 12 + c] = v[0][c];
  }
  for (int t = 0; t < npair; ++t) {
    double v[kLanes][12] = {};
    for (int l = 0; l < kLanes; ++l)
      for (int s = l; s < splits; s += kLanes)
        for (int c = 0; c < 12; ++c)
          v[l][c] += part[((size_t)s * npair + t) * 12 + c];
    lane_tree(v, 12);
    finish_write(terms + (size_t)t * 12, v[0], (cd*)Q + (size_t)t * 6);
  }
}
"""


@pytest.fixture(scope="module")
def qtf_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available to compile the kernel body")
    d = tmp_path_factory.mktemp("qtf_body")
    src = d / "host_qtf.cpp"
    src.write_text(_QTF_HOST_SRC)
    so = d / "libhost_qtf.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", CSRC,
                    "-o", str(so), str(src)], check=True)
    L = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    L.host_qtf.argtypes = [P] * 23 + [I, I, P, I, I, I, D, D, D, D]
    return L


def _qtf_body(lib, fields, beta, h, rho, g):
    from raft_tpu_torch.ops.kernels import qtf_pair as K

    ops, (nw2, N, nm) = K.kernel_operands(fields)
    sub, nsub = K.submerged(fields)
    ptrs = [None if ops.get(name) is None else K._ptr(ops[name])
            for name in K.OPERAND_ORDER]
    Q = torch.zeros((nw2, nw2, 6), dtype=torch.complex128)
    lib.host_qtf(*ptrs, sub.data_ptr(), nsub, K.node_split(nw2, nsub),
                 torch.view_as_real(Q).data_ptr(), nw2, N, nm, float(beta),
                 float(h), float(rho), float(g))
    return Q


@pytest.mark.parametrize("rB_z,beta,motion", [
    (10.0, 0.0, True), (-5.0, 0.0, True), (10.0, 0.0, False),
    (10.0, 0.35, True)], ids=["waterline", "no_waterline", "no_motion",
                              "beta_035"])
def test_qtf_body_matches_plain_spar(qtf_lib, rB_z, beta, motion):
    from raft_tpu_torch.ops.kernels.qtf_pair import qtf_pair_grid_plain

    f, _, _, fields = QC.case_fields(QC.spar_design(rB_z), QC.SPAR_W, beta,
                                     motion=motion)
    ref = qtf_pair_grid_plain(fields, beta, f.depth, f.rho_water, f.g)
    got = _qtf_body(qtf_lib, fields, beta, f.depth, f.rho_water, f.g)
    assert _rel(got.numpy(), ref.numpy()) <= QTF_TOL


def test_qtf_body_skips_dry_nodes_the_plain_version_masks(qtf_lib):
    """The body skips the nodes above water, where the plain version
    multiplies the wrench by 0: with finite fields (which ``qtf_fields``
    checks) no value of theirs reaches either result."""
    from raft_tpu_torch.ops.kernels.qtf_pair import (NODE_FIELDS,
                                                     qtf_pair_grid_plain)

    f, _, _, fields = QC.case_fields(QC.spar_design(10.0), QC.SPAR_W, 0.35)
    dry = fields["nodescal"][:, 3] == 0.0
    assert 0 < int(dry.sum()) < int(dry.numel())
    g = torch.Generator().manual_seed(11)
    noisy = dict(fields)
    for name in NODE_FIELDS:
        if name in ("nodescal", "pos"):
            continue
        t = fields[name].clone()
        t[dry] = 1e3 * torch.randn(t[dry].shape, generator=g,
                                   dtype=t.dtype)
        noisy[name] = t
    args = (0.35, f.depth, f.rho_water, f.g)
    assert torch.equal(qtf_pair_grid_plain(noisy, *args),
                       qtf_pair_grid_plain(fields, *args))
    assert torch.equal(_qtf_body(qtf_lib, noisy, *args),
                       _qtf_body(qtf_lib, fields, *args))


@pytest.mark.parametrize("beta", [0.0, 0.35])
def test_qtf_body_matches_plain_oc4semi(qtf_lib, beta):
    """The example's shapes: nw2 = 30, N = 177 nodes, nm = 7 waterline
    members, at an offset pose (submerged-node count changes)."""
    from raft_tpu_torch.ops.kernels.qtf_pair import qtf_pair_grid_plain

    f, _, _, fields = QC.case_fields(QC.oc4semi_design(), QC.OC4SEMI_W, beta,
                                     pose=QC.OFFSET_POSE)
    assert fields["q"].shape[0] == 177 and fields["wl"]["geo"].shape[0] == 7
    ref = qtf_pair_grid_plain(fields, beta, f.depth, f.rho_water, f.g)
    got = _qtf_body(qtf_lib, fields, beta, f.depth, f.rho_water, f.g)
    assert got.shape == (30, 30, 6)
    assert _rel(got.numpy(), ref.numpy()) <= QTF_TOL


def test_qtf_body_matches_plain_oc4semi_80(qtf_lib):
    """The design's own resolution, nw2 = 80 (0.005-0.40 Hz): 25 full
    tiles and the node split of that grid (17 of the 82 submerged nodes
    a block, the last block 14)."""
    from raft_tpu_torch.ops.kernels.qtf_pair import (node_split,
                                                     qtf_pair_grid_plain)

    f, _, _, fields = QC.case_fields(QC.oc4semi_design(0.40), QC.OC4SEMI_W,
                                     0.0, pose=QC.OFFSET_POSE)
    assert fields["w2"].shape[0] == 80 and fields["nsub"] == 82
    assert node_split(80, 82) == 17
    ref = qtf_pair_grid_plain(fields, 0.0, f.depth, f.rho_water, f.g)
    got = _qtf_body(qtf_lib, fields, 0.0, f.depth, f.rho_water, f.g)
    assert _rel(got.numpy(), ref.numpy()) <= QTF_TOL


@pytest.mark.parametrize("nw2,nsub", [(5, 5), (8, 20), (30, 80), (30, 82),
                                      (80, 82), (200, 177), (1, 0)])
def test_qtf_node_split_fills_the_card(nw2, nsub):
    """The pair pass's node split: every submerged node in exactly one
    share, no empty share, and the least waves of blocks (one block on
    each of 132 SMs a wave) times the nodes a block walks plus 2."""
    from raft_tpu_torch.ops.kernels.qtf_pair import (PAIR_TILE,
                                                     TARGET_BLOCKS,
                                                     node_split)

    per = node_split(nw2, nsub)
    splits = -(-nsub // per)
    assert per >= 1 and (nsub == 0 or (splits - 1) * per < nsub <= splits
                         * per)
    tiles = (-(-nw2 // PAIR_TILE)) ** 2

    def cost(p):
        return -(-tiles * -(-nsub // p) // TARGET_BLOCKS) * (p + 2)

    assert cost(per) == min(cost(p) for p in range(1, max(nsub, 1) + 1))
