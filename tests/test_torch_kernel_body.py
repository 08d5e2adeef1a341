"""The CUDA kernels' per-lane arithmetic, compiled for the host.

``raft_tpu_torch/csrc/gj_lane.cuh`` holds everything the two Gauss-Jordan
kernels compute per lane as ``__host__ __device__`` functions.  Here it is
compiled with g++ (``__host__``/``__device__`` defined empty) into a small
C library in ``tmp_path``, loaded with ctypes, and held against the
port's plain PyTorch versions — the only check of the kernels' arithmetic
(real row swaps and all) that can run without a card.  The kernels
themselves are checked against the same plain versions on the card by
``chip_smoke.py``.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops.kernels.gj_solve import (
    gj_solve_plain, impedance_gj_solve_plain)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "raft_tpu_torch", "csrc")

#: the kernel's real row swap vs the plain version's arithmetic swap, and
#: sum orders, differ by rounding only
TOL = 1e-10

_HOST_SRC = r"""
#include "gj_lane.cuh"
extern "C" void host_impedance(const double* w, const double* M,
    const double* B, const double* C, const double* F, double* X,
    int nb, int nw, int n, int refine) {
  for (int lane = 0; lane < nb * nw; ++lane) {
    if (n == 6) gjl::impedance_lane<6>(w, M, B, C, F, X, nw, lane, refine);
    else if (n == 3) gjl::impedance_lane<3>(w, M, B, C, F, X, nw, lane, refine);
  }
}
extern "C" void host_gj(const double* A, const double* b, double* x,
    int lanes, int n, int k, int refine) {
  for (int lane = 0; lane < lanes; ++lane) {
    if (n == 12 && k == 6) gjl::gj_lane<12, 6>(A, b, x, lane, refine);
    else if (n == 12 && k == 1) gjl::gj_lane<12, 1>(A, b, x, lane, refine);
    else if (n == 4 && k == 2) gjl::gj_lane<4, 2>(A, b, x, lane, refine);
  }
}
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
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-D__host__=", "-D__device__=", "-I", CSRC,
                    "-o", str(so), str(src)], check=True)
    L = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    L.host_impedance.argtypes = [P, P, P, P, P, P, I, I, I, I]
    L.host_gj.argtypes = [P, P, P, I, I, I, I]
    return L


def _ptr(a):
    return a.ctypes.data


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _gj_body(lib, A, b):
    lanes, n, _ = A.shape
    k = b.shape[-1]
    A = np.ascontiguousarray(A)
    b = np.ascontiguousarray(b)
    x = np.zeros((lanes, n, k))
    lib.host_gj(_ptr(A), _ptr(b), _ptr(x), lanes, n, k, 1)
    return x


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


@pytest.mark.parametrize("n,nb,nw", [(6, 3, 17), (3, 2, 5)])
def test_impedance_lane_matches_plain(lib, n, nb, nw):
    rng = np.random.default_rng(11)
    w = np.linspace(0.1, 2.5, nw)
    M = rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[None, :, :, None]
    B = 0.3 * rng.standard_normal((nb, n, n, nw))
    C = rng.standard_normal((nb, n, n)) + 10.0 * np.eye(n)
    F = rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal((nb, n, nw))
    X = np.zeros((nb, n, nw), dtype=complex)
    Fc = np.ascontiguousarray(F)
    lib.host_impedance(_ptr(w), _ptr(np.ascontiguousarray(M)),
                       _ptr(np.ascontiguousarray(B)),
                       _ptr(np.ascontiguousarray(C)), _ptr(Fc), _ptr(X),
                       nb, nw, n, 1)
    X_plain = impedance_gj_solve_plain(
        torch.tensor(w), torch.tensor(M), torch.tensor(B), torch.tensor(C),
        torch.tensor(F)).numpy()
    assert _rel(X, X_plain) < TOL
