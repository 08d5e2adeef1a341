"""Parity of the port's ops library with ``raft_tpu.ops`` on random inputs.

Transforms, frustum geometry, spectra, first-order wave kinematics and
the Struve-Bessel differences: the same inputs (numpy, from a seeded
generator) through the JAX function and its PyTorch counterpart, float64,
relative 1e-12 (normwise over each output).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops import geometry as JG
from raft_tpu.ops import special as JS
from raft_tpu.ops import spectra as JP
from raft_tpu.ops import transforms as JT
from raft_tpu.ops import waves as JW

from raft_tpu_torch.ops import geometry as TG
from raft_tpu_torch.ops import special as TS
from raft_tpu_torch.ops import spectra as TP
from raft_tpu_torch.ops import transforms as TT
from raft_tpu_torch.ops import waves as TW

TOL = 1e-12


def _close(t, j, tol=TOL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    scale = max(float(np.max(np.abs(j))), 1e-300)
    assert float(np.max(np.abs(t - j))) / scale < tol


def _T(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["skew", "vec_vec_trans", "rotation_matrix",
                                  "translate_force_3to6", "transform_force",
                                  "translate_matrix_3to6",
                                  "translate_matrix_6to6", "rotate_matrix_3",
                                  "rotate_matrix_6", "small_rotate",
                                  "rot_frm_2_vect"])
def test_transforms(rng, name):
    r = rng.standard_normal((5, 3))
    F = rng.standard_normal((5, 3))
    M3 = rng.standard_normal((5, 3, 3))
    M6 = rng.standard_normal((5, 6, 6))
    ang = rng.uniform(-0.5, 0.5, (3, 5))
    R = np.asarray(JT.rotation_matrix(*ang))
    if name == "skew":
        _close(TT.skew(_T(r)), JT.skew(r))
    elif name == "vec_vec_trans":
        _close(TT.vec_vec_trans(_T(r)), JT.vec_vec_trans(r))
    elif name == "rotation_matrix":
        _close(TT.rotation_matrix(*(_T(a) for a in ang)), R)
    elif name == "translate_force_3to6":
        _close(TT.translate_force_3to6(_T(F), _T(r)),
               JT.translate_force_3to6(F, r))
    elif name == "transform_force":
        f6 = rng.standard_normal((5, 6))
        _close(TT.transform_force(_T(f6), offset=_T(r), rotmat=_T(R)),
               JT.transform_force(f6, offset=r, rotmat=R))
        fc = f6 + 1j * rng.standard_normal((5, 6))
        _close(TT.transform_force(_T(fc), offset=_T(r)),
               JT.transform_force(fc, offset=r))
    elif name == "translate_matrix_3to6":
        _close(TT.translate_matrix_3to6(_T(M3), _T(r)),
               JT.translate_matrix_3to6(M3, r))
    elif name == "translate_matrix_6to6":
        _close(TT.translate_matrix_6to6(_T(M6), _T(r)),
               JT.translate_matrix_6to6(M6, r))
    elif name == "rotate_matrix_3":
        _close(TT.rotate_matrix_3(_T(M3), _T(R)), JT.rotate_matrix_3(M3, R))
    elif name == "rotate_matrix_6":
        _close(TT.rotate_matrix_6(_T(M6), _T(R)), JT.rotate_matrix_6(M6, R))
    elif name == "small_rotate":
        th = rng.standard_normal((5, 3)) + 1j * rng.standard_normal((5, 3))
        _close(TT.small_rotate(_T(r), _T(th)), JT.small_rotate(r, th))
    elif name == "rot_frm_2_vect":
        B = rng.standard_normal((5, 3))
        B[0] = r[0]              # parallel pair -> identity branch
        _close(TT.rot_frm_2_vect(r, B), JT.rot_frm_2_vect(r, B))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_frustum_circ(rng):
    dA = rng.uniform(1, 10, 20)
    dB = rng.uniform(1, 10, 20)
    dB[:4] = dA[:4]                                  # cylinders
    H = rng.uniform(0, 20, 20)
    H[0] = 0.0
    for a, b in zip(TG.frustum_vcv_circ(_T(dA), _T(dB), _T(H)),
                    JG.frustum_vcv_circ(dA, dB, H)):
        _close(a, b)
    for a, b in zip(TG.frustum_moi_circ(_T(dA), _T(dB), _T(H), 7850.0),
                    JG.frustum_moi_circ(dA, dB, H, 7850.0)):
        _close(a, b)


def test_frustum_rect(rng):
    slA = rng.uniform(1, 10, (8, 2))
    slB = rng.uniform(1, 10, (8, 2))
    H = rng.uniform(0.5, 20, 8)
    for a, b in zip(TG.frustum_vcv_rect(_T(slA), _T(slB), _T(H)),
                    JG.frustum_vcv_rect(slA, slB, H)):
        _close(a, b)
    # a scalar density, and one density per section for a one-section
    # member — the shapes the JAX function broadcasts correctly (for
    # several sections its per-section density array broadcasts against
    # the quadrature axis instead; the port pairs it with the sections)
    for a, b in zip(TG.frustum_moi_rect(_T(slA), _T(slB), _T(H), 7850.0),
                    JG.frustum_moi_rect(slA, slB, H, 7850.0)):
        _close(a, b)
    rho = rng.uniform(1000, 8000, 1)
    for a, b in zip(TG.frustum_moi_rect(_T(slA[:1]), _T(slB[:1]), _T(H[:1]),
                                        _T(rho)),
                    JG.frustum_moi_rect(slA[:1], slB[:1], H[:1], rho)):
        _close(a, b)


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Hs,Tp,gamma", [(2.0, 8.0, None), (6.0, 10.0, 3.3),
                                         (8.5, 13.1, None), (1.0, 3.0, None)])
def test_jonswap(Hs, Tp, gamma):
    ws = np.arange(0.005, 0.4025, 0.005) * 2 * np.pi
    _close(TP.jonswap(ws, Hs, Tp, gamma=gamma),
           JP.jonswap(ws, Hs, Tp, gamma=gamma))


def test_rms_psd_rao(rng):
    xi = rng.standard_normal((3, 6, 40)) + 1j * rng.standard_normal((3, 6, 40))
    _close(TP.get_rms(_T(xi)), JP.get_rms(xi))
    _close(TP.get_rms(_T(xi), axis=(0, 2)), JP.get_rms(xi, axis=(0, 2)))
    _close(TP.get_psd(_T(xi), 0.03, source_axis=0),
           JP.get_psd(xi, 0.03, source_axis=0))
    zeta = rng.uniform(0, 2, 40)
    zeta[:5] = 0.0                                   # zero-amplitude guard
    _close(TP.get_rao(_T(xi[0]), zeta), JP.get_rao(xi[0], zeta))


# ---------------------------------------------------------------------------
# waves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [320.0, 200.0, 15.0])
def test_wave_number(depth):
    w = np.concatenate([[0.0], np.arange(0.02, 3.0, 0.037)])
    _close(TW.wave_number(w, depth), JW.wave_number(w, depth))


@pytest.mark.parametrize("beta", [0.0, 0.6])
def test_wave_kinematics(rng, beta):
    depth = 200.0
    w = np.arange(0.05, 2.0, 0.05)
    k = np.asarray(JW.wave_number(w, depth))
    zeta = rng.standard_normal(w.size) + 1j * rng.standard_normal(w.size)
    r = rng.uniform(-50, 50, (30, 3))
    r[:, 2] = rng.uniform(-150, 10, 30)              # some nodes dry
    r[0, 2] = 0.0
    for a, b in zip(TW.wave_kinematics(zeta, beta, w, k, depth, r),
                    JW.wave_kinematics(jnp.asarray(zeta), beta, w, k, depth,
                                       r)):
        _close(a, b)


def test_kinematics_from_motion(rng):
    w = np.arange(0.05, 2.0, 0.05)
    Xi = rng.standard_normal((6, w.size)) + 1j * rng.standard_normal((6, w.size))
    r = rng.standard_normal((12, 3))
    for a, b in zip(TW.kinematics_from_motion(_T(r), _T(Xi), _T(w)),
                    JW.kinematics_from_motion(r, Xi, w)):
        _close(a, b)


# ---------------------------------------------------------------------------
# special
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["struve_bessel_diff_0", "struve_bessel_diff_1",
                                "struve_bessel_diff_m2"])
def test_struve_bessel_differences(fn):
    """Elementwise 1e-12 relative to the larger of the value and the size
    of the terms that cancel into it: on the power-series branch (x < 18)
    L and I each grow like e^x / sqrt(2 pi x) and cancel to an O(1)
    difference, so summation-order rounding (torch.sum vs XLA's reduce)
    scales with the terms, not with the result."""
    x = np.concatenate([[0.0], np.geomspace(1e-3, 17.99, 60),
                        np.geomspace(18.0, 500.0, 30)])
    t = getattr(TS, fn)(x).numpy()
    j = np.asarray(getattr(JS, fn)(x))
    xs = np.where(x > 0, x, 1.0)
    terms = np.where(x < 18.0, np.exp(xs) / np.sqrt(2 * np.pi * xs), 0.0)
    if fn == "struve_bessel_diff_m2":
        # the recurrence D0 - (2/x) D1 - 2/(pi x) cancels terms of size
        # ~4/(pi x) down to O(1/x^3) on the asymptotic branch
        terms = terms * (1.0 + 2.0 / xs) + 4.0 / (np.pi * xs)
    assert np.all(np.abs(t - j) <= 1e-12 * np.maximum(np.abs(j), terms))
