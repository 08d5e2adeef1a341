"""Linear (Airy) wave kinematics and second-order wave terms as batched
tensor ops.

Port of ``raft_tpu/ops/waves.py`` (reference: raft/helpers.py:66-310 —
getKinematics, getWaveKin, getWaveKin_grad_u1, getWaveKin_grad_dudt,
getWaveKin_grad_pres1st, getWaveKin_pot2ndOrd, waveNumber).  Every
function is vectorized over frequency and broadcasts over node/heading
batch axes.  Heading ``beta`` is in radians throughout (the JAX package's
convention, not the reference's mixed degrees/radians); z is positive up
with the free surface at z=0 and nodes above it get zeros.
"""
from __future__ import annotations

import math

import torch

from raft_tpu_torch._config import as_real

_G_DEFAULT = 9.81

# same deep-water switch threshold as the reference (raft/helpers.py:133)
_KH_DEEP = 89.4


def wave_number(w, h, g=_G_DEFAULT, tol=1e-3):
    """Solve the linear dispersion relation w^2 = g k tanh(k h) for k.

    The reference's fixed-point iteration including its per-element early
    stop: each frequency iterates k <- w^2/(g tanh(k h)) from the
    deep-water seed until its relative change drops below ``tol``;
    converged elements are frozen.  A Python loop with one host check per
    sweep.  w (...,) rad/s (w=0 gives k=0); h scalar depth [m]."""
    w = as_real(w)
    w2g = w * w / g
    k1 = w2g
    k2 = w2g / torch.tanh(torch.clamp(k1, min=1e-300) * h)
    done = torch.abs(k2 - k1) / torch.clamp(k1, min=1e-300) <= tol
    while not bool(torch.all(done)):
        k1n = torch.where(done, k1, k2)
        k2n = torch.where(done, k2,
                          w2g / torch.tanh(torch.clamp(k1n, min=1e-300) * h))
        done = done | (torch.abs(k2n - k1n)
                       / torch.clamp(k1n, min=1e-300) <= tol)
        k1, k2 = k1n, k2n
    return torch.where(w == 0.0, 0.0, k2)


def _depth_ratios(k, z, h):
    """(sinh(k(z+h))/sinh(kh), cosh(k(z+h))/sinh(kh), cosh(k(z+h))/cosh(kh))
    with the reference's deep-water switch at k h > 89.4 and its k == 0
    limits.  Shapes broadcast."""
    kh = k * h
    kh_safe = torch.clamp(kh, max=_KH_DEEP)
    kzh = torch.clamp(k * (z + h), max=_KH_DEEP)
    shallow_s = torch.sinh(kzh) / torch.sinh(kh_safe)
    shallow_c = torch.cosh(kzh) / torch.sinh(kh_safe)
    shallow_cc = torch.cosh(kzh) / torch.cosh(kh_safe)
    deep = torch.exp(k * z)
    deep_cc = deep + torch.exp(-k * (z + 2.0 * h))
    use_deep = kh > _KH_DEEP
    s_ratio = torch.where(use_deep, deep, shallow_s)
    c_ratio = torch.where(use_deep, deep, shallow_c)
    cc_ratio = torch.where(use_deep, deep_cc, shallow_cc)
    s_ratio = torch.where(k == 0.0, 1.0, s_ratio)
    c_ratio = torch.where(k == 0.0, 99999.0, c_ratio)
    cc_ratio = torch.where(k == 0.0, 99999.0, cc_ratio)
    return s_ratio, c_ratio, cc_ratio


def wave_kinematics(zeta0, beta, w, k, h, r, rho=1025.0, g=_G_DEFAULT):
    """First-order wave kinematics at point(s) r from an elevation
    spectrum: zeta0 (nw,) complex, beta heading [rad], w/k (nw,), depth h,
    r (..., 3).  Returns (u (...,3,nw), ud (...,3,nw), pDyn (...,nw)).

    A batch of sea states comes with an explicit leading case axis:
    zeta0 (nc, nw) and beta (nc,) tensors give u, ud (nc, ..., 3, nw) and
    pDyn (nc, ..., nw)."""
    r = as_real(r)
    dev = r.device
    w = as_real(w, dev)
    k = as_real(k, dev)
    zeta0 = torch.as_tensor(zeta0, device=dev).to(torch.complex128)
    batch = r.shape[:-1]
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    if isinstance(beta, torch.Tensor):
        beta = beta.to(device=dev, dtype=torch.float64)
        cosb, sinb = torch.cos(beta), torch.sin(beta)
    else:
        cosb, sinb = math.cos(beta), math.sin(beta)
    cases = isinstance(beta, torch.Tensor) and beta.ndim == 1
    if cases:
        # case axis first, broadcast over the point axes and frequency
        pts = (1,) * len(batch)
        cosb = cosb.reshape(cosb.shape + pts)
        sinb = sinb.reshape(sinb.shape + pts)
        zeta0 = zeta0.reshape(zeta0.shape[:1] + pts + zeta0.shape[1:])
    phase = torch.exp(-1j * k * (cosb * x + sinb * y)[..., None])
    zeta = zeta0 * phase
    s_r, c_r, cc_r = _depth_ratios(k, z[..., None], h)
    wet = (z <= 0.0)[..., None]
    cu = cosb[..., None] if cases else cosb
    su = sinb[..., None] if cases else sinb
    u = torch.stack(
        [
            w * zeta * c_r * cu,
            w * zeta * c_r * su,
            1j * w * zeta * s_r,
        ],
        dim=-2,
    )
    u = torch.where(wet[..., None, :], u, 0.0)
    ud = 1j * w * u
    pDyn = torch.where(wet, rho * g * zeta * cc_r, 0.0)
    return u, ud, pDyn


def kinematics_from_motion(r, Xi, w):
    """Node displacement/velocity/acceleration amplitudes from 6-DOF
    platform motion Xi (..., 6, nw) at offset r (..., 3) from the PRP.
    Returns (dr, v, a), each (..., 3, nw)."""
    trans = Xi[..., :3, :]
    rot = Xi[..., 3:, :]
    rx = r[..., :, None]
    disp_rot = torch.stack(
        [
            -rot[..., 2, :] * rx[..., 1, :] + rot[..., 1, :] * rx[..., 2, :],
            rot[..., 2, :] * rx[..., 0, :] - rot[..., 0, :] * rx[..., 2, :],
            -rot[..., 1, :] * rx[..., 0, :] + rot[..., 0, :] * rx[..., 1, :],
        ],
        dim=-2,
    )
    dr = trans + disp_rot
    v = 1j * w * dr
    a = 1j * w * v
    return dr, v, a


def _grad_ratios(k, z, h, denom_sinh=True):
    """Depth ratios of the gradient kernels, with their k*h >= 10
    deep-water switch (reference: raft/helpers.py:168-175, 213-220):
    (cosh(k(z+h))/den, sinh(k(z+h))/den), den = sinh(kh) or cosh(kh)."""
    kh = k * h
    kh_safe = torch.clamp(kh, max=_KH_DEEP)
    kzh = torch.clamp(k * (z + h), max=_KH_DEEP)
    den = torch.sinh(kh_safe) if denom_sinh else torch.cosh(kh_safe)
    deep = torch.exp(k * z)
    use_deep = kh >= 10.0
    return (torch.where(use_deep, deep, torch.cosh(kzh) / den),
            torch.where(use_deep, deep, torch.sinh(kzh) / den))


def _xyz(r):
    r = as_real(r)
    return r, r[..., 0], r[..., 1], r[..., 2]


def wave_vel_gradient(w, k, beta, h, r):
    """Spatial gradient matrix of the first-order wave velocity,
    (..., 3, 3), per unit amplitude (reference: raft/helpers.py:157-195).
    ``beta`` in radians for both the direction factors and the phase; the
    tensor is symmetric (dw/dy = dv/dz in ``grad[2][1]``, not the
    reference's du/dy copy)."""
    r, x, y, z = _xyz(r)
    w, k = as_real(w, r.device), as_real(k, r.device)
    cosB, sinB = math.cos(beta), math.sin(beta)
    khz_xy, khz_z = _grad_ratios(k, z, h, denom_sinh=True)
    phase = torch.exp(-1j * (k * (cosB * x + sinB * y)))
    aux_x = w * cosB * phase
    aux_y = w * sinB * phase
    aux_z = 1j * w * phase
    g00 = -1j * aux_x * khz_xy * k * cosB
    g01 = -1j * aux_x * khz_xy * k * sinB
    g02 = aux_x * k * khz_z
    g11 = -1j * aux_y * khz_xy * k * sinB
    g12 = aux_y * k * khz_z
    g22 = aux_z * k * khz_xy
    grad = torch.stack([
        torch.stack([g00, g01, g02], dim=-1),
        torch.stack([g01, g11, g12], dim=-1),
        torch.stack([g02, g12, g22], dim=-1),
    ], dim=-2)
    active = ((z <= 0.0) & (k > 0.0))[..., None, None]
    return torch.where(active, grad, 0.0)


def wave_acc_gradient(w, k, beta, h, r):
    """Gradient of the first-order wave acceleration (reference:
    raft/helpers.py:198-199), ``beta`` in radians."""
    return 1j * as_real(w) * wave_vel_gradient(w, k, beta, h, r)


def wave_pres1st_gradient(k, beta, h, r, rho=1025.0, g=_G_DEFAULT):
    """Gradient of the first-order dynamic pressure, (..., 3), per unit
    amplitude (reference: raft/helpers.py:202-225), ``beta`` in radians."""
    r, x, y, z = _xyz(r)
    k = as_real(k, r.device)
    cosB, sinB = math.cos(beta), math.sin(beta)
    khz_xy, khz_z = _grad_ratios(k, z, h, denom_sinh=False)
    phase = torch.exp(-1j * (k * (cosB * x + sinB * y)))
    gx = rho * g * khz_xy * phase * (-1j * k * cosB)
    gy = rho * g * khz_xy * phase * (-1j * k * sinB)
    gz = rho * g * khz_z * phase * k
    grad = torch.stack([gx, gy, gz], dim=-1)
    active = ((z <= 0.0) & (k > 0.0))[..., None]
    return torch.where(active, grad, 0.0)


def wave_pot_2nd_order(w1, w2, k1, k2, beta1, beta2, h, r,
                       g=_G_DEFAULT, rho=1025.0):
    """Acceleration and pressure of the difference-frequency second-order
    potential of a bichromatic pair (reference: raft/helpers.py:254-291),
    headings in radians.  w1, w2, k1, k2 broadcast against r (..., 3)'s
    leading axes.  Returns (acc (..., 3), p (...)); zero on the w1 == w2
    diagonal, above water and at k <= 0."""
    r, x, y, z = _xyz(r)
    dev = r.device
    w1, w2, k1, k2 = (as_real(a, dev) for a in (w1, w2, k1, k2))
    dkx = k1 * math.cos(beta1) - k2 * math.cos(beta2)
    dky = k1 * math.sin(beta1) - k2 * math.sin(beta2)
    nk = torch.sqrt(dkx * dkx + dky * dky)
    dw = w1 - w2
    th1, th2, thn = torch.tanh(k1 * h), torch.tanh(k2 * h), torch.tanh(nk * h)
    den12 = dw * dw / g - nk * thn
    den12 = torch.where(den12 == 0.0, 1.0, den12)
    g12 = (-1j * g / (2 * w1)) * ((k1**2) * (1 - th1**2)
                                  - 2 * k1 * k2 * (1 + th1 * th2)) / den12
    g21 = (-1j * g / (2 * w2)) * ((k2**2) * (1 - th2**2)
                                  - 2 * k2 * k1 * (1 + th2 * th1)) / den12
    aux = 0.5 * (g21 + torch.conj(g12))
    nkh = torch.clamp(nk * h, max=_KH_DEEP)
    nkzh = torch.clamp(nk * (z + h), max=_KH_DEEP)
    khz_xy = torch.cosh(nkzh) / torch.cosh(nkh)
    khz_z = torch.sinh(nkzh) / torch.cosh(nkh)
    phase = torch.exp(-1j * (dkx * x + dky * y))
    ax = aux * khz_xy * phase * dw * dkx
    ay = aux * khz_xy * phase * dw * dky
    az = aux * khz_z * phase * 1j * dw * nk
    p = aux * khz_xy * phase * (-1j) * rho * dw
    acc = torch.stack(torch.broadcast_tensors(ax, ay, az), dim=-1)
    active = (z <= 0.0) & (k1 > 0.0) & (k2 > 0.0) & (w1 != w2)
    acc = torch.where(active[..., None], acc, 0.0)
    p = torch.where(active, p, 0.0)
    return acc, p
