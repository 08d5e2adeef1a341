"""Linear (Airy) wave kinematics as batched tensor ops.

Port of the first-order half of ``raft_tpu/ops/waves.py`` (reference:
raft/helpers.py:66-154, 295-310 — getKinematics, getWaveKin,
waveNumber).  Every function is vectorized over frequency and broadcasts
over node/heading batch axes.  Heading ``beta`` is in radians; z is
positive up with the free surface at z=0 and nodes above it get zeros.
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
