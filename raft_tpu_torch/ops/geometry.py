"""Frustum volume/centroid/inertia primitives for member geometry.

Port of ``raft_tpu/ops/geometry.py`` (reference: raft/helpers.py:36-63
FrustumVCV and raft/raft_member.py:321-402 FrustumMOI /
RectangularFrustumMOI).  Elementwise over any batch shape.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch._config import as_real


def _dev(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def frustum_vcv_circ(dA, dB, H):
    """Volume and center-of-volume height (from the dA end) of a circular
    frustum with end diameters dA, dB and height H."""
    dev = _dev(dA, dB, H)
    dA, dB, H = as_real(dA, dev), as_real(dB, dev), as_real(H, dev)
    A1 = (math.pi / 4) * dA**2
    A2 = (math.pi / 4) * dB**2
    Am = (math.pi / 4) * dA * dB
    denom = A1 + Am + A2
    V = denom * H / 3.0
    hc = torch.where(denom > 0, ((A1 + 2 * Am + 3 * A2)
                                 / torch.where(denom > 0, denom, 1.0)) * H / 4.0,
                     0.0)
    return V, hc


def frustum_vcv_rect(slA, slB, H):
    """Rectangular (pyramidal) frustum volume/centroid; slA, slB are
    (...,2) side-length pairs at the two ends."""
    dev = _dev(slA, slB, H)
    slA, slB, H = as_real(slA, dev), as_real(slB, dev), as_real(H, dev)
    A1 = slA[..., 0] * slA[..., 1]
    A2 = slB[..., 0] * slB[..., 1]
    Am = torch.sqrt(A1 * A2)
    denom = A1 + Am + A2
    V = denom * H / 3.0
    hc = torch.where(denom > 0, ((A1 + 2 * Am + 3 * A2)
                                 / torch.where(denom > 0, denom, 1.0)) * H / 4.0,
                     0.0)
    return V, hc


def frustum_moi_circ(dA, dB, H, p):
    """Axial (Izz) and transverse (Ixx=Iyy) moments of inertia of a solid
    circular frustum about the center of its bottom end, density p.
    Returns (Ixx, Izz)."""
    dev = _dev(dA, dB, H, p)
    dA, dB, H = as_real(dA, dev), as_real(dB, dev), as_real(H, dev)
    rA, rB = 0.5 * dA, 0.5 * dB
    # cylinder detection is a relative tolerance (see the JAX module)
    cyl = torch.abs(rB - rA) <= 1e-9 * torch.maximum(torch.abs(rA), torch.abs(rB))
    m = torch.where(H > 0, (rB - rA) / torch.where(H > 0, H, 1.0), 0.0)
    m = torch.where(cyl, 0.0, m)
    m_safe = torch.where(m == 0, 1.0, m)
    Izz_t = (math.pi * p / (10.0 * m_safe)) * (rB**5 - rA**5)
    Ixx_t = math.pi * p * (
        H**3 / 30.0 * (rA**2 + 3.0 * rA * rB + 6.0 * rB**2)
        + 1.0 / 20.0 / m_safe * (rB**5 - rA**5)
    )
    Izz_cyl = 0.5 * math.pi * p * H * rA**4
    Ixx_cyl = math.pi * p * H * (rA**4 / 4.0 + (H**2 * rA**2) / 3.0)
    Izz = torch.where(m == 0, Izz_cyl, Izz_t)
    Ixx = torch.where(m == 0, Ixx_cyl, Ixx_t)
    return Ixx, Izz


def _gl8():
    x, w = np.polynomial.legendre.leggauss(8)
    return (0.5 * (x + 1.0)), (0.5 * w)


_GL8 = _gl8()


def frustum_moi_rect(slA, slB, H, p):
    """Moments of inertia of a solid rectangular frustum about the center
    of its bottom end (8-point Gauss-Legendre, exact for the degree-5
    integrands).  Returns (Ixx, Iyy, Izz)."""
    dev = _dev(slA, slB, H, p)
    slA, slB, H = as_real(slA, dev), as_real(slB, dev), as_real(H, dev)
    xg = as_real(_GL8[0], H.device)
    wg = as_real(_GL8[1], H.device)
    if isinstance(p, torch.Tensor):
        p = p[..., None]
    z = H[..., None] * xg
    t = torch.where(H[..., None] > 0,
                    z / torch.where(H[..., None] > 0, H[..., None], 1.0), 0.0)
    a = slA[..., 0:1] * (1 - t) + slB[..., 0:1] * t
    b = slA[..., 1:2] * (1 - t) + slB[..., 1:2] * t
    w = H[..., None] * wg
    Izz = torch.sum(w * p * (a * b) * (a**2 + b**2) / 12.0, dim=-1)
    Ixx = torch.sum(w * p * ((a * b**3) / 12.0 + a * b * z**2), dim=-1)
    Iyy = torch.sum(w * p * ((b * a**3) / 12.0 + a * b * z**2), dim=-1)
    return Ixx, Iyy, Izz
