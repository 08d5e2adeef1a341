"""Special functions: Struve-minus-Bessel differences and Hankel functions.

Port of ``raft_tpu/ops/special.py``.

- The rotor-averaged Kaimal spectrum (``rotor.kaimal_spectra``; the
  reference uses scipy.special modstruve/iv, raft/raft_rotor.py:1216-1218).
  D_nu(x) = L_nu(x) - I_nu(x) stays O(1) while L and I grow like
  e^x/sqrt(x): D_0 and D_1 come from the power-series difference
  (cumulative-product terms) for small x and the DLMF 11.6.2 asymptotic
  expansion for large x; D_{-2} from the exact recurrence D_{-2} = D_0 -
  (2/x) D_1 - 2/(pi x).
- The MacCamy-Fuchs inertia coefficient and the Kim & Yue correction (the
  reference calls scipy.special.hankel1, raft_member.py:1070-1073,
  1102-1109): H^(1)_n = J_n + i Y_n, float64 only.  J_0, J_1, Y_0 and Y_1
  are the Abramowitz & Stegun 9.4 polynomial approximations (|eps| <
  ~1.6e-8) with the JAX package's coefficients; J_n of every order comes
  from the normalized downward recurrence of
  ``jax.scipy.special.bessel_jn`` (`bessel_jn`, machine precision), Y_n
  from the upward recurrence, clamped at 1e300.  The A&S Y_0/Y_1 are
  kept, not replaced by accurate ones (``torch.special``), so that the
  port computes what the JAX package computes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch._config import as_real

_SERIES_K = 90
_ASYM_K = 10
_SWITCH = 18.0


def _asym_coeffs(nu: float):
    """DLMF 11.6.2: L_nu(z) - I_nu(z) ~ (1/pi) sum_k (-1)^{k+1}
    Gamma(k+1/2)/Gamma(nu+1/2-k) (z/2)^{nu-2k-1}."""
    def gamma_any(x):
        if x > 0:
            return math.gamma(x)
        return math.pi / (math.sin(math.pi * x) * math.gamma(1.0 - x))

    k = np.arange(_ASYM_K)
    c = np.array([(-1.0) ** (kk + 1) * math.gamma(kk + 0.5) / gamma_any(nu + 0.5 - kk)
                  for kk in k]) / math.pi
    p = nu - 2.0 * k - 1.0
    return c, p


_A0_C, _A0_P = _asym_coeffs(0.0)
_A1_C, _A1_P = _asym_coeffs(1.0)


def _series_diff(x, nu: int):
    """L_nu(x) - I_nu(x) by direct summation with cumulative-product
    terms (used for x < _SWITCH)."""
    h = 0.5 * x[..., None]
    h2 = h * h
    k = torch.arange(_SERIES_K, dtype=torch.float64, device=x.device)
    tI0 = h[..., 0] ** nu / math.gamma(nu + 1.0)
    ratios_I = h2 / ((k[:-1] + 1.0) * (k[:-1] + nu + 1.0))
    tI = tI0[..., None] * torch.cat(
        [torch.ones_like(h), torch.cumprod(ratios_I, dim=-1)], dim=-1)
    tL0 = h[..., 0] ** (nu + 1) / (math.gamma(1.5) * math.gamma(nu + 1.5))
    ratios_L = h2 / ((k[:-1] + 1.5) * (k[:-1] + nu + 1.5))
    tL = tL0[..., None] * torch.cat(
        [torch.ones_like(h), torch.cumprod(ratios_L, dim=-1)], dim=-1)
    return torch.sum(tL - tI, dim=-1)


def _eval_asym(x, coeffs, powers):
    h = 0.5 * x[..., None]
    h_safe = torch.where(h > 0, h, 1.0)
    terms = as_real(coeffs, x.device) * torch.exp(
        as_real(powers, x.device) * torch.log(h_safe))
    return torch.sum(terms, dim=-1)


def struve_bessel_diff_0(x):
    """D_0(x) = L_0(x) - I_0(x), elementwise, x >= 0."""
    x = as_real(x)
    out = torch.where(x < _SWITCH,
                      _series_diff(torch.clamp(x, max=_SWITCH), 0),
                      _eval_asym(torch.clamp(x, min=_SWITCH), _A0_C, _A0_P))
    return torch.where(x == 0.0, -1.0, out)


def struve_bessel_diff_1(x):
    """D_1(x) = L_1(x) - I_1(x), elementwise, x >= 0 (-> -2/pi at inf)."""
    x = as_real(x)
    out = torch.where(x < _SWITCH,
                      _series_diff(torch.clamp(x, max=_SWITCH), 1),
                      _eval_asym(torch.clamp(x, min=_SWITCH), _A1_C, _A1_P))
    return torch.where(x == 0.0, 0.0, out)


def struve_bessel_diff_m2(x):
    """L_{-2}(x) - I_2(x), elementwise, x > 0, via the recurrence."""
    x = as_real(x)
    x_safe = torch.where(x > 0, x, 1.0)
    out = (struve_bessel_diff_0(x) - (2.0 / x_safe) * struve_bessel_diff_1(x)
           - 2.0 / (math.pi * x_safe))
    return torch.where(x == 0.0, 0.0, out)


# --------------------------------------------------------------------------
# Bessel Y / Hankel functions (MacCamy-Fuchs + Kim & Yue)
# --------------------------------------------------------------------------

def _poly(t, coeffs):
    out = torch.zeros_like(t) + coeffs[0]
    for c in coeffs[1:]:
        out = out * t + c
    return out


# A&S 9.4.3 / 9.4.6: the modulus and phase of J_0/Y_0 and J_1/Y_1, x > 3
_F0 = [0.00014476, -0.00072805, 0.00137237, -0.00009512, -0.00552740,
       -0.00000077, 0.79788456]
_TH0 = [0.00013558, -0.00029333, -0.00054125, 0.00262573, -0.00003954,
        -0.04166397, -0.78539816]
_F1 = [-0.00020033, 0.00113653, -0.00249511, 0.00017105, 0.01659667,
       0.00000156, 0.79788456]
_TH1 = [-0.00029166, 0.00079824, 0.00074348, -0.00637879, 0.00005650,
        0.12499612, -2.35619449]


def bessel_j0(x):
    """J_0(x) (A&S 9.4.1/9.4.3)."""
    x = torch.abs(as_real(x))
    t = (x / 3.0) ** 2
    small = _poly(t, [0.0002100, -0.0039444, 0.0444479, -0.3163866,
                      1.2656208, -2.2499997, 1.0])
    z = 3.0 / torch.where(x > 3.0, x, 3.0)
    big = _poly(z, _F0) * torch.cos(x + _poly(z, _TH0)) \
        / torch.sqrt(torch.where(x > 0, x, 1.0))
    return torch.where(x <= 3.0, small, big)


def bessel_j1(x):
    """J_1(x) (A&S 9.4.4/9.4.6)."""
    x = as_real(x)
    ax = torch.abs(x)
    t = (ax / 3.0) ** 2
    small = ax * _poly(t, [0.00001109, -0.00031761, 0.00443319, -0.03954289,
                           0.21093573, -0.56249985, 0.5])
    z = 3.0 / torch.where(ax > 3.0, ax, 3.0)
    big = _poly(z, _F1) * torch.cos(ax + _poly(z, _TH1)) \
        / torch.sqrt(torch.where(ax > 0, ax, 1.0))
    return torch.sign(x) * torch.where(ax <= 3.0, small, big)


def bessel_y0(x):
    """Y_0(x), x > 0 (A&S 9.4.2/9.4.3)."""
    x = as_real(x)
    x_safe = torch.where(x > 0, x, 1.0)
    t = (x / 3.0) ** 2
    small = (2.0 / math.pi) * torch.log(0.5 * x_safe) * bessel_j0(x) + _poly(
        t, [-0.00024846, 0.00427916, -0.04261214, 0.25300117,
            -0.74350384, 0.60559366, 0.36746691])
    z = 3.0 / torch.where(x > 3.0, x, 3.0)
    big = _poly(z, _F0) * torch.sin(x + _poly(z, _TH0)) / torch.sqrt(x_safe)
    return torch.where(x <= 3.0, small, big)


def bessel_y1(x):
    """Y_1(x), x > 0 (A&S 9.4.5/9.4.6)."""
    x = as_real(x)
    x_safe = torch.where(x > 0, x, 1.0)
    t = (x / 3.0) ** 2
    small = ((2.0 / math.pi) * x * torch.log(0.5 * x_safe) * bessel_j1(x)
             + _poly(t, [0.0027873, -0.0400976, 0.3123951, -1.3164827,
                         2.1682709, 0.2212091, -0.6366198])) / x_safe
    z = 3.0 / torch.where(x > 3.0, x, 3.0)
    big = _poly(z, _F1) * torch.sin(x + _poly(z, _TH1)) / torch.sqrt(x_safe)
    return torch.where(x <= 3.0, small, big)


#: the top order of `bessel_jn`'s downward recurrence
#: (``jax.scipy.special.bessel_jn``'s default ``n_iter``): well above the
#: orders (0-12) and the kR (up to ~8) of the MacCamy-Fuchs members
_JN_START = 50


def bessel_jn(x, nmax: int):
    """J_n(x) for n = 0..nmax, (nmax+1, ...), x > 0, by Miller's
    normalized downward recurrence as ``jax.scipy.special.bessel_jn``
    runs it (Zhang & Jin, BJNDD), op for op: from 1e-16 at order
    `_JN_START` + 1 down to 0, every value divided by the even-order sum
    J_0 + 2 sum_k J_2k = 1."""
    x = as_real(x)
    f0 = torch.zeros_like(x)
    f1 = torch.full_like(x, 1e-16)
    bs = torch.zeros_like(x)
    vals = [None] * (_JN_START + 1)
    for k in range(_JN_START, -1, -1):
        f = 2.0 * (k + 1.0) * f1 / x - f0
        if k % 2 == 0:
            bs = bs + 2.0 * f
        f0, f1 = f1, f
        vals[k] = f
    return torch.stack(vals[:nmax + 1]) / (bs - vals[0])


#: the clamp of the upward Y recurrence: |Y_n| grows without bound as
#: x -> 0, and consumers take guarded reciprocals, whose limit is 0
_Y_CAP = 1e300


def hankel1_all(x, nmax: int):
    """H^(1)_n(x) = J_n(x) + i Y_n(x) for n = 0..nmax, x > 0 real:
    (nmax+1, ...) complex.  J_n by `bessel_jn`; Y_n by the upward
    recurrence Y_{n+1} = (2n/x) Y_n - Y_{n-1} from the A&S Y_0 and Y_1,
    clamped to +-1e300."""
    x = as_real(x)
    flat = x.reshape(-1)
    J = bessel_jn(flat, nmax)
    x_safe = torch.where(flat > 0, flat, 1.0)
    Ys = [bessel_y0(flat), bessel_y1(flat)]
    for n in range(1, nmax):
        Ys.append(torch.clamp((2.0 * n / x_safe) * Ys[n] - Ys[n - 1],
                              -_Y_CAP, _Y_CAP))
    Y = torch.stack(Ys[:nmax + 1])
    return torch.complex(J, Y).reshape((nmax + 1,) + tuple(x.shape))


def hankel1p_all(x, nmax: int):
    """Derivatives H^(1)'_n(x) for n = 0..nmax: 0.5 (H_{n-1} - H_{n+1}),
    with H_{-1} = -H_1 (so H'_0 = -H_1)."""
    H = hankel1_all(x, nmax + 1)
    lower = torch.cat([-H[1][None], H[:nmax]])
    upper = H[1:nmax + 2]
    return 0.5 * (lower - upper)
