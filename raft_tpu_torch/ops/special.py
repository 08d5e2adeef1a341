"""Struve-minus-Bessel differences for the rotor-averaged Kaimal spectrum.

Port of the part of ``raft_tpu/ops/special.py`` that
``rotor.kaimal_spectra`` needs (the reference uses scipy.special
modstruve/iv, raft/raft_rotor.py:1216-1218).  D_nu(x) = L_nu(x) - I_nu(x)
stays O(1) while L and I grow like e^x/sqrt(x): D_0 and D_1 come from the
power-series difference (cumulative-product terms) for small x and the
DLMF 11.6.2 asymptotic expansion for large x; D_{-2} from the exact
recurrence D_{-2} = D_0 - (2/x) D_1 - 2/(pi x).
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
