"""Wave spectra and response-statistics ops.

Port of ``raft_tpu/ops/spectra.py`` (reference: raft/helpers.py:581-684 —
getRMS, getPSD, JONSWAP, getRAO), batched over leading axes.  Inputs may
be tensors or numpy arrays; numpy inputs give CPU tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch._config import as_real


def _t(x, dev=None):
    """Tensor view of x: tensors pass through; numpy/python inputs keep
    complex128 when complex and become float64 otherwise."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=complex if np.iscomplexobj(x)
                                      else float), device=dev)


def jonswap_gamma(Hs, Tp):
    """IEC 61400-3 recommended peak-shape parameter."""
    Hs = as_real(Hs)
    Tp = as_real(Tp, Hs.device)
    ratio = Tp / torch.sqrt(Hs)
    mid = torch.exp(5.75 - 1.15 * ratio)
    return torch.where(ratio <= 3.6, 5.0, torch.where(ratio >= 5.0, 1.0, mid))


def jonswap(ws, Hs, Tp, gamma=None):
    """One-sided JONSWAP/PM wave PSD [m^2/(rad/s)] at frequencies ws
    [rad/s].  gamma None (or 0) selects the IEC auto-gamma.

    Scalar Hs, Tp give (nw,); Hs, Tp (and a given gamma) of shape (nc,)
    give one spectrum per sea state, (nc, nw)."""
    ws = as_real(ws)
    dev = ws.device
    Hs = as_real(Hs, dev)
    Tp = as_real(Tp, dev)
    batched = Hs.ndim > 0 or Tp.ndim > 0
    if batched:
        Hs, Tp = Hs[..., None], Tp[..., None]
    if gamma is None or (not isinstance(gamma, torch.Tensor)
                         and np.ndim(gamma) == 0 and not gamma):
        g = jonswap_gamma(Hs, Tp)
    else:
        g = as_real(gamma, dev)
        if batched and g.ndim > 0:
            g = g[..., None]
    f = 0.5 / math.pi * ws
    fpOvrf4 = (Tp * f) ** (-4.0)
    C = 1.0 - 0.287 * torch.log(g)
    sigma = torch.where(f <= 1.0 / Tp, torch.full_like(f, 0.07),
                        torch.full_like(f, 0.09))
    alpha = torch.exp(-0.5 * ((f * Tp - 1.0) / sigma) ** 2)
    return (
        0.5 / math.pi * C * 0.3125 * Hs * Hs * fpOvrf4 / f
        * torch.exp(-1.25 * fpOvrf4) * g**alpha
    )


def get_rms(xi, axis=None):
    """sigma = sqrt(0.5 * sum |xi|^2) over all (or the given) axes."""
    xi = _t(xi)
    a2 = torch.abs(xi) ** 2
    s = torch.sum(a2) if axis is None else torch.sum(a2, dim=axis)
    return torch.sqrt(0.5 * s)


def get_psd(xi, dw, source_axis=None):
    """PSD = 0.5 |xi|^2 / dw, summed over an excitation-source axis if
    given."""
    xi = _t(xi)
    psd = 0.5 * torch.abs(xi) ** 2 / dw
    if source_axis is not None:
        psd = torch.sum(psd, dim=source_axis)
    return psd


def get_rao(Xi, zeta, eps=1e-6):
    """Response amplitude operator Xi/zeta with a zero-amplitude guard;
    zeta (nw,) runs along Xi's last axis."""
    Xi = _t(Xi)
    zeta = zeta.to(Xi.device) if isinstance(zeta, torch.Tensor) \
        else torch.as_tensor(zeta, device=Xi.device)
    if not zeta.is_complex():
        zeta = zeta.to(torch.float64)
    ok = torch.abs(zeta) > eps
    safe = torch.where(ok, zeta, torch.ones_like(zeta))
    return torch.where(ok, Xi / safe, torch.zeros((), dtype=(Xi / safe).dtype,
                                                  device=Xi.device))
