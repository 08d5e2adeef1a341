"""WAMIT-format hydrodynamic coefficient I/O and the potential-flow
excitation.

Port of ``raft_tpu/io/wamit.py`` (reference: the pyHAMS read-back and
readHydro path, raft/raft_fowt.py:640-768).  Parsing, interpolation onto
the model grid and the writers are host numpy, as in the JAX package;
the arrays that enter the solve (`bem_coeffs`) and the per-case
excitation assembly (`bem_excitation`: heading interpolation with
wraparound, rotation from the wave-relative frame back to global, the
array-position phase) are tensors on the model's device.

File conventions (WAMIT v7 manual, as used by HAMS):
  .1 : PER i j Abar [Bbar]     added mass/damping, nondimensional
       PER < 0 -> zero frequency (infinite period): Abar only
       PER = 0 -> infinite frequency (zero period): Abar only
  .3 : PER head(deg) i MOD PHA Re Im    excitation per heading, nondim
Dimensionalization: A = rho*Abar, B = rho*w*Bbar, X = rho*g*(Re + i*Im).
"""
from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch._config import COMPLEX, REAL, as_real
from raft_tpu_torch.errors import NonFiniteResult


def _screen_finite(name, path, **arrays):
    """Raise ``NonFiniteResult`` if a parsed coefficient array carries
    NaN/Inf (the reference guards its HAMS read-back the same way,
    raft_fowt.py:708-714): a corrupt file must not propagate silently."""
    for label, arr in arrays.items():
        if arr is None:
            continue
        bad = ~np.isfinite(np.asarray(arr))
        if bad.any():
            raise NonFiniteResult(
                f"{name} file '{path}': {int(bad.sum())} non-finite "
                f"value(s) in {label} — the file is corrupt or truncated; "
                f"re-run the BEM solver or delete the cached output",
                file=str(path), field=str(label), n_bad=int(bad.sum()))


def _detect_freq_convention(col1_in_file_order):
    """'period' (WAMIT standard: column 1 descends in file order, long
    periods first) vs 'omega' (HAMS Wamit_format output: column 1 is
    rad/s, ascending in file order), from the first-seen unique positive
    column-1 values."""
    seen = set()
    vals = []
    for v in col1_in_file_order:
        if v > 0 and v not in seen:
            seen.add(v)
            vals.append(v)
    if len(vals) < 2:
        warnings.warn(
            "WAMIT/HAMS file has fewer than 2 unique positive column-1 "
            "values — the period-vs-omega convention cannot be detected "
            "from ordering; assuming WAMIT periods.  A single-frequency "
            "HAMS omega-format file would be misread (frequency axis "
            "warped): pass freq='omega' or set platform hydroFreqType.")
        return "period"
    if all(b > a for a, b in zip(vals, vals[1:])):
        return "omega"
    return "period"


def read_wamit1(path, freq="auto"):
    """Parse a WAMIT `.1` added-mass/damping file.

    ``freq``: 'period' (column 1 is the wave period), 'omega' (rad/s
    ascending) or 'auto' (detected from the file ordering).  4-column
    special rows are always periods (PER < 0 zero frequency, PER = 0
    infinite frequency).  Returns dict(w (nf,) ascending rad/s, A, B
    (6,6,nf) nondimensional, A0 (6,6) or None, Ainf (6,6) or None)."""
    rows = []
    special = []
    order = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            T = float(parts[0])
            i, j = int(parts[1]) - 1, int(parts[2]) - 1
            if len(parts) == 4:
                special.append((T, i, j, float(parts[3])))
            else:
                rows.append((T, i, j, float(parts[3]), float(parts[4])))
                order.append(T)

    if freq == "auto":
        freq = _detect_freq_convention(order)
    zero, inf = {}, {}
    for T, i, j, v in special:
        (zero if T < 0 else inf)[(i, j)] = v

    if freq == "omega":
        omegas = sorted({r[0] for r in rows})
        idx = {o: n for n, o in enumerate(omegas)}
        w = np.array(omegas)
    else:
        periods = sorted({r[0] for r in rows}, reverse=True)
        idx = {T: n for n, T in enumerate(periods)}
        w = 2.0 * np.pi / np.array(periods)
    nf = len(idx)
    A = np.zeros((6, 6, nf))
    B = np.zeros((6, 6, nf))
    for T, i, j, a, b in rows:
        A[i, j, idx[T]] = a
        B[i, j, idx[T]] = b

    def mat(d):
        if not d:
            return None
        M = np.zeros((6, 6))
        for (i, j), v in d.items():
            M[i, j] = v
        return M

    out = dict(w=w, A=A, B=B, A0=mat(zero), Ainf=mat(inf))
    _screen_finite("WAMIT .1", path, **out)
    return out


def read_wamit3(path, freq="auto"):
    """Parse a WAMIT `.3` excitation file (``freq`` as in read_wamit1).
    Returns dict(w (nf,) ascending rad/s, headings (nh,) deg sorted in
    [0, 360), X (nh,6,nf) complex nondimensional)."""
    rows = []
    order = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            T = float(parts[0])
            head = float(parts[1])
            i = int(parts[2]) - 1
            re, im = float(parts[5]), float(parts[6])
            rows.append((T, head, i, re, im))
            order.append(T)

    if freq == "auto":
        freq = _detect_freq_convention(order)
    if freq == "omega":
        keys = sorted({r[0] for r in rows})
        w = np.array(keys)
    else:
        keys = sorted({r[0] for r in rows}, reverse=True)
        w = 2.0 * np.pi / np.array(keys)
    heads_raw = sorted({r[1] for r in rows})
    tidx = {T: n for n, T in enumerate(keys)}
    hidx = {h: n for n, h in enumerate(heads_raw)}
    X = np.zeros((len(heads_raw), 6, len(keys)), dtype=complex)
    for T, head, i, re, im in rows:
        X[hidx[head], i, tidx[T]] = re + 1j * im

    # headings to [0, 360), re-sorted (reference: raft_fowt.py:669-676)
    headings = np.asarray(heads_raw) % 360.0
    order = np.argsort(headings)
    _screen_finite("WAMIT .3", path, w=w, X=X, headings=np.asarray(heads_raw))
    return dict(w=w, headings=headings[order], X=X[order])


@dataclass
class BEMData:
    """Potential-flow coefficients on the model frequency grid.  Built as
    numpy; carried to the model's device with the rest of the FOWTModel
    (``headings`` stays host numpy).  X_BEM is in the wave-relative frame
    per BEM heading (reference: raft_fowt.py:692-706)."""

    A_BEM: object                # (6,6,nw) dimensional added mass
    B_BEM: object                # (6,6,nw) dimensional radiation damping
    X_BEM: object                # (nh,6,nw) complex excitation, wave frame
    headings: np.ndarray         # (nh,) deg in [0,360), ascending


def _interp_freq(w_model, w_data, Y, Y_at_zero):
    """Linear interpolation of Y (..., nf) from w_data to w_model with a
    zero-frequency pad (reference: raft_fowt.py:678-683); clamps above
    the data range."""
    w_ext = np.concatenate([[0.0], w_data])
    Y_ext = np.concatenate([Y_at_zero[..., None], Y], axis=-1)
    shape = Y.shape[:-1]
    out = np.empty(shape + (len(w_model),), dtype=Y.dtype)
    for idx in np.ndindex(shape):
        if np.iscomplexobj(Y):
            out[idx] = (np.interp(w_model, w_ext, Y_ext[idx].real)
                        + 1j * np.interp(w_model, w_ext, Y_ext[idx].imag))
        else:
            out[idx] = np.interp(w_model, w_ext, Y_ext[idx])
    return out


def rotate_to_wave_frame(X_global, headings):
    """Rotate global-frame excitation (nh,6,nf) so surge/sway (and
    roll/pitch) are relative to each incident wave heading (reference:
    raft_fowt.py:692-706)."""
    X = np.zeros_like(X_global)
    for ih, hd in enumerate(np.atleast_1d(headings)):
        c, s = np.cos(np.deg2rad(hd)), np.sin(np.deg2rad(hd))
        Xg = X_global[ih]
        X[ih, 0] = c * Xg[0] + s * Xg[1]
        X[ih, 1] = -s * Xg[0] + c * Xg[1]
        X[ih, 2] = Xg[2]
        X[ih, 3] = c * Xg[3] + s * Xg[4]
        X[ih, 4] = -s * Xg[3] + c * Xg[4]
        X[ih, 5] = Xg[5]
    return X


def load_bem(hydro_path: str, w_model, rho: float = 1025.0,
             g: float = 9.81, freq: str = "auto") -> BEMData:
    """Read `hydro_path`.1/.3 and interpolate onto the model grid
    (reference: raft_fowt.py:663-768).  ``freq`` as in read_wamit1 (the
    design's ``platform: hydroFreqType``); 'auto' resolves it once from
    the .1 and reuses it for the .3.  Above the data range the added mass
    takes the file's infinite-frequency rows when present.  A missing .3
    gives zero excitation at one 0-degree heading."""
    path = hydro_path
    if not os.path.isfile(path + ".1"):
        raise FileNotFoundError(f"WAMIT file {hydro_path}.1 not found")

    w_model = np.asarray(w_model, float)
    if freq == "auto":
        with open(path + ".1") as f:
            col1 = [float(ln.split()[0]) for ln in f if ln.split()]
        freq = _detect_freq_convention(col1)
        if freq == "omega":
            warnings.warn(
                f"'{hydro_path}.1': column 1 ascends in file order — "
                "reading as HAMS omega [rad/s] format.  If this is a "
                "WAMIT period file with ascending PER input, set "
                "platform: hydroFreqType: period.", stacklevel=2)
    d1 = read_wamit1(path + ".1", freq=freq)
    A0 = d1["A0"] if d1["A0"] is not None else d1["A"][:, :, 0]
    A_BEM = rho * _interp_freq(w_model, d1["w"], d1["A"], A0)
    if d1["Ainf"] is not None:
        above = w_model > d1["w"][-1]
        if np.any(above):
            A_BEM[:, :, above] = rho * d1["Ainf"][:, :, None]
    # the file's raw Bbar times w (pyhams' read_wamit1 returns w*Bbar)
    B_dim = d1["B"] * d1["w"][None, None, :]
    B_BEM = rho * _interp_freq(w_model, d1["w"], B_dim, np.zeros((6, 6)))

    if os.path.isfile(path + ".3"):
        d3 = read_wamit3(path + ".3", freq=freq)
        X_dim = rho * g * d3["X"]
        X_BEM_global = _interp_freq(w_model, d3["w"], X_dim,
                                    np.zeros_like(X_dim[..., 0]))
        headings = d3["headings"]
        X_BEM = rotate_to_wave_frame(X_BEM_global, headings)
    else:
        headings = np.array([0.0])
        X_BEM = np.zeros((1, 6, len(w_model)), dtype=complex)

    return BEMData(A_BEM=A_BEM, B_BEM=B_BEM, X_BEM=X_BEM, headings=headings)


def bem_coeffs(bem: Optional[BEMData], nw: int, device=None):
    """(A_BEM, B_BEM) (6, 6, nw) float64 tensors on ``device`` for the
    linear system; zeros when no potential-flow data is loaded.  Shared
    by ``Model`` and the sweep so the two stay in step."""
    if bem is None:
        z = torch.zeros((6, 6, nw), dtype=REAL, device=device)
        return z, z
    return as_real(bem.A_BEM, device), as_real(bem.B_BEM, device)


def bem_excitation(bem: BEMData, beta_rad, zeta, k, x_ref=0.0, y_ref=0.0,
                   heading_adjust=0.0):
    """Potential-flow excitation of a batch of sea states (reference:
    raft_fowt.py:1039-1093): ``beta_rad`` (nH,) global wave headings,
    ``zeta`` (nH, nw) complex amplitudes, ``k`` (nw,) wave numbers, all
    on one device.  Returns F_BEM (nH, 6, nw) complex."""
    k = as_real(k)
    dev = k.device
    beta = as_real(beta_rad, dev).reshape(-1)
    zeta = torch.as_tensor(zeta, device=dev).to(COMPLEX).reshape(
        beta.shape[0], -1)
    heads = np.asarray(bem.headings, float)

    # periodic extension for wraparound interpolation (reference:
    # raft_fowt.py:1053-1074)
    heads_ext = as_real(np.concatenate(
        [[heads[-1] - 360.0], heads, [heads[0] + 360.0]]), dev)
    X = torch.as_tensor(bem.X_BEM, device=dev).to(COMPLEX)
    X_ext = torch.cat([X[-1:], X, X[:1]])

    beta_deg = torch.remainder(beta * (180.0 / math.pi) - heading_adjust,
                               360.0)
    i2 = torch.clamp(torch.searchsorted(heads_ext, beta_deg), 1,
                     heads_ext.shape[0] - 1)
    i1 = i2 - 1
    h1, h2 = heads_ext[i1], heads_ext[i2]
    f2 = torch.where(h2 > h1, (beta_deg - h1)
                     / torch.where(h2 > h1, h2 - h1, 1.0), 0.0)
    f2 = f2[:, None, None]
    Xp = X_ext[i1] * (1.0 - f2) + X_ext[i2] * f2             # (nH,6,nw)

    # back to the global frame (reference: raft_fowt.py:1082-1090)
    c = torch.cos(beta)[:, None]
    s = torch.sin(beta)[:, None]
    Xg = torch.stack([Xp[:, 0] * c - Xp[:, 1] * s,
                      Xp[:, 0] * s + Xp[:, 1] * c,
                      Xp[:, 2],
                      Xp[:, 3] * c - Xp[:, 4] * s,
                      Xp[:, 3] * s + Xp[:, 4] * c,
                      Xp[:, 5]], dim=1)

    # array-position phase from the GLOBAL wave heading (reference:
    # raft_fowt.py:1043-1045)
    phase = torch.exp(-1j * k[None, :] * (x_ref * c + y_ref * s))
    return Xg * zeta[:, None, :] * phase[:, None, :]


# --------------------------------------------------------------------------
# WAMIT-format writers (.1/.3): the native BEM's coefficient cache, in the
# files the reference writes for OpenFAST export
# --------------------------------------------------------------------------

def write_wamit1(path, w, A, B, rho=1025.0):
    """Write a WAMIT `.1` file from dimensional A/B (6,6,nf) on the
    ascending grid w, nondimensionalised by rho (Abar) and rho*w (Bbar)."""
    with open(path, "w") as f:
        for n in range(len(w)):
            T = 2.0 * np.pi / w[n]
            for i in range(6):
                for j in range(6):
                    Abar = A[i, j, n] / rho
                    Bbar = B[i, j, n] / (rho * w[n])
                    f.write(f"{T:14.6e} {i+1:d} {j+1:d} "
                            f"{Abar:14.6e} {Bbar:14.6e}\n")
    return path


def write_wamit3(path, w, headings, X, rho=1025.0, g=9.81):
    """Write a WAMIT `.3` file from dimensional global-frame excitation
    X (nh,6,nf) complex, nondimensionalised by rho*g."""
    with open(path, "w") as f:
        for n in range(len(w)):
            T = 2.0 * np.pi / w[n]
            for ih, hd in enumerate(headings):
                for i in range(6):
                    Xn = X[ih, i, n] / (rho * g)
                    mod, pha = np.abs(Xn), np.angle(Xn, deg=True)
                    f.write(f"{T:14.6e} {hd:10.3f} {i+1:d} "
                            f"{mod:14.6e} {pha:10.3f} "
                            f"{Xn.real:14.6e} {Xn.imag:14.6e}\n")
    return path
