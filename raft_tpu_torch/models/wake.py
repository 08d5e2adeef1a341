"""Wake coupling for farms: Gaussian-deficit model, equilibrium, AEP.

Port of ``raft_tpu/models/wake.py`` (reference: raft_model.py:1674-2022 —
powerThrustCurve, florisFindEquilibrium, florisCalcAEP).  The wake physics
is the Bastankhah & Porte-Agel (2014) Gaussian self-similar deficit with
linear wake expansion and root-sum-square superposition.

- The host functions are NumPy (the farm's orchestration, as the
  reference's FLORIS loop): `gaussian_deficit`, `wake_velocities`,
  `_curve_interp`, `find_wake_equilibrium`, `calc_aep`; the rotor BEM
  behind `power_thrust_curve` runs in float64 on the rotor's device, one
  operating point at a time.
- The ``*_torch`` functions are the batched counterparts of the JAX
  package's ``*_jnp`` ones, over a leading case axis, on any device: the
  farm sweep (``parallel/sweep.py:make_farm_solver``) runs the wake
  equilibrium of every case at once on the card.  `wake_equilibria_torch`
  is the ``vmap`` of the JAX package's ``lax.while_loop``: one step for
  all cases per iteration, a converged case frozen while the others go
  on, so each case's iteration count is its own.

The FLORIS interop of the JAX package (``floris_turbine_dict``,
``floris_coupling``) is not ported (ROADMAP A10).
"""
from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch._config import REAL, as_real

#: the reference clips Ct at 0.96 before dividing by sqrt(1 - Ct); (1 - Ct)
#: is also floored at 1 - CT_MAX so the expression has no Ct -> 1
#: singularity on an untaken branch
CT_MAX = 0.96
_ONE_MINUS_CT_MIN = 1.0 - CT_MAX


def gaussian_deficit(x_d, y_d, Ct, k_w=0.05):
    """Normalized velocity deficit at (x_d, y_d) rotor diameters
    downstream / crosswind of a turbine of thrust coefficient Ct
    (Bastankhah & Porte-Agel 2014): sigma/D = k_w x/D + 0.25 sqrt(beta),
    beta = (1 + sqrt(1-Ct)) / (2 sqrt(1-Ct)),
    dU/U = (1 - sqrt(1 - Ct/(8 (sigma/D)^2))) exp(-y^2/(2 sigma^2))."""
    Ct = np.clip(Ct, 0.0, CT_MAX)
    sq = np.sqrt(np.maximum(1.0 - Ct, _ONE_MINUS_CT_MIN))
    beta = 0.5 * (1.0 + sq) / sq
    sigma_D = k_w * np.maximum(x_d, 0.1) + 0.25 * np.sqrt(beta)
    rad = 1.0 - Ct / (8.0 * sigma_D**2)
    C = 1.0 - np.sqrt(np.clip(rad, 0.0, 1.0))
    dU = C * np.exp(-y_d**2 / (2.0 * sigma_D**2))
    return np.where(x_d > 0.05, dU, 0.0)


def _wake_frame(xy, wind_dir_deg):
    """Rotate farm coordinates into the downwind / crosswind frame."""
    th = np.deg2rad(wind_dir_deg)
    R = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    return np.asarray(xy, float) @ R.T


def wake_velocities(xy, D, Ct, U_inf, wind_dir_deg=0.0, k_w=0.05):
    """Effective hub-height wind speed at each turbine of a farm: xy (n, 2)
    positions [m], D rotor diameter(s), Ct (n,), wind_dir_deg the direction
    the wind flows toward (x axis at 0); root-sum-square superposition over
    the (receiver i, source j) pair matrix, distances in source
    diameters."""
    xy = np.asarray(xy, float)
    n = len(xy)
    D = np.broadcast_to(np.asarray(D, float), (n,))
    Ct = np.asarray(Ct, float)
    xy_w = _wake_frame(xy, wind_dir_deg)
    dx = (xy_w[:, 0][:, None] - xy_w[None, :, 0]) / D[None, :]
    dy = (xy_w[:, 1][:, None] - xy_w[None, :, 1]) / D[None, :]
    dU = gaussian_deficit(dx, dy, Ct[None, :], k_w)
    np.fill_diagonal(dU, 0.0)
    ssq = np.sum(dU**2, axis=1)
    return U_inf * (1.0 - np.sqrt(ssq))


def _host(x, what="wake_table"):
    """A host copy of ``x``; a tensor's through the counted
    ``obs.transfers.device_get``."""
    if isinstance(x, torch.Tensor):
        from raft_tpu_torch.obs import transfers
        return transfers.device_get(x, what=what)
    return np.asarray(x)


def power_thrust_curve(model, speeds=None, ifowt=0, cut_in=3.0,
                       cut_out=25.0):
    """Cp / Ct / power / thrust / pitch schedule against wind speed
    (reference: raft_model.py:1674-1750 powerThrustCurve): the BEM rotor
    at each operating point, float64 on the rotor's device.  Speeds outside
    [cut_in, cut_out] are parked (zero power, thrust, Cp, Ct, rotor
    speed).  ``model`` is a Model (rotor of ``fowtList[ifowt]``) or a
    FOWTModel.  Returns NumPy arrays keyed like the FLORIS turbine YAML."""
    from raft_tpu_torch.models.rotor import _device, bem_evaluate

    fowt = model.fowtList[ifowt] if hasattr(model, "fowtList") else model
    rot = fowt.rotors[0]
    if speeds is None:
        speeds = np.arange(3.0, 25.5, 1.0)
    speeds = np.asarray(speeds, float)
    rho = rot.rho
    A = np.pi * rot.R_rot**2
    P = np.zeros_like(speeds)
    T = np.zeros_like(speeds)
    pitch = np.zeros_like(speeds)
    omega = np.zeros_like(speeds)
    op = (speeds >= cut_in) & (speeds <= cut_out)
    Uh_all = speeds * rot.speed_gain
    Uhub_ops = _host(rot.Uhub_ops)
    om_all = np.interp(Uh_all, Uhub_ops, _host(rot.Omega_rpm_ops))
    pi_all = np.interp(Uh_all, Uhub_ops, _host(rot.pitch_deg_ops))
    dev = _device(rot)
    for i in np.flatnonzero(op):
        # tilt seen by the BEM is -shaft_tilt (the convention calc_aero
        # derives from the pose)
        out = bem_evaluate(rot, as_real(Uh_all[i], dev),
                           as_real(om_all[i], dev), as_real(pi_all[i], dev),
                           tilt=-rot.shaft_tilt)
        P[i], T[i] = _host(torch.stack([out["P"].reshape(()),
                                        out["T"].reshape(())]),
                           "power_curve")
    pitch[op] = pi_all[op]
    omega[op] = om_all[op]
    Cp = P / (0.5 * rho * A * speeds**3)
    Ct = np.clip(T / (0.5 * rho * A * speeds**2), 0.0, 2.0)
    return dict(wind_speed=speeds, power=P, thrust=T, Cp=Cp, Ct=Ct,
                pitch_deg=pitch, omega_rpm=omega, rotor_area=A)


def _curve_interp(U, curve, key, outside=0.0):
    """A power/thrust-curve channel at speeds U, ``outside`` beyond the
    curve's speed range (parked below cut-in and above cut-out)."""
    U = np.asarray(U, float)
    xs = curve["wind_speed"]
    vals = np.interp(U, xs, curve[key])
    return np.where((U < xs[0]) | (U > xs[-1]), outside, vals)


def _farm_curves(model, curve=None):
    """One power/thrust curve per FOWT, computed once per distinct rotor
    object; ``curve`` may be one curve dict (for all) or a list."""
    if isinstance(curve, dict):
        return [curve] * model.nFOWT
    if curve is not None:
        return list(curve)
    cache = {}
    out = []
    for i, f in enumerate(model.fowtList):
        key = id(f.rotors[0])
        if key not in cache:
            cache[key] = power_thrust_curve(model, ifowt=i)
        out.append(cache[key])
    return out


def find_wake_equilibrium(model, case, k_w=0.05, max_iter=100, tol=1e-4,
                          relax=0.5, curve=None):
    """Farm wake fixed point (reference: raft_model.py:1852-1994
    florisFindEquilibrium): wake model -> per-turbine wind speeds ->
    thrust coefficients -> wake model, under-relaxed.  A per-turbine list
    of ``case['wind_speed']`` is reduced to its maximum (the free
    stream).  Returns dict(U, Ct, power (n,), the case with per-turbine
    wind speeds, iterations)."""
    n = model.nFOWT
    ws = case.get("wind_speed", 10.0)
    U_inf = float(np.max(ws)) if np.ndim(ws) > 0 else float(ws)
    wh = np.atleast_1d(np.asarray(case.get("wind_heading", 0.0), float))
    # circular mean (the arithmetic mean of e.g. [350, 10] deg is wrong)
    wind_dir = float(np.rad2deg(np.arctan2(
        np.mean(np.sin(np.deg2rad(wh))), np.mean(np.cos(np.deg2rad(wh))))))
    xy = np.array([[f.x_ref, f.y_ref] for f in model.fowtList])
    D = np.array([2.0 * f.rotors[0].R_rot for f in model.fowtList])
    curves = _farm_curves(model, curve)

    U = np.full(n, U_inf)
    Ct = np.array([float(_curve_interp(U[i], curves[i], "Ct"))
                   for i in range(n)])
    for it in range(max_iter):
        U_new = wake_velocities(xy, D, Ct, U_inf, wind_dir, k_w)
        if np.max(np.abs(U_new - U)) < tol:
            U = U_new
            break
        U = relax * U + (1.0 - relax) * U_new
        Ct = np.array([float(_curve_interp(U[i], curves[i], "Ct"))
                       for i in range(n)])
    power = np.array([float(_curve_interp(U[i], curves[i], "power"))
                      for i in range(n)])
    case_out = dict(case)
    case_out["wind_speed"] = list(U)
    return dict(U=U, Ct=Ct, power=power, case=case_out, iterations=it + 1)


def calc_aep(model, wind_rose, k_w=0.05, availability=1.0):
    """Wind-rose AEP [Wh] with wake losses (reference: raft_model.py:
    1996-2022 florisCalcAEP); wind_rose: (speed [m/s], direction [deg],
    probability) triples."""
    curves = _farm_curves(model)
    hours = 8760.0
    aep = 0.0
    per_state = []
    for speed, wd, prob in wind_rose:
        eq = find_wake_equilibrium(
            model, dict(wind_speed=speed, wind_heading=wd), k_w=k_w,
            curve=curves)
        farm_p = float(np.sum(eq["power"]))
        per_state.append(dict(speed=speed, dir=wd, prob=prob,
                              farm_power=farm_p, U=eq["U"]))
        aep += prob * farm_p * hours
    return dict(AEP=aep * availability, states=per_state)


# --------------------------------------------------------------------------
# batched tensor counterparts of the JAX package's jnp functions
# --------------------------------------------------------------------------

def gaussian_deficit_torch(x_d, y_d, Ct, k_w=0.05):
    """`gaussian_deficit` on tensors (``gaussian_deficit_jnp``: the same
    math with the where-guards around the square roots)."""
    Ct = torch.clamp(Ct, 0.0, CT_MAX)
    sq = torch.sqrt(torch.clamp(1.0 - Ct, min=_ONE_MINUS_CT_MIN))
    beta = 0.5 * (1.0 + sq) / sq
    sigma_D = k_w * torch.clamp(x_d, min=0.1) + 0.25 * torch.sqrt(beta)
    rad = 1.0 - Ct / (8.0 * sigma_D**2)
    rad_pos = rad > 0.0
    one = torch.ones((), dtype=rad.dtype, device=rad.device)
    C = 1.0 - torch.where(rad_pos, torch.sqrt(torch.where(rad_pos, rad, one)),
                          torch.where(rad > 1.0, one, 0.0 * one))
    dU = C * torch.exp(-y_d**2 / (2.0 * sigma_D**2))
    return torch.where(x_d > 0.05, dU, 0.0 * one)


def wake_velocities_torch(xy_w, D, Ct, U_inf, k_w=0.05):
    """`wake_velocities` on tensors, already in the wake frame, over any
    leading axes (``wake_velocities_jnp``): xy_w (..., n, 2), D (n,),
    Ct (..., n), U_inf (...) -> (..., n)."""
    dx = (xy_w[..., :, None, 0] - xy_w[..., None, :, 0]) / D
    dy = (xy_w[..., :, None, 1] - xy_w[..., None, :, 1]) / D
    dU = gaussian_deficit_torch(dx, dy, Ct[..., None, :], k_w)
    n = xy_w.shape[-2]
    dU = dU * (1.0 - torch.eye(n, dtype=dU.dtype, device=dU.device))
    ssq = torch.sum(dU**2, dim=-1)
    return U_inf[..., None] * (1.0 - torch.sqrt(ssq))


def interp_torch(x, xp, fp):
    """``jnp.interp`` on tensors (the same index rule and arithmetic):
    piecewise linear in a table xp (m,), fp (m,), clamped to its ends."""
    m = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, m - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _curve_interp_torch(U, xs, vals, outside=0.0):
    """`_curve_interp` on tensors (``_curve_interp_jnp``)."""
    out = interp_torch(U, xs, vals)
    return torch.where((U < xs[0]) | (U > xs[-1]),
                       torch.full_like(out, outside), out)


def wake_equilibria_torch(xy, D, curve_speed, curve_Ct, curve_power,
                          U_inf, wind_dir_deg, k_w=0.05, max_iter=100,
                          tol=1e-4, relax=0.5):
    """The farm wake fixed point of every case at once, on the tensors'
    device (``wake_equilibria_jnp``, the ``vmap`` of
    ``wake_equilibrium_jnp``'s ``lax.while_loop``): xy (n, 2), D (n,),
    one curve table shared by the turbines, U_inf and wind_dir_deg (nc,).

    Each iteration steps every case that is still running; a case stops
    at its own convergence or at ``max_iter``.  As in the host loop, the
    converging iteration keeps U = U_new and does not re-interpolate Ct.
    One host read per iteration (whether any case still runs).  Returns
    dict(U, Ct, power (nc, n), iterations (nc,) int64)."""
    dev = xy.device
    U_inf = as_real(U_inf, dev).reshape(-1)
    th = torch.deg2rad(as_real(wind_dir_deg, dev).reshape(-1))
    c, s = torch.cos(th), torch.sin(th)
    R = torch.stack([torch.stack([c, s], dim=-1),
                     torch.stack([-s, c], dim=-1)], dim=-2)   # (nc, 2, 2)
    xy_w = torch.einsum("nj,cij->cni", xy, R)                # xy @ R.T
    nc, n = U_inf.shape[0], xy.shape[0]
    D = torch.broadcast_to(as_real(D, dev), (n,))

    U = U_inf[:, None].expand(nc, n).clone()
    Ct = _curve_interp_torch(U, curve_speed, curve_Ct)
    it = torch.zeros(nc, dtype=torch.int64, device=dev)
    done = torch.zeros(nc, dtype=torch.bool, device=dev)
    while True:
        run = (~done) & (it < max_iter)
        if not bool(_host(torch.any(run), "wake_iteration")):
            break
        U_new = wake_velocities_torch(xy_w, D, Ct, U_inf, k_w)
        conv = torch.amax(torch.abs(U_new - U), dim=-1) < tol
        U2 = torch.where(conv[:, None], U_new,
                         relax * U + (1.0 - relax) * U_new)
        Ct2 = torch.where(conv[:, None], Ct,
                          _curve_interp_torch(U2, curve_speed, curve_Ct))
        U = torch.where(run[:, None], U2, U)
        Ct = torch.where(run[:, None], Ct2, Ct)
        it = it + run.to(torch.int64)
        done = done | (run & conv)
    power = _curve_interp_torch(U, curve_speed, curve_power)
    return dict(U=U, Ct=Ct, power=power, iterations=it)


def wake_equilibrium_torch(xy, D, curve_speed, curve_Ct, curve_power,
                           U_inf, wind_dir_deg, k_w=0.05, max_iter=100,
                           tol=1e-4, relax=0.5):
    """One (U_inf, wind direction) state (``wake_equilibrium_jnp``):
    U, Ct, power (n,), iterations a 0-d tensor."""
    out = wake_equilibria_torch(
        xy, D, curve_speed, curve_Ct, curve_power,
        as_real(U_inf, xy.device).reshape(1),
        as_real(wind_dir_deg, xy.device).reshape(1), k_w=k_w,
        max_iter=max_iter, tol=tol, relax=relax)
    return {k: v[0] for k, v in out.items()}


def curve_tensors(curve, device):
    """(wind_speed, Ct, power) of a curve dict as float64 tensors."""
    return tuple(torch.as_tensor(np.asarray(curve[k], float), dtype=REAL,
                                 device=device)
                 for k in ("wind_speed", "Ct", "power"))
