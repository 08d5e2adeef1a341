"""Rotor aero-servo layer: differentiable BEM + control linearization.

Port of ``raft_tpu/models/rotor.py`` (reference: raft/raft_rotor.py and
its CCBlade dependency):

- `build_rotor(turbine, w, ir)` parses the turbine dict ONCE on the host
  (numpy + scipy, as in the JAX package): blade elements, spanwise PCHIP
  airfoil interpolation, and per-element smoothing-spline polars as
  piecewise-cubic tables (``convert.state_from_numpy`` moves them to a
  device).
- `bem_evaluate(...)` is Ning (2014)'s single-residual BEM solve (the
  algorithm inside CCBlade's `inductionfactors`): 60 bracketed bisections
  (held out of differentiation with ``.detach()``) then 3 Newton steps
  (differentiable), batched over blade elements and azimuth sectors.
  dT/d(U, Omega, pitch) come from ``torch.func.jacfwd``.
- `calc_aero(...)` reproduces the aero-servo linearization
  (raft_rotor.py:788-1005) for aeroServoMod 1 and 2.
- `kaimal_spectra(...)` is the IEC Kaimal model with rotor averaging
  through the Struve-Bessel differences of ``ops.special``.

The H100 runs all of it in float64 on the device; the JAX package's
f64 host detour (``f64_host``) has no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from raft_tpu_torch._config import as_real
from raft_tpu_torch.ops.special import struve_bessel_diff_1, struve_bessel_diff_m2
from raft_tpu_torch.ops.transforms import rotation_matrix, rotate_matrix_3, rotate_matrix_6
from raft_tpu_torch.utils.dicttools import get_from_dict

# the reference's (approximate) conversion constants — kept bit-identical
# for parity (raft_rotor.py:31-32)
_RAD2DEG = 57.2958
_RPM2RADPS = 0.1047
_RPM2RS = np.pi / 30.0   # exact, used inside the BEM like CCBlade does

_N_BISECT = 60
_N_NEWTON = 3
_EPS_PHI = 1e-6


@dataclass
class RotorModel:
    """Static description of one rotor (numpy arrays + flags)."""

    # RNA / drivetrain
    r_rel: np.ndarray
    overhang: float
    xCG_RNA: float
    mRNA: float
    IxRNA: float
    IrRNA: float
    speed_gain: float
    nBlades: int
    yaw_mode: int
    azimuths: np.ndarray
    shaft_tilt: float      # [rad]
    shaft_toe: float       # [rad]
    aeroServoMod: int
    I_drivetrain: float
    # blade/BEM geometry
    Rhub: float
    Rtip: float
    R_rot: float
    precone: float         # [deg]
    blade_r: np.ndarray
    chord: np.ndarray
    theta_deg: np.ndarray
    precurve: np.ndarray
    presweep: np.ndarray
    precurveTip: float
    presweepTip: float
    nSector: int
    rho: float
    mu: float
    shearExp: float
    hubHt: float
    # operating schedule (incl. parked extension)
    Uhub_ops: np.ndarray
    Omega_rpm_ops: np.ndarray
    pitch_deg_ops: np.ndarray
    # control gains
    kp_0: np.ndarray
    ki_0: np.ndarray
    k_float: float
    kp_tau: float
    ki_tau: float
    Ng: float
    # per-element polar piecewise-cubics: breakpoints (nr, nbp) and
    # coefficients (nr, nbp-1, 4) highest-power-first
    cl_bp: np.ndarray = field(default=None, repr=False)
    cl_c: np.ndarray = field(default=None, repr=False)
    cd_bp: np.ndarray = field(default=None, repr=False)
    cd_c: np.ndarray = field(default=None, repr=False)
    cpmin_bp: np.ndarray = field(default=None, repr=False)
    cpmin_c: np.ndarray = field(default=None, repr=False)
    # spanwise airfoil info (underwater blade members, cavitation)
    Ca_interp: np.ndarray = field(default=None, repr=False)
    r_thick_interp: np.ndarray = field(default=None, repr=False)
    aoa_grid: np.ndarray = field(default=None, repr=False)
    # rotor axis unit vector in the platform frame at build (tilt+toe
    # applied, zero nacelle yaw) — the reference's q_rel (raft_rotor.py:100)
    q_rel0: np.ndarray = field(default=None, repr=False)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

def _ppoly_from_smoothing_spline(x, y, s):
    """Fit the same bivariate smoothing spline CCAirfoil uses (duplicated
    Reynolds column, kx=3/ky=1) and convert the alpha dependence to
    piecewise-cubic (breakpoints, coeffs highest-power-first)."""
    from scipy.interpolate import RectBivariateSpline

    Re = np.array([1e1, 1e15])
    yy = np.c_[y, y]
    kx = min(len(x) - 1, 3)
    spl = RectBivariateSpline(x, Re, yy, kx=kx, ky=1, s=s)
    tx = spl.get_knots()[0]
    bp = np.unique(tx)
    Re0 = 1e7
    nseg = len(bp) - 1
    c = np.zeros((nseg, 4))
    x0 = bp[:-1]
    h = np.diff(bp)
    c[:, 3] = spl.ev(x0, Re0)
    c[:, 2] = spl.ev(x0, Re0, dx=1)
    c[:, 1] = spl.ev(x0, Re0, dx=2) / 2.0
    # cubic term from the change in second derivative across the segment
    # (FITPACK can't evaluate dx=3 for kx=3)
    c[:, 0] = (spl.ev(bp[1:], Re0, dx=2) - spl.ev(x0, Re0, dx=2)) / (6.0 * h)
    return bp, c


def build_rotor(turbine: dict, w, ir: int = 0) -> RotorModel:
    """Parse a turbine dict into a RotorModel (reference:
    raft_rotor.py:37-373)."""
    from scipy.interpolate import PchipInterpolator

    nrot = turbine.get("nrotors", 1)
    turbine = dict(turbine)
    turbine.setdefault("nrotors", nrot)

    if "rRNA" in turbine:
        r_rel = np.asarray(get_from_dict(turbine, "rRNA", shape=[nrot, 3]))[ir].astype(float)
    else:
        r_rel = np.array([0.0, 0.0, 100.0])
    overhang = float(np.atleast_1d(get_from_dict(turbine, "overhang", shape=nrot))[ir])
    xCG_RNA = float(np.atleast_1d(get_from_dict(turbine, "xCG_RNA", shape=nrot))[ir])
    mRNA = float(np.atleast_1d(get_from_dict(turbine, "mRNA", shape=nrot))[ir])
    IxRNA = float(np.atleast_1d(get_from_dict(turbine, "IxRNA", shape=nrot))[ir])
    IrRNA = float(np.atleast_1d(get_from_dict(turbine, "IrRNA", shape=nrot))[ir])
    speed_gain = float(np.atleast_1d(get_from_dict(turbine, "speed_gain", shape=nrot, default=1.0))[ir])
    nBlades = int(np.atleast_1d(get_from_dict(turbine, "nBlades", shape=nrot, dtype=int))[ir])
    yaw_mode = int(np.atleast_1d(get_from_dict(turbine, "yaw_mode", shape=nrot, dtype=int, default=0))[ir])
    azimuths = np.atleast_1d(np.asarray(
        get_from_dict(turbine, "headings", shape=-1,
                      default=list(np.arange(nBlades) * 360.0 / nBlades)), float))
    Rhub = float(np.atleast_1d(get_from_dict(turbine, "Rhub", shape=nrot))[ir])
    precone = float(np.atleast_1d(get_from_dict(turbine, "precone", shape=nrot))[ir])
    shaft_tilt = float(np.atleast_1d(get_from_dict(turbine, "shaft_tilt", shape=nrot))[ir]) * np.pi / 180
    shaft_toe = float(np.atleast_1d(get_from_dict(turbine, "shaft_toe", shape=nrot, default=0))[ir]) * np.pi / 180
    aeroServoMod = int(np.atleast_1d(get_from_dict(turbine, "aeroServoMod", shape=nrot, default=1))[ir])
    I_drivetrain = float(np.atleast_1d(get_from_dict(turbine, "I_drivetrain", shape=nrot))[ir])

    # initial axis/hub height (reference :99-112)
    q_rel = rotation_matrix_np(0.0, shaft_tilt, shaft_toe) @ np.array([1.0, 0.0, 0.0])
    if "hHub" in turbine:
        hHub = float(np.atleast_1d(get_from_dict(turbine, "hHub", shape=nrot))[ir])
        r_rel[2] = hHub - q_rel[2] * overhang
    hubHt = r_rel[2] + q_rel[2] * overhang

    blade = turbine["blade"]
    if isinstance(blade, dict):
        blade = [blade] * nrot
    wt_ops = turbine["wt_ops"]
    if isinstance(wt_ops, dict):
        wt_ops = [wt_ops] * nrot
    bl = blade[ir]
    Rtip = float(bl["Rtip"])

    Uhub = np.asarray(get_from_dict(wt_ops[ir], "v", shape=-1), float)
    Omega_rpm = np.asarray(get_from_dict(wt_ops[ir], "omega_op", shape=-1), float)
    pitch_deg = np.asarray(get_from_dict(wt_ops[ir], "pitch_op", shape=-1), float)
    # parked extension (reference :157-159)
    Uhub = np.r_[Uhub, Uhub.max() * 1.4, 100.0]
    Omega_rpm = np.r_[Omega_rpm, 0.0, 0.0]
    pitch_deg = np.r_[pitch_deg, 90.0, 90.0]

    # fluid properties by initial hub position (reference :323-330)
    underwater = (r_rel[2] + q_rel[2] * overhang) < 0
    if underwater:
        rho = float(turbine["rho_water"]); mu = float(turbine["mu_water"])
        shearExp = float(turbine["shearExp_water"])
    else:
        rho = float(turbine["rho_air"]); mu = float(turbine["mu_air"])
        shearExp = float(turbine["shearExp_air"])

    # ----- airfoil polar database (reference :179-296) -----
    station_airfoil = [b for [a, b] in bl["airfoils"]]
    station_position = np.array([a for [a, b] in bl["airfoils"]], float)
    n_aoa = 200
    aoa = np.unique(np.hstack([np.linspace(-180, -30, int(n_aoa / 4 + 1)),
                               np.linspace(-30, 30, int(n_aoa / 2)),
                               np.linspace(30, 180, int(n_aoa / 4 + 1))]))
    afs = turbine["airfoils"]
    names = [a["name"] for a in afs]
    thick = np.array([a["relative_thickness"] for a in afs], float)
    Ca_af = np.array([a.get("added_mass_coeff", [0.5, 1.0]) for a in afs], float)
    tables = {}
    for a in afs:
        # airfoils may differ in column count (5th cpmin column optional,
        # e.g. FOCTT_example.yaml) but each table must be internally
        # consistent — silently truncating would zero cpmin and disable
        # the cavitation check for that airfoil
        rows = [np.asarray(row, float) for row in a["data"]]
        ncols = {len(row) for row in rows}
        if len(ncols) != 1:
            raise ValueError(
                f"airfoil '{a.get('name')}' polar rows have inconsistent "
                f"column counts {sorted(ncols)}")
        ncol = ncols.pop()
        tab = np.stack(rows)
        cl = np.interp(aoa, tab[:, 0], tab[:, 1])
        cd = np.interp(aoa, tab[:, 0], tab[:, 2])
        cpm = np.interp(aoa, tab[:, 0], tab[:, 4]) if ncol > 4 else np.zeros_like(aoa)
        # enforce +-pi continuity as the reference does (:228-239)
        cl[0] = cl[-1]; cd[0] = cd[-1]; cpm[0] = cpm[-1]
        tables[a["name"]] = (cl, cd, cpm)

    nSector = int(get_from_dict(bl, "nSector", default=4))
    nr = int(get_from_dict(bl, "nr", default=20))
    grid = np.linspace(0.0, 1.0, nr, endpoint=False) + 0.5 / nr

    st_thick = np.array([thick[names.index(s)] for s in station_airfoil])
    st_Ca = np.array([Ca_af[names.index(s)] for s in station_airfoil])
    st_cl = np.array([tables[s][0] for s in station_airfoil])
    st_cd = np.array([tables[s][1] for s in station_airfoil])
    st_cpm = np.array([tables[s][2] for s in station_airfoil])

    if not np.all(st_thick == np.flip(np.sort(st_thick))):
        raise NotImplementedError("non-monotonic spanwise airfoil thickness")
    r_thick_interp = PchipInterpolator(station_position, st_thick)(grid)
    Ca_interp = PchipInterpolator(station_position, st_Ca)(grid)
    r_thick_unique, idx = np.unique(st_thick, return_index=True)
    cl_interp = np.flip(PchipInterpolator(r_thick_unique, st_cl[idx])(np.flip(r_thick_interp)), axis=0)
    cd_interp = np.flip(PchipInterpolator(r_thick_unique, st_cd[idx])(np.flip(r_thick_interp)), axis=0)
    cpm_interp = np.flip(PchipInterpolator(r_thick_unique, st_cpm[idx])(np.flip(r_thick_interp)), axis=0)

    # per-element smoothing-spline piecewise cubics (CCAirfoil equivalent:
    # RectBivariateSpline with s=0.1 on cl, s=0.001 on cd)
    aoa_rad = np.radians(aoa)
    cl_bps, cl_cs, cd_bps, cd_cs, cp_bps, cp_cs = [], [], [], [], [], []
    for i in range(nr):
        bp, c = _ppoly_from_smoothing_spline(aoa_rad, cl_interp[i], s=0.1)
        cl_bps.append(bp); cl_cs.append(c)
        bp, c = _ppoly_from_smoothing_spline(aoa_rad, cd_interp[i], s=0.001)
        cd_bps.append(bp); cd_cs.append(c)
        bp, c = _ppoly_from_smoothing_spline(aoa_rad, cpm_interp[i], s=0.1)
        cp_bps.append(bp); cp_cs.append(c)
    cl_bp, cl_c = _pad_ppoly(cl_bps, cl_cs)
    cd_bp, cd_c = _pad_ppoly(cd_bps, cd_cs)
    cp_bp, cp_c = _pad_ppoly(cp_bps, cp_cs)

    # blade element geometry (reference :309-320).  NOTE the reference's
    # element grid spans [Rhub, LAST GEOMETRY RADIUS] (raft_rotor.py:139
    # `rtip = geometry[-1][0]`, :312-315), NOT [Rhub, Rtip]: for IEA15MW
    # the geometry table ends at 116.94 m while Rtip=120.97 m, and CCBlade
    # still uses Rtip for the Prandtl tip loss and the hub/tip-padded
    # integration.  Replicating this (previously we spanned to Rtip) was
    # worth ~2.4% on thrust.
    gt = np.array(bl["geometry"], float)
    rtip_geom = float(gt[-1, 0])
    dr = (rtip_geom - Rhub) / nr
    blade_r = np.linspace(Rhub, rtip_geom, nr, endpoint=False) + dr / 2
    chord = np.interp(blade_r, gt[:, 0], gt[:, 1])
    theta = np.interp(blade_r, gt[:, 0], gt[:, 2])
    precurve = np.interp(blade_r, gt[:, 0], gt[:, 3])
    presweep = np.interp(blade_r, gt[:, 0], gt[:, 4])

    # control gains (reference :770-784)
    pc = turbine["pitch_control"]
    pc_angles = np.array(pc["GS_Angles"]) * _RAD2DEG
    kp_0 = np.interp(pitch_deg, pc_angles, pc["GS_Kp"], left=0, right=0)
    ki_0 = np.interp(pitch_deg, pc_angles, pc["GS_Ki"], left=0, right=0)
    k_float = -pc["Fl_Kp"]
    kp_tau = -turbine["torque_control"]["VS_KP"]
    ki_tau = -turbine["torque_control"]["VS_KI"]
    Ng = turbine["gear_ratio"]

    cone_r = np.radians(precone)
    R_rot = Rtip * np.cos(cone_r) + float(bl["precurveTip"]) * np.sin(cone_r)

    return RotorModel(
        r_rel=r_rel, overhang=overhang, xCG_RNA=xCG_RNA, mRNA=mRNA,
        IxRNA=IxRNA, IrRNA=IrRNA, speed_gain=speed_gain, nBlades=nBlades,
        yaw_mode=yaw_mode, azimuths=azimuths, shaft_tilt=shaft_tilt,
        shaft_toe=shaft_toe, aeroServoMod=aeroServoMod,
        I_drivetrain=I_drivetrain,
        Rhub=Rhub, Rtip=Rtip, R_rot=R_rot, precone=precone,
        blade_r=blade_r, chord=chord, theta_deg=theta,
        precurve=precurve, presweep=presweep,
        precurveTip=float(bl["precurveTip"]), presweepTip=float(bl["presweepTip"]),
        nSector=nSector, rho=rho, mu=mu, shearExp=shearExp, hubHt=hubHt,
        Uhub_ops=Uhub, Omega_rpm_ops=Omega_rpm, pitch_deg_ops=pitch_deg,
        kp_0=kp_0, ki_0=ki_0, k_float=k_float, kp_tau=kp_tau, ki_tau=ki_tau,
        Ng=float(Ng),
        cl_bp=cl_bp, cl_c=cl_c, cd_bp=cd_bp, cd_c=cd_c,
        cpmin_bp=cp_bp, cpmin_c=cp_c,
        Ca_interp=Ca_interp, r_thick_interp=r_thick_interp, aoa_grid=aoa_rad,
        q_rel0=q_rel,
    )


def _pad_ppoly(bps, cs):
    """Pad ragged per-element piecewise-cubic tables to a common segment
    count (repeating the last breakpoint; padded segments are never
    selected by searchsorted)."""
    nmax = max(len(b) for b in bps)
    bp = np.stack([np.pad(b, (0, nmax - len(b)), mode="edge") for b in bps])
    cc = np.stack([np.pad(c, ((0, nmax - 1 - len(c)), (0, 0)), mode="edge") for c in cs])
    return bp, cc


def rotation_matrix_np(x3, x2, x1):
    import numpy as _np
    s1, c1 = _np.sin(x1), _np.cos(x1)
    s2, c2 = _np.sin(x2), _np.cos(x2)
    s3, c3 = _np.sin(x3), _np.cos(x3)
    return _np.array([
        [c1 * c2, c1 * s2 * s3 - c3 * s1, s1 * s3 + c1 * c3 * s2],
        [c2 * s1, c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3],
        [-s2, c2 * s3, c2 * c3]])


# --------------------------------------------------------------------------
# device tables
# --------------------------------------------------------------------------

def _device(rot: RotorModel, *xs):
    for x in (rot.cl_c, *xs):
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _tab(rot, name, dev):
    return as_real(getattr(rot, name), dev)


# --------------------------------------------------------------------------
# polar evaluation (piecewise cubic, batched over elements)
# --------------------------------------------------------------------------

def _ppoly_eval(bp, c, x):
    """bp: (nr, nbp), c: (nr, nbp-1, 4), x: (..., nr) -> (..., nr); the
    per-element searchsorted runs as one batched torch.searchsorted."""
    xt = x.movedim(-1, 0).reshape(x.shape[-1], -1)         # (nr, m)
    xt = torch.clamp(xt, bp[:, :1], bp[:, -1:])
    idx = torch.searchsorted(bp, xt.detach().contiguous())
    idx = torch.clamp(idx - 1, 0, bp.shape[1] - 2)
    t = xt - torch.gather(bp, 1, idx)
    ci = torch.gather(c, 1, idx[:, :, None].expand(-1, -1, 4))
    out = ((ci[..., 0] * t + ci[..., 1]) * t + ci[..., 2]) * t + ci[..., 3]
    return out.reshape((x.shape[-1],) + x.shape[:-1]).movedim(0, -1)


# --------------------------------------------------------------------------
# BEM core (Ning 2014 single-residual formulation)
# --------------------------------------------------------------------------

def _define_curvature(r, precurve, presweep, precone_rad):
    """Azimuthal-frame coordinates and local cone angle of the blade axis
    (CCBlade's definecurvature)."""
    x_az = -r * math.sin(precone_rad) + precurve * math.cos(precone_rad)
    z_az = r * math.cos(precone_rad) + precurve * math.sin(precone_rad)
    y_az = presweep
    dx = x_az[1:] - x_az[:-1]
    dz = z_az[1:] - z_az[:-1]
    seg = torch.atan2(-dx, dz)
    cone = torch.cat([seg[:1], 0.5 * (seg[1:] + seg[:-1]), seg[-1:]])
    ds = torch.sqrt((x_az[1:] - x_az[:-1]) ** 2 + (y_az[1:] - y_az[:-1]) ** 2
                    + (z_az[1:] - z_az[:-1]) ** 2)
    s = torch.cat([torch.zeros(1, dtype=r.dtype, device=r.device),
                   torch.cumsum(ds, 0)])
    return x_az, y_az, z_az, cone, s


def _wind_components(rot: RotorModel, Uinf, Omega_rs, azimuth_rad, tilt,
                     yaw, dev):
    """Axial/tangential velocity at each element (CCBlade windcomponents);
    azimuth_rad (nS, 1) gives (nS, nr)."""
    r = _tab(rot, "blade_r", dev)
    x_az, y_az, z_az, cone, _ = _define_curvature(
        r, _tab(rot, "precurve", dev), _tab(rot, "presweep", dev),
        math.radians(rot.precone))
    sy, cy = torch.sin(yaw), torch.cos(yaw)
    st, ct = torch.sin(tilt), torch.cos(tilt)
    sa, ca = torch.sin(azimuth_rad), torch.cos(azimuth_rad)
    sc, cc = torch.sin(cone), torch.cos(cone)

    height = (y_az * sa + z_az * ca) * ct - x_az * st
    V = Uinf * (1.0 + height / rot.hubHt) ** rot.shearExp
    Vwind_x = V * ((cy * st * ca + sy * sa) * sc + cy * ct * cc)
    Vwind_y = V * (cy * st * sa - sy * ca)
    Vrot_x = -Omega_rs * y_az * sc
    Vrot_y = Omega_rs * z_az
    return Vwind_x + Vrot_x, Vwind_y + Vrot_y


def _signed_floor(x, floor):
    s = 1.0 - 2.0 * (x < 0).to(x.dtype)
    return s * torch.clamp(torch.abs(x), min=floor)


def _induction_residual(rot, phi, alpha_off, Vx, Vy, dev):
    """Ning (2014) residual + induction factors at inflow angle phi
    (elements on the last axis).  Returns (R, a, ap, cn, ct)."""
    sphi, cphi = torch.sin(phi), torch.cos(phi)
    alpha = phi - alpha_off
    cl = _ppoly_eval(_tab(rot, "cl_bp", dev), _tab(rot, "cl_c", dev), alpha)
    cd = _ppoly_eval(_tab(rot, "cd_bp", dev), _tab(rot, "cd_c", dev), alpha)
    cn = cl * cphi + cd * sphi
    ct = cl * sphi - cd * cphi

    r = _tab(rot, "blade_r", dev)
    B = rot.nBlades
    sigma_p = B / (2.0 * math.pi) * _tab(rot, "chord", dev) / r
    asphi = torch.clamp(torch.abs(sphi), min=1e-9)
    ftip = B / 2.0 * (rot.Rtip - r) / (r * asphi)
    Ftip = 2.0 / math.pi * torch.arccos(torch.clamp(torch.exp(-ftip), -1.0, 1.0))
    fhub = B / 2.0 * (r - rot.Rhub) / (rot.Rhub * asphi)
    Fhub = 2.0 / math.pi * torch.arccos(torch.clamp(torch.exp(-fhub), -1.0, 1.0))
    F = torch.clamp(Ftip * Fhub, min=1e-9)

    sphi_safe = _signed_floor(sphi, 1e-12)
    cphi_safe = _signed_floor(cphi, 1e-12)
    k = sigma_p * cn / (4.0 * F * sphi_safe * sphi_safe)
    kp = sigma_p * ct / (4.0 * F * sphi_safe * cphi_safe)

    # axial induction: momentum region / Buhl empirical region (phi>0)
    g1 = 2.0 * F * k - (10.0 / 9.0 - F)
    g2 = torch.clamp(2.0 * F * k - (4.0 / 3.0 - F) * F, min=1e-12)
    g3 = 2.0 * F * k - (25.0 / 9.0 - 2.0 * F)
    g3_safe = torch.where(torch.abs(g3) < 1e-6, 1.0, g3)
    a_buhl = torch.where(torch.abs(g3) < 1e-6,
                         1.0 - 1.0 / (2.0 * torch.sqrt(g2)),
                         (g1 - torch.sqrt(g2)) / g3_safe)
    a_mom = k / _signed_floor(1.0 + k, 1e-12)
    a_pos = torch.where(k <= 2.0 / 3.0, a_mom, a_buhl)
    # propeller-brake region (phi<0)
    a_neg = torch.where(k > 1.0, k / _signed_floor(k - 1.0, 1e-12), 0.0)
    a = torch.where(phi > 0, a_pos, a_neg)

    ap = kp / _signed_floor(1.0 - kp, 1e-12)

    Vx_safe = _signed_floor(Vx, 1e-9)
    Vy_safe = _signed_floor(Vy, 1e-9)
    lam = Vy_safe / Vx_safe
    one_m_a = _signed_floor(1.0 - a, 1e-12)
    R_pos = sphi / one_m_a - cphi / lam * (1.0 - kp)
    R_neg = sphi * (1.0 - k) - cphi / lam * (1.0 - kp)
    R = torch.where(phi > 0, R_pos, R_neg)
    return R, a, ap, cn, ct


def _solve_phi(rot, alpha_off, Vx, Vy, dev):
    """Bracketed bisection (CCBlade's interval strategy), held out of
    differentiation, then a differentiable Newton polish."""
    def res(phi):
        return _induction_residual(rot, phi, alpha_off, Vx, Vy, dev)[0]

    # the bracket and the bisection carry no derivative (the JAX
    # package's stop_gradient): evaluate them on detached inputs, which
    # gives the same iterates without dragging tangents through 60 steps
    a0, vx0, vy0 = alpha_off.detach(), Vx.detach(), Vy.detach()

    def res0(phi):
        return _induction_residual(rot, phi, a0, vx0, vy0, dev)[0]

    eps = _EPS_PHI
    full = lambda v: torch.full(Vx.shape, v, dtype=torch.float64,  # noqa: E731
                                device=dev)
    lo1, hi1 = full(eps), full(math.pi / 2)
    lo2, hi2 = full(-math.pi / 4), full(-eps)
    lo3, hi3 = full(math.pi / 2), full(math.pi - eps)
    r1lo, r1hi = res0(lo1), res0(hi1)
    r2lo, r2hi = res0(lo2), res0(hi2)
    use1 = r1lo * r1hi <= 0.0
    use2 = (~use1) & (r2lo * r2hi <= 0.0)
    lo = torch.where(use1, lo1, torch.where(use2, lo2, lo3))
    hi = torch.where(use1, hi1, torch.where(use2, hi2, hi3))
    rlo = res0(lo)
    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        rmid = res0(mid)
        go_lo = rlo * rmid <= 0.0
        lo, hi, rlo = (torch.where(go_lo, lo, mid), torch.where(go_lo, mid, hi),
                       torch.where(go_lo, rlo, rmid))
    phi = 0.5 * (lo + hi)

    # Newton polish (differentiable; restores implicit-function gradients)
    for _ in range(_N_NEWTON):
        r, dr = torch.func.jvp(res, (phi,), (torch.ones_like(phi),))
        dr_safe = torch.where(torch.abs(dr) < 1e-14, 1e-14, dr)
        step = torch.clamp(r / dr_safe, -0.05, 0.05)
        phi = phi - step
    return phi


def _distributed_loads(rot: RotorModel, Uinf, Omega_rpm, pitch_deg,
                       azimuth_deg, tilt, yaw, dev):
    """Np, Tp (N/m) along the blade at each azimuth (nS, nr), plus W and
    alpha."""
    Omega_rs = Omega_rpm * _RPM2RS
    az = torch.deg2rad(azimuth_deg)[:, None]
    Vx, Vy = _wind_components(rot, Uinf, Omega_rs, az, tilt, yaw, dev)
    alpha_off = torch.deg2rad(_tab(rot, "theta_deg", dev) + pitch_deg)
    alpha_off = torch.broadcast_to(alpha_off, Vx.shape)
    phi = _solve_phi(rot, alpha_off, Vx, Vy, dev)
    _, a, ap, cn, ct = _induction_residual(rot, phi, alpha_off, Vx, Vy, dev)
    W2 = (Vx * (1.0 - a)) ** 2 + (Vy * (1.0 + ap)) ** 2
    chord = _tab(rot, "chord", dev)
    Np = cn * 0.5 * rot.rho * W2 * chord
    Tp = ct * 0.5 * rot.rho * W2 * chord
    return Np, Tp, torch.sqrt(W2), phi - alpha_off


def _trapezoid(y, x, dim):
    """jnp.trapezoid of y against x (n,) along axis ``dim`` of y."""
    dx = x[1:] - x[:-1]
    y = y.movedim(dim, -1)
    return 0.5 * torch.sum(dx * (y[..., 1:] + y[..., :-1]), dim=-1)


def _hub_loads(rot: RotorModel, Np, Tp, azimuth_deg, dev):
    """Integrate each azimuth's distributed loads (with hub/tip zero
    padding) along the curved blade path and express force/moment in the
    hub frame with CCBlade's component conventions (see the JAX module's
    _hub_loads_one_azimuth).  Np, Tp (nS, nr) -> F, M (nS, 3)."""
    nS = Np.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    r = _tab(rot, "blade_r", dev)
    rfull = torch.cat([as_real([rot.Rhub], dev), r,
                       as_real([rot.Rtip], dev)])
    curve = torch.cat([torch.zeros(1, **f64), _tab(rot, "precurve", dev),
                       as_real([rot.precurveTip], dev)])
    sweep = torch.cat([torch.zeros(1, **f64), _tab(rot, "presweep", dev),
                       as_real([rot.presweepTip], dev)])
    z1 = torch.zeros_like(Np[:, :1])
    Npf = torch.cat([z1, Np, z1], dim=1)
    Tpf = torch.cat([z1, Tp, z1], dim=1)
    x_az, y_az, z_az, cone, s = _define_curvature(rfull, curve, sweep,
                                                  math.radians(rot.precone))
    f = torch.stack([Npf * torch.cos(cone), -Tpf, Npf * torch.sin(cone)],
                    dim=-1)                                  # (nS, nr+2, 3)
    F_az = _trapezoid(f, s, dim=-2)
    M_az = torch.stack([_trapezoid(Tpf * z_az, s, -1), _trapezoid(Npf * z_az, s, -1),
                        torch.zeros(nS, **f64)], dim=-1)
    psi = torch.deg2rad(azimuth_deg)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    one, zero = torch.ones_like(psi), torch.zeros_like(psi)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cpsi, spsi], -1),
                      torch.stack([zero, -spsi, cpsi], -1)], -2)
    return (Rx @ F_az[..., None])[..., 0], (Rx @ M_az[..., None])[..., 0]


def bem_evaluate(rot: RotorModel, Uinf, Omega_rpm, pitch_deg,
                 tilt=0.0, yaw=0.0):
    """Azimuth-averaged hub loads: dict(T, Y, Z, Q, My, Mz, P) over
    nSector azimuth sectors (ccblade.evaluate).  Differentiable w.r.t.
    (Uinf, Omega_rpm, pitch_deg)."""
    dev = _device(rot, Uinf, Omega_rpm, pitch_deg, tilt, yaw)
    tilt = as_real(tilt, dev) if not isinstance(tilt, torch.Tensor) else tilt
    yaw = as_real(yaw, dev) if not isinstance(yaw, torch.Tensor) else yaw
    azimuths = torch.arange(rot.nSector, dtype=torch.float64, device=dev) \
        * (360.0 / rot.nSector)
    Np, Tp, _, _ = _distributed_loads(rot, Uinf, Omega_rpm, pitch_deg,
                                      azimuths, tilt, yaw, dev)
    F, M = _hub_loads(rot, Np, Tp, azimuths, dev)
    F = rot.nBlades * torch.mean(F, dim=0)
    M = rot.nBlades * torch.mean(M, dim=0)
    Omega_rs = Omega_rpm * _RPM2RS
    return dict(T=F[0], Y=-F[1], Z=F[2], Q=M[0], My=M[1], Mz=-M[2],
                P=M[0] * Omega_rs)


def bem_thrust_torque_derivs(rot: RotorModel, Uinf, Omega_rpm, pitch_deg,
                             tilt=0.0, yaw=0.0):
    """(T, Q) and their Jacobian w.r.t. (Uinf, Omega_rpm, pitch_deg) by
    forward-mode autodiff (``torch.func.jacfwd``)."""
    dev = _device(rot, Uinf, Omega_rpm, pitch_deg, tilt, yaw)

    def tq(x):
        out = bem_evaluate(rot, x[0], x[1], x[2], tilt, yaw)
        return torch.stack([out["T"], out["Q"]])

    x = torch.stack([as_real(Uinf, dev), as_real(Omega_rpm, dev),
                     as_real(pitch_deg, dev)])
    TQ = tq(x)
    J = torch.func.jacfwd(tq)(x)
    return TQ, J


# --------------------------------------------------------------------------
# IEC Kaimal rotor-averaged spectrum
# --------------------------------------------------------------------------

_IEC_VREF = {"I": 50.0, "II": 42.5, "III": 37.5, "IV": 30.0}
_IEC_IREF = {"A+": 0.18, "A": 0.16, "B": 0.14, "C": 0.12}


def turbulence_sigma(turbulence, speed, turbine_class="I",
                     turbulence_class="B"):
    """sigma_1 from the IEC 61400-1 models (host-side).  ``turbulence``
    is a float TI (NTM with I_ref=TI) or a string like 'IB_NTM'."""
    if isinstance(turbulence, str):
        cls = ""
        for ch in turbulence:
            if ch in ("I", "V"):
                cls += ch
            else:
                break
        if not cls:
            I_ref = float(turbulence)
            model = "NTM"
            V_ave = _IEC_VREF[turbine_class] * 0.2
        else:
            categ = turbulence[len(cls)]
            model = turbulence.split("_")[1]
            I_ref = _IEC_IREF[categ]
            V_ave = _IEC_VREF[cls] * 0.2
    else:
        I_ref = float(turbulence)
        model = "NTM"
        V_ave = _IEC_VREF[turbine_class] * 0.2

    if model == "NTM":
        return I_ref * (0.75 * speed + 5.6)
    if model == "ETM":
        c = 2.0
        return c * I_ref * (0.072 * (V_ave / c + 3) * (speed / c - 4) + 10)
    if model == "EWM":
        return 0.11 * speed
    raise ValueError(f"unknown turbulence model {model}")


def kaimal_spectra(w, speed, HH, R, sigma_1):
    """IEC Kaimal spectra U, V, W plus the rotor-averaged Rot spectrum
    [(m/s)^2/(rad/s)] (reference: raft_rotor.py:1195-1223)."""
    w = as_real(w)
    HH = as_real(HH, w.device)
    f = w / (2.0 * math.pi)
    L_1 = torch.where(HH <= 60.0, 0.7 * HH, 42.0)
    sigma_u, L_u = sigma_1, 8.1 * L_1
    sigma_v, L_v = 0.8 * sigma_1, 2.7 * L_1
    sigma_w, L_w = 0.5 * sigma_1, 0.66 * L_1
    U = (4 * L_u / speed) * sigma_u**2 / (1 + 6 * f * L_u / speed) ** (5.0 / 3.0)
    V = (4 * L_v / speed) * sigma_v**2 / (1 + 6 * f * L_v / speed) ** (5.0 / 3.0)
    W = (4 * L_w / speed) * sigma_w**2 / (1 + 6 * f * L_w / speed) ** (5.0 / 3.0)
    kappa = 12.0 * torch.sqrt((f / speed) ** 2 + (0.12 / L_u) ** 2)
    x = 2.0 * R * kappa
    d1 = struve_bessel_diff_1(x)
    dm2 = struve_bessel_diff_m2(x)
    Rk = R * kappa
    Rot = (2.0 * U / Rk**3) * (d1 - 2.0 / math.pi + Rk * (-2.0 * dm2 + 1.0))
    Rot = torch.where(torch.isfinite(Rot), Rot, 0.0)
    return U, V, W, Rot


# --------------------------------------------------------------------------
# pose / yaw
# --------------------------------------------------------------------------

def rotor_pose(rot: RotorModel, r6, inflow_heading=0.0,
               turbine_heading=0.0, yaw_command=0.0):
    """Rotor orientation under a platform pose and yaw mode (reference:
    raft_rotor.py:376-460).  Returns dict(R_ptfm, R_q, q, q_rel, r_hub,
    yaw); angles in radians."""
    r6 = as_real(r6)
    dev = r6.device
    R_ptfm = rotation_matrix(r6[3], r6[4], r6[5])
    platform_heading = r6[5]
    if rot.yaw_mode == 0:
        yaw = inflow_heading - platform_heading + yaw_command
    elif rot.yaw_mode == 1:
        yaw = turbine_heading - platform_heading
    elif rot.yaw_mode == 2:
        yaw = as_real(yaw_command, dev)
    elif rot.yaw_mode == 3:
        yaw = yaw_command - platform_heading
    else:
        raise ValueError("yaw_mode must be 0..3")
    R_q_rel = rotation_matrix(as_real(0.0, dev), rot.shaft_tilt,
                              rot.shaft_toe + yaw)
    # the reference composes R_q = R_q_rel @ R_ptfm (raft_rotor.py:454)
    R_q = R_q_rel @ R_ptfm
    q_rel = R_q_rel[:, 0]
    q = R_ptfm @ q_rel
    r_RRP_rel = R_ptfm @ as_real(rot.r_rel, dev)
    r_hub_rel = r_RRP_rel + q * rot.overhang
    r_hub = r6[:3] + r_hub_rel
    return dict(R_ptfm=R_ptfm, R_q=R_q, q=q, q_rel=q_rel, r_hub=r_hub,
                yaw=yaw)


# --------------------------------------------------------------------------
# aero-servo linearization
# --------------------------------------------------------------------------

def calc_aero(rot: RotorModel, w, case: dict, r6=None, current=False):
    """Mean loads + frequency-domain aero matrices (reference:
    raft_rotor.py:788-1005).  w (nw,) tensor (its device is the result's).

    Returns dict(f0 (6,), f (6,nw) complex, a (6,6,nw), b (6,6,nw),
    C (nw,) control transfer function, pose, V_w, loads, op, derivs)."""
    w = as_real(w)
    dev = w.device
    nw = w.shape[0]
    f64 = dict(dtype=torch.float64, device=dev)
    r6 = torch.zeros(6, **f64) if r6 is None else as_real(r6, dev)
    if current:
        speed = float(get_from_dict(case, "current_speed", shape=0, default=1.0))
        heading = float(get_from_dict(case, "current_heading", shape=0, default=0.0))
        turb = case.get("current_turbulence", 0.0)
    else:
        speed = float(get_from_dict(case, "wind_speed", shape=0, default=10.0))
        heading = float(get_from_dict(case, "wind_heading", shape=0, default=0.0))
        turb = case.get("turbulence", 0.0)

    inflow_heading = np.radians(heading)
    turbine_heading = np.radians(float(get_from_dict(case, "turbine_heading", shape=0, default=0.0)))
    yaw_command = np.radians(float(get_from_dict(case, "yaw_misalign", shape=0, default=0.0)))

    pose = rotor_pose(rot, r6, inflow_heading=inflow_heading,
                      turbine_heading=turbine_heading, yaw_command=yaw_command)
    q = pose["q"]
    yaw_misalign = torch.atan2(q[1], q[0]) - inflow_heading
    turbine_tilt = torch.atan2(q[2], torch.hypot(q[0], q[1]))

    # operating point (reference :714-718); the schedule stays on the host
    Uhub = speed * rot.speed_gain
    Omega_rpm = float(np.interp(Uhub, np.asarray(rot.Uhub_ops),
                                np.asarray(rot.Omega_rpm_ops)))
    pitch_deg = float(np.interp(Uhub, np.asarray(rot.Uhub_ops),
                                np.asarray(rot.pitch_deg_ops)))
    Uhub_t = as_real(Uhub, dev)
    Om_t = as_real(Omega_rpm, dev)
    pi_t = as_real(pitch_deg, dev)

    loads = bem_evaluate(rot, Uhub_t, Om_t, pi_t, tilt=turbine_tilt,
                         yaw=yaw_misalign)
    TQ, J = bem_thrust_torque_derivs(rot, Uhub_t, Om_t, pi_t,
                                     tilt=turbine_tilt, yaw=yaw_misalign)
    dT_dU = J[0, 0]
    dT_dOm = J[0, 1] / _RPM2RADPS
    dT_dPi = J[0, 2] * _RAD2DEG
    dQ_dU = J[1, 0]
    dQ_dOm = J[1, 1] / _RPM2RADPS
    dQ_dPi = J[1, 2] * _RAD2DEG

    R_q = pose["R_q"]
    f0 = torch.cat([
        R_q @ torch.stack([loads["T"], loads["Y"], loads["Z"]]),
        R_q @ torch.stack([loads["My"], loads["Q"], loads["Mz"]]),
    ])

    # rotor-averaged turbulence spectrum -> wave-like amplitudes
    HH = torch.abs(pose["r_hub"][2])
    sigma_1 = turbulence_sigma(turb, speed)
    _, _, _, S_rot = kaimal_spectra(w, speed, HH, rot.R_rot, sigma_1)
    V_w = torch.sqrt(S_rot).to(torch.complex128)

    a = torch.zeros((6, 6, nw), **f64)
    b = torch.zeros((6, 6, nw), **f64)
    fvec = torch.zeros((6, nw), dtype=torch.complex128, device=dev)
    C = torch.zeros(nw, dtype=torch.complex128, device=dev)
    zf = None

    if rot.aeroServoMod == 1:
        b_inflow = torch.zeros((6, 6, nw), **f64)
        b_inflow[0, 0, :] = dT_dU
        a = rotate_matrix_6(a.movedim(-1, 0), R_q).movedim(0, -1)
        b = rotate_matrix_6(b_inflow.movedim(-1, 0), R_q).movedim(0, -1)
        f_inflow = dT_dU * V_w
        zf = torch.zeros_like(f_inflow)
        fvec[:3, :] = R_q.to(torch.complex128) @ torch.stack([f_inflow, zf, zf])
    elif rot.aeroServoMod == 2:
        kp_beta = -float(np.interp(speed, np.asarray(rot.Uhub_ops),
                                   np.asarray(rot.kp_0)))
        ki_beta = -float(np.interp(speed, np.asarray(rot.Uhub_ops),
                                   np.asarray(rot.ki_0)))
        kp_tau = rot.kp_tau * (kp_beta == 0)
        ki_tau = rot.ki_tau * (ki_beta == 0)
        zhub = pose["r_hub"][2]

        D = (rot.I_drivetrain * w**2
             + (dQ_dOm + kp_beta * dQ_dPi - rot.Ng * kp_tau) * 1j * w
             + ki_beta * dQ_dPi - rot.Ng * ki_tau)
        C = 1j * w * (dQ_dU - rot.k_float * dQ_dPi / zhub) / D
        H_QT = ((dT_dOm + kp_beta * dT_dPi) * 1j * w + ki_beta * dT_dPi) / D
        f2 = (dT_dU - H_QT * dQ_dU) * V_w
        b2 = torch.real(dT_dU - rot.k_float * dT_dPi
                        - H_QT * (dQ_dU - rot.k_float * dQ_dPi))
        a2 = torch.real((dT_dU - rot.k_float * dT_dPi
                         - H_QT * (dQ_dU - rot.k_float * dQ_dPi)) / (1j * w))

        diag_a = torch.zeros((nw, 3, 3), **f64)
        diag_a[:, 0, 0] = a2
        diag_b = torch.zeros((nw, 3, 3), **f64)
        diag_b[:, 0, 0] = b2
        a[:3, :3, :] = rotate_matrix_3(diag_a, R_q).movedim(0, -1)
        b[:3, :3, :] = rotate_matrix_3(diag_b, R_q).movedim(0, -1)
        zf = torch.zeros_like(f2)
        fvec[:3, :] = R_q.to(torch.complex128) @ torch.stack([f2, zf, zf])
    # aeroServoMod == 0: all zeros

    return dict(f0=f0, f=fvec, a=a, b=b, C=C, pose=pose, V_w=V_w,
                loads=loads, op=dict(U=Uhub, Omega_rpm=Omega_rpm,
                                     pitch_deg=pitch_deg),
                derivs=dict(dT_dU=dT_dU, dT_dOm=dT_dOm, dT_dPi=dT_dPi,
                            dQ_dU=dQ_dU, dQ_dOm=dQ_dOm, dQ_dPi=dQ_dPi))


# --------------------------------------------------------------------------
# underwater rotors (MHK): blade members + cavitation
# --------------------------------------------------------------------------

def _rodrigues_np(az_deg, axis):
    """Rotation matrix about ``axis`` by the blade azimuth angle
    (reference: raft_rotor.py:565-583 getBladeMemberPositions)."""
    c = np.cos(np.deg2rad(az_deg))
    s = np.sin(np.deg2rad(az_deg))
    a = np.asarray(axis, float)
    return np.array([
        [c + a[0]**2*(1-c), a[0]*a[1]*(1-c) - a[2]*s, a[0]*a[2]*(1-c) + a[1]*s],
        [a[1]*a[0]*(1-c) + a[2]*s, c + a[1]**2*(1-c), a[1]*a[2]*(1-c) - a[0]*s],
        [a[2]*a[0]*(1-c) - a[1]*s, a[2]*a[1]*(1-c) + a[0]*s, c + a[2]**2*(1-c)]])


def _host(x):
    """A host numpy copy of a rotor table (numpy, or a tensor anywhere)."""
    if isinstance(x, torch.Tensor):
        from raft_tpu_torch.obs import transfers
        return transfers.device_get(x, what="rotor_table")
    return np.asarray(x, float)


def _blade_dir0(rot: RotorModel):
    """(rotor axis q, azimuth-zero blade direction): the axis turned 90
    degrees about z (reference: raft_rotor.py:530 airfoil_zero_heading)."""
    q = np.asarray(rot.q_rel0, float)
    return q, np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                        [0.0, 0.0, 1.0]]) @ q


def blade_member_dicts(rot: RotorModel):
    """Rectangular member dicts for each blade element of a submerged
    rotor, one set per blade at its build azimuth, in the PLATFORM frame
    (host numpy at build time, as in the JAX package; reference:
    raft_rotor.py:522-562 bladeGeometry2Member, raft_fowt.py:384-444,
    which rotate per azimuth at use time — here the rotation is baked in
    so the members join the stacked strip-node set).

    Each element is a rect member of chord x equivalent-area thickness
    with the blade twist as gamma, the airfoil's added-mass pair and
    Cd 0; the last element is skipped (the reference's
    ``range(len(blade_r) - 1)``)."""
    q, dir0 = _blade_dir0(rot)
    r_hub_rel = np.asarray(rot.r_rel, float) + q * rot.overhang
    # (the rotor's tables may already be tensors on a device)
    blade_r, chord_r, theta = (_host(getattr(rot, k)) for k in (
        "blade_r", "chord", "theta_deg"))
    dr = float(blade_r[1] - blade_r[0])
    mems = []
    for az in np.atleast_1d(rot.azimuths):
        R = _rodrigues_np(float(az), q)
        for i in range(len(blade_r) - 1):
            chord = float(chord_r[i])
            rect_thick = (np.pi / 4.0) * chord * float(rot.r_thick_interp[i])
            rA = r_hub_rel + R @ (dir0 * (blade_r[i] - dr / 2.0))
            rB = r_hub_rel + R @ (dir0 * (blade_r[i] + dr / 2.0))
            mems.append(dict(
                name="blade", type=3, rA=rA, rB=rB, shape="rect",
                stations=[0, 1],
                d=[[chord, rect_thick], [chord, rect_thick]],
                gamma=float(theta[i]), potMod=False,
                Cd=0.0, Ca=list(np.atleast_1d(rot.Ca_interp[i])),
                CdEnd=0.0, CaEnd=0.0, t=0.01, rho_shell=1850.0))
    return mems


def calc_cavitation(rot: RotorModel, case: dict, clearance_margin=1.0,
                    Patm=101325.0, Pvap=2500.0, error_on_cavitation=False):
    """Cavitation check of a submerged rotor (reference: raft_rotor.py:
    639-696 calcCavitation): for each blade (azimuth) and element, the BEM
    at the case current gives the relative speed W and angle of attack;
    the airfoil's minimum pressure coefficient is compared with the
    critical cavitation number sigma_crit = (Patm + rho g |z| - Pvap) /
    (0.5 rho W^2).  Float64 on the rotor's device, every azimuth in one
    BEM call; returns host numpy (nBlades, nr): negative entries
    cavitate.  Cavitation warns, or raises ``ValueError`` with
    ``error_on_cavitation``."""
    if rot.hubHt >= 0:
        raise ValueError("Hub depth must be below the water surface to "
                         "calculate cavitation")
    dev = _device(rot)
    f64 = dict(dtype=torch.float64, device=dev)
    Uhub = float(get_from_dict(case, "current_speed", shape=0, default=0.0)) \
        * rot.speed_gain
    Omega_rpm = float(np.interp(Uhub, np.asarray(rot.Uhub_ops),
                                np.asarray(rot.Omega_rpm_ops)))
    pitch_deg = float(np.interp(Uhub, np.asarray(rot.Uhub_ops),
                                np.asarray(rot.pitch_deg_ops)))
    q, dir0 = _blade_dir0(rot)
    azimuths = np.atleast_1d(np.asarray(rot.azimuths, float))
    # tilt seen by the BEM is -shaft_tilt (q[2] = -sin(shaft_tilt))
    _, _, W, alpha = _distributed_loads(
        rot, torch.tensor(Uhub, **f64), torch.tensor(Omega_rpm, **f64),
        torch.tensor(pitch_deg, **f64), torch.tensor(azimuths, **f64),
        torch.tensor(-rot.shaft_tilt, **f64), torch.zeros((), **f64), dev)
    cpmin = _ppoly_eval(_tab(rot, "cpmin_bp", dev), _tab(rot, "cpmin_c", dev),
                        alpha)
    # node depths at the zero-offset pose, per azimuth (nA, nr)
    zdir = np.stack([(_rodrigues_np(float(az), q) @ dir0)[2]
                     for az in azimuths])
    z = rot.hubHt + torch.tensor(zdir, **f64)[:, None] \
        * _tab(rot, "blade_r", dev)[None, :] * clearance_margin
    sigma_crit = (Patm + rot.rho * 9.81 * torch.abs(z) - Pvap) \
        / torch.clamp(0.5 * rot.rho * W**2, min=1e-9)
    from raft_tpu_torch.obs import transfers
    cav = transfers.device_get(sigma_crit + cpmin, what="cavitation")
    if np.any(cav < 0.0):
        if error_on_cavitation:
            raise ValueError("Cavitation occurred at a blade node")
        import warnings
        warnings.warn("Cavitation check found a blade node with cavitation "
                      "occurring", stacklevel=2)
    return cav
