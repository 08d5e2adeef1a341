"""Quasi-static catenary mooring as differentiable tensor kernels.

Port of the simple-topology (anchor -> fairlead) path of
``raft_tpu/models/mooring.py`` (reference: the MoorPy subset of
raft/raft_fowt.py:166-189, 275-288 and raft/raft_model.py:801-803).  A
mooring system is a static `MooringSystem` of per-line arrays; each
line's fairlead force comes from the two-branch elastic catenary
(frictionless seabed) solved by a FIXED 40-step Newton loop, so the 6x6
coupled stiffness and the tension Jacobian are exact
``torch.func.jacfwd``s of the wrench.  Shared array moorings (free points,
multi-segment lines) are not part of this slice.

Catenary equations (Jonkman 2007, MAP/MoorPy lineage), fairlead force
(H, V), spans XF/ZF, unstretched length L, axial stiffness EA, submerged
weight per length w:

  no seabed contact (V >= wL):
    XF = (H/w)[asinh(V/H) - asinh((V-wL)/H)] + HL/EA
    ZF = (H/w)[sqrt(1+(V/H)^2) - sqrt(1+((V-wL)/H)^2)] + (VL - wL^2/2)/EA
  partial seabed contact (V < wL):
    XF = (L - V/w) + (H/w) asinh(V/H) + HL/EA
    ZF = (H/w)[sqrt(1+(V/H)^2) - 1] + V^2/(2 EA w)
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch._config import as_real
from raft_tpu_torch.ops.transforms import rotation_matrix, translate_force_3to6

_G = 9.81
_RHO = 1025.0
_NEWTON_ITERS = 40


@dataclass
class MooringSystem:
    """Static description of one body's mooring: numpy arrays at parse
    time, device tensors after ``convert.state_from_numpy``."""

    depth: float
    rAnchor: np.ndarray      # (nl,3) anchor positions, global
    rFair0: np.ndarray       # (nl,3) fairlead positions in the body frame
    L: np.ndarray            # (nl,) unstretched lengths
    EA: np.ndarray           # (nl,) axial stiffness
    w: np.ndarray            # (nl,) submerged weight per length [N/m]
    d_vol: np.ndarray        # (nl,) volume-equivalent diameter
    m_lin: np.ndarray        # (nl,) mass per length
    Cd_t: np.ndarray         # (nl,) transverse drag coefficient
    Cd_a: np.ndarray         # (nl,) tangential drag coefficient
    rho: float = _RHO        # water density (for line current drag)

    @property
    def n_lines(self) -> int:
        return len(self.L)


def parse_mooring(moor: dict, rho: float = _RHO, g: float = _G,
                  trans=(0.0, 0.0), rot: float = 0.0):
    """Build a simple-topology mooring system from the design['mooring']
    YAML dict (points fixed|vessel, lines endA/endB, line_types).
    ``trans``/``rot`` apply the reference's array-placement transform:
    rotate about z by ``rot`` degrees, then translate anchors in x, y."""
    depth = float(moor["water_depth"])
    types = {lt["name"]: lt for lt in moor["line_types"]}
    points = {p["name"]: p for p in moor["points"]}

    c, s = np.cos(np.deg2rad(rot)), np.sin(np.deg2rad(rot))
    Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def ptype(p):
        t = p["type"].lower()
        if t.startswith("vessel") or t.startswith("body") \
                or t.startswith("coupled"):
            return "vessel"
        if t.startswith("free") or t.startswith("connect"):
            return "free"
        return "fixed"

    simple = all(
        {ptype(points[ln["endA"]]), ptype(points[ln["endB"]])}
        == {"fixed", "vessel"}
        for ln in moor["lines"])
    if not simple:
        raise errors.ModelConfigError(
            "mooring systems with free points or multi-segment lines are "
            "not part of the PyTorch port yet (simple anchor->fairlead "
            "topologies only)")

    rAnchor, rFair0 = [], []
    L, EA, w, d_vol, m_lin, Cd_t, Cd_a = [], [], [], [], [], [], []
    for ln in moor["lines"]:
        pA, pB = points[ln["endA"]], points[ln["endB"]]
        if ptype(pA) == "vessel":
            pA, pB = pB, pA
        anchor = Rz @ np.array(pA["location"], float)
        anchor[0] += trans[0]
        anchor[1] += trans[1]
        fair = Rz @ np.array(pB["location"], float)
        rAnchor.append(anchor)
        rFair0.append(fair)
        lt = types[ln["type"]]
        d = float(lt["diameter"])
        m = float(lt["mass_density"])
        L.append(float(ln["length"]))
        EA.append(float(lt["stiffness"]))
        w.append((m - rho * np.pi / 4 * d**2) * g)
        d_vol.append(d)
        m_lin.append(m)
        Cd_t.append(float(lt.get("transverse_drag", 0.0)))
        Cd_a.append(float(lt.get("tangential_drag", 0.0)))

    return MooringSystem(
        depth=depth,
        rAnchor=np.array(rAnchor), rFair0=np.array(rFair0),
        L=np.array(L), EA=np.array(EA), w=np.array(w),
        d_vol=np.array(d_vol), m_lin=np.array(m_lin),
        Cd_t=np.array(Cd_t), Cd_a=np.array(Cd_a), rho=rho,
    )


# --------------------------------------------------------------------------
# catenary kernel
# --------------------------------------------------------------------------

def _profile_spans(H, V, L, EA, w, contact_allowed=True):
    """(XF, ZF) reached by a line with fairlead force (H, V) and their
    partial derivatives (dXF/dH, dXF/dV, dZF/dH, dZF/dV); both seabed
    branches evaluated and selected by mask."""
    Hm = H > 1e-8
    H = torch.clamp(H, min=1e-8)
    Va = V - w * L
    vh, vah = V / H, Va / H
    s1 = torch.sqrt(1.0 + vh ** 2)
    s2 = torch.sqrt(1.0 + vah ** 2)
    a1, a2 = torch.asinh(vh), torch.asinh(vah)
    LE = L / EA
    # fully suspended
    XF_s = (H / w) * (a1 - a2) + H * LE
    ZF_s = (H / w) * (s1 - s2) + (V * L - 0.5 * w * L**2) / EA
    dXs_dH = (a1 - a2) / w - (vh / s1 - vah / s2) / w + LE
    dXs_dV = (1.0 / s1 - 1.0 / s2) / w
    dZs_dH = (s1 - s2) / w - (vh ** 2 / s1 - vah ** 2 / s2) / w
    dZs_dV = (vh / s1 - vah / s2) / w + LE
    # partial seabed contact (frictionless): length L - V/w on the bottom
    LB = L - V / w
    XF_c = LB + (H / w) * a1 + H * LE
    ZF_c = (H / w) * (s1 - 1.0) + V**2 / (2.0 * EA * w)
    dXc_dH = a1 / w - (vh / s1) / w + LE
    dXc_dV = -1.0 / w + (1.0 / s1) / w
    dZc_dH = (s1 - 1.0) / w - (vh ** 2 / s1) / w
    dZc_dV = (vh / s1) / w + V / (EA * w)
    contact = V < w * L
    if not contact_allowed:
        contact = torch.zeros_like(contact)
    Hf = Hm.to(H.dtype)          # d clamp(H)/dH
    sel = lambda c, s: torch.where(contact, c, s)  # noqa: E731
    return (sel(XF_c, XF_s), sel(ZF_c, ZF_s),
            sel(dXc_dH, dXs_dH) * Hf, sel(dXc_dV, dXs_dV),
            sel(dZc_dH, dZs_dH) * Hf, sel(dZc_dV, dZs_dV))


def catenary_solve(XF, ZF, L, EA, w, contact_allowed=True):
    """Solve the fairlead force (H, V) of each line from its spans,
    elementwise over any batch shape, by a fixed ``_NEWTON_ITERS``-step
    damped Newton (the 2x2 Jacobian in closed form).  Differentiable by
    unrolled iteration.  Returns dict(H, V, Ha, Va, TA, TB)."""
    # standard initial guess (Jonkman 2007 quasi-static lineage)
    slack = L**2 - ZF**2
    XF_safe = torch.where(XF > 0, XF, 1.0)
    lam = torch.where(
        L**2 > XF**2 + ZF**2,
        torch.sqrt(torch.clamp(3.0 * (slack / XF_safe**2 - 1.0), min=1e-8)),
        0.2,
    )
    H = torch.clamp(torch.abs(0.5 * w * XF / lam), min=1e3)
    V = 0.5 * w * (ZF / torch.tanh(lam) + L)

    for _ in range(_NEWTON_ITERS):
        Xc, Zc, dXdH, dXdV, dZdH, dZdV = _profile_spans(
            H, V, L, EA, w, contact_allowed)
        r0, r1 = Xc - XF, Zc - ZF
        det = dXdH * dZdV - dXdV * dZdH
        det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
        dH = (-r0 * dZdV + r1 * dXdV) / det
        dV = (-dXdH * r1 + dZdH * r0) / det
        Hn = H + dH
        H = torch.where(Hn <= 0.0, 0.1 * H, Hn)
        V = V + dV

    H = torch.clamp(H, min=1e-8)
    contact = V < w * L
    if not contact_allowed:
        contact = torch.zeros_like(contact)
    Va = torch.where(contact, 0.0, V - w * L)
    Ha = H   # frictionless seabed: H unchanged
    TB = torch.sqrt(H**2 + V**2)
    TA = torch.sqrt(Ha**2 + Va**2)
    return dict(H=H, V=V, Ha=Ha, Va=Va, TA=TA, TB=TB)


# --------------------------------------------------------------------------
# body-level quantities
# --------------------------------------------------------------------------

def _lines(sys_: MooringSystem, dev):
    return (as_real(sys_.rAnchor, dev), as_real(sys_.L, dev),
            as_real(sys_.EA, dev), as_real(sys_.w, dev))


def fairlead_positions(sys_: MooringSystem, r6):
    """Global fairlead positions for body pose r6 (full Euler rotation)."""
    R = rotation_matrix(r6[3], r6[4], r6[5])
    return r6[:3] + as_real(sys_.rFair0, r6.device) @ R.T


def _safe_norm(x, axis=-1):
    """|x| with a zero-safe derivative."""
    return torch.sqrt(torch.sum(x * x, dim=axis) + 1e-30)


def chord_drag_per_length(chord, U, d, Cd_t, Cd_a, rho):
    """Uniform-current drag per unit length on lines with the given chord
    vectors (nl,3) -> (nl,3) N/m: transverse 0.5 rho Cd_t d |Un| Un plus
    tangential 0.5 rho Cd_a (pi d) |Ut| Ut (a copy of
    ``raft_tpu/models/mooring_array.chord_drag_per_length``)."""
    dev = chord.device
    U = as_real(U, dev)
    cn = torch.sqrt(torch.sum(chord * chord, dim=1, keepdim=True) + 1e-30)
    t = chord / cn
    Ut = torch.sum(U[None, :] * t, dim=1, keepdim=True) * t
    Un = U[None, :] - Ut
    nUn = torch.sqrt(torch.sum(Un * Un, dim=1, keepdim=True) + 1e-30)
    nUt = torch.sqrt(torch.sum(Ut * Ut, dim=1, keepdim=True) + 1e-30)
    return (0.5 * rho * as_real(d, dev))[:, None] * (
        as_real(Cd_t, dev)[:, None] * nUn * Un
        + math.pi * as_real(Cd_a, dev)[:, None] * nUt * Ut)


def chord_drag(rA, rB, U, L, d, Cd_t, Cd_a, rho):
    """Per-line uniform-current drag on the straight chord rA->rB, (nl,3),
    integrated over the unstretched length."""
    rB = as_real(rB)
    f = chord_drag_per_length(rB - as_real(rA, rB.device), U, d, Cd_t,
                              Cd_a, rho)
    return as_real(L, rB.device)[:, None] * f


def line_forces(sys_: MooringSystem, r6, current=None, rF=None):
    """Per-line force on the body at each fairlead, (nl,3) global, plus
    the fairlead positions and the catenary solution.

    ``current`` (3,) solves each line in the plane of its effective weight
    (submerged weight plus chord-direction current drag), MoorPy's
    currentMod=1 model; ``rF`` overrides the fairlead positions."""
    dev = r6.device
    if rF is None:
        rF = fairlead_positions(sys_, r6)
    rA, L, EA, w = _lines(sys_, dev)
    if current is None:
        dxy = rF[:, :2] - rA[:, :2]
        XF = torch.linalg.norm(dxy, dim=1)
        ZF = rF[:, 2] - rA[:, 2]
        sol = catenary_solve(XF, ZF, L, EA, w)
        XF_safe = torch.where(XF > 0, XF, 1.0)[:, None]
        dir_h = dxy / XF_safe
        F = torch.cat([-sol["H"][:, None] * dir_h, -sol["V"][:, None]], dim=1)
        return F, rF, sol

    U = as_real(current, dev)
    dr = rF - rA
    f_drag = chord_drag_per_length(dr, U, sys_.d_vol, sys_.Cd_t,
                                   sys_.Cd_a, sys_.rho)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=torch.float64, device=dev)
    w_vec = f_drag + w[:, None] * down
    # net-buoyant lines stay on the plain vertical-plane solve
    sinking = w > 0.0
    w_eff = torch.where(sinking, _safe_norm(w_vec), w)
    zt = torch.where(sinking[:, None], -w_vec / _safe_norm(w_vec)[:, None],
                     -down)
    ZF = torch.sum(dr * zt, dim=1)
    xvec = dr - ZF[:, None] * zt
    XF = _safe_norm(xvec)
    xt = xvec / torch.where(XF > 0, XF, 1.0)[:, None]
    sol = catenary_solve(XF, ZF, L, EA, w_eff)
    F = -sol["H"][:, None] * xt - sol["V"][:, None] * zt
    F = F + torch.where(sinking[:, None], 0.0, 0.5 * L[:, None] * f_drag)
    return F, rF, sol


def free_points(sys_, r6, xf0=None):
    """Free-point positions of a general topology; None for the simple
    topology this port supports."""
    return None


def body_wrench(sys_, r6, xf=None, current=None):
    """Net 6-DOF mooring wrench on the body about its reference point
    (Body.getForces(lines_only=True))."""
    F, rF, _ = line_forces(sys_, r6, current=current)
    return torch.sum(translate_force_3to6(F, rF - r6[:3]), dim=0)


def coupled_stiffness(sys_, r6, xf=None, current=None):
    """6x6 mooring stiffness -dF/dx as the exact EULER-ANGLE jacobian of
    the wrench, by forward-mode autodiff through the catenary Newton."""
    return -torch.func.jacfwd(
        lambda x: body_wrench(sys_, x, current=current))(as_real(r6))


def coupled_stiffness_rotvec(sys_, r6, xf=None, current=None):
    """MoorPy-parity analytic coupled stiffness: the exact ROTATION-VECTOR
    linearization of the wrench about the pose (the reference's
    dynamics/eigen C_moor, getCoupledStiffnessA), by autodiffing the
    wrench under the parameterization R(delta) @ R0."""
    r6 = as_real(r6)
    R0 = rotation_matrix(r6[3], r6[4], r6[5])
    rfair_rel0 = as_real(sys_.rFair0, r6.device) @ R0.T

    def wrench(delta):
        dR = rotation_matrix(delta[3], delta[4], delta[5])
        base = r6[:3] + delta[:3]
        rF = base + rfair_rel0 @ dR.T
        F, rFo, _ = line_forces(sys_, r6, current=current, rF=rF)
        return torch.sum(translate_force_3to6(F, rFo - base), dim=0)

    return -torch.func.jacfwd(wrench)(torch.zeros(6, dtype=torch.float64,
                                                  device=r6.device))


def tensions(sys_, r6, xf=None, current=None):
    """Line end tensions (2*nl,): all anchor-end tensions first, then all
    fairlead-end tensions (MoorPy's getTensions order)."""
    _, _, sol = line_forces(sys_, r6, current=current)
    return torch.cat([sol["TA"], sol["TB"]])


def current_wrench(sys_, r6, U, rho: float = _RHO, xf=None):
    """Uniform-current drag on the mooring lines lumped to the body (the
    chord-direction approximation of MoorPy's currentMod=1): half of each
    line's drag loads the fairlead."""
    r6 = as_real(r6)
    rF = fairlead_positions(sys_, r6)
    F_line = chord_drag(sys_.rAnchor, rF, U, sys_.L, sys_.d_vol,
                        sys_.Cd_t, sys_.Cd_a, rho)
    return torch.sum(translate_force_3to6(0.5 * F_line, rF - r6[:3]), dim=0)


def tension_jacobian(sys_, r6, xf=None):
    """d(tensions)/d(pose): (2*nl, 6), by forward-mode autodiff."""
    return torch.func.jacfwd(lambda x: tensions(sys_, x))(as_real(r6))


def tension_jacobian_fd(sys_, r6, dx=0.1, dth=0.1, current=None):
    """MoorPy-parity tension Jacobian by CENTRAL finite differences with
    MoorPy's default perturbations (getCoupledStiffness(tensions=True)
    J_moor; the reference's Tmoor statistics use it).  The 12 perturbed
    poses are solved as one batch."""
    r6 = as_real(r6)
    dX = torch.tensor([dx, dx, dx, dth, dth, dth], dtype=torch.float64,
                      device=r6.device)
    E = torch.diag(dX)
    X = torch.cat([r6[None] + E, r6[None] - E])          # (12, 6)
    T = torch.func.vmap(lambda x: tensions(sys_, x, current=current))(X)
    return (0.5 * (T[:6] - T[6:]) / dX[:, None]).T
