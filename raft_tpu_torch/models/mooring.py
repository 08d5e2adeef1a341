"""Quasi-static catenary mooring as differentiable tensor kernels.

Port of the simple-topology (anchor -> fairlead) path of
``raft_tpu/models/mooring.py`` (reference: the MoorPy subset of
raft/raft_fowt.py:166-189, 275-288 and raft/raft_model.py:801-803).  A
mooring system is a static `MooringSystem` of per-line arrays; each
line's fairlead force comes from the two-branch elastic catenary
(frictionless seabed) solved by a FIXED 40-step Newton loop, so the 6x6
coupled stiffness and the tension Jacobian are exact autodiff Jacobians
of the wrench.  Topologies with free points or
multi-segment lines build a single-body ``mooring_array.ArrayMooring``
(the same catenary plus a free-point equilibrium); every body-level
function below takes either system.  Multi-body shared moorings are not
part of the port yet.

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
    """Build a mooring system from the design['mooring'] YAML dict (points
    fixed|vessel|free, lines endA/endB, line_types).  Simple
    anchor->fairlead topologies give a `MooringSystem`; topologies with
    free points or multi-segment lines give a single-body
    ``mooring_array.ArrayMooring`` (the reference's MoorPy System.parseYAML,
    raft_fowt.py:166-189).  ``trans``/``rot`` apply the reference's
    array-placement transform: rotate about z by ``rot`` degrees, then
    translate the fixed and free points in x, y (body points stay in the
    body frame)."""
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

    def line_props(ln):
        lt = types[ln["type"]]
        d = float(lt["diameter"])
        m = float(lt["mass_density"])
        return dict(L=float(ln["length"]), EA=float(lt["stiffness"]),
                    w=(m - rho * np.pi / 4 * d**2) * g, d=d, m=m,
                    Cd_t=float(lt.get("transverse_drag", 0.0)),
                    Cd_a=float(lt.get("tangential_drag", 0.0)))

    if not simple:
        return _parse_general(moor, points, ptype, line_props, depth, Rz,
                              trans, rho, g)

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
        lp = line_props(ln)
        L.append(lp["L"])
        EA.append(lp["EA"])
        w.append(lp["w"])
        d_vol.append(lp["d"])
        m_lin.append(lp["m"])
        Cd_t.append(lp["Cd_t"])
        Cd_a.append(lp["Cd_a"])

    return MooringSystem(
        depth=depth,
        rAnchor=np.array(rAnchor), rFair0=np.array(rFair0),
        L=np.array(L), EA=np.array(EA), w=np.array(w),
        d_vol=np.array(d_vol), m_lin=np.array(m_lin),
        Cd_t=np.array(Cd_t), Cd_a=np.array(Cd_a), rho=rho,
    )


def _parse_general(moor, points, ptype, line_props, depth, Rz, trans, rho,
                   g):
    """The single-body ``ArrayMooring`` of a topology with free points or
    multi-segment lines (``raft_tpu/models/mooring.py:145-200``)."""
    from raft_tpu_torch.models import mooring_array as ma

    names = list(points.keys())
    attach, r0, pmass, pvol = [], [], [], []
    for name in names:
        p = points[name]
        t = ptype(p)
        loc = np.array(p["location"], float)
        if t == "vessel":
            attach.append(0)
            r0.append(Rz @ loc)          # body frame (placement on body)
        else:
            attach.append(ma.ATTACH_FIXED if t == "fixed" else ma.ATTACH_FREE)
            loc = Rz @ loc
            loc[0] += trans[0]
            loc[1] += trans[1]
            r0.append(loc)
        pmass.append(float(p.get("mass", 0.0)))
        pvol.append(float(p.get("volume", 0.0)))
    attach = np.array(attach)
    r0 = np.array(r0)
    free_idx = np.full(len(names), -1)
    free_idx[attach == ma.ATTACH_FREE] = np.arange(
        (attach == ma.ATTACH_FREE).sum())
    name2row = {n: i for i, n in enumerate(names)}

    iA, iB = [], []
    props = {k: [] for k in ("L", "EA", "w", "d", "Cd_t", "Cd_a")}
    for ln in moor["lines"]:
        lp = line_props(ln)
        iA.append(name2row[ln["endA"]])
        iB.append(name2row[ln["endB"]])
        for k in props:
            props[k].append(lp[k])
    iA, iB = np.array(iA), np.array(iB)

    def on_seabed(ipt):
        return (attach[ipt] == ma.ATTACH_FIXED) & (r0[ipt, 2] <= -depth + 1.0)

    return ma.ArrayMooring(
        depth=depth, nbodies=1,
        attach=attach, r0=r0, pmass=np.array(pmass), pvol=np.array(pvol),
        free_idx=free_idx, iA=iA, iB=iB, L=np.array(props["L"]),
        EA=np.array(props["EA"]), w=np.array(props["w"]),
        contact_ok=on_seabed(iA) | on_seabed(iB), g=g, rho=rho,
        d_vol=np.array(props["d"]), Cd_t=np.array(props["Cd_t"]),
        Cd_a=np.array(props["Cd_a"]),
    )


# --------------------------------------------------------------------------
# catenary kernel
# --------------------------------------------------------------------------

def _contact(V, w, L, contact_allowed):
    """Lines on the seabed-contact branch: V < wL where contact is allowed
    (a bool, or a per-line bool tensor)."""
    contact = V < w * L
    if isinstance(contact_allowed, torch.Tensor):
        return contact & contact_allowed
    return contact if contact_allowed else torch.zeros_like(contact)


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
    contact = _contact(V, w, L, contact_allowed)
    Hf = Hm.to(H.dtype)          # d clamp(H)/dH
    sel = lambda c, s: torch.where(contact, c, s)  # noqa: E731
    return (sel(XF_c, XF_s), sel(ZF_c, ZF_s),
            sel(dXc_dH, dXs_dH) * Hf, sel(dXc_dV, dXs_dV),
            sel(dZc_dH, dZs_dH) * Hf, sel(dZc_dV, dZs_dV))


def _newton_step(H, V, XF, ZF, L, EA, w, contact_allowed):
    """One damped Newton step of the catenary spans (2x2 in closed form,
    H kept positive)."""
    Xc, Zc, dXdH, dXdV, dZdH, dZdV = _profile_spans(
        H, V, L, EA, w, contact_allowed)
    r0, r1 = Xc - XF, Zc - ZF
    det = dXdH * dZdV - dXdV * dZdH
    det = torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    dH = (-r0 * dZdV + r1 * dXdV) / det
    dV = (-dXdH * r1 + dZdH * r0) / det
    Hn = H + dH
    return torch.where(Hn <= 0.0, 0.1 * H, Hn), V + dV


def catenary_solve(XF, ZF, L, EA, w, contact_allowed=True,
                   grad_steps=_NEWTON_ITERS):
    """Solve the fairlead force (H, V) of each line from its spans,
    elementwise over any batch shape, by a fixed ``_NEWTON_ITERS``-step
    damped Newton (the 2x2 Jacobian in closed form).  Returns dict(H, V,
    Ha, Va, TA, TB).

    Derivatives flow through the last ``grad_steps`` steps: all of them
    by default (the JAX package's unrolled differentiation).  With fewer,
    the earlier steps (and the initial guess) run on detached inputs: the
    values are the same bit for bit, and at a converged solution the
    derivatives are the implicit-function ones that the unrolled loop
    gives too (the Newton map's own derivative in H, V vanishes there),
    up to rounding — at a small fraction of the forward-mode cost.  The
    free-point mooring takes ``grad_steps=1``: its equilibrium Newton
    differentiates the catenary 40 times per solve."""
    args = (XF, ZF, L, EA, w)
    n_detached = _NEWTON_ITERS - int(grad_steps)
    src = tuple(a.detach() if isinstance(a, torch.Tensor) else a
                for a in args) if n_detached > 0 else args
    XF0, ZF0, L0, EA0, w0 = src
    # standard initial guess (Jonkman 2007 quasi-static lineage)
    slack = L0**2 - ZF0**2
    XF_safe = torch.where(XF0 > 0, XF0, 1.0)
    lam = torch.where(
        L0**2 > XF0**2 + ZF0**2,
        torch.sqrt(torch.clamp(3.0 * (slack / XF_safe**2 - 1.0), min=1e-8)),
        0.2,
    )
    H = torch.clamp(torch.abs(0.5 * w0 * XF0 / lam), min=1e3)
    V = 0.5 * w0 * (ZF0 / torch.tanh(lam) + L0)
    for i in range(_NEWTON_ITERS):
        H, V = _newton_step(H, V, *(src if i < n_detached else args),
                            contact_allowed)

    H = torch.clamp(H, min=1e-8)
    contact = _contact(V, w, L, contact_allowed)
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
    down = as_real([0.0, 0.0, -1.0], dev)
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


def _is_general(sys_) -> bool:
    """True for the general (free-point / multi-segment) single-body
    system `parse_mooring` builds on non-simple topologies."""
    return hasattr(sys_, "attach")


def _general_xf(sys_, r6, xf):
    """(the body poses (1, 6), the free points: ``xf`` or solved there)."""
    from raft_tpu_torch.models import mooring_array as ma
    Xb = as_real(r6)[None, :]
    return Xb, (ma.solve_free_points(sys_, Xb) if xf is None else xf)


def free_points(sys_, r6, xf0=None):
    """Equilibrium free-point positions of a general system (None for the
    simple topology).  Callers evaluating several mooring quantities at
    one pose solve this ONCE and pass it through the ``xf=`` arguments
    below."""
    if not _is_general(sys_):
        return None
    from raft_tpu_torch.models import mooring_array as ma
    return ma.solve_free_points(sys_, as_real(r6)[None, :], xf0=xf0)


def body_wrench(sys_, r6, xf=None, current=None):
    """Net 6-DOF mooring wrench on the body about its reference point
    (Body.getForces(lines_only=True)).  ``current`` engages the
    current-loaded line profiles on the simple path; general topologies
    take current through the lumped `current_wrench` instead."""
    if _is_general(sys_):
        from raft_tpu_torch.models import mooring_array as ma
        Xb, xf = _general_xf(sys_, r6, xf)
        return ma.body_wrenches(sys_, Xb, xf)[0]
    F, rF, _ = line_forces(sys_, r6, current=current)
    return torch.sum(translate_force_3to6(F, rF - r6[:3]), dim=0)


def coupled_stiffness(sys_, r6, xf=None, current=None):
    """6x6 mooring stiffness -dF/dx as the exact EULER-ANGLE jacobian of
    the wrench, by forward-mode autodiff through the catenary Newton (the
    free points eliminated by the implicit-function theorem on the
    general path)."""
    if _is_general(sys_):
        from raft_tpu_torch.models import mooring_array as ma
        Xb, xf = _general_xf(sys_, r6, xf)
        return ma.coupled_stiffness(sys_, Xb, xf)
    return -torch.func.jacfwd(
        lambda x: body_wrench(sys_, x, current=current))(as_real(r6))


def coupled_stiffness_rotvec(sys_, r6, xf=None, current=None):
    """MoorPy-parity analytic coupled stiffness: the exact ROTATION-VECTOR
    linearization of the wrench about the pose (the reference's
    dynamics/eigen C_moor, getCoupledStiffnessA), by autodiffing the
    wrench under the parameterization R(delta) @ R0.  The general
    topology has no current-loaded line profiles: a ``current`` given
    there is ignored with a warning (current reaches it through the
    lumped `current_wrench`).  The simple topology's Jacobian is taken
    in reverse mode (``torch.func.jacrev``): the JAX package's ``jacfwd``
    to rounding, at a sixth of forward mode's cost through the catenary
    (see ``parallel/variants.statics_newton``)."""
    if _is_general(sys_):
        if current is not None:
            import warnings
            warnings.warn(
                "coupled_stiffness_rotvec: 'current' is ignored on "
                "general (free-point) mooring topologies — the stiffness "
                "is evaluated with unloaded line profiles (current only "
                "enters general topologies through the lumped "
                "current_wrench on F_env)", stacklevel=2)
        from raft_tpu_torch.models import mooring_array as ma
        Xb, xf = _general_xf(sys_, r6, xf)
        return ma.coupled_stiffness_rotvec(sys_, Xb, xf)
    r6 = as_real(r6)
    R0 = rotation_matrix(r6[3], r6[4], r6[5])
    rfair_rel0 = as_real(sys_.rFair0, r6.device) @ R0.T

    def wrench(delta):
        dR = rotation_matrix(delta[3], delta[4], delta[5])
        base = r6[:3] + delta[:3]
        rF = base + rfair_rel0 @ dR.T
        F, rFo, _ = line_forces(sys_, r6, current=current, rF=rF)
        return torch.sum(translate_force_3to6(F, rFo - base), dim=0)

    return -torch.func.jacrev(wrench)(torch.zeros(6, dtype=torch.float64,
                                                  device=r6.device))


def tensions(sys_, r6, xf=None, current=None):
    """Line end tensions (2*nl,): all anchor-end (end A) tensions first,
    then all fairlead-end (end B) tensions (MoorPy's getTensions
    order)."""
    if _is_general(sys_):
        from raft_tpu_torch.models import mooring_array as ma
        Xb, xf = _general_xf(sys_, r6, xf)
        return ma.tensions(sys_, Xb, xf)
    _, _, sol = line_forces(sys_, r6, current=current)
    return torch.cat([sol["TA"], sol["TB"]])


def current_wrench(sys_, r6, U, rho: float = _RHO, xf=None):
    """Uniform-current drag on the mooring lines lumped to the body (the
    chord-direction approximation of MoorPy's currentMod=1): half of each
    line's drag loads each end."""
    if _is_general(sys_):
        from raft_tpu_torch.models import mooring_array as ma
        Xb, xf = _general_xf(sys_, r6, xf)
        return ma.current_wrenches(sys_, Xb, xf, U)[0]
    r6 = as_real(r6)
    rF = fairlead_positions(sys_, r6)
    F_line = chord_drag(sys_.rAnchor, rF, U, sys_.L, sys_.d_vol,
                        sys_.Cd_t, sys_.Cd_a, rho)
    return torch.sum(translate_force_3to6(0.5 * F_line, rF - r6[:3]), dim=0)


def tension_jacobian(sys_, r6, xf=None):
    """d(tensions)/d(pose): (2*nl, 6), by forward-mode autodiff (with the
    implicit free-point correction on the general path)."""
    if _is_general(sys_):
        from raft_tpu_torch.models import mooring_array as ma
        Xb, xf = _general_xf(sys_, r6, xf)
        return ma.tension_jacobian(sys_, Xb, xf)
    return torch.func.jacfwd(lambda x: tensions(sys_, x))(as_real(r6))


def _fd_poses(r6, dx, dth):
    """The 12 centrally perturbed poses (+ then -) and the steps."""
    r6 = as_real(r6)
    dX = as_real([dx, dx, dx, dth, dth, dth], r6.device)
    E = torch.diag(dX)
    return torch.cat([r6[None] + E, r6[None] - E]), dX


def coupled_stiffness_fd(sys_, r6, dx=0.1, dth=0.1, tensions_too=False):
    """MoorPy-parity coupled stiffness (and with ``tensions_too`` the
    tension Jacobian) by CENTRAL finite differences with MoorPy's default
    perturbations (System.getCoupledStiffness: dx 0.1 m, dth 0.1 rad),
    the free points re-solved at every perturbed pose.  The 12 poses are
    solved as one batch."""
    X, dX = _fd_poses(r6, dx, dth)
    F = torch.func.vmap(lambda x: body_wrench(sys_, x))(X)
    K = (-0.5 * (F[:6] - F[6:]) / dX[:, None]).T
    if not tensions_too:
        return K
    T = torch.func.vmap(lambda x: tensions(sys_, x))(X)
    return K, (0.5 * (T[:6] - T[6:]) / dX[:, None]).T


def tension_jacobian_fd(sys_, r6, dx=0.1, dth=0.1, current=None):
    """MoorPy-parity tension Jacobian by CENTRAL finite differences with
    MoorPy's default perturbations (getCoupledStiffness(tensions=True)
    J_moor; the reference's Tmoor statistics use it), one free-point
    solve per perturbed pose on the general path.  The 12 perturbed
    poses are solved as one batch."""
    X, dX = _fd_poses(r6, dx, dth)
    T = torch.func.vmap(lambda x: tensions(sys_, x, current=current))(X)
    return (0.5 * (T[:6] - T[6:]) / dX[:, None]).T
