"""Strip-theory member physics: geometry build + batched tensor kernels.

Port of ``raft_tpu/models/member.py`` (reference: raft/raft_member.py).
The design dictionary is parsed ONCE into a static `MemberGeometry` of
numpy arrays (strip discretization, per-node coefficients, resolved cap
geometry) — host NumPy, as in the JAX package; ``convert.state_from_numpy``
moves its arrays onto a device.  The physics — inertia
(raft_member.py:307-707), hydrostatics (:712-874), strip-theory added
mass / inertial-excitation coefficients (:877-1050) — are vectorized
tensor kernels over the section/node axes, with every per-section branch
of the reference a mask.  The JAX module's intentional deviations from
the reference (zero-length sections, rectangular top caps) are kept.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from raft_tpu_torch._config import as_real
from raft_tpu_torch.ops.geometry import (
    frustum_vcv_circ,
    frustum_vcv_rect,
    frustum_moi_circ,
    frustum_moi_rect,
)
from raft_tpu_torch.ops.transforms import (
    rotation_matrix,
    translate_force_3to6,
    translate_matrix_3to6,
    translate_matrix_6to6,
    vec_vec_trans,
)
from raft_tpu_torch.utils.dicttools import get_from_dict

_CAP_BOTTOM, _CAP_TOP, _CAP_MIDDLE = 0, 1, 2


@dataclass
class MemberGeometry:
    """Static (per-design) description of one member: numpy arrays at
    build time, device tensors after ``convert.state_from_numpy``."""

    name: str
    shape: str                  # 'circular' | 'rectangular'
    potMod: bool
    MCF: bool
    gamma: float                # twist [deg] (incl. heading for vertical members)
    rA0: np.ndarray             # (3,) end A relative to PRP, after heading rotation
    rB0: np.ndarray             # (3,)
    l: float
    stations: np.ndarray        # (n,) positions along axis, 0..l
    d: np.ndarray               # (n,) diameters  or (n,2) side lengths
    t: np.ndarray               # (n,) shell thickness
    rho_shell: float
    l_fill: np.ndarray          # (n-1,) ballast fill length per section [m]
    rho_fill: np.ndarray        # (n-1,) ballast density per section
    # strip discretization
    ns: int
    ls: np.ndarray              # (ns,) node positions along axis
    dls: np.ndarray             # (ns,) lumped strip lengths
    ds: np.ndarray              # (ns,) or (ns,2) strip mean diameter / sides
    drs: np.ndarray             # (ns,) or (ns,2) radius (half-side) change over strip
    # per-node coefficients (pre-interpolated over stations)
    Cd_q_n: np.ndarray
    Cd_p1_n: np.ndarray
    Cd_p2_n: np.ndarray
    Cd_End_n: np.ndarray
    Ca_q_n: np.ndarray
    Ca_p1_n: np.ndarray
    Ca_p2_n: np.ndarray
    Ca_End_n: np.ndarray
    # resolved caps/bulkheads: arrays over caps (possibly empty)
    cap_kind: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    cap_L: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cap_h: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cap_dA: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cap_dB: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cap_dAi: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cap_dBi: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def circular(self) -> bool:
        return self.shape == "circular"


def build_member_geometry(mi: dict, heading: float = 0.0) -> MemberGeometry:
    """Parse one YAML member dict into a MemberGeometry (reference:
    raft_member.py:16-242)."""
    name = str(mi.get("name", ""))
    mtype = int(mi.get("type", 0))
    rA0 = np.array(mi["rA"], dtype=float)
    rB0 = np.array(mi["rB"], dtype=float)
    if (rA0[2] == 0 or rB0[2] == 0) and mtype != 3:
        raise ValueError("Members cannot start or end on the waterplane")
    if rB0[2] < rA0[2]:
        rA0, rB0 = rB0.copy(), rA0.copy()

    shape_str = str(mi["shape"])
    potMod = bool(get_from_dict(mi, "potMod", dtype=bool, default=False))
    MCF = bool(get_from_dict(mi, "MCF", dtype=bool, default=False))
    gamma = float(get_from_dict(mi, "gamma", default=0.0))

    rAB = rB0 - rA0
    l = float(np.linalg.norm(rAB))

    if heading != 0.0:
        c, s = np.cos(np.deg2rad(heading)), np.sin(np.deg2rad(heading))
        rotMat = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        rA0 = rotMat @ rA0
        rB0 = rotMat @ rB0
        if rAB[0] == 0.0 and rAB[1] == 0.0:  # vertical: heading becomes twist
            gamma += heading

    st = np.array(mi["stations"], dtype=float)
    n = len(st)
    if n < 2:
        raise ValueError("At least two station entries must be provided")
    if sorted(st.tolist()) != st.tolist():
        raise ValueError(f"Member {name}: station list not ascending")
    stations = (st - st[0]) / (st[-1] - st[0]) * l

    if shape_str[0].lower() == "c":
        shape = "circular"
        d = np.asarray(get_from_dict(mi, "d", shape=n), dtype=float)
        gamma = 0.0
    elif shape_str[0].lower() == "r":
        shape = "rectangular"
        d = np.asarray(get_from_dict(mi, "d", shape=[n, 2]), dtype=float)
    else:
        raise ValueError("shape must be circular or rectangular")

    if MCF and shape != "circular":
        MCF = False

    t = np.asarray(get_from_dict(mi, "t", shape=n), dtype=float)
    rho_shell = float(get_from_dict(mi, "rho_shell", shape=0, default=8500.0))

    st_fill = np.asarray(get_from_dict(mi, "l_fill", shape=n - 1, default=0), dtype=float)
    for i in range(n - 1):
        if st_fill[i] < 0:
            raise ValueError(f"Member {name}: negative ballast level in section {i+1}")
        if st_fill[i] > st[i + 1] - st[i]:
            raise ValueError(f"Member {name}: ballast exceeds section {i+1} length")
    l_fill = st_fill / (st[-1] - st[0]) * l

    rho_fill = get_from_dict(mi, "rho_fill", shape=-1, default=1025)
    if np.isscalar(rho_fill):
        rho_fill = np.zeros(n - 1) + rho_fill
    else:
        rho_fill = np.asarray(rho_fill, dtype=float)
        if len(rho_fill) != n - 1:
            raise ValueError(f"Member {name}: rho_fill must have {n-1} entries")

    # drag / added-mass coefficients at stations
    Cd_q = np.asarray(get_from_dict(mi, "Cd_q", shape=n, default=0.0), float)
    Cd_p1 = np.asarray(get_from_dict(mi, "Cd", shape=n, default=0.6, index=0), float)
    Cd_p2 = np.asarray(get_from_dict(mi, "Cd", shape=n, default=0.6, index=1), float)
    Cd_End = np.asarray(get_from_dict(mi, "CdEnd", shape=n, default=0.6), float)
    Ca_q = np.asarray(get_from_dict(mi, "Ca_q", shape=n, default=0.0), float)
    Ca_p1 = np.asarray(get_from_dict(mi, "Ca", shape=n, default=0.97, index=0), float)
    Ca_p2 = np.asarray(get_from_dict(mi, "Ca", shape=n, default=0.97, index=1), float)
    Ca_End = np.asarray(get_from_dict(mi, "CaEnd", shape=n, default=0.6), float)

    # ----- strip discretization (reference: raft_member.py:169-216) -----
    dorsl = [d[i] for i in range(n)]  # per-station diameter or side pair
    dlsMax = float(np.atleast_1d(get_from_dict(mi, "dlsMax", shape=-1, default=5))[0])

    ls = [0.0]
    dls = [0.0]
    ds = [0.5 * dorsl[0]]
    drs = [0.5 * dorsl[0]]
    for i in range(1, n):
        lstrip = stations[i] - stations[i - 1]
        if lstrip > 0.0:
            nseg = int(np.ceil(lstrip / dlsMax))
            dlstrip = lstrip / nseg
            m = 0.5 * (dorsl[i] - dorsl[i - 1]) / lstrip
            ls += [stations[i - 1] + dlstrip * (0.5 + j) for j in range(nseg)]
            dls += [dlstrip] * nseg
            ds += [dorsl[i - 1] + dlstrip * 2 * m * (0.5 + j) for j in range(nseg)]
            drs += [dlstrip * m] * nseg
        else:  # flat transition: single zero-length strip
            ls += [stations[i - 1]]
            dls += [0.0]
            ds += [0.5 * (dorsl[i - 1] + dorsl[i])]
            drs += [0.5 * (dorsl[i] - dorsl[i - 1])]
    # end-B strip
    ls += [stations[-1]]
    dls += [0.0]
    ds += [0.5 * dorsl[-1]]
    drs += [-0.5 * dorsl[-1]]

    ls = np.array(ls, float)
    dls = np.array(dls, float)
    ds = np.array(ds, float)
    drs = np.array(drs, float)
    ns = len(ls)

    geom = MemberGeometry(
        name=name, shape=shape, potMod=potMod, MCF=MCF, gamma=gamma,
        rA0=rA0, rB0=rB0, l=l, stations=stations, d=d, t=t,
        rho_shell=rho_shell, l_fill=l_fill, rho_fill=rho_fill,
        ns=ns, ls=ls, dls=dls, ds=ds, drs=drs,
        Cd_q_n=np.interp(ls, stations, Cd_q),
        Cd_p1_n=np.interp(ls, stations, Cd_p1),
        Cd_p2_n=np.interp(ls, stations, Cd_p2),
        Cd_End_n=np.interp(ls, stations, Cd_End),
        Ca_q_n=np.interp(ls, stations, Ca_q),
        Ca_p1_n=np.interp(ls, stations, Ca_p1),
        Ca_p2_n=np.interp(ls, stations, Ca_p2),
        Ca_End_n=np.interp(ls, stations, Ca_End),
    )
    _resolve_caps(geom, mi, st)
    return geom


def _resolve_caps(geom: MemberGeometry, mi: dict, st_raw: np.ndarray) -> None:
    """Resolve end cap / bulkhead diameters ahead of time (reference:
    raft_member.py:553-700, geometry-only part).  Rectangular caps store
    side pairs in cap_dA..cap_dBi with shape (ncap, 2)."""
    cap_st_raw = get_from_dict(mi, "cap_stations", shape=-1, default=[])
    cap_st_raw = np.atleast_1d(np.asarray(cap_st_raw, float))
    ncap = len(cap_st_raw)
    if ncap == 0:
        return
    cap_t = np.atleast_1d(np.asarray(get_from_dict(mi, "cap_t", shape=ncap), float))
    if geom.circular:
        cap_d_in = np.atleast_1d(np.asarray(
            get_from_dict(mi, "cap_d_in", shape=ncap, default=np.zeros(ncap)), float))
        d_in = geom.d - 2 * geom.t  # inner diameter profile at stations
    else:
        cap_d_in = np.asarray(
            get_from_dict(mi, "cap_d_in", shape=[ncap, 2], default=np.zeros([ncap, 2])), float)
        d_in = geom.d - 2 * geom.t[:, None]
    cap_L = (cap_st_raw - st_raw[0]) / (st_raw[-1] - st_raw[0]) * geom.l

    stations = geom.stations

    def interp_d(x):
        if geom.circular:
            return np.interp(x, stations, d_in)
        return np.stack([np.interp(x, stations, d_in[:, k]) for k in range(2)], -1)

    kinds, dAs, dBs, dAis, dBis = [], [], [], [], []
    for i in range(ncap):
        L, h, hole = cap_L[i], cap_t[i], cap_d_in[i]
        if L == stations[0]:
            kind = _CAP_BOTTOM
            dA = d_in[0]
            dB = interp_d(L + h)
            dAi = hole
            dBi = dB * _safe_ratio(dAi, dA)
        elif L == stations[-1]:
            kind = _CAP_TOP
            dA = interp_d(L - h)
            dB = d_in[-1]
            dBi = hole
            dAi = dA * _safe_ratio(dBi, dB)
        elif (stations[0] < L < stations[0] + h) or (stations[-1] - h < L < stations[-1]):
            raise ValueError(f"Member {geom.name}: cap at {L} overlaps member end")
        elif i < ncap - 1 and cap_L[i] == cap_L[i + 1]:
            # step discontinuity (duplicated cap station): an end cap
            # going DOWN from the lower segment.  NOTE the reference
            # indexes the per-station inner-diameter array by the CAP
            # index here (raft_member.py:584 `dB = d[i]`) — valid only
            # when caps align 1:1 with stations; replicated verbatim.
            kind = _CAP_MIDDLE        # positioned like a middle bulkhead
            dA = interp_d(L - h)
            dB = d_in[i]
            dBi = hole
            dAi = dA * _safe_ratio(dBi, dB)
        elif i > 0 and cap_L[i] == cap_L[i - 1]:
            # step discontinuity: the matching end cap going UP from the
            # upper segment (reference raft_member.py:588-592, same
            # cap-index quirk)
            kind = _CAP_MIDDLE
            dA = d_in[i]
            dB = interp_d(L + h)
            dAi = hole
            dBi = dB * _safe_ratio(dAi, dA)
        else:
            kind = _CAP_MIDDLE
            dA = interp_d(L - h / 2)
            dB = interp_d(L + h / 2)
            dM = interp_d(L)
            dAi = dA * _safe_ratio(hole, dM)
            dBi = dB * _safe_ratio(hole, dM)
        kinds.append(kind)
        dAs.append(dA)
        dBs.append(dB)
        dAis.append(dAi)
        dBis.append(dBi)

    geom.cap_kind = np.array(kinds, int)
    geom.cap_L = cap_L
    geom.cap_h = cap_t
    geom.cap_dA = np.array(dAs, float)
    geom.cap_dB = np.array(dBs, float)
    geom.cap_dAi = np.array(dAis, float)
    geom.cap_dBi = np.array(dBis, float)


def _safe_ratio(a, b):
    b = np.asarray(b, float)
    return np.asarray(a, float) / np.where(b == 0.0, 1.0, b) * (b != 0.0)


# --------------------------------------------------------------------------
# pose
# --------------------------------------------------------------------------

def member_pose(geom: MemberGeometry, r6):
    """Member pose under a 6-DOF platform displacement r6 (tensor; its
    device is the device of the result).  Returns a dict of tensors: rA,
    rB, q, p1, p2, R, r (ns,3), qMat, p1Mat, p2Mat."""
    r6 = as_real(r6)
    dev = r6.device
    rA0 = as_real(geom.rA0, dev)
    rB0 = as_real(geom.rB0, dev)
    rAB0 = rB0 - rA0
    q0 = rAB0 / torch.linalg.norm(rAB0)

    beta = torch.atan2(q0[1], q0[0])
    phi = torch.atan2(torch.sqrt(q0[0] ** 2 + q0[1] ** 2), q0[2])
    s1, c1 = torch.sin(beta), torch.cos(beta)
    s2, c2 = torch.sin(phi), torch.cos(phi)
    g = math.radians(geom.gamma)
    s3, c3 = math.sin(g), math.cos(g)
    # Z1Y2Z3 Euler rotation (reference: raft_member.py:272-274)
    R0 = torch.stack([
        torch.stack([c1 * c2 * c3 - s1 * s3, -c3 * s1 - c1 * c2 * s3, c1 * s2]),
        torch.stack([c1 * s3 + c2 * c3 * s1, c1 * c3 - c2 * s1 * s3, s1 * s2]),
        torch.stack([-c3 * s2, s2 * s3, c2]),
    ])
    p1_0 = R0[:, 0]

    R_platform = rotation_matrix(r6[3], r6[4], r6[5])
    R = R_platform @ R0
    q = R_platform @ q0
    p1 = R_platform @ p1_0
    p2 = torch.linalg.cross(q, p1)

    rA = r6[:3] + R_platform @ rA0
    rB = r6[:3] + R_platform @ rB0
    rAB = rB - rA
    frac = as_real(geom.ls, dev) / geom.l
    r = rA + frac[:, None] * rAB

    return dict(
        rA=rA, rB=rB, q=q, p1=p1, p2=p2, R=R, r=r,
        qMat=vec_vec_trans(q), p1Mat=vec_vec_trans(p1), p2Mat=vec_vec_trans(p2),
    )


# --------------------------------------------------------------------------
# inertia
# --------------------------------------------------------------------------

def member_inertia(geom: MemberGeometry, pose, rPRP=None,
                   l_fill=None, rho_fill=None):
    """Mass properties about the PRP (reference: raft_member.py:307-707).

    Returns dict(mass, center, mshell, mfill, pfill, vfill, M_struc) where
    mfill / pfill / vfill are per-section tensors."""
    dev = pose["rA"].device
    rPRP = torch.zeros(3, dtype=torch.float64, device=dev) if rPRP is None \
        else as_real(rPRP, dev)
    st = as_real(geom.stations, dev)
    lsec = st[1:] - st[:-1]
    valid = lsec > 0.0
    lsafe = torch.where(valid, lsec, 1.0)
    l_fill = as_real(geom.l_fill if l_fill is None else l_fill, dev)
    rho_fill = as_real(geom.rho_fill if rho_fill is None else rho_fill, dev)
    rho_shell = geom.rho_shell
    d = as_real(geom.d, dev)
    t = as_real(geom.t, dev)

    if geom.circular:
        dA, dB = d[:-1], d[1:]
        dAi = dA - 2 * t[:-1]
        dBi = dB - 2 * t[1:]
        V_outer, hco = frustum_vcv_circ(dA, dB, lsec)
        V_inner, hci = frustum_vcv_circ(dAi, dBi, lsec)
        dBi_fill = (dBi - dAi) * (l_fill / lsafe) + dAi
        v_fill, hc_fill = frustum_vcv_circ(dAi, dBi_fill, l_fill)
        IxxO, IzzO = frustum_moi_circ(dA, dB, lsec, rho_shell)
        IxxI, IzzI = frustum_moi_circ(dAi, dBi, lsec, rho_shell)
        IxxF, IzzF = frustum_moi_circ(dAi, dBi_fill, l_fill, rho_fill)
        IyyO, IyyI, IyyF = IxxO, IxxI, IxxF
    else:
        slA, slB = d[:-1], d[1:]
        slAi = slA - 2 * t[:-1, None]
        slBi = slB - 2 * t[1:, None]
        V_outer, hco = frustum_vcv_rect(slA, slB, lsec)
        V_inner, hci = frustum_vcv_rect(slAi, slBi, lsec)
        slBi_fill = (slBi - slAi) * (l_fill / lsafe)[:, None] + slAi
        v_fill, hc_fill = frustum_vcv_rect(slAi, slBi_fill, l_fill)
        IxxO, IyyO, IzzO = frustum_moi_rect(slA, slB, lsec, rho_shell)
        IxxI, IyyI, IzzI = frustum_moi_rect(slAi, slBi, lsec, rho_shell)
        IxxF, IyyF, IzzF = frustum_moi_rect(slAi, slBi_fill, l_fill, rho_fill)

    v_shell = V_outer - V_inner
    m_shell = v_shell * rho_shell
    vs_safe = torch.where(v_shell != 0.0, v_shell, 1.0)
    hc_shell = (hco * V_outer - hci * V_inner) / vs_safe
    m_fill = v_fill * rho_fill
    mass_s = m_shell + m_fill
    mass_safe = torch.where(mass_s != 0.0, mass_s, 1.0)
    hc = (hc_fill * m_fill + hc_shell * m_shell) / mass_safe

    Ixx = (IxxO - IxxI) + IxxF - mass_s * hc**2
    Iyy = (IyyO - IyyI) + IyyF - mass_s * hc**2
    Izz = (IzzO - IzzI) + IzzF

    # zero-length sections: zero mass/center, but the PREVIOUS section's
    # local MoI is re-added (the reference's loop-carried variable,
    # raft_member.py:420-426 + 539-548; see the JAX module)
    mass_s = torch.where(valid, mass_s, 0.0)
    m_shell = torch.where(valid, m_shell, 0.0)
    m_fill = torch.where(valid, m_fill, 0.0)
    v_fill = torch.where(valid, v_fill, 0.0)
    pfill = torch.where(valid, rho_fill, 0.0)
    z1 = torch.zeros(1, dtype=torch.float64, device=dev)
    Ixx = torch.where(valid, Ixx, torch.cat([z1, Ixx[:-1]]))
    Iyy = torch.where(valid, Iyy, torch.cat([z1, Iyy[:-1]]))
    Izz = torch.where(valid, Izz, torch.cat([z1, Izz[:-1]]))

    center = pose["rA"] + pose["q"][None, :] * (st[:-1] + hc)[:, None] - rPRP
    center = torch.where(valid[:, None], center, 0.0)

    R = pose["R"]
    M_struc = _assemble_inertia(mass_s, Ixx, Iyy, Izz, R, center)

    # ----- caps / bulkheads -----
    mshell_total = torch.sum(m_shell)
    mass_center = torch.sum(mass_s[:, None] * center, dim=0)
    if len(geom.cap_kind):
        h = as_real(geom.cap_h, dev)
        cdA, cdB = as_real(geom.cap_dA, dev), as_real(geom.cap_dB, dev)
        cdAi, cdBi = as_real(geom.cap_dAi, dev), as_real(geom.cap_dBi, dev)
        rho_cap = rho_shell
        if geom.circular:
            V_o, hco_c = frustum_vcv_circ(cdA, cdB, h)
            V_i, hci_c = frustum_vcv_circ(cdAi, cdBi, h)
            IxxOc, IzzOc = frustum_moi_circ(cdA, cdB, h, rho_cap)
            IxxIc, IzzIc = frustum_moi_circ(cdAi, cdBi, h, rho_cap)
            IyyOc, IyyIc = IxxOc, IxxIc
        else:
            V_o, hco_c = frustum_vcv_rect(cdA, cdB, h)
            V_i, hci_c = frustum_vcv_rect(cdAi, cdBi, h)
            IxxOc, IyyOc, IzzOc = frustum_moi_rect(cdA, cdB, h, rho_cap)
            IxxIc, IyyIc, IzzIc = frustum_moi_rect(cdAi, cdBi, h, rho_cap)
        v_cap = V_o - V_i
        m_cap = v_cap * rho_cap
        vc_safe = torch.where(v_cap != 0.0, v_cap, 1.0)
        hc_cap = (hco_c * V_o - hci_c * V_i) / vc_safe
        Ixx_c = (IxxOc - IxxIc) - m_cap * hc_cap**2
        Iyy_c = (IyyOc - IyyIc) - m_cap * hc_cap**2
        Izz_c = IzzOc - IzzIc

        kind = torch.as_tensor(geom.cap_kind, device=dev)
        off = torch.where(kind == _CAP_BOTTOM, hc_cap,
                          torch.where(kind == _CAP_TOP, -(h - hc_cap),
                                      -(h / 2 - hc_cap)))
        center_cap = (pose["rA"] + pose["q"][None, :]
                      * (as_real(geom.cap_L, dev) + off)[:, None] - rPRP)
        M_struc = M_struc + _assemble_inertia(m_cap, Ixx_c, Iyy_c, Izz_c, R,
                                              center_cap)
        mshell_total = mshell_total + torch.sum(m_cap)
        mass_center = mass_center + torch.sum(m_cap[:, None] * center_cap,
                                              dim=0)

    mass = M_struc[0, 0]
    center_total = mass_center / torch.where(mass != 0.0, mass, 1.0)
    return dict(mass=mass, center=center_total, mshell=mshell_total,
                mfill=m_fill, pfill=pfill, vfill=v_fill, M_struc=M_struc)


def _assemble_inertia(mass, Ixx, Iyy, Izz, R, center):
    """Per-section local mass matrix (diag mass + rotated MoI about its
    CG) translated to the PRP and summed (reference: raft_member.py:
    537-547)."""
    z = torch.zeros_like(mass)
    I_loc = torch.stack([torch.stack([Ixx, z, z], -1),
                         torch.stack([z, Iyy, z], -1),
                         torch.stack([z, z, Izz], -1)], -2)
    I_rot = R @ I_loc @ R.T
    m3 = mass[:, None, None] * torch.eye(3, dtype=mass.dtype,
                                          device=mass.device)
    z3 = torch.zeros_like(m3)
    Mmat = torch.cat([torch.cat([m3, z3], -1), torch.cat([z3, I_rot], -1)], -2)
    return torch.sum(translate_matrix_6to6(Mmat, center), dim=0)


# --------------------------------------------------------------------------
# hydrostatics
# --------------------------------------------------------------------------

def member_hydrostatics(geom: MemberGeometry, pose, rPRP=None,
                        rho=1025.0, g=9.81):
    """Buoyancy wrench, hydrostatic stiffness, displaced volume, CB, and
    waterplane properties (reference: raft_member.py:712-874), vectorized
    over sections with the reference's three cases as masks (crossing the
    waterplane, fully submerged, dry); the waterplane outputs take the
    LAST crossing section's values."""
    dev = pose["rA"].device
    rPRP = torch.zeros(3, dtype=torch.float64, device=dev) if rPRP is None \
        else as_real(rPRP, dev)
    st = as_real(geom.stations, dev)
    q = pose["q"]
    rHS_ref = torch.stack([rPRP[0], rPRP[1], torch.zeros_like(rPRP[0])])
    rA_s = pose["rA"] + q[None, :] * st[:-1, None] - rHS_ref
    rB_s = pose["rA"] + q[None, :] * st[1:, None] - rHS_ref
    zA, zB = rA_s[:, 2], rB_s[:, 2]

    cross = zA * zB <= 0.0
    submerged = (~cross) & (zA <= 0.0) & (zB <= 0.0)

    beta = torch.atan2(q[1], q[0])
    phi = torch.atan2(torch.sqrt(q[0] ** 2 + q[1] ** 2), q[2])
    cosPhi, sinPhi, tanPhi = torch.cos(phi), torch.sin(phi), torch.tan(phi)
    cosBeta, sinBeta = torch.cos(beta), torch.sin(beta)
    cosPhi_safe = torch.where(cosPhi == 0.0, 1.0, cosPhi)

    dz = torch.where(zB - zA == 0.0, 1.0, zB - zA)
    xWP_s = rA_s[:, 0] + (0.0 - zA) * (rB_s[:, 0] - rA_s[:, 0]) / dz
    yWP_s = rA_s[:, 1] + (0.0 - zA) * (rB_s[:, 1] - rA_s[:, 1]) / dz

    d = as_real(geom.d, dev)
    if geom.circular:
        # the reference interpolates the waterplane diameter with the
        # upper/lower values swapped (raft_member.py:769) — replicated
        dWP = d[1:] + (0.0 - zA) * (d[:-1] - d[1:]) / dz
        AWP_s = (math.pi / 4) * dWP**2
        IWP_s = (math.pi / 64) * dWP**4
        IxWP_s, IyWP_s = IWP_s, IWP_s
    else:
        sl = d
        slWP = sl[1:] + (0.0 - zA)[:, None] * (sl[:-1] - sl[1:]) / dz[:, None]
        AWP_s = slWP[:, 0] * slWP[:, 1]
        IWP_s = torch.zeros_like(AWP_s)  # reference leaves IWP at 0 for rect
        IxWP_l = (1.0 / 12.0) * slWP[:, 0] * slWP[:, 1] ** 3
        IyWP_l = (1.0 / 12.0) * slWP[:, 0] ** 3 * slWP[:, 1]
        R = pose["R"]
        z0 = torch.zeros_like(IxWP_l)
        Iloc = torch.stack([torch.stack([IxWP_l, z0, z0], -1),
                            torch.stack([z0, IyWP_l, z0], -1),
                            torch.stack([z0, z0, z0], -1)], -2)
        Irot = R @ Iloc @ R.T
        IxWP_s = Irot[:, 0, 0]
        IyWP_s = Irot[:, 1, 1]

    LWP = torch.abs(zA / cosPhi_safe)

    if geom.circular:
        V_cr, hc_cr = frustum_vcv_circ(d[:-1], dWP, LWP)
        V_sub, hc_sub = frustum_vcv_circ(d[:-1], d[1:], st[1:] - st[:-1])
    else:
        V_cr, hc_cr = frustum_vcv_rect(d[:-1], slWP, LWP)
        V_sub, hc_sub = frustum_vcv_rect(d[:-1], d[1:], st[1:] - st[:-1])

    r_center_cr = rA_s + q[None, :] * hc_cr[:, None]
    r_center_sub = rA_s + q[None, :] * hc_sub[:, None]

    # ---- crossing-section contributions ----
    Fz_cr = rho * g * V_cr
    if geom.circular:
        M_incline = -rho * g * math.pi * (dWP**2 / 32.0 * (2.0 + tanPhi**2)
                                          + 0.5 * (zA / cosPhi_safe) ** 2) * sinPhi
    else:
        M_incline = torch.zeros_like(Fz_cr)
    Mx_cr = M_incline * (-sinBeta)
    My_cr = M_incline * (cosBeta)

    cr = cross.to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    Fvec = torch.stack([zero, zero, torch.sum(cr * Fz_cr),
                        torch.sum(cr * (Mx_cr + Fz_cr * rA_s[:, 1])),
                        torch.sum(cr * (My_cr - Fz_cr * rA_s[:, 0])), zero])

    c22 = rho * g * AWP_s / cosPhi_safe
    s = lambda x: torch.sum(cr * x)  # noqa: E731
    c23 = s(rho * g * (-AWP_s * yWP_s))
    c24 = s(rho * g * (AWP_s * xWP_s))
    c34 = s(rho * g * (AWP_s * xWP_s * yWP_s))
    c33 = s(rho * g * (IxWP_s + AWP_s * yWP_s**2)) \
        + s(rho * g * V_cr * r_center_cr[:, 2])
    c44 = s(rho * g * (IyWP_s + AWP_s * xWP_s**2)) \
        + s(rho * g * V_cr * r_center_cr[:, 2])

    # ---- fully-submerged contributions ----
    sub = submerged.to(torch.float64)
    zv = torch.zeros_like(V_sub)
    Fsub = translate_force_3to6(
        torch.stack([zv, zv, rho * g * V_sub], -1), r_center_sub)
    Fvec = Fvec + torch.sum(sub[:, None] * Fsub, dim=0)
    c33 = c33 + torch.sum(sub * rho * g * V_sub * r_center_sub[:, 2])
    c44 = c44 + torch.sum(sub * rho * g * V_sub * r_center_sub[:, 2])

    Cmat = torch.stack([
        torch.stack([zero, zero, zero, zero, zero, zero]),
        torch.stack([zero, zero, zero, zero, zero, zero]),
        torch.stack([zero, zero, s(c22), c23, c24, zero]),
        torch.stack([zero, zero, c23, c33, c34, zero]),
        torch.stack([zero, zero, c24, c34, c44, zero]),
        torch.stack([zero, zero, zero, zero, zero, zero]),
    ])

    V_UW = torch.sum(cr * V_cr + sub * V_sub)
    r_centerV = torch.sum((cr * V_cr)[:, None] * r_center_cr
                          + (sub * V_sub)[:, None] * r_center_sub, dim=0)
    r_center = torch.where(V_UW > 0,
                           r_centerV / torch.where(V_UW > 0, V_UW, 1.0), 0.0)

    # last crossing section wins the waterplane scalars
    nsec = zA.shape[0]
    idxs = torch.arange(nsec, device=dev)
    last_cross = torch.max(torch.where(cross, idxs, -1))
    any_cross = last_cross >= 0
    sel = torch.clamp(last_cross, 0, nsec - 1)
    # a gather, not x[sel]: indexing by a 0-d tensor reads it on the host
    isel = sel.reshape(1)
    AWP = torch.where(any_cross, AWP_s.index_select(0, isel)[0], 0.0)
    IWP = torch.where(any_cross, IWP_s.index_select(0, isel)[0], 0.0)
    xWP = torch.where(any_cross, xWP_s.index_select(0, isel)[0], 0.0)
    yWP = torch.where(any_cross, yWP_s.index_select(0, isel)[0], 0.0)

    return dict(Fvec=Fvec, Cmat=Cmat, V_UW=V_UW, r_center=r_center,
                AWP=AWP, IWP=IWP, xWP=xWP, yWP=yWP)


# --------------------------------------------------------------------------
# strip-theory added mass & inertial-excitation coefficients
# --------------------------------------------------------------------------

def _node_volumes(geom: MemberGeometry, r_nodes):
    """Per-node side volume (with partial-submergence scaling) and end
    volume/area terms (reference: raft_member.py:922-949)."""
    dev = r_nodes.device
    dls = as_real(geom.dls, dev)
    ds = as_real(geom.ds, dev)
    drs = as_real(geom.drs, dev)
    if geom.circular:
        v_side = 0.25 * math.pi * ds**2 * dls
        v_end = math.pi / 12.0 * torch.abs((ds + drs) ** 3 - (ds - drs) ** 3)
        a_i = math.pi * ds * drs
    else:
        v_side = ds[:, 0] * ds[:, 1] * dls
        dmean_p = torch.mean(ds + drs, dim=1)
        dmean_m = torch.mean(ds - drs, dim=1)
        v_end = math.pi / 12.0 * (dmean_p**3 - dmean_m**3)
        a_i = ((ds[:, 0] + drs[:, 0]) * (ds[:, 1] + drs[:, 1])
               - (ds[:, 0] - drs[:, 0]) * (ds[:, 1] - drs[:, 1]))
    z = r_nodes[:, 2]
    dls_safe = torch.where(dls == 0.0, 1.0, dls)
    scale = torch.where(z + 0.5 * dls > 0.0, (0.5 * dls - z) / dls_safe, 1.0)
    v_side = v_side * scale
    return v_side, v_end, a_i


def member_hydro_constants(geom: MemberGeometry, pose, r_ref=None,
                           rho=1025.0):
    """Strip-theory added mass and inertial-excitation matrices
    (reference: raft_member.py:877-1050, non-MCF path): per-node Amat,
    Imat (ns,3,3), a_i (ns,), plus the 6x6 A_hydro and I_hydro about
    ``r_ref``."""
    r = pose["r"]
    dev = r.device
    r_ref = torch.zeros(3, dtype=torch.float64, device=dev) if r_ref is None \
        else as_real(r_ref, dev)
    submerged = r[:, 2] < 0.0
    active = submerged & (not geom.potMod)

    v_side, v_end, a_i = _node_volumes(geom, r)

    Ca_p1 = as_real(geom.Ca_p1_n, dev)
    Ca_p2 = as_real(geom.Ca_p2_n, dev)
    Ca_End = as_real(geom.Ca_End_n, dev)

    p1Mat, p2Mat, qMat = pose["p1Mat"], pose["p2Mat"], pose["qMat"]
    Amat = (rho * v_side * Ca_p1)[:, None, None] * p1Mat \
        + (rho * v_side * Ca_p2)[:, None, None] * p2Mat \
        + (rho * v_end * Ca_End)[:, None, None] * qMat
    Imat = (rho * v_side * (1.0 + Ca_p1))[:, None, None] * p1Mat \
        + (rho * v_side * (1.0 + Ca_p2))[:, None, None] * p2Mat \
        + (rho * v_end * Ca_End)[:, None, None] * qMat

    mask = active[:, None, None].to(torch.float64)
    Amat = Amat * mask
    Imat = Imat * mask
    a_i = a_i * active.to(torch.float64)

    offsets = r - r_ref[None, :3]
    A_hydro = torch.sum(translate_matrix_3to6(Amat, offsets), dim=0)
    I_hydro = torch.sum(translate_matrix_3to6(Imat, offsets), dim=0)
    return dict(Amat=Amat, Imat=Imat, a_i=a_i, A_hydro=A_hydro,
                I_hydro=I_hydro)
