"""Single-platform assembly: statics, strip-theory hydro, aero constants.

Port of the strip-theory path of ``raft_tpu/models/fowt.py`` (reference:
raft/raft_fowt.py).  All members' strip nodes are concatenated into one
flat node axis at build time (`NodeSet`), so every hydro quantity —
added mass, Froude-Krylov excitation, drag linearization, current loads —
is one batched tensor expression over (heading, node, frequency) with
submergence masks.

Build time (host numpy): `build_fowt(design, w, ..., device=...)` parses
the design dict into a `FOWTModel` and, given a device, carries its
arrays there (``convert.state_from_numpy``).  Pose time (tensors on the
model's device): the `fowt_*` functions mirror the reference methods:

  calcStatics            -> fowt_statics            (raft_fowt.py:291-566)
  calcHydroConstants     -> fowt_hydro_constants    (raft_fowt.py:848-880)
  calcHydroExcitation    -> fowt_hydro_excitation   (raft_fowt.py:972-1149)
  calcHydroLinearization -> fowt_hydro_linearization_pre (:1152-1266)
  calcDragExcitation     -> fowt_drag_excitation    (raft_fowt.py:1270-1293)
  calcCurrentLoads       -> fowt_current_loads      (raft_fowt.py:1297-1382)
  calcTurbineConstants   -> fowt_turbine_constants  (raft_fowt.py:773-845)

First-order potential flow: ``potFirstOrder: 1`` / ``potModMaster: 3``
read WAMIT ``.1``/``.3`` files at ``hydroPath`` (``io/wamit.py``);
otherwise potential-flow members (``potMod``, or every member under
``potModMaster: 2``) are meshed and solved by the native BEM core on the
host (``io/bem_native.py``, cached in ``meshDir``).  The coefficients
(`BEMData`) are host numpy at build time and tensors on the model's
device afterwards.

Second-order loads: ``potSecOrder: 1`` sets up the second-order grid
(``w1_2nd`` / ``k1_2nd``) for the internal slender-body QTF
(``models/qtf.py``), ``potSecOrder: 2`` reads ``hydroPath + ".12d"``
into ``qtf_data``.

Submerged (MHK) rotors: a rotor whose blade tips stay below the surface
(``hubHt + R_rot < 0``) adds one rectangular type-3 member per blade
element at each blade's build azimuth (``rotor.blade_member_dicts``),
named ``"blade"``, after every other member; their buoyancy counts in
the statics, their structural mass does not (it is in the RNA mass).

MacCamy-Fuchs members (``MCF: True`` on a circular member): the
transverse inertia coefficient of their nodes depends on the frequency,
so ``Imat`` is (N, 3, 3, nw) complex (`fowt_hydro_constants`); the Kim &
Yue second-order correction is in ``models/qtf.py``.
"""
from __future__ import annotations

import contextlib
import math
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from raft_tpu_torch._config import COMPLEX, REAL, as_real, to_device
from raft_tpu_torch.io.bem_native import solve_bem_fowt
from raft_tpu_torch.io.wamit import bem_excitation, load_bem
from raft_tpu_torch.models.member import (
    MemberGeometry, build_member_geometry, member_pose, member_inertia,
    member_hydrostatics,
)
from raft_tpu_torch.models.rotor import (
    RotorModel, blade_member_dicts, build_rotor, calc_aero, rotor_pose,
)
from raft_tpu_torch.models import mooring as mr
from raft_tpu_torch.models.qtf import read_qtf_12d
from raft_tpu_torch.ops.transforms import (
    translate_force_3to6, translate_matrix_3to6, translate_matrix_6to6,
    rotate_matrix_6, transform_force, skew,
)
from raft_tpu_torch.ops.special import hankel1p_all
from raft_tpu_torch.ops.waves import wave_number, wave_kinematics
from raft_tpu_torch.ops.spectra import jonswap
from raft_tpu_torch.utils.dicttools import get_from_dict


@dataclass
class NodeSet:
    """Static per-node scalars, all members concatenated (built once).
    Shapes (N,) unless noted."""

    member_index: np.ndarray     # which member each node belongs to
    frac: np.ndarray             # position along member axis / length
    dls: np.ndarray
    # drag areas per unit Cd (reference: raft_fowt.py:1200-1202, 1235-1238)
    a_i_q: np.ndarray
    a_i_p1: np.ndarray
    a_i_p2: np.ndarray
    a_i_end_drag: np.ndarray     # |end area| for drag
    # added-mass volumes/areas (reference: raft_member.py:925-949)
    v_side: np.ndarray           # pre-submergence-scaling side volume
    v_end: np.ndarray
    a_i: np.ndarray              # signed axial pressure area
    # coefficients interpolated to nodes
    Cd_q: np.ndarray
    Cd_p1: np.ndarray
    Cd_p2: np.ndarray
    Cd_End: np.ndarray
    Ca_p1: np.ndarray
    Ca_p2: np.ndarray
    Ca_End: np.ndarray
    circ: np.ndarray             # bool per node
    potMod: np.ndarray           # bool per node (True -> no strip hydro)
    MCF: np.ndarray = None       # bool per node: MacCamy-Fuchs member
    R: np.ndarray = None         # node radius ds/2 (circular; 0 for rect)

    @property
    def n(self):
        return len(self.frac)


@dataclass
class FOWTModel:
    """Static description of one floating wind turbine (build output)."""

    members: List[MemberGeometry]
    member_types: List[int]
    member_names: List[str]
    rotors: List[RotorModel]
    mooring: Optional[mr.MooringSystem]
    nodes: NodeSet
    w: np.ndarray
    k: np.ndarray
    depth: float
    rho_water: float
    g: float
    shearExp_water: float
    yawstiff: float
    x_ref: float
    y_ref: float
    heading_adjust: float
    nplatmems: int
    ntowers: int
    potModMaster: int
    platmem_groups: Optional[List[List[int]]] = None
    potSecOrder: int = 0
    potFirstOrder: int = 0
    bem: Optional[object] = None
    w1_2nd: Optional[np.ndarray] = None   # 2nd-order QTF grid (potSecOrder 1)
    k1_2nd: Optional[np.ndarray] = None
    qtf_data: Optional[object] = None     # models.qtf.QTFData (potSecOrder 2)

    @property
    def potMod_any(self) -> bool:
        return any(m.potMod for m in self.members)

    @property
    def nw(self):
        return len(self.w)

    @property
    def nrotors(self):
        return len(self.rotors)

    @property
    def device(self):
        return self.w.device if isinstance(self.w, torch.Tensor) \
            else torch.device("cpu")


def build_fowt(design: dict, w, depth=600.0, x_ref=0.0, y_ref=0.0,
               heading_adjust=0.0, device=None,
               geometry_only=False) -> FOWTModel:
    """Parse a design dict into a FOWTModel (reference: raft_fowt.py:
    22-257); potential-flow members read their WAMIT files or are solved
    by the native BEM on the host here.  With ``device`` the built arrays
    are carried onto it.  ``geometry_only`` skips the potential-flow and
    second-order setup, for callers that only need the member geometry
    (the variant-sweep grid)."""
    design = dict(design)
    site = design["site"]
    rho_water = float(get_from_dict(site, "rho_water", default=1025.0))
    g = float(get_from_dict(site, "g", default=9.81))
    shearExp_water = float(get_from_dict(site, "shearExp_water", default=0.12))

    platform = design["platform"]
    potModMaster = int(get_from_dict(platform, "potModMaster", dtype=int, default=0))
    dlsMax = float(get_from_dict(platform, "dlsMax", default=5.0))

    members: List[MemberGeometry] = []
    member_types: List[int] = []
    member_names: List[str] = []
    nplatmems = 0
    platmem_groups: List[List[int]] = []
    for mi in platform["members"]:
        mi = dict(mi)
        if potModMaster in (1,):
            mi["potMod"] = False
        elif potModMaster in (2, 3):
            mi["potMod"] = True
        mi.setdefault("dlsMax", dlsMax)
        headings = get_from_dict(mi, "heading", shape=-1, default=0.0)
        platmem_groups.append(list(range(
            nplatmems, nplatmems + len(np.atleast_1d(headings)))))
        for h in (np.atleast_1d(headings)):
            members.append(build_member_geometry(mi, heading=float(h) + heading_adjust))
            member_types.append(int(mi.get("type", 2)))
            member_names.append(str(mi.get("name", "")))
            nplatmems += 1

    rotors: List[RotorModel] = []
    ntowers = 0
    if "turbine" in design and design["turbine"] is not None:
        turbine = dict(design["turbine"])
        nrotors = int(get_from_dict(turbine, "nrotors", dtype=int, shape=0, default=1))
        turbine["nrotors"] = nrotors
        turbine["rho_air"] = float(get_from_dict(site, "rho_air", shape=0, default=1.225))
        turbine["mu_air"] = float(get_from_dict(site, "mu_air", shape=0, default=1.81e-5))
        turbine["shearExp_air"] = float(get_from_dict(site, "shearExp_air", shape=0, default=0.12))
        turbine["rho_water"] = rho_water
        turbine["mu_water"] = float(get_from_dict(site, "mu_water", shape=0, default=1.0e-3))
        turbine["shearExp_water"] = shearExp_water
        tower = turbine.get("tower")
        if tower is not None:
            towers = [tower] if isinstance(tower, dict) else list(tower)
            ntowers = len(towers)
            for mem in towers:
                mem = dict(mem)
                mem.setdefault("dlsMax", dlsMax)
                members.append(build_member_geometry(mem))
                member_types.append(int(mem.get("type", 1)))
                member_names.append(str(mem.get("name", "tower")))
        nac = turbine.get("nacelle")
        if nac is not None:
            nacs = [nac] if isinstance(nac, dict) else list(nac)
            for mem in nacs:
                mem = dict(mem)
                mem.setdefault("dlsMax", dlsMax)
                members.append(build_member_geometry(mem))
                member_types.append(int(mem.get("type", 1)))
                member_names.append("nacelle")
        for ir in range(nrotors):
            rotors.append(build_rotor(turbine, w, ir))
        # fully submerged rotors get per-element blade members for added
        # mass, buoyancy and inertial excitation (reference:
        # raft_rotor.py:369-373, raft_fowt.py:384-444, 873-880), appended
        # last so the platform and tower member indices are unchanged
        for rot in rotors:
            if rot.hubHt + rot.R_rot < 0:
                for bm in blade_member_dicts(rot):
                    bm.setdefault("dlsMax", dlsMax)
                    members.append(build_member_geometry(bm))
                    member_types.append(3)
                    member_names.append("blade")

    moor = None
    if design.get("mooring"):
        moor = mr.parse_mooring(design["mooring"], rho=rho_water, g=g,
                                trans=(x_ref, y_ref), rot=heading_adjust)

    yawstiff = float(platform.get("yaw_stiffness", 0.0))

    w = np.asarray(w, float)
    k = wave_number(w, depth).numpy()

    nodes = _build_nodeset(members)

    # potential-flow coefficient files (reference: raft_fowt.py:222-227 for
    # potFirstOrder 1; :654-655 reuses the same path for potModMaster 3)
    potFirstOrder = int(get_from_dict(platform, "potFirstOrder", dtype=int, default=0))
    bem = None
    if not geometry_only and (potFirstOrder == 1 or potModMaster == 3):
        if "hydroPath" not in platform:
            raise ValueError("potFirstOrder==1/potModMaster==3 require "
                             "'hydroPath' in the platform input")
        bem = load_bem(platform["hydroPath"], w, rho=rho_water, g=g,
                       freq=str(platform.get("hydroFreqType", "auto")))
    potSecOrder = int(get_from_dict(platform, "potSecOrder", dtype=int, default=0))
    if geometry_only:
        potSecOrder = 0
    # second-order hydro setup (reference: raft_fowt.py:231-252)
    w1_2nd = k1_2nd = qtf_data = None
    if potSecOrder == 1:
        if "min_freq2nd" not in platform or "max_freq2nd" not in platform:
            raise ValueError("potSecOrder==1 requires min_freq2nd and "
                             "max_freq2nd in the platform input")
        f_min2 = float(platform["min_freq2nd"])
        f_max2 = float(platform["max_freq2nd"])
        f_df2 = float(platform.get("df_freq2nd", f_min2))
        w1_2nd = np.arange(f_min2, f_max2 + 0.5 * f_min2, f_df2) * 2 * np.pi
        k1_2nd = wave_number(w1_2nd, depth).numpy()
    elif potSecOrder == 2:
        if "hydroPath" not in platform:
            raise ValueError("potSecOrder==2 requires hydroPath in the "
                             "platform input")
        qpath = platform["hydroPath"] + ".12d"
        if not os.path.isfile(qpath):
            raise FileNotFoundError(f"QTF file {qpath} not found")
        qtf_data = read_qtf_12d(qpath, rho=rho_water, g=g)

    fowt = FOWTModel(
        members=members, member_types=member_types, member_names=member_names,
        rotors=rotors, mooring=moor, nodes=nodes,
        w=w, k=k, depth=float(depth), rho_water=rho_water, g=g,
        shearExp_water=shearExp_water, yawstiff=yawstiff,
        x_ref=float(x_ref), y_ref=float(y_ref),
        heading_adjust=float(heading_adjust),
        nplatmems=nplatmems, ntowers=ntowers,
        platmem_groups=platmem_groups, potModMaster=potModMaster,
        potSecOrder=potSecOrder, potFirstOrder=potFirstOrder, bem=bem,
        w1_2nd=w1_2nd, k1_2nd=k1_2nd, qtf_data=qtf_data,
    )
    if not geometry_only and bem is None and fowt.potMod_any:
        # potMod members get no strip-theory hydro: the native BEM core
        # solves their panel mesh on the host (the reference's pyHAMS
        # step, raft_fowt.py:568-650).  min_freq_BEM [Hz] is both the
        # lowest BEM frequency and its step (raft_fowt.py:121-122)
        mf_bem = get_from_dict(platform, "min_freq_BEM", default=0.0)
        fowt.bem = solve_bem_fowt(
            fowt, dz=float(get_from_dict(platform, "dz_BEM", default=3.0)),
            da=float(get_from_dict(platform, "da_BEM", default=2.0)),
            dw_bem=2.0 * np.pi * float(mf_bem) if mf_bem else None,
            mesh_dir=platform.get("meshDir"))
    if device is not None:
        from raft_tpu_torch.convert import state_from_numpy
        fowt = state_from_numpy(fowt, device)
    return fowt


def member_node_cols(m: MemberGeometry):
    """Per-node derived areas/volumes for one member from its strip arrays
    (reference: raft_fowt.py:1200-1202, raft_member.py:925-949), as
    tensors: from the numpy arrays at build time, and from the batched
    geometry leaves of a design variant (``parallel/variants.py``)."""
    ds, drs, dls = as_real(m.ds), as_real(m.drs), as_real(m.dls)
    if m.circular:
        a_i_q = math.pi * ds * dls
        a_i_p1 = ds * dls
        a_i_p2 = ds * dls
        a_end_drag = torch.abs(math.pi * ds * drs)
        v_side = 0.25 * math.pi * ds**2 * dls
        v_end = math.pi / 12.0 * torch.abs((ds + drs) ** 3 - (ds - drs) ** 3)
        a_i = math.pi * ds * drs
    else:
        # a_i_q uses ds[:,0] twice, replicating the reference
        # (raft_fowt.py:1200: 2*(ds[il,0]+ds[il,0])*dls)
        a_i_q = 2 * (ds[:, 0] + ds[:, 0]) * dls
        a_i_p1 = ds[:, 0] * dls
        a_i_p2 = ds[:, 1] * dls
        a_end = ((ds[:, 0] + drs[:, 0]) * (ds[:, 1] + drs[:, 1])
                 - (ds[:, 0] - drs[:, 0]) * (ds[:, 1] - drs[:, 1]))
        a_end_drag = torch.abs(a_end)
        v_side = ds[:, 0] * ds[:, 1] * dls
        dmean_p = torch.mean(ds + drs, dim=1)
        dmean_m = torch.mean(ds - drs, dim=1)
        v_end = math.pi / 12.0 * (dmean_p**3 - dmean_m**3)
        a_i = a_end
    R = 0.5 * ds if m.circular else 0.0 * ds[:, 0]
    return dict(frac=as_real(m.ls) / m.l, dls=dls, a_i_q=a_i_q,
                a_i_p1=a_i_p1, a_i_p2=a_i_p2, a_i_end_drag=a_end_drag,
                v_side=v_side, v_end=v_end, a_i=a_i, R=R)


def _build_nodeset(members: List[MemberGeometry]) -> NodeSet:
    cols = {k: [] for k in ("member_index", "frac", "dls", "a_i_q", "a_i_p1",
                            "a_i_p2", "a_i_end_drag", "v_side", "v_end", "a_i",
                            "Cd_q", "Cd_p1", "Cd_p2", "Cd_End",
                            "Ca_p1", "Ca_p2", "Ca_End", "circ", "potMod",
                            "MCF", "R")}
    for im, m in enumerate(members):
        ns = m.ns
        derived = member_node_cols(m)
        cols["member_index"].append(np.full(ns, im))
        cols["MCF"].append(np.full(ns, bool(m.MCF), dtype=bool))
        for key in ("frac", "dls", "a_i_q", "a_i_p1", "a_i_p2",
                    "a_i_end_drag", "v_side", "v_end", "a_i", "R"):
            cols[key].append(derived[key].numpy())
        cols["Cd_q"].append(m.Cd_q_n)
        cols["Cd_p1"].append(m.Cd_p1_n)
        cols["Cd_p2"].append(m.Cd_p2_n)
        cols["Cd_End"].append(m.Cd_End_n)
        cols["Ca_p1"].append(m.Ca_p1_n)
        cols["Ca_p2"].append(m.Ca_p2_n)
        cols["Ca_End"].append(m.Ca_End_n)
        cols["circ"].append(np.full(ns, m.circular, dtype=bool))
        cols["potMod"].append(np.full(ns, m.potMod, dtype=bool))
    return NodeSet(**{k: np.concatenate(v) for k, v in cols.items()})


def _nd(fowt, name, dev):
    """A NodeSet column as a tensor on ``dev`` (bool columns stay bool)."""
    x = getattr(fowt.nodes, name)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    x = np.asarray(x)
    if x.dtype == np.bool_:
        return torch.as_tensor(x, device=dev)
    return as_real(x, dev)


# --------------------------------------------------------------------------
# pose
# --------------------------------------------------------------------------

def fowt_pose(fowt: FOWTModel, r6):
    """Member poses + stacked node arrays for the given platform pose.

    Returns dict with 'members' (list of member pose dicts) and stacked
    'r' (N,3), 'q','p1','p2' (N,3), 'qMat','p1Mat','p2Mat' (N,3,3)."""
    r6 = as_real(r6, fowt.device)
    mposes = [member_pose(m, r6) for m in fowt.members]
    counts = [m.ns for m in fowt.members]
    r = torch.cat([p["r"] for p in mposes])
    q = torch.cat([p["q"].expand(n, 3) for p, n in zip(mposes, counts)])
    p1 = torch.cat([p["p1"].expand(n, 3) for p, n in zip(mposes, counts)])
    p2 = torch.cat([p["p2"].expand(n, 3) for p, n in zip(mposes, counts)])
    qMat = q[:, :, None] * q[:, None, :]
    p1Mat = p1[:, :, None] * p1[:, None, :]
    p2Mat = p2[:, :, None] * p2[:, None, :]
    return dict(r6=r6, members=mposes, r=r, q=q, p1=p1, p2=p2,
                qMat=qMat, p1Mat=p1Mat, p2Mat=p2Mat)


# --------------------------------------------------------------------------
# statics
# --------------------------------------------------------------------------

def fowt_statics(fowt: FOWTModel, pose, l_fill=None, rho_fill=None):
    """Mass/hydrostatic matrices and weight/buoyancy vectors about the PRP
    (reference: raft_fowt.py:291-566).  ``l_fill``/``rho_fill``: optional
    per-member override lists (the ballast trim of a design variant)."""
    g = fowt.g
    r6 = pose["r6"]
    dev = r6.device
    f64 = dict(dtype=REAL, device=dev)
    rPRP = r6[:3]

    W_struc = torch.zeros(6, **f64)
    M_struc = torch.zeros((6, 6), **f64)
    M_struc_sub = torch.zeros((6, 6), **f64)
    W_hydro = torch.zeros(6, **f64)
    C_hydro = torch.zeros((6, 6), **f64)
    m_center_sum = torch.zeros(3, **f64)
    m_sub_sum = torch.zeros(3, **f64)
    m_sub = torch.zeros((), **f64)
    m_shell_sub = torch.zeros((), **f64)
    VTOT = torch.zeros((), **f64)
    AWP_TOT = torch.zeros((), **f64)
    IWPx_TOT = torch.zeros((), **f64)
    IWPy_TOT = torch.zeros((), **f64)
    Sum_V_rCB = torch.zeros(3, **f64)
    Sum_AWP_rWP = torch.zeros(2, **f64)
    mtower = []
    rCG_tow = []
    mballast = []
    pballast = []
    gvec = as_real([0.0, 0.0, -g], dev)

    for i, (m, mtype, mname) in enumerate(zip(fowt.members, fowt.member_types,
                                              fowt.member_names)):
        mpose = pose["members"][i]
        # nacelles contribute buoyancy only — their inertia lives in
        # mRNA/IxRNA/IrRNA (reference: raft_fowt.py:447-464)
        if mname not in ("nacelle", "blade"):
            inert = member_inertia(
                m, mpose, rPRP=rPRP,
                l_fill=None if l_fill is None else l_fill[i],
                rho_fill=None if rho_fill is None else rho_fill[i])
            mass, center = inert["mass"], inert["center"]
            W_struc = W_struc + translate_force_3to6(gvec * mass, center)
            M_struc = M_struc + inert["M_struc"]
            m_center_sum = m_center_sum + center * mass
            if mtype <= 1:
                mtower.append(mass)
                rCG_tow.append(center)
            else:
                m_sub = m_sub + mass
                M_struc_sub = M_struc_sub + inert["M_struc"]
                m_sub_sum = m_sub_sum + center * mass
                m_shell_sub = m_shell_sub + inert["mshell"]
                mballast.append(inert["mfill"])
                pballast.append(inert["pfill"])

        hs = member_hydrostatics(m, mpose, rPRP=rPRP, rho=fowt.rho_water, g=g)
        W_hydro = W_hydro + hs["Fvec"]
        C_hydro = C_hydro + hs["Cmat"]
        VTOT = VTOT + hs["V_UW"]
        AWP_TOT = AWP_TOT + hs["AWP"]
        IWPx_TOT = IWPx_TOT + hs["IWP"] + hs["AWP"] * hs["yWP"] ** 2
        IWPy_TOT = IWPy_TOT + hs["IWP"] + hs["AWP"] * hs["xWP"] ** 2
        Sum_V_rCB = Sum_V_rCB + hs["r_center"] * hs["V_UW"]
        Sum_AWP_rWP = Sum_AWP_rWP + torch.stack([hs["xWP"], hs["yWP"]]) * hs["AWP"]

    # RNA inertia contributions (reference :467-480)
    for rot in fowt.rotors:
        rpose = rotor_pose(rot, r6)
        Mmat = torch.diag(as_real([rot.mRNA, rot.mRNA, rot.mRNA,
                                   rot.IxRNA, rot.IrRNA, rot.IrRNA], dev))
        Mmat = rotate_matrix_6(Mmat, rpose["R_q"])
        r_RRP_rel = rpose["R_ptfm"] @ as_real(rot.r_rel, dev)
        r_CG_rel = r_RRP_rel + rpose["q"] * rot.xCG_RNA
        W_struc = W_struc + translate_force_3to6(
            as_real([0.0, 0.0, -g * rot.mRNA], dev), r_CG_rel)
        M_struc = M_struc + translate_matrix_6to6(Mmat, r_CG_rel)
        m_center_sum = m_center_sum + r_CG_rel * rot.mRNA

    m_all = M_struc[0, 0]
    rCG = m_center_sum / m_all
    rCG_sub = m_sub_sum / torch.where(m_sub == 0.0, 1.0, m_sub)

    # built without in-place writes, so the statics run under
    # torch.func.vmap over design variants
    e34 = as_real([0.0, 0.0, 0.0, 1.0, 1.0, 0.0], dev)
    C_struc = torch.diag(e34 * (-m_all * g * rCG[2]))
    C_struc_sub = torch.diag(e34 * (-m_sub * g * rCG_sub[2]))

    rCB = Sum_V_rCB / torch.where(VTOT == 0.0, 1.0, VTOT)
    zMeta = torch.where(VTOT == 0.0, 0.0,
                        rCB[2] + IWPx_TOT / torch.where(VTOT == 0.0, 1.0, VTOT))

    M_sub_cm = translate_matrix_6to6(M_struc_sub, -rCG_sub)
    M_all_cm = translate_matrix_6to6(M_struc, -rCG)

    zero = torch.zeros((), **f64)
    return dict(
        W_struc=W_struc, M_struc=M_struc, C_struc=C_struc,
        W_hydro=W_hydro, C_hydro=C_hydro,
        M_struc_sub=M_struc_sub, C_struc_sub=C_struc_sub,
        m=m_all, m_sub=m_sub, m_shell=m_shell_sub,
        rCG=rCG, rCG_sub=rCG_sub, rCB=rCB, V=VTOT, AWP=AWP_TOT,
        rM=torch.stack([rCB[0], rCB[1], zero]) + torch.stack([zero, zero, zMeta]),
        mtower=mtower, rCG_tow=rCG_tow, mballast=mballast, pballast=pballast,
        Ixx=M_all_cm[3, 3], Iyy=M_all_cm[4, 4], Izz=M_all_cm[5, 5],
        Ixx_sub=M_sub_cm[3, 3], Iyy_sub=M_sub_cm[4, 4], Izz_sub=M_sub_cm[5, 5],
    )


def ballast_density_trim(fowt: FOWTModel, pose0, ref):
    """The uniform ballast-density shift that zeroes the linearized
    unloaded heave, closed form (reference: raft_model.py:1569-1624), as
    tensors with no data-dependent Python branch (it runs under
    ``torch.func.vmap`` over design variants).

    Free-flooding sections (``rho_fill == 0``) get their fill level
    zeroed; ``sumFz`` is the net vertical force at ``pose0`` (the pose at
    ``ref``, (6,)) with those fills, ``v_ballast`` the ballast volume and
    ``delta = sumFz / g / v_ballast`` (0 where ``v_ballast <= 0``), added
    to ``rho_fill`` wherever the fill level is positive.  Returns
    ``(l_fill, rho_fill, delta, sumFz, v_ballast)``, the first two
    per-member lists of new tensors."""
    g, rho = fowt.g, fowt.rho_water
    l_fill = [torch.where(torch.atleast_1d(m.rho_fill) == 0.0, 0.0,
                          torch.atleast_1d(m.l_fill))
              for m in fowt.members]
    stat = fowt_statics(fowt, pose0, l_fill=l_fill)
    Fz_moor = (mr.body_wrench(fowt.mooring, ref)[2]
               if fowt.mooring is not None else 0.0)
    sumFz = -stat["M_struc"][0, 0] * g + stat["V"] * rho * g + Fz_moor
    vb = 0.0
    for i, m in enumerate(fowt.members):
        inert = member_inertia(m, pose0["members"][i], rPRP=ref[:3],
                               l_fill=l_fill[i])
        vb = vb + torch.sum(inert["vfill"])
    delta = torch.where(vb > 0.0,
                        sumFz / g / torch.where(vb > 0, vb, 1.0), 0.0)
    rho_fill = [torch.where(lf > 0.0, torch.atleast_1d(m.rho_fill) + delta,
                            torch.atleast_1d(m.rho_fill))
                for m, lf in zip(fowt.members, l_fill)]
    return l_fill, rho_fill, delta, sumFz, vb


# --------------------------------------------------------------------------
# strip-theory hydro constants (stacked nodes)
# --------------------------------------------------------------------------

def fowt_hydro_constants(fowt: FOWTModel, pose):
    """Added mass (6,6) about the PRP plus per-node Amat (N,3,3), Imat and
    a_i (reference: raft_fowt.py:848-880 over raft_member.py:877-1088).
    Imat is (N,3,3) real, or (N,3,3,nw) complex when a MacCamy-Fuchs
    member is present."""
    r = pose["r"]
    dev = r.device
    rho = fowt.rho_water
    submerged = r[:, 2] < 0.0
    active = submerged & ~_nd(fowt, "potMod", dev)

    dls = _nd(fowt, "dls", dev)
    z = r[:, 2]
    dls_safe = torch.where(dls == 0.0, 1.0, dls)
    scale = torch.where(z + 0.5 * dls > 0.0, (0.5 * dls - z) / dls_safe, 1.0)
    v_side = _nd(fowt, "v_side", dev) * scale
    v_end = _nd(fowt, "v_end", dev)

    Ca_p1 = _nd(fowt, "Ca_p1", dev)
    Ca_p2 = _nd(fowt, "Ca_p2", dev)
    Ca_End = _nd(fowt, "Ca_End", dev)
    p1Mat, p2Mat, qMat = pose["p1Mat"], pose["p2Mat"], pose["qMat"]

    Amat = ((rho * v_side * Ca_p1)[:, None, None] * p1Mat
            + (rho * v_side * Ca_p2)[:, None, None] * p2Mat
            + (rho * v_end * Ca_End)[:, None, None] * qMat)
    Imat = ((rho * v_side * (1.0 + Ca_p1))[:, None, None] * p1Mat
            + (rho * v_side * (1.0 + Ca_p2))[:, None, None] * p2Mat
            + (rho * v_end * Ca_End)[:, None, None] * qMat)
    mask = active.to(REAL)
    Amat = Amat * mask[:, None, None]
    Imat = Imat * mask[:, None, None]
    a_i = _nd(fowt, "a_i", dev) * mask

    # MacCamy-Fuchs: frequency-dependent complex inertia coefficient of
    # the flagged circular members (reference: raft_member.py:1053-1088):
    # Cm = 4i / (pi (kR)^2 H1'(kR)), blended by a cosine ramp into the
    # Morison Cm for long waves (k < pi / (5R)), zero at k <= 0; on the
    # transverse terms only, the end term stays real
    if fowt.nodes.MCF is not None and (
            _MCF_KNOWN[-1] if _MCF_KNOWN
            else bool(np.any(_host(fowt.nodes.MCF, "mcf_flags")))):
        k = as_real(fowt.k, dev)                      # (nw,)
        R = _nd(fowt, "R", dev)                       # (N,)
        R_safe = torch.where(R > 0, R, 1.0)
        kR = k[None, :] * R_safe[:, None]             # (N, nw)
        Hp1 = hankel1p_all(kR, 1)[1]
        Cm = 4j / (math.pi * kR**2 * Hp1)
        Tr = math.pi / 5.0 / R_safe                   # (N,)
        ramp = torch.where(k[None, :] < Tr[:, None],
                           0.5 * (1.0 - torch.cos(math.pi * k[None, :]
                                                  / Tr[:, None])),
                           1.0)
        ramp = torch.where(k[None, :] <= 0.0, 0.0, ramp)
        mcf = _nd(fowt, "MCF", dev)[:, None]
        Cm_p1 = torch.where(mcf, Cm * ramp + (1.0 + Ca_p1[:, None])
                            * (1 - ramp), (1.0 + Ca_p1[:, None]).to(COMPLEX))
        Cm_p2 = torch.where(mcf, Cm * ramp + (1.0 + Ca_p2[:, None])
                            * (1 - ramp), (1.0 + Ca_p2[:, None]).to(COMPLEX))
        Imat = ((rho * v_side)[:, None, None, None]
                * (Cm_p1[:, None, None, :] * p1Mat[:, :, :, None]
                   + Cm_p2[:, None, None, :] * p2Mat[:, :, :, None])
                + ((rho * v_end * Ca_End)[:, None, None]
                   * qMat)[:, :, :, None].to(COMPLEX))
        Imat = Imat * mask[:, None, None, None]

    offsets = r - pose["r6"][:3]
    A_hydro = torch.sum(translate_matrix_3to6(Amat, offsets), dim=0)
    return dict(A_hydro_morison=A_hydro, Amat=Amat, Imat=Imat, a_i=a_i,
                active=active)


# --------------------------------------------------------------------------
# sea states & excitation
# --------------------------------------------------------------------------

def build_seastate(fowt: FOWTModel, case: dict):
    """Host-side sea-state setup from a case dict (reference:
    raft_fowt.py:977-1014).  Returns dict(beta (nH,), S (nH,nw),
    zeta (nH,nw) complex) as numpy arrays."""
    wh = case.get("wave_heading", 0.0)
    nWaves = 1 if np.isscalar(wh) else len(wh)
    heading = np.atleast_1d(np.asarray(
        get_from_dict(case, "wave_heading", shape=nWaves, dtype=float, default=0), float))
    spectrum = get_from_dict(case, "wave_spectrum", shape=nWaves, dtype=str,
                             default="JONSWAP")
    spectrum = [spectrum] * nWaves if isinstance(spectrum, str) else list(np.atleast_1d(spectrum))
    period = np.atleast_1d(np.asarray(get_from_dict(case, "wave_period", shape=nWaves, dtype=float, default=0), float))
    height = np.atleast_1d(np.asarray(get_from_dict(case, "wave_height", shape=nWaves, dtype=float, default=0), float))
    for ih in range(nWaves):
        if spectrum[ih] == "JONSWAP" and height[ih] <= 0.0:
            spectrum[ih] = "still"
        elif spectrum[ih] == "JONSWAP" and period[ih] <= 0.0:
            raise ValueError(
                f"case specifies wave_height={height[ih]} but no positive "
                "wave_period — set both (or neither, for a still sea state)")
    gamma = np.atleast_1d(np.asarray(get_from_dict(case, "wave_gamma", shape=nWaves, dtype=float, default=0), float))

    w = _host(fowt.w, "frequencies")
    dw = w[1] - w[0]
    S = np.zeros((nWaves, len(w)))
    zeta = np.zeros((nWaves, len(w)), dtype=complex)
    for ih in range(nWaves):
        sp = spectrum[ih]
        if sp == "unit":
            S[ih, :] = 1.0
        elif sp == "constant":
            S[ih, :] = height[ih]
        elif sp == "JONSWAP":
            S[ih, :] = jonswap(w, height[ih], period[ih],
                               gamma=(gamma[ih] if gamma[ih] else None)).numpy()
        elif sp in ("none", "still"):
            S[ih, :] = 0.0
        else:
            raise ValueError(f"unknown wave spectrum '{sp}'")
        zeta[ih, :] = np.sqrt(2.0 * S[ih, :] * dw)
    return dict(beta=np.deg2rad(heading), S=S, zeta=zeta, nWaves=nWaves)


#: the MacCamy-Fuchs look of a sharded setup, read once for its shards
_MCF_KNOWN: list = []


@contextlib.contextmanager
def mcf_known(fowt: FOWTModel):
    """Inside: `fowt_hydro_constants` takes ``fowt``'s MacCamy-Fuchs look
    (any flagged node?) from ONE counted read made here, instead of one a
    call: a sharded setup's shards share it, so their pulls are the
    unsharded setup's."""
    _MCF_KNOWN.append(fowt.nodes.MCF is not None and bool(
        np.any(_host(fowt.nodes.MCF, "mcf_flags"))))
    try:
        yield
    finally:
        _MCF_KNOWN.pop()


def _host(x, what="fowt_constant"):
    """A host copy of ``x``; a tensor's comes through the counted
    ``obs.transfers.device_get``."""
    if isinstance(x, torch.Tensor):
        from raft_tpu_torch.obs import transfers
        return transfers.device_get(x, what=what)
    return np.asarray(x)


def fowt_bem_excitation(fowt: FOWTModel, seastate):
    """Potential-flow wave excitation per heading, (nH,6,nw) complex on
    the model's device (reference: raft_fowt.py:1034-1093).  Zero when no
    BEM data applies: the reference computes F_BEM only when a member is
    potential-flow modelled or potModMaster is 2/3 (raft_fowt.py:1040).
    The heading axis is a batch axis (a batch of cases' sea states)."""
    dev = fowt.device
    beta = as_real(seastate["beta"], dev).reshape(-1)
    nH = beta.shape[0]
    if fowt.bem is None or not (fowt.potMod_any
                                or fowt.potModMaster in (2, 3)):
        return torch.zeros((nH, 6, fowt.nw), dtype=COMPLEX, device=dev)
    zeta = torch.as_tensor(seastate["zeta"], device=dev).reshape(nH, -1)
    return bem_excitation(fowt.bem, beta, zeta, as_real(fowt.k, dev),
                          x_ref=fowt.x_ref, y_ref=fowt.y_ref,
                          heading_adjust=fowt.heading_adjust)


def fowt_hydro_excitation(fowt: FOWTModel, pose, seastate, hydro_consts):
    """Wave kinematics at all nodes + strip-theory inertial excitation
    (reference: raft_fowt.py:972-1149, strip part).  ``seastate`` holds
    beta (nH,) and zeta (nH, nw), numpy or tensors; the heading axis is a
    batch axis (a batch of cases' sea states is a batch of headings).
    Returns dict with u, ud (nH,N,3,nw), pDyn (nH,N,nw), F_hydro_iner
    (nH,6,nw)."""
    r = pose["r"]
    dev = r.device
    w = as_real(fowt.w, dev)
    k = as_real(fowt.k, dev)
    beta = as_real(seastate["beta"], dev).reshape(-1)
    zeta = to_device(seastate["zeta"], dev, COMPLEX)
    zeta = zeta.reshape(beta.shape[0], -1)

    u, ud, pDyn = wave_kinematics(zeta, beta, w, k, fowt.depth, r,
                                  rho=fowt.rho_water, g=fowt.g)
    # the reference additionally excludes z == 0 exactly (strict z<0)
    submerged = (r[..., 2] < 0.0).to(REAL)
    u = u * submerged[..., None, None]
    ud = ud * submerged[..., None, None]
    pDyn = pDyn * submerged[..., None]

    # inertial excitation: F = Imat @ ud + pDyn * a_i * q   per node
    # (Imat is (N,3,3,nw) complex when MacCamy-Fuchs members are present)
    Imat = hydro_consts["Imat"].to(COMPLEX)
    a_i = hydro_consts["a_i"]
    q = pose["q"]
    if Imat.dim() == 4:
        F_I = torch.einsum("nijw,hnjw->hniw", Imat, ud)
    else:
        F_I = torch.einsum("nij,hnjw->hniw", Imat, ud)
    F_nodes = F_I + pDyn[:, :, None, :] * (a_i[:, None] * q)[None, :, :, None]
    offsets = r - pose["r6"][:3]
    F_hydro_iner = torch.sum(_wrench_about_origin(F_nodes, offsets), dim=1)
    return dict(u=u, ud=ud, pDyn=pDyn, F_hydro_iner=F_hydro_iner)


def _wrench_about_origin(F_nodes, offsets):
    """Stack per-node 3-forces (..., N, 3, nw) with their moments r x F
    into 6-wrenches (..., N, 6, nw); offsets (..., N, 3)."""
    rx = offsets[..., None]

    def comp(i):
        return F_nodes[..., i, :]

    def rcomp(i):
        return rx[..., i, :]
    m0 = rcomp(1) * comp(2) - rcomp(2) * comp(1)
    m1 = rcomp(2) * comp(0) - rcomp(0) * comp(2)
    m2 = rcomp(0) * comp(1) - rcomp(1) * comp(0)
    mom = torch.stack([m0, m1, m2], dim=-2)
    return torch.cat([F_nodes, mom], dim=-2)


# --------------------------------------------------------------------------
# drag linearization & excitation
# --------------------------------------------------------------------------

def fowt_drag_precompute(fowt: FOWTModel, pose, u0):
    """Xi-independent pieces of the stochastic drag linearization (the
    node velocity is affine in the platform motions, so every RMS integral
    splits into a wave-only energy, a cross term linear in Xi and a
    quadratic form in the motion spectrum).  Rank-polymorphic over an
    optional leading batch.  Returns the dict consumed by
    `fowt_hydro_linearization_pre`."""
    r = pose["r"]
    dev = r.device
    offsets = r - pose["r6"][..., None, :3]
    q, p1, p2 = pose["q"], pose["p1"], pose["p2"]

    eye = torch.broadcast_to(torch.eye(3, dtype=REAL, device=dev),
                             offsets.shape[:-1] + (3, 3))
    # skew follows the reference's H-matrix convention (skew(r) @ th ==
    # th x r), so the rotational block enters with +
    T = torch.cat([eye, skew(offsets)], dim=-1)              # (...,N,3,6)

    def proj(vec):
        s = torch.einsum("...nc,...ncw->...nw", vec.to(u0.dtype), u0)
        g = torch.einsum("...nc,...ncj->...nj", vec, T)
        A = torch.sum(torch.abs(s) ** 2, dim=-1)
        return s, g, A

    s_q, g_q, A_q = proj(q)
    s_p1, g_p1, A_p1 = proj(p1)
    s_p2, g_p2, A_p2 = proj(p2)

    u_P = u0 - q[..., :, None] * s_q[..., None, :]           # perp wave vel
    K = T - q[..., :, None] * g_q[..., None, :]              # (...,N,3,6)
    A_P = torch.sum(torch.abs(u_P) ** 2, dim=(-2, -1))

    nd = lambda name: _nd(fowt, name, dev)  # noqa: E731
    a_q_eff = nd("a_i_q") * nd("Cd_q") + nd("a_i_end_drag") * nd("Cd_End")
    a_p1_eff = nd("a_i_p1") * nd("Cd_p1")
    a_p2_eff = nd("a_i_p2") * nd("Cd_p2")

    return dict(T=T, s_q=s_q, g_q=g_q, A_q=A_q,
                s_p1=s_p1, g_p1=g_p1, A_p1=A_p1,
                s_p2=s_p2, g_p2=g_p2, A_p2=A_p2,
                u_P=u_P, K=K, A_P=A_P,
                a_q_eff=a_q_eff, a_p1_eff=a_p1_eff, a_p2_eff=a_p2_eff,
                circ=nd("circ"))


def fowt_hydro_linearization_pre(fowt: FOWTModel, pose, pre, Xi):
    """Drag linearization about Xi using `fowt_drag_precompute` constants
    (reference: raft_fowt.py:1152-1266).  Returns (B_hydro_drag (6,6),
    Bmat (N,3,3))."""
    rho = fowt.rho_water
    r = pose["r"]
    w = as_real(fowt.w, r.device)
    offsets = r - pose["r6"][..., None, :3]
    submerged = r[..., 2] < 0.0

    iwXi = (1j * w) * Xi                                     # (...,6,nw)
    # The contractions over a lane's own axes are element-wise products
    # and a sum per output, not batched GEMMs (einsum): the card rounds a
    # batched GEMM by batch size, and a lane of a sweep should not depend
    # on the lanes solved beside it.  On the card this makes a batch of a
    # few dozen lanes or more give each lane bitwise what the whole table
    # gives it (sweep_cases_chunked's chunks); below that PyTorch's sums
    # split a reduction differently.  probe_drag_forms.py measures both.
    xr = torch.view_as_real(iwXi)                            # (...,6,nw,2)

    def re_dot(a, extra):
        """Re(sum_w iwXi[..., j, w] conj(a[..., w])) for each DOF j, on a
        new last axis; ``a`` has ``extra`` axes between the batch and w.
        One DOF at a time, so no temporary is 6x the size of ``a``."""
        ar = torch.view_as_real(a)
        pick = (...,) + (None,) * extra + (slice(None), slice(None))
        return torch.stack([torch.sum(ar * xr[..., j, :, :][pick],
                                      dim=(-2, -1)) for j in range(6)],
                           dim=-1)

    # motion spectrum quadratic form: M[j,k] = sum_w w^2 Re(Xi_j Xi_k*)
    M_re = torch.sum(xr[..., :, None, :, :] * xr[..., None, :, :, :],
                     dim=(-2, -1))

    def rms_scalar(s, g, A):
        b = re_dot(s, 1)                                     # (...,N,6)
        cross = torch.sum(g * b, dim=-1)
        quad = torch.sum(g[..., :, :, None] * M_re[..., None, :, :]
                         * g[..., :, None, :], dim=(-2, -1))
        return torch.sqrt(torch.clamp(0.5 * (A - 2.0 * cross + quad), min=0.0))

    vRMS_q = rms_scalar(pre["s_q"], pre["g_q"], pre["A_q"])
    vRMS_p1c = rms_scalar(pre["s_p1"], pre["g_p1"], pre["A_p1"])
    vRMS_p2c = rms_scalar(pre["s_p2"], pre["g_p2"], pre["A_p2"])

    K = pre["K"]
    D = re_dot(pre["u_P"], 2)                                # (...,N,3,6)
    cross_P = torch.sum(K * D, dim=(-2, -1))
    quad_P = torch.sum(K[..., :, :, :, None] * M_re[..., None, None, :, :]
                       * K[..., :, :, None, :], dim=(-3, -2, -1))
    vRMS_p = torch.sqrt(torch.clamp(
        0.5 * (pre["A_P"] - 2.0 * cross_P + quad_P), min=0.0))

    circ = pre["circ"]
    vRMS_p1 = torch.where(circ, vRMS_p, vRMS_p1c)
    vRMS_p2 = torch.where(circ, vRMS_p, vRMS_p2c)

    c = math.sqrt(8.0 / math.pi) * 0.5 * rho
    Bq_end = c * vRMS_q * pre["a_q_eff"]
    Bp1 = c * vRMS_p1 * pre["a_p1_eff"]
    Bp2 = c * vRMS_p2 * pre["a_p2_eff"]

    Bmat = (Bq_end[..., None, None] * pose["qMat"]
            + Bp1[..., None, None] * pose["p1Mat"]
            + Bp2[..., None, None] * pose["p2Mat"])
    Bmat = Bmat * submerged[..., None, None].to(REAL)
    B_hydro_drag = torch.sum(translate_matrix_3to6(Bmat, offsets), dim=-3)
    return B_hydro_drag, Bmat


def fowt_drag_excitation(fowt: FOWTModel, pose, Bmat, u_h):
    """Linearized drag excitation for wave velocities u_h (...,N,3,nw)
    (reference: raft_fowt.py:1270-1293); rank-polymorphic over a leading
    heading axis."""
    F_nodes = torch.einsum("...nij,...njw->...niw", Bmat.to(COMPLEX), u_h)
    offsets = pose["r"] - pose["r6"][..., None, :3]
    return torch.sum(_wrench_about_origin(F_nodes, offsets), dim=-3)


def fowt_current_loads(fowt: FOWTModel, pose, speed, heading_deg):
    """Mean current drag about the PRP (reference: raft_fowt.py:
    1297-1382)."""
    r = pose["r"]
    dev = r.device
    rho = fowt.rho_water
    submerged = r[:, 2] < 0.0

    Zref = 0.0
    for rot in fowt.rotors:
        if rot.hubHt < 0:
            Zref = rot.hubHt
    v = speed * ((fowt.depth - torch.abs(r[:, 2]))
                 / (fowt.depth + Zref)) ** fowt.shearExp_water
    h = math.radians(heading_deg)
    vcur = torch.stack([v * math.cos(h), v * math.sin(h), torch.zeros_like(v)],
                       dim=-1)

    q, p1, p2 = pose["q"], pose["p1"], pose["p2"]
    vq = torch.sum(vcur * q, dim=1)[:, None] * q
    vp = vcur - vq
    vp1 = torch.sum(vcur * p1, dim=1)[:, None] * p1
    vp2 = torch.sum(vcur * p2, dim=1)[:, None] * p2
    circ = _nd(fowt, "circ", dev)
    nq = torch.linalg.norm(vq, dim=1)
    np_ = torch.linalg.norm(vp, dim=1)
    np1 = torch.where(circ, np_, torch.linalg.norm(vp1, dim=1))
    np2 = torch.where(circ, np_, torch.linalg.norm(vp2, dim=1))

    nd = lambda name: _nd(fowt, name, dev)  # noqa: E731
    Dq = 0.5 * rho * nd("a_i_q") * nd("Cd_q")
    Dp1 = 0.5 * rho * nd("a_i_p1") * nd("Cd_p1")
    Dp2 = 0.5 * rho * nd("a_i_p2") * nd("Cd_p2")
    Dend = 0.5 * rho * nd("a_i_end_drag") * nd("Cd_End")
    D = (Dq[:, None] * nq[:, None] * vq + Dp1[:, None] * np1[:, None] * vp1
         + Dp2[:, None] * np2[:, None] * vp2 + Dend[:, None] * nq[:, None] * vq)
    D = D * submerged[:, None].to(REAL)
    offsets = r - pose["r6"][:3]
    return torch.sum(translate_force_3to6(D, offsets), dim=0)


# --------------------------------------------------------------------------
# turbine constants
# --------------------------------------------------------------------------

def fowt_turbine_constants(fowt: FOWTModel, case: dict, r6,
                           transfer_heading=None):
    """Aero-servo matrices/forces about the PRP + gyroscopic damping
    (reference: raft_fowt.py:773-845).

    ``transfer_heading`` (rad, per-rotor list or scalar) reproduces the
    reference's stale hub->PRP transfer offset (see the JAX module); None
    uses the current case heading."""
    dev = fowt.device
    f64 = dict(dtype=REAL, device=dev)
    r6 = as_real(r6, dev)
    nw = fowt.nw
    nrot = fowt.nrotors
    A_aero = torch.zeros((6, 6, nw, nrot), **f64)
    B_aero = torch.zeros((6, 6, nw, nrot), **f64)
    f_aero = torch.zeros((6, nw, nrot), dtype=COMPLEX, device=dev)
    f_aero0 = torch.zeros((6, nrot), **f64)
    B_gyro = torch.zeros((6, 6, nrot), **f64)

    status = str(get_from_dict(case, "turbine_status", shape=0, dtype=str,
                               default="operating"))
    if status != "operating":
        return dict(A_aero=A_aero, B_aero=B_aero, f_aero=f_aero,
                    f_aero0=f_aero0, B_gyro=B_gyro)

    w = as_real(fowt.w, dev)
    for ir, rot in enumerate(fowt.rotors):
        current = rot.hubHt < 0
        speed = float(get_from_dict(case, "current_speed", shape=0, default=1.0)) \
            if current else float(get_from_dict(case, "wind_speed", shape=0, default=10.0))
        if rot.aeroServoMod > 0 and speed > 0.0:
            out = calc_aero(rot, w, case, r6=r6, current=current)
            pose_r = out["pose"]
            if transfer_heading is None:
                r_hub_rel = pose_r["r_hub"] - r6[:3]
            else:
                th = (transfer_heading[ir]
                      if np.ndim(transfer_heading) else transfer_heading)
                pose_t = rotor_pose(
                    rot, r6, inflow_heading=float(th),
                    turbine_heading=np.radians(float(get_from_dict(
                        case, "turbine_heading", shape=0, default=0.0))),
                    yaw_command=np.radians(float(get_from_dict(
                        case, "yaw_misalign", shape=0, default=0.0))))
                r_hub_rel = pose_t["r_hub"] - r6[:3]
            a = out["a"].movedim(-1, 0)     # (nw,6,6)
            b = out["b"].movedim(-1, 0)
            A_aero[:, :, :, ir] = translate_matrix_6to6(a, r_hub_rel).movedim(0, -1)
            B_aero[:, :, :, ir] = translate_matrix_6to6(b, r_hub_rel).movedim(0, -1)
            f_aero0[:, ir] = transform_force(out["f0"], offset=r_hub_rel)
            f_h = out["f"].movedim(-1, 0)   # (nw,6)
            f_aero[:, :, ir] = transform_force(f_h, offset=r_hub_rel).movedim(0, -1)
            # gyroscopic damping (reference :829-840)
            Omega_rpm = float(np.interp(speed, np.asarray(rot.Uhub_ops),
                                        np.asarray(rot.Omega_rpm_ops)))
            IO = rot.I_drivetrain * pose_r["q"] * Omega_rpm * 2 * math.pi / 60.0
            B_gyro[3:, 3:, ir] = skew(IO)
    return dict(A_aero=A_aero, B_aero=B_aero, f_aero=f_aero, f_aero0=f_aero0,
                B_gyro=B_gyro)
