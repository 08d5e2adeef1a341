"""Quasi-static mooring with free points, multi-segment and shared lines.

Port of ``raft_tpu/models/mooring_array.py`` (reference: the MoorPy
``System`` the reference builds for general mooring topologies,
raft/raft_fowt.py:166-189, and for farms, raft/raft_model.py:83-100, and
its equilibrium, stiffness and tension calls, raft/raft_model.py:600-606,
:1029-1031 and :345-388).  One system serves one FOWT (a design's
``mooring`` with free points) or a whole array (``parse_moordyn``: the
farm's MoorDyn file, lines shared between N bodies).

- points: FIXED anchors (global coordinates), FREE points (clump weights,
  buoys, junctions of multi-segment lines; their positions are solved to
  static equilibrium) and points attached to any of the N bodies
  (body-frame coordinates);
- lines: the elastic catenary of ``models.mooring`` between arbitrary
  end elevations, differentiated through its last Newton step only
  (``grad_steps=1``: the free-point Newton differentiates it 40 times a
  solve, and through all 40 catenary steps that costs ~30x more).  The seabed-contact branch is enabled only for lines
  whose lower end is a fixed anchor on the seabed (a static per-line
  mask); a line suspended between elevated points keeps the suspended
  branch, which holds for a negative lower-end vertical force.

Everything is tensor code, differentiable end to end and safe under
``torch.func.vmap``:

- the free-point equilibrium is a damped Newton of a fixed 40 steps
  (``torch.func.jacfwd`` Jacobian, a 1e-6 ridge, steps clipped to 30 m;
  the 3 n_free system goes to ``torch.linalg.solve``, as the JAX package
  uses ``jnp.linalg.solve`` outside any kernel);
- the body wrenches are (N, 6); the coupled body stiffness, (6N, 6N),
  eliminates the free points by the implicit-function theorem (a Schur
  complement), the exact counterpart of MoorPy's
  ``getCoupledStiffnessA``:
      K = -( dFb/dXb - dFb/dxf (dg/dxf)^-1 dg/dXb )     with g(xf; Xb) = 0
- the tension Jacobian, over all 6N body DOFs, gets the same implicit
  correction.

The point-to-line bookkeeping (which line ends load which point) is a
pair of dense incidence matrices built from the static topology.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch._config import REAL, as_real
from raft_tpu_torch.models.mooring import catenary_solve, chord_drag
from raft_tpu_torch.ops.transforms import rotation_matrix, translate_force_3to6

_G = 9.81
_RHO = 1025.0

ATTACH_FIXED = -1
ATTACH_FREE = -2

#: [N/m] seabed normal-contact stiffness for free points (the MoorDyn
#: kbot analogue)
_KBOT_POINT = 1e5


@dataclass
class ArrayMooring:
    """Static description of a mooring system with free points: numpy
    arrays at parse time; after ``convert.state_from_numpy`` the float
    arrays are tensors on the device and the topology stays numpy."""

    depth: float
    nbodies: int
    # points
    attach: np.ndarray      # (npt,) ATTACH_FIXED | ATTACH_FREE | body index
    r0: np.ndarray          # (npt,3) body-frame (body pts) or global coords
    pmass: np.ndarray       # (npt,) point mass [kg]
    pvol: np.ndarray        # (npt,) point displaced volume [m^3]
    free_idx: np.ndarray    # (npt,) row into the free-point vector, -1 else
    # lines
    iA: np.ndarray          # (nl,) endpoint A point index
    iB: np.ndarray          # (nl,) endpoint B point index
    L: np.ndarray           # (nl,) unstretched length
    EA: np.ndarray          # (nl,) axial stiffness
    w: np.ndarray           # (nl,) submerged weight per length [N/m]
    contact_ok: np.ndarray  # (nl,) bool: lower end is a seabed anchor
    g: float = _G
    rho: float = _RHO
    d_vol: np.ndarray = None   # (nl,) volume-equivalent line diameter
    Cd_t: np.ndarray = None    # (nl,) transverse drag coefficient
    Cd_a: np.ndarray = None    # (nl,) tangential (axial) drag coefficient

    @property
    def n_free(self) -> int:
        return int((np.asarray(self.attach) == ATTACH_FREE).sum())

    @property
    def n_lines(self) -> int:
        return len(self.iA)


# --------------------------------------------------------------------------
# MoorDyn-format parsing (the reference loads the same file through MoorPy's
# System.load)
# --------------------------------------------------------------------------

_BODY_RE = re.compile(r"^(?:turbine|body|vessel|coupled)(\d*)$", re.I)


def parse_moordyn(path: str, nbodies: int, depth: float | None = None,
                  rho: float = _RHO, g: float = _G) -> ArrayMooring:
    """Parse the sections of a MoorDyn v2 input file that define a
    quasi-static system: LINE TYPES, POINTS, LINES and the WtrDpth option
    (``raft_tpu/models/mooring_array.py:parse_moordyn``, field for field).

    Body attachments named ``Turbine<i>``/``Body<i>`` map to body ``i-1``;
    their coordinates are body-frame (MoorPy attaches them relative to the
    FOWT bodies, reference raft_model.py:93-97)."""
    sections: dict[str, list[str]] = {}
    current = None
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("---"):
                current = line.strip("- ").upper()
                sections[current] = []
            elif current is not None:
                sections[current].append(line)

    def section(key, n_header=2):
        for name, rows in sections.items():
            if key in name:
                return rows[n_header:]   # drop the names and units rows
        return []

    types = {}
    for row in section("LINE TYPES"):
        c = row.split()
        d, m, EA = float(c[1]), float(c[2]), float(c[3])
        w_wet = (m - rho * np.pi / 4.0 * d**2) * g
        types[c[0]] = dict(d=d, m=m, EA=EA, w=w_wet,
                           Cd=float(c[6]) if len(c) > 6 else 0.0,
                           CdAx=float(c[8]) if len(c) > 8 else 0.0)

    for row in section("OPTIONS", n_header=0):
        c = row.split()
        if len(c) >= 2 and c[1].lower() in ("wtrdpth", "depth", "wtrdepth"):
            depth = float(c[0])
    if depth is None:
        raise ValueError("water depth not found in MoorDyn file or args")

    ids, attach, r0, pmass, pvol = [], [], [], [], []
    for row in section("POINTS"):
        c = row.split()
        ids.append(int(c[0]))
        a = c[1].lower()
        if a in ("fixed", "fix", "anchor"):
            attach.append(ATTACH_FIXED)
        elif a in ("free", "connect"):
            attach.append(ATTACH_FREE)
        else:
            mm = _BODY_RE.match(a)
            if not mm:
                raise ValueError(f"unknown point attachment {c[1]!r}")
            attach.append(int(mm.group(1) or 1) - 1)
        r0.append([float(c[2]), float(c[3]), float(c[4])])
        pmass.append(float(c[5]))
        pvol.append(float(c[6]))
    ids = np.array(ids)
    attach = np.array(attach)
    r0 = np.array(r0)
    if attach.size and attach.max() >= nbodies:
        raise ValueError(
            f"MoorDyn file references body {attach.max()+1} but the array "
            f"has only {nbodies} FOWTs")

    id2row = {pid: i for i, pid in enumerate(ids)}
    free_idx = np.full(len(ids), -1)
    free_idx[attach == ATTACH_FREE] = np.arange((attach == ATTACH_FREE).sum())

    iA, iB, L, EA, w = [], [], [], [], []
    d_vol, Cd_t, Cd_a = [], [], []
    for row in section("LINES"):
        c = row.split()
        lt = types[c[1]]
        iA.append(id2row[int(c[2])])
        iB.append(id2row[int(c[3])])
        L.append(float(c[4]))
        EA.append(lt["EA"])
        w.append(lt["w"])
        d_vol.append(lt["d"])
        Cd_t.append(lt["Cd"])
        Cd_a.append(lt["CdAx"])
    iA, iB = np.array(iA), np.array(iB)

    # seabed contact only for lines whose lower end is a fixed anchor on
    # the seabed
    def on_seabed(ipt):
        return (attach[ipt] == ATTACH_FIXED) & (r0[ipt, 2] <= -depth + 1.0)

    return ArrayMooring(
        depth=float(depth), nbodies=nbodies,
        attach=attach, r0=r0, pmass=np.array(pmass), pvol=np.array(pvol),
        free_idx=free_idx,
        iA=iA, iB=iB, L=np.array(L), EA=np.array(EA), w=np.array(w),
        contact_ok=on_seabed(iA) | on_seabed(iB), g=g, rho=rho,
        d_vol=np.array(d_vol), Cd_t=np.array(Cd_t), Cd_a=np.array(Cd_a))


# --------------------------------------------------------------------------
# kinematics & forces
# --------------------------------------------------------------------------

def _incidence(ms: ArrayMooring, dev):
    """(IA, IB), (npt, nl) each: IA[p, l] = 1 where line l's end A is
    point p, so ``IA @ FA`` sums the end-A forces onto the points."""
    npt, nl = len(np.asarray(ms.attach)), ms.n_lines
    IA, IB = np.zeros((npt, nl)), np.zeros((npt, nl))
    IA[np.asarray(ms.iA), np.arange(nl)] = 1.0
    IB[np.asarray(ms.iB), np.arange(nl)] = 1.0
    return as_real(IA, dev), as_real(IB, dev)


def _free_rows(ms: ArrayMooring):
    return np.where(np.asarray(ms.attach) == ATTACH_FREE)[0]


def point_positions(ms: ArrayMooring, Xb, xf, delta=None):
    """Global point positions, (npt, 3).  Xb: (nb, 6) body poses; xf:
    (nf, 3) free-point positions.  ``delta`` ((nb, 6), optional) moves
    each body by a translation delta[:, :3] and a left-composed rotation
    R(delta[:, 3:]) @ R0 — the rotation-vector parameterization of the
    MoorPy-parity stiffness (`coupled_stiffness_rotvec`)."""
    Xb = as_real(Xb)
    dev = Xb.device
    attach = np.asarray(ms.attach)
    r0 = as_real(ms.r0, dev)
    R = rotation_matrix(Xb[:, 3], Xb[:, 4], Xb[:, 5])        # (nb,3,3)
    base = Xb[:, :3]
    if delta is not None:
        delta = as_real(delta, dev)
        dR = rotation_matrix(delta[:, 3], delta[:, 4], delta[:, 5])
        R = torch.einsum("bij,bjk->bik", dR, R)
        base = base + delta[:, :3]
    bidx = torch.as_tensor(np.clip(attach, 0, ms.nbodies - 1), device=dev)
    body_pos = base[bidx] + torch.einsum("pij,pj->pi", R[bidx], r0)
    nf = ms.n_free
    if nf:
        fidx = torch.as_tensor(np.clip(np.asarray(ms.free_idx), 0, nf - 1),
                               device=dev)
        free_pos = as_real(xf, dev)[fidx]
    else:
        free_pos = torch.zeros_like(r0)
    is_body = torch.as_tensor(attach >= 0, device=dev)[:, None]
    is_free = torch.as_tensor(attach == ATTACH_FREE, device=dev)[:, None]
    return torch.where(is_body, body_pos, torch.where(is_free, free_pos, r0))


def line_end_forces(ms: ArrayMooring, pts):
    """Per-line forces exerted BY each line ON its two end points, and the
    end tensions: (FA, FB, TA, TB), F* (nl, 3), with TA belonging to
    end A of the line as defined (MoorPy's per-line TA/TB)."""
    dev = pts.device
    rA = pts[torch.as_tensor(np.asarray(ms.iA), device=dev)]
    rB = pts[torch.as_tensor(np.asarray(ms.iB), device=dev)]
    flip = rA[:, 2] > rB[:, 2]          # A above B -> A is the upper end
    rLow = torch.where(flip[:, None], rB, rA)
    rUp = torch.where(flip[:, None], rA, rB)

    dxy = rUp[:, :2] - rLow[:, :2]
    XF = torch.linalg.norm(dxy, dim=1)
    ZF = rUp[:, 2] - rLow[:, 2]
    sol = catenary_solve(
        XF, ZF, as_real(ms.L, dev), as_real(ms.EA, dev), as_real(ms.w, dev),
        contact_allowed=torch.as_tensor(np.asarray(ms.contact_ok, bool),
                                        device=dev), grad_steps=1)

    dir_h = dxy / torch.where(XF > 1e-8, XF, 1.0)[:, None]
    # upper end: the line pulls down and toward the lower end; lower end:
    # toward the upper end
    F_up = torch.cat([-sol["H"][:, None] * dir_h, -sol["V"][:, None]], dim=1)
    F_low = torch.cat([sol["Ha"][:, None] * dir_h, sol["Va"][:, None]], dim=1)
    FA = torch.where(flip[:, None], F_up, F_low)
    FB = torch.where(flip[:, None], F_low, F_up)
    TA = torch.where(flip, sol["TB"], sol["TA"])
    TB = torch.where(flip, sol["TA"], sol["TB"])
    return FA, FB, TA, TB


def _point_forces(ms: ArrayMooring, pts):
    """Net line force on every point, (npt, 3)."""
    FA, FB, _, _ = line_end_forces(ms, pts)
    IA, IB = _incidence(ms, pts.device)
    return IA @ FA + IB @ FB


def free_net_force(ms: ArrayMooring, Xb, xf, delta=None):
    """Equilibrium residual of the free points: line forces, weight,
    buoyancy and the seabed's normal contact (a linear penalty below
    z = -depth), (nf, 3)."""
    pts = point_positions(ms, Xb, xf, delta=delta)
    dev = pts.device
    F = _point_forces(ms, pts)
    Wz = (-as_real(ms.pmass, dev) * ms.g
          + as_real(ms.pvol, dev) * ms.rho * ms.g)
    Fz = F[:, 2] + Wz + _KBOT_POINT * torch.clamp(-ms.depth - pts[:, 2],
                                                  min=0.0)
    F = torch.cat([F[:, :2], Fz[:, None]], dim=1)
    return F[torch.as_tensor(_free_rows(ms), device=dev)]


def solve_free_points(ms: ArrayMooring, Xb, xf0=None, iters: int = 40,
                      step_max: float = 30.0):
    """Damped-Newton equilibrium of the free points, (nf, 3): a fixed
    ``iters`` steps, so it runs unchanged under ``torch.func.vmap`` (the
    MoorPy analogue is System.solveEquilibrium over the free DOFs,
    reference raft_model.py:600-606).  Starts from ``xf0``, by default
    the points' input positions."""
    Xb = as_real(Xb)
    dev = Xb.device
    if ms.n_free == 0:
        return torch.zeros((0, 3), dtype=REAL, device=dev)
    if xf0 is None:
        xf0 = as_real(ms.r0, dev)[torch.as_tensor(_free_rows(ms), device=dev)]
    x = as_real(xf0, dev).reshape(-1)
    ridge = 1e-6 * torch.eye(x.shape[0], dtype=REAL, device=dev)

    def resid(x):
        r = free_net_force(ms, Xb, x.reshape(-1, 3)).reshape(-1)
        return r, r

    jac = torch.func.jacfwd(resid, has_aux=True)
    for _ in range(int(iters)):
        J, r = jac(x)
        dx = torch.linalg.solve(J + ridge, -r)
        x = x + torch.clamp(dx, -step_max, step_max)
    return x.reshape(-1, 3)


def _body_sum(ms: ArrayMooring, Fp, pts, base):
    """(nb, 6): each body's wrench about ``base[b]`` of the point forces
    ``Fp`` (npt, 3) at the points attached to it."""
    attach = np.asarray(ms.attach)
    out = []
    for b in range(ms.nbodies):
        mask = torch.as_tensor((attach == b).astype(float), dtype=REAL,
                               device=pts.device)[:, None]
        out.append(torch.sum(translate_force_3to6(Fp * mask, pts - base[b]),
                             dim=0))
    return torch.stack(out)


def current_wrenches(ms: ArrayMooring, Xb, xf, U):
    """Uniform-current drag on the lines lumped to the attached bodies,
    (nb, 6): the chord-direction approximation of MoorPy's currentMod=1
    (reference raft_model.py:559-578), half of each line's drag at each
    end; free and fixed ends shed their share."""
    Xb = as_real(Xb)
    dev = Xb.device
    if ms.Cd_t is None:
        return torch.zeros((ms.nbodies, 6), dtype=REAL, device=dev)
    pts = point_positions(ms, Xb, xf)
    rA = pts[torch.as_tensor(np.asarray(ms.iA), device=dev)]
    rB = pts[torch.as_tensor(np.asarray(ms.iB), device=dev)]
    F_line = chord_drag(rA, rB, U, ms.L, ms.d_vol, ms.Cd_t, ms.Cd_a, ms.rho)
    IA, IB = _incidence(ms, dev)
    Fp = IA @ (0.5 * F_line) + IB @ (0.5 * F_line)
    return _body_sum(ms, Fp, pts, Xb[:, :3])


def body_wrenches(ms: ArrayMooring, Xb, xf, delta=None):
    """6-DOF mooring wrench on each body about its pose reference point,
    (nb, 6) (Body.getForces(lines_only=True)).  ``delta`` perturbs the
    body poses as in `point_positions` (the reference point moves with
    the body)."""
    Xb = as_real(Xb)
    pts = point_positions(ms, Xb, xf, delta=delta)
    base = Xb[:, :3]
    if delta is not None:
        base = base + as_real(delta, Xb.device)[:, :3]
    return _body_sum(ms, _point_forces(ms, pts), pts, base)


# --------------------------------------------------------------------------
# equilibrium-coupled quantities (implicit function / Schur complement)
# --------------------------------------------------------------------------

def _implicit_sensitivity(g, xb_arg, xf_flat, n_free):
    """d(xf)/d(xb) at equilibrium: -(dg/dxf)^-1 (dg/dxb), the one
    regularized free-point elimination behind both stiffness flavours and
    the tension Jacobian."""
    nf3 = n_free * 3
    dg_dxf = torch.func.jacfwd(lambda xf: g(xb_arg, xf))(xf_flat)
    dg_dxb = torch.func.jacfwd(lambda xb: g(xb, xf_flat))(xb_arg)
    eye = torch.eye(nf3, dtype=REAL, device=xf_flat.device)
    return -torch.linalg.solve(dg_dxf + 1e-9 * eye, dg_dxb)


def _implicit_dxf_dXb(ms: ArrayMooring, Xb_flat, xf_eq):
    """d(xf)/d(Xb) at equilibrium for the Euler pose parameterization."""

    def g(xb, xf):
        return free_net_force(ms, xb.reshape(-1, 6),
                              xf.reshape(-1, 3)).reshape(-1)

    return _implicit_sensitivity(g, Xb_flat, as_real(xf_eq).reshape(-1),
                                 ms.n_free)


def _schur_coupled(fb, g, xb_arg, xf_flat, n_free):
    """-d(fb)/d(xb) at equilibrium with the free points eliminated (the
    Schur complement over the free DOFs), shared by both body
    parameterizations (Euler pose vector and rotation-vector delta)."""
    dfb_dxb = torch.func.jacfwd(lambda xb: fb(xb, xf_flat))(xb_arg)
    if n_free == 0:
        return -dfb_dxb
    dxf_dxb = _implicit_sensitivity(g, xb_arg, xf_flat, n_free)
    dfb_dxf = torch.func.jacfwd(lambda xf: fb(xb_arg, xf))(xf_flat)
    return -(dfb_dxb + dfb_dxf @ dxf_dxb)


def coupled_stiffness(ms: ArrayMooring, Xb, xf_eq):
    """(6nb, 6nb) coupled mooring stiffness about the body poses with the
    free points eliminated — MoorPy's getCoupledStiffnessA(lines_only=True)
    by exact forward-mode differentiation."""
    Xb_flat = as_real(Xb).reshape(-1)
    xf_flat = as_real(xf_eq, Xb_flat.device).reshape(-1)

    def fb(xb, xf):
        return body_wrenches(ms, xb.reshape(-1, 6),
                             xf.reshape(-1, 3)).reshape(-1)

    def g(xb, xf):
        return free_net_force(ms, xb.reshape(-1, 6),
                              xf.reshape(-1, 3)).reshape(-1)

    return _schur_coupled(fb, g, Xb_flat, xf_flat, ms.n_free)


def coupled_stiffness_rotvec(ms: ArrayMooring, Xb, xf_eq):
    """(6nb, 6nb) MoorPy-parity analytic coupled stiffness: the exact
    ROTATION-VECTOR linearization of the body wrenches, free points
    eliminated by the shared Schur complement (see
    ``mooring.coupled_stiffness_rotvec``)."""
    Xb = as_real(Xb)
    xf_flat = as_real(xf_eq, Xb.device).reshape(-1)
    d0 = torch.zeros(Xb.numel(), dtype=REAL, device=Xb.device)

    def fb(d, xf):
        return body_wrenches(ms, Xb, xf.reshape(-1, 3),
                             delta=d.reshape(-1, 6)).reshape(-1)

    def g(d, xf):
        return free_net_force(ms, Xb, xf.reshape(-1, 3),
                              delta=d.reshape(-1, 6)).reshape(-1)

    return _schur_coupled(fb, g, d0, xf_flat, ms.n_free)


def tensions(ms: ArrayMooring, Xb, xf):
    """Line end tensions, (2 nl,): [TA_1..TA_n, TB_1..TB_n] (MoorPy's
    getTensions order)."""
    pts = point_positions(ms, as_real(Xb), xf)
    _, _, TA, TB = line_end_forces(ms, pts)
    return torch.cat([TA, TB])


def tension_jacobian(ms: ArrayMooring, Xb, xf_eq):
    """d(tensions)/d(body poses) with the implicit free-point correction,
    (2 nl, 6 nb) — the J_moor of getCoupledStiffness(..., tensions=True)."""
    Xb_flat = as_real(Xb).reshape(-1)
    xf_flat = as_real(xf_eq, Xb_flat.device).reshape(-1)

    def T(xb, xf):
        return tensions(ms, xb.reshape(-1, 6), xf.reshape(-1, 3))

    dT_dxb = torch.func.jacfwd(lambda xb: T(xb, xf_flat))(Xb_flat)
    if ms.n_free == 0:
        return dT_dxb
    dT_dxf = torch.func.jacfwd(lambda xf: T(Xb_flat, xf))(xf_flat)
    return dT_dxb + dT_dxf @ _implicit_dxf_dXb(ms, Xb_flat, xf_eq)
