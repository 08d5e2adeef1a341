"""Second-order difference-frequency hydrodynamics: the QTF engine.

Port of ``raft_tpu/models/qtf.py`` (reference: raft/raft_fowt.py:
1385-1648 calcQTF_slenderBody, :1651-1725 readQTF/writeQTF, :1728-1818
calcHydroForce_2ndOrd).  All strip nodes are stacked on one axis (the
first-order hydro's node set); `qtf_fields` precomputes every per-
frequency node field on the second-order grid and the waterline-crossing
members' fields (host-side geometry selection), and the (w1, w2) pair
grid goes through kernel K5 (``ops/kernels/qtf_pair.py``: the CUDA
kernel on the card, its plain version on the CPU).  The lower triangle
is masked out and filled by Hermitian symmetry afterwards, as the
reference does.

Conventions are the JAX package's: headings in radians throughout, the
symmetric velocity gradient, and the reference's "last submerged node's
Ca" in the waterline term.  The Kim & Yue correction of MacCamy-Fuchs
members (`kim_yue_correction`, plain PyTorch on the model's device, as
the JAX package computes it outside its Pallas kernel) is added to the
raw pair grid before the Hermitian completion.  The ``.12d`` / ``.4``
readers and writers are host numpy, byte-compatible with the JAX
package's files.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from raft_tpu_torch._config import COMPLEX, REAL, as_real
from raft_tpu_torch.ops.kernels.qtf_pair import (check_dry_nodes,
                                                 qtf_pair_grid)
from raft_tpu_torch.ops.special import hankel1p_all
from raft_tpu_torch.ops.waves import (
    wave_kinematics, kinematics_from_motion, wave_vel_gradient,
    wave_pres1st_gradient,
)


@dataclass
class QTFData:
    """A QTF matrix on its own (coarse) frequency grid: qtf (nw2, nw2, nh,
    6) complex, Hermitian in the two frequency axes; host numpy."""

    heads_rad: np.ndarray
    w: np.ndarray
    qtf: np.ndarray


# --------------------------------------------------------------------------
# .12d / .4 file I/O  (reference: raft_fowt.py:1420-1433, 1651-1725)
# --------------------------------------------------------------------------

def read_qtf_12d(path: str, rho: float = 1025.0, g: float = 9.81,
                 ULEN: float = 1.0) -> QTFData:
    """Read a WAMIT .12d difference-frequency QTF file (columns T1 T2
    head1 head2 DOF |F| phase Re Im, periods in seconds).  Unidirectional
    QTFs only; the file holds one triangle, the other is filled by
    Hermitian symmetry."""
    data = np.loadtxt(path)
    w12 = 2.0 * np.pi / data[:, 0:2]
    if not np.allclose(data[:, 2], data[:, 3]):
        raise ValueError("only unidirectional QTFs are supported")
    heads = np.sort(np.unique(data[:, 2]))
    w1 = np.unique(w12[:, 0])
    w2 = np.unique(w12[:, 1])
    if not (len(w1) == len(w2) and np.allclose(w1, w2)):
        raise ValueError("both frequency columns must contain the same values")

    qtf = np.zeros([len(w1), len(w2), len(heads), 6], dtype=complex)
    for row, (ww1, ww2) in zip(data, w12):
        i1 = int(np.argmin(np.abs(w1 - ww1)))
        i2 = int(np.argmin(np.abs(w2 - ww2)))
        ih = int(np.argmin(np.abs(heads - row[2])))
        idof = int(round(row[4])) - 1
        factor = rho * g * ULEN * (ULEN if idof >= 3 else 1.0)
        val = factor * (row[7] + 1j * row[8])
        qtf[i1, i2, ih, idof] = val
        if i1 != i2:
            qtf[i2, i1, ih, idof] = np.conj(val)
    nbad = int((~np.isfinite(qtf)).sum())
    if nbad:
        raise ValueError(
            f"QTF .12d file '{path}': {nbad} non-finite value(s) — the "
            f"file is corrupt or truncated; delete it (and its .key "
            f"checkpoint) and re-run the QTF computation")
    return QTFData(heads_rad=np.deg2rad(heads), w=w1, qtf=qtf)


def write_qtf_12d(path: str, qtf, w, heads_rad, rho: float = 1025.0,
                  g: float = 9.81) -> None:
    """Write the upper triangle of a (nw, nw, nh, 6) QTF in .12d format,
    ih-major / DOF / upper-triangle row order, rows formatted
    ``% .8e`` / ``%d`` (byte-identical to the JAX package's writer)."""
    w = np.asarray(w)
    qtf = np.asarray(qtf)
    heads = np.atleast_1d(heads_rad)
    ULEN = 1.0
    nh = len(heads)
    i1, i2 = np.triu_indices(len(w))
    F = np.moveaxis(qtf[i1, i2, :, :], 0, -1) / (rho * g * ULEN)
    rows = np.empty((nh, 6, i1.size, 9), float)
    rows[..., 0] = 2.0 * np.pi / w[i1]
    rows[..., 1] = 2.0 * np.pi / w[i2]
    rows[..., 2] = np.rad2deg(heads)[:, None, None]
    rows[..., 3] = rows[..., 2]
    rows[..., 4] = (np.arange(6) + 1.0)[None, :, None]
    rows[..., 5] = np.abs(F)
    rows[..., 6] = np.angle(F)
    rows[..., 7] = F.real
    rows[..., 8] = F.imag
    with open(path, "w") as f:
        np.savetxt(f, rows.reshape(-1, 9),
                   fmt="% .8e % .8e % .8e % .8e %d % .8e % .8e % .8e % .8e")


def write_rao_4(path, w, beta_rad, Xi) -> None:
    """Write first-order RAOs in WAMIT .4 format (period, heading, DOF,
    |X|, phase, Re, Im), the snapshot dropped beside the QTF files."""
    Xi = np.asarray(Xi)
    w = np.asarray(w)
    beta = float(np.rad2deg(beta_rad))
    with open(path, "w") as f:
        for idof in range(Xi.shape[0]):
            for w1, x in zip(w, Xi[idof, :]):
                f.write(f"{2*np.pi/w1: 8.4e} {beta: 8.4e} {idof+1} "
                        f"{np.abs(x): 8.4e} {np.angle(x): 8.4e} "
                        f"{x.real: 8.4e} {x.imag: 8.4e}\n")


# --------------------------------------------------------------------------
# interpolation with jnp.interp's semantics
# --------------------------------------------------------------------------

def interp(x, xp, fp, left=0.0, right=0.0):
    """One-dimensional linear interpolation of real ``fp`` (..., n) on the
    sorted grid ``xp`` (n,) at ``x`` (m,), ``left`` / ``right`` outside
    it, batched over ``fp``'s leading axes: the arithmetic of
    ``jnp.interp`` (right-sided search, the zero-width-interval guard)."""
    x = as_real(x)
    xp, fp = as_real(xp, x.device), as_real(fp, x.device)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[..., i - 1],
                    fp[..., i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


def _interp_c(x, xp, fp):
    """``interp`` of complex rows, real and imaginary parts apart."""
    return torch.complex(interp(x, xp, fp.real), interp(x, xp, fp.imag))


# --------------------------------------------------------------------------
# the slender-body QTF
# --------------------------------------------------------------------------

def _np(x):
    """A host copy of ``x``; a tensor's through the counted
    ``obs.transfers.device_get``."""
    if isinstance(x, torch.Tensor):
        from raft_tpu_torch.obs import transfers
        return transfers.device_get(x, what="qtf_fields")
    return np.asarray(x)


def qtf_fields(fowt, pose, beta, Xi0=None, M_struc=None) -> dict:
    """Every input of the pair grid (kernel K5) for one wave heading
    ``beta`` [rad] at the pose ``pose`` (``fowt_pose`` output): the RAOs
    ``Xi0`` (6, nw) on the model grid resampled onto ``fowt.w1_2nd`` (zero
    outside), the first-order inertial loads, the stacked node fields
    (lane-last, on the model's device) and the waterline-crossing members'
    fields.  ``Xi0`` None is a fixed body.  Raises ``NonFiniteResult``
    if a field of a node above water is not finite (``check_dry_nodes``)."""
    dev = fowt.device
    w2 = as_real(fowt.w1_2nd, dev)
    k2 = as_real(fowt.k1_2nd, dev)
    nw2 = w2.shape[0]
    h = fowt.depth
    rho, g = fowt.rho_water, fowt.g
    beta = float(beta)

    # ---- RAOs resampled to the 2nd-order grid (reference :1415-1417) ----
    if Xi0 is None:
        Xi = torch.zeros((6, nw2), dtype=COMPLEX, device=dev)
    else:
        Xi0 = torch.as_tensor(Xi0, device=dev).to(COMPLEX)
        wm = as_real(fowt.w, dev)
        Xi = _interp_c(w2, wm, Xi0)

    # ---- first-order inertial loads for Pinkster IV (reference :1437-1440)
    M_struc = torch.zeros((6, 6), dtype=REAL, device=dev) if M_struc is None \
        else as_real(M_struc, dev)
    F1st = torch.cat([
        M_struc[0, 0] * (-w2**2 * Xi[0:3, :]),
        M_struc[3:, 3:].to(COMPLEX) @ (-w2**2 * Xi[3:, :]),
    ])

    # ---- stacked node fields on the 2nd-order grid ----
    nd = fowt.nodes
    r = as_real(pose["r"], dev)                      # (N, 3)
    rPRP = as_real(pose["r6"], dev)[:3]
    offsets = r - rPRP
    q, p1, p2 = pose["q"], pose["p1"], pose["p2"]
    Ca_p1, Ca_p2 = as_real(nd.Ca_p1, dev), as_real(nd.Ca_p2, dev)
    Ca_End = as_real(nd.Ca_End, dev)

    # per-node volumes with partial-submergence scaling (reference
    # :1533-1539); the strict z < 0 mask (reference :1522-1523)
    dls = as_real(nd.dls, dev)
    z = r[:, 2]
    dls_safe = torch.where(dls == 0.0, 1.0, dls)
    scale = torch.where(z + 0.5 * dls > 0.0, (0.5 * dls - z) / dls_safe, 1.0)
    v_i = as_real(nd.v_side, dev) * scale
    v_end = as_real(nd.v_end, dev)
    a_i = as_real(nd.a_i, dev)
    submerged = (z < 0.0).to(REAL)

    ones = torch.ones(nw2, dtype=COMPLEX, device=dev)
    u_n, _, _ = wave_kinematics(ones, beta, w2, k2, h, r, rho=rho, g=g)
    dr_n, nodeV, _ = kinematics_from_motion(offsets, Xi, w2)      # (N,3,nw2)
    grad_u = wave_vel_gradient(w2, k2, beta, h, r[:, None, :])    # (N,nw2,3,3)
    grad_p = wave_pres1st_gradient(k2, beta, h, r[:, None, :], rho=rho, g=g)
    nodeV_ax = torch.einsum("ncw,nc->nw", u_n - nodeV, q.to(COMPLEX))

    Minert = ((1.0 + Ca_p1)[:, None, None] * pose["p1Mat"]
              + (1.0 + Ca_p2)[:, None, None] * pose["p2Mat"])
    CaMat = Ca_p1[:, None, None] * pose["p1Mat"] \
        + Ca_p2[:, None, None] * pose["p2Mat"]
    ptMat = pose["p1Mat"] + pose["p2Mat"]

    # ---- waterline-crossing members (host-side geometry selection;
    #      reference :1487-1497, 1603-1626) ----
    r_np = _np(r)
    rPRP_np = _np(rPRP)
    mem_idx = _np(nd.member_index)
    wl = []
    for im, m in enumerate(fowt.members):
        sel = np.where(mem_idx == im)[0]
        rm = r_np[sel]
        if len(rm) == 0 or rm[0, 2] * rm[-1, 2] >= 0:
            continue
        r_int = rm[0] + (rm[-1] - rm[0]) * (0.0 - rm[0, 2]) / (rm[-1, 2] - rm[0, 2])
        below = np.where(rm[:, 2] < 0)[0]
        i_wl = below[-1]
        ds = _np(m.ds)
        if m.circular:
            d_wl = (0.5 * (ds[i_wl] + ds[i_wl + 1])
                    if i_wl != len(ds) - 1 else ds[i_wl])
            area = 0.25 * np.pi * d_wl**2
        else:
            if i_wl != len(ds) - 1:
                d1 = 0.5 * (ds[i_wl, 0] + ds[i_wl + 1, 0])
                d2w = 0.5 * (ds[i_wl, 1] + ds[i_wl + 1, 1])
            else:
                d1, d2w = ds[i_wl, 0], ds[i_wl, 1]
            area = d1 * d2w
        # the reference's loop leaks the LAST node that passed its
        # submerged guard into the waterline term's Ca (raft_fowt.py:
        # 1527-1529 'continue' on r[il,2]>=0, used at :1613)
        last = int(sel[below[-1]])
        r_int_t = as_real(r_int, dev)
        # unit-amplitude fields at the intersection; rho = g = 1 makes the
        # "pressure" output the wave elevation
        _, udw, eta = wave_kinematics(ones, beta, w2, k2, h, r_int_t,
                                      rho=1.0, g=1.0)
        drw, _, aw = kinematics_from_motion(r_int_t - rPRP, Xi, w2)
        eta_r = eta - drw[2, :]
        pm1, pm2 = p1[last].to(COMPLEX), p2[last].to(COMPLEX)
        th = Xi[3:, :]
        # z component of cross(Xi_rot, p) per frequency (reference
        # :1506-1509)
        cz1 = th[0] * pm1[1] - th[1] * pm1[0]
        cz2 = th[0] * pm2[1] - th[1] * pm2[0]
        g_e1 = -g * (cz1[None, :] * pm1[:, None] + cz2[None, :] * pm2[:, None])
        wl.append(dict(c=torch.stack([udw, aw, g_e1]), eta=eta_r,
                       mats=torch.stack([Minert[last], CaMat[last]]),
                       geo=torch.cat([as_real([area], dev),
                                      as_real(r_int - rPRP_np, dev)])))

    wl_fields = None
    if wl:
        wl_fields = {k: torch.stack([m[k] for m in wl])
                     for k in ("c", "eta", "mats", "geo")}
    fields = dict(
        w2=w2, k2=k2, Xi=Xi, F1st=F1st,
        u=u_n, dr=dr_n, nv=nodeV, nax=nodeV_ax,
        gu=grad_u.movedim(1, -1).contiguous(),        # (N,3,3,nw2)
        gp=grad_p.movedim(1, -1).contiguous(),        # (N,3,nw2)
        q=as_real(q, dev), offsets=offsets, pos=r,
        Minert=Minert, CaMat=CaMat, ptMat=ptMat, qMat=as_real(pose["qMat"], dev),
        nodescal=torch.stack([v_i, v_end * Ca_End, a_i, submerged], dim=1),
        wl=wl_fields)
    check_dry_nodes(fields)
    return fields


def complete_hermitian(Q, w2):
    """Keep the upper triangle (w2 >= w1) of a raw (nw2, nw2, 6) pair grid
    and fill the lower one by Hermitian symmetry (reference :1638-1640)."""
    nw2 = Q.shape[0]
    upper = (w2[None, :] >= w2[:, None]).to(REAL)
    Q = Q * upper[:, :, None]
    eye = torch.eye(nw2, dtype=REAL, device=Q.device)[:, :, None]
    return Q + torch.conj(Q.transpose(0, 1)) - eye * torch.conj(Q)


def calc_qtf_slender_body(fowt, pose, beta, Xi0=None, M_struc=None):
    """Slender-body QTF for one wave heading ``beta`` [rad], (nw2, nw2, 6)
    complex on the model's device.  The pair grid is kernel K5: on a CUDA
    device the hand-written kernel, on the CPU its plain version; the
    Kim & Yue correction of MacCamy-Fuchs members is added to it before
    the Hermitian completion (reference: raft_fowt.py:1636-1640)."""
    fields = qtf_fields(fowt, pose, beta, Xi0=Xi0, M_struc=M_struc)
    Q = qtf_pair_grid(fields, beta, fowt.depth, fowt.rho_water, fowt.g)
    Q = Q + kim_yue_correction(fowt, pose, beta)
    return complete_hermitian(Q, fields["w2"])


# --------------------------------------------------------------------------
# Kim & Yue analytical 2nd-order diffraction correction
# (reference: raft_member.py:1090-1205, applied at raft_fowt.py:1636)
# --------------------------------------------------------------------------

def _recip(z):
    """1/z, and 0 where that is not finite (high-order Hankel magnitudes
    saturate the dtype; the physical limit of 1/(H'H') there is 0)."""
    r = 1.0 / z
    ok = torch.isfinite(r.real) & torch.isfinite(r.imag)
    return torch.where(ok, r, torch.zeros_like(r))


def _sinh_over_coshcosh(a, b, c):
    """sinh(a) / (cosh(b) cosh(c)), overflow-stable for |a| <= b + c."""
    num = torch.exp(a - b - c) - torch.exp(-a - b - c)
    den = (1.0 + torch.exp(-2.0 * b)) * (1.0 + torch.exp(-2.0 * c))
    return 2.0 * num / den


def _inv_coshcosh(b, c):
    """1 / (cosh(b) cosh(c)), overflow-stable."""
    return 4.0 * torch.exp(-(b + c)) / (
        (1.0 + torch.exp(-2.0 * b)) * (1.0 + torch.exp(-2.0 * c)))


def kim_yue_correction(fowt, pose, beta, Nm: int = 10):
    """Sum of the Kim & Yue (1989/1990) bottom-mounted-cylinder
    difference-frequency corrections over the MacCamy-Fuchs members that
    pierce the surface (``rA0.z * rB0.z < 0``), on the (nw2, nw2) pair
    grid of ``fowt.w1_2nd`` for heading ``beta`` [rad] at ``pose``:
    (nw2, nw2, 6) complex on the model's device, zero when no member
    counts.  ``Nm`` is the highest order of the Hankel sums.

    As the JAX package and the reference compute it: the real part only
    is kept (the diffraction share, so as not to count the Rainey terms
    twice, :1148/:1196); the segment phase is taken at the waterline
    point rwl (:1199), not at the segment's midpoint; end nodes
    (``dls == 0``) reuse ds as the radius (:1173-1179); the whole force
    is conjugated where k1 < k2 (:1202-1203).  Member geometry is read
    on the host; the pair-grid algebra runs on the device, the Hankel
    derivative tables cached by radius."""
    dev = fowt.device
    k2g = as_real(fowt.k1_2nd, dev)
    w2 = as_real(fowt.w1_2nd, dev)
    nw2 = w2.shape[0]
    h = float(fowt.depth)
    rho, g = float(fowt.rho_water), float(fowt.g)
    F = torch.zeros((nw2, nw2, 6), dtype=COMPLEX, device=dev)
    members = [(im, m) for im, m in enumerate(fowt.members)
               if m.MCF and float(m.rA0[2]) * float(m.rB0[2]) < 0]
    if not members:
        return F

    k1, k2 = k2g[:, None], k2g[None, :]
    w1, wv2 = w2[:, None], w2[None, :]
    beta = float(beta)
    cosB, sinB = np.cos(beta), np.sin(beta)
    rPRP = _np(pose["r6"])[:3]

    def omega_sum(Hp, weights):
        """sum_n weights_n * (1/(Hp_{n+1} conj(Hp_n)) - 1/(Hp_n
        conj(Hp_{n+1}))) on the pair grid; Hp the (Nm+2, nw2) derivative
        table, ``weights`` a per-n list of grids or a scalar (reference:
        raft_member.py:1102-1109)."""
        tot = 0.0
        for n in range(Nm + 1):
            a1 = Hp[n + 1][:, None] * torch.conj(Hp[n][None, :])
            a2 = Hp[n][:, None] * torch.conj(Hp[n + 1][None, :])
            wn = weights[n] if isinstance(weights, list) else weights
            tot = tot + wn * (_recip(a1) - _recip(a2))
        return tot

    hp_cache: dict = {}

    def hp_table(R):
        key = round(float(R), 12)
        if key not in hp_cache:
            hp_cache[key] = hankel1p_all(k2g * float(R), Nm + 1)
        return hp_cache[key]

    def wrench(pf, off):
        return as_real(np.concatenate([pf, np.cross(off, pf)]), dev)

    diag = w1 == wv2
    kp = k1 + k2
    km_safe = torch.where(diag, 1.0, k1 - k2)
    for im, m in members:
        mpose = pose["members"][im]
        rA, rB = _np(mpose["rA"]), _np(mpose["rB"])
        rm = _np(mpose["r"])
        p1, p2 = _np(mpose["p1"]), _np(mpose["p2"])
        ds, dls = _np(m.ds), _np(m.dls)

        # wave-aligned transverse force direction (:1128-1131)
        bvec = np.array([cosB, sinB, 0.0])
        pf = np.dot(bvec, p1) * p1 + np.dot(bvec, p2) * p2
        pf = pf / np.linalg.norm(pf)

        # waterline intersection and radius (:1136-1139)
        rwl = rA + (rB - rA) * (0.0 - rA[2]) / (rB[2] - rA[2])
        order = np.argsort(rm[:, 2])
        Rwl = float(np.interp(0.0, rm[order, 2], 0.5 * ds[order]))
        phase = torch.exp(-1j * ((k1 - k2)
                                 * float(cosB * rwl[0] + sinB * rwl[1])))

        # ---- waterline relative-elevation term (:1134-1149) ----
        k1R, k2R = k1 * Rwl, k2 * Rwl
        Fwl = complex(-rho * g * Rwl * 2j / np.pi) / (k1R * k2R) \
            * omega_sum(hp_table(Rwl), 1.0)
        Fwl = Fwl.real * phase
        F = F + Fwl[:, :, None] * wrench(pf, rwl - rPRP)[None, None, :]

        # ---- Bernoulli quadratic-velocity depth integral (:1155-1200) ----
        for il in range(len(rm) - 1):
            z1 = float(rm[il, 2])
            if z1 > 0:
                continue
            z2 = min(float(rm[il + 1, 2]), 0.0)
            R1 = ds[il] / 2.0 if dls[il] != 0 else ds[il]
            R2 = ds[il + 1] / 2.0 if dls[il + 1] != 0 else ds[il]
            R = float(0.5 * (R1 + R2))
            k1R, k2R = k1 * R, k2 * R
            k1h, k2h = k1R * (h / R), k2R * (h / R)
            # Im/Ip pre-divided by cosh(k1h)cosh(k2h) with the
            # overflow-stable exp-ratio algebra
            icc = _inv_coshcosh(k1h, k2h)
            sp2 = _sinh_over_coshcosh(kp * (z2 + h), k1h, k2h) / (k1h + k2h)
            sp1 = _sinh_over_coshcosh(kp * (z1 + h), k1h, k2h) / (k1h + k2h)
            sm2 = torch.where(
                diag, (z2 + h) / h * icc,
                _sinh_over_coshcosh(km_safe * (z2 + h), k1h, k2h)
                / torch.where(diag, 1.0, k1h - k2h))
            sm1 = torch.where(
                diag, (z1 + h) / h * icc,
                _sinh_over_coshcosh(km_safe * (z1 + h), k1h, k2h)
                / torch.where(diag, 1.0, k1h - k2h))
            Im_cc = 0.5 * (sp2 - sm2 - sp1 + sm1)
            Ip_cc = 0.5 * (sp2 + sm2 - sp1 - sm1)

            t1 = torch.sqrt(k1h * torch.tanh(k1h))
            t2 = torch.sqrt(k2h * torch.tanh(k2h))
            pref = k1h * k2h / t1 / t2
            weights = [pref * (Im_cc + Ip_cc * n * (n + 1) / k1R / k2R)
                       for n in range(Nm + 1)]
            dF = (complex(rho * g * R * 2j / np.pi) / (k1R * k2R)
                  * omega_sum(hp_table(R), weights))
            rmid = 0.5 * (rm[il] + rm[il + 1])
            dF = dF.real * phase
            F = F + dF[:, :, None] * wrench(pf, rmid - rPRP)[None, None, :]

    # conjugate where k1 < k2 (:1202-1203)
    return torch.where((k1 < k2)[:, :, None], torch.conj(F), F)


# --------------------------------------------------------------------------
# 2nd-order force from QTF + spectrum  (reference: raft_fowt.py:1728-1818)
# --------------------------------------------------------------------------

def hydro_force_2nd(qtf, heads_rad, w2, beta, S0, w, interp_mode="qtf",
                    device=None):
    """Mean drift and slowly-varying difference-frequency force
    amplitudes.  qtf (nw2, nw2, nh, 6) Hermitian; heads_rad (nh,); w2
    (nw2,) the QTF grid; beta the case heading [rad]; S0 (nw,) the wave
    spectrum on the model grid w (nw,).  Returns (f_mean (6,), f (6, nw))
    real tensors on ``device`` (default: the QTF's)."""
    if device is None:
        device = qtf.device if isinstance(qtf, torch.Tensor) else "cpu"
    qtf = torch.as_tensor(qtf, device=device).to(COMPLEX)
    heads = np.atleast_1d(np.asarray(heads_rad, float))
    w2 = as_real(w2, device)
    w = as_real(w, device)
    S0 = as_real(S0, device)
    nw = w.shape[0]
    dw = w[1] - w[0]

    # heading interpolation with clamping (reference :1747-1757)
    if len(heads) == 1:
        Qh = qtf[:, :, 0, :]
    else:
        b = float(np.clip(beta, heads[0], heads[-1]))
        i2 = int(np.clip(np.searchsorted(heads, b), 1, len(heads) - 1))
        f2 = (b - heads[i2 - 1]) / (heads[i2] - heads[i2 - 1])
        Qh = qtf[:, :, i2 - 1, :] * (1 - f2) + qtf[:, :, i2, :] * f2

    jj = torch.arange(nw, device=device)
    i2idx = jj[None, :] + jj[:, None]              # [imu, j] -> j + imu
    valid = (i2idx < nw).to(REAL)
    i2c = torch.clamp(i2idx, 0, nw - 1)

    Qd = Qh.movedim(-1, 0)                         # (6, nw2, nw2)
    if interp_mode == "qtf":
        # interpolate the QTF to the model grid (separable bilinear, zero
        # outside), then sum off-diagonals (reference :1786-1804, the
        # default mode)
        Qc = _interp_c(w, w2, Qd)                              # along axis 2
        Qi = _interp_c(w, w2, Qc.transpose(1, 2)).transpose(1, 2)  # axis 1
        Qdiag = Qi[:, jj[None, :], i2c] * valid        # (6, imu, j)
        Smu = S0[i2c] * valid
        ssum = torch.sum(S0[None, :] * Smu * torch.abs(Qdiag) ** 2, dim=2)
        f = 4.0 * torch.sqrt(ssum) * dw
        f = torch.cat([f.new_zeros((6, 1)), f[:, 1:]], dim=1)
        fmean = 2.0 * torch.sum(S0 * torch.diagonal(Qi, dim1=1, dim2=2).real,
                                dim=1) * dw
    elif interp_mode == "spectrum":
        # force spectrum on the QTF grid, then interpolate (reference
        # :1760-1784)
        nw2n = w2.shape[0]
        S2 = interp(w2, w, S0)
        j2 = torch.arange(nw2n, device=device)
        i2idx2 = j2[None, :] + j2[:, None]
        valid2 = (i2idx2 < nw2n).to(REAL)
        i2c2 = torch.clamp(i2idx2, 0, nw2n - 1)
        dw2 = w2[1] - w2[0]
        mu = w2 - w2[0]
        Qdiag = Qd[:, j2[None, :], i2c2] * valid2
        Smu = S2[i2c2] * valid2
        Sf = 8.0 * torch.sum(S2[None, :] * Smu * torch.abs(Qdiag) ** 2,
                             dim=2) * dw2
        Sf = torch.cat([Sf.new_zeros((6, 1)), Sf[:, 1:]], dim=1)
        f = torch.sqrt(2.0 * interp(w - w[0], mu, Sf) * dw)
        fmean = 2.0 * torch.sum(S2 * torch.diagonal(Qd, dim1=1, dim2=2).real,
                                dim=1) * dw2
    else:
        raise ValueError(f"unknown interp_mode '{interp_mode}'")

    # shift by one frequency: difference frequencies start at 0, the model
    # grid starts at dw (reference :1806-1810)
    f = torch.cat([f[:, 1:], f.new_zeros((6, 1))], dim=1)
    return fmean, f


# --------------------------------------------------------------------------
# the outFolderQTF checkpoint  (reference: raft_fowt.py:1420-1433, 1642-1648)
# --------------------------------------------------------------------------

def cache_key(fowt, r6, beta0, RAO, M_struc) -> str:
    """Content key of an internal QTF: sha256 over the same inputs, in the
    same order and byte layout, as the JAX package's Model
    (raft_tpu/model.py:1172-1199) — pose, heading, RAO, structural mass,
    second-order grid, every node field by name, depth / rho / g, the
    members' MCF flags and end positions — so either package reloads a
    .12d the other wrote from identical inputs."""
    import dataclasses
    import hashlib

    h = hashlib.sha256()
    for a in (r6, [beta0], RAO, M_struc, fowt.w1_2nd):
        h.update(np.ascontiguousarray(np.asarray(_np(a), dtype=complex))
                 .tobytes())
    for fld in sorted(f.name for f in dataclasses.fields(fowt.nodes)):
        val = getattr(fowt.nodes, fld)
        h.update(fld.encode())
        if val is not None:
            h.update(np.ascontiguousarray(np.asarray(_np(val), dtype=float))
                     .tobytes())
    h.update(np.asarray([fowt.depth, fowt.rho_water, fowt.g]).tobytes())
    h.update(np.asarray([bool(getattr(m, "MCF", False))
                         for m in fowt.members], dtype=bool).tobytes())
    for m in fowt.members:
        h.update(np.ascontiguousarray(np.asarray(
            [_np(m.rA0), _np(m.rB0)], dtype=float)).tobytes())
    return h.hexdigest()
