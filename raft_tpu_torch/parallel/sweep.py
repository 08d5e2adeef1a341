"""Batched load-case sweeps.

Port of the physics of ``raft_tpu/parallel/sweep.py``: a certification-
style sweep solves many sea states (Hs, Tp, heading) of one floating
turbine at once.  The pose, statics, strip-theory hydro constants and the
mooring stiffness do not depend on the case (the reference pose ``r6`` is
fixed), so they are computed once; the sea-state part — spectra, wave
kinematics, inertial excitation, the drag-linearization fixed point
around the batched impedance solve (kernel K1, or K3 under
``RAFT_TPU_PRECISION=mixed``) — carries an explicit leading case axis.
That is the same math as the JAX package's ``vmap(setup)``.

Not ported here (ROADMAP): the device mesh / partition rules and the
executable cache (A9); the run manifest, quarantine ladder, fault seams
and health telemetry (A8); the farm hooks ``r6_b``, ``C_moor_b``,
``B_add``, ``F_add`` (A7).
"""
from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch._config import COMPLEX, REAL, as_real, resolve_device
from raft_tpu_torch.io.wamit import bem_coeffs
from raft_tpu_torch.models import mooring as mr
from raft_tpu_torch.models.fowt import (
    FOWTModel, build_fowt, fowt_bem_excitation, fowt_drag_excitation,
    fowt_drag_precompute, fowt_hydro_constants, fowt_hydro_excitation,
    fowt_hydro_linearization_pre, fowt_pose, fowt_statics,
)
from raft_tpu_torch.ops.linalg import impedance_solve
from raft_tpu_torch.ops.spectra import get_rms, jonswap
from raft_tpu_torch.utils.dicttools import get_from_dict


def relax_weights(relax) -> tuple[float, float]:
    """(keep, relax) weights of the drag fixed point's under-relaxation
    ``keep*XiLast + relax*Xin``.  The default 0.8 keeps the literal 0.2
    complement (``1.0 - 0.8`` is ``0.19999...96`` in float64); a copy of
    ``raft_tpu/recovery.py:relax_weights``."""
    relax = float(relax)
    return (0.2 if relax == 0.8 else 1.0 - relax), relax


def unrolled_fixed_point(step, Xi0, nIter, tol, chunk: int = 2,
                         relax: float = 0.8):
    """Drag-linearization fixed point over a leading batch axis: ``nIter``
    passes of ``step`` with per-item convergence freezing (0.2/0.8
    under-relaxation, the reference's raft_model.py:961-991 scheme).

    The passes are cut into chunks of ``chunk``; before each chunk one
    host check skips it when every item has converged.  That is exact: a
    frozen pass is an identity on the whole carry.  ``chunk=nIter`` (or
    0) runs every pass.

    Returns (XiLast, Xi, done, iters, chunks_run): ``iters`` is the
    per-item count of executed (non-frozen) passes and ``chunks_run`` the
    number of chunks that ran."""
    chunk = int(chunk) if chunk else int(nIter)
    keep, relax = relax_weights(relax)
    nb = Xi0.shape[0]
    XiLast, Xi = Xi0, Xi0
    done = torch.zeros(nb, dtype=torch.bool, device=Xi0.device)
    iters = torch.zeros(nb, dtype=torch.int32, device=Xi0.device)
    chunks_run = 0
    remaining = int(nIter)
    while remaining > 0:
        count = min(chunk, remaining)
        remaining -= count
        if bool(torch.all(done)):
            continue
        for _ in range(count):
            Xin = step(XiLast)
            rel = torch.abs(Xin - XiLast) / (torch.abs(Xin) + tol)
            conv = torch.all(torch.all(rel < tol, dim=-1), dim=-1)
            frozen = done[:, None, None]
            XiNext = torch.where(frozen | conv[:, None, None], XiLast,
                                 keep * XiLast + relax * Xin)
            Xi = torch.where(frozen, Xi, Xin)
            iters = iters + (~done).to(torch.int32)
            done = done | conv
            XiLast = XiNext
        chunks_run += 1
    return XiLast, Xi, done, iters, chunks_run


def make_case_solver(fowt: FOWTModel, nIter: int = 10, tol: float = 0.01,
                     XiStart: float = 0.1, r6=None, fp_chunk: int = 2,
                     relax: float = 0.8):
    """Per-case response solver (no aero; wave loading) on the model's
    device: ``solve(Hs, Tp, beta)`` for one case, ``solve.batched(Hs, Tp,
    beta, Xi0=None)`` for a batch.  Hs, Tp [m, s], beta [rad]."""
    if fowt.potSecOrder > 0:
        import warnings
        warnings.warn(
            "sweep case solver does not include second-order (potSecOrder) "
            "wave forces yet — sweep responses will exclude slow-drift "
            "excitation that Model.solveDynamics includes", stacklevel=2)
    dev = fowt.device
    if r6 is None:
        r6 = np.array([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0], float)
    r6 = as_real(r6, dev)
    keep, relax_w = relax_weights(relax)
    w = as_real(fowt.w, dev)
    nw = fowt.nw
    dw = float(w[1] - w[0])
    cache = {}

    def case_constants():
        """Everything that does not depend on the sea state, once."""
        if not cache:
            pose = fowt_pose(fowt, r6)
            stat = fowt_statics(fowt, pose)
            hc = fowt_hydro_constants(fowt, pose)
            # rotation-vector flavour for MoorPy parity, as Model uses
            C_moor = (mr.coupled_stiffness_rotvec(fowt.mooring, r6)
                      if fowt.mooring is not None
                      else torch.zeros((6, 6), dtype=REAL, device=dev))
            A_BEM, B_BEM = bem_coeffs(fowt.bem, nw, device=dev)
            cache.update(
                pose=pose, hc=hc, B_BEM=B_BEM,
                M_lin=(stat["M_struc"] + hc["A_hydro_morison"])[:, :, None]
                + A_BEM,
                C_lin=stat["C_struc"] + C_moor + stat["C_hydro"])
        return cache

    def setup(Hs, Tp, beta):
        """Case state: scalar Hs, Tp, beta for one case, or (nc,) each
        for a batch (the excitation then carries a leading case axis)."""
        cc = case_constants()
        Hs = as_real(Hs, dev)
        single = Hs.ndim == 0
        S = jonswap(w, Hs, as_real(Tp, dev))
        zeta = torch.sqrt(2.0 * S * dw).to(COMPLEX)
        beta = as_real(beta, dev).reshape(-1)
        seastate = dict(beta=beta, zeta=zeta.reshape(beta.shape[0], nw))
        exc = fowt_hydro_excitation(fowt, cc["pose"], seastate, cc["hc"])
        F_lin = fowt_bem_excitation(fowt, seastate) + exc["F_hydro_iner"]
        u0 = exc["u"]
        if single:
            F_lin, u0 = F_lin[0], u0[0]
        drag_pre = fowt_drag_precompute(fowt, cc["pose"], u0)
        return dict(pose=cc["pose"], drag_pre=drag_pre, u0=u0,
                    B_BEM=cc["B_BEM"], M_lin=cc["M_lin"], C_lin=cc["C_lin"],
                    F_lin=F_lin)

    def drag_step(st, Xi):
        """One drag pass + the impedance solve (K1 on the card);
        rank-polymorphic over an optional leading case axis."""
        B_drag6, Bmat = fowt_hydro_linearization_pre(
            fowt, st["pose"], st["drag_pre"], Xi)
        F_drag = fowt_drag_excitation(fowt, st["pose"], Bmat, st["u0"])
        return impedance_solve(w, st["M_lin"],
                               B_drag6[..., None] + st["B_BEM"],
                               st["C_lin"], st["F_lin"] + F_drag)

    def solve(Hs, Tp, beta):
        """The serial reference: one case, iterated until it converges or
        ``nIter`` passes ran."""
        st = setup(Hs, Tp, beta)
        XiLast = torch.zeros((6, nw), dtype=COMPLEX, device=dev) + XiStart
        Xi = XiLast
        for _ in range(int(nIter)):
            Xin = drag_step(st, XiLast)
            conv = bool(torch.all(torch.abs(Xin - XiLast)
                                  / (torch.abs(Xin) + tol) < tol))
            Xi = Xin
            if conv:
                break
            XiLast = keep * XiLast + relax_w * Xin
        return dict(Xi=Xi, std=get_rms(Xi, axis=-1))

    def solve_batched(Hs, Tp, beta, Xi0=None):
        """A batch of cases, Hs/Tp/beta (nc,).  ``Xi0`` (nc, 6, nw)
        complex seeds the fixed point per case (a warm start moves only
        the starting point)."""
        Hs = as_real(Hs, dev).reshape(-1)
        st = setup(Hs, Tp, beta)
        nc = Hs.shape[0]
        if Xi0 is None:
            Xi0 = torch.zeros((nc, 6, nw), dtype=COMPLEX, device=dev) + XiStart
        else:
            Xi0 = torch.as_tensor(Xi0, device=dev).to(COMPLEX)
        _, Xi, done, iters, chunks = unrolled_fixed_point(
            lambda XiLast: drag_step(st, XiLast), Xi0, nIter, tol,
            chunk=fp_chunk, relax=relax)
        return dict(Xi=Xi, std=get_rms(Xi, axis=-1), converged=done,
                    iters=iters, fp_chunks=chunks)

    solve.batched = solve_batched
    solve.setup = setup
    solve.drag_step = drag_step
    return solve


def design_fowt(design_or_name, device) -> FOWTModel:
    """A design (dict, YAML path or vendored name) built on its own
    frequency grid (``settings.min_freq``/``max_freq``, as ``Model``) and
    water depth, on ``device``."""
    if isinstance(design_or_name, str):
        from raft_tpu_torch.io.designs import load_design
        design_or_name = load_design(design_or_name)
    s = design_or_name.get("settings") or {}
    min_freq = float(get_from_dict(s, "min_freq", default=0.01, dtype=float))
    max_freq = float(get_from_dict(s, "max_freq", default=1.00, dtype=float))
    w = np.arange(min_freq, max_freq + 0.5 * min_freq, min_freq) * 2 * np.pi
    depth = float(get_from_dict(design_or_name["site"], "water_depth",
                                dtype=float))
    return build_fowt(design_or_name, w, depth=depth, device=device)


def on_device(fowt_or_design, device) -> FOWTModel:
    """The model of a sweep on the device it runs on: a FOWTModel built on
    the host is carried there with ``convert.state_from_numpy``; a design
    is built there."""
    if not isinstance(fowt_or_design, FOWTModel):
        return design_fowt(fowt_or_design, device)
    if fowt_or_design.device == device and isinstance(fowt_or_design.w,
                                                      torch.Tensor):
        return fowt_or_design
    from raft_tpu_torch.convert import state_from_numpy
    return state_from_numpy(fowt_or_design, device)


def sweep_cases(fowt_or_design, Hs, Tp, beta, nIter: int = 10,
                tol: float = 0.01, XiStart: float = 0.1, fp_chunk: int = 2,
                relax: float = 0.8, r6=None, Xi0=None, device=None):
    """Solve a batch of load cases of one floating turbine.

    ``fowt_or_design``: a FOWTModel, a design dict, or the name of a
    vendored design (built on its own frequency grid).  Hs, Tp, beta
    (ncases,) [m, s, rad].  Runs on the card unless ``device="cpu"``
    (``device=None`` with no card raises).  Returns ``Xi`` (nc, 6, nw)
    complex, ``std`` (nc, 6), ``converged`` (nc,) bool, ``iters`` (nc,)
    int32 — tensors on the device — and ``fp_chunks``, the number of
    fixed-point chunks that ran."""
    dev = resolve_device(device)
    fowt = on_device(fowt_or_design, dev)
    solver = make_case_solver(fowt, nIter=nIter, tol=tol, XiStart=XiStart,
                              r6=r6, fp_chunk=fp_chunk, relax=relax)
    return solver.batched(as_real(Hs, dev), as_real(Tp, dev),
                          as_real(beta, dev), Xi0=Xi0)
