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

The farm axis (``make_farm_solver``, ``sweep_farm``): N turbines x M
cases of one platform design as one batch of N*M lanes, turbine-major.
A lane's reference position moves its wave phase and takes its own
mooring stiffness (the ``r6_b`` / ``C_moor_b`` pair of
``make_case_solver``'s ``batched``), the batched wake equilibrium of every
case (``models/wake.py:wake_equilibria_torch``) gives each turbine its
waked wind speed, and the rotor's linearized aero damping at that speed
enters the lane's impedance (``B_add``): one K1 launch of N*M*nw lanes
per drag pass.

Fault tolerance (the JAX package's, ``raft_tpu/parallel/sweep.py``):
``sweep_cases`` finds its non-finite lanes (``quarantine="nonfinite"``,
the default; ``"all"`` adds the lanes that did not converge, ``"off"``
none) in one host pull and re-solves only those lanes down
`_LANE_LADDER` — the configured kernel (K1, or K3 under ``mixed``) on
the offending lanes alone — splicing every finite result back;
``sweep_cases_chunked`` persists each chunk of a large case table in a
``serve.checkpoint.CheckpointStore`` so a killed sweep re-solves only its
unfinished chunks.  The ``sweep`` fault seam (``testing/faults.py``)
sits after the batched solve.

Observability (the JAX package's): ``sweep_cases`` and ``sweep_farm``
each finish a ``RunManifest`` (kinds ``sweep_cases`` / ``sweep_farm``)
with their spans, metrics, ledger and counted host pulls (phases
``sweep`` / ``farm``: one pull a fixed-point chunk, one summary pull a
batch), and record the ``sweep_lanes`` probe from the summary pull.
Health mode (``RAFT_TPU_HEALTH=1`` or ``health=True``): the batched
solve also returns each lane's ``health_residual`` and ``health_cond``
at the final drag iterate — one more drag linearization and one more
impedance solve (one more K1 / K3 launch) a batch — folded by
`_health_summary` into the ``raft_tpu_solve_*`` gauges, a
``solve_health`` event and ``manifest.extra["solve_health"]``.

Not ported here (ROADMAP): the device mesh / partition rules and the
executable cache (A9); lane quarantine and the health mode of the farm
sweep; the farm runner of the service (``make_farm_runner``,
``normalize_farm_request``, A10).
"""
from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import _config, errors, ledger as _ledger, obs, recovery
from raft_tpu_torch._config import COMPLEX, REAL, as_real, resolve_device
from raft_tpu_torch.io.wamit import bem_coeffs
from raft_tpu_torch.models import mooring as mr
from raft_tpu_torch.models.fowt import (
    FOWTModel, build_fowt, fowt_bem_excitation, fowt_drag_excitation,
    fowt_drag_precompute, fowt_hydro_constants, fowt_hydro_excitation,
    fowt_hydro_linearization_pre, fowt_pose, fowt_statics,
)
from raft_tpu_torch.ops.linalg import impedance_solve
from raft_tpu_torch.obs import transfers
from raft_tpu_torch.ops.spectra import get_rms, jonswap
from raft_tpu_torch.recovery import relax_weights
from raft_tpu_torch.testing import faults
from raft_tpu_torch.utils.dicttools import get_from_dict


def unrolled_fixed_point(step, Xi0, nIter, tol, chunk: int = 2,
                         relax: float = 0.8, what: str = "sweep_fp_chunk"):
    """Drag-linearization fixed point over a leading batch axis: ``nIter``
    passes of ``step`` with per-item convergence freezing (0.2/0.8
    under-relaxation, the reference's raft_model.py:961-991 scheme).

    The passes are cut into chunks of ``chunk``; before each chunk one
    host check (a counted pull, labelled ``what``) skips it when every
    item has converged.  That is exact: a frozen pass is an identity on
    the whole carry.  ``chunk=nIter`` (or 0) runs every pass.

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
        if bool(transfers.device_get(torch.all(done), what=what)):
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
                     relax: float = 0.8, health: bool = False):
    """Per-case response solver (no aero; wave loading) on the model's
    device: ``solve(Hs, Tp, beta)`` for one case, ``solve.batched(Hs, Tp,
    beta, Xi0=None)`` for a batch.  Hs, Tp [m, s], beta [rad].

    ``health``: the batched solve also returns ``health_residual`` (nc,),
    each lane's relative residual |Z Xi - F| / |F| of one more impedance
    solve at the drag linearization of its final iterate (the linear
    solve's accuracy, not the fixed point's convergence), and
    ``health_cond`` (nc,), the largest condition number of its impedance
    over the frequencies (inf where a bin is not finite).  It only adds
    outputs: ``Xi``, ``std``, ``iters`` and ``converged`` are those of the
    solve without it."""
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

    def pose_constants(r6_at):
        """The platform at reference pose ``r6_at``: pose, hydro constants,
        the mass and radiation terms and the structural and hydrostatic
        stiffness."""
        pose = fowt_pose(fowt, r6_at)
        stat = fowt_statics(fowt, pose)
        hc = fowt_hydro_constants(fowt, pose)
        A_BEM, B_BEM = bem_coeffs(fowt.bem, nw, device=dev)
        return dict(
            pose=pose, hc=hc, B_BEM=B_BEM,
            M_lin=(stat["M_struc"] + hc["A_hydro_morison"])[:, :, None]
            + A_BEM, C_sh=stat["C_struc"], C_hydro=stat["C_hydro"])

    def case_constants():
        """Everything that does not depend on the sea state, once."""
        if not cache:
            pc = pose_constants(r6)
            # rotation-vector flavour for MoorPy parity, as Model uses
            C_moor = (mr.coupled_stiffness_rotvec(fowt.mooring, r6)
                      if fowt.mooring is not None
                      else torch.zeros((6, 6), dtype=REAL, device=dev))
            cache.update(pose=pc["pose"], hc=pc["hc"], B_BEM=pc["B_BEM"],
                         M_lin=pc["M_lin"],
                         C_lin=pc["C_sh"] + C_moor + pc["C_hydro"])
        return cache

    def sea_state(cc, Hs, Tp, beta, pose_lanes=None):
        """The sea-state part of a case state on the constants ``cc``;
        ``pose_lanes``, the pose with a lane axis, for the drag pass."""
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
        pose = cc["pose"] if pose_lanes is None else pose_lanes
        drag_pre = fowt_drag_precompute(fowt, pose, u0)
        return dict(pose=pose, drag_pre=drag_pre, u0=u0,
                    B_BEM=cc["B_BEM"], M_lin=cc["M_lin"], C_lin=cc["C_lin"],
                    F_lin=F_lin)

    def setup(Hs, Tp, beta):
        """Case state: scalar Hs, Tp, beta for one case, or (nc,) each
        for a batch (the excitation then carries a leading case axis)."""
        return sea_state(case_constants(), Hs, Tp, beta)

    def setup_lanes(Hs, Tp, beta, r6_b, C_moor_b):
        """Case state of a batch whose lanes each have their own reference
        pose ``r6_b`` (nc, 6) and mooring stiffness ``C_moor_b`` (nc, 6,
        6), the JAX package's ``vmap(setup)`` with the farm overrides: the
        pose constants are computed once per distinct pose (one host read
        of ``r6_b``), the sea state per lane, and every pose-dependent
        entry carries the lane axis."""
        r6_h = transfers.device_get(r6_b, what="lane_poses")
        uniq, inv = np.unique(r6_h, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        parts, order = [], []
        for g in range(len(uniq)):
            idx = np.flatnonzero(inv == g)
            it = torch.as_tensor(idx, device=dev)
            pc = pose_constants(r6_b[idx[0]])
            cc = dict(pose=pc["pose"], hc=pc["hc"], B_BEM=pc["B_BEM"],
                      M_lin=pc["M_lin"],
                      C_lin=pc["C_sh"] + C_moor_b[it] + pc["C_hydro"])
            nl = len(idx)
            lane = lambda x: x.expand((nl,) + tuple(x.shape))  # noqa: E731
            st = sea_state(cc, Hs[it], Tp[it], beta[it],
                           {k: lane(cc["pose"][k]) for k in _LANE_POSE})
            st["M_lin"] = lane(cc["M_lin"])
            st["B_BEM"] = lane(cc["B_BEM"])
            parts.append(st)
            order.append(idx)
        back = torch.as_tensor(np.argsort(np.concatenate(order)), device=dev)

        def join(xs, key=None):
            if isinstance(xs[0], dict):
                return {k: join([x[k] for x in xs], k) for k in xs[0]}
            if key in _NODE_CONSTANTS:       # no lane axis, the same in all
                return xs[0]
            return torch.cat(xs)[back]

        return join(parts)

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

    def solve_batched(Hs, Tp, beta, Xi0=None, r6_b=None, C_moor_b=None,
                      B_add=None, F_add=None):
        """A batch of cases, Hs/Tp/beta (nc,).  ``Xi0`` (nc, 6, nw)
        complex seeds the fixed point per case (a warm start moves only
        the starting point).

        Farm hooks (the JAX package's): ``r6_b`` / ``C_moor_b`` ((nc, 6)
        / (nc, 6, 6), both or neither), each lane's reference pose and
        mooring stiffness — the farm evaluates the mooring stiffness at
        the base position and passes it, never implicitly at a translated
        pose; ``B_add`` (nc, 6, 6), linear damping added to the radiation
        damping (the aero damping at a turbine's waked wind speed);
        ``F_add`` (nc, 6, nw) complex, added excitation."""
        if (r6_b is None) != (C_moor_b is None):
            raise errors.ModelConfigError(
                "solve_batched: r6_b and C_moor_b come as a pair — the "
                "farm evaluates mooring stiffness at the base reference "
                "position, never implicitly at a translated r6")
        Hs = as_real(Hs, dev).reshape(-1)
        if r6_b is None:
            st = setup(Hs, Tp, beta)
        else:
            st = setup_lanes(Hs, as_real(Tp, dev).reshape(-1),
                             as_real(beta, dev).reshape(-1),
                             as_real(r6_b, dev).reshape(-1, 6),
                             as_real(C_moor_b, dev).reshape(-1, 6, 6))
        if B_add is not None:
            st = dict(st)
            st["B_BEM"] = st["B_BEM"] + as_real(B_add, dev)[..., None]
        if F_add is not None:
            st = dict(st)
            st["F_lin"] = st["F_lin"] + torch.as_tensor(
                F_add, device=dev).to(COMPLEX)
        nc = Hs.shape[0]
        if Xi0 is None:
            Xi0 = torch.zeros((nc, 6, nw), dtype=COMPLEX, device=dev) + XiStart
        else:
            Xi0 = torch.as_tensor(Xi0, device=dev).to(COMPLEX)
        _, Xi, done, iters, chunks = unrolled_fixed_point(
            lambda XiLast: drag_step(st, XiLast), Xi0, nIter, tol,
            chunk=fp_chunk, relax=relax)
        out = dict(Xi=Xi, std=get_rms(Xi, axis=-1), converged=done,
                   iters=iters, fp_chunks=chunks)
        if health:
            out.update(health_lanes(st, Xi))
        return out

    def health_lanes(st, Xi):
        """(health_residual, health_cond) of each lane at the drag
        linearization of ``Xi``: one more drag pass and impedance solve
        (K1, or K3 under mixed), then the residual of that solve,
        contracted element-wise per lane (a batched product would round
        by batch size, and a chunk of lanes must give the table's lanes),
        and the conditioning over the frequency stack with the identity
        in place of a non-finite bin."""
        B6_h, Bmat_h = fowt_hydro_linearization_pre(
            fowt, st["pose"], st["drag_pre"], Xi)
        F_h = st["F_lin"] + fowt_drag_excitation(fowt, st["pose"], Bmat_h,
                                                 st["u0"])
        B_h = B6_h[..., None] + st["B_BEM"]
        Xi_h = impedance_solve(w, st["M_lin"], B_h, st["C_lin"], F_h)
        Z_h = (-w ** 2 * st["M_lin"] + 1j * w * B_h
               + st["C_lin"][..., None]).to(COMPLEX)
        R_h = torch.sum(Z_h * Xi_h[..., None, :, :], dim=-2) - F_h
        num = torch.sqrt(torch.sum(torch.abs(R_h) ** 2, dim=(-2, -1)))
        den = torch.sqrt(torch.sum(torch.abs(F_h) ** 2, dim=(-2, -1)))
        Zs = Z_h.movedim(-1, -3)                          # (..., nw, 6, 6)
        bin_ok = torch.all(torch.all(torch.isfinite(Zs.real)
                                     & torch.isfinite(Zs.imag), dim=-1),
                           dim=-1)
        eye = torch.eye(Zs.shape[-1], dtype=Zs.dtype, device=Zs.device)
        # the SVD's error check reads the card: one counted read
        conds = transfers.sync_point(
            torch.linalg.cond, torch.where(bin_ok[..., None, None], Zs, eye),
            what="health_cond_check")
        inf = torch.full_like(conds, float("inf"))
        return dict(health_residual=num / (den + 1e-300),
                    health_cond=torch.amax(torch.where(bin_ok, conds, inf),
                                           dim=-1))

    solve.batched = solve_batched
    solve.setup = setup
    solve.setup_lanes = setup_lanes
    solve.drag_step = drag_step
    return solve


#: the pose entries the drag pass reads, given a lane axis by setup_lanes
_LANE_POSE = ("r6", "r", "q", "p1", "p2", "qMat", "p1Mat", "p2Mat")
#: the drag constants of fowt_drag_precompute that are per node only
_NODE_CONSTANTS = ("a_q_eff", "a_p1_eff", "a_p2_eff", "circ")


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


def _lane_finite(Xi):
    """(ncases,) bool tensor: the lane's response is finite everywhere."""
    return torch.all(torch.isfinite(Xi.real) & torch.isfinite(Xi.imag),
                     dim=-1).all(dim=-1)


#: the lane ladder: the same solve again on the offending lanes alone
#: (clears a transient poisoning at exact parity), then a damped restart
#: (under-relaxation 0.5, twice the iterations, one pass a chunk); both
#: on the configured kernel
_LANE_LADDER = (
    ("re_solve", {}),
    ("damped_restart", {"nIter_mult": 2, "fp_chunk": 1, "relax": 0.5}),
)
_QUARANTINE_MODES = ("nonfinite", "all", "off")


def _quarantine_lanes(fowt, Hs, Tp, beta, out, bad, kw, conv, iters,
                      Xi0=None):
    """Re-solve only the lanes ``bad`` of a sweep batch down
    `_LANE_LADDER`, splicing every finite result back into ``out``; a
    lane still non-finite or unconverged after a rung goes on to the
    next, and a lane no rung makes finite stays NaN and is reported as
    quarantined.  ``conv`` and ``iters`` are the batch's pulled
    convergence flags and iteration counts.  Returns ``(out, info)``;
    ``out["converged"]`` and ``out["iters"]`` come back agreeing with the
    spliced lanes.  Each rung is a ``sweep_quarantine_resolve`` span with
    one counted pull; the outcome is a ``quarantine`` event."""
    dev = out["Xi"].device
    info = {"lanes": [int(i) for i in bad], "ladder": [], "recovered": [],
            "quarantined": []}
    out = dict(out)
    iters = np.array(iters, np.int32)
    conv = np.array(conv, bool)
    remaining = np.asarray(bad, int)
    step_from = "batched"
    for name, mods in _LANE_LADDER:
        if remaining.size == 0:
            break
        kw2 = dict(kw)
        if "nIter_mult" in mods:
            kw2["nIter"] = int(kw.get("nIter", 10)) * mods["nIter_mult"]
        if "fp_chunk" in mods:
            kw2["fp_chunk"] = mods["fp_chunk"]
        if "relax" in mods:
            kw2["relax"] = mods["relax"]
        idx = _config.to_device(remaining, dev)
        with obs.span("sweep_quarantine_resolve", step=name,
                      lanes=int(remaining.size)):
            sub = make_case_solver(fowt, **kw2).batched(
                Hs[idx], Tp[idx], beta[idx],
                Xi0=None if Xi0 is None else Xi0[idx])
            # one pull of the re-solved lanes' summary
            ok, sconv, siters = transfers.device_get(torch.stack([
                _lane_finite(sub["Xi"]).to(torch.int32),
                sub["converged"].to(torch.int32),
                sub["iters"].to(torch.int32)]), what="quarantine_summary")
        ok, sconv = ok.astype(bool), sconv.astype(bool)
        saved = remaining[ok]
        if saved.size:
            gsel = _config.to_device(np.flatnonzero(ok), dev)
            gidx = _config.to_device(saved, dev)
            out["Xi"] = out["Xi"].index_copy(0, gidx, sub["Xi"][gsel])
            out["std"] = out["std"].index_copy(0, gidx, sub["std"][gsel])
            iters[saved] = siters[ok]
            conv[saved] = sconv[ok]
            info["recovered"] = sorted(set(info["recovered"])
                                       | {int(i) for i in saved})
        attempt = recovery.RecoveryAttempt(
            phase="sweep", case=",".join(str(int(i)) for i in remaining),
            step_from=step_from, step_to=name,
            outcome="recovered" if saved.size else "failed",
            error="NonFiniteResult",
            detail=f"{int(saved.size)}/{int(remaining.size)} lanes "
                   "recovered")
        recovery.record_attempt(attempt)
        info["ladder"].append(attempt.to_dict())
        step_from = name
        # lanes still non-finite or not converged walk on
        remaining = remaining[~(ok & sconv)]
    out["converged"] = _config.to_device(conv, dev)
    out["iters"] = _config.to_device(iters, dev, torch.int32)
    info["quarantined"] = sorted(set(info["lanes"]) - set(info["recovered"]))
    obs.events.emit("quarantine", phase="sweep", lanes=info["lanes"],
                    recovered=info["recovered"],
                    quarantined=info["quarantined"])
    return out, info


def _sweep_seam(out, ncases):
    """The ``sweep`` fault seam: ``nan@sweep:lane=K`` poisons lane K,
    ``raise@sweep`` fails the batch with an injected KernelFailure."""
    inject = []
    for i in range(ncases):
        action = faults.fire("sweep", lane=i)
        if action == "raise":
            raise errors.KernelFailure("injected sweep failure",
                                       injected=True, lane=i)
        if action == "nan":
            inject.append(i)
    if not inject:
        return out
    ij = _config.to_device(inject, out["Xi"].device)
    out = dict(out)
    for k in ("Xi", "std"):
        out[k] = out[k].index_fill(0, ij, float("nan"))
    out["converged"] = out["converged"].index_fill(0, ij, False)
    return out


def _health_summary(phase, residual, cond, lane_ok, iters) -> dict:
    """Fold one batch's pulled per-lane health arrays into JSON-safe
    summary facts, the ``raft_tpu_solve_*`` gauges and a worst-lane
    ``solve_health`` flight-recorder event (``raft_tpu/parallel/sweep.py:
    _health_summary``).  Non-finite lanes are left out of the residual
    and conditioning aggregates and counted as ``nonfinite_lanes``, so
    every fact stays finite and serializable."""
    residual = np.asarray(residual, float)
    cond = np.asarray(cond, float)
    lane_ok = np.asarray(lane_ok, bool)
    iters = np.asarray(iters)
    nonfinite = int(np.count_nonzero(~lane_ok))
    res_fin = residual[np.isfinite(residual)]
    cond_fin = cond[np.isfinite(cond)]
    res_max = float(res_fin.max()) if res_fin.size else 0.0
    res_med = float(np.median(res_fin)) if res_fin.size else 0.0
    cond_max = float(cond_fin.max()) if cond_fin.size else 0.0
    iters_max = int(iters.max(initial=0))
    if nonfinite:
        worst = int(np.flatnonzero(~lane_ok)[0])
    elif residual.size:
        worst = int(np.argmax(np.where(np.isfinite(residual),
                                       residual, np.inf)))
    else:
        worst = -1
    facts = {"residual_rel_max": res_max, "residual_rel_median": res_med,
             "cond_max": cond_max, "nonfinite_lanes": nonfinite,
             "iters_max": iters_max, "lanes": int(residual.size),
             "worst_lane": worst}
    obs.record_solve_health(phase, res_max, res_med, nonfinite,
                            cond_max=cond_max, iters_max=iters_max)
    obs.events.emit("solve_health", phase=str(phase), worst_lane=worst,
                    residual_rel_max=res_max, cond_max=cond_max,
                    nonfinite_lanes=nonfinite)
    return facts


def _solver_facts() -> dict:
    """The last solve dispatch's facts without their tensors (reading
    one would be a host pull)."""
    from raft_tpu_torch.ops.linalg import last_dispatch
    return {k: v for k, v in last_dispatch().items()
            if not isinstance(v, torch.Tensor)}


def sweep_cases(fowt_or_design, Hs, Tp, beta, nIter: int = 10,
                tol: float = 0.01, XiStart: float = 0.1, fp_chunk: int = 2,
                relax: float = 0.8, r6=None, Xi0=None, device=None,
                quarantine: str = "nonfinite", health: bool = None):
    """Solve a batch of load cases of one floating turbine.

    ``fowt_or_design``: a FOWTModel, a design dict, or the name of a
    vendored design (built on its own frequency grid).  Hs, Tp, beta
    (ncases,) [m, s, rad].  Runs on the card unless ``device="cpu"``
    (``device=None`` with no card raises).  Returns ``Xi`` (nc, 6, nw)
    complex, ``std`` (nc, 6), ``converged`` (nc,) bool, ``iters`` (nc,)
    int32 — tensors on the device — ``fp_chunks``, the number of
    fixed-point chunks that ran, and ``quarantine``: None on a clean
    batch, else the lane-quarantine record (``lanes``, ``ladder``,
    ``recovered``, ``quarantined``).

    ``quarantine`` picks the lanes re-solved down `_LANE_LADDER`: the
    non-finite ones (default), also the unconverged ones (``"all"``), or
    none (``"off"``, the lanes stay as solved).  With
    ``RAFT_TPU_RECOVERY=0`` nothing is re-solved and every offending lane
    is reported quarantined.

    ``health`` (default: the ``RAFT_TPU_HEALTH`` knob, off) adds
    ``health_residual`` and ``health_cond`` (nc,) to the outputs (see
    `make_case_solver`) and their summary to the manifest.

    Observability: spans ``sweep_cases`` > ``sweep_build`` /
    ``sweep_execute`` (/ ``sweep_quarantine_resolve``), the sweep
    metrics, the ``sweep_lanes`` probe, and a ``RunManifest`` (kind
    ``sweep_cases``) with the batch's ledger, written under
    ``obs.out_dir()`` when one is set.  Host pulls: one a fixed-point
    chunk and one summary pull (``std``, the lane flags, ``iters`` and
    the health lanes), phase ``sweep``."""
    if quarantine not in _QUARANTINE_MODES:
        raise errors.ModelConfigError(
            f"quarantine {quarantine!r} not in {_QUARANTINE_MODES}")
    health = _config.health_enabled() if health is None else bool(health)
    dev = resolve_device(device)
    fowt = on_device(fowt_or_design, dev)
    kw = dict(nIter=nIter, tol=tol, XiStart=XiStart, r6=r6,
              fp_chunk=fp_chunk, relax=relax)
    ncases = int(np.size(Hs)) if not isinstance(Hs, torch.Tensor) \
        else int(Hs.numel())
    manifest = obs.RunManifest.begin(kind="sweep_cases", config={
        "ncases": ncases, "nw": fowt.nw, "sharded": False,
        "mesh_devices": 0, "device": str(dev), "quarantine": quarantine,
        **({"health": True} if health else {}),
        **{k: v for k, v in kw.items() if isinstance(v, (int, float, str))}})
    obs.record_build_info(run_id=manifest.run_id)
    obs.device.jit_cache_delta(scope="sweep_cases")
    transfers0 = transfers.snapshot()
    status = "failed"
    ledger = None
    try:
        with obs.span("sweep_cases", ncases=ncases, sharded=False) as sp, \
                transfers.phase("sweep"):
            with obs.span("sweep_build", ncases=ncases):
                solver = make_case_solver(fowt, health=health, **kw)
                Hs, Tp, beta = (as_real(x, dev).reshape(-1)
                                for x in (Hs, Tp, beta))
                if Xi0 is not None:
                    Xi0 = _config.to_device(Xi0, dev, COMPLEX)
            with obs.span("sweep_execute", ncases=ncases):
                out = solver.batched(Hs, Tp, beta, Xi0=Xi0)
            if faults.any_active():
                out = _sweep_seam(out, ncases)
            # ONE summary pull: the lane flags, the iteration counts, the
            # stds (for the ledger) and, in health mode, the health lanes
            pull = (torch.stack([_lane_finite(out["Xi"]).to(torch.int32),
                                 out["converged"].to(torch.int32),
                                 out["iters"].to(torch.int32)]),
                    out["std"])
            if health:
                pull = pull + (out["health_residual"], out["health_cond"])
            pulled = transfers.device_get(pull, what="sweep_summary")
            flags, std_h = pulled[0], pulled[1]
            lane_ok, conv = flags[0].astype(bool), flags[1].astype(bool)
            iters = flags[2]
            obs.probes.probe("sweep_lanes", finite=lane_ok, converged=conv,
                             iters=iters)
            if quarantine == "all":
                bad = np.flatnonzero(~lane_ok | ~conv)
            elif quarantine == "off":
                bad = np.zeros(0, int)
            else:
                bad = np.flatnonzero(~lane_ok)
            info = None
            if bad.size and recovery.enabled():
                out, info = _quarantine_lanes(fowt, Hs, Tp, beta, out, bad,
                                              kw, conv, iters, Xi0)
                std_h, iters, conv = transfers.device_get(
                    (out["std"], out["iters"], out["converged"]),
                    what="sweep_ledger")
            elif bad.size:
                info = {"lanes": [int(i) for i in bad], "ladder": [],
                        "recovered": [], "quarantined": [int(i) for i in bad]}
            n_conv = int(np.count_nonzero(conv))
            fp_chunks = int(out["fp_chunks"])
            iters_max = int(np.max(iters, initial=0))
            sp.set(converged=n_conv, iters_max=iters_max,
                   fp_chunks=fp_chunks)
            obs.histogram(
                "raft_sweep_fixed_point_iterations",
                "per-case drag fixed-point iterations in the batched sweep",
                buckets=obs.ITER_BUCKETS).observe_many(iters)
            obs.gauge(
                "raft_sweep_converged_cases",
                "cases whose drag fixed point converged within nIter",
                ).set(n_conv, sharded="false")
            obs.gauge(
                "raft_sweep_batch_cases",
                "case-batch size of the most recent sweep",
                ).set(ncases, sharded="false")
            obs.gauge(
                "raft_sweep_fixed_point_chunks",
                "drag fixed-point chunks actually executed by the "
                "adaptive unroll (chunked early exit)",
                ).set(fp_chunks)
            # set every sweep (0 when clean) so a healthy batch clears
            # the previous run's reading
            obs.gauge(
                "raft_tpu_sweep_quarantined_lanes",
                "sweep lanes the batch-quarantine ladder could not "
                "recover (left NaN in the batch outputs)").set(float(
                    len((info or {}).get("quarantined", []))))
            health_info = None
            if health:
                health_info = _health_summary(
                    "sweep", pulled[2], pulled[3], lane_ok, iters)
                sp.set(health_residual_max=health_info["residual_rel_max"],
                       health_nonfinite=health_info["nonfinite_lanes"])
        if info is not None:
            manifest.extra["quarantine"] = info
        manifest.extra["solver"] = _solver_facts()
        if health_info is not None:
            manifest.extra["solve_health"] = health_info
        manifest.extra["fixed_point"] = {"chunks_run": fp_chunks,
                                         "iters_max": iters_max}
        manifest.extra["host_transfers"] = transfers.delta(
            transfers0, transfers.snapshot())
        obs.device.collect(manifest, scope="sweep_cases")
        ledger = _ledger.ledger_from_sweep(
            {"std": std_h, "iters": iters, "converged": conv},
            config=dict(manifest.config), run_id=manifest.run_id)
        status = "ok"
        out = dict(out)
        out["quarantine"] = info
        return out
    finally:
        obs.finish_run(manifest, status=status, write_trace=False,
                       ledger=ledger)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float).reshape(-1)


def sweep_cases_chunked(fowt_or_design, Hs, Tp, beta, *, store, key: str,
                        chunk: int, **kw) -> tuple[dict, dict]:
    """Resumable sweep of a large case table: the table splits into
    chunks of ``chunk`` cases, each solved by `sweep_cases` (``kw`` goes
    to it, ``Xi0`` excepted) and persisted in ``store`` (a
    ``serve.checkpoint.CheckpointStore``) under ``(key, chunk index)``,
    so a killed sweep re-solves only its unfinished chunks on the next
    call with the same key.

    A chunk is reused only when its stored content guard matches: a
    digest of the chunk's own (Hs, Tp, beta) rows, the chunk index, the
    table length, the model's content digest, the scalar ``kw``, the
    precision mode and the device type; an edited row re-solves its
    chunk alone.  The store's integrity checks come on top (a corrupt
    chunk is deleted and re-solved).  A put that hits ENOSPC
    (``StorageExhausted``) sheds persistence: the sweep keeps solving
    and stores nothing more.

    Returns ``(out, info)``: ``out`` the host numpy ``Xi``, ``std``,
    ``iters`` and ``converged`` (with ``health`` on, also
    ``health_residual`` and ``health_cond``) over the whole table;
    ``info`` the census ``{"chunks", "resumed", "solved", "ckpt_shed"}``.
    Stored chunks stay (``store.delete(key)`` drops them), so a repeated
    call is a pure read.  Each solved chunk comes to the host in one
    counted pull (phase ``sweep``); a shed is a ``storage_degraded``
    event."""
    import json

    from raft_tpu_torch.ledger import digest_metrics
    from raft_tpu_torch.parallel import exec_cache

    if "Xi0" in kw:
        raise errors.ModelConfigError(
            "sweep_cases_chunked takes no Xi0 (a warm start per chunk "
            "would not be covered by the chunk's content guard)")
    dev = resolve_device(kw.pop("device", None))
    health = kw.pop("health", None)
    health = _config.health_enabled() if health is None else bool(health)
    fowt = on_device(fowt_or_design, dev)
    Hs, Tp, beta = _host_f64(Hs), _host_f64(Tp), _host_f64(beta)
    n = int(Hs.shape[0])
    chunk = int(chunk)
    if chunk < 1 or n < 1:
        raise errors.ModelConfigError(
            "sweep_cases_chunked needs chunk >= 1 and a non-empty table",
            chunk=chunk, ncases=n)
    nchunks = -(-n // chunk)
    info = {"chunks": nchunks, "resumed": [], "solved": [],
            "ckpt_shed": False}
    solver_id = digest_metrics({
        "model": exec_cache.model_digest(fowt),
        "kw": json.dumps({k: v for k, v in kw.items()
                          if isinstance(v, (int, float, str, bool))},
                         sort_keys=True),
        "precision": [_config.precision_mode(), _config.precision_width(),
                      _config.precision_tol()],
        "device": dev.type,
        # only when on: health-off guards stay those of earlier stores
        **({"health": True} if health else {})})
    fields = ("Xi", "std", "iters", "converged")
    if health:
        fields = fields + ("health_residual", "health_cond")
    parts = []
    for ci in range(nchunks):
        sl = slice(ci * chunk, min(n, (ci + 1) * chunk))
        guard = digest_metrics({
            "Hs": Hs[sl], "Tp": Tp[sl], "beta": beta[sl], "chunk": ci,
            "ncases": n, "solver": solver_id})
        found = store.get(key, ci)
        if found is not None:
            _, arrays, meta = found
            if meta.get("kind") == "sweep_chunk" \
                    and meta.get("guard") == guard \
                    and all(k in arrays for k in fields):
                parts.append({k: arrays[k] for k in fields})
                info["resumed"].append(ci)
                continue
        out = sweep_cases(fowt, Hs[sl], Tp[sl], beta[sl], device=dev,
                          health=health, **kw)
        with transfers.phase("sweep"):
            part = transfers.device_get({k: out[k] for k in fields},
                                        what="sweep_chunk_checkpoint")
        parts.append(part)
        info["solved"].append(ci)
        if not info["ckpt_shed"]:
            try:
                store.put(key, ci, part,
                          meta={"kind": "sweep_chunk", "guard": guard,
                                "chunk": ci, "ncases": n})
            except errors.StorageExhausted as e:
                # the sweep outlives a full disk: keep solving, stop
                # persisting, and say so
                info["ckpt_shed"] = True
                obs.events.emit("storage_degraded", component="checkpoint",
                                chunk=ci, error=str(e)[:200])
    out = {k: np.concatenate([p[k] for p in parts]) for k in fields}
    return out, info


# ---------------------------------------------------------------------------
# the farm axis: N turbines x M cases as one batch of lanes
# ---------------------------------------------------------------------------

def _interp_along0(xs, ys, x):
    """Piecewise-linear interpolation of a table ``ys`` (n, ...) along its
    leading axis at ``x`` (m,) -> (m, ...): clamped inside the table, zero
    outside it (parked: below cut-in and above cut-out the rotor adds no
    aero damping), as ``raft_tpu/parallel/sweep.py:_interp_along0``."""
    idx = torch.clamp(torch.searchsorted(xs, x.contiguous(), right=True) - 1,
                      0, xs.shape[0] - 2)
    x0 = xs[idx]
    x1 = xs[idx + 1]
    f = torch.clamp((x - x0) / (x1 - x0), 0.0, 1.0)
    expand = (slice(None),) + (None,) * (ys.ndim - 1)
    out = ys[idx] * (1.0 - f)[expand] + ys[idx + 1] * f[expand]
    parked = (x < xs[0]) | (x > xs[-1])
    return torch.where(parked[expand], torch.zeros_like(out), out)


def aero_damping_table(curve, zhub):
    """(nspeeds, 6, 6) linearized aero damping from a power/thrust curve:
    dT/dU at the operating point, acting at hub height, on the (surge,
    pitch) block [[dT/dU, dT/dU z], [dT/dU z, dT/dU z^2]] (NumPy)."""
    ws = np.asarray(curve["wind_speed"], float)
    dTdU = np.gradient(np.asarray(curve["thrust"], float), ws)
    B = np.zeros((len(ws), 6, 6))
    B[:, 0, 0] = dTdU
    B[:, 0, 4] = B[:, 4, 0] = dTdU * zhub
    B[:, 4, 4] = dTdU * zhub**2
    return B


def make_farm_solver(fowt: FOWTModel, xy, curve=None, C_moor_t=None,
                     aero: bool = True, k_w: float = 0.05,
                     wake_max_iter: int = 100, wake_tol: float = 1e-4,
                     wake_relax: float = 0.5, **kw):
    """Batched farm solver (``raft_tpu/parallel/sweep.py:make_farm_solver``)
    on the FOWT's device: N turbines of one design (``fowt``, replicated at
    the positions ``xy`` (N, 2) [m]) x M cases.

    ``curve``: a power/thrust curve dict (``models/wake.py:
    power_thrust_curve``), by default the fowt's rotor's.  ``C_moor_t``:
    (N, 6, 6) per-turbine mooring stiffness (tensor or array); by default
    the fowt's own mooring stiffness at its reference position, shared
    (a platform moved with its anchors has the same stiffness).
    ``aero``: add each lane's aero damping at its waked wind speed to its
    radiation damping; False solves wave-only lanes (the wake outputs
    still come).  ``kw`` goes to `make_case_solver` (``nIter``, ``tol``,
    ``XiStart``, ``fp_chunk``, ``relax``).

    Returns ``solve_farm(Hs, Tp, beta, U_inf, wind_dir, Xi0=None)``: Hs,
    Tp, beta (L,) turbine-major lanes, L = N * ncases (lane t * ncases +
    c; `sweep_farm` tiles them), U_inf and wind_dir (ncases,).  Output:
    ``Xi`` (L, 6, nw), ``std`` (L, 6), ``converged`` / ``iters`` (L,),
    ``fp_chunks``, and ``U_wake`` / ``Ct_wake`` / ``aero_power`` (N,
    ncases), ``wake_iters`` (ncases,)."""
    from raft_tpu_torch.models import wake as wk

    dev = fowt.device
    xy = np.asarray(xy, float).reshape(-1, 2)
    nt = int(xy.shape[0])
    if nt < 1:
        raise errors.ModelConfigError("farm needs at least one turbine",
                                      n_turbines=nt)
    rot = fowt.rotors[0] if fowt.rotors else None
    if curve is None:
        if rot is None:
            raise errors.ModelConfigError(
                "make_farm_solver needs a rotor (or an explicit curve=) "
                "to build the wake power/thrust coupling")
        curve = wk.power_thrust_curve(fowt)
    D = np.full(nt, 2.0 * rot.R_rot if rot is not None
                else float(curve.get("rotor_diameter", 200.0)))
    if C_moor_t is None:
        r6_ref = as_real([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0], dev)
        C_base = (mr.coupled_stiffness_rotvec(fowt.mooring, r6_ref)
                  if fowt.mooring is not None
                  else torch.zeros((6, 6), dtype=REAL, device=dev))
        C_moor_t = C_base.expand(nt, 6, 6).clone()
    else:
        C_moor_t = as_real(C_moor_t, dev).reshape(nt, 6, 6)
    r6_t = np.zeros((nt, 6))
    r6_t[:, :2] = xy

    case = make_case_solver(fowt, **kw)
    cs, cCt, cP = wk.curve_tensors(curve, dev)
    xy_d = as_real(xy, dev)
    D_d = as_real(D, dev)
    r6_d = as_real(r6_t, dev)
    B_tab = (as_real(aero_damping_table(curve, float(rot.hubHt)), dev)
             if (aero and rot is not None) else None)

    def solve_farm(Hs, Tp, beta, U_inf, wind_dir, Xi0=None):
        U_inf = as_real(U_inf, dev).reshape(-1)
        nc = U_inf.shape[0]
        eq = wk.wake_equilibria_torch(
            xy_d, D_d, cs, cCt, cP, U_inf, as_real(wind_dir, dev),
            k_w=k_w, max_iter=wake_max_iter, tol=wake_tol,
            relax=wake_relax)
        U_t = eq["U"].T                                   # (nt, nc)
        U_l = U_t.reshape(-1)                             # turbine-major
        B_add = _interp_along0(cs, B_tab, U_l) if B_tab is not None \
            else None
        out = case.batched(Hs, Tp, beta, Xi0=Xi0,
                           r6_b=torch.repeat_interleave(r6_d, nc, dim=0),
                           C_moor_b=torch.repeat_interleave(C_moor_t, nc,
                                                            dim=0),
                           B_add=B_add)
        out = dict(out)
        out["U_wake"] = U_t
        out["Ct_wake"] = eq["Ct"].T
        out["aero_power"] = eq["power"].T
        out["wake_iters"] = eq["iterations"]
        return out

    solve_farm.fowt = fowt
    solve_farm.n_turbines = nt
    solve_farm.layout = xy
    solve_farm.curve = curve
    solve_farm.C_moor_t = C_moor_t
    solve_farm.case = case
    solve_farm.aero = bool(aero and B_tab is not None)
    solve_farm.curve_speed = cs
    solve_farm.B_tab = B_tab
    solve_farm.wake_kw = dict(k_w=float(k_w),
                              wake_max_iter=int(wake_max_iter),
                              wake_tol=float(wake_tol),
                              wake_relax=float(wake_relax))
    return solve_farm


def _farm_lane_tile(x, nt):
    """(ncases,) case array -> (L,) turbine-major lane array."""
    return torch.as_tensor(x).repeat(int(nt))


def _farm_reshape(out, nt, ncases):
    """Lane-shaped outputs -> (n_turbines, ncases, ...): lane arrays
    reshape turbine-major, the wake outputs keep their case columns,
    ``fp_chunks`` passes through."""
    shaped = {}
    for k, v in out.items():
        if k == "fp_chunks":
            shaped[k] = v
        elif k in ("U_wake", "Ct_wake", "aero_power"):
            shaped[k] = v[:, :ncases]
        elif k == "wake_iters":
            shaped[k] = v[:ncases]
        else:
            shaped[k] = v.reshape((nt, v.shape[0] // nt) + tuple(v.shape[1:]))[
                :, :ncases]
    return shaped


def sweep_farm(fowt_or_design, xy, Hs, Tp, beta, U_inf, wind_dir=None,
               device=None, **kw):
    """Solve an N-turbine x M-case farm batch (``raft_tpu/parallel/
    sweep.py:sweep_farm`` on one device, no mesh): ``xy`` (N, 2) layout
    [m]; Hs, Tp, beta (ncases,) sea states shared by every turbine of a
    case; U_inf (ncases,) free-stream hub wind speeds of the wake
    equilibrium, ``wind_dir`` (ncases,) [deg] (default 0).  ``kw`` goes
    to `make_farm_solver`.  Runs on the card unless ``device="cpu"``.
    Returns (N, ncases, ...) tensors ``Xi``, ``std``, ``converged``,
    ``iters``, ``U_wake``, ``Ct_wake``, ``aero_power``, the per-case
    ``wake_iters`` and ``fp_chunks``.

    Observability as `sweep_cases`': spans ``sweep_farm`` >
    ``farm_build`` / ``farm_execute``, the sweep metrics and the wake
    iterations, and a ``RunManifest`` (kind ``sweep_farm``) with the
    flattened lanes' ledger; host pulls in phase ``farm`` (the lane
    poses, one a wake iteration, one a fixed-point chunk, one summary
    pull)."""
    dev = resolve_device(device) if device is not None or not isinstance(
        fowt_or_design, FOWTModel) else fowt_or_design.device
    fowt = on_device(fowt_or_design, dev)
    xy = np.asarray(xy, float).reshape(-1, 2)
    nt = int(xy.shape[0])
    Hs = as_real(Hs, dev).reshape(-1)
    Tp = as_real(Tp, dev).reshape(-1)
    beta = as_real(beta, dev).reshape(-1)
    U_inf = as_real(U_inf, dev).reshape(-1)
    wind_dir = (torch.zeros_like(U_inf) if wind_dir is None
                else as_real(wind_dir, dev).reshape(-1))
    ncases = int(Hs.shape[0])
    if not (Tp.shape[0] == beta.shape[0] == U_inf.shape[0]
            == wind_dir.shape[0] == ncases):
        raise errors.ModelConfigError(
            "sweep_farm case arrays must share one length",
            ncases=ncases, Tp=int(Tp.shape[0]), beta=int(beta.shape[0]),
            U_inf=int(U_inf.shape[0]), wind_dir=int(wind_dir.shape[0]))
    from raft_tpu_torch.parallel import exec_cache
    ldig = exec_cache.model_digest({"layout": xy})
    manifest = obs.RunManifest.begin(kind="sweep_farm", config={
        "ncases": ncases, "n_turbines": nt, "nw": fowt.nw,
        "layout_digest": ldig, "sharded": False, "mesh_devices": 0,
        "device": str(dev),
        **{k: v for k, v in kw.items()
           if isinstance(v, (int, float, str))}})
    obs.record_build_info(run_id=manifest.run_id)
    obs.device.jit_cache_delta(scope="sweep_farm")
    transfers0 = transfers.snapshot()
    status = "failed"
    ledger = None
    try:
        with obs.span("sweep_farm", ncases=ncases, n_turbines=nt,
                      sharded=False) as sp, transfers.phase("farm"):
            with obs.span("farm_build", ncases=ncases, n_turbines=nt):
                solver = make_farm_solver(fowt, xy, **kw)
            with obs.span("farm_execute", ncases=ncases):
                out = solver(_farm_lane_tile(Hs, nt), _farm_lane_tile(Tp, nt),
                             _farm_lane_tile(beta, nt), U_inf, wind_dir)
            out = _farm_reshape(out, nt, ncases)
            # ONE summary pull for the whole farm batch, the wake facts
            # and the stds (for the ledger) in it
            flags, wake_iters, std_h = transfers.device_get(
                (torch.stack([_lane_finite(out["Xi"].reshape(
                    (-1,) + tuple(out["Xi"].shape[2:]))).to(torch.int32),
                    out["converged"].reshape(-1).to(torch.int32),
                    out["iters"].reshape(-1).to(torch.int32)]),
                 out["wake_iters"], out["std"]), what="farm_summary")
            lane_ok, conv = flags[0].astype(bool), flags[1].astype(bool)
            iters = flags[2]
            n_conv = int(np.count_nonzero(conv))
            n_lanes = int(conv.size)
            fp_chunks = int(out["fp_chunks"])
            nonfinite = int(np.count_nonzero(~lane_ok))
            wake_max = int(np.max(wake_iters, initial=0))
            sp.set(converged=n_conv, lanes=n_lanes,
                   iters_max=int(np.max(iters, initial=0)),
                   fp_chunks=fp_chunks, wake_iters_max=wake_max,
                   nonfinite_lanes=nonfinite)
            obs.histogram(
                "raft_sweep_fixed_point_iterations",
                "per-case drag fixed-point iterations in the batched sweep",
                buckets=obs.ITER_BUCKETS).observe_many(iters)
            obs.gauge(
                "raft_sweep_converged_cases",
                "cases whose drag fixed point converged within nIter",
                ).set(n_conv, sharded="false")
            obs.gauge(
                "raft_sweep_batch_cases",
                "case-batch size of the most recent sweep",
                ).set(n_lanes, sharded="false")
            obs.gauge(
                "raft_tpu_farm_wake_iterations",
                "wake-equilibrium fixed-point iterations of the most "
                "recent farm batch (max over cases)").set(wake_max)
        manifest.extra["farm"] = {
            "n_turbines": nt, "ncases": ncases, "layout_digest": ldig,
            "aero": solver.aero, "wake": solver.wake_kw,
            "wake_iters_max": wake_max, "nonfinite_lanes": nonfinite}
        manifest.extra["solver"] = _solver_facts()
        manifest.extra["fixed_point"] = {
            "chunks_run": fp_chunks,
            "iters_max": int(np.max(iters, initial=0))}
        manifest.extra["host_transfers"] = transfers.delta(
            transfers0, transfers.snapshot())
        obs.device.collect(manifest, scope="sweep_farm")
        # the ledger walks a 1-D case axis: the flattened turbine-major
        # lanes (lane i = turbine i // ncases, case i % ncases)
        ledger = _ledger.ledger_from_sweep(
            {"std": np.asarray(std_h).reshape(nt * ncases, -1),
             "iters": iters, "converged": conv},
            config=dict(manifest.config), run_id=manifest.run_id)
        status = "ok"
        return out
    finally:
        obs.finish_run(manifest, status=status, write_trace=False,
                       ledger=ledger)
