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

Not ported here (ROADMAP): the device mesh / partition rules and the
executable cache (A9); the run manifest and the health telemetry (A8);
lane quarantine of the farm sweep (the JAX package has none either); the
farm runner of the service (``make_farm_runner``,
``normalize_farm_request``, A10).
"""
from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import _config, errors, recovery
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
from raft_tpu_torch.recovery import relax_weights
from raft_tpu_torch.testing import faults
from raft_tpu_torch.utils.dicttools import get_from_dict


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
        r6_h = r6_b.detach().cpu().numpy()
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
        return dict(Xi=Xi, std=get_rms(Xi, axis=-1), converged=done,
                    iters=iters, fp_chunks=chunks)

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


def _quarantine_lanes(fowt, Hs, Tp, beta, out, bad, kw, conv, Xi0=None):
    """Re-solve only the lanes ``bad`` of a sweep batch down
    `_LANE_LADDER`, splicing every finite result back into ``out``; a
    lane still non-finite or unconverged after a rung goes on to the
    next, and a lane no rung makes finite stays NaN and is reported as
    quarantined.  ``conv`` is the batch's pulled convergence flags.
    Returns ``(out, info)``; ``out["converged"]`` and ``out["iters"]``
    come back agreeing with the spliced lanes."""
    dev = out["Xi"].device
    info = {"lanes": [int(i) for i in bad], "ladder": [], "recovered": [],
            "quarantined": []}
    out = dict(out)
    iters = out["iters"].cpu().numpy().copy()
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
        idx = torch.as_tensor(remaining, device=dev)
        sub = make_case_solver(fowt, **kw2).batched(
            Hs[idx], Tp[idx], beta[idx],
            Xi0=None if Xi0 is None else Xi0[idx])
        # one pull of the re-solved lanes' summary
        ok, sconv, siters = torch.stack([
            _lane_finite(sub["Xi"]).to(torch.int32),
            sub["converged"].to(torch.int32),
            sub["iters"].to(torch.int32)]).cpu().numpy()
        ok, sconv = ok.astype(bool), sconv.astype(bool)
        saved = remaining[ok]
        if saved.size:
            gsel = torch.as_tensor(np.flatnonzero(ok), device=dev)
            gidx = torch.as_tensor(saved, device=dev)
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
    out["converged"] = torch.as_tensor(conv, device=dev)
    out["iters"] = torch.as_tensor(iters, dtype=torch.int32, device=dev)
    info["quarantined"] = sorted(set(info["lanes"]) - set(info["recovered"]))
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
    ij = torch.as_tensor(inject, device=out["Xi"].device)
    out = dict(out)
    for k in ("Xi", "std"):
        out[k] = out[k].index_fill(0, ij, float("nan"))
    out["converged"] = out["converged"].index_fill(0, ij, False)
    return out


def sweep_cases(fowt_or_design, Hs, Tp, beta, nIter: int = 10,
                tol: float = 0.01, XiStart: float = 0.1, fp_chunk: int = 2,
                relax: float = 0.8, r6=None, Xi0=None, device=None,
                quarantine: str = "nonfinite"):
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
    is reported quarantined."""
    if quarantine not in _QUARANTINE_MODES:
        raise errors.ModelConfigError(
            f"quarantine {quarantine!r} not in {_QUARANTINE_MODES}")
    dev = resolve_device(device)
    fowt = on_device(fowt_or_design, dev)
    kw = dict(nIter=nIter, tol=tol, XiStart=XiStart, r6=r6,
              fp_chunk=fp_chunk, relax=relax)
    Hs, Tp, beta = (as_real(x, dev).reshape(-1) for x in (Hs, Tp, beta))
    if Xi0 is not None:
        Xi0 = torch.as_tensor(Xi0, device=dev).to(COMPLEX)
    out = make_case_solver(fowt, **kw).batched(Hs, Tp, beta, Xi0=Xi0)
    if faults.any_active():
        out = _sweep_seam(out, int(Hs.shape[0]))
    # one pull: the per-lane finite flags beside the convergence flags
    lane_ok, conv = torch.stack([_lane_finite(out["Xi"]),
                                 out["converged"]]).cpu().numpy()
    if quarantine == "all":
        bad = np.flatnonzero(~lane_ok | ~conv)
    elif quarantine == "off":
        bad = np.zeros(0, int)
    else:
        bad = np.flatnonzero(~lane_ok)
    info = None
    if bad.size and recovery.enabled():
        out, info = _quarantine_lanes(fowt, Hs, Tp, beta, out, bad, kw,
                                      conv, Xi0)
    elif bad.size:
        info = {"lanes": [int(i) for i in bad], "ladder": [],
                "recovered": [], "quarantined": [int(i) for i in bad]}
    out = dict(out)
    out["quarantine"] = info
    return out


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
    ``iters`` and ``converged`` over the whole table; ``info`` the
    census ``{"chunks", "resumed", "solved", "ckpt_shed"}``.  Stored
    chunks stay (``store.delete(key)`` drops them), so a repeated call
    is a pure read."""
    import json

    from raft_tpu_torch.ledger import digest_metrics
    from raft_tpu_torch.parallel import exec_cache

    if "Xi0" in kw:
        raise errors.ModelConfigError(
            "sweep_cases_chunked takes no Xi0 (a warm start per chunk "
            "would not be covered by the chunk's content guard)")
    dev = resolve_device(kw.pop("device", None))
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
        "device": dev.type})
    fields = ("Xi", "std", "iters", "converged")
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
        out = sweep_cases(fowt, Hs[sl], Tp[sl], beta[sl], device=dev, **kw)
        part = {k: out[k].cpu().numpy() for k in fields}
        parts.append(part)
        info["solved"].append(ci)
        if not info["ckpt_shed"]:
            try:
                store.put(key, ci, part,
                          meta={"kind": "sweep_chunk", "guard": guard,
                                "chunk": ci, "ncases": n})
            except errors.StorageExhausted:
                # the sweep outlives a full disk: keep solving, stop
                # persisting
                info["ckpt_shed"] = True
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
    ``wake_iters`` and ``fp_chunks``."""
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
    solver = make_farm_solver(fowt, xy, **kw)
    out = solver(_farm_lane_tile(Hs, nt), _farm_lane_tile(Tp, nt),
                 _farm_lane_tile(beta, nt), U_inf, wind_dir)
    return _farm_reshape(out, nt, ncases)
