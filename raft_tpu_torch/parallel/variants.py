"""Design-variant sweeps: geometry as batched tensor leaves.

Port of ``raft_tpu/parallel/variants.py``.  The reference's design study
mutates the design dict and reruns the serial pipeline per variant
(raft/parametersweep.py:56-100: 3^5 = 243 VolturnUS-S geometries through
runRAFT each, with ballast trim).  Here a variant is a dict θ of tensors
(member end positions, diameter scales, ballast, mooring geometry) and the
per-variant pipeline

    geometry rebuild -> statics -> ballast density trim -> Newton
    equilibrium (exact Jacobian + line search) -> drag-linearization
    fixed point -> batched RAO solve (kernel K1, K3 under the mixed
    ladder) -> statistics

is one function of θ.  The setup (through the Newton equilibrium and the
sea-state excitation) runs under ``torch.func.vmap`` over the variants,
with ``chunk_size`` bounding its memory; the fixed point is batched by
hand with an explicit variant axis, as in JAX.

Strip node counts and station fractions stay those of the base design;
lengths, positions, diameters, areas and volumes are tensors computed
from θ.  ``make_variant_solver(implicit_diff=True)`` makes the pipeline
differentiable in θ by implicit differentiation (``parallel/optimize.py``:
the Newton through ``newton_implicit``, ``solve.implicit`` /
``solve.implicit_batched`` through ``fixed_point_implicit``, whose
adjoint passes launch K1 / K3).  ``mesh=`` (``parallel/partition.py``,
batch axes only) shards the variant axis: each shard's setup on its
device, one fixed point over every shard.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from raft_tpu_torch._config import COMPLEX, REAL, as_real
from raft_tpu_torch.errors import ModelConfigError
from raft_tpu_torch.models import mooring as mr
from raft_tpu_torch.models.fowt import (
    FOWTModel, ballast_density_trim, build_fowt, fowt_drag_excitation, fowt_drag_precompute,
    fowt_hydro_constants, fowt_hydro_excitation,
    fowt_hydro_linearization_pre, fowt_pose, fowt_statics, mcf_known,
    member_node_cols,
)
from raft_tpu_torch.ops.linalg import impedance_solve
from raft_tpu_torch.ops.spectra import get_rms, jonswap
from raft_tpu_torch.parallel.optimize import (
    fixed_point_implicit, newton_implicit)
from raft_tpu_torch.parallel.sweep import on_device, unrolled_fixed_point

# --------------------------------------------------------------------------
# geometry rebuild
# --------------------------------------------------------------------------


def variant_member(m, rA0=None, rB0=None, d_scale=None, l_fill=None,
                   rho_fill=None):
    """Copy of one MemberGeometry with moved ends / a scaled section.

    rA0/rB0: (3,) new end positions (PRP frame); d_scale: scalar or (2,)
    diameter (side-length) scale.  Station fractions and node counts stay
    those of ``m``; lengths, diameters and the dependent strip arrays are
    tensors."""
    dev = m.rA0.device if isinstance(m.rA0, torch.Tensor) else None
    rA0 = as_real(m.rA0 if rA0 is None else rA0, dev)
    rB0 = as_real(m.rB0 if rB0 is None else rB0, dev)
    l = torch.linalg.norm(rB0 - rA0)
    s_l = l / m.l
    d_scale = as_real(1.0 if d_scale is None else d_scale, dev)
    if m.circular:
        sd_node = d_scale if d_scale.ndim == 0 else d_scale[0]
        sd_cap = sd_node
    else:
        sd_node = d_scale[None, :] if d_scale.ndim == 1 else d_scale
        sd_cap = torch.mean(d_scale)
    # caps: diameters scale; ring caps keep their radial plate width
    # (dA - dAi)/2, while solid caps (dAi == 0) stay solid
    cap_dA0 = as_real(m.cap_dA, dev)
    cap_dB0 = as_real(m.cap_dB, dev)
    cap_dAi0 = as_real(m.cap_dAi, dev)
    cap_dBi0 = as_real(m.cap_dBi, dev)
    cap_dA = cap_dA0 * sd_cap
    cap_dB = cap_dB0 * sd_cap
    cap_tA = 0.5 * (cap_dA0 - cap_dAi0)
    cap_tB = 0.5 * (cap_dB0 - cap_dBi0)
    cap_dAi = torch.where(cap_dAi0 > 0.0,
                          torch.clamp(cap_dA - 2.0 * cap_tA, min=0.0), 0.0)
    cap_dBi = torch.where(cap_dBi0 > 0.0,
                          torch.clamp(cap_dB - 2.0 * cap_tB, min=0.0), 0.0)
    return dataclasses.replace(
        m,
        rA0=rA0, rB0=rB0, l=l,
        stations=as_real(m.stations, dev) * s_l,
        d=as_real(m.d, dev) * sd_node,
        ls=as_real(m.ls, dev) * s_l,
        dls=as_real(m.dls, dev) * s_l,
        ds=as_real(m.ds, dev) * sd_node,
        drs=as_real(m.drs, dev) * sd_node,
        l_fill=as_real(m.l_fill if l_fill is None else l_fill, dev) * s_l,
        rho_fill=as_real(m.rho_fill if rho_fill is None else rho_fill, dev),
        cap_L=as_real(m.cap_L, dev) * sd_cap,
        cap_h=as_real(m.cap_h, dev) * s_l,
        cap_dA=cap_dA, cap_dB=cap_dB, cap_dAi=cap_dAi, cap_dBi=cap_dBi,
    )


def variant_fowt(base: FOWTModel, theta: dict) -> FOWTModel:
    """FOWTModel of one variant.

    theta keys (all optional, indexed over base.members / mooring lines):
      rA0, rB0     (nmem, 3)  member end positions
      d_scale      (nmem, 2)  diameter / side-length scales
      l_fill, rho_fill        per-member lists
      moor_rFair0  (nl, 3), moor_rAnchor (nl, 3), moor_L (nl,),
      moor_EA (nl,)   (simple moorings only: a mooring with free
                       points or multi-segment lines raises
                       ModelConfigError, as the JAX package has no
                       variants of one to hold the port to; ROADMAP A7)

    A submerged rotor's blade members are members like any other: θ rows
    index them too and move them as given, as in the JAX package; they
    are not rebuilt from the rotor.
    """
    def get(key, i):
        v = theta.get(key)
        return None if v is None else v[i]

    members = [
        variant_member(
            m, rA0=get("rA0", i), rB0=get("rB0", i),
            d_scale=None if theta.get("d_scale") is None
            else theta["d_scale"][i, :2],
            l_fill=get("l_fill", i), rho_fill=get("rho_fill", i))
        for i, m in enumerate(base.members)
    ]
    # the node columns derived from the geometry are rebuilt; the static
    # ones (indices, coefficients, masks) carry over from the base
    derived = [member_node_cols(m) for m in members]
    nodes = dataclasses.replace(
        base.nodes, **{key: torch.cat([d[key] for d in derived])
                       for key in ("frac", "dls", "a_i_q", "a_i_p1",
                                   "a_i_p2", "a_i_end_drag", "v_side",
                                   "v_end", "a_i", "R")})
    moor = base.mooring
    keys = ("moor_rFair0", "moor_rAnchor", "moor_L", "moor_EA")
    if moor is not None and any(k in theta for k in keys):
        _refuse_general(moor)
        moor = dataclasses.replace(
            moor,
            rFair0=as_real(theta.get("moor_rFair0", moor.rFair0)),
            rAnchor=as_real(theta.get("moor_rAnchor", moor.rAnchor)),
            L=as_real(theta.get("moor_L", moor.L)),
            EA=as_real(theta.get("moor_EA", moor.EA)))
    return dataclasses.replace(base, members=members, nodes=nodes,
                               mooring=moor)


def _refuse_general(moor):
    if moor is not None and mr._is_general(moor):
        raise ModelConfigError(
            "design variants of a mooring with free points or multi-segment "
            "lines are not supported (ROADMAP A7); vary the members only")


# --------------------------------------------------------------------------
# statics: exact-Jacobian Newton with a backtracking line search
# --------------------------------------------------------------------------

_DB = (30.0, 30.0, 5.0, 0.1, 0.1, 0.1)
_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


def statics_newton(net_force, X0, iters: int = 20):
    """Damped Newton equilibrium with the exact Jacobian and a line search
    on |F|^2 over five step lengths; a fixed number of steps, each
    accepting the best candidate only if it improves on X
    (``raft_tpu/parallel/variants.py:statics_newton``).  Runs under
    ``torch.func.vmap``.

    The Jacobian is taken in reverse mode (``torch.func.jacrev``; the JAX
    package's ``jacfwd`` to rounding, ~2e-15): in forward mode every op
    between a dual and a constant of the 40-step catenary makes PyTorch
    build a zero tangent whose shape it works out in Python, which makes
    ``jacfwd`` ~7x the cost of ``jacrev`` here."""
    X = as_real(X0)
    dev = X.device
    # non-blocking copies and solve_ex (no error check): no host wait
    db = as_real(_DB, dev)
    alphas = as_real(_ALPHAS, dev)
    eye = torch.eye(6, dtype=REAL, device=dev)
    merit_of = torch.func.vmap(lambda x: torch.sum(net_force(x) ** 2))
    for _ in range(int(iters)):
        F = net_force(X)
        J = -torch.func.jacrev(net_force)(X) + 1e-6 * eye
        dX = torch.clamp(torch.linalg.solve_ex(J, F)[0], -db, db)
        cands = X[None, :] + alphas[:, None] * dX[None, :]
        merit = merit_of(cands)
        merit = torch.where(torch.isfinite(merit), merit, torch.inf)
        best = torch.argmin(merit)
        X = torch.where(merit[best] < torch.sum(F ** 2), cands[best], X)
    return X


# --------------------------------------------------------------------------
# per-variant pipeline
# --------------------------------------------------------------------------

#: the setup outputs one drag pass reads (the fixed point's state)
_STEP_STATE = ("pose_eq", "drag_pre", "u0", "M_lin", "C_lin", "F_lin")


def make_variant_solver(base: FOWTModel, Hs=6.0, Tp=12.0, beta=0.0,
                        F_env=None, A_turb=None, B_turb=None,
                        ballast: bool = True, nIter: int = 10,
                        tol: float = 0.01, XiStart: float = 0.1,
                        newton_iters: int = 20, fp_chunk: int = 2,
                        chunk_size=None, implicit_diff: bool = False,
                        adjoint_iters=None, mesh=None):
    """The per-variant function θ -> outputs, on the base model's device
    (``solve.device``): ``solve(theta)`` for one variant,
    ``solve.batched(thetas)`` for a batch (leading variant axis on every
    θ leaf).

    ``implicit_diff``: ``solve.implicit(theta)`` /
    ``solve.implicit_batched(thetas)`` exist: the pipeline differentiable
    in θ, its statics Newton through ``optimize.newton_implicit`` (the
    same values; the gradient one solve with its tangent stiffness), its
    drag fixed point through ``optimize.fixed_point_implicit``
    (``nIter`` passes, ``adjoint_iters`` adjoint passes, default
    ``2 * nIter``).  After a call ``solve.fixed_point`` holds the passes
    it ran (``passes``, and ``adjoint_passes`` once its backward ran) and
    ``solve.timings`` its host-clock walls (no wait for the card: its
    queued setup work falls to the fixed point's first counted pull).  The values of ``solve`` and
    ``solve.batched`` do not change with the flag.

    F_env: constant environmental force (mean thrust + current drag) from
    the base design; A_turb/B_turb: (6,6,nw) aero added mass/damping.
    Outputs per variant: mass, displacement, GMT, offset, pitch_deg (the
    reference parametersweep metrics), Xeq (6,), Xi (6,nw), std (6,).
    ``chunk_size`` bounds how many variants the vmapped setup holds at
    once (None: all).  After ``solve.batched`` the wall seconds of its
    two phases are in ``solve.timings`` (``setup``, ``fixed_point``).

    ``mesh`` (``parallel/partition.py``, batch axes only): ``batched``
    takes a variant axis that is a multiple of the mesh's batch size and
    shards it: each shard's vmapped setup runs on its device (the
    solver's twin there), one fixed point runs every shard, and the
    outputs come back on this device in lane order; ``implicit_sharded``
    is the differentiable path over per-shard θ lists."""
    from raft_tpu_torch.parallel import partition

    partition.require_batch_only(mesh, "make_variant_solver")
    knobs = dict(Hs=Hs, Tp=Tp, beta=beta, F_env=F_env, A_turb=A_turb,
                 B_turb=B_turb, ballast=ballast, nIter=nIter, tol=tol,
                 XiStart=XiStart, newton_iters=newton_iters,
                 fp_chunk=fp_chunk, chunk_size=chunk_size,
                 implicit_diff=implicit_diff, adjoint_iters=adjoint_iters)
    dev = base.device
    w = as_real(base.w, dev)
    nw = base.nw
    dw = w[1] - w[0]               # left on the device: no host wait
    F_env = torch.zeros(6, dtype=REAL, device=dev) if F_env is None \
        else as_real(F_env, dev)
    A_t = torch.zeros((6, 6, nw), dtype=REAL, device=dev) if A_turb is None \
        else as_real(A_turb, dev)
    B_t = torch.zeros((6, 6, nw), dtype=REAL, device=dev) if B_turb is None \
        else as_real(B_turb, dev)
    rho = base.rho_water

    def setup(theta, implicit: bool = False):
        """One variant's statics, equilibrium and dynamics state;
        ``implicit``: the Newton through ``newton_implicit`` (the
        differentiable path only, so ``solve`` / ``solve.batched`` never
        pay its tangent solve)."""
        fowt = variant_fowt(base, theta)
        ref = torch.zeros(6, dtype=REAL, device=dev)
        pose0 = fowt_pose(fowt, ref)
        stat = fowt_statics(fowt, pose0)

        # ----- ballast density trim, closed form (reference:
        #       raft_model.py:1569-1624, parametersweep.py:93); a variant
        #       with no ballast volume keeps its densities (delta 0) -----
        if ballast:
            l_fill, rho_fill, _, _, _ = ballast_density_trim(fowt, pose0,
                                                             ref)
            stat = fowt_statics(fowt, pose0, l_fill=l_fill,
                                rho_fill=rho_fill)

        K_hs = stat["C_struc"] + stat["C_hydro"]
        F0 = stat["W_struc"] + stat["W_hydro"] + F_env

        def net_force(X):
            F = F0 - K_hs @ X
            if fowt.mooring is not None:
                F = F + mr.body_wrench(fowt.mooring, X)
            return F

        if implicit:
            Xeq = newton_implicit(net_force, ref, iters=newton_iters)
        else:
            Xeq = statics_newton(net_force, ref, iters=newton_iters)

        # ----- dynamics state: drag precompute + the linear system -----
        hc = fowt_hydro_constants(fowt, pose0)
        # rotation-vector flavour = the reference's MoorPy analytic
        # stiffness at the loaded equilibrium
        C_moor = (mr.coupled_stiffness_rotvec(fowt.mooring, Xeq)
                  if fowt.mooring is not None
                  else torch.zeros((6, 6), dtype=REAL, device=dev))
        pose_eq = fowt_pose(fowt, Xeq)
        S = jonswap(w, Hs, Tp)
        zeta = torch.sqrt(2.0 * S * dw).to(COMPLEX)
        seastate = dict(beta=as_real(beta, dev).reshape(1),
                        zeta=zeta[None])
        exc = fowt_hydro_excitation(fowt, pose_eq, seastate, hc)
        u0 = exc["u"][0]
        drag_pre = fowt_drag_precompute(fowt, pose_eq, u0)
        return dict(
            pose_eq={k: pose_eq[k] for k in ("r6", "r", "q", "p1", "p2",
                                             "qMat", "p1Mat", "p2Mat")},
            drag_pre=drag_pre, u0=u0,
            M_lin=(stat["M_struc"] + hc["A_hydro_morison"])[:, :, None]
            + A_t,
            C_lin=stat["C_struc"] + stat["C_hydro"] + C_moor,
            F_lin=exc["F_hydro_iner"][0],
            mass=stat["M_struc"][0, 0],
            displacement=stat["V"] * rho,
            GMT=stat["rM"][2] - stat["rCG"][2],
            offset=torch.hypot(Xeq[0], Xeq[1]),
            pitch_deg=torch.rad2deg(Xeq[4]),
            Xeq=Xeq,
        )

    def drag_step(st, Xi):
        """One drag pass + the impedance solve; rank-polymorphic over an
        optional leading variant axis."""
        B_drag6, Bmat = fowt_hydro_linearization_pre(
            base, st["pose_eq"], st["drag_pre"], Xi)
        F_drag = fowt_drag_excitation(base, st["pose_eq"], Bmat, st["u0"])
        return impedance_solve(w, st["M_lin"], B_t + B_drag6[..., None],
                               st["C_lin"], st["F_lin"] + F_drag)

    def finish(st, Xi):
        out = {k: st[k] for k in ("mass", "displacement", "GMT", "offset",
                                  "pitch_deg", "Xeq")}
        out["Xi"] = Xi
        out["std"] = get_rms(Xi, axis=-1)
        return out

    def solve(theta):
        """One variant, iterated until it converges or nIter + 1 passes
        ran (the serial reference)."""
        theta = {k: as_real(v, dev) for k, v in theta.items()}
        st = setup(theta)
        XiLast = torch.zeros((6, nw), dtype=COMPLEX, device=dev) + XiStart
        Xi = XiLast
        for _ in range(int(nIter) + 1):
            Xin = drag_step(st, XiLast)
            conv = bool(torch.all(torch.abs(Xin - XiLast)
                                  / (torch.abs(Xin) + tol) < tol))
            Xi = Xin
            if conv:
                break
            XiLast = 0.2 * XiLast + 0.8 * Xin
        return finish(st, Xi)

    def _sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def peer(device):
        """This solver's twin on ``device`` (the base carried there)."""
        d = partition.canonical_device(device)
        if d not in solve.peers:
            solve.peers[d] = make_variant_solver(on_device(base, d), **knobs)
        return solve.peers[d]

    def solve_sharded(thetas):
        """`solve_batched` over ``mesh`` (see `make_variant_solver`)."""
        t0 = time.perf_counter()
        with partition.spmd(mesh), mcf_known(base):
            parts = partition.shard_tree(thetas, mesh,
                                         partition.VARIANT_INPUT_RULES)
            peers = [peer(d) for d in partition.shard_devices(mesh)]
            sts = [torch.func.vmap(p.setup, chunk_size=chunk_size)(
                {k: as_real(v, p.device) for k, v in part.items()})
                for p, part in zip(peers, parts)]
            t1 = time.perf_counter()
            seeds = [torch.zeros((st["Xeq"].shape[0], 6, nw), dtype=COMPLEX,
                                 device=p.device) + XiStart
                     for p, st in zip(peers, sts)]
            _, Xi, done, iters, chunks = unrolled_fixed_point(
                lambda zs: [p.drag_step(st, z)
                            for p, st, z in zip(peers, sts, zs)],
                seeds, nIter + 1, tol, chunk=fp_chunk)
            outs = [dict(p.finish(st, x), converged=dn, iters=it)
                    for p, st, x, dn, it in zip(peers, sts, Xi, done, iters)]
            out = partition.gather_tree(outs, mesh, dev)
        out["fp_chunks"] = chunks
        solve.timings = dict(setup=t1 - t0,
                             fixed_point=time.perf_counter() - t1)
        return out

    def implicit_sharded(thetas_list):
        """`implicit_batched` over ``mesh``: ``thetas_list`` holds one θ
        batch per shard this process runs (on its device, in lane
        order); returns one output dict per shard.  The drag fixed point
        is ONE ``fixed_point_implicit`` over every shard (its forward and
        adjoint chunk pulls are the unsharded batch's)."""
        peers = [peer(d) for d in partition.shard_devices(mesh)]
        t0 = time.perf_counter()
        with mcf_known(base):
            sts = [torch.func.vmap(functools.partial(p.setup, implicit=True),
                                   chunk_size=chunk_size)(
                pytree.tree_map(lambda v: as_real(v, p.device), th))
                for p, th in zip(peers, thetas_list)]
        t1 = time.perf_counter()
        seeds = [torch.zeros((st["Xeq"].shape[0], 6, nw), dtype=COMPLEX,
                             device=p.device) + XiStart
                 for p, st in zip(peers, sts)]
        record = {}
        with partition.spmd(mesh):
            Xi = fixed_point_implicit(
                lambda states, zs: [p.drag_step(st, z) for p, st, z
                                    in zip(peers, states, zs)],
                seeds, [{k: st[k] for k in _STEP_STATE} for st in sts],
                nIter=nIter, tol=tol, adjoint_iters=adjoint_iters,
                chunk=fp_chunk, record=record)
        solve.fixed_point = record
        outs = [p.finish(st, x) for p, st, x in zip(peers, sts, Xi)]
        solve.timings = dict(setup=t1 - t0,
                             fixed_point=time.perf_counter() - t1)
        return outs

    def solve_batched(thetas):
        """A batch of variants: the vmapped setup, then the hand-batched
        fixed point with per-variant convergence freezing."""
        if mesh is not None:
            return solve_sharded(thetas)
        thetas = {k: as_real(v, dev) for k, v in thetas.items()}
        t0 = time.perf_counter()
        st = torch.func.vmap(setup, chunk_size=chunk_size)(thetas)
        _sync()
        t1 = time.perf_counter()
        nv = st["Xeq"].shape[0]
        Xi0 = torch.zeros((nv, 6, nw), dtype=COMPLEX, device=dev) + XiStart
        _, Xi, done, iters, chunks = unrolled_fixed_point(
            lambda XiLast: drag_step(st, XiLast), Xi0, nIter + 1, tol,
            chunk=fp_chunk)
        out = finish(st, Xi)
        out.update(converged=done, iters=iters, fp_chunks=chunks)
        _sync()
        solve.timings = dict(setup=t1 - t0,
                             fixed_point=time.perf_counter() - t1)
        return out

    def implicit_batched(thetas):
        """A batch of variants, differentiable in θ: the vmapped setup,
        then the implicit drag fixed point over the variant axis (the
        port's form of the JAX package's ``vmap(solve.implicit)``)."""
        thetas = pytree.tree_map(lambda v: as_real(v, dev), thetas)
        t0 = time.perf_counter()
        st = torch.func.vmap(functools.partial(setup, implicit=True),
                             chunk_size=chunk_size)(thetas)
        t1 = time.perf_counter()
        nv = st["Xeq"].shape[0]
        Xi0 = torch.zeros((nv, 6, nw), dtype=COMPLEX, device=dev) + XiStart
        record = {}
        Xi = fixed_point_implicit(
            drag_step, Xi0, {k: st[k] for k in _STEP_STATE}, nIter=nIter,
            tol=tol, adjoint_iters=adjoint_iters, chunk=fp_chunk,
            record=record)
        solve.fixed_point = record
        out = finish(st, Xi)
        solve.timings = dict(setup=t1 - t0,
                             fixed_point=time.perf_counter() - t1)
        return out

    def implicit(theta):
        """One variant, differentiable in θ (``solve.implicit_batched``
        on a batch of one)."""
        out = implicit_batched(pytree.tree_map(lambda v: v[None], theta))
        return {k: v[0] for k, v in out.items()}

    solve.batched = solve_batched
    if implicit_diff:
        solve.implicit = implicit
        solve.implicit_batched = implicit_batched
        solve.fixed_point = {}
        if mesh is not None:
            solve.implicit_sharded = implicit_sharded
    solve.mesh = mesh
    solve.peers = {partition.canonical_device(dev): solve}
    solve.device = dev
    solve.setup = setup
    solve.drag_step = drag_step
    solve.finish = finish
    solve.timings = {}
    return solve


def sweep_variants(base, thetas: dict, device=None, mesh=None, **kw):
    """Solve a batch of design variants of ``base`` (a FOWTModel, a
    design dict or a vendored design name).  ``thetas``: dict of arrays
    with a leading variant axis (see :func:`variant_fowt`); ``kw`` go to
    :func:`make_variant_solver`.  Runs on the card unless
    ``device="cpu"`` (``device=None`` with no card raises).  Returns the
    per-variant outputs as tensors on the device, plus ``converged``,
    ``iters`` and ``fp_chunks`` of the fixed point and ``timings``.

    ``mesh`` (batch axes only; ``VARIANT_INPUT_RULES``): the variant axis
    is padded to the mesh's batch size (copies of the last variant),
    sharded over the mesh's devices (the call runs on its first device,
    or on ``device``) and the padding stripped from every output; a
    ``sweep_variants`` span and the ``raft_tpu_mesh_devices`` gauge
    record the topology."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.parallel import partition
    from raft_tpu_torch.parallel.sweep import _mesh_gauge, _unpad, mesh_device

    partition.require_batch_only(mesh, "sweep_variants")
    dev = mesh_device(mesh, device)
    base = on_device(base, dev)
    nv = len(pytree.tree_leaves(thetas)[0])
    with obs.span("sweep_variants", nv=nv, sharded=mesh is not None) as sp:
        _mesh_gauge(sp, partition.mesh_facts(mesh))
        solver = make_variant_solver(base, mesh=mesh, **kw)
        if mesh is not None:
            thetas, _ = partition.pad_batch(thetas, nv,
                                            partition.batch_size(mesh))
        out = _unpad(solver.batched(thetas), nv)
    out["timings"] = dict(solver.timings)
    return out


# --------------------------------------------------------------------------
# the reference 3^5 VolturnUS-S grid as a θ batch
# --------------------------------------------------------------------------

def volturn_grid(design: dict, factors=(0.75, 1.0, 1.25)):
    """The reference parametersweep grid (parametersweep.py:33-100):
    center-column diameter, outer-column diameter, draft, outer-column
    radius, pontoon height — with the dependent pontoon-end and
    mooring-fairlead updates — as a θ batch over the base model's member
    list (numpy; a copy of ``raft_tpu/parallel/variants.py:
    volturn_grid``).  Returns (thetas, meta)."""
    plat = design["platform"]["members"]
    ccD0 = float(np.atleast_1d(plat[0]["d"])[0])
    ocD0 = float(np.atleast_1d(plat[1]["d"])[0])
    T0 = float(plat[0]["rA"][2])
    ocR0 = float(plat[1]["rA"][0])
    pH0 = float(np.atleast_1d(plat[2]["d"])[1]) if np.ndim(plat[2]["d"]) \
        else float(plat[2]["d"])

    f = np.asarray(factors, float)
    ccDs, ocDs, Ts, ocRs, pHs = (ccD0 * f, ocD0 * f, T0 * f, ocR0 * f, pH0 * f)
    grid = np.stack(np.meshgrid(ccDs, ocDs, Ts, ocRs, pHs, indexing="ij"),
                    axis=-1).reshape(-1, 5)
    nv = len(grid)

    # the per-variant design mutations on the flattened member list
    # (reference parametersweep.py:57-90); heading-expanded members of
    # one entry share the same local-frame mutation
    base = build_fowt(design, np.asarray([1.0]), depth=600.0,
                      geometry_only=True)
    nmem = len(base.members)
    rA = np.tile(np.stack([np.asarray(m.rA0) for m in base.members]),
                 (nv, 1, 1))
    rB = np.tile(np.stack([np.asarray(m.rB0) for m in base.members]),
                 (nv, 1, 1))
    d_scale = np.ones((nv, nmem, 2))
    groups = base.platmem_groups

    moor = base.mooring
    _refuse_general(moor)
    rFair = np.tile(np.asarray(moor.rFair0), (nv, 1, 1)) if moor else None

    for iv, (a, b, c, d, e) in enumerate(grid):
        sa, sb, se = a / ccD0, b / ocD0, e / pH0
        # member entry 0: center column - diameter a, draft c
        for i in groups[0]:
            d_scale[iv, i, :] = sa
            rA[iv, i, 2] = c
        # member entry 1: outer columns - diameter b, radius d, draft c
        for i in groups[1]:
            ang = np.arctan2(rB[iv, i, 1], rB[iv, i, 0])
            rA[iv, i, 0], rA[iv, i, 1] = d * np.cos(ang), d * np.sin(ang)
            rB[iv, i, 0], rB[iv, i, 1] = d * np.cos(ang), d * np.sin(ang)
            d_scale[iv, i, :] = sb
            rA[iv, i, 2] = c
        # member entry 2: lower pontoons - height e, span from center
        # column face to outer column face, sitting on the keel at draft c
        for i in groups[2]:
            ang = np.arctan2(rB[iv, i, 1], rB[iv, i, 0])
            d_scale[iv, i, 1] = se   # height is the second side length
            # inner end follows the center-column face (parametersweep:58-59)
            rA[iv, i, :2] = np.array([np.cos(ang), np.sin(ang)]) \
                * np.hypot(*np.asarray(base.members[i].rA0)[:2]) * sa
            rB[iv, i, :2] = np.array([np.cos(ang), np.sin(ang)]) * (d - b / 2)
            rA[iv, i, 2] = c + e / 2
            rB[iv, i, 2] = c + e / 2
        if len(groups) > 3:
            # member entry 3: upper pontoons / struts - follow the columns
            for i in groups[3]:
                ang = np.arctan2(rB[iv, i, 1], rB[iv, i, 0])
                rA[iv, i, :2] = np.array([np.cos(ang), np.sin(ang)]) \
                    * np.hypot(*np.asarray(base.members[i].rA0)[:2]) * sa
                rB[iv, i, :2] = np.array([np.cos(ang), np.sin(ang)]) \
                    * (d - b / 2)
        # mooring fairleads follow the outer-column outer face
        # (parametersweep.py:66-71, 82-87)
        if rFair is not None:
            for il in range(rFair.shape[1]):
                ang = np.arctan2(rFair[iv, il, 1], rFair[iv, il, 0])
                rFair[iv, il, 0] = (d + b / 2) * np.cos(ang)
                rFair[iv, il, 1] = (d + b / 2) * np.sin(ang)

    thetas = dict(rA0=rA, rB0=rB, d_scale=d_scale)
    if rFair is not None:
        thetas["moor_rFair0"] = rFair
    meta = dict(shape=(len(f),) * 5, axes=dict(ccD=ccDs, ocD=ocDs, T=Ts,
                                               ocR=ocRs, pH=pHs), grid=grid)
    return thetas, meta
