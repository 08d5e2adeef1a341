"""Co-design gradients: implicit differentiation of the variant pipeline.

Port of the gradient half of ``raft_tpu/parallel/optimize.py``.  A design
objective (RAO std, mean offset or a damage-equivalent-load proxy) is a
function of a flat design vector x through the variant pipeline

    x -> DesignSpace.to_theta -> setup (geometry, statics, the Newton
    equilibrium, the sea state) -> drag-linearization fixed point around
    impedance_solve (K1; K3 under RAFT_TPU_PRECISION=mixed) -> objective

and its gradient is taken by the implicit-function theorem, never by
differentiating the iterations:

``newton_implicit``
    The equilibrium F(X*, θ) = 0: the forward is
    ``variants.statics_newton`` without a graph; the gradient is one solve
    with the regularized tangent stiffness K = -∂F/∂X + 1e-6 I at X*
    (``raft_tpu/parallel/optimize.py:_newton_bwd``), written as
    X* + (c - c.detach()) with c = K(X*)^-1 F(X*, θ): the value is X*
    and the gradient JAX's ``custom_vjp``'s, under ``torch.func.vmap``
    too.

``fixed_point_implicit``
    Xi* = T(Xi*, θ) over a leading lane axis (`FixedPoint`, a
    ``torch.autograd.Function``): the forward runs ``nIter`` relaxed
    passes with a per-lane freeze and returns the relaxed iterate; the
    backward iterates the adjoint fixed point λ = X̄ + (∂T/∂Xi)^H λ with
    the same weights and freeze (2 nIter passes by default), each pass
    one pullback of T and so one adjoint impedance solve
    (``ops/linalg.ImpedanceSolve``: one K1 / K3 launch on the card).

The design layer (``DesignSpace``, the objectives, ``make_design_objective``
and ``grad_guarded``) is the JAX package's; its numpy bookkeeping is
copied, not imported.  ``grad_guarded`` of one design raises
``NonFiniteResult`` with ``phase == "adjoint"`` on a non-finite value or
gradient; of a lane batch it returns the values, the gradients and a
per-lane finite mask, and a poisoned lane changes no other lane's
gradient.

The batched descent (``make_descent``, ``optimize_designs``) runs L
box-projected descents at once with Adam or L-BFGS
(``parallel/optimizers.py``, the port's copies of optax's): each step is
one value and gradient of the lane batch (the pipeline above, forward and
adjoint), the optimizer's update (L-BFGS: its linesearch's trials, each
one more value and gradient of the batch), ``DesignSpace.clip`` and the
per-lane freeze: a lane whose value or gradient goes non-finite is
frozen at its last iterate and counted, and never stalls the others (a
frozen lane leaves the linesearch before its first trial).  Between its
counted pulls the descent never waits for the card: its walls
(``descent_step`` spans, ``descend.record``) are host-clock walls, the
card's queued work falling to the phase whose counted pull waits for
it.
``normalize_request`` is the serve tenant's request check.

``optimize_designs(checkpoint_every=N)`` runs the descent N steps a
segment through ``make_descent``'s ``segment`` (`_segmented_descent`:
bitwise the monolithic descent), pulls the carry by stable names
(`carry_tensors`: x, the masks, the counters and the optimizer's state
whole) once a segment into a ``serve.checkpoint.CheckpointStore``, and
resumes a later call from the newest checkpoint whose identity
(`_ckpt_identity`) and carry layout agree; the ``kill@optimize`` /
``hang@optimize`` seams sit at the segment boundaries.  ``mesh=``
(``parallel/partition.py``, batch axes only) shards each value and
gradient's lanes (`_value_and_grad_sharded`); the carry stays whole.

Not ported here: the compiled-program cache and its per-segment AOT
programs (``exec_cache``, ``_aot_program``: the port compiles nothing,
ROADMAP A9), and a mesh's ``freq`` axis (A9's next item).
"""
from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from raft_tpu_torch import _config, errors
from raft_tpu_torch._config import REAL, as_real
from raft_tpu_torch.obs import tracing, transfers
from raft_tpu_torch.parallel.optimizers import make_optimizer
from raft_tpu_torch.parallel.sweep import unrolled_fixed_point

# ---------------------------------------------------------------------------
# implicit-diff solvers
# ---------------------------------------------------------------------------


def newton_implicit(net_force, X0, iters: int = 20):
    """Statics equilibrium ``net_force(X*) = 0`` with the implicit
    gradient: the forward is ``variants.statics_newton`` (unchanged, run
    without a graph), the gradient one solve with the same regularized
    tangent stiffness at X* and the pullback of ``net_force`` to the
    tensors it closes over.  Runs under ``torch.func.vmap``.  With grad
    enabled the value is X* + (c - c.detach()): X* wherever c is finite,
    so only the differentiable path (``solve.implicit_batched``) calls
    it."""
    from raft_tpu_torch.parallel.variants import statics_newton

    with torch.no_grad():
        X = statics_newton(net_force, X0, iters=iters)
    if not torch.is_grad_enabled():
        return X
    with torch.no_grad():
        # reverse mode, as statics_newton's Jacobian
        K = -torch.func.jacrev(net_force)(X) + 1e-6 * torch.eye(
            X.shape[-1], dtype=X.dtype, device=X.device)
    # solve_ex: no error-info read (a sync on the card); dc/dθ = K^-1 ∂F/∂θ
    c = torch.linalg.solve_ex(K, net_force(X))[0]
    return X + (c - c.detach())


class FixedPoint(torch.autograd.Function):
    """The drag fixed point with the implicit adjoint
    (``raft_tpu/parallel/optimize.py:_fp_core`` / ``_fp_bwd``).

    ``apply(step, rebuild, knobs, Xi0, *tensors)``: ``rebuild(tensors)``
    is the step's state, ``step(state, Xi)`` one drag pass.  The gradient
    reaches the state's tensors (Xi0 gets none, as in JAX).  In PyTorch's
    convention λ is the conjugate of JAX's; the relaxation, the freeze
    and the test are the same.  Sharded: ``Xi0`` a list of per-shard
    tensors, ``step`` a map of such lists, the outputs one tensor per
    shard; the forward and the adjoint iterations each run every shard
    as one (``unrolled_fixed_point`` over lists)."""

    @staticmethod
    def forward(ctx, step, rebuild, knobs, Xi0, *tensors):
        state = rebuild(tensors)
        n, chunk = knobs["nIter"], knobs["chunk"] or knobs["nIter"]
        Xi, _, _, _, chunks = unrolled_fixed_point(
            lambda z: step(state, z), Xi0, n, knobs["tol"], chunk=chunk,
            relax=knobs["relax"], what="implicit_fp_chunk")
        if knobs["record"] is not None:
            knobs["record"]["passes"] = min(chunks * chunk, n)
        ctx.step, ctx.rebuild, ctx.knobs = step, rebuild, knobs
        ctx.sharded = isinstance(Xi0, (list, tuple))
        Xs = list(Xi) if ctx.sharded else [Xi]
        ctx.nshards = len(Xs)
        ctx.save_for_backward(*Xs, *tensors)
        return tuple(Xs) if ctx.sharded else Xi

    @staticmethod
    def backward(ctx, *Xbar):
        saved = ctx.saved_tensors
        Xi, tensors = saved[:ctx.nshards], saved[ctx.nshards:]
        need = ctx.needs_input_grad[4:]
        knobs = ctx.knobs
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(True) for x in Xi]
            leaves = [t.detach().requires_grad_(True) if n else t.detach()
                      for t, n in zip(tensors, need)]
            ys = ctx.step(ctx.rebuild(leaves), xs if ctx.sharded else xs[0])
            ys = list(ys) if ctx.sharded else [ys]

            def pull(lams):
                # one pullback of the step: one adjoint impedance solve
                # (each shard's own: y_i depends on x_i alone)
                gs = torch.autograd.grad(ys, xs, lams, retain_graph=True)
                return [xb + g for xb, g in zip(Xbar, gs)]

            n_adj = knobs["adjoint_iters"]
            chunk = knobs["chunk"] or n_adj
            lam, _, _, _, chunks = unrolled_fixed_point(
                pull, list(Xbar), n_adj, knobs["tol"], chunk=chunk,
                relax=knobs["relax"], what="implicit_adjoint_chunk")
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(ys, wanted, lam,
                                             allow_unused=True)
                         if wanted else ())
        if knobs["record"] is not None:
            knobs["record"]["adjoint_passes"] = min(chunks * chunk, n_adj)
        return (None, None, None, None,
                *[next(grads) if n else None for n in need])


def fixed_point_implicit(step, Xi0, state, nIter: int = 10,
                         tol: float = 0.01, relax: float = 0.8,
                         adjoint_iters: int = None, chunk: int = 2,
                         record: dict = None):
    """Drag-linearization fixed point ``Xi* = step(state, Xi*)`` over the
    leading lane axis of ``Xi0`` with the implicit gradient
    (`FixedPoint`).  ``state`` is a dict (any pytree) of the step's
    θ-dependent inputs: its tensors are the Function's explicit inputs,
    and get the gradient.  ``adjoint_iters`` bounds the adjoint
    iteration (default ``2 * nIter``); ``chunk`` passes run between two
    counted pulls that end a loop early once every lane froze.  A
    ``record`` dict receives ``passes`` (forward) and, after the
    backward, ``adjoint_passes``.  Returns the relaxed iterate (not the
    raw last output, which lands on the exact zeros of symmetric DOFs
    where the drag linearization's gradient is NaN).  Sharded
    (``partition``): ``Xi0`` a list of per-shard seeds, ``state`` a list
    of per-shard states, ``step(states, Xis)`` a list; returns a tuple,
    one iterate per shard."""
    leaves, spec = pytree.tree_flatten(state)
    idx = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]

    def rebuild(tensors):
        out = list(leaves)
        for i, t in zip(idx, tensors):
            out[i] = t
        return pytree.tree_unflatten(out, spec)

    knobs = dict(nIter=int(nIter), tol=float(tol), relax=float(relax),
                 adjoint_iters=int(adjoint_iters) if adjoint_iters
                 else 2 * int(nIter), chunk=int(chunk), record=record)
    return FixedPoint.apply(step, rebuild, knobs, Xi0,
                            *[leaves[i] for i in idx])


# ---------------------------------------------------------------------------
# design spaces: named scalar variables -> variant θ
# ---------------------------------------------------------------------------

def _theta_ballast(base, x):
    return {"rho_fill": [torch.atleast_1d(as_real(m.rho_fill, x.device)) * x
                         for m in base.members]}


def _theta_d_scale(base, x):
    return {"d_scale": torch.ones((len(base.members), 2), dtype=REAL,
                                  device=x.device) * x}


def _theta_moor_L(base, x):
    return {"moor_L": as_real(base.mooring.L, x.device) * x}


def _theta_moor_EA(base, x):
    return {"moor_EA": as_real(base.mooring.EA, x.device) * x}


def _theta_moor_anchor(base, x):
    rA = as_real(base.mooring.rAnchor, x.device)
    return {"moor_rAnchor": rA * torch.stack([x, x, torch.ones_like(x)])}


#: named design variables: each maps a SCALE factor (1.0 = the base
#: design) onto variant-θ entries.  ``ballast`` scales every member's
#: fill density (the solver then runs without the density trim, which
#: would cancel it), ``d_scale`` every member's diameters / side lengths,
#: ``moor_L`` the unstretched line lengths, ``moor_EA`` the axial
#: stiffness, ``moor_anchor`` the anchors' horizontal footprint.
DESIGN_PARAMS = {
    "ballast": _theta_ballast,
    "d_scale": _theta_d_scale,
    "moor_L": _theta_moor_L,
    "moor_EA": _theta_moor_EA,
    "moor_anchor": _theta_moor_anchor,
}


class DesignSpace:
    """Box-bounded design space over :data:`DESIGN_PARAMS` variables.

    ``bounds`` maps variable name -> ``(lo, hi)`` scale factors; the
    sorted names define the layout of the flat design vector x (P,).
    ``lower`` / ``upper`` are float64 numpy arrays."""

    def __init__(self, base, bounds: dict):
        if not bounds:
            raise errors.ModelConfigError("empty design space",
                                          bounds=str(bounds))
        self.base = base
        self.names = sorted(bounds)
        for name in self.names:
            if name not in DESIGN_PARAMS:
                raise errors.ModelConfigError(
                    f"unknown design variable '{name}' "
                    f"(known: {sorted(DESIGN_PARAMS)})", param=name)
            if name.startswith("moor") and base.mooring is None:
                raise errors.ModelConfigError(
                    f"design variable '{name}' needs a moored design",
                    param=name)
        lo = np.array([float(bounds[n][0]) for n in self.names])
        hi = np.array([float(bounds[n][1]) for n in self.names])
        if not np.all(lo < hi) or not np.all(np.isfinite(lo)) \
                or not np.all(np.isfinite(hi)):
            raise errors.ModelConfigError(
                "design bounds must be finite with lo < hi",
                bounds=json.dumps({n: list(map(float, bounds[n]))
                                   for n in self.names}))
        self.lower = lo
        self.upper = hi

    @property
    def ndim(self) -> int:
        return len(self.names)

    def to_theta(self, x) -> dict:
        """Variant θ of ONE flat design vector x (P,) tensor (vmap it over
        a lane axis for a batch)."""
        theta = {}
        for i, name in enumerate(self.names):
            theta.update(DESIGN_PARAMS[name](self.base, x[i]))
        return theta

    def clip(self, x):
        return torch.clamp(x, as_real(self.lower, x.device),
                           as_real(self.upper, x.device))

    def sample(self, nlanes: int, seed: int = 0) -> np.ndarray:
        """(nlanes, P) uniform starts inside the box (host RNG, the JAX
        package's draw)."""
        rng = np.random.default_rng(seed)
        return self.lower + (self.upper - self.lower) * rng.uniform(
            size=(int(nlanes), self.ndim))

    def fingerprint(self) -> dict:
        """JSON-able identity of the space."""
        return {"names": list(self.names),
                "lower": [float(v) for v in self.lower],
                "upper": [float(v) for v in self.upper]}


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

#: objective spec defaults (JSON-able)
DEFAULT_OBJECTIVE = {"metric": "std", "dof": None, "weights": None,
                     "Hs": 6.0, "Tp": 12.0, "beta": 0.0, "sn_m": 4.0}

OBJECTIVE_METRICS = ("std", "offset", "del")


def normalize_objective(spec) -> dict:
    """Validated, canonical objective spec (``ModelConfigError`` on bad
    input) — a copy of the JAX package's."""
    if spec is None:
        spec = {}
    if isinstance(spec, str):
        spec = {"metric": spec}
    if not isinstance(spec, dict):
        raise errors.ModelConfigError("objective spec must be a dict "
                                      "or metric name", spec=str(spec))
    out = dict(DEFAULT_OBJECTIVE)
    unknown = set(spec) - set(out)
    if unknown:
        raise errors.ModelConfigError(
            f"unknown objective keys {sorted(unknown)}",
            keys=",".join(sorted(unknown)))
    out.update(spec)
    if out["metric"] not in OBJECTIVE_METRICS:
        raise errors.ModelConfigError(
            f"unknown objective metric '{out['metric']}' "
            f"(known: {OBJECTIVE_METRICS})", metric=str(out["metric"]))
    if out["dof"] is not None:
        try:
            out["dof"] = int(out["dof"])
        except (TypeError, ValueError) as e:
            raise errors.ModelConfigError(
                "objective dof must be an integer",
                dof=str(out["dof"])) from e
        if not 0 <= out["dof"] < 6:
            raise errors.ModelConfigError("objective dof must be 0..5",
                                          dof=out["dof"])
    for key, lo in (("Hs", 0.0), ("Tp", 0.0), ("beta", None),
                    ("sn_m", 0.0)):
        try:
            out[key] = float(out[key])
        except (TypeError, ValueError) as e:
            raise errors.ModelConfigError(
                f"objective '{key}' must be a number", key=key) from e
        if not np.isfinite(out[key]) or (lo is not None
                                         and out[key] <= lo):
            raise errors.ModelConfigError(
                f"objective '{key}' must be finite"
                + ("" if lo is None else f" and > {lo:g}"), key=key)
    if out["weights"] is not None:
        try:
            wts = [float(v) for v in out["weights"]]
        except (TypeError, ValueError) as e:
            raise errors.ModelConfigError(
                "objective weights must be a list of numbers") from e
        if len(wts) != 6 or not all(np.isfinite(v) for v in wts):
            raise errors.ModelConfigError(
                "objective weights must be 6 finite numbers", n=len(wts))
        out["weights"] = wts
    return out


def _dof_weights(spec, device=None) -> torch.Tensor:
    if spec.get("weights") is not None:
        return torch.tensor(spec["weights"], dtype=REAL, device=device)
    if spec.get("dof") is not None:
        wts = torch.zeros(6, dtype=REAL, device=device)
        wts[int(spec["dof"])] = 1.0
        return wts
    return torch.ones(6, dtype=REAL, device=device)


def _abs2(z):
    """|z|^2 with polynomial gradients (``torch.abs(z)**2`` has a NaN
    gradient at the exact zeros of a symmetric design's responses)."""
    return z.real ** 2 + z.imag ** 2


def _safe_sqrt(s):
    """``sqrt`` whose gradient is 0 (not NaN) at s == 0, NaN-propagating
    (``s * 0`` keeps a NaN) and equal to ``torch.sqrt`` elsewhere."""
    pos = s > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, 1.0)), s * 0.0)


def safe_rms(xi, axis=None):
    """Gradient-safe twin of ``ops.spectra.get_rms``: sqrt(0.5 Σ|xi|²)
    to one ulp, exact at zero, with a zero gradient at an identically
    zero response."""
    a2 = _abs2(xi)
    return _safe_sqrt(0.5 * (torch.sum(a2) if axis is None
                             else torch.sum(a2, dim=axis)))


def del_proxy(Xi, w, sn_m: float = 4.0):
    """Narrow-band damage-equivalent-load proxy per DOF: σ ν^(1/m) with
    ν = sqrt(m2/m0)/2π (``m_k = Σ w^k |Xi|²/2``) and m the S-N slope;
    a zero-response DOF gives exactly 0 with a zero gradient."""
    p2 = 0.5 * _abs2(Xi)
    m0 = torch.sum(p2, dim=-1)
    m2 = torch.sum(w ** 2 * p2, dim=-1)
    pos = m0 > 0.0
    m0s = torch.where(pos, m0, 1.0)
    m2s = torch.where(pos, m2, 1.0)
    nu = torch.sqrt(m2s / m0s) / (2.0 * math.pi)
    return torch.where(pos, torch.sqrt(m0s) * nu ** (1.0 / sn_m), m0 * 0.0)


def make_objective(spec=None):
    """``fn(out, w)`` over a variant solver's output dict: a scalar for
    one variant, (lanes,) for a lane batch.  ``spec["metric"]``: ``std``
    (DOF-weighted response std), ``offset`` (mean horizontal offset),
    ``del`` (DOF-weighted DEL proxy).  Returns ``(fn, canonical_spec)``."""
    spec = normalize_objective(spec)

    def fn(out, w):
        if spec["metric"] == "offset":
            # hypot has a NaN gradient at the exact origin: the safe sqrt
            Xeq = out["Xeq"]
            return _safe_sqrt(Xeq[..., 0] ** 2 + Xeq[..., 1] ** 2)
        wts = _dof_weights(spec, w.device)
        if spec["metric"] == "del":
            return torch.sum(wts * del_proxy(out["Xi"], w,
                                             float(spec["sn_m"])), dim=-1)
        return torch.sum(wts * safe_rms(out["Xi"], axis=-1), dim=-1)

    return fn, spec


def make_design_objective(base, space: DesignSpace, objective=None,
                          nIter: int = 10, tol: float = 0.01,
                          newton_iters: int = 20, mesh=None, **solver_kw):
    """``obj(x)`` -> scalar tensor for one flat design vector (P,) and
    ``obj.batched(X)`` -> (lanes,) for X (lanes, P), through the
    implicit-diff pipeline on the base model's device, differentiable in
    x; ``obj.spec`` is the canonical objective, ``obj.solver`` the
    variant solver.  A ``ballast`` design variable runs the solver
    without the density trim, as in the JAX package.  With ``mesh``
    (batch axes only), ``obj.sharded(xs)`` takes one X block per shard
    this process runs (on its device, in lane order) and returns their
    values, through ONE implicit fixed point over every shard."""
    from raft_tpu_torch.parallel.variants import make_variant_solver

    fn, spec = make_objective(objective)
    solver = make_variant_solver(
        base, Hs=float(spec["Hs"]), Tp=float(spec["Tp"]),
        beta=float(spec["beta"]), ballast="ballast" not in space.names,
        nIter=int(nIter), tol=float(tol), newton_iters=int(newton_iters),
        implicit_diff=True, mesh=mesh, **solver_kw)
    w = as_real(base.w, base.device)
    to_thetas = torch.func.vmap(space.to_theta)

    def obj(x):
        return fn(solver.implicit(space.to_theta(x)), w)

    def batched(X):
        return fn(solver.implicit_batched(to_thetas(X)), w)

    def sharded(xs):
        outs = solver.implicit_sharded([to_thetas(x) for x in xs])
        return [fn(o, as_real(base.w, x.device)) for o, x in zip(outs, xs)]

    obj.batched = batched
    obj.sharded = sharded
    obj.mesh = mesh
    obj.spec = spec
    obj.solver = solver
    return obj


def _finite_lane(v, g):
    """Per-lane mask: a finite value and a finite gradient."""
    return torch.isfinite(v) & torch.all(torch.isfinite(g), dim=-1)


def value_and_grad(obj, X, record: dict = None):
    """Values (lanes,) and gradients (lanes, P) of ``obj.batched`` at X
    (lanes, P) on the objective's device, detached, with no host pull or
    wait of its own (the fixed points' counted chunk pulls are the only
    ones).  A ``record`` dict counts the call (``gradients``) and adds its
    fixed point's ``passes`` and ``adjoint_passes`` and its host-clock
    walls (``setup_s``, ``fixed_point_s`` from the solver,
    ``backward_s``)."""
    dev = obj.solver.device
    if getattr(obj, "mesh", None) is not None:
        v, g, t0 = _value_and_grad_sharded(obj, as_real(X, dev))
    else:
        x = as_real(X, dev).detach().requires_grad_(True)
        with torch.enable_grad():
            v = obj.batched(x)
            t0 = time.perf_counter()
            g, = torch.autograd.grad(torch.sum(v), x)
    if record is not None:
        tm, fp = obj.solver.timings, obj.solver.fixed_point
        for key, val in (("gradients", 1), ("passes", fp["passes"]),
                         ("adjoint_passes", fp["adjoint_passes"]),
                         ("setup_s", tm["setup"]),
                         ("fixed_point_s", tm["fixed_point"]),
                         ("backward_s", time.perf_counter() - t0)):
            record[key] = record.get(key, 0) + val
    return v.detach(), g.detach()


def _value_and_grad_sharded(obj, X):
    """`value_and_grad` over ``obj.mesh``: X's lanes split into one block
    per shard (``partition.shard_tree``), each shard's values and its
    block's gradient taken locally (the forward and the adjoint fixed
    points each ONE iteration over every shard), then both gathered on
    X's device in lane order (across processes by ``all_gather``).
    Returns (values, gradients, the backward's start time)."""
    from raft_tpu_torch.parallel import partition

    mesh = obj.mesh
    with partition.spmd(mesh):
        parts = partition.shard_tree({"x": X.detach()}, mesh,
                                     partition.VARIANT_INPUT_RULES)
        xs = [p["x"].detach().requires_grad_(True) for p in parts]
        with torch.enable_grad():
            vs = obj.sharded(xs)
            t0 = time.perf_counter()
            gs = torch.autograd.grad([torch.sum(v) for v in vs], xs)
        out = partition.gather_tree(
            [{"v": v.detach(), "g": g} for v, g in zip(vs, gs)], mesh,
            X.device)
    return out["v"], out["g"], t0


def grad_guarded(obj):
    """Value and gradient of ``obj`` (from `make_design_objective`) at x
    on the objective's device, with the finiteness check the JAX
    package's ``grad_guarded`` makes (one counted pull).

    x (P,): returns (value, gradient); a non-finite value or gradient
    raises ``NonFiniteResult`` with ``phase == "adjoint"``.  X (lanes, P):
    returns (values (lanes,), gradients (lanes, P), finite (lanes,) bool
    numpy): the lanes are independent, so a poisoned lane marks itself
    and leaves every other lane's gradient as it is."""
    def wrapped(x):
        batch = len(getattr(x, "shape", np.shape(x))) == 2
        v, g = value_and_grad(obj, x if batch else as_real(x)[None])
        vh, fin = transfers.device_get((v, _finite_lane(v, g)),
                                       what="adjoint_finite")
        if batch:
            return v, g, np.asarray(fin, bool)
        if not bool(fin[0]):
            err = errors.NonFiniteResult(
                "non-finite objective/adjoint gradient", value=float(vh[0]))
            err.phase = "adjoint"
            raise err
        return v[0], g[0]

    return wrapped


# ---------------------------------------------------------------------------
# serve-tenant request specs
# ---------------------------------------------------------------------------

#: knobs an ``optimize`` serve request may carry (all JSON scalars plus
#: the bounds/objective dicts); everything else is a typed reject
OPTIMIZE_REQUEST_DEFAULTS = {
    "bounds": None, "objective": None, "nlanes": 32, "steps": 30,
    "method": "adam", "lr": 0.02, "gtol": 1e-4, "seed": 0,
    "nIter": 10, "tol": 0.01,
}


def normalize_request(spec, lanes_max: int = None,
                      steps_max: int = None) -> dict:
    """Validated canonical form of an ``optimize`` serve-request spec (a
    copy of the JAX package's): sorted keys, defaults filled, so two
    requests for the same optimization share one content address.  Bad
    input is a typed :class:`errors.ModelConfigError`; ``lanes_max`` /
    ``steps_max`` are the service's resource guards."""
    if not isinstance(spec, dict):
        raise errors.ModelConfigError(
            "optimize request spec must be a JSON object",
            spec=str(type(spec).__name__))
    unknown = set(spec) - set(OPTIMIZE_REQUEST_DEFAULTS)
    if unknown:
        raise errors.ModelConfigError(
            f"unknown optimize request keys {sorted(unknown)}",
            keys=",".join(sorted(unknown)))
    out = dict(OPTIMIZE_REQUEST_DEFAULTS)
    out.update(spec)
    bounds = out["bounds"]
    if not isinstance(bounds, dict) or not bounds:
        raise errors.ModelConfigError(
            "optimize request needs non-empty 'bounds' "
            "{design_var: [lo, hi]}", bounds=str(bounds))
    canon_bounds = {}
    for name, pair in bounds.items():
        if name not in DESIGN_PARAMS:
            raise errors.ModelConfigError(
                f"unknown design variable '{name}' "
                f"(known: {sorted(DESIGN_PARAMS)})", param=str(name))
        try:
            lo, hi = float(pair[0]), float(pair[1])
        except (TypeError, ValueError, IndexError) as e:
            raise errors.ModelConfigError(
                f"bounds for '{name}' must be [lo, hi]",
                param=str(name)) from e
        if not (np.isfinite(lo) and np.isfinite(hi) and lo < hi):
            raise errors.ModelConfigError(
                f"bounds for '{name}' must be finite with lo < hi",
                param=str(name), lo=lo, hi=hi)
        canon_bounds[str(name)] = [lo, hi]
    out["bounds"] = {k: canon_bounds[k] for k in sorted(canon_bounds)}
    out["objective"] = normalize_objective(out["objective"])
    if str(out["method"]) not in ("adam", "lbfgs"):
        raise errors.ModelConfigError(
            f"unknown optimize method '{out['method']}' (adam|lbfgs)",
            method=str(out["method"]))
    # nIter is capped: the fixed point runs nIter forward and 2 nIter
    # adjoint passes, the request's cost knob
    for key, lo, hi in (("nlanes", 1, None), ("steps", 1, None),
                        ("nIter", 1, 200), ("seed", 0, None)):
        try:
            out[key] = int(out[key])
        except (TypeError, ValueError) as e:
            raise errors.ModelConfigError(
                f"optimize request '{key}' must be an integer",
                key=key) from e
        if out[key] < lo or (hi is not None and out[key] > hi):
            raise errors.ModelConfigError(
                f"optimize request '{key}' must be in "
                f"[{lo}, {hi if hi is not None else 'inf'}]", key=key)
    for key in ("lr", "gtol", "tol"):
        try:
            out[key] = float(out[key])
        except (TypeError, ValueError) as e:
            raise errors.ModelConfigError(
                f"optimize request '{key}' must be a number",
                key=key) from e
        if not (np.isfinite(out[key]) and out[key] > 0):
            raise errors.ModelConfigError(
                f"optimize request '{key}' must be finite and > 0",
                key=key)
    if lanes_max is not None and out["nlanes"] > int(lanes_max):
        raise errors.ModelConfigError(
            f"optimize request nlanes {out['nlanes']} exceeds the "
            f"service bound {lanes_max}", nlanes=out["nlanes"],
            bound=int(lanes_max))
    if steps_max is not None and out["steps"] > int(steps_max):
        raise errors.ModelConfigError(
            f"optimize request steps {out['steps']} exceeds the "
            f"service bound {steps_max}", steps=out["steps"],
            bound=int(steps_max))
    return {k: out[k] for k in sorted(out)}


# ---------------------------------------------------------------------------
# the batched descent
# ---------------------------------------------------------------------------

def make_descent(base, space: DesignSpace, objective=None,
                 method: str = "adam", steps: int = 40, lr: float = 0.02,
                 gtol: float = 1e-4, xtol: float = 0.0, mesh=None,
                 **obj_kw):
    """``descend(X0 (L, P)) -> result dict``: L independent box-projected
    descents with per-lane convergence masks, as the JAX package's
    ``make_descent``.  A lane whose value or gradient goes non-finite is
    FROZEN at its last iterate (x and every optimizer state leaf) and
    counted; the others go on.  All ``steps`` run whatever the masks say.

    ``descend.init_carry(X0)`` -> carry (x, optimizer state, done, bad,
    iters); ``descend.segment(carry, n)`` -> (carry, (obj_trace,
    gnorm_trace)), n steps (chained segments are the whole descent);
    ``descend.finalize(carry, obj_trace, gnorm_trace)`` -> the result;
    ``descend.objective_spec``, ``descend.space``; ``descend.record``
    counts the steps, the gradients taken (linesearch trials included),
    the linesearch trials, the fixed points' passes and their walls
    (`value_and_grad`).  Each step runs in a ``descent_step`` span and
    ``finalize`` in a ``descent_finalize`` span, each with its share of
    the record as attributes.  ``mesh``: each value and gradient of the
    lane batch shards its lanes (`value_and_grad`); the carry and the
    optimizer stay whole on the base model's device."""
    obj = make_design_objective(base, space, objective, mesh=mesh, **obj_kw)
    opt = make_optimizer(method, lr)
    dev = obj.solver.device
    steps = int(steps)
    record = {"steps": 0, "gradients": 0, "linesearch_trials": 0}

    @contextlib.contextmanager
    def spanned(name):
        """A span holding the record's growth inside it."""
        before = dict(record)
        with tracing.span(name, method=method, step=record["steps"]) as sp:
            yield
            sp.set(**{k: v - before.get(k, 0) for k, v in record.items()})

    def vg(X):
        return value_and_grad(obj, X, record)

    def ls_vg(X):
        record["linesearch_trials"] += 1
        return vg(X)

    def init_carry(X0):
        X0 = as_real(X0, dev)
        L = X0.shape[0]
        return (X0, opt.init(X0), torch.zeros(L, dtype=torch.bool,
                                               device=dev),
                torch.zeros(L, dtype=torch.bool, device=dev),
                torch.zeros(L, dtype=torch.int32, device=dev))

    def step(carry):
        x, state, done, bad, iters = carry
        v, g = vg(x)
        finite = _finite_lane(v, g)
        bad_now = bad | (~finite & ~done)
        frozen = done | bad_now
        g_safe = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
        v_safe = torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
        upd, new = opt.update(g_safe, state, x, value=v_safe,
                              value_and_grad_fn=ls_vg, frozen=frozen)
        x_new = space.clip(x + upd)
        x_new = torch.where(frozen[:, None], x, x_new)
        new = {k: torch.where(frozen.reshape((-1,) + (1,) * (a.ndim - 1)),
                              state[k], a) for k, a in new.items()}
        gnorm = torch.amax(torch.abs(g_safe), dim=-1)
        moved = torch.amax(torch.abs(x_new - x), dim=-1)
        conv = finite & ((gnorm <= gtol) | ((moved <= xtol) & (xtol > 0.0)))
        iters = iters + (~frozen).to(torch.int32)
        return (x_new, new, done | conv, bad_now, iters), (v, gnorm)

    def segment(carry, seg_len):
        """``seg_len`` descent steps from ``carry``."""
        vs, gs = [], []
        for _ in range(int(seg_len)):
            with spanned("descent_step"):
                carry, (v, gnorm) = step(carry)
                record["steps"] += 1
            vs.append(v)
            gs.append(gnorm)
        return carry, (torch.stack(vs), torch.stack(gs))

    def finalize(carry, obj_trace, gnorm_trace):
        x, _, done, bad, iters = carry
        with spanned("descent_finalize"):
            v_fin, g_fin = vg(x)
        # jnp.nan_to_num(g, nan=inf): NaN -> inf -> the largest float
        g_num = torch.nan_to_num(torch.where(torch.isnan(g_fin), math.inf,
                                             g_fin))
        return {"x": x, "objective": v_fin,
                "grad_norm": torch.amax(torch.abs(g_num), dim=-1),
                "converged": done & ~bad, "nonfinite": bad, "iters": iters,
                "obj_trace": obj_trace, "gnorm_trace": gnorm_trace}

    def descend(X0):
        carry, (obj_trace, gnorm_trace) = segment(init_carry(X0), steps)
        return finalize(carry, obj_trace, gnorm_trace)

    descend.objective_spec = obj.spec
    descend.space = space
    descend.init_carry = init_carry
    descend.segment = segment
    descend.finalize = finalize
    descend.record = record
    return descend


# ---------------------------------------------------------------------------
# the segmented, checkpointed and resumable descent
# ---------------------------------------------------------------------------

def _ckpt_identity(base, space, spec, method, steps, lr, gtol, xtol,
                   nlanes, every, obj_kw=None) -> str:
    """Content identity of one checkpointable descent — what a resume
    must agree on before trusting a persisted carry: the base model's
    digest, the space, the objective, the method and its knobs, the lane
    count, the segment length and every scalar solver keyword (the carry
    layout alone cannot tell ``nIter`` or ``tol`` apart).  A checkpoint
    of another spec is ignored (a fresh start), never mis-resumed."""
    from raft_tpu_torch.ledger import digest_metrics
    from raft_tpu_torch.parallel import exec_cache

    return digest_metrics({
        "model": exec_cache.model_digest(base),
        "space": json.dumps(space.fingerprint(), sort_keys=True),
        "objective": json.dumps(spec, sort_keys=True),
        "method": str(method), "steps": int(steps), "lr": float(lr),
        "gtol": float(gtol), "xtol": float(xtol),
        "nlanes": int(nlanes), "every": int(every),
        "kw": json.dumps({k: v for k, v in (obj_kw or {}).items()
                          if isinstance(v, (int, float, str, bool))},
                         sort_keys=True)})


def carry_tensors(carry) -> dict:
    """``make_descent``'s carry by stable name: ``x``, ``done``, ``bad``,
    ``iters`` and ``state/<key>`` for every tensor of the optimizer's
    state (L-BFGS's memory, step size and counters whole)."""
    x, state, done, bad, iters = carry
    out = {"x": x, "done": done, "bad": bad, "iters": iters}
    out.update({f"state/{k}": v for k, v in state.items()})
    return out


def carry_layout(carry) -> dict:
    """name -> [shape, dtype] of `carry_tensors` (what a resume checks)."""
    return {k: [list(v.shape), str(v.dtype)]
            for k, v in carry_tensors(carry).items()}


def carry_from(arrays: dict, like):
    """The carry of the host ``arrays`` (`carry_tensors`' names, under
    ``c/``), every leaf at the dtype and on the device of ``like``'s."""
    x, state, done, bad, iters = like

    def get(name, t):
        return _config.to_device(arrays[f"c/{name}"], t.device, t.dtype)

    return (get("x", x), {k: get(f"state/{k}", v) for k, v in state.items()},
            get("done", done), get("bad", bad), get("iters", iters))


def _resume(store, key, steps, identity, layout, nlanes, like):
    """(carry, obj_trace parts, gnorm_trace parts, step) of the newest
    valid checkpoint of ``key`` whose identity and carry layout agree,
    or None.  A corrupt checkpoint the store dropped falls back one
    segment; one that disagrees is a ``ckpt_resume_rejected`` event."""
    from raft_tpu_torch import obs

    found = store.latest(key, max_step=steps)
    if found is None:
        return None
    step0, arrays, meta = found
    ok = (meta.get("identity") == identity
          and meta.get("carry") == layout
          and all(f"c/{k}" in arrays for k in layout)
          and tuple(np.shape(arrays.get("obj_trace")))
          == (int(step0), int(nlanes))
          and tuple(np.shape(arrays.get("gnorm_trace")))
          == (int(step0), int(nlanes)))
    if not ok:
        obs.events.emit("ckpt_resume_rejected", step=int(step0),
                        key=str(key)[:24])
        return None
    dev = like[0].device
    carry = carry_from(arrays, like)
    ot = _config.to_device(arrays["obj_trace"], dev, REAL)
    gt = _config.to_device(arrays["gnorm_trace"], dev, REAL)
    obs.counter("raft_tpu_checkpoint_resumes_total",
                "descents resumed from a persisted checkpoint instead of "
                "step 0").inc(1.0)
    obs.events.emit("ckpt_resume", step=int(step0), steps=int(steps),
                    key=str(key)[:24])
    return carry, [ot], [gt], int(step0)


def _segmented_descent(descend, x0, *, every: int, steps: int,
                       ckpt_store=None, ckpt_key: str = None,
                       on_checkpoint=None, identity: str = None,
                       resume_only: bool = False):
    """The chunked outer loop around `make_descent`'s ``segment``:
    ``every`` steps a segment (``descend.segment(carry, seg_len)``; the
    chained segments are the monolithic descent step for step, so the
    result is bitwise the same), the carry and the traces so far pulled
    once a segment (``optimize_checkpoint``, phase ``optimize``) and put
    in ``ckpt_store`` under ``ckpt_key`` (``on_checkpoint(step,
    cdigest)`` after each), a resume from the newest valid checkpoint,
    the ``kill@optimize:step=N`` / ``hang@optimize:step=N`` seams at every
    segment boundary (a hang parks after step N's checkpoint is durable)
    and the ``StorageExhausted`` shed (checkpointing stops; the descent
    keeps its progress on the device).  ``resume_only`` reads a
    checkpoint but writes none.

    Returns ``(out, ckpt_info)``: ``descend.finalize``'s result over the
    whole traces, and the facts ``checkpoint_every``,
    ``resumed_from_step``, ``segments``, ``ckpt_writes``, ``ckpt_shed``,
    ``ckpt_resume_only``."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.testing import faults

    L = int(x0.shape[0])
    carry = descend.init_carry(x0)
    layout = carry_layout(carry)
    resumed_from, ot_parts, gt_parts = 0, [], []
    if ckpt_store is not None and ckpt_key:
        got = _resume(ckpt_store, ckpt_key, steps, identity, layout, L,
                      carry)
        if got is not None:
            carry, ot_parts, gt_parts, resumed_from = got
    shed = False
    writes = 0
    done_steps = resumed_from
    nseg = 0
    log = logging.getLogger("raft_tpu_torch.optimize")
    while done_steps < steps:
        # the preemption seams, at the boundary whose cumulative step
        # count is N
        f = faults.fire_info("optimize", step=done_steps)
        if f is not None and f["action"] == "kill":
            log.warning("optimize: injected kill at step %d (os._exit)",
                        done_steps)
            os._exit(137)
        if f is not None and f["action"] == "hang":
            log.warning("optimize: injected hang at step %d (%.1fs)",
                        done_steps, f.get("hang_s", 30.0))
            time.sleep(float(f.get("hang_s", 30.0)))
        seg_len = min(int(every), int(steps) - done_steps)
        carry, (ot, gt) = descend.segment(carry, seg_len)
        done_steps += seg_len
        nseg += 1
        ot_parts.append(ot)
        gt_parts.append(gt)
        if ckpt_store is not None and ckpt_key and not shed \
                and not resume_only and done_steps < steps:
            # ONE counted pull a segment: the carry and the traces so far
            host = transfers.device_get(
                (carry_tensors(carry), torch.cat(ot_parts),
                 torch.cat(gt_parts)),
                what="optimize_checkpoint", phase="optimize")
            arrays = {f"c/{k}": v for k, v in host[0].items()}
            arrays["obj_trace"], arrays["gnorm_trace"] = host[1], host[2]
            try:
                cd = ckpt_store.put(
                    ckpt_key, done_steps, arrays,
                    meta={"identity": identity, "carry": layout,
                          "steps": int(steps), "every": int(every),
                          "nlanes": L})
                if cd:
                    writes += 1
                    if on_checkpoint is not None:
                        on_checkpoint(done_steps, cd)
            except errors.StorageExhausted as e:
                # checkpointing sheds first: the descent keeps its
                # progress on the device, its durability degrades
                shed = True
                obs.events.emit("storage_degraded", component="checkpoint",
                                step=done_steps, error=str(e)[:200])
    out = descend.finalize(carry, torch.cat(ot_parts), torch.cat(gt_parts))
    return out, {"checkpoint_every": int(every),
                 "resumed_from_step": resumed_from, "segments": nseg,
                 "ckpt_writes": writes, "ckpt_shed": shed,
                 "ckpt_resume_only": bool(resume_only)}


def optimize_designs(base, space: DesignSpace, objective=None,
                     x0=None, nlanes: int = 64, method: str = "adam",
                     steps: int = 40, lr: float = 0.02,
                     gtol: float = 1e-4, xtol: float = 0.0,
                     mesh=None, seed: int = 0, strict: bool = True,
                     checkpoint_every: int = None, ckpt_store=None,
                     ckpt_key: str = None, on_checkpoint=None,
                     ckpt_resume_only: bool = False,
                     **obj_kw) -> dict:
    """Run ``nlanes`` simultaneous projected descents over ``space`` (the
    JAX package's ``optimize_designs`` without its compiled-program
    cache).

    Returns per-lane results (``x``, ``objective``, ``grad_norm``,
    ``converged``, ``nonfinite``, ``iters``, ``obj_trace``), the best
    lane (``x_best`` / ``f_best`` / ``lane_best``, ``design``: named
    scale factors) and ``provenance``; a run manifest of kind
    ``optimize`` records the facts.  ``x0=None`` samples
    ``space.sample(nlanes, seed)``.  ``strict=True`` raises
    ``NonFiniteResult`` (``phase="adjoint"``) when EVERY lane's gradient
    went non-finite; no lane ending finite raises ``NonFiniteResult``.

    ``mesh`` (batch axes only; a ``freq`` axis raises
    ``PartitionRuleError``): the lanes are padded to the mesh's batch
    size (copies of the last lane), each value and gradient shards them
    over the mesh's devices, and the padding is stripped from the result;
    ``provenance["mesh"]`` holds the topology.

    Preemption tolerance: ``checkpoint_every=N`` runs the descent N steps
    a segment (bitwise the monolithic descent); with ``ckpt_store`` (a
    ``serve.checkpoint.CheckpointStore``) and ``ckpt_key`` the carry is
    pulled once a segment and persisted, a later call with the same key
    and spec resumes from the newest valid checkpoint
    (``result["resumed_from_step"]``; a corrupt one falls back one
    segment, another spec's is ignored), an ENOSPC write sheds
    checkpointing without losing progress, and ``on_checkpoint(step,
    cdigest)`` is called after each persisted segment.
    ``ckpt_resume_only`` resumes but writes nothing.  The checkpoints of
    a finished descent are deleted."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.ops import linalg as _linalg
    from raft_tpu_torch.parallel import partition

    partition.require_batch_only(mesh, "optimize_designs")
    descend = make_descent(base, space, objective, method=method,
                           steps=steps, lr=lr, gtol=gtol, xtol=xtol,
                           mesh=mesh, **obj_kw)
    spec = descend.objective_spec
    if x0 is None:
        x0 = space.sample(nlanes, seed=seed)
    x0 = as_real(x0, base.device)
    nlanes = int(x0.shape[0])
    npad = 0
    if mesh is not None:
        x0, npad = partition.pad_batch(x0, nlanes, partition.batch_size(mesh))
    mesh_info = partition.mesh_facts(mesh)
    manifest = obs.RunManifest.begin(kind="optimize", config={
        "nlanes": nlanes, "ndim": space.ndim, "steps": int(steps),
        "method": method, "objective": spec["metric"], "mesh": mesh_info,
        "names": ",".join(space.names)})
    obs.record_build_info(run_id=manifest.run_id)
    status = "failed"
    try:
        with obs.span("optimize_designs", nlanes=nlanes,
                      method=method) as sp:
            cache_info = {"state": "disabled"}
            sp.set(exec_cache=cache_info["state"])
            if mesh_info is not None:
                sp.set(mesh=mesh_info["topology"])
            every = int(checkpoint_every or 0)
            ckpt_info = None
            t0 = time.perf_counter()
            with obs.span("optimize_execute"):
                if every > 0:
                    identity = _ckpt_identity(
                        base, space, spec, method, steps, lr, gtol, xtol,
                        int(x0.shape[0]), every, obj_kw)
                    out, ckpt_info = _segmented_descent(
                        descend, x0, every=every, steps=int(steps),
                        ckpt_store=ckpt_store, ckpt_key=ckpt_key,
                        on_checkpoint=on_checkpoint, identity=identity,
                        resume_only=bool(ckpt_resume_only))
                    sp.set(resumed_from_step=ckpt_info["resumed_from_step"])
                else:
                    out = descend(x0)
            if npad:
                # the padded lanes are a placement detail, never a result
                out = {k: v[:, :nlanes] if k in ("obj_trace", "gnorm_trace")
                       else v[:nlanes] for k, v in out.items()}
            # one host pull for the descent summary
            res = transfers.device_get(
                (out["x"], out["objective"], out["grad_norm"],
                 out["converged"], out["nonfinite"], out["iters"],
                 out["obj_trace"]),
                what="optimize_summary", phase="optimize")
            wall_s = time.perf_counter() - t0
            x, fval, gnorm, conv, bad, iters, obj_trace = \
                [np.asarray(a) for a in res]
            n_bad = int(bad.sum())
            if n_bad:
                obs.counter(
                    "raft_tpu_optimize_grad_nonfinite_total",
                    "descent lanes whose adjoint gradient went "
                    "non-finite (frozen, never stalling the batch)",
                    ).inc(n_bad)
            if strict and n_bad == nlanes:
                err = errors.NonFiniteResult(
                    "every descent lane produced a non-finite adjoint "
                    "gradient", lanes=nlanes)
                err.phase = "adjoint"
                raise err
            ok = ~bad & np.isfinite(fval)
            if not ok.any():
                raise errors.NonFiniteResult(
                    "no descent lane finished with a finite objective",
                    lanes=nlanes)
            best = int(np.flatnonzero(ok)[np.argmin(fval[ok])])
            result = {
                "x": x, "objective": fval, "grad_norm": gnorm,
                "converged": conv, "nonfinite": bad, "iters": iters,
                "obj_trace": obj_trace,
                "x_best": x[best], "f_best": float(fval[best]),
                "lane_best": best,
                "design": {n: float(x[best][i])
                           for i, n in enumerate(space.names)},
                "provenance": {
                    "method": method, "steps": int(steps),
                    "lr": float(lr), "gtol": float(gtol),
                    "nlanes": nlanes, "ndim": space.ndim,
                    "objective": spec,
                    "space": space.fingerprint(),
                    "iterations": int(iters.max(initial=0)),
                    "grad_norm_best": float(gnorm[best]),
                    "grad_nonfinite": n_bad,
                    "converged": int(conv.sum()),
                    "wall_s": wall_s,
                    "solver": _linalg.last_dispatch(),
                    "exec_cache": cache_info["state"]},
            }
            if mesh_info is not None:
                result["provenance"]["mesh"] = mesh_info
            if ckpt_info is not None:
                # the resume point, the segment census and whether the
                # checkpoints shed, journaled with the result
                result["resumed_from_step"] = ckpt_info["resumed_from_step"]
                result["provenance"].update(ckpt_info)
                if ckpt_store is not None and ckpt_key:
                    # done: its progress checkpoints are garbage
                    ckpt_store.delete(ckpt_key)
            sp.set(best=result["f_best"], converged=int(conv.sum()),
                   nonfinite=n_bad)
            if _config.health_enabled():
                # health mode repackages the pulled summary: the
                # descent's "residual" is its gradient norm, the
                # non-finite count the frozen lanes
                gn_fin = gnorm[np.isfinite(gnorm)]
                gn_max = float(gn_fin.max()) if gn_fin.size else 0.0
                gn_med = float(np.median(gn_fin)) if gn_fin.size else 0.0
                health_info = {
                    "residual_rel_max": gn_max,
                    "residual_rel_median": gn_med,
                    "nonfinite_lanes": n_bad,
                    "iters_max": int(iters.max(initial=0)),
                    "lanes": nlanes,
                    "worst_lane": (int(np.flatnonzero(bad)[0]) if n_bad
                                   else int(np.argmax(np.where(
                                       np.isfinite(gnorm), gnorm,
                                       -np.inf))))}
                obs.record_solve_health(
                    "optimize", gn_max, gn_med, n_bad,
                    iters_max=health_info["iters_max"])
                obs.events.emit(
                    "solve_health", phase="optimize",
                    worst_lane=health_info["worst_lane"],
                    residual_rel_max=gn_max, nonfinite_lanes=n_bad)
                result["provenance"]["solve_health"] = health_info
                manifest.extra["solve_health"] = health_info
                sp.set(health_nonfinite=n_bad)
            obs.gauge(
                "raft_tpu_optimize_lanes",
                "descent lanes of the most recent batched design "
                "optimization").set(nlanes, method=method)
            obs.gauge(
                "raft_tpu_optimize_converged_lanes",
                "lanes whose projected descent met the gradient "
                "tolerance").set(int(conv.sum()), method=method)
            manifest.extra["exec_cache"] = cache_info
            manifest.extra["optimize"] = {
                "nlanes": nlanes, "steps": int(steps),
                "method": method,
                "converged": int(conv.sum()),
                "grad_nonfinite": n_bad,
                "grad_nonfinite_ratio": n_bad / max(1, nlanes),
                "f_best": result["f_best"],
                "iters_max": int(iters.max(initial=0)),
                "wall_s": wall_s,
                "descents_per_min": 60.0 * nlanes / max(wall_s, 1e-9),
                "exec_cache": cache_info["state"],
                **({k: int(ckpt_info[k]) for k in
                    ("checkpoint_every", "resumed_from_step", "segments",
                     "ckpt_writes", "ckpt_shed")}
                   if ckpt_info is not None else {})}
            if mesh_info is not None:
                manifest.extra["partition"] = {
                    "mesh": mesh_info, "npad": npad,
                    "rules": partition.rules_fingerprint(
                        partition.VARIANT_INPUT_RULES)}
            status = "ok"
            return result
    finally:
        obs.finish_run(manifest, status=status, write_trace=False)
