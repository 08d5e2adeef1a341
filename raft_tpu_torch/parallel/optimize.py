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

Not ported here (ROADMAP A9): the segmented and checkpointed descent
(``checkpoint_every``, ``ckpt_store``, ...), ``partition`` (``mesh=``),
and the compiled-program cache (``exec_cache``: the port compiles
nothing); ``optimize_designs`` refuses ``mesh`` and the checkpoint
arguments with a typed error.
"""
from __future__ import annotations

import contextlib
import json
import math
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
    and the test are the same."""

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
        ctx.save_for_backward(Xi, *tensors)
        return Xi

    @staticmethod
    def backward(ctx, Xbar):
        Xi, *tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        knobs = ctx.knobs
        with torch.enable_grad():
            x = Xi.detach().requires_grad_(True)
            leaves = [t.detach().requires_grad_(True) if n else t.detach()
                      for t, n in zip(tensors, need)]
            y = ctx.step(ctx.rebuild(leaves), x)

            def pull(lam):
                # one pullback of the step: one adjoint impedance solve
                return Xbar + torch.autograd.grad(y, x, lam,
                                                  retain_graph=True)[0]

            n_adj = knobs["adjoint_iters"]
            chunk = knobs["chunk"] or n_adj
            lam, _, _, _, chunks = unrolled_fixed_point(
                pull, Xbar, n_adj, knobs["tol"], chunk=chunk,
                relax=knobs["relax"], what="implicit_adjoint_chunk")
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, lam,
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
    where the drag linearization's gradient is NaN)."""
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
                          newton_iters: int = 20, **solver_kw):
    """``obj(x)`` -> scalar tensor for one flat design vector (P,) and
    ``obj.batched(X)`` -> (lanes,) for X (lanes, P), through the
    implicit-diff pipeline on the base model's device, differentiable in
    x; ``obj.spec`` is the canonical objective, ``obj.solver`` the
    variant solver.  A ``ballast`` design variable runs the solver
    without the density trim, as in the JAX package."""
    from raft_tpu_torch.parallel.variants import make_variant_solver

    fn, spec = make_objective(objective)
    solver = make_variant_solver(
        base, Hs=float(spec["Hs"]), Tp=float(spec["Tp"]),
        beta=float(spec["beta"]), ballast="ballast" not in space.names,
        nIter=int(nIter), tol=float(tol), newton_iters=int(newton_iters),
        implicit_diff=True, **solver_kw)
    w = as_real(base.w, base.device)
    to_thetas = torch.func.vmap(space.to_theta)

    def obj(x):
        return fn(solver.implicit(space.to_theta(x)), w)

    def batched(X):
        return fn(solver.implicit_batched(to_thetas(X)), w)

    obj.batched = batched
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
                 gtol: float = 1e-4, xtol: float = 0.0, **obj_kw):
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
    the record as attributes."""
    obj = make_design_objective(base, space, objective, **obj_kw)
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


#: optimize_designs arguments of the JAX package the port does not take yet
_NOT_PORTED = ("mesh", "checkpoint_every", "ckpt_store", "ckpt_key",
               "on_checkpoint", "ckpt_resume_only")


def optimize_designs(base, space: DesignSpace, objective=None,
                     x0=None, nlanes: int = 64, method: str = "adam",
                     steps: int = 40, lr: float = 0.02,
                     gtol: float = 1e-4, xtol: float = 0.0,
                     seed: int = 0, strict: bool = True,
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

    ``mesh=`` and the checkpoint arguments (``checkpoint_every``,
    ``ckpt_store``, ``ckpt_key``, ``on_checkpoint``,
    ``ckpt_resume_only``) raise ``ModelConfigError``: not ported yet
    (ROADMAP A9)."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.ops import linalg as _linalg

    refused = sorted(k for k in _NOT_PORTED
                     if obj_kw.get(k) not in (None, False))
    if refused:
        raise errors.ModelConfigError(
            f"optimize_designs: {', '.join(refused)} not ported yet "
            "(ROADMAP A9: the segmented and checkpointed descent, "
            "partition)", args=",".join(refused))
    obj_kw = {k: v for k, v in obj_kw.items() if k not in _NOT_PORTED}
    descend = make_descent(base, space, objective, method=method,
                           steps=steps, lr=lr, gtol=gtol, xtol=xtol,
                           **obj_kw)
    spec = descend.objective_spec
    if x0 is None:
        x0 = space.sample(nlanes, seed=seed)
    x0 = as_real(x0, base.device)
    nlanes = int(x0.shape[0])
    manifest = obs.RunManifest.begin(kind="optimize", config={
        "nlanes": nlanes, "ndim": space.ndim, "steps": int(steps),
        "method": method, "objective": spec["metric"], "mesh": None,
        "names": ",".join(space.names)})
    obs.record_build_info(run_id=manifest.run_id)
    status = "failed"
    try:
        with obs.span("optimize_designs", nlanes=nlanes,
                      method=method) as sp:
            cache_info = {"state": "disabled"}
            sp.set(exec_cache=cache_info["state"])
            t0 = time.perf_counter()
            with obs.span("optimize_execute"):
                out = descend(x0)
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
                "exec_cache": cache_info["state"]}
            status = "ok"
            return result
    finally:
        obs.finish_run(manifest, status=status, write_trace=False)
