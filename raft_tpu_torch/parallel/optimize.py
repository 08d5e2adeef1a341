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

Not ported here (ROADMAP A9, second part): ``normalize_request``, the
optimizers (Adam, L-BFGS), ``make_descent`` / ``optimize_designs``, the
segmented and checkpointed descent, ``partition``.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch
from torch.utils import _pytree as pytree

from raft_tpu_torch import errors
from raft_tpu_torch._config import REAL, as_real
from raft_tpu_torch.obs import transfers
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
        K = -torch.func.jacfwd(net_force)(X) + 1e-6 * torch.eye(
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


def grad_guarded(obj):
    """Value and gradient of ``obj`` (from `make_design_objective`) at x
    on the objective's device, with the finiteness check the JAX
    package's ``grad_guarded`` makes (one counted pull).

    x (P,): returns (value, gradient); a non-finite value or gradient
    raises ``NonFiniteResult`` with ``phase == "adjoint"``.  X (lanes, P):
    returns (values (lanes,), gradients (lanes, P), finite (lanes,) bool
    numpy): the lanes are independent, so a poisoned lane marks itself
    and leaves every other lane's gradient as it is."""
    dev = obj.solver.device

    def wrapped(x):
        x = as_real(x, dev).detach().requires_grad_(True)
        batch = x.ndim == 2
        v = obj.batched(x) if batch else obj(x)
        g, = torch.autograd.grad(torch.sum(v), x)
        v, g = v.detach(), g.detach()
        vh, fin = transfers.device_get(
            (v, torch.isfinite(v) & torch.all(torch.isfinite(g), dim=-1)),
            what="adjoint_finite")
        if batch:
            return v, g, np.asarray(fin, bool)
        if not bool(fin):
            err = errors.NonFiniteResult(
                "non-finite objective/adjoint gradient", value=float(vh))
            err.phase = "adjoint"
            raise err
        return v, g

    return wrapped
