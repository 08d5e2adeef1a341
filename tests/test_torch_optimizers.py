"""The port's Adam and L-BFGS against optax 0.2.6, live, on the CPU.

``raft_tpu_torch/parallel/optimizers.py`` copies the two optimizers the
JAX package's descent takes from optax (``raft_tpu/parallel/optimize.py:
_make_optimizer``: ``optax.adam(lr)``; ``optax.lbfgs(memory_size=8,
linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=8))``).
Here both run 10 steps on batched float64 analytic objectives, optax under
``jax.vmap`` over the lanes, the port batched:

- Rosenbrock from (-1.2, 1), (0.5, 0.5), (2, 2), (0, 0) and a NaN lane
  (its linesearch runs to the 8-step cap every step);
- a 6-D quadratic with condition number 1e4 (eigenvalues 1 to 1e4 in a
  random basis), from three starts;
- the Rosenbrock lanes with the NaN lane frozen, as the descent freezes
  it: the linesearch's trials are the slowest live lane's, and the live
  lanes are bitwise those of the search that holds every lane.

Each objective is one function on the host, its value and its gradient
written out by hand, that both sides call (optax through
``jax.pure_callback`` under a ``custom_vjp``): the comparison sees the
optimizers' arithmetic alone (XLA's fused multiply-adds would otherwise
differ from PyTorch's in the last bit of every value).  Iterates and every state leaf are held at 1e-12
relative (max-abs over the leaf's finite entries; NaN and inf where
optax has them), step counts
and linesearch steps exactly; the linesearch must end on different
iterations in different lanes and reach its cap in one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from raft_tpu_torch import errors
from raft_tpu_torch.parallel import optimizers

jax.config.update("jax_enable_x64", True)

STEPS = 10
TOL = 1e-12
ROSEN_X0 = [[-1.2, 1.0], [0.5, 0.5], [2.0, 2.0], [0.0, 0.0],
            [np.nan, 1.0]]


def _quadratic():
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    A = Q @ np.diag(np.logspace(0, 4, 6)) @ Q.T
    return 0.5 * (A + A.T), rng.normal(size=6), rng.normal(size=(3, 6))


A_Q, B_Q, QUAD_X0 = _quadratic()


def rosen_torch(X):
    """Rosenbrock's value and gradient, lanes (lanes, 2)."""
    x0, x1 = X[:, 0], X[:, 1]
    a = 1.0 - x0
    b = x1 - x0 * x0
    return (a * a + 100.0 * (b * b),
            torch.stack([-2.0 * a - 400.0 * x0 * b, 200.0 * b], dim=-1))


def quad_torch(X):
    """The quadratic's value and gradient, lanes (lanes, 6)."""
    A = torch.as_tensor(A_Q)
    b = torch.as_tensor(B_Q)
    Ax = X @ A.T
    return 0.5 * torch.sum(X * Ax, dim=-1) - torch.sum(b * X, dim=-1), Ax - b


def on_host(vg):
    """A scalar JAX objective of one lane that calls ``vg`` on the host
    for its value and (through a ``custom_vjp``) its gradient."""
    def host(x):
        v, g = vg(torch.tensor(np.asarray(x))[None])
        return v.numpy()[0], g.numpy()[0]

    def both(x):
        return jax.pure_callback(
            host, (jax.ShapeDtypeStruct((), jnp.float64),
                   jax.ShapeDtypeStruct(x.shape, jnp.float64)), x,
            vmap_method="sequential")

    @jax.custom_vjp
    def f(x):
        return both(x)[0]

    def bwd(g, ct):
        return (ct * g,)

    f.defvjp(both, bwd)
    return f


OBJECTIVES = {"rosenbrock": (rosen_torch, ROSEN_X0),
              "quadratic": (quad_torch, QUAD_X0)}


def optax_run(method, f, X0):
    """(x, state leaves by name) after each step, optax under vmap."""
    if method == "adam":
        opt = optax.adam(0.03)
    else:
        opt = optax.lbfgs(memory_size=8,
                          linesearch=optax.scale_by_zoom_linesearch(
                              max_linesearch_steps=8))
    vg = jax.value_and_grad(f)

    def step(x, s):
        v, g = vg(x)
        if method == "adam":
            u, s = opt.update(g, s, x)
        else:
            u, s = opt.update(g, s, x, value=v, grad=g, value_fn=f)
        return optax.apply_updates(x, u), s

    step = jax.jit(jax.vmap(step))
    x = jnp.asarray(X0)
    s = jax.vmap(opt.init)(x)
    out = []
    for _ in range(STEPS):
        x, s = step(x, s)
        if method == "adam":
            leaves = {"count": s[0].count, "mu": s[0].mu, "nu": s[0].nu}
        else:
            lb, ls = s[0], s[2]
            leaves = {k: getattr(lb, k) for k in lb._fields}
            leaves.update(learning_rate=ls.learning_rate, value=ls.value,
                          grad=ls.grad,
                          num_linesearch_steps=ls.info.num_linesearch_steps,
                          decrease_error=ls.info.decrease_error,
                          curvature_error=ls.info.curvature_error)
        out.append((np.asarray(x), {k: np.asarray(v)
                                    for k, v in leaves.items()}))
    return out


def port_run(method, vg, X0):
    opt = optimizers.make_optimizer(method, 0.03)
    x = torch.tensor(X0, dtype=torch.float64)
    s = opt.init(x)
    out = []
    for _ in range(STEPS):
        v, g = vg(x)
        u, s = opt.update(g, s, x, value=v, value_and_grad_fn=vg)
        x = x + u
        out.append((x.numpy(), {k: t.numpy() for k, t in s.items()}))
    return out


def rel(a, b) -> float:
    """max|a - b| / max|b| over the finite entries; inf where the NaN and
    infinite entries differ."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    ok = np.isfinite(b)
    if not (np.array_equal(a[~ok], b[~ok], equal_nan=True)
            and np.isfinite(a[ok]).all()):
        return float("inf")
    if not ok.any():
        return 0.0
    scale = np.max(np.abs(b[ok]))
    d = np.max(np.abs(a[ok] - b[ok]))
    return 0.0 if d == 0.0 else float(d / scale)


@pytest.fixture(scope="module", params=sorted(OBJECTIVES))
def objective(request):
    return OBJECTIVES[request.param]


@pytest.mark.parametrize("method", ["adam", "lbfgs"])
def test_iterates_and_state_match_optax(objective, method):
    vg, X0 = objective
    ref = optax_run(method, on_host(vg), X0)
    got = port_run(method, vg, X0)
    for k, ((xr, sr), (xg, sg)) in enumerate(zip(ref, got)):
        assert rel(xg, xr) <= TOL, (k, xg, xr)
        assert set(sg) == set(sr)
        for name in sr:
            if np.issubdtype(sr[name].dtype, np.integer):
                assert np.array_equal(sg[name], sr[name]), (k, name)
            else:
                assert rel(sg[name], sr[name]) <= TOL, \
                    (k, name, sg[name], sr[name])
    if method == "lbfgs":
        ls = np.array([s["num_linesearch_steps"] for _, s in ref])
        fin = ~np.isnan(np.asarray(X0, float)).any(axis=1)
        assert len({tuple(col) for col in ls[:, fin].T}) > 1
        # the NaN lane searches to the cap every step
        assert (ls[:, ~fin] == 8).all()


def test_the_nan_lane_stays_nan_and_alone():
    """Adam and L-BFGS keep a NaN lane to itself: the other lanes'
    iterates are bitwise those of a batch without it."""
    for method in ("adam", "lbfgs"):
        got = port_run(method, rosen_torch, ROSEN_X0)
        alone = port_run(method, rosen_torch, ROSEN_X0[:4])
        for (xg, _), (xa, _) in zip(got, alone):
            assert np.isnan(xg[4]).all()
            assert np.array_equal(xg[:4], xa)


def test_frozen_lanes_leave_the_linesearch():
    """L-BFGS with the NaN lane frozen, as the descent freezes it: each
    step's linesearch takes as many trials as the slowest live lane's
    steps, not the NaN lane's 8, and the live lanes' iterates and every
    state leaf are bitwise those of the search that holds every lane."""
    opt = optimizers.make_optimizer("lbfgs", 0.03)
    x_frz = x_all = torch.tensor(ROSEN_X0, dtype=torch.float64)
    s_frz = s_all = opt.init(x_all)
    for _ in range(STEPS):
        calls = []

        def counted(X):
            calls.append(1)
            return rosen_torch(X)

        v, g = rosen_torch(x_frz)
        frozen = ~(torch.isfinite(v) & torch.all(torch.isfinite(g), -1))
        assert frozen.tolist() == [False] * 4 + [True]
        u, s_frz = opt.update(g, s_frz, x_frz, value=v,
                              value_and_grad_fn=counted, frozen=frozen)
        x_frz = x_frz + u
        assert len(calls) == int(s_frz["num_linesearch_steps"][:4].max())
        v, g = rosen_torch(x_all)
        u, s_all = opt.update(g, s_all, x_all, value=v,
                              value_and_grad_fn=rosen_torch)
        x_all = x_all + u
        assert int(s_all["num_linesearch_steps"][4]) == 8
        assert torch.equal(x_frz[:4], x_all[:4])
        for k in s_all:
            assert torch.equal(s_frz[k][:4], s_all[k][:4]), k


def test_unknown_method_is_a_typed_error():
    with pytest.raises(errors.ModelConfigError):
        optimizers.make_optimizer("sgd", 0.1)
