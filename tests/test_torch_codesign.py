"""Co-design gradients of the port on the small cylinder, against the JAX
package's goldens.

``tests/golden/codesign/cylinder.json`` (written by
``tests/golden/codesign_golden.py`` with the JAX package) holds, on
``Vertical_cylinder`` at 2 frequency bins, the value and gradient of the
std, offset and del objectives over {d_scale, moor_L} at x = 1 and one
interior point.  The port's ``make_design_objective`` / ``grad_guarded``
run the same space, objective and solver knobs on the CPU:

- values at 1e-9 relative, gradients at 1e-7 relative per component
  (a component below 1e-6 of the largest is held to 1e-7 of 1e-6 of it:
  ``models/codesign_cases.deviation``);
- central finite differences of the port's own values (eps 1e-6) against
  its std gradient at 1e-5, the JAX package's bar
  (``tests/test_optimize.py:test_fd_parity_std_gradient_small_cylinder``);
- a NaN lane in the batch marks itself non-finite and leaves every other
  lane's value and gradient bitwise those of the clean batch;
- ``safe_rms`` against ``get_rms``, ``del_proxy``'s finite gradient at a
  zero row, the design space's and the objective spec's validation and
  bookkeeping against the JAX package's.

The finite-difference points ride in the std batch (one vmapped setup).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu import errors as jerrors
from raft_tpu.models.fowt import build_fowt as j_build_fowt
from raft_tpu.ops.spectra import get_rms as j_get_rms
from raft_tpu.parallel import optimize as jopt

from raft_tpu_torch import errors
from raft_tpu_torch.io.designs import load_design
from raft_tpu_torch.models import codesign_cases as CC
from raft_tpu_torch.ops.spectra import get_rms
from raft_tpu_torch.parallel import optimize as opt

jax.config.update("jax_enable_x64", True)

GOLD = CC.load("cylinder")
EPS = 1e-6          # the JAX test's finite-difference step
VALUE_TOL = 1e-9
GRAD_TOL = 1e-7     # of max(|g_i|, CC.GRAD_FLOOR * max|g|)
FD_TOL = 1e-5


def held(value, grad, lane):
    v_rel, g_rel = CC.deviation(value, grad, lane)
    assert v_rel <= VALUE_TOL and g_rel <= GRAD_TOL, (v_rel, g_rel)


@pytest.fixture(scope="module")
def cyl():
    return CC.build(GOLD["std"], "cpu")


def _objective(cyl, metric):
    return CC.objective(GOLD[metric], *cyl)


def _std_points():
    """The golden's lanes, then x = 1 moved by +-EPS along each axis."""
    X = list(CC.lanes_x(GOLD["std"]))
    x1 = X[0]
    for i in range(len(x1)):
        for s in (1.0, -1.0):
            X.append(x1 + s * EPS * np.eye(len(x1))[i])
    return np.asarray(X)


@pytest.fixture(scope="module")
def std_obj(cyl):
    return _objective(cyl, "std")


@pytest.fixture(scope="module")
def std_run(std_obj):
    v, g, fin = opt.grad_guarded(std_obj)(_std_points())
    return v.numpy(), g.numpy(), fin


@pytest.mark.parametrize("metric", ["std", "offset", "del"])
def test_golden_values_and_gradients(cyl, std_run, metric):
    rec = GOLD[metric]
    if metric == "std":
        v, g, fin = std_run
    else:
        obj = _objective(cyl, metric)
        assert obj.spec == rec["objective"]
        v, g, fin = opt.grad_guarded(obj)(CC.lanes_x(rec))
        v, g = v.numpy(), g.numpy()
    assert fin.all()
    for i, lane in enumerate(rec["lanes"]):
        held(float(v[i]), g[i], lane)


def test_finite_differences(std_run):
    v, g, _ = std_run
    for i in range(2):
        fd = (v[2 + 2 * i] - v[3 + 2 * i]) / (2 * EPS)
        rel = abs(g[0, i] - fd) / abs(fd)
        assert rel <= FD_TOL, (i, g[0, i], fd, rel)


def test_poisoned_lane_leaves_the_others_bitwise(std_obj, std_run):
    X = _std_points()
    X[1] = np.nan
    v, g, fin = opt.grad_guarded(std_obj)(X)
    v, g = v.numpy(), g.numpy()
    v0, g0, _ = std_run
    assert fin.tolist() == [True, False] + [True] * (len(X) - 2)
    assert np.isnan(v[1])
    keep = np.arange(len(X)) != 1
    assert np.array_equal(v[keep], v0[keep])
    assert np.array_equal(g[keep], g0[keep])


def test_safe_rms_and_del_proxy_at_zero_rows():
    rng = np.random.default_rng(3)
    Xi = rng.normal(size=(6, 5)) + 1j * rng.normal(size=(6, 5))
    Xi[1] = 0.0                      # a symmetric DOF's exact-zero row
    t = torch.tensor(Xi, requires_grad=True)
    a = opt.safe_rms(t, axis=-1)
    np.testing.assert_allclose(a.detach().numpy(),
                               get_rms(t.detach(), axis=-1).numpy(),
                               rtol=1e-15)
    np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(jopt.safe_rms(jnp.asarray(Xi),
                                                     axis=-1)), rtol=1e-15)
    np.testing.assert_allclose(a.detach().numpy(),
                               np.asarray(j_get_rms(Xi, axis=-1)),
                               rtol=1e-15)
    assert float(a[1].detach()) == 0.0
    w = np.linspace(0.3, 1.5, 5)
    d = opt.del_proxy(t, torch.tensor(w))
    np.testing.assert_allclose(
        d.detach().numpy(), np.asarray(jopt.del_proxy(jnp.asarray(Xi),
                                                      jnp.asarray(w))),
        rtol=1e-14)
    g, = torch.autograd.grad(torch.sum(d) + torch.sum(a), t)
    assert bool(torch.all(torch.isfinite(torch.view_as_real(g))))
    assert bool(torch.all(g[1] == 0))


def test_design_space_and_objective_bookkeeping(cyl):
    base, _ = cyl
    jbase = j_build_fowt(load_design("Vertical_cylinder"),
                         np.asarray(GOLD["std"]["w"]),
                         depth=GOLD["std"]["depth"])
    for bad in ({}, {"nope": (0.9, 1.1)}, {"d_scale": (1.1, 0.9)},
                {"d_scale": (0.9, float("inf"))}):
        with pytest.raises(errors.ModelConfigError) as e:
            opt.DesignSpace(base, bad)
        with pytest.raises(jerrors.ModelConfigError) as je:
            jopt.DesignSpace(jbase, bad)
        assert type(e.value).__name__ == type(je.value).__name__
    bounds = {"ballast": (0.8, 1.2), "moor_EA": (0.9, 1.1),
              "moor_anchor": (0.9, 1.1)}
    space = opt.DesignSpace(base, bounds)
    jspace = jopt.DesignSpace(jbase, bounds)
    assert space.names == jspace.names == ["ballast", "moor_EA",
                                           "moor_anchor"]
    assert space.fingerprint() == jspace.fingerprint()
    np.testing.assert_array_equal(space.sample(5, seed=1),
                                  jspace.sample(5, seed=1))
    x = np.array([1.1, 1.05, 0.95])
    th = space.to_theta(torch.tensor(x))
    jth = jspace.to_theta(jnp.asarray(x))
    assert set(th) == set(jth)
    for k in th:
        for a, b in zip(th[k] if k == "rho_fill" else [th[k]],
                        jth[k] if k == "rho_fill" else [jth[k]]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        space.clip(torch.tensor([2.0, 0.0, 1.0])).numpy(),
        np.asarray(jspace.clip(jnp.asarray([2.0, 0.0, 1.0]))))
    for spec in (None, "del", {"metric": "offset", "Hs": 3, "dof": "2"},
                 {"weights": [1, 0, 1, 0, 1, 0], "sn_m": 3}):
        assert opt.normalize_objective(spec) == \
            jopt.normalize_objective(spec)
    for bad in ({"metric": "max"}, {"Hs": -1.0}, {"dof": 6},
                {"weights": [1, 2]}, {"what": 1}, 3.0):
        with pytest.raises(errors.ModelConfigError):
            opt.normalize_objective(bad)
        with pytest.raises(jerrors.ModelConfigError):
            jopt.normalize_objective(bad)
