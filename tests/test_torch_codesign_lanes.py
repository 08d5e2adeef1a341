"""Co-design gradients of the port: lanes, the unrolled check and the
guards, on the small cylinder of ``tests/golden/codesign/cylinder.json``.

- the batched lanes of ``grad_guarded(obj)`` against a single design
  (``obj(x)``), the golden held by both;
- implicit differentiation of the drag fixed point against
  differentiating the unrolled iteration (30 relaxed passes, tol 1e-9),
  at 1e-5 as ``tests/test_optimize.py:
  test_custom_vjp_matches_unrolled_autodiff``, and the fixed point's
  record of the passes it ran;
- ``grad_guarded`` of a single non-finite design raises
  ``NonFiniteResult`` with ``phase == "adjoint"``;
- ``make_variant_solver(implicit_diff=True)`` leaves ``solve`` and
  ``solve.batched`` bitwise those of the solver without it.
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from raft_tpu import errors as jerrors

from raft_tpu_torch import errors
from raft_tpu_torch._config import COMPLEX
from raft_tpu_torch.models import codesign_cases as CC
from raft_tpu_torch.parallel import optimize as opt
from raft_tpu_torch.parallel import variants as vr

REC = CC.load("cylinder")["std"]
SERIAL_TOL = 1e-10   # the plain K1 rounds by batch size on the CPU (~1e-12)
VALUE_TOL, GRAD_TOL = 1e-9, 1e-7   # as tests/test_torch_codesign.py


@pytest.fixture(scope="module")
def cyl():
    base, space = CC.build(REC, "cpu")
    return base, space, CC.objective(REC, base, space)


def test_batched_lanes_match_a_single_design(cyl):
    _, _, obj = cyl
    X = CC.lanes_x(REC)
    vb, gb, fin = opt.grad_guarded(obj)(X)
    assert fin.tolist() == [True, True]
    v, g = opt.grad_guarded(obj)(X[1])
    assert v.shape == () and g.shape == (2,)
    np.testing.assert_allclose(v.numpy(), vb[1].numpy(), rtol=SERIAL_TOL)
    np.testing.assert_allclose(g.numpy(), gb[1].numpy(), rtol=SERIAL_TOL)
    for vv, gg, lane in ((v, g, REC["lanes"][1]), (vb[0], gb[0],
                                                   REC["lanes"][0])):
        v_rel, g_rel = CC.deviation(float(vv), gg.numpy(), lane)
        assert v_rel <= VALUE_TOL and g_rel <= GRAD_TOL, (v_rel, g_rel)


def test_implicit_matches_unrolled_autodiff(cyl):
    base, space, _ = cyl
    solver = vr.make_variant_solver(base, Hs=5.0, Tp=9.0, beta=0.0,
                                    ballast=False, nIter=30, tol=1e-9,
                                    newton_iters=REC["solver"]["newton_iters"],
                                    implicit_diff=True)
    x = torch.ones(2, dtype=torch.float64, requires_grad=True)
    st = torch.func.vmap(functools.partial(solver.setup, implicit=True))(
        pytree.tree_map(lambda v: v[None], space.to_theta(x)))
    nw = len(REC["w"])
    Xi0 = torch.zeros((1, 6, nw), dtype=COMPLEX) + 0.1
    state = {k: st[k] for k in vr._STEP_STATE}
    record = {}
    Xi = opt.fixed_point_implicit(solver.drag_step, Xi0, state, nIter=30,
                                  tol=1e-9, record=record)
    assert 0 < record["passes"] <= 30 and "adjoint_passes" not in record
    gi, = torch.autograd.grad(torch.sum(opt._abs2(Xi)), x,
                              retain_graph=True)
    assert 0 < record["adjoint_passes"] <= 60
    Xu = Xi0
    for _ in range(30):
        Xu = 0.2 * Xu + 0.8 * solver.drag_step(state, Xu)
    gu, = torch.autograd.grad(torch.sum(opt._abs2(Xu)), x)
    assert torch.all(torch.isfinite(gi)) and torch.all(torch.isfinite(gu))
    np.testing.assert_allclose(gi.numpy(), gu.numpy(), rtol=1e-5)


def test_non_finite_design_raises_in_the_adjoint_phase(cyl):
    _, _, obj = cyl
    with pytest.raises(errors.NonFiniteResult) as e:
        opt.grad_guarded(obj)(np.array([np.nan, 1.0]))
    assert e.value.phase == "adjoint"
    assert type(e.value).__name__ == jerrors.NonFiniteResult.__name__


def test_implicit_diff_leaves_solve_bitwise(cyl):
    base, space, _ = cyl
    kw = dict(Hs=5.0, Tp=9.0, ballast=True, nIter=4, newton_iters=1)
    X = torch.tensor([[1.0, 1.0], [1.05, 0.98]], dtype=torch.float64)
    thetas = torch.func.vmap(space.to_theta)(X)
    outs = [vr.make_variant_solver(base, implicit_diff=flag, **kw)
            for flag in (False, True)]
    a, b = (s.batched(thetas) for s in outs)
    assert set(a) == set(b)
    for k in a:
        assert (a[k] == b[k]) if k == "fp_chunks" \
            else torch.equal(a[k], b[k]), k
    theta = pytree.tree_map(lambda v: v[1], thetas)
    a, b = (s(theta) for s in outs)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not hasattr(outs[0], "implicit")
    assert callable(outs[1].implicit) and callable(outs[1].implicit_batched)
