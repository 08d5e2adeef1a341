"""The port's differentiable impedance solve against the JAX package's.

``raft_tpu_torch.ops.linalg.impedance_solve`` is a
``torch.autograd.Function`` (``ImpedanceSolve``) whose backward is one
adjoint solve through the same dispatch; ``raft_tpu.ops.linalg.
impedance_solve`` is a ``jax.custom_vjp`` with the same algebra.  On
seeded systems (numpy, handed to both):

- the gradients of a real function of X in w, M, B and C equal JAX's, and
  F's equals the conjugate of JAX's (PyTorch's convention for complex
  gradients), at 1e-12 normwise, with M, B and C shared by the cases and
  on the LU branch (2n > 16) too;
- ``torch.autograd.gradcheck`` in float64 on a tiny system;
- ``last_dispatch()["adjoint"]`` after a backward (cleared by the next
  forward), under ``RAFT_TPU_PRECISION=mixed`` too;
- the backward is the Function's (one forward and one adjoint solve of
  the plain version, no native autograd of it), the ``kernel`` fault
  seam fires in it, and the forward X is bitwise the dispatch's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.ops import linalg as jlinalg

from raft_tpu_torch import _config
from raft_tpu_torch.errors import KernelFailure
from raft_tpu_torch.ops import linalg
from raft_tpu_torch.testing import faults

jax.config.update("jax_enable_x64", True)

# (n, per-input batch shapes of M, B, C, F): every input batched, M and C
# shared by the cases, B shared, and a 9-DOF system on the LU branch
CASES = {
    "batched": (3, (2,), (2,), (2,), (2,)),
    "shared_MC": (3, (), (2,), (), (2,)),
    "shared_B": (2, (2, 1), (), (2, 3), (2, 3)),
    "lu": (9, (), (2,), (2,), (2,)),
}


def _inputs(n, bM, bB, bC, bF, nw=4, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.5, 2.0, nw)
    M = rng.normal(size=bM + (n, n, nw)) + 4.0 * np.eye(n)[:, :, None]
    B = rng.normal(size=bB + (n, n, nw))
    C = rng.normal(size=bC + (n, n)) + 3.0 * np.eye(n)
    F = rng.normal(size=bF + (n, nw)) + 1j * rng.normal(size=bF + (n, nw))
    c = rng.normal(size=(n, nw)) + 1j * rng.normal(size=(n, nw))
    return (w, M, B, C, F), c


def _loss_jax(c):
    def f(w, M, B, C, F):
        X = jlinalg.impedance_solve(w, M, B, C, F)
        return jnp.sum(jnp.abs(X) ** 2) + jnp.sum(jnp.real(c * X))
    return f


def _loss_torch(X, c):
    return torch.sum(torch.abs(X) ** 2) + torch.sum(torch.real(
        torch.as_tensor(c) * X))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_equal_jax(case):
    args, c = _inputs(*CASES[case])
    gj = jax.grad(_loss_jax(c), argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    _loss_torch(linalg.impedance_solve(*ts), c).backward()
    for name, t, g in zip("wMBCF", ts, gj):
        g = np.asarray(g)
        if name == "F":
            g = np.conj(g)     # PyTorch's complex gradient is JAX's conjugate
        got = t.grad.numpy()
        assert got.shape == g.shape, name
        err = np.max(np.abs(got - g)) / np.max(np.abs(g))
        assert err <= 1e-12, (case, name, err)


def test_gradcheck_tiny_system():
    args, _ = _inputs(2, (2,), (), (2,), (2,), nw=2, seed=3)
    ts = tuple(torch.tensor(a, requires_grad=True) for a in args)
    assert torch.autograd.gradcheck(linalg.impedance_solve, ts)


@pytest.mark.parametrize("mode,kernel", [("f64", "impedance_gj"),
                                         ("mixed", "impedance_gj_mixed")])
def test_adjoint_dispatch_recorded(mode, kernel):
    args, c = _inputs(3, (2,), (2,), (2,), (2,), seed=5)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    _config.set_precision_mode(mode)
    try:
        X = linalg.impedance_solve(*ts)
        assert "adjoint" not in linalg.last_dispatch()
        _loss_torch(X, c).backward()
        d = linalg.last_dispatch()
        assert d["adjoint"] is True
        assert (d["backend"], d["kernel"], d["precision"]) == (
            "plain_fused", kernel, mode)
        grads = [t.grad.clone() for t in ts]
        # a fresh forward clears the fact
        linalg.impedance_solve(*ts)
        assert "adjoint" not in linalg.last_dispatch()
    finally:
        _config.set_precision_mode(None)
    if mode == "mixed":
        ref = [torch.tensor(a, requires_grad=True) for a in args]
        _loss_torch(linalg.impedance_solve(*ref), c).backward()
        for g, r in zip(grads, ref):
            assert float(torch.max(torch.abs(g - r.grad))
                         / torch.max(torch.abs(r.grad))) <= 1e-10


def test_backward_is_the_function(monkeypatch):
    args, c = _inputs(3, (), (2,), (), (2,), seed=7)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    calls = []
    inner = linalg.impedance_gj_solve

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return inner(*a, **k)

    monkeypatch.setattr(linalg, "impedance_gj_solve", counting)
    X = linalg.impedance_solve(*ts)
    # one node, straight onto the inputs: no graph of the elimination
    assert type(X.grad_fn).__name__ == "ImpedanceSolveBackward"
    assert all(type(f).__name__ == "AccumulateGrad"
               for f, _ in X.grad_fn.next_functions if f is not None)
    _loss_torch(X, c).backward()
    # the forward and one adjoint solve, neither recording a graph
    assert calls == [False, False]
    # the forward value is the dispatch's, bit for bit
    with torch.no_grad():
        ref = inner(*[torch.as_tensor(a) for a in args])
    assert torch.equal(X.detach(), ref)
    assert torch.equal(
        linalg._impedance_solve_impl(*[torch.as_tensor(a) for a in args]),
        ref)


def test_adjoint_goes_through_the_kernel_seam():
    args, c = _inputs(3, (2,), (2,), (2,), (2,), seed=9)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    X = linalg.impedance_solve(*ts)
    faults.install("raise@kernel")
    try:
        with pytest.raises(KernelFailure) as ei:
            _loss_torch(X, c).backward()
    finally:
        faults.clear()
    assert ei.value.injected
