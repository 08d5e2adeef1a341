"""The port's batched case sweep against the JAX package's.

On the vendored OC3spar at 10 frequency bins, 6 cases from a seeded
draw (Hs 1-12 m, Tp 4-18 s, heading 0-360 deg), nIter 6:

- ``sweep_cases(device="cpu")`` against JAX ``sweep_cases``: Xi and std
  at rtol 1e-9 / atol 1e-12 (the port solves by Gauss-Jordan, JAX on the
  CPU by LU: they agree to rounding, ~1e-11); iters, converged and
  fp_chunks exactly;
- the batched sweep against the port's serial per-case solve;
- both packages under ``RAFT_TPU_PRECISION=mixed``, to 1e-8 with the
  iteration counts exact;
- ``device=None`` raises where there is no card.
"""
import numpy as np
import pytest
import torch
import yaml

from raft_tpu import _config as j_config
from raft_tpu.models.fowt import build_fowt as j_build_fowt
from raft_tpu.parallel.sweep import sweep_cases as j_sweep_cases

from raft_tpu_torch import _config
from raft_tpu_torch.io.designs import design_path
from raft_tpu_torch.models.fowt import build_fowt
from raft_tpu_torch.ops import linalg as TL
from raft_tpu_torch.parallel.sweep import (
    make_case_solver, sweep_cases, unrolled_fixed_point)

W = np.arange(0.03, 0.33, 0.03) * 2 * np.pi        # 10 bins
NIT = 6


@pytest.fixture(scope="module")
def design():
    with open(design_path("OC3spar")) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(5)
    nc = 6
    return (1.0 + 11.0 * rng.random(nc), 4.0 + 14.0 * rng.random(nc),
            np.deg2rad(360.0 * rng.random(nc)))


@pytest.fixture(scope="module")
def depth(design):
    return float(design["site"]["water_depth"])


@pytest.fixture(scope="module")
def port_f64(design, depth, cases):
    fowt = build_fowt(design, W, depth=depth)
    return sweep_cases(fowt, *cases, nIter=NIT, device="cpu")


@pytest.fixture(scope="module")
def jax_f64(design, depth, cases):
    return j_sweep_cases(j_build_fowt(design, W, depth=depth), *cases,
                         nIter=NIT)


def _close(a, b, rtol, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_sweep_matches_jax(port_f64, jax_f64):
    for key in ("Xi", "std"):
        _close(port_f64[key].numpy(), jax_f64[key], rtol=1e-9)
    np.testing.assert_array_equal(port_f64["iters"].numpy(),
                                  np.asarray(jax_f64["iters"]))
    np.testing.assert_array_equal(port_f64["converged"].numpy(),
                                  np.asarray(jax_f64["converged"]))
    assert port_f64["fp_chunks"] == int(jax_f64["fp_chunks"])
    assert port_f64["Xi"].shape == (6, 6, len(W))
    assert port_f64["Xi"].dtype == torch.complex128


def test_batched_matches_serial(design, depth, cases, port_f64):
    solver = make_case_solver(build_fowt(design, W, depth=depth,
                                         device="cpu"), nIter=NIT)
    for i in (0, 3):
        out = solver(*(float(c[i]) for c in cases))
        _close(out["Xi"].numpy(), port_f64["Xi"][i].numpy(), rtol=1e-9)
        _close(out["std"].numpy(), port_f64["std"][i].numpy(), rtol=1e-9)


def test_sweep_mixed_matches_jax_mixed(design, depth, cases, port_f64):
    _config.set_precision_mode("mixed")
    j_config.set_precision_mode("mixed")
    try:
        port = sweep_cases(build_fowt(design, W, depth=depth), *cases,
                           nIter=NIT, device="cpu")
        disp = TL.last_dispatch()
        jax = j_sweep_cases(j_build_fowt(design, W, depth=depth), *cases,
                            nIter=NIT)
    finally:
        _config.set_precision_mode(None)
        j_config.set_precision_mode(None)
    assert disp["precision"] == "mixed"
    assert disp["kernel"] == "impedance_gj_mixed"
    for key in ("Xi", "std"):
        _close(port[key].numpy(), jax[key], rtol=1e-8)
        # and the ladder lands on the f64 answer
        _close(port[key].numpy(), port_f64[key].numpy(), rtol=1e-8)
    np.testing.assert_array_equal(port["iters"].numpy(),
                                  np.asarray(jax["iters"]))
    np.testing.assert_array_equal(port["converged"].numpy(),
                                  np.asarray(jax["converged"]))
    assert port["fp_chunks"] == int(jax["fp_chunks"])


def test_frozen_chunks_are_skipped():
    """A chunk runs only while some item is unconverged; skipping the
    rest changes nothing (a frozen pass is an identity on the carry)."""
    target = torch.tensor([[[1.0 + 0j]], [[2.0 + 0j]]], dtype=torch.complex128)
    calls = []

    def step(X):
        calls.append(1)
        return target + 0 * X

    out = unrolled_fixed_point(step, torch.zeros_like(target), nIter=8,
                               tol=0.01, chunk=2)
    XiLast, Xi, done, iters, chunks = out
    # XiLast = (1 - 0.2^k) target after k passes: converged at pass 4
    assert chunks == 2 and len(calls) == 4
    assert done.tolist() == [True, True] and iters.tolist() == [4, 4]
    torch.testing.assert_close(Xi, target)
    full = unrolled_fixed_point(step, torch.zeros_like(target), nIter=8,
                                tol=0.01, chunk=0)
    assert full[4] == 1 and torch.equal(full[1], Xi)


def test_no_card_raises(monkeypatch, design, depth):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_cases(build_fowt(design, W, depth=depth), [6.0], [10.0], [0.0])
