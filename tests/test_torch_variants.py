"""The port's design-variant sweep against the JAX package's.

On the vendored VolturnUS-S at 10 frequency bins:

- ``volturn_grid`` gives exactly the JAX package's θ batch;
- the identity variant reproduces the base design's statics;
- 4 variants of ``volturn_grid(factors=(0.9, 1.1))`` with the ballast
  trim, newton_iters 8, nIter 5, against JAX ``solver.batched``: mass,
  displacement, GMT, offset, pitch_deg and Xeq to 1e-9 (atol 1e-12 for
  the components that are zero by symmetry), std and Xi to 1e-8;
- the port's batched sweep against its serial per-variant solve.
"""
import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from raft_tpu.models.fowt import build_fowt as j_build_fowt
from raft_tpu.parallel import variants as j_vr

from raft_tpu_torch.io.designs import design_path
from raft_tpu_torch.models.fowt import build_fowt, fowt_pose, fowt_statics
from raft_tpu_torch.parallel import variants as vr

W = np.arange(0.02, 0.21, 0.02) * 2 * np.pi        # 10 bins
KW = dict(Hs=6.0, Tp=12.0, ballast=True, nIter=5, tol=0.01, newton_iters=8)


@pytest.fixture(scope="module")
def design():
    with open(design_path("VolturnUS-S")) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def base(design):
    return build_fowt(design, W, depth=600.0, device="cpu")


@pytest.fixture(scope="module")
def thetas(design):
    th, _ = vr.volturn_grid(design, factors=(0.9, 1.1))
    idx = np.random.default_rng(1).integers(0, len(th["rA0"]), 4)
    return {k: np.asarray(v)[idx] for k, v in th.items()}


@pytest.fixture(scope="module")
def port_out(base, thetas):
    return vr.sweep_variants(base, thetas, device="cpu", **KW)


def _close(a, b, rtol, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("factors", [(0.75, 1.0, 1.25), (0.9, 1.1)])
def test_volturn_grid_equals_jax(design, factors):
    th, meta = vr.volturn_grid(design, factors=factors)
    jth, jmeta = j_vr.volturn_grid(design, factors=factors)
    assert set(th) == set(jth)
    for k in th:
        np.testing.assert_array_equal(th[k], np.asarray(jth[k]), err_msg=k)
    assert meta["shape"] == jmeta["shape"]
    np.testing.assert_array_equal(meta["grid"], jmeta["grid"])
    assert len(meta["grid"]) == len(factors) ** 5


def test_identity_variant_matches_base(base):
    theta = dict(rA0=np.stack([m.rA0.numpy() for m in base.members]),
                 rB0=np.stack([m.rB0.numpy() for m in base.members]),
                 d_scale=np.ones((len(base.members), 2)))
    out = vr.make_variant_solver(base, ballast=False, newton_iters=10)(theta)
    stat = fowt_statics(base, fowt_pose(base, np.zeros(6)))
    _close(out["mass"], stat["M_struc"][0, 0], rtol=1e-12)
    _close(out["displacement"], stat["V"] * 1025, rtol=1e-12)
    _close(out["GMT"], stat["rM"][2] - stat["rCG"][2], rtol=1e-9)
    # the unloaded equilibrium: the vendored design's heave imbalance,
    # 0.1805 m by the JAX package's variant solver (the reference YAML's
    # is -0.43 m, tests/test_variants.py)
    assert abs(float(out["Xeq"][2]) - 0.1805) < 0.02


def test_variants_match_jax(design, thetas, port_out):
    solver = j_vr.make_variant_solver(j_build_fowt(design, W, depth=600.0),
                                      **KW)
    jax_out = solver.batched({k: jnp.asarray(v) for k, v in thetas.items()})
    for key in ("mass", "displacement", "GMT", "offset", "pitch_deg",
                "Xeq"):
        _close(port_out[key].numpy(), jax_out[key], rtol=1e-9, msg=key)
    for key in ("std", "Xi"):
        _close(port_out[key].numpy(), jax_out[key], rtol=1e-8, msg=key)
    assert port_out["fp_chunks"] == int(jax_out["fp_chunks"])
    assert np.all(np.isfinite(port_out["std"].numpy()))
    # the ballast trim drives every variant's unloaded heave toward zero
    assert np.abs(port_out["Xeq"][:, 2].numpy()).max() < 0.05
    assert set(port_out["timings"]) == {"setup", "fixed_point"}


def test_batched_matches_serial(base, thetas, port_out):
    solver = vr.make_variant_solver(base, **KW)
    out = solver({k: v[2] for k, v in thetas.items()})
    for key in ("mass", "offset", "Xeq", "std", "Xi"):
        _close(out[key].numpy(), port_out[key][2].numpy(), rtol=1e-9,
               msg=key)
    assert out["Xi"].dtype == torch.complex128
