"""``optimize_designs``' edges and ``normalize_request`` in the port,
against the JAX package.

- ``mesh=`` and the checkpoint arguments (``checkpoint_every``,
  ``ckpt_store``, ``ckpt_key``, ``on_checkpoint``, ``ckpt_resume_only``)
  are refused with a typed ``ModelConfigError`` naming ROADMAP A9 (not
  ported yet), and so is an unknown method;
- every lane NaN (``cylinder.json``'s ``adam_all_nan``):
  ``NonFiniteResult`` with ``phase == "adjoint"``, its message and
  context the JAX package's;
- the health mode's repackaging of the descent summary;
- a one-lane, one-step Adam descent on the small cylinder: the result's,
  the provenance's and the run manifest's keys (and ``extra["optimize"]``'s)
  are those of the JAX package's ``optimize_designs`` in
  ``tests/golden/descent/cylinder.json``; its counted host pulls by
  ``what`` are pinned (each gradient's fixed-point chunk pulls, one
  summary);
- ``normalize_request`` against the JAX function, called live on a table
  of valid and invalid specs: the same canonical dict, or the same error
  class, message and context.
"""
import glob
import json
import math

import numpy as np
import pytest

from raft_tpu import errors as jerrors
from raft_tpu.parallel import optimize as jopt

from raft_tpu_torch import errors, obs
from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.parallel import optimize as opt

GOLD = DC.load("cylinder")["adam"]
#: a cheap call of the golden's design and objective
SMALL = dict(GOLD, x0=[[1.0, 1.0]], steps=1,
             solver={"nIter": 2, "tol": 1e-3, "adjoint_iters": 2,
                     "newton_iters": 1})


@pytest.fixture(scope="module")
def cyl():
    return DC.build(GOLD, "cpu")


@pytest.mark.parametrize("arg, value", [
    ("mesh", object()), ("checkpoint_every", 1), ("ckpt_store", object()),
    ("ckpt_key", "k"), ("on_checkpoint", print), ("ckpt_resume_only", True)])
def test_unported_arguments_are_refused(cyl, arg, value):
    with pytest.raises(errors.ModelConfigError) as ei:
        opt.optimize_designs(*cyl, **DC.call_kwargs(SMALL), **{arg: value})
    assert "ROADMAP A9" in str(ei.value) and arg in str(ei.value)


def test_every_lane_nan_is_a_typed_adjoint_failure(cyl):
    rec = DC.load("cylinder")["adam_all_nan"]
    with pytest.raises(errors.NonFiniteResult) as ei:
        opt.optimize_designs(*cyl, **DC.call_kwargs(rec))
    want = rec["raises"]
    assert ei.value.phase == "adjoint" == want["phase"]
    assert type(ei.value).__name__ == want["type"]
    assert ei.value.ctx == want["ctx"]
    assert str(ei.value) == want["message"]


def test_unknown_method_is_refused(cyl):
    kw = dict(DC.call_kwargs(SMALL), method="sgd")
    with pytest.raises(errors.ModelConfigError):
        opt.optimize_designs(*cyl, **kw)


@pytest.fixture(scope="module")
def small_run(cyl, tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    before = DC.pulls_by_what()
    obs.configure(str(d))
    try:
        res = opt.optimize_designs(*cyl, **DC.call_kwargs(SMALL))
    finally:
        obs.configure(None)
    pulls = DC.pulls_between(before, DC.pulls_by_what())
    with open(glob.glob(str(d / "optimize_*.manifest.json"))[0]) as f:
        return res, json.load(f), pulls


def test_result_provenance_and_manifest_keys(small_run):
    res, man, _ = small_run
    gold = GOLD["result"]
    assert set(res) == set(gold)
    assert set(res["provenance"]) == set(gold["provenance"]) | {"wall_s"}
    assert res["provenance"]["exec_cache"] == "disabled"
    # the port's dispatch record holds the JAX package's keys (and more)
    assert set(gold["provenance"]["solver"]) <= set(
        res["provenance"]["solver"])
    assert sorted(man) == GOLD["manifest_keys"]
    assert sorted(man["extra"]["optimize"]) == GOLD["manifest_optimize_keys"]
    assert set(man["config"]) == set(GOLD["manifest_config"])
    for key in ("method", "objective", "names", "ndim", "mesh"):
        assert man["config"][key] == GOLD["manifest_config"][key]
    assert man["kind"] == "optimize" and man["status"] == "ok"
    assert man["extra"]["optimize"]["descents_per_min"] > 0


def test_health_mode_repackages_the_summary(cyl, monkeypatch):
    """RAFT_TPU_HEALTH=1: the provenance and the manifest carry the
    descent's solve-health record (its gradient norms as the residual,
    the frozen lanes as the non-finite count), as the JAX package's."""
    monkeypatch.setenv("RAFT_TPU_HEALTH", "1")
    kw = dict(DC.call_kwargs(SMALL), x0=[[1.0, 1.0], [float("nan"), 1.0]])
    res = opt.optimize_designs(*cyl, **kw)
    h = res["provenance"]["solve_health"]
    assert set(h) == {"residual_rel_max", "residual_rel_median",
                      "nonfinite_lanes", "iters_max", "lanes", "worst_lane"}
    assert h["nonfinite_lanes"] == 1 and h["worst_lane"] == 1
    # a NaN lane's grad_norm is the largest float (JAX's nan_to_num(nan=inf))
    assert h["residual_rel_max"] == res["grad_norm"].max() == \
        np.finfo(float).max and h["lanes"] == 2


def test_host_pulls_by_what(small_run):
    _, _, pulls = small_run
    assert pulls == DC.expected_pulls(SMALL, gradients=2)


B = {"d_scale": [0.9, 1.1]}
SPECS = [
    ({"bounds": B}, {}),
    ({"bounds": {"moor_L": [0.98, 1.02], "d_scale": (0.9, 1.1)},
      "objective": "offset", "nlanes": "8", "steps": 5.0, "method": "lbfgs",
      "lr": "0.05", "gtol": 1e-6, "seed": 3, "nIter": 12, "tol": 0.02},
     {"lanes_max": 8, "steps_max": 5}),
    ({"bounds": {"ballast": [0.8, 1.2]},
      "objective": {"metric": "del", "dof": "2", "sn_m": 3}}, {}),
    ([("bounds", B)], {}),
    ({"bounds": B, "mesh": 4}, {}),
    ({}, {}),
    ({"bounds": {}}, {}),
    ({"bounds": {"hull": [0.9, 1.1]}}, {}),
    ({"bounds": {"d_scale": [1.0]}}, {}),
    ({"bounds": {"d_scale": [1.1, 0.9]}}, {}),
    ({"bounds": {"d_scale": [0.9, math.inf]}}, {}),
    ({"bounds": B, "objective": {"metric": "max"}}, {}),
    ({"bounds": B, "objective": {"metric": "std", "dof": 7}}, {}),
    ({"bounds": B, "method": "sgd"}, {}),
    ({"bounds": B, "nIter": 0}, {}),
    ({"bounds": B, "nIter": 201}, {}),
    ({"bounds": B, "nlanes": "x"}, {}),
    ({"bounds": B, "seed": -1}, {}),
    ({"bounds": B, "lr": 0}, {}),
    ({"bounds": B, "gtol": float("nan")}, {}),
    ({"bounds": B, "tol": "x"}, {}),
    ({"bounds": B, "nlanes": 100}, {"lanes_max": 64}),
    ({"bounds": B, "steps": 500}, {"steps_max": 200}),
]


def _call(fn, err_cls, spec, kw):
    try:
        return "ok", fn(spec, **kw)
    except err_cls as e:
        return type(e).__name__, (str(e), e.ctx)


@pytest.mark.parametrize("spec, kw", SPECS)
def test_normalize_request_is_the_jax_packages(spec, kw):
    got = _call(opt.normalize_request, errors.RaftError, spec, kw)
    want = _call(jopt.normalize_request, jerrors.RaftError, spec, kw)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert json.dumps(got[1], sort_keys=True) == \
            json.dumps(want[1], sort_keys=True)
    else:
        assert got[1] == want[1]
