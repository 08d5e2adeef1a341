"""The port's batched Adam descent against the JAX package's, on the
small cylinder.

``tests/golden/descent/cylinder.json`` (``tests/golden/descent_golden.py``)
holds ``tests/test_optimize.py``'s lane-isolation call of the JAX
package's ``optimize_designs`` (``Vertical_cylinder`` at 2 bins, std,
x0 [[1, 1], [nan, 1], [0.95, 1.02]], Adam, 3 steps, lr 0.03), stepped by
``descend.segment(carry, 1)``.  The port runs the same call through
``optimize_designs`` (the result), and its descent step by step through
``make_descent``'s own ``segment`` (``models/descent_cases.stepped``: the
per-step facts), on the CPU:

- x, the objective and its trace at 1e-9 relative, the gradient norms at
  1e-7, the steps counted, the masks and the best lane exactly, NaN in
  the NaN lane where the JAX package has NaN (``descent_cases.
  deviations``, ``CPU_BARS``);
- the NaN lane frozen and counted, the others finite; one gradient a
  step, read from ``optimize_designs``' ``descent_step`` spans.

The all-NaN batch is in ``tests/test_torch_optimize_request.py``.
"""
import numpy as np
import pytest

from raft_tpu_torch import obs
from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.obs import tracing
from raft_tpu_torch.parallel import optimize as opt

GOLD = DC.load("cylinder")


@pytest.fixture(scope="module")
def cyl():
    return DC.build(GOLD["adam"], "cpu")


@pytest.fixture(scope="module")
def adam_run(cyl):
    rec = GOLD["adam"]
    before = obs.counter_total("raft_tpu_optimize_grad_nonfinite_total")
    n0 = len(tracing.spans())
    res = opt.optimize_designs(*cyl, **DC.call_kwargs(rec))
    steps, _ = DC.spans_since(n0)
    counted = obs.counter_total(
        "raft_tpu_optimize_grad_nonfinite_total") - before
    return rec, res, DC.stepped(*cyl, rec), steps, counted


def test_adam_descent_matches_the_jax_package(adam_run):
    rec, res, facts, _, _ = adam_run
    dev = DC.deviations(rec, res, facts)
    assert not DC.failures(dev, DC.CPU_BARS), dev
    assert res["design"] == pytest.approx(rec["result"]["design"],
                                          rel=DC.CPU_BARS["value"])
    assert res["f_best"] == pytest.approx(rec["result"]["f_best"],
                                          rel=DC.CPU_BARS["value"])


def test_the_nan_lane_is_frozen_and_counted(adam_run):
    rec, res, facts, steps, counted = adam_run
    assert res["nonfinite"].tolist() == [False, True, False]
    assert np.isnan(res["objective"][1]) and np.isnan(res["x"][1, 0])
    assert np.all(np.isfinite(res["objective"][[0, 2]]))
    assert res["iters"].tolist() == [3, 0, 3]
    assert res["lane_best"] in (0, 2)
    assert res["provenance"]["grad_nonfinite"] == 1 and counted == 1
    # one gradient a step, no linesearch
    assert [s["gradients"] for s in steps] == [1, 1, 1]
    assert all(s["linesearch_trials"] == 0 for s in steps)
