"""The port's batched L-BFGS descent against the JAX package's, on the
small cylinder.

``tests/golden/descent/cylinder.json``'s ``lbfgs`` record
(``tests/golden/descent_golden.py``) holds the JAX package's
``optimize_designs`` with optax's L-BFGS and zoom linesearch
(``_make_optimizer``: memory 8, at most 8 linesearch steps) on
``Vertical_cylinder`` at 2 bins, std, 2 lanes from (1, 1) and
(0.95, 1.02), 2 steps, over the box d_scale 0.5-1.5, moor_L 0.8-1.2,
stepped by ``descend.segment(carry, 1)``.  The port runs the same call
through ``optimize_designs`` on the CPU (the result and its
``descent_step`` spans), and step by step through ``make_descent``'s own
``segment`` (the per-step facts):

- x, the objective, its trace and each step's linesearch step size at
  1e-9 relative, the gradient norms at 1e-7, the steps counted, the
  masks, the best lane and each step's linesearch steps exactly;
- the batch's linesearch runs until its last live lane is done: each
  step takes one gradient and one more per linesearch iteration (the
  most steps of a lane the step does not freeze), and one step takes two
  or more;
- the counted host pulls by ``what``: the fixed points' chunk pulls of
  each gradient, one per linesearch loop test, one summary.
"""
import numpy as np
import pytest

from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.obs import tracing
from raft_tpu_torch.parallel import optimize as opt

REC = DC.load("cylinder")["lbfgs"]


@pytest.fixture(scope="module")
def run():
    base, space = DC.build(REC, "cpu")
    before = DC.pulls_by_what()
    n0 = len(tracing.spans())
    res = opt.optimize_designs(base, space, **DC.call_kwargs(REC))
    pulls = DC.pulls_between(before, DC.pulls_by_what())
    steps, _ = DC.spans_since(n0)
    return res, DC.stepped(base, space, REC), steps, pulls


def test_lbfgs_descent_matches_the_jax_package(run):
    res, facts, _, _ = run
    dev = DC.deviations(REC, res, facts)
    assert not DC.failures(dev, DC.CPU_BARS), dev


def test_linesearch_trials_are_the_slowest_lanes(run):
    res, facts, steps, _ = run
    trials = DC.expected_trials(REC)
    assert trials == [int(np.max(f["ls_steps"])) for f in facts]
    assert [s["linesearch_trials"] for s in steps] == trials
    assert [s["gradients"] for s in steps] == [1 + t for t in trials]
    assert max(trials) >= 2
    # at least one lane ends inside the box (the record is not the clip)
    lo, hi = REC["space"]["lower"], REC["space"]["upper"]
    assert any(all(lo[j] < v < hi[j] for j, v in enumerate(x))
               for x in res["x"])


def test_host_pulls_by_what(run):
    res, facts, steps, pulls = run
    grads = sum(s["gradients"] for s in steps) + 1          # + finalize
    tests = sum(s["linesearch_trials"] + 1 for s in steps)
    assert pulls == DC.expected_pulls(REC, grads, ls_tests=tests)
