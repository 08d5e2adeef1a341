"""MacCamy-Fuchs members through the port's Model on the coarse golden
grid (0.02-0.2 Hz, 10 bins) against the JAX package's goldens
(``tests/golden/mcf_golden.py``), OC4semi with ``MCF: True`` on its
circular columns (``models/mcf_cases.py``):

- (c1) strip theory, its one case, through ``run_raft``;
- (c2) (c1) under ``potSecOrder: 1`` (second-order grid 0.02-0.16 Hz,
  8 bins): the slender-body QTF plus the Kim & Yue correction.

Each is held by its physics record (every case's metrics at 1e-6, the
iteration counts exact, the statics residual one-sided at most
``mhk_cases.RESIDUAL_FACTOR`` times the larger JAX backend's); (c2) also
by its ledger golden (``mcf_cases.LEDGER_STEMS``).  (c1) has none: its
``dyn_solve_residual`` sits at the machine floor (``mcf_cases.NO_LEDGER``,
ROADMAP C3) and is printed beside the JAX package's two backends'.
Then (c3): ``sweep_cases`` on (c1)'s FOWT, whose excitation takes the
(N, 3, 3, nw) inertia coefficient with the case axis, against the serial
solve at 1e-9.
"""
import json

import numpy as np
import pytest
import torch

from raft_tpu_torch import run_raft
from raft_tpu_torch.models import mcf_cases as FC
from raft_tpu_torch.models import mhk_cases as MC
from raft_tpu_torch.models import qtf as TQ

from test_torch_mhk import GOLDEN, check_golden


@pytest.fixture(scope="module")
def c1():
    return run_raft(FC.mcf_design(coarse=True), device="cpu")


def test_mcf_strip_theory_matches_golden(c1):
    assert c1.nw == 10
    assert c1._state[0]["hydro0"]["Imat"].dim() == 4
    check_golden(c1, "oc4semi_mcf", FC.LEDGER_STEMS)
    with open(MC.golden_file(GOLDEN, "oc4semi_mcf", coarse=True)) as f:
        gold = json.load(f)
    print(json.dumps({"dyn_solve_residual": {
        "port": c1._case_records["0"]["dyn_solve_residual"],
        "jax_host": gold["dyn_solve_residual_host"],
        "jax_default": gold["dyn_solve_residual_default"]},
        "no_ledger_golden": FC.NO_LEDGER["oc4semi_mcf"]}))


def test_mcf_under_the_qtf_matches_golden():
    m = run_raft(FC.mcf_qtf_design(coarse=True), device="cpu")
    fowt = m.fowtList[0]
    assert len(fowt.w1_2nd) == 8
    check_golden(m, "oc4semi_mcf_qtf", FC.LEDGER_STEMS)
    # the four MCF columns pierce the surface: the correction is not zero
    ky = TQ.kim_yue_correction(fowt, m._state[0]["pose0"], 0.0)
    assert float(torch.max(torch.abs(ky))) > 0


def test_sweep_cases_on_the_mcf_platform(c1):
    from raft_tpu_torch.parallel.sweep import make_case_solver

    fowt = c1.fowtList[0]
    Hs, Tp, beta = FC.sweep_inputs(6)
    solver = make_case_solver(fowt, nIter=FC.SWEEP_NITER, tol=0.01)
    out = solver.batched(Hs, Tp, beta)
    assert out["Xi"].shape == (6, 6, fowt.nw)
    assert bool(torch.all(torch.isfinite(out["std"])))
    for i in (0, 3, 5):
        ser = solver(Hs[i], Tp[i], beta[i])
        np.testing.assert_allclose(out["Xi"][i].numpy(), ser["Xi"].numpy(),
                                   rtol=1e-9, atol=1e-12)
