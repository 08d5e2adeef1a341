"""(f2), two FOWTs on a shared mooring, through the port's ``Model`` in
array mode against the JAX package's goldens.

The shipped two-turbine rows of ``VolturnUS-S_farm.yaml`` (1600 m apart,
``heading_adjust`` 180 and 0, no mooring of their own) on the stand-in
shared mooring ``tests/golden/farm/shared_mooring_standin.dat`` (7 lines,
2 free buoys; the file the YAML names is not in the repository), on the
coarse grid 0.005-0.1 Hz.  Held against ``tests/golden/farm/
f2_coarse.*`` (``tests/golden/farm_golden.py``, the JAX package's host
statics backend):

- the physics record (both FOWTs' DOF statistics and rotor channels, the
  12 mean offsets, the mean and std tension of all 14 line ends through
  the coupled tension Jacobian) at 1e-6, the counts exact, the
  ``statics_residual`` at the rounding floor held one-sided (ROADMAP C7);
- the free points and the coupled (12, 12) stiffness ``_K_array`` at the
  case's equilibrium at 1e-9;
- ``Model.sweep_farm`` on eight seeded cases after the case (its
  per-turbine stiffness takes ``_K_array``'s diagonal blocks): the
  response std and the wake outputs at 1e-6, every count exact.
No JAX model runs here: the goldens were written once by the JAX package.
"""
import json
import os
import warnings

import numpy as np
import pytest

from raft_tpu_torch.model import run_raft
from raft_tpu_torch.models import farm_cases as FC
from raft_tpu_torch.models import mhk_cases as MC

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "farm")
TOL = 1e-6
ARRAY_TOL = 1e-9


def _load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def f2_model():
    return run_raft(FC.f2_design(FC.GRID), device="cpu")


def test_f2_matches_its_record(f2_model):
    m = f2_model
    assert (m.nFOWT, m.nDOF) == (2, 12)
    assert m.arr_ms.n_free == 2 and m.arr_ms.n_lines == 7
    assert all(f.mooring is None for f in m.fowtList)
    gold = _load("f2_coarse.metrics.json")
    live = FC.farm_records(m.results, m.last_ledger)
    rel, same = MC.case_records_deviation(gold, live)
    assert rel <= TOL and same, rel
    ratio, held = MC.residual_held(gold, live)
    assert held, ratio
    if gold["ledger_golden"]:
        chk = MC.ledger_golden_check(_load("f2_coarse.ledger.json"),
                                     m.last_ledger)
        assert not chk["blocking"] and chk["iters_ok"], chk
    arr = m.results["case_metrics"][0]["array_mooring"]
    assert arr["Tmoor_avg"].shape == (14,) and arr["Tmoor_PSD"].shape == \
        (14, m.nw)
    assert np.all(arr["Tmoor_avg"] > 0) and np.all(arr["Tmoor_std"] > 0)


def test_f2_free_points_and_array_stiffness(f2_model):
    assert FC.array_deviation(_load("f2_coarse.array.json"),
                              FC.array_record(f2_model)) <= ARRAY_TOL
    # the coupled system: the shared line ties FOWT 1's surge to FOWT 2's
    K = f2_model._K_array.numpy()
    assert K.shape == (12, 12) and abs(K[0, 6]) > 1e3


def test_f2_model_sweep_farm(f2_model):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the farm mixes headings
        out = f2_model.sweep_farm(cases=FC.f3_cases(8, seed=1))
    rel, same = FC.sweep_deviation(_load("f2_coarse.sweep.json"),
                                   FC.sweep_record(out))
    assert rel <= TOL and same, rel
    assert tuple(out["std"].shape) == (2, 8, 6)
    assert f2_model.results["farm"]["U_wake"].shape == (2, 8)
