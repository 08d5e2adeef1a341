"""(f1), the four-turbine farm on individual moorings, through the port's
``Model`` in array mode against the JAX package's goldens.

``VolturnUS-S_farm.yaml`` on its own four-turbine layout
(``farm_cases.f1_design``) on the coarse grid 0.005-0.1 Hz: 4 FOWTs, 24
DOFs, the (20, 24, 24) system solved by LU.  ``run_raft`` runs it as the
JAX package runs a farm (``Model`` -> ``analyzeCases``; the reference has
no unloaded statics and no properties for an array).  Held against
``tests/golden/farm/f1_coarse.*`` (``tests/golden/farm_golden.py``, the
JAX package's host statics backend):

- the ledger golden at 1e-6 with every iteration count exact; the
  ``statics_residual`` band's verdict is reported, the residual being at
  the rounding floor of the force sum (ROADMAP C7) and held one-sided at
  ``mhk_cases.RESIDUAL_FACTOR`` times the larger JAX backend's;
- the physics record: every FOWT's DOF statistics, tensions and rotor
  channels, the 24 mean offsets, at 1e-6, the counts exact;
- the array-mode refusals that stay: ``analyzeUnloaded`` (one FOWT only,
  as the reference) and an ``array_mooring`` without a file.
No JAX model runs here: the goldens were written once by the JAX package.
"""
import json
import os

import numpy as np
import pytest

from raft_tpu_torch import errors
from raft_tpu_torch.model import Model, run_raft
from raft_tpu_torch.models import farm_cases as FC
from raft_tpu_torch.models import mhk_cases as MC

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "farm")
TOL = 1e-6


def _load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def held_against_goldens(model, stem):
    """(record deviation, counts equal, residual ratio, residual held,
    ledger check or None) of a finished farm run against its goldens."""
    gold = _load(f"{stem}.metrics.json")
    live = FC.farm_records(model.results, model.last_ledger)
    rel, same = MC.case_records_deviation(gold, live)
    ratio, held = MC.residual_held(gold, live)
    chk = None
    if gold["ledger_golden"]:
        chk = MC.ledger_golden_check(_load(f"{stem}.ledger.json"),
                                     model.last_ledger)
    return rel, same, ratio, held, chk


@pytest.fixture(scope="module")
def f1_model():
    return run_raft(FC.f1_design(FC.GRID), device="cpu")


def test_f1_matches_its_goldens(f1_model):
    m = f1_model
    assert (m.nFOWT, m.nDOF, m.nw) == (4, 24, 20)
    assert [f.heading_adjust for f in m.fowtList] == [0.0, 0.0, 0.0, 180.0]
    assert m.arr_ms is None and m._K_array is None
    rel, same, ratio, held, chk = held_against_goldens(m, "f1_coarse")
    assert rel <= TOL and same, rel
    assert held, ratio
    assert chk is not None and not chk["blocking"] and chk["iters_ok"], chk
    # every FOWT has its own entry, its own mooring tensions and rotor
    cm = m.results["case_metrics"][0]
    assert sorted(k for k in cm if isinstance(k, int)) == [0, 1, 2, 3]
    for i in range(4):
        assert cm[i]["Tmoor_avg"].shape == (6,)
        assert cm[i]["power_avg"][0] > 1e6
    assert m.results["mean_offsets"][0].shape == (24,)
    assert "properties" not in m.results or not m.results["properties"]


def test_f1_eigen_at_24_dofs(f1_model):
    fns, modes = f1_model.solveEigen()
    assert fns.shape == (24,) and modes.shape == (24, 24)
    assert np.all(np.isfinite(fns)) and np.all(fns > 0)
    # four platforms on their own moorings, three alike and one turned by
    # 180 deg: each natural frequency appears three times, and once more
    # for the turned one within 20 per cent
    f = np.sort(fns).reshape(6, 4)
    assert np.max(np.abs(f[:, :3] - f[:, :1]) / f[:, :1]) < 1e-9
    assert np.max(np.abs(f[:, 3:] - f[:, :1]) / f[:, :1]) < 0.2


def test_array_refusals_that_stay():
    d = FC.f1_design(FC.GRID)
    d["array"]["data"] = d["array"]["data"][:2]
    m = Model(d, device="cpu")
    with pytest.raises(errors.ModelConfigError, match="single FOWT"):
        m.analyzeUnloaded()
    d2 = FC.f2_design(FC.GRID)
    d2["array_mooring"] = {}
    with pytest.raises(errors.ModelConfigError, match="file"):
        Model(d2, device="cpu")
