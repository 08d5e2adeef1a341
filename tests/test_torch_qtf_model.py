"""The port's Model with second-order wave loads against the JAX package's.

1. ``potSecOrder: 1`` on a coarse Vertical_cylinder (0.02-0.2 Hz, second-
   order grid 0.02-0.16 Hz) with two JONSWAP headings (0 and 30 deg):
   heading 0 runs the QTF, the warm-started fixed point and the drift
   statics re-solve, heading 30 the per-heading QTF and the re-solve
   through the factored impedance.  The port (CPU) against
   ``raft_tpu.Model``: case metrics at 1e-6, the mean offset after the
   drift re-solve at 1e-6, the iteration counts exact.  The JAX side runs
   once, in a module-scoped fixture.
2. ``potSecOrder: 2`` from a ``.12d`` that the JAX writer puts in
   ``tmp_path`` (the QTF of run 1): port against JAX at 1e-6.
3. The OC4semi example (``examples/example_qtf.py``: 80 bins, second-
   order grid 0.005-0.15 Hz, 30 bins) through ``run_raft`` on the CPU
   against ``tests/golden/oc4semi_qtf.ledger.json`` — the JAX package's
   ledger — at 1e-6, solver residuals at 0.5 (as the other goldens), the
   iteration counts exact.  No JAX run.
"""
import os

import numpy as np
import pytest

from raft_tpu.io.designs import load_design as j_load
from raft_tpu.model import Model as JModel
from raft_tpu.models import qtf as JQ

from raft_tpu_torch import Model, ledger, run_raft
from raft_tpu_torch.io.designs import load_design
from raft_tpu_torch.models.qtf_cases import (cylinder_two_headings,
                                             oc4semi_design)

TOL = 1e-6
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CHANS = ("surge", "sway", "heave", "roll", "pitch", "yaw")


def vc_design(load, **platform):
    """Vertical_cylinder on the coarse grid with potSecOrder 1 and one
    case of two JONSWAP headings (the vendored case row is 'still')."""
    d = cylinder_two_headings(load("Vertical_cylinder"))
    d["platform"].update(platform)
    return d


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _compare(tm, jm):
    """Case metrics, mean offset and iteration counts, port vs JAX."""
    tc, jc = tm.results["case_metrics"][0][0], jm.results["case_metrics"][0][0]
    for ch in CHANS:
        for stat in ("avg", "std"):
            key = f"{ch}_{stat}"
            assert _rel(tc[key], jc[key]) < TOL, key
        assert _rel(tc[f"{ch}_PSD"], jc[f"{ch}_PSD"]) < TOL, ch
    assert _rel(tc["Tmoor_std"], jc["Tmoor_std"]) < TOL
    assert _rel(tm.results["mean_offsets"], jm.results["mean_offsets"]) < TOL
    assert len(tm.results["mean_offsets"]) == 1
    tr, jr = tm._case_records["0"], jm._case_records["0"]
    assert tr["statics_iters"] == jr["statics_iters"]
    assert tr["fowt0"]["drag_iters"] == jr["fowt0"]["drag_iters"]
    assert tr["fowt0"]["drag_converged"] == jr["fowt0"]["drag_converged"]
    assert len(tr["dyn_solve_residual"]) == len(jr["dyn_solve_residual"])


@pytest.fixture(scope="module")
def jax_two_headings():
    jm = JModel(vc_design(j_load))
    jm.analyzeCases()
    return jm


def test_pso1_two_headings_matches_jax(jax_two_headings):
    jm = jax_two_headings
    tm = Model(vc_design(load_design), device="cpu")
    tm.analyzeCases()
    _compare(tm, jm)
    # the drift moved the operating point, and the QTF is the JAX one
    assert np.max(np.abs(np.asarray(tm._state[0]["Fhydro_2nd_mean"]))) > 0
    tq, jq = np.asarray(tm._state[0]["qtf"]), np.asarray(jm._state[0]["qtf"])
    assert np.max(np.abs(tq - jq)) < 1e-9 * np.max(np.abs(jq))
    for key in ("first_order_fp", "qtf", "second_order_fp", "drift_statics"):
        assert tm.timings[key] > 0.0, key


def test_pso2_from_a_jax_written_12d_matches_jax(jax_two_headings, tmp_path):
    jm1 = jax_two_headings
    fowt = jm1.fowtList[0]
    JQ.write_qtf_12d(str(tmp_path / "vc.12d"), jm1._state[0]["qtf"],
                     fowt.w1_2nd, [0.0], rho=fowt.rho_water, g=fowt.g)
    kw = dict(potSecOrder=2, hydroPath=str(tmp_path / "vc"))
    jm = JModel(vc_design(j_load, **kw))
    jm.analyzeCases()
    tm = Model(vc_design(load_design, **kw), device="cpu")
    assert tm.fowtList[0].qtf_data.qtf.shape == (8, 8, 1, 6)
    tm.analyzeCases()
    _compare(tm, jm)


def test_oc4semi_example_reproduces_the_golden():
    model = run_raft(oc4semi_design(), device="cpu")
    assert model.nw == 80 and len(model.fowtList[0].w1_2nd) == 30
    gold = ledger.load_ledger(os.path.join(GOLDEN, "oc4semi_qtf.ledger.json"))
    live = model.last_ledger
    rep = ledger.diff(gold, live, tol_rel=TOL,
                      per_metric={"*_residual*": 0.5})
    assert not ledger.blocking_regressions(rep), ledger.format_diff(rep)
    assert not rep["added"] and not rep["removed"]
    g = {e["key"]: e["metrics"] for e in gold["entries"]}
    m = {e["key"]: e["metrics"] for e in live["entries"]}
    assert set(g) == set(m)
    assert m["case0/system"]["statics_iters"] == \
        g["case0/system"]["statics_iters"]
    for key in ("drag_iters", "drag_converged"):
        assert m["case0/fowt0"][key] == g["case0/fowt0"][key]
