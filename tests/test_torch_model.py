"""The whole slice: the port's Model against the JAX package's results.

1. Golden ledgers: the port's ``Model`` runs both golden configurations
   (OC3spar and VolturnUS-S, 0.02-0.2 Hz, first case) on the CPU and its
   ``last_ledger`` is diffed with the port's ``ledger.diff`` against the
   committed ``tests/golden/*.ledger.json`` — the JAX package's own output
   — at relative 1e-6 with the solver residuals at 0.5 (as
   tools/golden_gate.py does; a residual that came out below the golden
   one at the machine floor is an improvement, not a regression — see
   ``ledger.blocking_regressions``), no added or removed metrics, and the
   integer iteration counts (statics Newton, drag fixed point) exactly.
2. A live JAX-vs-port run of the run_raft extras on OC3spar at the golden
   grid: the unloaded offset, the calcOutputs properties and the
   solveEigen frequencies.
"""
import os

import numpy as np
import pytest

from raft_tpu_torch import Model, ledger
from raft_tpu_torch.io.designs import load_design

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GRID = {"min_freq": 0.02, "max_freq": 0.2}


def _golden_design(name):
    d = load_design(name)
    d["settings"].update(GRID)
    d["cases"]["data"] = d["cases"]["data"][:1]
    return d


def _metrics(led):
    return {e["key"]: e["metrics"] for e in led["entries"]}


@pytest.mark.parametrize("name,fname", [
    ("OC3spar", "oc3spar_coarse.ledger.json"),
    ("VolturnUS-S", "volturnus_coarse.ledger.json")])
def test_golden_ledger(name, fname):
    model = Model(_golden_design(name), device="cpu")
    model.analyzeCases()
    gold = ledger.load_ledger(os.path.join(GOLDEN, fname))
    live = model.last_ledger
    assert live["schema"] == gold["schema"]
    rep = ledger.diff(gold, live, tol_rel=1e-6,
                      per_metric={"*_residual*": 0.5})
    assert not ledger.blocking_regressions(rep), ledger.format_diff(rep)
    assert not rep["added"] and not rep["removed"]
    g, m = _metrics(gold), _metrics(live)
    assert set(g) == set(m)
    for key in g:
        assert set(g[key]) == set(m[key]), key
    assert m["case0/system"]["statics_iters"] == \
        g["case0/system"]["statics_iters"]
    assert m["case0/fowt0"]["drag_iters"] == g["case0/fowt0"]["drag_iters"]
    assert m["case0/fowt0"]["drag_converged"] == \
        g["case0/fowt0"]["drag_converged"]


def test_golden_ledger_mixed():
    """OC3spar's golden under RAFT_TPU_PRECISION=mixed: the ladder (K3 in
    the drag fixed point, K4 in inv_complex; their plain versions here)
    reproduces the f64 golden at 1e-6 with the iteration counts exact."""
    from raft_tpu_torch import _config
    from raft_tpu_torch.ops import linalg

    _config.set_precision_mode("mixed")
    try:
        model = Model(_golden_design("OC3spar"), device="cpu")
        model.analyzeCases()
        disp = linalg.last_dispatch()
    finally:
        _config.set_precision_mode(None)
    assert disp["precision"] == "mixed" and disp["kernel"] == "gj_solve_mixed"
    assert disp["factor_width"] == "f32"
    gold = ledger.load_ledger(os.path.join(GOLDEN,
                                           "oc3spar_coarse.ledger.json"))
    live = model.last_ledger
    rep = ledger.diff(gold, live, tol_rel=1e-6,
                      per_metric={"*_residual*": 0.5})
    assert not ledger.blocking_regressions(rep), ledger.format_diff(rep)
    assert not rep["added"] and not rep["removed"]
    g, m = _metrics(gold), _metrics(live)
    for key in ("statics_iters",):
        assert m["case0/system"][key] == g["case0/system"][key]
    for key in ("drag_iters", "drag_converged"):
        assert m["case0/fowt0"][key] == g["case0/fowt0"][key]


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_run_raft_extras_match_jax():
    """analyzeUnloaded -> calcOutputs -> solveEigen on both packages
    (the run_raft extras; the case loop is covered by the goldens)."""
    from raft_tpu.io.designs import load_design as j_load
    from raft_tpu.model import Model as JModel

    d = j_load("OC3spar")
    d["settings"].update(GRID)
    jm = JModel(d)
    jm.analyzeUnloaded()
    jm.calcOutputs()
    j_fn, _ = jm.solveEigen()

    tm = Model(_golden_design("OC3spar"), device="cpu")
    tm.analyzeUnloaded()
    tm.calcOutputs()
    t_fn, _ = tm.solveEigen()

    jp, tp = jm.results["properties"], tm.results["properties"]
    assert _rel(tp["offset_unloaded"], jp["offset_unloaded"]) < 1e-8
    assert set(jp) == set(tp)
    for key in jp:
        if key == "offset_unloaded":
            continue
        assert _rel(tp[key], jp[key]) < 1e-10, key
    assert _rel(t_fn, j_fn) < 1e-10
    assert tm._case_records["unloaded"]["statics_iters"] == \
        jm._case_records["unloaded"]["statics_iters"]
