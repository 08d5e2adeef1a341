"""First-order potential flow through the port's Model on OC4semi at full
width (its 80-bin grid and first case), from the committed WAMIT cache of
the JAX package's native-BEM solve (``tests/golden/oc4semi_bem/``).

- (a) ``potModMaster: 2`` reproduces ``oc4semi_bem.ledger.json`` under
  ``chip_smoke.py``'s golden rule (1e-6, solver residuals 0.5 as
  ``ledger.blocking_regressions`` reads them, no metric added or removed,
  iteration counts exact).  The build must hit the cache: a miss would
  mean the mesher or the key drifted, so the solve itself raises here.
- (b) ``potModMaster: 3`` on the cache's files equals (a) at 1e-12.
- ``potFirstOrder: 1`` with the YAML's own per-member ``potMod`` flags
  (``potModMaster: 0``: BEM on the columns, strip theory on the pontoons
  and braces): the built model's flags, coefficients, strip-theory added
  mass and excitation and BEM excitation against the JAX package's at
  1e-12.
- (c) (a) plus ``potSecOrder: 1`` on ``examples/example_qtf.py``'s
  second-order grid against ``oc4semi_bem_qtf.metrics.json`` at 1e-6
  with the iteration counts exact.  Its ``statics_residual`` sits at the
  rounding floor of the force sum (ROADMAP C7) and is reported, not held.
- A MacCamy-Fuchs member builds: the spar's (N, 3, 3, nw) inertia
  coefficient against the JAX package's at 1e-12.  The ballast trim
  runs on the spar and still refuses a platform with no ballast volume.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from raft_tpu.io.designs import load_design as jload
from raft_tpu.models import fowt as JF

from raft_tpu_torch import errors, ledger
from raft_tpu_torch.io import bem_native as TB
from raft_tpu_torch.model import Model
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import potflow_cases as PC

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CACHE = os.path.join(GOLDEN, "oc4semi_bem")
ITERS = ("statics_iters", "drag_iters", "drag_converged")


def _no_solve(*a, **k):
    raise AssertionError("the committed OC4semi cache missed: the mesher "
                         "or the cache key drifted from the JAX package's")


@pytest.fixture(scope="module")
def cache_copy(tmp_path_factory):
    """A copy of the committed cache: a run never rewrites the original."""
    d = tmp_path_factory.mktemp("oc4semi_bem") / "cache"
    shutil.copytree(CACHE, d)
    return d


def _run(design):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TB, "solve_radiation_diffraction", _no_solve)
        m = Model(design, device="cpu")
    m.analyzeUnloaded()
    m.analyzeCases()
    return m


@pytest.fixture(scope="module")
def bem_model(cache_copy):
    return _run(PC.oc4semi_bem_design(cache_copy))


def _entries(doc):
    return {e["key"]: e["metrics"] for e in doc["entries"]}


def test_oc4semi_bem_golden(bem_model):
    """(a) under chip_smoke.py's _golden_check rule."""
    m = bem_model
    assert m.fowtList[0].bem is not None and m.nw == 80
    gold = ledger.load_ledger(os.path.join(GOLDEN, "oc4semi_bem.ledger.json"))
    rep = ledger.diff(gold, m.last_ledger, tol_rel=1e-6,
                      per_metric={"*_residual*": 0.5})
    assert not ledger.blocking_regressions(rep), ledger.format_diff(rep)
    assert not rep["added"] and not rep["removed"]
    gm, lm = _entries(gold), _entries(m.last_ledger)
    for key in gm:
        for it in ITERS:
            if it in gm[key]:
                assert lm[key][it] == gm[key][it], (key, it)
    # A support structure: Morison plus the BEM added mass at the top bin
    props = m.calcOutputs()["properties"]
    np.testing.assert_array_equal(
        props["A support structure"],
        props["A matrix"] + m.fowtList[0].bem.A_BEM[:, :, -1].numpy())


def test_oc4semi_from_wamit_files_equals_bem_run(bem_model, cache_copy):
    """(b): the same physics read from the files the solve wrote."""
    m = _run(PC.oc4semi_wamit_design(cache_copy / "Output"))
    assert all(g.potMod for g in m.fowtList[0].members[:m.fowtList[0]
                                                      .nplatmems])
    rep = ledger.diff(bem_model.last_ledger, m.last_ledger, tol_rel=1e-12,
                      per_metric={"*": 1e-12})
    assert rep["ok"], ledger.format_diff(rep)
    a, b = _entries(bem_model.last_ledger), _entries(m.last_ledger)
    for key in a:
        for it in ITERS:
            if it in a[key]:
                assert a[key][it] == b[key][it], (key, it)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_pot_first_order_with_yaml_potmod_flags_matches_jax():
    """potFirstOrder: 1 under potModMaster: 0 keeps the YAML's flags: the
    columns take the file's coefficients and the other members keep
    their strip-theory hydro, in both packages."""
    d = jload("OC4semi")
    d["platform"].update(potModMaster=0, potFirstOrder=1,
                         hydroPath=os.path.join(CACHE, "Output"))
    w = np.arange(0.005, 0.4025, 0.005) * 2 * np.pi
    depth = float(d["site"]["water_depth"])
    jf = JF.build_fowt(d, w, depth=depth)
    tf = TF.build_fowt(d, w, depth=depth, device="cpu")
    flags = [m.potMod for m in tf.members]
    assert flags == [m.potMod for m in jf.members]
    assert any(flags) and not all(flags[:tf.nplatmems])
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        assert _rel(getattr(tf.bem, k), getattr(jf.bem, k)) < 1e-12, k
    r6 = np.zeros(6)
    tp, jp = TF.fowt_pose(tf, r6), JF.fowt_pose(jf, r6)
    thc, jhc = TF.fowt_hydro_constants(tf, tp), JF.fowt_hydro_constants(jf, jp)
    assert _rel(thc["A_hydro_morison"], jhc["A_hydro_morison"]) < 1e-12
    case = dict(zip(d["cases"]["keys"], d["cases"]["data"][0]))
    ts, js = TF.build_seastate(tf, case), JF.build_seastate(jf, case)
    tex = TF.fowt_hydro_excitation(tf, tp, ts, thc)
    jex = JF.fowt_hydro_excitation(jf, jp, js, jhc)
    assert _rel(tex["F_hydro_iner"], jex["F_hydro_iner"]) < 1e-12
    assert _rel(TF.fowt_bem_excitation(tf, ts),
                JF.fowt_bem_excitation(jf, js)) < 1e-12


def test_oc4semi_bem_qtf_matches_jax_metrics(cache_copy):
    """(c): the physics record at 1e-6, iteration counts exact."""
    m = _run(PC.oc4semi_bem_qtf_design(cache_copy))
    with open(os.path.join(GOLDEN, "oc4semi_bem_qtf.metrics.json")) as f:
        ref = json.load(f)
    live = PC.metrics_record(m.results, m.last_ledger)
    rel, iters_equal = PC.metrics_deviation(ref, live)
    print(json.dumps({"statics_residual": {
        "port": live["statics_residual"], "jax_host": ref["statics_residual"],
        "jax_default": ref["statics_residual_default"]}, "max_rel": rel}))
    assert iters_equal, (ref["iters"], live["iters"])
    assert rel <= PC.METRICS_TOL


@pytest.mark.parametrize("what", ["ballast"])
def test_still_refused(what):
    """The ballast trim (ROADMAP A1) runs on the spar, the density shift
    zeroing its linearized heave, and still refuses a platform with no
    ballast volume."""
    d = PC.spar_design(1)
    m = Model(d, device="cpu")
    m.analyzeUnloaded(ballast=2)
    assert m.ballast_trim["delta_rho"] != 0.0
    assert abs(m._heave_imbalance(m.fowtList[0])[1]) < 1e-9
    d["platform"]["members"][0]["l_fill"] = [0.0]
    with pytest.raises(errors.ModelConfigError, match="ballast"):
        Model(d, device="cpu").analyzeUnloaded(ballast=2)


def test_mcf_spar_builds_and_matches_jax_imat():
    """A MacCamy-Fuchs member, refused until ROADMAP A4, builds on the
    spar: its (N, 3, 3, nw) complex inertia coefficient equals the JAX
    package's at 1e-12, and it depends on the frequency."""
    d = PC.spar_design(1)
    d["platform"]["members"][0]["MCF"] = True
    m = Model(d, device="cpu")
    fowt = m.fowtList[0]
    assert fowt.members[0].MCF
    jf = JF.build_fowt(d, m.w, depth=float(d["site"]["water_depth"]))
    hc = TF.fowt_hydro_constants(fowt, TF.fowt_pose(fowt, np.zeros(6)))
    jhc = JF.fowt_hydro_constants(jf, JF.fowt_pose(jf, np.zeros(6)))
    got, ref = hc["Imat"].numpy(), np.asarray(jhc["Imat"])
    assert got.shape == ref.shape == (fowt.nodes.n, 3, 3, m.nw)
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert np.ptp(np.abs(got), axis=-1).max() > 0
