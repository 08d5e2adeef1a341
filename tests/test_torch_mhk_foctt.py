"""FOCTT_example (a model-scale current turbine: the rotor driven by the
current under ``aeroServoMod: 2``) in the port, against the committed
goldens of ``tests/golden/mhk_golden.py`` on the coarse golden grid.

No statics Newton of this design converges as shipped, in the JAX
package or here (ROADMAP C8), so it is held in parts:

- (m2a) the build and the shipped case's constants at the zero pose
  (members with the blade members, ``fowt_statics``,
  ``fowt_hydro_constants``, ``fowt_turbine_constants``, the cavitation
  array) against ``foctt_build_coarse.json`` at 1e-9, and the cavitation
  arrays at both settings against ``foctt_cavitation.json``;
- (m2b) the one case found on which both JAX statics backends converge
  (``mhk_cases.M2B_CASE``) through the port's Model against its golden,
  with the control channels of the current-driven rotor;
- the shipped case runs to its end with finite outputs; its statics stop
  at the 50-iteration cap, as in the JAX package.
"""
import json
import os
import warnings

import numpy as np
import pytest

from raft_tpu_torch.model import Model
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import mhk_cases as MC
from raft_tpu_torch.models import rotor as TR

from test_torch_mhk import GOLDEN, _case0, _grid_w, check_golden


def _json(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def foctt():
    d = MC.foctt_design(MC.GRID)
    return d, TF.build_fowt(d, _grid_w(d), depth=float(
        d["site"]["water_depth"]), device="cpu")


def test_foctt_build_record(foctt):
    """(m2a) the build and the shipped case's constants at 1e-9."""
    d, tf = foctt
    case = _case0(d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cav = TR.calc_cavitation(tf.rotors[0], case)
    live = MC.build_record(tf, TF, TR, case, cav)
    rel, bad = MC.record_deviation(_json("foctt_build_coarse.json"), live)
    assert not bad and rel <= MC.RECORD_TOL, (rel, bad)
    assert live["member_names"].count("blade") == \
        len(tf.rotors[0].azimuths) * (len(tf.rotors[0].blade_r) - 1)


@pytest.mark.parametrize("which", ["shipped", "m2b"])
def test_foctt_cavitation(foctt, which):
    d, tf = foctt
    case = _case0(d if which == "shipped" else MC.foctt_design(
        MC.GRID, **MC.M2B_CASE))
    gold = _json("foctt_cavitation.json")[which]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for key, kw in (("default", {}), ("Pvap_3e5", {"Pvap": 3e5})):
            cav = TR.calc_cavitation(tf.rotors[0], case, **kw)
            ref = np.asarray(gold[key])
            assert np.max(np.abs(cav - ref)) <= 1e-9 * np.max(np.abs(ref))


def test_foctt_current_golden():
    """(m2b) the converging case through the port's Model."""
    m = Model(MC.foctt_design(MC.GRID, **MC.M2B_CASE), device="cpu")
    m.analyzeUnloaded()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.analyzeCases()
    check_golden(m, "foctt_current")
    cm = m.results["case_metrics"][0][0]
    assert cm["omega_avg"][0] > 0 and np.isfinite(cm["omega_std"][0])
    assert cm["surge_std"] > 0 and "cavitation" in cm


def test_foctt_shipped_case_runs_to_its_end():
    """The shipped case finishes with finite outputs; its statics stop at
    the iteration cap (ROADMAP C8), and that is reported, not raised."""
    m = Model(MC.foctt_design(MC.GRID), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.analyzeCases()
    rec = m._case_records["0"]
    print(f"FOCTT shipped case: statics_iters {rec['statics_iters']}, "
          f"statics_residual {rec['statics_residual']:.4e} N")
    assert rec["statics_iters"] == Model._NEWTON_MAX_ITERS
    cm = m.results["case_metrics"][0][0]
    assert np.all(np.isfinite(m.results["mean_offsets"][0]))
    for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"):
        assert np.isfinite(cm[f"{ch}_std"])
