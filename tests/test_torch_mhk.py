"""Submerged rotors (MHK) in the port: RM1_Floating against the JAX package
and the committed goldens of ``tests/golden/mhk_golden.py`` on the coarse
golden grid (0.02-0.2 Hz, 10 bins).

- ``blade_member_dicts``: member for member against the JAX function at
  1e-12 (nBlades x (nr - 1) rectangular members: ends, chord and
  thickness, added mass, twist), and the built member list;
- ``calc_cavitation`` against the JAX function at 1e-9, at the defaults
  and at ``Pvap=3e5``, and the ``error_on_cavitation`` raise;
- blade members add buoyancy and no structural mass
  (``tests/test_mhk.py:45``);
- (m1) RM1 as shipped plus its JONSWAP case through the port's Model
  against its physics record ``rm1_floating_coarse.metrics.json`` (1e-6,
  iteration counts exact, the statics residual one-sided) and its ledger
  golden ``rm1_floating_coarse.ledger.json``, its per-case cavitation array against
  ``rm1_cavitation.json`` at 1e-9, and a non-zero response in the wave
  case;
- ``sweep_cases`` on RM1's FOWT against the serial solve at 1e-9, and a
  design variant at the base geometry equal to the base.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

from raft_tpu.models import fowt as JF
from raft_tpu.models import rotor as JR

from raft_tpu_torch.model import Model
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import mhk_cases as MC
from raft_tpu_torch.models import rotor as TR

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _grid_w(d):
    s = d["settings"]
    return np.arange(s["min_freq"], s["max_freq"] + 0.5 * s["min_freq"],
                     s["min_freq"]) * 2 * np.pi


def _case0(d):
    return dict(zip(d["cases"]["keys"], d["cases"]["data"][0]))


@pytest.fixture(scope="module")
def rm1():
    d = MC.rm1_design(MC.GRID)
    depth = float(d["site"]["water_depth"])
    return (d, TF.build_fowt(d, _grid_w(d), depth=depth, device="cpu"),
            JF.build_fowt(d, _grid_w(d), depth=depth))


def test_blade_member_dicts_match_jax(rm1):
    _, tf, jf = rm1
    trot, jrot = tf.rotors[0], jf.rotors[0]
    assert trot.hubHt + trot.R_rot < 0
    tb, jb = TR.blade_member_dicts(trot), JR.blade_member_dicts(jrot)
    n = len(np.atleast_1d(jrot.azimuths)) * (len(jrot.blade_r) - 1)
    assert len(tb) == len(jb) == n == jrot.nBlades * (len(jrot.blade_r) - 1)
    for a, b in zip(tb, jb):
        assert (a["name"], a["type"], a["shape"]) == ("blade", 3, "rect")
        assert (a["Cd"], a["potMod"]) == (b["Cd"], b["potMod"]) == (0.0,
                                                                     False)
        for k in ("rA", "rB", "d", "gamma", "Ca"):
            np.testing.assert_allclose(np.asarray(a[k], float),
                                       np.asarray(b[k], float),
                                       rtol=1e-12, atol=1e-12, err_msg=k)
    assert tf.member_names == jf.member_names
    assert tf.member_types == jf.member_types
    assert tf.member_names[-n:] == ["blade"] * n


@pytest.mark.parametrize("kw", [{}, {"Pvap": 3e5}], ids=["default", "Pvap"])
def test_calc_cavitation_matches_jax(rm1, kw):
    d, tf, jf = rm1
    case = _case0(d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cav = TR.calc_cavitation(tf.rotors[0], case, **kw)
        ref = np.asarray(JR.calc_cavitation(jf.rotors[0], case, **kw))
    rot = tf.rotors[0]
    assert cav.shape == (len(rot.azimuths), len(rot.blade_r))
    assert np.max(np.abs(cav - ref)) <= 1e-9 * np.max(np.abs(ref))
    # the operating point does not cavitate; at Pvap = 3e5 it does
    assert bool(np.all(cav > 0)) == (not kw)


def test_cavitation_error_and_warning(rm1):
    d, tf, _ = rm1
    case = _case0(d)
    with pytest.warns(UserWarning, match="[Cc]avitation"):
        TR.calc_cavitation(tf.rotors[0], case, Pvap=3e5)
    with pytest.raises(ValueError, match="[Cc]avitation"):
        TR.calc_cavitation(tf.rotors[0], case, Pvap=3e5,
                           error_on_cavitation=True)


def test_blade_buoyancy_without_mass(rm1):
    """Blade members add displaced volume, not structural mass (reference:
    raft_fowt.py:402-444)."""
    d, tf, _ = rm1
    zero = np.zeros(6)
    full = TF.fowt_statics(tf, TF.fowt_pose(tf, zero))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TF, "blade_member_dicts", lambda rot: [])
        bare = TF.build_fowt(d, _grid_w(d), depth=tf.depth, device="cpu")
    assert "blade" not in bare.member_names
    stat = TF.fowt_statics(bare, TF.fowt_pose(bare, zero))
    assert float(stat["V"]) < float(full["V"])
    assert float(stat["m"]) == pytest.approx(float(full["m"]), rel=1e-12)


@pytest.fixture(scope="module")
def rm1_model():
    m = Model(MC.rm1_design(MC.GRID), device="cpu")
    m.analyzeUnloaded()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.analyzeCases()
    return m


def check_golden(m, stem, ledger_stems=MC.LEDGER_STEMS):
    """The port's run against the goldens of ``stem`` on the coarse grid:
    the physics record (every case's metrics at 1e-6, the iteration counts
    exact), the statics residual one-sided (at most
    ``MC.RESIDUAL_FACTOR`` times the larger JAX backend's), and where
    the model has one (``stem`` in ``ledger_stems``) the ledger golden at
    the golden bars, the statics residual's 0.5 band at the rounding floor
    reported (ROADMAP C7)."""
    from raft_tpu_torch import ledger

    with open(MC.golden_file(GOLDEN, stem, coarse=True)) as f:
        gold = json.load(f)
    live = MC.case_records(m.results, m.last_ledger)
    rel, same = MC.case_records_deviation(gold, live)
    ratio, held = MC.residual_held(gold, live)
    print(f"{stem}: statics_residual port "
          f"{[c['statics_residual'] for c in live['cases']]}, JAX host "
          f"{[c['statics_residual'] for c in gold['cases']]}, default "
          f"{gold['statics_residual_default']}; ratio {ratio:.3g}")
    assert rel <= 1e-6 and same, (rel, same)
    assert held, (ratio, MC.RESIDUAL_FACTOR)
    if stem in ledger_stems:
        chk = MC.ledger_golden_check(
            ledger.load_ledger(MC.ledger_golden_file(GOLDEN, stem, True)),
            m.last_ledger)
        print(ledger.format_diff(chk["report"]))
        assert not chk["blocking"] and chk["iters_ok"], chk["blocking"]


def test_rm1_golden(rm1_model):
    """(m1) both cases against the JAX package's golden."""
    m = rm1_model
    assert m.nw == 10 and len(m.results["case_metrics"]) == 2
    check_golden(m, "rm1_floating")


def test_rm1_cavitation_and_response(rm1_model):
    m = rm1_model
    with open(os.path.join(GOLDEN, "rm1_cavitation.json")) as f:
        gold = np.asarray(json.load(f)["default"])
    for ic in (0, 1):
        cm = m.results["case_metrics"][ic][0]
        cav = np.asarray(cm["cavitation"][0])
        assert np.max(np.abs(cav - gold)) <= 1e-9 * np.max(np.abs(gold))
    still, wave = (m.results["case_metrics"][i][0] for i in (0, 1))
    for ch in ("surge", "heave", "pitch"):
        assert still[f"{ch}_std"] == 0.0
        assert np.isfinite(wave[f"{ch}_std"]) and wave[f"{ch}_std"] > 0.0
    fns, _ = m.solveEigen()
    assert np.all(np.isfinite(fns)) and np.all(np.real(fns) > 0)


def test_sweep_cases_on_rm1(rm1):
    """An MHK FOWT goes through make_case_solver unchanged: the batch
    against the serial solve at 1e-9."""
    from raft_tpu_torch.parallel.sweep import make_case_solver

    _, tf, _ = rm1
    r = np.random.default_rng(8)
    Hs, Tp, beta = 0.5 + 3 * r.random(6), 5 + 8 * r.random(6), \
        2 * np.pi * r.random(6)
    solver = make_case_solver(tf, nIter=10)
    out = solver.batched(Hs, Tp, beta)
    assert bool(torch.all(torch.isfinite(out["std"])))
    for i in (0, 3, 5):
        ser = solver(Hs[i], Tp[i], beta[i])
        np.testing.assert_allclose(out["Xi"][i].numpy(), ser["Xi"].numpy(),
                                   rtol=1e-9, atol=1e-12)


def test_variant_at_the_base_geometry_keeps_the_blades(rm1):
    """variant_fowt carries the blade members like any other member (as
    the JAX package does): at the base geometry the statics equal the
    base model's."""
    from raft_tpu_torch.parallel.variants import variant_fowt

    _, tf, _ = rm1
    theta = dict(
        rA0=torch.stack([torch.as_tensor(m.rA0) for m in tf.members]),
        rB0=torch.stack([torch.as_tensor(m.rB0) for m in tf.members]))
    var = variant_fowt(tf, theta)
    zero = np.zeros(6)
    a = TF.fowt_statics(var, TF.fowt_pose(var, zero))
    b = TF.fowt_statics(tf, TF.fowt_pose(tf, zero))
    for k in ("M_struc", "C_hydro", "W_hydro"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-12,
                                   atol=1e-6)
