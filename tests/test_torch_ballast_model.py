"""The ballast trim through the port's Model on the CPU against the JAX
package's goldens (``tests/golden/ballast_golden.py``, under
``tests/golden/ballast/``), on the cases of ``models/ballast_cases.py``:

- (b1) VolturnUS-S, OC3spar and OC4semi through
  ``analyzeUnloaded(ballast=1)`` at ``heave_tol`` 1.0 and
  ``analyzeUnloaded(ballast=2)``; (b2) the walk at ``heave_tol`` 1e-5 on
  OC4semi and VolturnUS-S (several sections, a group of three members,
  the full and the empty clamps).  Every fill level equal to the JAX
  package's, each visited section's unrounded fill level at 1e-9 (its
  margin to the rounding boundary printed), the density shift and every
  fill density at 1e-12, the unloaded offset and the walk's heaves at
  1e-6, the unloaded Newton iterations exact, and the outputs a density
  trim drives to zero by ``ballast_cases.floor_bar`` (printed beside the
  reading).  The trim is statics only: the goldens are taken at each
  design's own grid and hold the coarse-grid models here unchanged.
- (b3) ``run_raft(design, ballast=True)`` on VolturnUS-S and OC3spar's
  first case on the coarse golden grid: the physics record (1e-6,
  iteration counts exact, the statics residual one-sided), the ledger
  golden, the trim and ``calcOutputs``' ballast densities and masses.
- The case journal of a trimmed model has another key than the
  untrimmed model's, so ``resume=True`` restores no untrimmed case.
"""
import json
import os

import numpy as np
import pytest

from raft_tpu_torch import run_raft
from raft_tpu_torch.ledger import _compare_values
from raft_tpu_torch.model import Model
from raft_tpu_torch.models import ballast_cases as BC
from raft_tpu_torch.models import mhk_cases as MC
from raft_tpu_torch.recovery import CaseJournal

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "ballast")


def _load(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _report(tid, dev, live):
    print(json.dumps({tid: {k: dev[k] for k in (
        "fills_equal", "walk_equal", "unrounded", "imbalance", "density",
        "downstream", "near_zero", "iters_equal")}}))
    for w in live["walk"]:
        print(f"  group {w['group']} section {w['section']} {w['branch']}: "
              f"{w['l_fill0']} -> {w['l_new']} m (unrounded "
              f"{w['l_new_unrounded']!r}, margin {w['margin']:.3e} m), "
              f"heave {w['heave']:.3e} m")


@pytest.mark.parametrize("tid", list(BC.TRIMS))
def test_trim_matches_golden(tid):
    key, ballast, tol = BC.TRIMS[tid]
    gold = _load("trims.json")[tid]
    m = Model(BC.design(key, coarse=True), device="cpu")
    # a walk reads the imbalance before it itself; a density shift not
    before = m._heave_imbalance(m.fowtList[0])[1] if ballast == 2 else None
    m.analyzeUnloaded(ballast=ballast, heave_tol=tol)
    live = BC.run_trim_record(m, before)
    dev = BC.trim_deviation(gold, live)
    _report(tid, dev, live)
    assert dev["ok"], dev
    assert (ballast == 2) == bool(gold.get("near_zero"))


def test_the_walks_take_every_branch():
    gold = _load("trims.json")
    seen = {w["branch"] for r in gold.values() for w in r["walk"]}
    assert seen == set(BC.BRANCHES)
    groups = {len(r["walk"]) for tid, r in gold.items()
              if tid.startswith("b2")}
    assert min(groups) > 1


@pytest.mark.parametrize("stem", list(BC.RUNS))
def test_run_raft_with_ballast_matches_golden(stem, monkeypatch):
    from raft_tpu_torch import ledger

    key, ncases = BC.RUNS[stem]
    # analyzeCases forgets the unloaded statics' record: read it before
    unloaded_iters = []
    unloaded = Model.analyzeUnloaded

    def read_iters(self, *a, **k):
        unloaded(self, *a, **k)
        unloaded_iters.append(
            self._case_records["unloaded"]["statics_iters"])
    monkeypatch.setattr(Model, "analyzeUnloaded", read_iters)
    m = run_raft(BC.design(key, coarse=True, ncases=ncases), ballast=True,
                 device="cpu")
    assert m.nw == 10
    gold = _load(f"{stem}_coarse.metrics.json")
    live = MC.case_records(m.results, m.last_ledger)
    rel, same = MC.case_records_deviation(gold, live)
    ratio, held = MC.residual_held(gold, live)
    print(f"{stem}: records rel {rel:.2e}, iteration counts equal {same}; "
          f"statics_residual port {[c['statics_residual'] for c in live['cases']]}"
          f", JAX host {[c['statics_residual'] for c in gold['cases']]}, "
          f"default {gold['statics_residual_default']}; ratio {ratio:.3g}")
    assert rel <= BC.GOLDEN_TOL and same
    assert held, (ratio, MC.RESIDUAL_FACTOR)
    trim = BC.run_trim_record(m)
    trim["unloaded_iters"] = unloaded_iters[0]
    dev = BC.trim_deviation(gold["trim"], trim)
    _report(stem, dev, trim)
    assert dev["ok"], dev
    props = m.results["properties"]
    for k, v in gold["properties"].items():
        assert _compare_values(v, np.asarray(props[k], float).tolist())[0] \
            <= BC.GOLDEN_TOL, k
    if stem in BC.LEDGER_STEMS:
        chk = MC.ledger_golden_check(
            ledger.load_ledger(MC.ledger_golden_file(GOLDEN, stem, True)),
            m.last_ledger)
        print(ledger.format_diff(chk["report"]))
        assert not chk["blocking"] and chk["iters_ok"], chk["blocking"]


def test_trimmed_model_has_its_own_case_journal(tmp_path):
    d = BC.design("oc3spar", coarse=True, ncases=1)
    plain = Model(d, device="cpu")
    plain.analyzeUnloaded()
    plain.analyzeCases()
    trimmed = Model(d, device="cpu")
    trimmed.analyzeUnloaded(ballast=1)
    assert trimmed.ballast_trim["walk"]
    keys = str(tmp_path / "keys")
    assert CaseJournal.for_model(plain, base_dir=keys).key \
        != CaseJournal.for_model(trimmed, base_dir=keys).key
    trimmed.analyzeCases(resume=True)
    assert trimmed.resumed_cases == []
    assert not np.allclose(trimmed.results["mean_offsets"][0],
                           plain.results["mean_offsets"][0])
    # the untrimmed model's journal is there: an untrimmed rerun restores it
    again = Model(d, device="cpu")
    again.analyzeUnloaded()
    again.analyzeCases(resume=True)
    assert again.resumed_cases == [0]
