"""``Model.analyzeCases`` fault tolerance on the coarse cylinder, against
the JAX package's goldens (``tests/golden/recovery_golden.py``).

One module-scoped fixture runs the port on the CPU through the golden's
scenarios (``raft_tpu_torch/models/recovery_cases.py``): the clean
three-case run, the run under ``nan@dynamics:case=1`` (case 1
quarantined), ``resume=True`` on that run's journal, one case under
``raise@kernel:case=0:once`` and the same case clean, and one case under
``nan@dynamics:case=0:times=2`` in f64 and under
``RAFT_TPU_PRECISION=mixed``.  Held:

- every ledger against the JAX package's at 1e-6 (solver residuals in the
  0.5 band, ``ledger.blocking_regressions``; the quarantined case's
  message text aside, and of a recovered case's ``dyn_solve_residual``
  the last rung's, ROADMAP C10), iteration counts exact;
- ``failed_cases`` (case, phase, error), the attempt sequences mapped
  through ``recovery.JAX_STEP``, and the number of statics and dynamics
  solves of every run equal to the JAX package's;
- the faulted run's surviving cases, the resumed run and the recovered
  kernel run equal to the port's clean runs at 1e-12;
- ``RAFT_TPU_RECOVERY=0`` propagating ``NonFiniteResult``, a table whose
  every case fails raising, and a case quarantined mid-dynamics under
  ``potSecOrder: 1`` leaving no mean drift to the next case.
"""
import json
import os

import numpy as np
import pytest

from raft_tpu_torch import _config, errors, ledger, recovery
from raft_tpu_torch.model import Model
from raft_tpu_torch.models import recovery_cases as RC
from raft_tpu_torch.testing import faults

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "recovery")
#: (label, fault spec, cases, resume, precision mode), in golden order
RUNS = (("clean", None, 3, False, None),
        ("faulted", "nan@dynamics:case=1", 3, False, None),
        ("resumed", None, 3, True, None),
        ("kernel_once", "raise@kernel:case=0:once", 1, False, None),
        ("clean1", None, 1, False, None),
        ("times2", "nan@dynamics:case=0:times=2", 1, False, None),
        ("times2_mixed", "nan@dynamics:case=0:times=2", 1, False, "mixed"))


def _golden(label):
    name, key = (("cylinder_mixed", "times2") if label == "times2_mixed"
                 else ("cylinder", label))
    with open(os.path.join(GOLDEN, f"{name}.json")) as f:
        return json.load(f)[key]


def _as_ledger(entries: dict) -> dict:
    led = ledger.new_ledger("analyzeCases")
    for key in sorted(entries):
        ledger.add_entry(led, key, entries[key])
    return ledger.finalize(led)


@pytest.fixture(autouse=True)
def _port_faults():
    faults.clear()
    yield
    faults.clear()
    _config.set_recovery_mode(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's runs of the golden's scenarios, with the number of
    statics and dynamics solves and of drag passes each made."""
    import raft_tpu_torch.model as TM

    saved_env = os.environ.get("RAFT_TPU_JOURNAL_DIR")
    os.environ["RAFT_TPU_JOURNAL_DIR"] = str(tmp_path_factory.mktemp("j"))
    seen = {}
    s0, d0, k0 = Model.solveStatics, Model.solveDynamics, TM.impedance_solve

    def counted(name, fn):
        def wrapper(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return wrapper

    Model.solveStatics = counted("statics", s0)
    Model.solveDynamics = counted("dynamics", d0)
    TM.impedance_solve = counted("passes", k0)
    out = {}
    try:
        for label, spec, ncases, resume, mode in RUNS:
            seen.update(statics=0, dynamics=0, passes=0)
            faults.install(spec)
            _config.set_precision_mode(mode)
            try:
                m = Model(RC.cyl_design(ncases), device="cpu")
                m.analyzeCases(resume=resume)
            finally:
                faults.clear()
                _config.set_precision_mode(None)
            out[label] = {"model": m, "ledger": m.last_ledger,
                          "solves": {"statics": seen["statics"],
                                     "dynamics": seen["dynamics"]},
                          "passes": seen["passes"]}
            if label == "clean":
                # resume must read the faulted run's journal, as in
                # tests/test_recovery.py
                recovery.CaseJournal.for_model(m).clear()
        yield out
    finally:
        Model.solveStatics, Model.solveDynamics = s0, d0
        TM.impedance_solve = k0
        if saved_env is None:
            os.environ.pop("RAFT_TPU_JOURNAL_DIR", None)
        else:
            os.environ["RAFT_TPU_JOURNAL_DIR"] = saved_env


LABELS = [r[0] for r in RUNS]


@pytest.mark.parametrize("label", LABELS)
def test_ledger_matches_jax_golden(runs, label):
    entries = _golden(label)["ledger"]
    live = runs[label]["ledger"]
    ignore = ("message",)
    if label.startswith("times2"):
        # the JAX package's case record keeps the residuals of the failed
        # rungs' solves (NaN) before the recovered one's; the port's holds
        # the rung that succeeded: compare that tail
        ignore += ("case0/system:dyn_solve_residual",)
        port = next(e["metrics"]["dyn_solve_residual"]
                    for e in live["entries"] if e["key"] == "case0/system")
        jax = entries["case0/system"]["dyn_solve_residual"]
        assert all(isinstance(v, str) for v in jax[:-len(port)])   # "nan"
        assert not ledger.blocking_regressions(ledger.diff(
            _as_ledger({"r": {"dyn_solve_residual": jax[-len(port):]}}),
            _as_ledger({"r": {"dyn_solve_residual": port}}),
            per_metric={"*_residual*": 0.5}))
    gold = _as_ledger(entries)
    rep = ledger.diff(gold, live, tol_rel=1e-6,
                      per_metric={"*_residual*": 0.5}, ignore=ignore)
    assert not ledger.blocking_regressions(rep), ledger.format_diff(rep)
    assert not rep["added"] and not rep["removed"], ledger.format_diff(rep)
    g = {e["key"]: e["metrics"] for e in gold["entries"]}
    m = {e["key"]: e["metrics"] for e in live["entries"]}
    for key in g:
        assert set(g[key]) == set(m[key]), key
        for k in ("statics_iters", "drag_iters", "drag_converged"):
            if k in g[key]:
                assert m[key][k] == g[key][k], (key, k)


@pytest.mark.parametrize("label", LABELS)
def test_failures_attempts_and_solves_match_jax(runs, label):
    gold = _golden(label)
    m = runs[label]["model"]
    assert [(c["case"], c["phase"], c["error"]) for c in m.failed_cases] == \
        [(c["case"], c["phase"], c["error"]) for c in gold["failed_cases"]]
    mapped = [(a["phase"], a["case"], recovery.JAX_STEP[a["step_from"]],
               recovery.JAX_STEP[a["step_to"]], a["outcome"], a["error"])
              for a in gold["attempts"]]
    assert [(a.phase, a.case, a.step_from, a.step_to, a.outcome, a.error)
            for a in m.recovery_attempts] == mapped
    assert m.resumed_cases == gold["resumed_cases"]
    assert runs[label]["solves"] == gold["solves"]
    assert m.last_ledger["extra"]["failed_cases"] == m.failed_cases


def test_faulted_survivors_equal_the_clean_run(runs):
    clean, faulted = runs["clean"]["ledger"], runs["faulted"]["ledger"]
    rep = ledger.diff(clean, faulted, tol_rel=1e-12)
    assert rep["added"] == ["case1/failed"]
    assert rep["removed"] == ["case1/fowt0", "case1/system"]
    assert not rep["regressions"], ledger.format_diff(rep)
    m = runs["faulted"]["model"]
    assert np.all(np.isnan(m.results["mean_offsets"][1]))
    assert "failed" in m.results["case_metrics"][1]


def test_resume_reruns_only_the_failed_case(runs):
    m = runs["resumed"]["model"]
    assert m.resumed_cases == [0, 2] and m.failed_cases == []
    assert runs["resumed"]["solves"] == {"statics": 1, "dynamics": 1}
    rep = ledger.diff(runs["clean"]["ledger"], runs["resumed"]["ledger"],
                      tol_rel=1e-12)
    assert rep["ok"], ledger.format_diff(rep)


def test_kernel_fault_recovers_at_parity_and_launches_nothing(runs):
    rep = ledger.diff(runs["clean1"]["ledger"], runs["kernel_once"]["ledger"],
                      tol_rel=1e-12)
    assert rep["ok"], ledger.format_diff(rep)
    # the faulted attempt's first impedance_solve raised before launching;
    # the seam counts that call, the kernel never ran for it
    assert runs["kernel_once"]["passes"] == runs["clean1"]["passes"] + 1


def test_mixed_damped_restart_matches_f64(runs):
    rep = ledger.diff(runs["times2"]["ledger"],
                      runs["times2_mixed"]["ledger"], tol_rel=1e-6,
                      per_metric={"*_residual*": 0.5})
    assert not ledger.blocking_regressions(rep), ledger.format_diff(rep)
    # both dynamics rungs that failed ran their whole fixed point
    assert runs["times2_mixed"]["passes"] == runs["times2"]["passes"]


def test_recovery_off_propagates():
    _config.set_recovery_mode("0")
    faults.install("nan@dynamics:case=0")
    m = Model(RC.cyl_design(ncases=1), device="cpu")
    with pytest.raises(errors.NonFiniteResult):
        m.analyzeCases()
    assert m.recovery_attempts == [] and m.failed_cases == []


def test_every_case_failing_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("RAFT_TPU_JOURNAL_DIR", str(tmp_path))
    faults.install("nan@dynamics")
    m = Model(RC.cyl_design(ncases=1), device="cpu")
    with pytest.raises(errors.NonFiniteResult):
        m.analyzeCases()
    assert [c["case"] for c in m.failed_cases] == [0]
    assert len(m.recovery_attempts) == 2


def test_quarantine_clears_meandrift_for_next_case(monkeypatch, tmp_path):
    """A potSecOrder case quarantined mid-dynamics leaves no F_meandrift
    to the next case's statics: the neighbour equals a clean run's."""
    monkeypatch.setenv("RAFT_TPU_JOURNAL_DIR", str(tmp_path))

    def build():
        design = RC.cyl_design(ncases=2)
        design["platform"]["potSecOrder"] = 1
        design["platform"]["min_freq2nd"] = 0.05
        design["platform"]["max_freq2nd"] = 0.25
        ik = design["cases"]["keys"].index("wave_spectrum")
        for row in design["cases"]["data"]:
            row[ik] = "JONSWAP"      # a still sea has no drift forcing
        return design

    m = Model(build(), device="cpu")
    m.analyzeCases()
    clean = {e["key"]: e["digest"] for e in m.last_ledger["entries"]}
    faults.install("nan@dynamics:case=0")
    m = Model(build(), device="cpu")
    m.analyzeCases()
    assert [f["case"] for f in m.failed_cases] == [0]
    faulted = {e["key"]: e["digest"] for e in m.last_ledger["entries"]}
    for key in ("case1/fowt0", "case1/system"):
        assert faulted[key] == clean[key], key
