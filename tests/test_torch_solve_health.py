"""The sweep's solve-health mode (``RAFT_TPU_HEALTH``) on the CPU, against
the JAX package's golden (``tests/golden/obs_golden.py``,
``tests/golden/obs/sweep.json``).

The four-case cylinder sweep of ``tests/golden/recovery_golden.py``
(``raft_tpu_torch/models/recovery_cases.py``, nIter 6) with
``health=True``, clean and under ``nan@sweep:lane=2``:

- ``health_cond`` at 1e-9 relative to the JAX package's;
- ``health_residual`` held one-sided, at most 4x the JAX package's or
  1e-14, whichever is larger (a residual at the rounding floor, as ROADMAP
  C3/C7 hold floor residuals);
- ``Xi``, ``std``, ``iters`` and ``converged`` bitwise equal with health
  on and off: health only adds outputs;
- ``_health_summary``'s facts equal the JAX package's (counts exactly,
  residuals one-sided, conditioning at 1e-9), its gauges and its
  ``solve_health`` event, ``manifest.extra["solve_health"]``;
- the knob off by default and on through ``RAFT_TPU_HEALTH=1``;
- ``sweep_cases_chunked`` with health on equal to the whole table's lanes
  (1e-12, as ``tests/test_torch_recovery_sweep.py`` holds the chunks on
  the CPU; the residuals, at the rounding floor, both below 1e-14;
  ``chip_smoke.py`` holds the card's lanes bitwise).
"""
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import _config, obs
from raft_tpu_torch.models import recovery_cases as RC
from raft_tpu_torch.models.fowt import build_fowt
from raft_tpu_torch.obs import events
from raft_tpu_torch.parallel import sweep as S
from raft_tpu_torch.serve.checkpoint import CheckpointStore
from raft_tpu_torch.testing import faults

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "obs", "sweep.json")
COND_TOL = 1e-9
RESID_FACTOR = 4.0
RESID_FLOOR = 1e-14


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_HEALTH", raising=False)
    monkeypatch.delenv("RAFT_TPU_OBS_DIR", raising=False)
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()
    _config.set_health_mode(None)


@pytest.fixture(scope="module")
def fowt():
    d, w, depth = RC.sweep_fowt_args()
    return build_fowt(d, w, depth=depth, device="cpu")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _sweep(fowt, **kw):
    return S.sweep_cases(fowt, *RC.sweep_inputs(), nIter=RC.SWEEP_NITER,
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def sweeps(fowt):
    """(off, clean, faulted_off, faulted) runs, each with the summary it
    folded and its metrics snapshot."""
    out = {}
    for label, spec, health in (("off", None, False),
                                ("clean", None, True),
                                ("faulted_off", RC.SWEEP_FAULT, False),
                                ("faulted", RC.SWEEP_FAULT, True)):
        obs.reset_all()
        faults.install(spec)
        facts = {}
        inner = S._health_summary

        def capture(*a, **k):
            facts["summary"] = inner(*a, **k)
            return facts["summary"]

        S._health_summary = capture
        try:
            res = _sweep(fowt, health=health)
        finally:
            S._health_summary = inner
            faults.clear()
        out[label] = {"out": res, "summary": facts.get("summary"),
                      "snap": obs.snapshot()}
    obs.reset_all()
    return out


def _residual_held(mine, theirs):
    mine, theirs = np.asarray(mine), np.asarray(theirs)
    return bool(np.all(mine <= np.maximum(RESID_FACTOR * theirs,
                                          RESID_FLOOR)))


@pytest.mark.parametrize("label", ["clean", "faulted"])
def test_health_lanes_against_the_jax_package(sweeps, golden, label):
    out, gold = sweeps[label]["out"], golden[label]
    cond = out["health_cond"].numpy()
    want = np.asarray(gold["health_cond"])
    assert np.all(np.abs(cond - want) <= COND_TOL * np.abs(want))
    res = out["health_residual"].numpy()
    assert _residual_held(res, gold["health_residual"]), (
        res, gold["health_residual"])
    assert out["iters"].tolist() == gold["iters"]
    assert out["converged"].tolist() == gold["converged"]


@pytest.mark.parametrize("label", ["clean", "faulted"])
def test_health_summary_facts_gauges_and_manifest(sweeps, golden, label):
    mine, gold = sweeps[label]["summary"], golden[label]["summary"]
    for k in ("nonfinite_lanes", "iters_max", "lanes"):
        assert mine[k] == gold[k], k
    # the worst lane is the first non-finite one; on a clean batch it is
    # the largest floor residual, which rounding picks
    if gold["nonfinite_lanes"]:
        assert mine["worst_lane"] == gold["worst_lane"]
    else:
        assert 0 <= mine["worst_lane"] < mine["lanes"]
    assert abs(mine["cond_max"] - gold["cond_max"]) \
        <= COND_TOL * gold["cond_max"]
    for k in ("residual_rel_max", "residual_rel_median"):
        assert _residual_held(mine[k], gold[k]), k
    snap = sweeps[label]["snap"]
    assert sorted(n for n in snap if n.startswith("raft_tpu_solve_")) \
        == golden[label]["gauges"]
    rel = {s["labels"]["stat"]: s["value"]
           for s in snap["raft_tpu_solve_residual_rel"]["series"]}
    assert rel == {"max": mine["residual_rel_max"],
                   "median": mine["residual_rel_median"]}
    assert snap["raft_tpu_solve_nonfinite_lanes"]["series"][0]["value"] \
        == mine["nonfinite_lanes"]


def test_health_only_adds_outputs(sweeps):
    for label in ("clean", "faulted"):
        off = sweeps[f"{label}_off" if label == "faulted" else "off"]
        assert off["summary"] is None
        off = off["out"]
        assert "health_residual" not in off and "health_cond" not in off
        on = sweeps[label]["out"]
        for k in ("Xi", "std", "iters", "converged"):
            assert torch.equal(on[k], off[k]), (label, k)
        assert on["fp_chunks"] == off["fp_chunks"]
    assert sweeps["faulted"]["out"]["quarantine"]["recovered"] == [2]


def test_event_and_manifest_and_the_knob(fowt, tmp_path, monkeypatch):
    obs.configure(str(tmp_path))
    assert _config.health_enabled() is False
    monkeypatch.setenv("RAFT_TPU_HEALTH", "1")
    out = _sweep(fowt)
    assert "health_residual" in out and "health_cond" in out
    names = os.listdir(tmp_path)
    man = json.load(open(tmp_path / next(
        n for n in names if n.endswith(".manifest.json"))))
    assert obs.validate_manifest(man) == []
    assert man["config"]["health"] is True
    facts = man["extra"]["solve_health"]
    assert facts["lanes"] == 4 and facts["nonfinite_lanes"] == 0
    evs = events.read(str(tmp_path / next(
        n for n in names if n.endswith(".events.jsonl"))))
    sh = [e for e in evs if e["type"] == "solve_health"]
    assert len(sh) == 1 and sh[0]["phase"] == "sweep"
    assert sh[0]["residual_rel_max"] == facts["residual_rel_max"]
    probes = [e for e in evs if e["type"] == "probe"]
    assert [p["probe"] for p in probes] == ["sweep_lanes"]
    assert probes[0]["values"]["finite"] == [1, 1, 1, 1]
    # the ledger of the sweep is written beside the manifest
    led = json.load(open(tmp_path / next(
        n for n in names if n.endswith(".ledger.json"))))
    assert led["kind"] == "sweep_cases" and len(led["entries"]) == 5
    monkeypatch.setenv("RAFT_TPU_HEALTH", "0")
    assert "health_cond" not in _sweep(fowt)


def test_chunked_sweep_with_health_equals_the_whole_table(fowt, tmp_path):
    rng = np.random.default_rng(11)
    n = 12
    table = (1 + 11 * rng.random(n), 4 + 14 * rng.random(n),
             np.deg2rad(360 * rng.random(n)))
    whole = S.sweep_cases(fowt, *table, nIter=RC.SWEEP_NITER, device="cpu",
                          health=True)
    store = CheckpointStore(str(tmp_path))
    out, info = S.sweep_cases_chunked(
        fowt, *table, store=store, key="health:t", chunk=4,
        nIter=RC.SWEEP_NITER, device="cpu", health=True)
    assert info["solved"] == [0, 1, 2]
    for k in ("health_cond", "Xi", "std"):
        a, b = out[k], whole[k].numpy()
        assert np.all(np.abs(a - b) <= 1e-12 * np.max(np.abs(b))), k
    # the residuals sit at the rounding floor in both: the plain solve
    # rounds by batch size on the CPU (the card's K1 does not)
    assert np.all(out["health_residual"] <= RESID_FLOOR)
    assert np.all(whole["health_residual"].numpy() <= RESID_FLOOR)
    for k in ("iters", "converged"):
        assert np.array_equal(out[k], whole[k].numpy())
    # a health-off call does not reuse the health chunks, and has no
    # health fields
    off, info = S.sweep_cases_chunked(
        fowt, *table, store=store, key="health:t", chunk=4,
        nIter=RC.SWEEP_NITER, device="cpu")
    assert info["resumed"] == [] and "health_cond" not in off
    again, info = S.sweep_cases_chunked(
        fowt, *table, store=store, key="health:t", chunk=4,
        nIter=RC.SWEEP_NITER, device="cpu")
    assert info["resumed"] == [0, 1, 2]
