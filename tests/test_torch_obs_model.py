"""``Model.analyzeCases`` observability on the CPU, against the JAX
package's goldens (``tests/golden/obs_golden.py``, ``tests/golden/obs/``).

A module-scoped fixture runs the port on the coarse grids of the goldens
(``raft_tpu_torch/models/recovery_cases.py``): OC3spar's first case with
observability off (no output directory, ``RAFT_TPU_PROBES=off``) and on
(an output directory, probes ``sampled``); the three-case cylinder under
``nan@dynamics:case=1`` with an output directory; then ``resume=True`` on
that run's journal.  Held:

- the span tree, the flight recorder's event types and probe counts, and
  the metric names with their label keys equal to the JAX package's
  (`JAX_ONLY` / `PORT_ONLY` list the families one package has and the
  other cannot);
- manifest, trace, ledger and events written and valid, the ledger file
  equal to ``ledger_from_model``, the events replaying the trace;
- the host pulls per phase equal to the port's pinned formula
  (``models/obs_cases.pulls_per_case``) with probes on and off, beside
  the JAX package's 1 + 4;
- every output bitwise equal with observability on and off;
- the recovery and quarantine counters and events of the faulted run,
  the rung names mapped through ``recovery.JAX_STEP``.
"""
import json
import os

import numpy as np
import pytest

from raft_tpu_torch import _config, ledger, obs, recovery
from raft_tpu_torch.model import Model
from raft_tpu_torch.models import recovery_cases as RC
from raft_tpu_torch.models.obs_cases import (JAX_PULLS_PER_CASE, SPAN_TREE,
                                             pulls_per_case)
from raft_tpu_torch.obs import events
from raft_tpu_torch.testing import faults

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "obs")

#: metric families only the JAX package records: XLA compile events
#: (the port counts its kernel build cache instead: no build on the
#: CPU), XLA's static cost model (no counterpart) and the live-array
#: count (the caching allocator counts bytes, not tensors); the device
#: allocator families have no CPU series in the port
JAX_ONLY = {"raft_jax_events_total", "raft_jax_event_duration_seconds_total",
            "raft_hlo_flops", "raft_hlo_bytes_accessed", "raft_live_arrays",
            "raft_live_arrays_bytes", "raft_device_memory_bytes"}
#: the port samples its build cache into the jit-cache gauges every run
PORT_ONLY = {"raft_jit_cache_hits", "raft_jit_cache_misses",
             "raft_jit_cache_delta"}
#: build-info labels: jax_version becomes the torch/CUDA/card facts
BUILD_INFO_KEYS = ("cuda_version,device,dirty,git_sha,hostname,pid,run_id,"
                   "torch_version,version")


def _gold(name):
    with open(os.path.join(GOLD, f"{name}.json")) as f:
        return json.load(f)


def _run(design, out_dir=None, probes="off", spec=None, resume=False):
    obs.reset_all()
    obs.configure(out_dir)
    _config.set_probes_mode(probes)
    faults.install(spec)
    try:
        m = Model(design, device="cpu")
        m.analyzeCases(resume=resume)
    finally:
        faults.clear()
        _config.set_probes_mode(None)
    return {"model": m, "spans": obs.spans(), "snap": obs.snapshot(),
            "chrome": obs.chrome_trace(),
            "manifest": m.last_manifest.to_dict(), "dir": out_dir}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("obs_model")
    old = os.environ.get("RAFT_TPU_JOURNAL_DIR")
    os.environ["RAFT_TPU_JOURNAL_DIR"] = str(base / "journal")
    try:
        oc3 = RC.oc3spar_design(True, 1)
        out = {"off": _run(oc3),
               "on": _run(oc3, str(base / "on"), probes="sampled")}
        cyl = RC.cyl_design(3)
        out["faulted"] = _run(cyl, str(base / "faulted"), probes="sampled",
                              spec="nan@dynamics:case=1")
        out["resumed"] = _run(cyl, str(base / "resumed"), probes="sampled",
                              resume=True)
        yield out
    finally:
        obs.reset_all()
        if old is None:
            os.environ.pop("RAFT_TPU_JOURNAL_DIR", None)
        else:
            os.environ["RAFT_TPU_JOURNAL_DIR"] = old


def _files(run):
    names = os.listdir(run["dir"])
    out = {}
    for suffix in ("manifest.json", "trace.json", "ledger.json",
                   "events.jsonl"):
        hits = [n for n in names if n.endswith("." + suffix)]
        assert len(hits) == 1, (suffix, names)
        out[suffix] = os.path.join(run["dir"], hits[0])
    return out


def test_span_tree_equals_the_jax_packages(runs):
    gold = _gold("model")
    for label in ("off", "on"):
        got = [[s["name"], s["depth"], s["parent"]]
               for s in runs[label]["spans"]]
        assert got == gold["spans"] == SPAN_TREE, label
    on = {s["name"]: s["attrs"] for s in runs["on"]["spans"]}
    assert on["solveStatics"]["newton_iters"] == gold["statics_iters"]
    assert on["fowt_linearize"]["iterations"] == gold["drag_iters"]
    assert on["solveDynamics"]["cond_max"] > 1.0


def test_metric_names_and_label_keys_equal_the_jax_packages(runs):
    gold = _gold("model")["metrics"]
    mine = {name: {"kind": m["kind"],
                   "label_keys": sorted({",".join(sorted(s["labels"]))
                                         for s in m["series"]})}
            for name, m in runs["on"]["snap"].items()}
    assert set(mine) == (set(gold) - JAX_ONLY) | PORT_ONLY
    for name in set(mine) & set(gold):
        if name == "raft_tpu_build_info":
            assert mine[name]["label_keys"] == [BUILD_INFO_KEYS]
            continue
        assert mine[name] == gold[name], name


def test_events_and_probes_equal_the_jax_packages(runs):
    gold = _gold("model")["events"]
    evs = events.read(_files(runs["on"])["events.jsonl"])
    assert events.validate(evs) == []
    assert [e["type"] for e in evs if e["type"] != "probe"] == gold["types"]
    assert [e["name"] for e in evs if e["type"] == "span_close"] \
        == gold["spans"]
    probes = {}
    for e in evs:
        if e["type"] == "probe":
            probes[e["probe"]] = probes.get(e["probe"], 0) + 1
    assert probes == gold["probes"]
    # the stream replays the in-process trace event for event
    assert events.to_chrome_trace(evs)["traceEvents"] \
        == runs["on"]["chrome"]["traceEvents"]
    assert runs["off"]["snap"].get("raft_tpu_probe_events_total") is None


def test_run_files_are_written_and_valid(runs):
    files = _files(runs["on"])
    man = json.load(open(files["manifest.json"]))
    assert obs.validate_manifest(man) == [] and man["status"] == "ok"
    assert man == json.loads(json.dumps(runs["on"]["manifest"],
                                        default=str))
    assert man["extra"]["failed_cases"] == []
    assert man["extra"]["solver"]["backend"] == "plain_gj"
    assert set(man["extra"]["timings"]) >= {"statics", "dynamics",
                                            "outputs", "journal"}
    trace = json.load(open(files["trace.json"]))
    assert {e["name"] for e in trace["traceEvents"]} == {
        "analyzeCases", "solveStatics", "solveDynamics", "fowt_linearize",
        "saveTurbineOutputs"}
    led = json.load(open(files["ledger.json"]))
    m = runs["on"]["model"]
    assert ledger.validate_ledger(led) == []
    assert led["digest"] == m.last_ledger["digest"] \
        == ledger.ledger_from_model(m)["digest"]
    assert led["run_id"] == man["run_id"]
    assert runs["off"]["dir"] is None and runs["off"]["model"].last_manifest


def test_host_pulls_follow_the_pinned_formula_with_probes_on_and_off(runs):
    gold = _gold("model")
    for label in ("off", "on"):
        m = runs[label]["model"]
        rec = m._case_records["0"]
        phases = {ph: r["events"] for ph, r in
                  runs[label]["manifest"]["extra"]["host_transfers"]
                  ["phases"].items()}
        want = pulls_per_case(rec["statics_iters"],
                              rec["fowt0"]["drag_iters"])
        assert phases == {**want, "journal": 1}, label
    # the JAX package's budget beside it: one statics pull, four dynamics
    assert gold["transfers"] == JAX_PULLS_PER_CASE
    assert (gold["statics_iters"], gold["drag_iters"]) == (
        runs["on"]["model"]._case_records["0"]["statics_iters"],
        runs["on"]["model"]._case_records["0"]["fowt0"]["drag_iters"])


def test_outputs_bitwise_equal_with_observability_on_and_off(runs):
    a, b = runs["off"]["model"], runs["on"]["model"]
    assert a.last_ledger["digest"] == b.last_ledger["digest"]
    assert np.array_equal(a.Xi, b.Xi)
    ma, mb = a.results["case_metrics"][0][0], b.results["case_metrics"][0][0]
    assert set(ma) == set(mb)
    for k in ma:
        assert np.array_equal(np.asarray(ma[k]), np.asarray(mb[k])), k
    assert a._case_records == b._case_records


def test_recovery_counters_and_events_equal_the_jax_packages(runs):
    gold = _gold("recovery")
    snap = runs["faulted"]["snap"]
    series = {}
    for name in ("raft_tpu_recovery_attempts_total",
                 "raft_tpu_cases_failed_total"):
        series[name] = sorted(
            ([s["labels"], s["value"]] for s in snap[name]["series"]),
            key=json.dumps)
    want = {name: sorted(([{k: (recovery.JAX_STEP[v]
                                if k in ("from", "to") else v)
                            for k, v in labels.items()}, value]
                          for labels, value in rows), key=json.dumps)
            for name, rows in gold["series"].items()}
    assert series == want
    m = runs["faulted"]["model"]
    assert [[c["case"], c["phase"], c["error"]] for c in m.failed_cases] \
        == gold["failed_cases"]
    evs = events.read(_files(runs["faulted"])["events.jsonl"])
    assert events.validate(evs) == []
    assert [e["type"] for e in evs if e["type"] != "probe"] \
        == gold["events"]["types"]
    assert [e["name"] for e in evs if e["type"] == "span_close"] \
        == gold["events"]["spans"]
    prog = events.public_progress(events.progress(evs))
    assert (prog["done"], prog["failed"], prog["quarantined"],
            prog["recoveries"]) == (3, 1, 1, 2)
    man = runs["faulted"]["manifest"]
    assert len(man["extra"]["recovery"]["attempts"]) == 2


def test_resume_spans_counters_and_events(runs):
    run = runs["resumed"]
    m = run["model"]
    assert m.resumed_cases == [0, 2]
    assert [s["name"] for s in run["spans"]
            if s["name"] == "case_resumed"] == ["case_resumed"] * 2
    snap = run["snap"]
    assert snap["raft_tpu_cases_resumed_total"]["series"][0]["value"] == 2
    evs = events.read(_files(run)["events.jsonl"])
    ends = [e for e in evs if e["type"] == "case_end"]
    assert [(e["case"], e.get("resumed", False)) for e in ends] == [
        (0, True), (1, False), (2, True)]
    assert run["manifest"]["extra"]["resumed_cases"] == [0, 2]
