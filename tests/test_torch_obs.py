"""The port's observability modules against the JAX package's, on the CPU.

``raft_tpu_torch/obs`` holds copies of ``raft_tpu/obs`` (tracing,
metrics, manifest, events, transfers, probes, device) and the knobs of
``raft_tpu/_config.py``; the JAX package's obs modules import here (they
need no JAX device), so the two are held against each other directly:

- the Prometheus text of a scripted series of registry operations byte
  for byte equal to the JAX registry's, and to ``tests/golden/obs/
  prometheus.json`` (``tests/golden/obs_golden.py``);
- a flight-recorder stream written by either package read and validated
  by the other, a torn tail included;
- ``prune_runs`` sparing running stubs; the manifest schema (the JAX
  validator accepts the port's manifest); ledgers of a sweep digesting
  alike;
- ``transfers.device_get`` counting events, arrays and bytes per phase;
  the probe modes, ``suppress`` and the probes' own budget; the knobs
  parsed as the JAX package parses them.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch import _config, obs
from raft_tpu_torch.obs import events, journalio, metrics, probes, transfers

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden", "obs")


@pytest.fixture(autouse=True)
def _port_obs_isolation(monkeypatch):
    for k in ("RAFT_TPU_PROBES", "RAFT_TPU_TELEMETRY", "RAFT_TPU_HEALTH",
              "RAFT_TPU_OBS_DIR", "RAFT_TPU_OBS_MAX_RUNS",
              "RAFT_TPU_EVENTS", "RAFT_TPU_EVENTS_MAX_BYTES",
              "RAFT_TPU_EVENTS_KEEP"):
        monkeypatch.delenv(k, raising=False)
    obs.reset_all()
    yield
    obs.reset_all()
    _config.set_probes_mode(None)
    _config.set_telemetry_mode(None)
    _config.set_health_mode(None)


def _golden(name):
    with open(os.path.join(GOLD, f"{name}.json")) as f:
        return json.load(f)


def _replay(registry, buckets, script):
    for kind, name, help_, method, value, labels in script:
        if kind == "histogram":
            m = registry.histogram(name, help_, buckets=buckets)
        else:
            m = getattr(registry, kind)(name, help_)
        getattr(m, method)(value, **labels)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_prometheus_text_is_the_jax_registrys_byte_for_byte():
    from raft_tpu.obs import metrics as jm

    gold = _golden("prometheus")
    assert list(metrics.ITER_BUCKETS) == gold["buckets"] \
        == list(jm.ITER_BUCKETS)
    mine = metrics.MetricsRegistry()
    theirs = jm.MetricsRegistry()
    _replay(mine, metrics.ITER_BUCKETS, gold["script"])
    _replay(theirs, jm.ITER_BUCKETS, gold["script"])
    assert mine.to_prometheus() == theirs.to_prometheus() == gold["text"]
    assert json.dumps(mine.snapshot(), sort_keys=True) \
        == json.dumps(theirs.snapshot(), sort_keys=True)


@pytest.mark.parametrize("fn,args", [
    ("record_solve_health", ("sweep", 1e-15, 5e-16, 2)),
    ("record_solve_dispatch", ("cuda_fused", 12, 81920, True)),
])
def test_recorders_write_the_jax_series(fn, args):
    from raft_tpu.obs import metrics as jm

    jm.REGISTRY.reset()
    getattr(metrics, fn)(*args)
    getattr(jm, fn)(*args)
    assert metrics.to_prometheus() == jm.to_prometheus()
    jm.REGISTRY.reset()


def test_counter_rejects_decrease_and_kinds_do_not_mix():
    c = metrics.counter("raft_tpu_x_total", "x")
    with pytest.raises(ValueError):
        c.inc(-1.0)
    with pytest.raises(TypeError):
        metrics.gauge("raft_tpu_x_total")
    assert metrics.counter_total("raft_tpu_x_total") == 0.0
    c.inc(2.0, a="1")
    c.inc(3.0, a="2")
    assert metrics.counter_total("raft_tpu_x_total") == 5.0


def test_build_info_names_torch_and_the_card():
    labels = metrics.record_build_info(run_id="abc")
    assert labels["torch_version"] == torch.__version__
    assert labels["device"] == ("cpu" if not torch.cuda.is_available()
                                else torch.cuda.get_device_name(0))
    assert labels["run_id"] == "abc"
    series = metrics.snapshot()["raft_tpu_build_info"]["series"]
    assert len(series) == 1 and series[0]["value"] == 1.0
    metrics.record_build_info(run_id="def")
    assert len(metrics.snapshot()["raft_tpu_build_info"]["series"]) == 1


def test_kernel_build_cache_counts_as_jit_cache_gauges():
    before = metrics.sample_jit_cache()
    metrics.record_kernel_build("compile", 1.5)
    metrics.record_kernel_build("load", 1.6)
    metrics.record_kernel_build("load", 0.01)
    after = metrics.sample_jit_cache()
    assert after["misses"] - before["misses"] == 1
    assert after["hits"] - before["hits"] == 1
    snap = metrics.snapshot()
    ev = {s["labels"]["event"]: s["value"]
          for s in snap["raft_kernel_build_events_total"]["series"]}
    assert ev == {"compile": 1.0, "load": 2.0}
    d0 = obs.device.jit_cache_delta(scope="t")
    assert d0["first_sample"]
    metrics.record_kernel_build("load", 0.0)
    assert obs.device.jit_cache_delta(scope="t")["hits"] == 1


def test_journal_corrupt_count_is_the_registry_counter():
    assert journalio.corrupt_count("case") == 0
    journalio.count_corrupt("case", 2)
    journalio.count_corrupt("checkpoint")
    journalio.count_corrupt("case", 0)
    assert journalio.corrupt_count("case") == 2
    assert journalio.corrupt_count("checkpoint") == 1
    series = metrics.snapshot()["raft_tpu_journal_corrupt_total"]["series"]
    assert {s["labels"]["kind"] for s in series} == {"case", "checkpoint"}


# ---------------------------------------------------------------------------
# tracing and the flight recorder
# ---------------------------------------------------------------------------

def test_spans_nest_aggregate_and_export(tmp_path):
    with obs.span("outer", case=1) as sp:
        with obs.span("inner", t=torch.zeros(3)):
            pass
        sp.set(cond=np.float64(2.5))
        assert obs.current_span() is sp
    spans = obs.spans()
    assert [(s["name"], s["depth"], s["parent"]) for s in spans] == [
        ("inner", 1, "outer"), ("outer", 0, None)]
    assert spans[0]["attrs"]["t"] == "tensor(3,)"
    assert spans[1]["attrs"] == {"case": 1, "cond": 2.5}
    agg = obs.aggregate()
    assert agg["outer"][1] == 1 and agg["inner"][1] == 1
    path = obs.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert [e["name"] for e in doc["traceEvents"]] == ["inner", "outer"]
    assert all(e["ph"] == "X" and e["cat"] == "raft_tpu"
               for e in doc["traceEvents"])


def _port_stream(path):
    rec = events.start(str(path), run_id="r1", kind="analyzeCases")
    with obs.span("analyzeCases", nCases=1):
        events.emit("case_start", case=0, n_cases=1)
        with obs.span("solveStatics", case="0"):
            pass
        events.emit("case_end", case=0, n_cases=1, ok=True, s=0.1)
    events.finish("r1")
    return rec


def test_port_stream_reads_and_validates_in_the_jax_package(tmp_path):
    from raft_tpu.obs import events as je

    path = tmp_path / "port.events.jsonl"
    _port_stream(path)
    mine, theirs = events.read(str(path)), je.read(str(path))
    assert mine == theirs
    assert events.validate(mine) == [] == je.validate(theirs)
    assert [e["type"] for e in mine] == [
        "begin", "span_open", "case_start", "span_open", "span_close",
        "case_end", "span_close", "end"]
    assert je.to_chrome_trace(theirs) == events.to_chrome_trace(mine)
    assert je.public_progress(je.progress(theirs)) == \
        events.public_progress(events.progress(mine))
    # a torn tail (a kill mid-write) is skipped by both readers, and the
    # incremental readers leave it unconsumed
    with open(path, "a") as f:
        f.write('{"seq": 99, "t": 1.0, "ty')
    assert events.read(str(path)) == je.read(str(path)) == mine
    a, off_a = events.read_incremental(str(path), 0)
    b, off_b = je.read_incremental(str(path), 0)
    assert a == b == mine and off_a == off_b < os.path.getsize(path)


def test_jax_stream_reads_and_validates_in_the_port(tmp_path):
    from raft_tpu import obs as jo
    from raft_tpu.obs import events as je

    path = tmp_path / "jax.events.jsonl"
    je.start(str(path), run_id="j1", kind="sweep_cases")
    with jo.span("sweep_cases", ncases=4):
        je.emit("quarantine", phase="sweep", lanes=[2], recovered=[2],
                quarantined=[])
    je.emit("probe", probe="sweep_lanes", values={"finite": [1, 1]})
    je.finish("j1")
    jo.reset_all()
    evs = events.read(str(path))
    assert events.validate(evs) == []
    assert evs[0]["schema"] == events.SCHEMA
    prog = events.public_progress(events.progress(evs))
    assert prog["status"] == "ok" and prog["quarantined"] == 1 \
        and prog["probes"] == 1
    assert events.to_chrome_trace(evs)["traceEvents"][0]["name"] \
        == "sweep_cases"
    # a gap in seq is flagged
    bad = [dict(e) for e in evs]
    bad[2]["seq"] += 5
    assert any("gap" in p for p in events.validate(bad))


def test_recorder_rotates_by_size(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_EVENTS_MAX_BYTES", "400")
    monkeypatch.setenv("RAFT_TPU_EVENTS_KEEP", "1")
    path = tmp_path / "rot.events.jsonl"
    events.start(str(path), run_id="rr", kind="x")
    for i in range(20):
        events.emit("probe", probe="p", values={"i": i})
    events.finish("rr")
    parts = sorted(p.name for p in tmp_path.iterdir())
    assert parts == ["rot.events.jsonl", "rot.events.jsonl.1"]
    assert events.read(str(path))[0]["type"] == "begin"
    assert events.read(str(path))[0]["part"] >= 1


def test_events_off_and_no_active_recorder(tmp_path, monkeypatch):
    events.emit("case_start", case=0)              # no recorder: a no-op
    monkeypatch.setenv("RAFT_TPU_EVENTS", "0")
    assert events.start(str(tmp_path / "x.jsonl"), "r", "k") is None
    assert not (tmp_path / "x.jsonl").exists()


# ---------------------------------------------------------------------------
# manifests, retention, ledgers
# ---------------------------------------------------------------------------

def test_manifest_validates_in_both_packages(tmp_path):
    from raft_tpu.obs import manifest as jman

    obs.configure(str(tmp_path))
    m = obs.RunManifest.begin(kind="analyzeCases", config={"nCases": 1})
    stub = tmp_path / f"analyzeCases_{m.run_id}.manifest.json"
    assert json.load(open(stub))["status"] == "running"
    assert m.extra["events"]["schema"] == events.SCHEMA
    with obs.span("analyzeCases"):
        pass
    m.add_probe_attempt(obs.ProbeAttempt(index=0, started_at="t0",
                                         outcome="ok"))
    m.add_probe_attempt({"index": 1, "started_at": "t1", "outcome": "ok",
                         "timeout_s": None, "error_class": None,
                         "message": None})
    paths = obs.finish_run(m, status="ok")
    doc = json.load(open(paths["manifest"]))
    assert obs.validate_manifest(doc) == [] == jman.validate_manifest(doc)
    assert doc["schema"] == jman.SCHEMA
    assert doc["probe_attempts"][0]["attempts"] == 2
    assert [p["name"] for p in doc["phases"]] == ["analyzeCases"]
    assert paths["trend"] is None and paths["ledger"] is None
    assert events.validate(events.read(paths["events"])) == []
    env = doc["environment"]
    assert env["torch_version"] == torch.__version__ and "git_sha" in env
    assert obs.validate_manifest({"schema": "x"})


def test_prune_runs_spares_running_stubs(tmp_path):
    d = str(tmp_path)
    for i, status in enumerate(("ok", "running", "ok", "ok")):
        stem = os.path.join(d, f"k_r{i}")
        with open(stem + ".manifest.json", "w") as f:
            json.dump({"status": status}, f)
        for suffix in (".trace.json", ".events.jsonl", ".events.jsonl.1"):
            open(stem + suffix, "w").close()
        t = time.time() - 100 + i
        os.utime(stem + ".manifest.json", (t, t))
    removed = obs.prune_runs(d, keep=2)
    assert sorted(os.path.basename(p) for p in removed) == [
        "k_r0.events.jsonl", "k_r0.events.jsonl.1", "k_r0.manifest.json",
        "k_r0.trace.json"]
    left = sorted(f for f in os.listdir(d) if f.endswith(".manifest.json"))
    assert left == ["k_r1.manifest.json", "k_r2.manifest.json",
                    "k_r3.manifest.json"]
    assert obs.prune_runs(d, keep=0) == []


def test_sweep_ledger_digests_as_the_jax_packages():
    from raft_tpu.obs import ledger as jl

    from raft_tpu_torch import ledger as L

    rng = np.random.default_rng(3)
    out = {"std": rng.random((5, 6)), "iters": np.array([3, 4, 4, 2, 9]),
           "converged": np.array([1, 1, 1, 1, 0], bool)}
    mine = L.ledger_from_sweep(out, config={"ncases": 5})
    theirs = jl.ledger_from_sweep(out, config={"ncases": 5})
    assert mine["digest"] == theirs["digest"]
    assert L.validate_ledger(mine) == [] == jl.validate_ledger(mine)
    mine["entries"][0]["metrics"]["iters"] = 99
    assert L.validate_ledger(mine)


def test_write_ledger_round_trips(tmp_path):
    from raft_tpu_torch import ledger as L

    led = L.new_ledger("sweep_cases")
    L.add_entry(led, "case0", {"std": [1.0, 2.0]})
    path = L.write_ledger(led, str(tmp_path / "a" / "l.json"))
    back = L.load_ledger(path)
    assert back["digest"] and L.validate_ledger(back) == []


# ---------------------------------------------------------------------------
# counted pulls, the guard, probes, knobs
# ---------------------------------------------------------------------------

def test_device_get_counts_events_arrays_and_bytes_per_phase():
    t = torch.arange(6, dtype=torch.float64)
    with transfers.phase("statics"):
        a, (b, c) = transfers.device_get(
            (t, (t[:2], np.ones(3, np.float32))), what="x")
        with transfers.phase("dynamics"):
            d = transfers.device_get({"k": t.to(torch.int32)}, what="y")
    assert isinstance(a, np.ndarray) and a.tolist() == list(range(6))
    assert isinstance(d["k"], np.ndarray)
    snap = transfers.snapshot()
    assert snap["phases"] == {
        "statics": {"events": 1, "arrays": 3, "bytes": 48 + 16 + 12},
        "dynamics": {"events": 1, "arrays": 1, "bytes": 24}}
    assert snap["total"] == {"events": 2, "arrays": 4, "bytes": 100}
    transfers.device_get(t, phase="outputs")
    assert transfers.counts("outputs")["events"] == 1
    assert transfers.counts("never") == {"events": 0, "arrays": 0,
                                         "bytes": 0}
    assert transfers.sync_point(torch.linalg.cond, torch.eye(2),
                                what="z", phase="dynamics") == 1.0
    delta = transfers.delta(snap, transfers.snapshot())
    assert delta["phases"] == {
        "outputs": {"events": 1, "arrays": 1, "bytes": 48},
        "dynamics": {"events": 1, "arrays": 0, "bytes": 0}}
    series = metrics.snapshot()["raft_tpu_host_transfers_total"]["series"]
    assert {(s["labels"]["phase"], s["labels"]["what"]) for s in series} \
        == {("statics", "x"), ("dynamics", "y"), ("outputs", "-"),
            ("dynamics", "z")}


def test_guard_is_vacuous_on_the_cpu_and_checks_its_mode():
    with transfers.guard("disallow"):
        assert float(torch.ones(())) == 1.0
    with pytest.raises(ValueError):
        with transfers.guard("sometimes"):
            pass


@pytest.mark.parametrize("mode,expect", [("off", 0), ("sampled", 2),
                                         ("full", 3)])
def test_probe_modes_budget_and_suppress(mode, expect, tmp_path):
    _config.set_probes_mode(mode)
    events.start(str(tmp_path / "p.jsonl"), run_id="p", kind="k")
    probes.probe("statics_newton", iters=4, residual=1e-7)
    probes.probe("drag_fixed_point", it=0, residual=np.arange(40.0))
    probes.probe("deep", level="full", x=torch.ones(2, 2))
    with probes.suppress("test"):
        assert not probes.enabled()
        probes.probe("statics_newton", iters=1)
    events.finish("p")
    assert metrics.counter_total("raft_tpu_probe_events_total") == expect
    evs = [e for e in events.read(str(tmp_path / "p.jsonl"))
           if e["type"] == "probe"]
    assert len(evs) == expect
    if expect:
        assert evs[0]["values"] == {"iters": 4, "residual": 1e-7}
        assert evs[1]["values"]["residual"] == {
            "n": 40, "finite": 40, "min": 0.0, "max": 39.0}
    if expect == 3:
        assert evs[2]["values"]["x"] == {"tensor": [2, 2]}
    # probes add no host transfer
    assert transfers.snapshot()["total"]["events"] == 0


def test_knobs_parse_as_the_jax_packages(monkeypatch):
    from raft_tpu import _config as jc

    cases = [("RAFT_TPU_PROBES", ("off", "0", "false", "full", "junk", "")),
             ("RAFT_TPU_TELEMETRY", ("full", "FAST", "junk")),
             ("RAFT_TPU_HEALTH", ("1", "on", "true", "0", "off", "junk"))]
    fns = {"RAFT_TPU_PROBES": "probes_mode",
           "RAFT_TPU_TELEMETRY": "telemetry_mode",
           "RAFT_TPU_HEALTH": "health_mode"}
    for var, values in cases:
        for v in values:
            monkeypatch.setenv(var, v)
            assert getattr(_config, fns[var])() == getattr(jc, fns[var])()
        monkeypatch.delenv(var)
        assert getattr(_config, fns[var])() == getattr(jc, fns[var])()
    assert _config.health_enabled() is False
    _config.set_health_mode("1")
    assert _config.health_enabled()
    with pytest.raises(ValueError):
        _config.set_probes_mode("loud")
    monkeypatch.setenv("RAFT_TPU_OBS_MAX_RUNS", "7")
    monkeypatch.setenv("RAFT_TPU_OBS_DIR", "/x")
    assert obs.max_runs() == 7 and obs.out_dir() == "/x"
    obs.configure("/y", max_runs=2)
    assert obs.max_runs() == 2 and obs.out_dir() == "/y"


def test_timing_report_reads_the_span_aggregate(capsys):
    from raft_tpu_torch.utils import profiling

    with profiling.timed("section_a"):
        pass
    rep = profiling.timing_report()
    assert rep["section_a"][1] == 1
    profiling.print_timing_report()
    assert "section_a" in capsys.readouterr().out
    profiling.set_verbosity(2)
    assert profiling.get_logger().getEffectiveLevel() == 10
    profiling.set_verbosity(0)
