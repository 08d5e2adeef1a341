"""Write or check the observability goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per group, each with its own output and case-journal directories; the
inputs are those of ``tests/golden/recovery_golden.py``
(``raft_tpu_torch/models/recovery_cases.py``), on the same coarse grids:

- ``model.json``: OC3spar's first case on the coarse golden grid
  (0.02-0.2 Hz) through ``Model.analyzeCases`` with an output directory
  and ``RAFT_TPU_PROBES=sampled``: the finished spans (name, depth,
  parent, in order), the metric names with their kinds and label keys,
  the flight recorder's event types (probes apart) and its probe counts
  by name, the host transfers of the run per phase (the JAX package's
  budget) and the iteration counts;
- ``recovery.json``: the three-case cylinder under
  ``nan@dynamics:case=1``: the ``raft_tpu_recovery_attempts_total`` and
  ``raft_tpu_cases_failed_total`` series and the event types;
- ``sweep.json``: the four-case cylinder sweep (nIter 6) with
  ``health=True``, clean and under ``nan@sweep:lane=2``:
  ``health_residual``, ``health_cond``, ``iters``, ``converged`` and
  the ``_health_summary`` facts;
- ``prometheus.json``: a scripted series of counter, gauge and histogram
  operations (`SCRIPT`) and the text the JAX registry exposes after it.

    JAX_PLATFORMS=cpu python tests/golden/obs_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/obs_golden.py --write  # rewrite

``--only GROUP`` (repeatable) runs only the named groups.

Without ``--write`` the runs are compared with the committed files:
names, sequences, counts and text exactly, arrays at 1e-12.  Regenerate
only after an intentional change of the JAX package.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_DIR = os.path.join(HERE, "obs")
sys.path.insert(0, ROOT)

GROUPS = ("model", "recovery", "sweep", "prometheus")
TOL = 1e-12

#: the scripted registry operations of ``prometheus.json``: (kind, name,
#: help, method, value, labels); histograms take ITER_BUCKETS
SCRIPT = [
    ["counter", "raft_tpu_demo_total", "a counter", "inc", 1.0, {}],
    ["counter", "raft_tpu_demo_total", "a counter", "inc", 2.5,
     {"phase": "statics"}],
    ["counter", "raft_tpu_demo_total", "a counter", "inc", 1.0,
     {"phase": "dyn\"amics\\n"}],
    ["gauge", "raft_tpu_demo_gauge", "a gauge\nwith a newline", "set",
     1234567.0, {"case": "0"}],
    ["gauge", "raft_tpu_demo_gauge", "a gauge\nwith a newline", "set",
     1.25e-15, {"case": "1"}],
    ["gauge", "raft_tpu_demo_gauge", "a gauge\nwith a newline", "inc",
     3.0, {"case": "1"}],
    ["gauge", "raft_tpu_demo_gauge", "a gauge\nwith a newline", "set",
     1e16, {"case": "big"}],
    ["histogram", "raft_tpu_demo_iters", "a histogram", "observe", 4.0,
     {"case": "0"}],
    ["histogram", "raft_tpu_demo_iters", "a histogram", "observe", 13.0,
     {"case": "0"}],
    ["histogram", "raft_tpu_demo_iters", "a histogram", "observe", 60.0,
     {"case": "1"}],
    ["counter", "raft_tpu_nohelp_total", "", "inc", 7.0, {"b": "2",
                                                        "a": "1"}],
]


def replay(registry, buckets, script=SCRIPT):
    """Apply ``script`` to a metrics registry (either package's)."""
    for kind, name, help_, method, value, labels in script:
        if kind == "histogram":
            m = registry.histogram(name, help_, buckets=buckets)
        else:
            m = getattr(registry, kind)(name, help_)
        getattr(m, method)(value, **labels)


def _metric_shapes(snap: dict) -> dict:
    """{name: {"kind", "label_keys"}} of a registry snapshot."""
    return {name: {"kind": m["kind"],
                   "label_keys": sorted({",".join(sorted(s["labels"]))
                                         for s in m["series"]})}
            for name, m in snap.items()}


def _event_facts(path: str) -> dict:
    from raft_tpu.obs import events
    evs = events.read(path)
    probes = {}
    for e in evs:
        if e["type"] == "probe":
            probes[e["probe"]] = probes.get(e["probe"], 0) + 1
    return {"types": [e["type"] for e in evs if e["type"] != "probe"],
            "spans": [e["name"] for e in evs if e["type"] == "span_close"],
            "probes": probes, "problems": events.validate(evs)}


def _model(out_dir: str) -> dict:
    import jax

    from raft_tpu import obs
    from raft_tpu.model import Model
    from raft_tpu_torch.models import recovery_cases as RC

    obs.reset_all()
    obs.configure(out_dir)
    m = Model(RC.oc3spar_design(True, 1))
    m.analyzeCases()
    jax.effects_barrier()
    man = m.last_manifest.to_dict()
    rec = m._case_records["0"]
    return {
        "spans": [[s["name"], s["depth"], s["parent"]] for s in obs.spans()],
        "metrics": _metric_shapes(obs.snapshot()),
        "events": _event_facts(man["extra"]["events"]["path"]),
        "transfers": {ph: r["events"] for ph, r in
                      man["extra"]["host_transfers"]["phases"].items()},
        "statics_iters": rec["statics_iters"],
        "drag_iters": rec["fowt0"]["drag_iters"],
    }


def _recovery(out_dir: str) -> dict:
    import jax

    from raft_tpu import obs
    from raft_tpu.model import Model
    from raft_tpu.testing import faults
    from raft_tpu_torch.models import recovery_cases as RC

    obs.reset_all()
    obs.configure(out_dir)
    faults.install("nan@dynamics:case=1")
    try:
        m = Model(RC.cyl_design(3))
        m.analyzeCases()
    finally:
        faults.clear()
    jax.effects_barrier()
    snap = obs.snapshot()
    series = {name: sorted(([s["labels"], s["value"]]
                            for s in snap.get(name, {}).get("series", [])),
                           key=json.dumps)
              for name in ("raft_tpu_recovery_attempts_total",
                           "raft_tpu_cases_failed_total")}
    man = m.last_manifest.to_dict()
    return {"series": series,
            "events": _event_facts(man["extra"]["events"]["path"]),
            "failed_cases": [[c["case"], c["phase"], c["error"]]
                             for c in m.failed_cases]}


def _sweep(out_dir: str) -> dict:
    from raft_tpu import obs
    from raft_tpu.models.fowt import build_fowt
    from raft_tpu.parallel import sweep as S
    from raft_tpu.testing import faults
    from raft_tpu_torch.models import recovery_cases as RC

    fowt = build_fowt(*RC.sweep_fowt_args())
    Hs, Tp, beta = RC.sweep_inputs()
    facts = {}
    inner = S._health_summary

    def capture(*a, **k):
        facts["summary"] = inner(*a, **k)
        return facts["summary"]

    S._health_summary = capture
    out = {}
    for label, spec in (("clean", None), ("faulted", RC.SWEEP_FAULT)):
        obs.reset_all()
        facts.clear()
        faults.install(spec)
        try:
            o = S.sweep_cases(fowt, Hs, Tp, beta, nIter=RC.SWEEP_NITER,
                              health=True)
        finally:
            faults.clear()
        snap = obs.snapshot()
        out[label] = {
            "health_residual": np.asarray(o["health_residual"]).tolist(),
            "health_cond": np.asarray(o["health_cond"]).tolist(),
            "iters": np.asarray(o["iters"]).tolist(),
            "converged": np.asarray(o["converged"]).tolist(),
            "gauges": sorted(n for n in snap
                             if n.startswith("raft_tpu_solve_")),
            "summary": facts.get("summary"),
        }
    return out


def _prometheus(out_dir: str) -> dict:
    from raft_tpu.obs import metrics

    reg = metrics.MetricsRegistry()
    replay(reg, metrics.ITER_BUCKETS)
    return {"script": SCRIPT, "buckets": list(metrics.ITER_BUCKETS),
            "text": reg.to_prometheus()}


def _jsonable(v):
    if isinstance(v, float) and not math.isfinite(v):
        return repr(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    return v


def run_group(group: str, out: str) -> None:
    """One group of JAX runs in this process, written to ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_PROBES"] = "sampled"
    work = os.path.dirname(out)
    os.environ["RAFT_TPU_JOURNAL_DIR"] = os.path.join(work,
                                                      f"journal_{group}")
    import jax

    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    fn = {"model": _model, "recovery": _recovery, "sweep": _sweep,
          "prometheus": _prometheus}[group]
    doc = fn(os.path.join(work, f"obs_{group}"))
    doc["wall_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(_jsonable(doc), f)


def _sub(args):
    group, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", group, out], check=True)


def _close(a, b, path=""):
    """Nested equality: strings, ints and bools exactly, floats at TOL
    relative; returns the list of paths that differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in _close(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _close(x, y, f"{path}[{i}]")]
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if fa == fb:
            return []
        return [] if abs(fa - fb) <= TOL * max(abs(fa), abs(fb)) \
            else [f"{path}: {fa!r} != {fb!r}"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--only", action="append", choices=GROUPS,
                    help="run only this group (repeatable)")
    ap.add_argument("--run", nargs=2, metavar=("GROUP", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_group(*args.run)
        return 0

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(g, os.path.join(tmp, f"{g}.json"))
                for g in (args.only or GROUPS)]
        with ThreadPoolExecutor(len(jobs)) as pool:
            list(pool.map(_sub, jobs))
        for group, path in jobs:
            with open(path) as f:
                doc = json.load(f)
            print(json.dumps({group: {"wall_s": doc.pop("wall_s")}}))
            gold = os.path.join(OUT_DIR, f"{group}.json")
            if args.write:
                os.makedirs(OUT_DIR, exist_ok=True)
                with open(gold, "w") as f:
                    json.dump(doc, f, indent=1)
                    f.write("\n")
                continue
            with open(gold) as f:
                diffs = _close(json.load(f), doc, group)
            for d in diffs[:20]:
                print("  DIFFERS", d)
            ok = ok and not diffs
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
