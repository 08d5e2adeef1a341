"""Result ledger: content-addressed physics digests for cross-run diffing.

The jax-free parts of ``raft_tpu/obs/ledger.py`` (``compare_manifests``
apart), copied so the port
writes the same ``raft_tpu.ledger/v1`` documents and diffs them against
the golden ledgers in ``tests/golden/`` without importing the JAX
package.  A ledger is the numeric fingerprint of one run: per-case
response means/stds, RAO magnitude/phase summaries per DOF, mean offsets,
solver iteration counts and residuals, each entry content-addressed by a
SHA-256 of its canonical metrics; :func:`diff` compares two ledgers
metric by metric with a relative tolerance (per-metric fnmatch
overrides).
"""
from __future__ import annotations

import datetime
import fnmatch
import hashlib
import json
import math
import os
import platform
import socket
import uuid

SCHEMA = "raft_tpu.ledger/v1"

REQUIRED_KEYS = ("schema", "run_id", "kind", "created_at", "environment",
                 "config", "entries", "digest")


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _scalar(v):
    """Canonical JSON scalar for a metric value (floats kept full
    precision; numpy scalars unwrapped)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, str)):
        return v
    f = float(v)
    if math.isnan(f):
        return "nan"
    if math.isinf(f):
        return "inf" if f > 0 else "-inf"
    return f


def canonical_metrics(metrics: dict) -> dict:
    """Metrics dict with every value a JSON scalar or flat list of them
    (arrays flattened), keys sorted — the digest input."""
    out = {}
    for k in sorted(metrics):
        v = metrics[k]
        if hasattr(v, "tolist"):
            v = v.tolist()
        if isinstance(v, (list, tuple)):
            flat = []
            for x in v:
                flat.extend(x if isinstance(x, (list, tuple)) else [x])
            out[str(k)] = [_scalar(x) for x in flat]
        else:
            out[str(k)] = _scalar(v)
    return out


def digest_metrics(metrics: dict) -> str:
    """``sha256:<hex>`` of the canonical JSON of ``metrics`` — full
    float precision (repr round-trip), so digest equality means the
    numbers are bitwise-identical."""
    payload = json.dumps(canonical_metrics(metrics), sort_keys=True,
                         separators=(",", ":"))
    return "sha256:" + hashlib.sha256(payload.encode()).hexdigest()


def new_ledger(kind: str, run_id: str = None, config: dict = None,
               environment: dict = None) -> dict:
    return {
        "schema": SCHEMA,
        "run_id": run_id or uuid.uuid4().hex[:12],
        "kind": kind,
        "created_at": _utcnow(),
        "environment": dict(environment or {}),
        "config": dict(config or {}),
        "entries": [],
        "digest": None,
    }


def add_entry(ledger: dict, key: str, metrics: dict) -> dict:
    """Append one content-addressed entry; returns the entry."""
    entry = {"key": str(key), "metrics": canonical_metrics(metrics),
             "digest": digest_metrics(metrics)}
    ledger["entries"].append(entry)
    return entry


def finalize(ledger: dict) -> dict:
    """Stamp the ledger-level digest (over the sorted entry digests)."""
    body = json.dumps(sorted((e["key"], e["digest"])
                             for e in ledger["entries"]),
                      separators=(",", ":"))
    ledger["digest"] = "sha256:" + hashlib.sha256(body.encode()).hexdigest()
    return ledger


def write_ledger(ledger: dict, path: str) -> str:
    """Write ``ledger`` (finalized first when it has no digest) as JSON
    at ``path`` through a tmp file and an atomic rename; returns the
    path."""
    if ledger.get("digest") is None:
        finalize(ledger)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ledger, f, indent=1)
    os.replace(tmp, path)
    return path


def load_ledger(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def validate_ledger(doc: dict) -> list[str]:
    """Structural check against the v1 schema; [] == valid."""
    problems = []
    if not isinstance(doc, dict):
        return ["ledger is not an object"]
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, expected {SCHEMA}")
    for k in REQUIRED_KEYS:
        if k not in doc:
            problems.append(f"missing key {k!r}")
    if not isinstance(doc.get("entries"), list):
        problems.append("entries is not a list")
        return problems
    seen = set()
    for i, e in enumerate(doc["entries"]):
        if not isinstance(e, dict) or not {"key", "metrics", "digest"} <= set(e):
            problems.append(f"entries[{i}] missing key/metrics/digest")
            continue
        if e["key"] in seen:
            problems.append(f"duplicate entry key {e['key']!r}")
        seen.add(e["key"])
        if digest_metrics(e["metrics"]) != e["digest"]:
            problems.append(f"entries[{i}] ({e['key']!r}) digest mismatch")
    return problems


def capture_environment(model=None) -> dict:
    """Minimal run environment for the ledger header (the JAX package's
    manifest.capture_environment is not part of the port)."""
    import torch

    dev = getattr(model, "device", None)
    env = {"python": platform.python_version(),
           "hostname": socket.gethostname(), "pid": os.getpid(),
           "torch_version": torch.__version__,
           "device": None if dev is None else str(dev)}
    if dev is not None and torch.device(dev).type == "cuda":
        env["device_name"] = torch.cuda.get_device_name(torch.device(dev))
    return env


# ---------------------------------------------------------------------------
# ledgers of the instrumented entry points
# ---------------------------------------------------------------------------

_CHANS = ("surge", "sway", "heave", "roll", "pitch", "yaw")


def ledger_from_model(model, run_id: str = None) -> dict:
    """Ledger of a completed ``Model.analyzeCases`` run.

    One entry per (case, fowt) with response means/stds and RAO
    magnitude/phase summaries per DOF, one system entry per case (mean
    offsets, statics Newton iterations, dynamics condition number and
    solve residuals, drag fixed-point counts), a ``case{N}/failed`` entry
    in place of those for a quarantined case, plus an ``eigen`` entry
    when ``solveEigen`` has run; ``extra["failed_cases"]`` holds the
    quarantined cases' records.
    """
    config = {"nCases": len(model.results.get("case_metrics", {})),
              "nFOWT": model.nFOWT, "nw": model.nw, "nDOF": model.nDOF}
    if getattr(model, "mesh", None) is not None:
        # the topology rides in the config so a partitioned run is told
        # apart from a single-device one (its entries digest the same)
        from raft_tpu_torch.parallel import partition
        config["mesh"] = partition.mesh_facts(model.mesh)
    led = new_ledger(
        kind="analyzeCases", run_id=run_id, config=config,
        environment=capture_environment(model))
    records = getattr(model, "_case_records", {})
    for iCase in sorted(model.results.get("case_metrics", {})):
        per_case = model.results["case_metrics"][iCase]
        if "failed" in per_case:
            # quarantined case: a structured failure entry stands in for
            # the physics digests (the full record also rides in
            # ledger["extra"]["failed_cases"])
            frec = per_case["failed"]
            add_entry(led, f"case{iCase}/failed", {
                k: v for k, v in sorted(frec.items())
                if isinstance(v, (bool, int, float, str))})
            continue
        rec = records.get(str(iCase), {})
        for ifowt in sorted(k for k in per_case if isinstance(k, int)):
            m = per_case[ifowt]
            metrics = {}
            for ch in _CHANS:
                metrics[f"mean_{ch}"] = m[f"{ch}_avg"]
                metrics[f"std_{ch}"] = m[f"{ch}_std"]
                if f"{ch}_RAO_mag_max" in m:
                    metrics[f"rao_mag_max_{ch}"] = m[f"{ch}_RAO_mag_max"]
                    metrics[f"rao_mag_mean_{ch}"] = m[f"{ch}_RAO_mag_mean"]
                    metrics[f"rao_phase_peak_{ch}"] = m[f"{ch}_RAO_phase_peak"]
            if "Tmoor_avg" in m:
                metrics["tmoor_avg"] = m["Tmoor_avg"]
                metrics["tmoor_std"] = m["Tmoor_std"]
            frec = rec.get(f"fowt{ifowt}", {})
            for k in ("drag_iters", "drag_residual", "drag_converged"):
                if k in frec:
                    metrics[k] = frec[k]
            add_entry(led, f"case{iCase}/fowt{ifowt}", metrics)
        sysm = {}
        offsets = model.results.get("mean_offsets", [])
        if iCase < len(offsets):
            sysm["mean_offset"] = offsets[iCase]
        for k in ("statics_iters", "statics_residual", "cond_max",
                  "dyn_solve_residual"):
            if k in rec:
                sysm[k] = rec[k]
        if sysm:
            add_entry(led, f"case{iCase}/system", sysm)
    if "eigen" in model.results:
        add_entry(led, "eigen",
                  {"fn_hz": model.results["eigen"]["frequencies"]})
    # the quarantined cases' full records, as the JAX package's ledger
    # carries them
    led["extra"] = {"failed_cases": list(getattr(model, "failed_cases",
                                                 None) or [])}
    return finalize(led)


def ledger_from_sweep(out: dict, config: dict = None,
                      run_id: str = None) -> dict:
    """Ledger of one sweep batch from its host values (numpy ``std``
    (nc, 6), ``iters`` and ``converged`` (nc,)): per-case response stds
    and fixed-point counts, and a batch summary entry."""
    import numpy as np

    led = new_ledger(kind="sweep_cases", run_id=run_id,
                     config=dict(config or {}),
                     environment=capture_environment())
    std = np.asarray(out["std"])
    iters = np.asarray(out["iters"])
    conv = np.asarray(out["converged"])
    for i in range(std.shape[0]):
        add_entry(led, f"case{i}", {
            "std": std[i], "iters": int(iters[i]),
            "converged": bool(conv[i])})
    add_entry(led, "summary", {
        "ncases": int(std.shape[0]),
        "n_converged": int(conv.sum()),
        "iters_max": int(iters.max(initial=0)),
        "std_norm": float(np.linalg.norm(std))})
    return finalize(led)



# ---------------------------------------------------------------------------
# diffing
# ---------------------------------------------------------------------------

RESIDUAL_METRIC_PATTERNS = ("*residual*",)
RESIDUAL_TOL_FLOOR = 1e-2


def _tol_for(metric: str, tol_rel: float, per_metric: dict) -> float:
    for pat, t in (per_metric or {}).items():
        if fnmatch.fnmatch(metric, pat):
            return float(t)
    if any(fnmatch.fnmatch(metric, pat)
           for pat in RESIDUAL_METRIC_PATTERNS):
        return max(tol_rel, RESIDUAL_TOL_FLOOR)
    return tol_rel


def _rel(a, b) -> float:
    if a == b:
        return 0.0
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return math.inf           # non-numeric mismatch
    if math.isnan(fa) and math.isnan(fb):
        return 0.0
    denom = max(abs(fa), abs(fb))
    if denom == 0.0:
        return 0.0
    if not (math.isfinite(fa) and math.isfinite(fb)):
        return math.inf
    return abs(fa - fb) / denom


def _compare_values(va, vb):
    """Max elementwise relative deviation between two metric values
    (scalar or list); inf on shape/type mismatch."""
    la = va if isinstance(va, list) else [va]
    lb = vb if isinstance(vb, list) else [vb]
    if len(la) != len(lb):
        return math.inf, -1
    worst, worst_i = 0.0, -1
    for i, (a, b) in enumerate(zip(la, lb)):
        r = _rel(a, b)
        if r > worst:
            worst, worst_i = r, i
    return worst, worst_i


def diff(a: dict, b: dict, tol_rel: float = 1e-6,
         per_metric: dict = None, ignore: tuple = ()) -> dict:
    """Compare ledger ``b`` (current) against ``a`` (baseline).

    Returns a report dict: ``regressions`` lists every metric whose max
    elementwise relative deviation exceeds its tolerance (``tol_rel``,
    overridable per metric-name fnmatch pattern via ``per_metric``);
    ``added``/``removed`` list entry/metric keys present on one side
    only (also regressions — a silently vanished output is a drift).
    ``ok`` is True iff nothing regressed.
    """
    ea = {e["key"]: e for e in a.get("entries", [])}
    eb = {e["key"]: e for e in b.get("entries", [])}
    report = {
        "a": a.get("run_id"), "b": b.get("run_id"),
        "kind": (a.get("kind"), b.get("kind")),
        "tol_rel": tol_rel,
        "identical": (a.get("digest") is not None
                      and a.get("digest") == b.get("digest")),
        "added": sorted(set(eb) - set(ea)),
        "removed": sorted(set(ea) - set(eb)),
        "n_compared": 0, "n_entries": len(set(ea) & set(eb)),
        "regressions": [],
    }
    for key in sorted(set(ea) & set(eb)):
        ma, mb = ea[key]["metrics"], eb[key]["metrics"]
        if ea[key]["digest"] == eb[key]["digest"]:
            report["n_compared"] += len(ma)
            continue
        for name in sorted(set(ma) | set(mb)):
            full = f"{key}:{name}"
            if any(fnmatch.fnmatch(full, p) or fnmatch.fnmatch(name, p)
                   for p in ignore):
                continue
            if name not in ma or name not in mb:
                report["regressions"].append({
                    "entry": key, "metric": name,
                    "a": ma.get(name), "b": mb.get(name),
                    "rel": math.inf,
                    "why": "missing in " + ("baseline" if name not in ma
                                            else "current")})
                continue
            report["n_compared"] += 1
            rel, idx = _compare_values(ma[name], mb[name])
            tol = _tol_for(name, tol_rel, per_metric)
            if rel > tol:
                report["regressions"].append({
                    "entry": key, "metric": name, "index": idx,
                    "a": ma[name], "b": mb[name], "rel": rel, "tol": tol})
    report["ok"] = (not report["regressions"] and not report["added"]
                    and not report["removed"])
    return report


def _fmt_val(v):
    if isinstance(v, list):
        head = ", ".join(f"{x:.6g}" if isinstance(x, float) else str(x)
                         for x in v[:4])
        return f"[{head}{', ...' if len(v) > 4 else ''}]"
    if isinstance(v, float):
        return f"{v:.9g}"
    return str(v)


def format_diff(report: dict, max_rows: int = 40) -> str:
    """Human-readable rendering of a :func:`diff` report."""
    lines = [f"ledger diff: {report['a']} -> {report['b']} "
             f"(tol_rel={report['tol_rel']:g})"]
    if report.get("identical"):
        lines.append("  digests identical — nothing moved")
    for key in report["removed"]:
        lines.append(f"  REMOVED entry {key}")
    for key in report["added"]:
        lines.append(f"  ADDED   entry {key}")
    regs = report["regressions"]
    for r in regs[:max_rows]:
        why = r.get("why")
        if why:
            lines.append(f"  REGRESSION {r['entry']}:{r['metric']} — {why}")
        else:
            lines.append(
                f"  REGRESSION {r['entry']}:{r['metric']} "
                f"rel={r['rel']:.3g} (tol {r['tol']:g}): "
                f"{_fmt_val(r['a'])} -> {_fmt_val(r['b'])}")
    if len(regs) > max_rows:
        lines.append(f"  ... and {len(regs) - max_rows} more")
    lines.append(
        f"  {'OK' if report['ok'] else 'REGRESSED'}: "
        f"{len(regs)} regression(s) over {report['n_compared']} compared "
        f"metric(s) in {report['n_entries']} shared entrie(s)")
    return "\n".join(lines)


def blocking_regressions(report: dict, floor: float = 1e-12) -> list:
    """The regressions of a :func:`diff` report that count: every one,
    except a residual-class metric (``*residual*``) whose current values
    all sit at the machine floor (below ``floor``) and none above the
    baseline's — a solver whose rounding came out smaller, not a drift.
    The golden gate's 0.5 band on residuals admits a factor-2 spread of
    floor noise; equivalent Gauss-Jordan implementations spread wider
    than that on the same system (the JAX package's Pallas and jnp
    versions and this port's land at 9.4e-15, 1.1e-14 and 5.4e-15 on the
    VolturnUS-S golden case), while a blow-up raises the residual and
    still counts."""
    out = []
    for r in report.get("regressions", []):
        name = r.get("metric", "")
        a, b = r.get("a"), r.get("b")
        if (any(fnmatch.fnmatch(name, p) for p in RESIDUAL_METRIC_PATTERNS)
                and "why" not in r and a is not None and b is not None):
            la = a if isinstance(a, list) else [a]
            lb = b if isinstance(b, list) else [b]
            if len(la) == len(lb) and all(
                    isinstance(x, float) and isinstance(y, float)
                    and abs(y) < floor and abs(y) <= abs(x)
                    for x, y in zip(la, lb)):
                continue
        out.append(r)
    return out
