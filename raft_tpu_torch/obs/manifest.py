"""Structured run manifests: one JSON record per solve or sweep run.

The port's copy of ``raft_tpu/obs/manifest.py``, under the same schema
(``raft_tpu.run_manifest/v1``): a ``RunManifest`` captures what ran,
where, and how it behaved — the environment (torch and CUDA versions,
the card's name, capability, memory and power limit, the git SHA), the
run config, per-phase wall times (from the span aggregate), a metrics
snapshot and ``extra`` facts.  Every manifest has exactly these
top-level keys (``REQUIRED_KEYS``, ``validate_manifest()``):

    schema, run_id, kind, status, started_at, finished_at, duration_s,
    environment, config, phases, metrics, probe_attempts, extra

Writers: ``Model.analyzeCases``, ``parallel.sweep.sweep_cases`` and
``sweep_farm``.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import uuid

SCHEMA = "raft_tpu.run_manifest/v1"

#: exactly the top-level keys of a serialized v1 manifest
REQUIRED_KEYS = (
    "schema", "run_id", "kind", "status", "started_at", "finished_at",
    "duration_s", "environment", "config", "phases", "metrics",
    "probe_attempts", "extra",
)

_STATUSES = ("running", "ok", "failed", "tpu_unavailable")


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


#: process-lifetime cache of the git probes — every run emits them
#: (environment capture, build-info gauge, ledger), and spawning a git
#: subprocess (plus a full working-tree scan for the dirty flag) per
#: sweep batch is pure overhead for facts that don't change mid-process
_GIT_CACHE: dict = {}


def _git(key: str, argv: list[str]):
    if key in _GIT_CACHE:
        return _GIT_CACHE[key]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = None
    try:
        r = subprocess.run(["git", "-C", root] + argv,
                           capture_output=True, text=True, timeout=10)
        if r.returncode == 0:
            out = r.stdout
    except Exception:
        pass
    _GIT_CACHE[key] = out
    return out


def git_sha() -> str | None:
    """HEAD SHA of the checkout this package runs from, or None.
    Cached for the process lifetime."""
    out = _git("sha", ["rev-parse", "HEAD"])
    return out.strip() if out is not None else None


def git_dirty() -> bool | None:
    """True when the checkout has uncommitted changes, None when git is
    unavailable.  Cached for the process lifetime."""
    out = _git("dirty", ["status", "--porcelain"])
    return bool(out.strip()) if out is not None else None


_CARD_CACHE: dict = {}


def card_power_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (its first line), or None where it does not run.  Cached for the
    process lifetime."""
    if "line" not in _CARD_CACHE:
        line = None
        try:
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=10)
            if r.returncode == 0 and r.stdout.strip():
                line = r.stdout.strip().splitlines()[0].strip()
        except (OSError, subprocess.SubprocessError):
            pass
        _CARD_CACHE["line"] = line
    return _CARD_CACHE["line"]


def capture_environment(devices: bool = True) -> dict:
    """Environment block: python, host, torch and git facts and, with
    ``devices``, the CUDA devices (name, capability, memory) and the
    first card's power limit from ``nvidia-smi``."""
    env = {
        "python": sys.version.split()[0],
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "git_sha": git_sha(),
    }
    try:
        import torch
        env["torch_version"] = torch.__version__
        env["cuda_version"] = torch.version.cuda
        if devices:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            env["backend"] = "cuda" if n else "cpu"
            env["device_count"] = n
            env["devices"] = []
            for i in range(min(n, 8)):
                p = torch.cuda.get_device_properties(i)
                env["devices"].append({
                    "name": torch.cuda.get_device_name(i),
                    "capability": list(torch.cuda.get_device_capability(i)),
                    "memory_bytes": int(p.total_memory)})
            if n:
                env["card"] = card_power_line()
        else:
            env["backend"] = None
            env["device_count"] = None
    except Exception as e:                      # pragma: no cover
        env["torch_error"] = f"{type(e).__name__}: {e}"
    return env


@dataclasses.dataclass
class ProbeAttempt:
    """One structured device-probe attempt record.

    ``attempts`` counts how many identical consecutive tries this
    record stands for — :func:`collapse_probe_attempts` merges runs of
    same-outcome records into one with the combined count and time
    span.
    """
    index: int
    started_at: str
    finished_at: str | None = None
    timeout_s: float | None = None
    outcome: str | None = None      # ok | timeout | error | cpu-fallback
    error_class: str | None = None  # e.g. TimeoutExpired, CalledProcessError
    message: str | None = None
    attempts: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


#: fields that define probe-attempt identity for collapsing (timestamps
#: and index vary between identical retries; outcome facts must not)
_PROBE_IDENTITY = ("outcome", "error_class", "message", "timeout_s")


def collapse_probe_attempts(attempts: list) -> list[dict]:
    """Collapse identical CONSECUTIVE probe-attempt records into one.

    Merged record: first record's ``index``/``started_at``, last
    record's ``finished_at``, summed ``attempts``.  Non-consecutive or
    differing records are preserved in order — the collapse only
    removes pure retry noise, never reorders the probe history.
    """
    out: list[dict] = []
    for att in attempts:
        att = att.to_dict() if isinstance(att, ProbeAttempt) else dict(att)
        att.setdefault("attempts", 1)
        prev = out[-1] if out else None
        if prev is not None and all(
                prev.get(k) == att.get(k) for k in _PROBE_IDENTITY):
            prev["attempts"] += att["attempts"]
            if att.get("finished_at"):
                prev["finished_at"] = att["finished_at"]
        else:
            out.append(att)
    return out


@dataclasses.dataclass
class RunManifest:
    kind: str
    run_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12])
    status: str = "running"
    started_at: str = dataclasses.field(default_factory=_utcnow)
    finished_at: str | None = None
    duration_s: float | None = None
    environment: dict = dataclasses.field(default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)
    phases: list = dataclasses.field(default_factory=list)
    metrics: dict = dataclasses.field(default_factory=dict)
    probe_attempts: list = dataclasses.field(default_factory=list)
    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def begin(cls, kind: str, config: dict = None,
              devices: bool = True) -> "RunManifest":
        """Start a manifest: stamps run id, start time, environment, and
        a baseline of the span aggregate so ``finish()`` reports phase
        times for THIS run only (the aggregate is process-cumulative).

        When an obs output directory is configured this also fires
        ``obs.begin_run``: a ``status="running"`` manifest stub is
        written (atomically replaced by ``finish_run`` — a killed run
        therefore leaves a discoverable record) and the flight recorder
        opens the run's event file."""
        m = cls(kind=kind, config=dict(config or {}),
                environment=capture_environment(devices=devices))
        from raft_tpu_torch.obs import tracing as _tracing
        m._phase_baseline = _tracing.aggregate()
        # the metrics snapshot embedded at finish is process-cumulative;
        # baseline the probe budget now so the trend store can attribute
        # probe volume to THIS run (trendstore.facts_from_manifest)
        from raft_tpu_torch.obs import metrics as _metrics
        m.extra["probe_events_at_begin"] = _metrics.counter_total(
            "raft_tpu_probe_events_total")
        from raft_tpu_torch import obs as _obs
        _obs.begin_run(m)
        return m

    def add_probe_attempt(self, attempt: ProbeAttempt | dict):
        """Append a probe attempt, collapsing it into the previous
        record when it is an identical consecutive retry.  The attempt
        also streams to the flight recorder as a ``probe_attempt``
        event."""
        if isinstance(attempt, ProbeAttempt):
            attempt = attempt.to_dict()
        self.probe_attempts = collapse_probe_attempts(
            self.probe_attempts + [dict(attempt)])
        from raft_tpu_torch.obs import events as _events
        _events.emit("probe_attempt", **dict(attempt))

    def finish(self, status: str = "ok", metrics: dict = None,
               phases: list = None) -> "RunManifest":
        """Stamp the end time and fold in the metrics snapshot and the
        per-phase wall times.  Defaults: the process-wide registry
        (snapshots are cumulative, Prometheus-style) and the span
        aggregate MINUS the baseline captured by ``begin()`` — so
        ``phases`` covers this run only even when several runs share
        the process."""
        if status not in _STATUSES:
            raise ValueError(f"status {status!r} not in {_STATUSES}")
        self.finished_at = _utcnow()
        t0 = datetime.datetime.fromisoformat(self.started_at)
        t1 = datetime.datetime.fromisoformat(self.finished_at)
        self.duration_s = (t1 - t0).total_seconds()
        self.status = status
        if metrics is None:
            from raft_tpu_torch.obs import metrics as _metrics
            # the kernel build cache, sampled into its gauges
            _metrics.sample_jit_cache()
            metrics = _metrics.snapshot()
        self.metrics = metrics
        if phases is None:
            from raft_tpu_torch.obs import tracing as _tracing
            base = getattr(self, "_phase_baseline", {})
            phases = []
            for name, (tot, calls) in _tracing.aggregate().items():
                tot0, calls0 = base.get(name, (0.0, 0))
                if calls > calls0:
                    phases.append({"name": name, "total_s": tot - tot0,
                                   "calls": calls - calls0})
            phases.sort(key=lambda p: -p["total_s"])
        self.phases = phases
        return self

    def to_dict(self) -> dict:
        d = {"schema": SCHEMA}
        d.update(dataclasses.asdict(self))
        return {k: d[k] for k in REQUIRED_KEYS}

    def write(self, path: str) -> str:
        """Serialize to JSON at ``path``; returns the path."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=str)
        os.replace(tmp, path)
        return path


def validate_manifest(doc: dict) -> list[str]:
    """Structural check of a serialized manifest against the v1 schema;
    returns a list of problems (empty == valid)."""
    problems = []
    if not isinstance(doc, dict):
        return ["manifest is not an object"]
    if doc.get("schema") != SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, expected {SCHEMA}")
    for k in REQUIRED_KEYS:
        if k not in doc:
            problems.append(f"missing key {k!r}")
    extra_keys = set(doc) - set(REQUIRED_KEYS)
    if extra_keys:
        problems.append(f"unknown top-level keys {sorted(extra_keys)}")
    if doc.get("status") not in _STATUSES:
        problems.append(f"status {doc.get('status')!r} not in {_STATUSES}")
    for k in ("environment", "config", "metrics", "extra"):
        if k in doc and not isinstance(doc[k], dict):
            problems.append(f"{k} is not an object")
    for k in ("phases", "probe_attempts"):
        if k in doc and not isinstance(doc[k], list):
            problems.append(f"{k} is not a list")
    for i, att in enumerate(doc.get("probe_attempts") or []):
        if not isinstance(att, dict):
            problems.append(f"probe_attempts[{i}] is not an object")
            continue
        for k in ("index", "started_at", "outcome"):
            if k not in att:
                problems.append(f"probe_attempts[{i}] missing {k!r}")
    return problems
