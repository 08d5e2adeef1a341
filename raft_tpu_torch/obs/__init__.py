"""raft_tpu_torch.obs — observability: tracing, metrics, manifests.

The port's copy of the JAX package's ``raft_tpu/obs`` layer (everything
it imports of that layer is copied here; nothing of ``raft_tpu`` is
imported):

- :mod:`~raft_tpu_torch.obs.tracing` — nested wall-time spans with
  attributes, Chrome-trace/Perfetto export, the name -> (total, calls)
  aggregate behind ``utils.profiling.timing_report()``;
- :mod:`~raft_tpu_torch.obs.metrics` — process-wide counters, gauges and
  histograms with JSON and Prometheus text exports;
- :mod:`~raft_tpu_torch.obs.manifest` — ``RunManifest``, one JSON record
  per ``analyzeCases`` / ``sweep_cases`` / ``sweep_farm`` run;
- :mod:`~raft_tpu_torch.obs.transfers` — counted host pulls per phase
  and the sync guard;
- :mod:`~raft_tpu_torch.obs.events` — the flight recorder, a crash-safe
  JSONL stream of span, case, probe, recovery and quarantine events;
- :mod:`~raft_tpu_torch.obs.probes` — live samples of values a counted
  pull brought back;
- :mod:`~raft_tpu_torch.obs.device` — allocator and build-cache
  telemetry.

File output is opt-in: ``configure(out_dir=...)`` or
``RAFT_TPU_OBS_DIR``.  Each instrumented run then writes
``<kind>_<run_id>.manifest.json`` (a ``status="running"`` stub at begin,
replaced at finish), ``<kind>_<run_id>.trace.json`` (``analyzeCases``),
``<kind>_<run_id>.ledger.json`` and the flight recorder's
``<kind>_<run_id>.events.jsonl``.  ``configure(..., max_runs=N)`` (or
``RAFT_TPU_OBS_MAX_RUNS``) keeps the newest N runs.  Without a
directory, spans and metrics still record in-process
(``Model.last_manifest``, ``timing_report()``, ``snapshot()``) and
nothing touches the filesystem.  The JAX package's trend store
(``obs/trendstore.py``) is not part of the port yet: ``finish_run``'s
``paths["trend"]`` is always None.
"""
from __future__ import annotations

import json
import os

from raft_tpu_torch import _config
from raft_tpu_torch.obs.tracing import (                        # noqa: F401
    span, current_span, spans, aggregate, reset as reset_tracing,
    chrome_trace, export_chrome_trace, dropped_spans,
    TraceContext, TRACE_HEADER,
)
from raft_tpu_torch.obs.metrics import (                        # noqa: F401
    REGISTRY, counter, gauge, histogram, snapshot, to_prometheus,
    counter_total, record_build_info, ITER_BUCKETS, record_solve_dispatch,
    record_exec_cache_event, record_solve_health, record_kernel_build,
    sample_jit_cache,
)
from raft_tpu_torch.obs.manifest import (                       # noqa: F401
    SCHEMA, RunManifest, ProbeAttempt, capture_environment,
    validate_manifest, git_sha, collapse_probe_attempts,
)
from raft_tpu_torch.obs import device  # noqa: F401
from raft_tpu_torch.obs import transfers  # noqa: F401
from raft_tpu_torch.obs import events  # noqa: F401
from raft_tpu_torch.obs import probes  # noqa: F401
from raft_tpu_torch.obs import tracing as _tracing_mod

# stream span open/close into the flight recorder whenever one is
# active (a cheap no-op check per span otherwise)
_tracing_mod.set_sink(events._tracing_sink)

_OUT_DIR: str | None = None
_MAX_RUNS: int | None = None


def configure(out_dir: str | None, max_runs: int | None = None):
    """Set (or clear, with None) the output directory, which overrides
    ``RAFT_TPU_OBS_DIR``; ``max_runs`` bounds the runs kept there
    (falls back to ``RAFT_TPU_OBS_MAX_RUNS``; None/0 = unbounded)."""
    global _OUT_DIR, _MAX_RUNS
    _OUT_DIR = out_dir
    _MAX_RUNS = int(max_runs) if max_runs else None


def out_dir() -> str | None:
    """Active output directory, or None when file output is off."""
    return _OUT_DIR or _config.obs_dir()


def max_runs() -> int | None:
    """Active retention bound (runs kept on disk), or None."""
    return _MAX_RUNS or _config.obs_max_runs()


#: artifact suffixes that make up one run's on-disk record (the event
#: file may also have rotated ``.events.jsonl.N`` siblings)
_RUN_SUFFIXES = (".manifest.json", ".trace.json", ".ledger.json",
                 ".events.jsonl")


def _is_running_stub(path: str) -> bool:
    """True when ``path`` is a ``status="running"`` manifest: an
    in-flight or killed run, which retention never deletes."""
    try:
        with open(path) as f:
            return json.load(f).get("status") == "running"
    except (OSError, ValueError):
        return False


def prune_runs(directory: str, keep: int) -> list[str]:
    """Delete the oldest runs' artifact sets from ``directory`` so at
    most ``keep`` runs (counted by their ``*.manifest.json``) remain;
    ``status="running"`` stubs are exempt.  Returns the removed paths."""
    try:
        manifests = [f for f in os.listdir(directory)
                     if f.endswith(".manifest.json")
                     and not _is_running_stub(os.path.join(directory, f))]
    except OSError:
        return []
    if keep <= 0 or len(manifests) <= keep:
        return []

    def _mtime(f):
        try:
            return os.path.getmtime(os.path.join(directory, f))
        except OSError:
            return 0.0
    manifests.sort(key=_mtime)
    removed = []
    for f in manifests[:len(manifests) - keep]:
        stem = f[:-len(".manifest.json")]
        victims = [stem + suffix for suffix in _RUN_SUFFIXES]
        try:
            victims += [n for n in os.listdir(directory)
                        if n.startswith(stem + ".events.jsonl.")]
        except OSError:                              # pragma: no cover
            pass
        for name in victims:
            path = os.path.join(directory, name)
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                pass
    return removed


def begin_run(manifest: RunManifest) -> dict:
    """The hook ``RunManifest.begin`` fires: with an output directory,
    write a ``status="running"`` manifest stub and start the flight
    recorder on ``<kind>_<run_id>.events.jsonl`` (registered in
    ``manifest.extra["events"]``).  Returns ``{"manifest", "events"}``
    paths (None where nothing was written); never raises: telemetry
    must not take down the run it documents."""
    paths = {"manifest": None, "events": None}
    try:
        d = out_dir()
        if not d:
            return paths
        stem = f"{manifest.kind}_{manifest.run_id}"
        paths["manifest"] = manifest.write(
            os.path.join(d, stem + ".manifest.json"))
        if events.enabled():
            rec = events.start(os.path.join(d, stem + ".events.jsonl"),
                               run_id=manifest.run_id,
                               kind=manifest.kind)
            if rec is not None:
                manifest.extra["events"] = {"schema": events.SCHEMA,
                                            "path": rec.path}
                paths["events"] = rec.path
    except OSError:
        pass
    return paths


def finish_run(manifest: RunManifest, status: str = "ok",
               write_trace: bool = True, ledger: dict = None) -> dict:
    """Finish ``manifest``, close its flight recorder and, with an output
    directory, write the manifest (replacing the ``running`` stub), the
    Chrome trace and, when given, the ledger; then apply ``max_runs``.
    Returns ``{"manifest", "trace", "ledger", "events", "trend"}`` paths
    (``trend`` always None: no trend store in the port yet).  I/O
    errors are swallowed, as in ``begin_run``."""
    from raft_tpu_torch.ledger import write_ledger

    manifest.finish(status)
    paths = {"manifest": None, "trace": None, "ledger": None,
             "events": None, "trend": None}
    paths["events"] = events.finish(manifest.run_id, status=status)
    try:
        d = out_dir()
        if d:
            stem = f"{manifest.kind}_{manifest.run_id}"
            paths["manifest"] = manifest.write(
                os.path.join(d, stem + ".manifest.json"))
            if write_trace:
                paths["trace"] = export_chrome_trace(
                    os.path.join(d, stem + ".trace.json"))
            if ledger is not None:
                paths["ledger"] = write_ledger(
                    ledger, os.path.join(d, stem + ".ledger.json"))
            keep = max_runs()
            if keep:
                prune_runs(d, keep)
    except OSError:
        pass
    return paths


def reset_all():
    """Reset every in-process pillar (span buffer and aggregate, metrics
    registry, build-cache baselines, transfer accounting, active flight
    recorders) and the configured output directory — for test
    isolation; call ``configure(...)`` again afterwards to keep
    writing."""
    reset_tracing()
    REGISTRY.reset()
    device.reset_jit_cache_baseline()
    transfers.reset()
    events.stop_all()
    configure(None)
