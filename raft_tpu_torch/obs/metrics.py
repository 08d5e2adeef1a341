"""Process-wide metrics: counters, gauges, histograms with labels.

The port's copy of ``raft_tpu/obs/metrics.py``: one locked registry and
its two exports, ``snapshot()`` (a plain-JSON dict, embedded in run
manifests) and ``to_prometheus()`` (the Prometheus text exposition
format, byte for byte the JAX package's for the same operations).

In place of the JAX package's compile telemetry (``install_jax_hooks``,
``sample_jit_cache``: XLA compiles and jit-cache hits) the port counts
its kernel build cache (``ops/kernels/_build.py``): each nvcc build and
each load of the kernel library (`record_kernel_build`), sampled into
the same ``raft_jit_cache_hits`` / ``raft_jit_cache_misses`` gauges by
`sample_jit_cache`.
"""
from __future__ import annotations

import math
import os
import threading

DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0)
#: iteration-count shaped buckets (drag fixed points, Newton loops)
ITER_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 50.0)


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    def _bump(self, labels: dict, amount: float, absolute: bool):
        key = _labelkey(labels)
        with self._lock:
            if absolute:
                self._values[key] = float(amount)
            else:
                self._values[key] = self._values.get(key, 0.0) + float(amount)

    def clear(self):
        """Drop every series of this metric (info-style gauges whose
        label VALUES carry the facts — build info with a per-run
        ``run_id`` — re-record instead of accumulating stale series)."""
        with self._lock:
            self._values.clear()

    def series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._values.items())]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        self._bump(labels, amount, absolute=False)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels):
        self._bump(labels, value, absolute=True)

    def inc(self, amount: float = 1.0, **labels):
        self._bump(labels, amount, absolute=False)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # per label set: [bucket_counts..., +Inf count is implicit via n]
        self._hist: dict[tuple, dict] = {}

    def observe(self, value: float, **labels):
        value = float(value)
        key = _labelkey(labels)
        with self._lock:
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0, "n": 0}
            for i, b in enumerate(self.buckets):
                if value <= b:
                    h["counts"][i] += 1
            h["sum"] += value
            h["n"] += 1

    def observe_many(self, values, **labels):
        for v in values:
            self.observe(v, **labels)

    def series(self) -> list[dict]:
        with self._lock:
            out = []
            for key, h in sorted(self._hist.items()):
                cum = {}
                running = 0
                for i, b in enumerate(self.buckets):
                    # counts[] is already cumulative per bucket boundary
                    running = h["counts"][i]
                    cum[_fmt_float(b)] = running
                cum["+Inf"] = h["n"]
                out.append({"labels": dict(key), "count": h["n"],
                            "sum": h["sum"], "buckets": cum})
            return out


def _fmt_float(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(float(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _labelstr(labels: dict, extra: dict = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self):
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-able {name: {kind, help, series}} of everything recorded."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"kind": m.kind, "help": m.help,
                         "series": m.series()} for m in metrics}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for s in m.series():
                    labels = s["labels"]
                    for le, c in s["buckets"].items():
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_labelstr(labels, {'le': le})} {c}")
                    lines.append(f"{m.name}_sum{_labelstr(labels)} "
                                 f"{_fmt_value(s['sum'])}")
                    lines.append(f"{m.name}_count{_labelstr(labels)} "
                                 f"{s['count']}")
            else:
                for s in m.series():
                    lines.append(f"{m.name}{_labelstr(s['labels'])} "
                                 f"{_fmt_value(s['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt_value(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


#: the process-wide registry every raft_tpu component records into
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def counter_total(name: str) -> float:
    """Summed value across one counter's series (0.0 when unrecorded) —
    the per-run baselining hook for process-cumulative counters."""
    m = REGISTRY.snapshot().get(name) or {}
    return float(sum(s.get("value", 0.0) for s in m.get("series", [])))


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()


def record_build_info(run_id: str = None) -> dict:
    """Info-style ``raft_tpu_build_info`` gauge (value 1, facts as
    labels: git SHA, dirty working tree, package, torch and CUDA
    versions, the card's name, plus the process identity ``pid`` /
    ``hostname`` and, when given, the active ``run_id``).  Exactly one
    series exists at a time: re-recording clears the previous one.
    Returns the label dict."""
    import socket

    from raft_tpu_torch.obs.manifest import git_dirty, git_sha

    labels = {"git_sha": git_sha() or "unknown",
              "pid": str(os.getpid()),
              "hostname": socket.gethostname()}
    if run_id:
        labels["run_id"] = str(run_id)
    dirty = git_dirty()
    labels["dirty"] = "unknown" if dirty is None else str(dirty).lower()
    labels["version"] = "raft_tpu_torch"
    try:
        import torch
        labels["torch_version"] = torch.__version__
        labels["cuda_version"] = str(torch.version.cuda or "none")
        labels["device"] = (torch.cuda.get_device_name(0)
                            if torch.cuda.is_available() else "cpu")
    except Exception:                             # pragma: no cover
        labels["torch_version"] = "unavailable"
    g = gauge("raft_tpu_build_info",
              "build/commit identity and process identity of the "
              "running raft_tpu (info-style gauge, always 1)")
    g.clear()
    g.set(1.0, **labels)
    return labels


def record_solve_dispatch(backend: str, n, batch_elems, fused: bool = False):
    """Count a solve-backend dispatch decision of ``ops.linalg`` (made at
    every solve in the port): which backend (``cuda_fused`` /
    ``cuda_gj`` / ``plain_fused`` / ``plain_gj`` / ``lu``) took a
    real-embedded system of size ``n``.  Batch size travels as a gauge,
    not a label, to keep the series cardinality bounded."""
    counter("raft_solve_dispatch_total",
            "solve-backend dispatch decisions at trace time, by backend "
            "and real-embedded system size").inc(
        1.0, backend=str(backend), n=str(int(n)),
        fused=str(bool(fused)).lower())
    gauge("raft_solve_dispatch_batch_elems",
          "batch elements of the most recent solve dispatch per backend",
          ).set(float(batch_elems), backend=str(backend))


def record_solve_health(phase: str, residual_max, residual_med,
                        nonfinite_lanes, cond_max=None,
                        iters_max=None) -> None:
    """Publish one batch's solve-health summary (``RAFT_TPU_HEALTH=1``):
    worst/median per-lane relative residual ``|Z Xi - F| / |F|``, the
    count of lanes whose response went non-finite, and optionally the
    conditioning and drag fixed-point iteration ceiling.  ``phase`` is
    the producing pipeline (``sweep``), a small fixed vocabulary."""
    gauge("raft_tpu_solve_residual_rel",
          "per-batch relative residual of the batched RAO solve "
          "(max/median over lanes; health mode only)").set(
              float(residual_max), phase=str(phase), stat="max")
    gauge("raft_tpu_solve_residual_rel",
          "per-batch relative residual of the batched RAO solve "
          "(max/median over lanes; health mode only)").set(
              float(residual_med), phase=str(phase), stat="median")
    gauge("raft_tpu_solve_nonfinite_lanes",
          "lanes of the last batch whose response was non-finite "
          "(health mode only)").set(
              float(nonfinite_lanes), phase=str(phase))
    if cond_max is not None:
        gauge("raft_tpu_solve_condition_max",
              "max conditioning proxy of the batched impedance over "
              "lanes and frequencies (health mode only)").set(
                  float(cond_max), phase=str(phase))
    if iters_max is not None:
        gauge("raft_tpu_solve_drag_iters_max",
              "max drag fixed-point iterations over the batch "
              "(health mode only)").set(
                  float(iters_max), phase=str(phase))


def record_exec_cache_event(event: str):
    """Count an executable-cache event (hit/miss/store/error), also
    streamed to the flight recorder (the port has no executable cache
    yet; the counter keeps the JAX package's name for when it comes)."""
    counter("raft_exec_cache_events_total",
            "persistent executable cache events (hit / miss / store / "
            "error)").inc(1.0, event=str(event))
    from raft_tpu_torch.obs import events as _events
    _events.emit("exec_cache", event=str(event))


# ---------------------------------------------------------------------------
# kernel build cache telemetry (the counterpart of the JAX compile hooks)
# ---------------------------------------------------------------------------

#: process totals of the kernel build cache: "compile" (an nvcc build
#: ran), "load" (the kernel library was loaded, built now or earlier)
_BUILD_EVENTS = {"compile": 0, "load": 0}
_BUILD_LOCK = threading.Lock()


def record_kernel_build(event: str, seconds: float = 0.0):
    """Count one kernel build-cache event (``"compile"`` or ``"load"``)
    of ``ops/kernels/_build.py`` in
    ``raft_kernel_build_events_total{event}`` and its wall seconds in
    ``raft_kernel_build_seconds_total{event}``."""
    with _BUILD_LOCK:
        _BUILD_EVENTS[str(event)] = _BUILD_EVENTS.get(str(event), 0) + 1
    counter("raft_kernel_build_events_total",
            "kernel build-cache events (compile: nvcc ran; load: the "
            "kernel library was loaded)").inc(1.0, event=str(event))
    counter("raft_kernel_build_seconds_total",
            "wall seconds of kernel build-cache events").inc(
                max(0.0, float(seconds)), event=str(event))


def sample_jit_cache() -> dict:
    """The kernel build cache as hit/miss gauges: ``misses`` the nvcc
    builds, ``hits`` the loads that found the library already built —
    the counterpart of the JAX package's jit-cache sample (the same
    gauge names).  Returns the stats dict."""
    with _BUILD_LOCK:
        compiles = _BUILD_EVENTS.get("compile", 0)
        loads = _BUILD_EVENTS.get("load", 0)
    stats = {"hits": max(0, loads - compiles), "misses": compiles}
    gauge("raft_jit_cache_hits",
          "kernel library loads that found it already built "
          "(build-cache hits)").set(stats["hits"])
    gauge("raft_jit_cache_misses",
          "kernel library builds (each miss is an nvcc compile)"
          ).set(stats["misses"])
    return stats
