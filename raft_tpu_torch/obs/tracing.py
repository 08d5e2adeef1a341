"""Span-based tracing: nested wall-time spans with attributes.

The port's copy of ``raft_tpu/obs/tracing.py``.  The process-wide tracer
records every finished span into (a) a bounded event buffer exportable
as Chrome-trace/Perfetto JSON and (b) a locked name -> (total_seconds,
calls) aggregate (``utils.profiling.timing_report`` reads it).  A span's
times are host wall times: opening or closing one never synchronizes the
card.

Usage::

    from raft_tpu_torch import obs

    with obs.span("solveDynamics", case=3) as sp:
        ...
        sp.set(cond_max=1.2e4)          # attach attributes mid-span

    obs.export_chrome_trace("trace.json")   # load in ui.perfetto.dev

Spans nest through a thread-local stack; threads share the buffer and
the aggregate under a lock.  The Chrome-trace format (``cat``
``"raft_tpu"``) and the span-event fields are the JAX package's, so the
two packages' traces and flight-recorder streams read alike.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

#: hard cap on buffered span events — a runaway sweep must not OOM the
#: host; past the cap spans still feed the aggregate but drop from the
#: Chrome-trace buffer (`dropped_spans()` reports how many)
MAX_SPANS = 200_000

_LOCK = threading.Lock()
_SPANS: list[dict] = []
_AGG: dict[str, list] = {}          # name -> [total_seconds, calls]
_DROPPED = 0
_T0 = time.perf_counter()           # trace time origin (relative us in export)
_LOCAL = threading.local()
#: optional live event sink fn(kind, payload) — the flight recorder
#: (obs.events) registers here so span open/close stream to disk as
#: they happen; exceptions are swallowed (telemetry never fails a span)
_SINK = None


def set_sink(fn):
    """Install (or clear, with None) the live span-event sink."""
    global _SINK
    _SINK = fn


def _to_sink(kind: str, payload: dict):
    sink = _SINK
    if sink is None:
        return
    try:
        sink(kind, payload)
    # the sink is best-effort telemetry; a failing recorder must never
    # break the span protocol around solver code
    except Exception:  # pragma: no cover
        pass


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


def _jsonable(v):
    """Best-effort JSON-safe conversion for span attributes (numpy
    scalars become Python numbers, everything else falls back to str)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        import numpy as np
        if isinstance(v, np.generic):
            return v.item()
    except ImportError:                      # pragma: no cover
        pass
    if isinstance(v, torch.Tensor):
        # a tensor: reading its value would synchronize the card
        return f"tensor{tuple(v.shape)}"
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError):
        return str(v)


class ActiveSpan:
    """Handle yielded by ``span()``: carries the name/attrs and accepts
    late attributes via ``set(**attrs)`` while the span is open."""

    __slots__ = ("name", "attrs", "t0", "depth", "parent")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = {k: _jsonable(v) for k, v in attrs.items()}
        self.t0 = 0.0
        self.depth = 0
        self.parent = None

    def set(self, **attrs):
        for k, v in attrs.items():
            self.attrs[k] = _jsonable(v)
        return self


@contextlib.contextmanager
def span(name: str, **attrs):
    """Open a nested, attributed wall-time span around a code block."""
    global _DROPPED
    sp = ActiveSpan(name, attrs)
    stack = _stack()
    sp.parent = stack[-1].name if stack else None
    sp.depth = len(stack)
    stack.append(sp)
    sp.t0 = time.perf_counter()
    if _SINK is not None:
        _to_sink("span_open", {
            "name": name, "ts": sp.t0 - _T0,
            "tid": threading.get_ident(), "depth": sp.depth,
            "parent": sp.parent, "attrs": dict(sp.attrs)})
    try:
        yield sp
    finally:
        dur = time.perf_counter() - sp.t0
        if stack and stack[-1] is sp:
            stack.pop()
        event = {
            "name": name,
            "ts": sp.t0 - _T0,
            "dur": dur,
            "tid": threading.get_ident(),
            "depth": sp.depth,
            "parent": sp.parent,
            "attrs": dict(sp.attrs),
        }
        with _LOCK:
            entry = _AGG.setdefault(name, [0.0, 0])
            entry[0] += dur
            entry[1] += 1
            if len(_SPANS) < MAX_SPANS:
                _SPANS.append(event)
            else:
                _DROPPED += 1
        _to_sink("span_close", event)


def current_span() -> ActiveSpan | None:
    """The innermost open span on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def spans() -> list[dict]:
    """Snapshot of the finished-span buffer (oldest first)."""
    with _LOCK:
        return [dict(e) for e in _SPANS]


def dropped_spans() -> int:
    with _LOCK:
        return _DROPPED


def aggregate(reset: bool = False) -> dict:
    """{name: (total_seconds, calls)} across all finished spans."""
    with _LOCK:
        out = {k: tuple(v) for k, v in _AGG.items()}
        if reset:
            _AGG.clear()
    return out


def reset():
    """Clear the span buffer AND the aggregate (open spans unaffected)."""
    global _DROPPED
    with _LOCK:
        _SPANS.clear()
        _AGG.clear()
        _DROPPED = 0


def chrome_trace() -> dict:
    """The finished spans as a Chrome Trace Event Format object
    (``{"traceEvents": [...]}``, "X" complete events, microsecond
    timestamps) — loadable in ui.perfetto.dev or chrome://tracing."""
    pid = os.getpid()
    events = []
    for e in spans():
        events.append({
            "name": e["name"],
            "cat": "raft_tpu",
            "ph": "X",
            "ts": e["ts"] * 1e6,
            "dur": e["dur"] * 1e6,
            "pid": pid,
            "tid": e["tid"],
            "args": e["attrs"],
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str) -> str:
    """Write ``chrome_trace()`` as JSON; returns the path."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path


# ---------------------------------------------------------------------------
# distributed trace context (request identity across processes)
# ---------------------------------------------------------------------------

#: HTTP header carrying the context across the router -> replica hop
TRACE_HEADER = "X-Raft-Trace"

_HEX = set("0123456789abcdef")


def _is_hex_id(s, n: int) -> bool:
    return (isinstance(s, str) and len(s) == n and set(s) <= _HEX
            and set(s) != {"0"})


class TraceContext:
    """W3C-traceparent-style request identity: a 128-bit ``trace_id``
    shared by every hop of one request's journey, a 64-bit ``span_id``
    naming the current hop, and the ``parent_id`` of the hop that spawned
    it.  Immutable by convention; derive hops with :meth:`child`.

    The wire form (``to_header`` / ``parse``) is the W3C ``traceparent``
    layout ``00-<trace_id>-<span_id>-01``; a bare ``<trace_id>-<span_id>``
    pair is accepted too.  Anything malformed parses to ``None`` — the
    caller mints a fresh context instead of propagating garbage.

    Allocation-only on the hot path: minting draws 24 random bytes and
    builds three strings; nothing is locked, written, or signalled.
    """

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str, parent_id: str = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh root context (new trace_id, no parent)."""
        return cls(os.urandom(16).hex(), os.urandom(8).hex())

    def child(self) -> "TraceContext":
        """The next hop: same trace, fresh span, parented on this one."""
        return TraceContext(self.trace_id, os.urandom(8).hex(),
                            parent_id=self.span_id)

    @classmethod
    def parse(cls, header) -> "TraceContext | None":
        """Parse a ``TRACE_HEADER`` value; None when malformed."""
        if not isinstance(header, str):
            return None
        parts = header.strip().lower().split("-")
        if len(parts) == 4 and parts[0] == "00":    # full traceparent
            parts = parts[1:3]
        if len(parts) != 2:
            return None
        tid, sid = parts
        if not (_is_hex_id(tid, 32) and _is_hex_id(sid, 16)):
            return None
        return cls(tid, sid)

    @classmethod
    def from_header(cls, header) -> "TraceContext":
        """Parse, or mint a fresh root on a missing/malformed header."""
        return cls.parse(header) or cls.mint()

    def to_header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def as_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            d["parent_id"] = self.parent_id
        return d

    @classmethod
    def from_dict(cls, d) -> "TraceContext | None":
        """Rehydrate from a WAL/provenance dict; None when not a valid
        serialized context (tolerates foreign keys riding along)."""
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not (_is_hex_id(tid, 32) and _is_hex_id(sid, 16)):
            return None
        pid = d.get("parent_id")
        return cls(tid, sid, parent_id=pid if _is_hex_id(pid, 16) else None)

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, {self.span_id!r}, "
                f"parent_id={self.parent_id!r})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.parent_id == other.parent_id)
