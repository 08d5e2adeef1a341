"""Flight recorder: a crash-safe, append-only JSONL event stream.

The port's copy of ``raft_tpu/obs/events.py``, under the same schema
(``raft_tpu.events/v1``), so a stream written by either package reads and
validates in the other.  Every span open/close, probe sample, recovery-
ladder transition, quarantine decision and per-case start and end is
appended to a run-scoped JSONL file as it happens and flushed line by
line, so the file is valid (but for at most one torn final line, which
:func:`read` skips) at every instant, the instant of a kill included.

Every line carries ``seq`` (monotonic per file), ``t`` (unix seconds)
and ``type``.  The first line is a ``begin`` record with the run identity
(``run_id``, ``kind``, ``pid``, ``hostname``, ``schema``); a clean
shutdown appends an ``end`` record, whose absence marks a killed run.
Event types the port emits:

================ =========================================================
type             emitted by
================ =========================================================
begin/end        recorder lifecycle (``start`` / ``finish``)
span_open        ``obs.span`` entry (name, ts, depth, parent, attrs)
span_close       ``obs.span`` exit, replayable into the Chrome trace
case_start       ``Model.analyzeCases`` per-case loop
case_end         ditto (``ok`` / ``resumed`` flags, wall seconds)
quarantine       per-case / per-lane quarantine decisions
recovery         every degradation-ladder transition (``recovery.py``)
probe            probe samples (``obs.probes``)
solve_health     a sweep batch's health summary (``RAFT_TPU_HEALTH=1``)
storage_degraded a chunked sweep or descent that stopped persisting
                 (ENOSPC)
ckpt_corrupt     a checkpoint that failed its integrity checks
ckpt_resume      a descent resumed from its newest valid checkpoint
ckpt_resume_rej. ``ckpt_resume_rejected``: a checkpoint of another spec
                 or carry layout, ignored (the descent starts fresh)
================ =========================================================

A recorder starts only when an output directory is configured
(``obs.begin_run``); ``RAFT_TPU_EVENTS=0`` turns it off.  Files rotate by
size (``RAFT_TPU_EVENTS_MAX_BYTES``, default 16 MiB, the newest
``RAFT_TPU_EVENTS_KEEP`` generations kept as ``<file>.1``, ...); each
rotation opens with a fresh ``begin`` record carrying its ``part``.  No
recorder failure takes down the solve it watches.
"""
from __future__ import annotations

import os
import socket
import threading
import time

import torch

from raft_tpu_torch import _config
from raft_tpu_torch.obs import journalio

SCHEMA = "raft_tpu.events/v1"

_LOCK = threading.Lock()
#: stack of active recorders (innermost last) — nested runs each keep
#: their own file; `emit` routes to the innermost
_STACK: list["FlightRecorder"] = []


def enabled() -> bool:
    """Flight recording active (when an output path is available)?
    ``RAFT_TPU_EVENTS=0`` turns it off."""
    return _config.events_enabled()


def max_bytes() -> int:
    return _config.events_max_bytes()


def keep_rotations() -> int:
    return _config.events_keep()


def _jsonable(v):
    """Best-effort JSON-safe conversion (numpy scalars -> numbers,
    small arrays -> lists, everything else -> str)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:
        import numpy as np
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray) and v.size <= 64:
            return v.tolist()
    except ImportError:                          # pragma: no cover
        pass
    if isinstance(v, torch.Tensor):
        # a tensor: reading its value would synchronize the card
        return f"tensor{tuple(v.shape)}"
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class FlightRecorder:
    """One run's append-only event file.

    Every :meth:`emit` serializes one line, writes it and flushes the
    stream, so the OS has the bytes even if the process is killed the
    next instant.  All methods are thread-safe and exception-silent —
    the recorder is telemetry, never a failure mode.
    """

    def __init__(self, path: str, run_id: str, kind: str):
        self.path = str(path)
        self.run_id = str(run_id)
        self.kind = str(kind)
        self.seq = 0
        self._lock = threading.Lock()
        # the shared crash-safe codec owns open/flush/rotate; this
        # recorder owns the schema (seq numbering, begin/end records)
        self._writer = journalio.JsonlWriter(
            self.path, max_bytes=max_bytes(), keep=keep_rotations(),
            header=self._begin_record)

    # -- file lifecycle ----------------------------------------------

    @property
    def part(self) -> int:
        return self._writer.part if self._writer is not None else 0

    def _begin_record(self, part: int) -> dict:
        rec = {"seq": self.seq, "t": round(time.time(), 6),
               "type": "begin", "schema": SCHEMA, "run_id": self.run_id,
               "kind": self.kind, "pid": os.getpid(),
               "hostname": socket.gethostname(), "part": int(part)}
        self.seq += 1
        return rec

    def close(self, status: str = "ok"):
        """Append the ``end`` record and close the file (idempotent)."""
        with self._lock:
            if self._writer is None or self._writer.closed:
                return
            try:
                self._emit_locked("end", status=str(status))
            except OSError:                      # pragma: no cover
                pass
            self._writer.close()

    @property
    def closed(self) -> bool:
        return self._writer is None or self._writer.closed

    # -- emission ----------------------------------------------------

    def _emit_locked(self, type_: str, **fields):
        rec = {"seq": self.seq, "t": round(time.time(), 6),
               "type": str(type_)}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        # assign this record's seq BEFORE the write: a size rotation
        # inside write() opens a fresh part whose begin header must
        # number itself after this record
        self.seq += 1
        self._writer.write(rec)

    def emit(self, type_: str, **fields):
        try:
            with self._lock:
                if self.closed:
                    return
                # the knobs stay env-dynamic (tests shrink them mid-run)
                self._writer.max_bytes = max_bytes()
                self._writer.keep = keep_rotations()
                self._emit_locked(type_, **fields)
        # a full disk / closed stream must never take down the run the
        # recorder is documenting (obs contract)
        except Exception:  # pragma: no cover
            pass


# ---------------------------------------------------------------------------
# module-level recorder stack (what the instrumented stack talks to)
# ---------------------------------------------------------------------------

def start(path: str, run_id: str, kind: str) -> FlightRecorder | None:
    """Open a recorder and make it the active event sink.  Returns the
    recorder, or None when recording is disabled or the open failed."""
    if not enabled():
        return None
    try:
        rec = FlightRecorder(path, run_id=run_id, kind=kind)
    except OSError:
        return None
    with _LOCK:
        _STACK.append(rec)
    return rec


def active() -> FlightRecorder | None:
    """The innermost active recorder, or None."""
    with _LOCK:
        return _STACK[-1] if _STACK else None


def emit(type_: str, **fields):
    """Append one event to the innermost active recorder (no-op when
    none is active) — the one call every instrumented site makes."""
    rec = active()
    if rec is not None:
        rec.emit(type_, **fields)


def finish(run_id: str, status: str = "ok") -> str | None:
    """Close and deactivate the recorder owned by ``run_id`` (no-op
    when that run never started one).  Returns the closed file's path,
    or None."""
    with _LOCK:
        rec = next((r for r in _STACK if r.run_id == str(run_id)), None)
        if rec is not None:
            _STACK.remove(rec)
    if rec is None:
        return None
    rec.close(status=status)
    return rec.path


def stop_all():
    """Close every active recorder without an ``end`` status ceremony
    (test isolation / ``obs.reset_all``)."""
    with _LOCK:
        recs = list(_STACK)
        del _STACK[:]
    for rec in recs:
        rec.close(status="aborted")


def _tracing_sink(kind: str, event: dict):
    """Span open/close hook installed on ``obs.tracing`` — forwards
    every span event into the active recorder."""
    if active() is not None:
        emit(kind, **event)


# ---------------------------------------------------------------------------
# replay: the read half of the recorder
# ---------------------------------------------------------------------------

def read(path: str) -> list[dict]:
    """Parse one event file, tolerating the torn final line a hard kill
    can leave (any unparseable line is skipped, never fatal) — the
    shared :func:`raft_tpu_torch.obs.journalio.read` codec."""
    return journalio.read(path)


def read_incremental(path: str, offset: int = 0) -> tuple[list[dict], int]:
    """Parse only the COMPLETE lines at byte ``offset`` and beyond;
    returns ``(events, new_offset)``.  A torn final line (mid-write or
    mid-kill) is left unconsumed for the next call — a follow loop's
    building block that avoids re-parsing a multi-MiB stream.  A ``new_offset`` smaller than the
    file is normal (torn tail); a file smaller than ``offset`` means
    the recorder rotated — re-enter at 0."""
    return journalio.read_incremental(path, offset)


def validate(events: list[dict]) -> list[str]:
    """Structural check of a parsed event stream; [] == valid.  A
    stream without an ``end`` record is still *valid* — that is the
    killed-run signature ``progress`` reports — but seq gaps,
    a missing/alien header, or untyped records are problems."""
    problems = []
    if not events:
        return ["no events"]
    head = events[0]
    if head.get("type") != "begin":
        problems.append("first event is not 'begin'")
    elif head.get("schema") != SCHEMA:
        problems.append(f"schema is {head.get('schema')!r}, "
                        f"expected {SCHEMA}")
    prev_seq = None
    for i, e in enumerate(events):
        if "type" not in e or "seq" not in e or "t" not in e:
            problems.append(f"events[{i}] missing seq/t/type")
            continue
        if prev_seq is not None and e["seq"] != prev_seq + 1:
            problems.append(
                f"events[{i}] seq {e['seq']} != {prev_seq + 1} "
                "(gap or reorder)")
        prev_seq = e["seq"]
    return problems


def to_chrome_trace(events: list[dict]) -> dict:
    """Replay the ``span_close`` records into the same Chrome Trace
    Event Format object ``tracing.chrome_trace()`` would have produced
    in-process (pid taken from the ``begin`` header) — the span tree of
    a killed run, reconstructed from disk."""
    pid = os.getpid()
    for e in events:
        if e.get("type") == "begin" and e.get("pid") is not None:
            pid = int(e["pid"])
            break
    out = []
    for e in events:
        if e.get("type") != "span_close":
            continue
        out.append({
            "name": e.get("name"),
            "cat": "raft_tpu",
            "ph": "X",
            "ts": float(e.get("ts", 0.0)) * 1e6,
            "dur": float(e.get("dur", 0.0)) * 1e6,
            "pid": pid,
            "tid": e.get("tid"),
            "args": e.get("attrs") or {},
        })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def progress(events: list[dict], state: dict = None) -> dict:
    """Per-case progress reconstructed from the stream — what
    a follow loop renders.

    Returns ``{run_id, kind, status, n_cases, done, failed, resumed,
    in_flight, avg_case_s, eta_s, probes, recoveries, quarantined,
    last_t}``;
    ``status`` is ``running`` until an ``end`` record appears (a killed
    run therefore reads ``running`` forever — exactly the forensic
    signal the manifest stub carries too).

    Incremental folding: pass a previous call's return value as
    ``state`` and only the NEWLY appended events — the follow loop's
    O(new) path (accumulators ride under the private ``"_"`` key;
    strip it before serializing the dict for users)."""
    if state is not None:
        info = state
        acc = info["_"]
    else:
        info = {"run_id": None, "kind": None, "status": "running",
                "n_cases": None, "done": 0, "failed": 0, "resumed": 0,
                "in_flight": None, "avg_case_s": None, "eta_s": None,
                "probes": 0, "recoveries": 0, "quarantined": 0,
                "last_t": None}
        acc = info["_"] = {"durations": [], "started": {}}
    durations = acc["durations"]
    started = acc["started"]
    for e in events:
        t = e.get("type")
        info["last_t"] = e.get("t", info["last_t"])
        if t == "begin":
            info["run_id"] = e.get("run_id")
            info["kind"] = e.get("kind")
        elif t == "end":
            info["status"] = e.get("status", "ok")
            info["in_flight"] = None
        elif t == "case_start":
            started[e.get("case")] = e.get("t")
            info["in_flight"] = e.get("case")
            if e.get("n_cases") is not None:
                info["n_cases"] = int(e["n_cases"])
        elif t == "case_end":
            case = e.get("case")
            info["done"] += 1
            if e.get("n_cases") is not None:
                info["n_cases"] = int(e["n_cases"])
            if e.get("resumed"):
                # journal restores are ~free — folding their s=0.0 into
                # the average would wreck the ETA of the solved cases
                info["resumed"] += 1
            else:
                if not e.get("ok", True):
                    info["failed"] += 1
                if isinstance(e.get("s"), (int, float)):
                    durations.append(float(e["s"]))
                elif case in started and e.get("t") is not None:
                    durations.append(float(e["t"]) - float(started[case]))
            if info["in_flight"] == case:
                info["in_flight"] = None
        elif t == "quarantine":
            info["quarantined"] += 1
        elif t == "probe":
            info["probes"] += 1
        elif t == "recovery":
            info["recoveries"] += 1
    info["eta_s"] = None                  # recomputed on every fold
    if durations:
        info["avg_case_s"] = sum(durations) / len(durations)
        if info["n_cases"]:
            remaining = max(0, info["n_cases"] - info["done"])
            if info["status"] == "running" and remaining:
                info["eta_s"] = info["avg_case_s"] * remaining
    return info


def public_progress(info: dict) -> dict:
    """``progress()`` output without the private ``"_"`` accumulators —
    what goes into JSON responses and rendered summaries."""
    return {k: v for k, v in info.items() if k != "_"}
