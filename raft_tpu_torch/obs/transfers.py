"""Host-transfer accounting: device-to-host pulls as counted events.

The port's copy of ``raft_tpu/obs/transfers.py``.  Every host pull of the
solve path goes through one of two sanctioned exit points:

- :func:`device_get` copies the tensors of a tree (tuple, list or dict
  of tensors, nested) to the host as numpy arrays;
- :func:`sync_point` wraps a call whose library code reads the card
  inside (``torch.linalg.cond``'s error check).

Each is counted as ONE event (with its arrays and bytes) against the
innermost active accounting phase (:func:`phase`, nestable), exported as
``raft_tpu_host_transfers_total{phase,what}`` /
``raft_tpu_host_transfer_bytes_total{phase}`` and kept in a process
snapshot (:func:`snapshot`, :func:`delta`) that ``Model.analyzeCases``
and the sweeps fold into their run manifests.  The count per case is a
pinned number (``tests/test_torch_obs_model.py``).

:func:`guard` is ``torch.cuda.set_sync_debug_mode``: under
``guard("disallow")`` any synchronizing CUDA operation raises (an
implicit ``bool(t)``, ``float(t)``, ``.cpu()``, ``.item()``, a blocking
host-to-device copy, boolean-mask indexing, ``torch.nonzero``, a linalg
error check), while :func:`device_get` and :func:`sync_point` stay legal
(they lift the mode around their own copy).  On the CPU, as the JAX
package's guard there, it is vacuous: host tensors need no transfer.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_LOCK = threading.Lock()
#: per-phase totals: {phase: {"events": int, "arrays": int, "bytes": int}}
_PHASES: dict[str, dict] = {}
#: stack of active phase names (the solve path is host-single-threaded;
#: nested phases label the innermost)
_STACK: list[str] = []

_UNPHASED = "unphased"
_MODES = {"disallow": "error", "log": "warn", "allow": 0}


def reset():
    """Forget all accumulated transfer accounting (test isolation)."""
    with _LOCK:
        _PHASES.clear()
        del _STACK[:]


@contextlib.contextmanager
def phase(name: str):
    """Attribute sanctioned pulls inside the block to ``name``."""
    with _LOCK:
        _STACK.append(str(name))
    try:
        yield
    finally:
        with _LOCK:
            if _STACK and _STACK[-1] == str(name):
                _STACK.pop()
            elif str(name) in _STACK:          # pragma: no cover
                _STACK.remove(str(name))


def current_phase() -> str:
    with _LOCK:
        return _STACK[-1] if _STACK else _UNPHASED


@contextlib.contextmanager
def _lifted():
    """Lift a :func:`guard` around one sanctioned host read."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    if prev:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if prev:
            torch.cuda.set_sync_debug_mode(prev)


def _host(tree, stats):
    """Host copy of ``tree``: tensors become numpy arrays, containers keep
    their type, anything else passes through; ``stats`` counts the
    arrays and bytes."""
    if isinstance(tree, torch.Tensor):
        stats[0] += 1
        stats[1] += tree.numel() * tree.element_size()
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray):
        stats[0] += 1
        stats[1] += tree.nbytes
        return tree
    if isinstance(tree, dict):
        return {k: _host(v, stats) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v, stats) for v in tree)
    return tree


def _count(ph: str, what: str, arrays: int, nbytes: int):
    from raft_tpu_torch.obs import metrics as _metrics

    with _LOCK:
        rec = _PHASES.setdefault(
            ph, {"events": 0, "arrays": 0, "bytes": 0})
        rec["events"] += 1
        rec["arrays"] += arrays
        rec["bytes"] += nbytes
    _metrics.counter(
        "raft_tpu_host_transfers_total",
        "sanctioned device->host transfer events on the solve path, "
        "by accounting phase and exit point").inc(
        1.0, phase=ph, what=str(what) or "-")
    _metrics.counter(
        "raft_tpu_host_transfer_bytes_total",
        "bytes pulled device->host through sanctioned exit points"
        ).inc(float(nbytes), phase=ph)


def device_get(tree, what: str = "", phase: str = None):
    """Sanctioned device-to-host pull: the tensors of ``tree`` copied to
    the host (numpy leaves, 0-d arrays for scalars), counted as ONE
    transfer event against ``phase`` (default: the innermost active
    :func:`phase`).  Legal inside :func:`guard`."""
    ph = str(phase) if phase is not None else current_phase()
    stats = [0, 0]
    with _lifted():
        out = _host(tree, stats)
    _count(ph, what, stats[0], stats[1])
    return out


def sync_point(fn, *args, what: str = "", phase: str = None, **kwargs):
    """Call ``fn(*args, **kwargs)``, whose library code reads the card
    (an error check's host read), as ONE counted transfer event; legal
    inside :func:`guard`.  Returns ``fn``'s result."""
    ph = str(phase) if phase is not None else current_phase()
    with _lifted():
        out = fn(*args, **kwargs)
    _count(ph, what, 0, 0)
    return out


@contextlib.contextmanager
def guard(mode: str = "disallow"):
    """Trap unsanctioned synchronizing operations inside the block:
    ``"disallow"`` raises, ``"log"`` warns, ``"allow"`` lets them pass
    (``torch.cuda.set_sync_debug_mode``); :func:`device_get` and
    :func:`sync_point` stay legal.  A no-op without CUDA."""
    if mode not in _MODES:
        raise ValueError(f"guard mode {mode!r} not in {tuple(_MODES)}")
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(_MODES[mode])
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def snapshot() -> dict:
    """JSON-able accounting snapshot:
    ``{"total": {...}, "phases": {name: {events, arrays, bytes}}}``."""
    with _LOCK:
        phases = {k: dict(v) for k, v in sorted(_PHASES.items())}
    total = {"events": 0, "arrays": 0, "bytes": 0}
    for rec in phases.values():
        for k in total:
            total[k] += rec[k]
    return {"total": total, "phases": phases}


def delta(before: dict, after: dict) -> dict:
    """Per-phase difference of two :func:`snapshot` dicts — the
    accounting of one run in a process that may have run others."""
    out = {"total": {}, "phases": {}}
    for ph, rec in after.get("phases", {}).items():
        prev = before.get("phases", {}).get(ph, {})
        d = {k: rec[k] - prev.get(k, 0) for k in rec}
        if any(d.values()):
            out["phases"][ph] = d
    for k in after.get("total", {}):
        out["total"][k] = (after["total"][k]
                           - before.get("total", {}).get(k, 0))
    return out


def counts(phase: str = None) -> dict:
    """One phase's totals (zeros when it never pulled)."""
    with _LOCK:
        rec = _PHASES.get(str(phase) if phase else _UNPHASED)
        return dict(rec) if rec else {"events": 0, "arrays": 0, "bytes": 0}
