"""Crash-safe writes shared by the port's persistence tiers.

The jax-free parts of ``raft_tpu/obs/journalio.py`` that the case journal
(``recovery.CaseJournal``) and the checkpoint store
(``serve/checkpoint.CheckpointStore``) use: one serialization for JSON
records, one whole-file write (``tmp -> fsync -> rename``) and the count
of corrupt entries read as misses, kept in a plain module counter (the
port's metrics registry is a later slice).
"""
from __future__ import annotations

import json
import os
import threading

#: corrupt entries treated as misses on read, by journal kind ("case",
#: "checkpoint")
CORRUPT: dict[str, int] = {}
_LOCK = threading.Lock()


def _default(v):
    return str(v)


def dumps(doc: dict) -> str:
    """The one JSON serialization (compact separators, values JSON cannot
    take stringified)."""
    return json.dumps(doc, separators=(",", ":"), default=_default)


def fsync_write(path: str, data: bytes):
    """Crash-safe whole-file write: a per-writer tmp name (two writers of
    one path never truncate each other) -> write -> flush -> fsync ->
    atomic rename.  Raises on I/O trouble, after unlinking the tmp
    file; the caller owns its degradation."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def count_corrupt(kind: str, n: int = 1):
    """Count ``n`` corrupt entries of journal ``kind`` (never raises)."""
    if n <= 0:
        return
    with _LOCK:
        CORRUPT[str(kind)] = CORRUPT.get(str(kind), 0) + int(n)
