"""Checkpoint store for long-running work (preemption tolerance).

Port of ``raft_tpu/serve/checkpoint.py``.  ``parallel.sweep.
sweep_cases_chunked`` persists each solved chunk of a large case table
here, so a killed sweep re-solves only its unfinished chunks.

Integrity contract:

- every checkpoint is written through ``obs.journalio.fsync_write``
  (``tmp -> fsync -> rename``) with a size + sha256 sidecar written
  last: a crash mid-put leaves a torn checkpoint that reads as a miss,
  never as state;
- reads verify the sidecar, the payload's size and sha256, the npz parse
  and the key/step check (the sidecar must answer for the requested key
  and step); any failure is delete-and-miss, counted, and `latest` falls
  back one step to the next older checkpoint;
- a transient read ``OSError`` (the ``eio@checkpoint`` fault) is a
  counted plain miss: deletion is kept for proven corruption.

A write that fails with proven ENOSPC raises
``errors.StorageExhausted``, which the caller sheds; every other
write failure is a counted gap.  Fault seams
(:mod:`raft_tpu_torch.testing.faults`): ``corrupt@checkpoint[:entry=HEX]
[:step=N]`` damages the bytes read before the checks; ``enospc@checkpoint``
injects the full-disk write failure; ``eio@checkpoint`` the transient
read error.  Counts live in :meth:`CheckpointStore.stats`, the
directory's bytes in the ``raft_tpu_disk_bytes`` gauge; ``budget_bytes``
makes a put over budget the same typed ``StorageExhausted``.
"""
from __future__ import annotations

import errno as _errno
import hashlib
import io
import json
import logging
import os
import re
import threading
import time

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.obs import journalio
from raft_tpu_torch.testing import faults

_LOG = logging.getLogger("raft_tpu_torch.serve.checkpoint")

SCHEMA = "raft_tpu.serve.checkpoint/v1"

_STEP_RE = re.compile(r"^(?P<stem>.+)\.step(?P<step>\d+)\.sum$")


def is_enospc(e: BaseException | None, _depth: int = 8) -> bool:
    """True when ``e`` (or its cause/context chain, bounded) is a proven
    out-of-space failure."""
    while e is not None and _depth > 0:
        if isinstance(e, OSError) and e.errno == _errno.ENOSPC:
            return True
        e = e.__cause__ or e.__context__
        _depth -= 1
    return False


def _stem(key: str) -> str:
    """File-name stem of a key: the bare hex of a ``sha256:<hex>`` digest
    (also what the ``entry=HEX`` qualifier matches), or the key
    sanitized."""
    stem = str(key).rsplit(":", 1)[-1]
    return re.sub(r"[^A-Za-z0-9_.-]", "_", stem)


def _pack(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{str(k): np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _unpack(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k].copy() for k in z.files}


def disk_gauge(component: str, nbytes: int):
    """Set the per-component ``raft_tpu_disk_bytes`` gauge (guarded:
    telemetry never takes down a persistence path)."""
    try:
        from raft_tpu_torch.obs.metrics import record_disk_bytes
        record_disk_bytes(component, nbytes)
    except Exception:  # pragma: no cover
        pass


class CheckpointStore:
    """One checkpoint directory (see the module docstring); thread-safe.

    ``budget_bytes`` bounds the directory: a put that would exceed it
    raises the same typed ``StorageExhausted`` a real ENOSPC does, so the
    serving layer's shed ladder can be driven before a disk fills.
    ``component`` labels the ``raft_tpu_disk_bytes`` gauge."""

    #: a payload younger than this with no sidecar may be a concurrent put
    #: that has not landed its sidecar yet, and is left alone; older ones
    #: are torn-put orphans and are reclaimed
    TORN_GRACE_S = 60.0

    def __init__(self, ckpt_dir: str, *, budget_bytes: int = None,
                 component: str = "checkpoint"):
        self.dir = str(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.budget_bytes = int(budget_bytes) if budget_bytes else None
        self.component = str(component)
        self._lock = threading.Lock()
        self._bytes = journalio.dir_bytes(self.dir)
        self._counts = {k: 0 for k in (
            "writes", "write_errors", "enospc", "hits", "misses",
            "corrupt", "read_errors", "deletes")}
        disk_gauge(self.component, self._bytes)

    def _count(self, name: str, n: int = 1):
        with self._lock:
            self._counts[name] += n

    # -- paths -----------------------------------------------------------

    def _paths(self, key: str, step: int) -> tuple[str, str]:
        base = os.path.join(self.dir, f"{_stem(key)}.step{int(step)}")
        return base + ".npz", base + ".sum"

    def steps(self, key: str) -> list[int]:
        """Steps of ``key`` with a sidecar on disk, ascending."""
        stem = _stem(key)
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return sorted(int(m.group("step")) for m in map(_STEP_RE.match, names)
                      if m and m.group("stem") == stem)

    def _orphan_paths(self, key: str) -> list[str]:
        """Files of ``key`` no read will ever serve: payloads without a
        sidecar and ``fsync_write`` tmp leftovers."""
        stem = _stem(key)
        try:
            names = set(os.listdir(self.dir))
        except OSError:
            return []
        return [os.path.join(self.dir, n) for n in names
                if n.startswith(stem + ".step") and not n.endswith(".sum")
                and not (n.endswith(".npz") and n[:-4] + ".sum" in names)]

    def _count_metric(self, name: str, reason: str = None):
        """One checkpoint-store outcome in the registry counter ``name``
        (never raises)."""
        try:
            from raft_tpu_torch import obs
            labels = {"reason": reason} if reason else {}
            obs.counter(name, "checkpoint-store outcomes "
                        "(serve/checkpoint.py)").inc(1.0, **labels)
        except Exception:                             # pragma: no cover
            pass

    def _reclaim_orphans(self, key: str, grace: float = None):
        """Delete the torn-put orphans of ``key`` older than the grace
        window (counted as corruption)."""
        grace = self.TORN_GRACE_S if grace is None else float(grace)
        now = time.time()
        for p in self._orphan_paths(key):
            try:
                if grace > 0 and now - os.path.getmtime(p) < grace:
                    continue
                os.unlink(p)
            except OSError:
                continue
            self._count("corrupt")
            journalio.count_corrupt("checkpoint")
            self._count_metric("raft_tpu_checkpoint_corrupt_total",
                               "torn_put")
            _LOG.warning("checkpoint: reclaimed torn-put orphan %s",
                         os.path.basename(p))

    def _corrupt(self, key: str, step: int, reason: str):
        """Delete-and-miss one damaged checkpoint."""
        for p in self._paths(key, step):
            try:
                os.unlink(p)
            except OSError:
                pass
        self._count("corrupt")
        journalio.count_corrupt("checkpoint")
        self._count_metric("raft_tpu_checkpoint_corrupt_total", reason)
        try:
            from raft_tpu_torch import obs
            obs.events.emit("ckpt_corrupt", key=_stem(key)[:12],
                            step=int(step), reason=reason)
        except Exception:                             # pragma: no cover
            pass
        _LOG.warning("checkpoint %s@step%d failed integrity (%s): deleted",
                     _stem(key)[:12], step, reason)

    # -- write path ------------------------------------------------------

    def put(self, key: str, step: int, arrays: dict,
            meta: dict = None) -> str | None:
        """Persist named arrays and a JSON ``meta`` under ``(key, step)``;
        returns the payload's ``sha256:<hex>``, or None on a write failure
        that is not exhaustion.  Proven ENOSPC (a real one or the injected
        ``enospc@checkpoint``) raises ``StorageExhausted``."""
        entry, sidecar = self._paths(key, step)
        data = _pack(arrays)
        cdigest = "sha256:" + hashlib.sha256(data).hexdigest()
        with self._lock:
            projected = self._bytes + len(data)
        if self.budget_bytes is not None and projected > self.budget_bytes:
            self._count("enospc")
            raise errors.StorageExhausted(
                "checkpoint store disk budget exceeded",
                component=self.component, budget=self.budget_bytes,
                bytes=projected)
        try:
            if faults.fire_info("checkpoint", action="enospc",
                                entry=_stem(key), step=int(step)):
                raise OSError(_errno.ENOSPC, "injected ENOSPC (fault)")
            journalio.fsync_write(entry, data)
            side = {"schema": SCHEMA, "key": str(key), "step": int(step),
                    "size": len(data), "sha256": cdigest.split(":", 1)[1],
                    "cdigest": cdigest, "t": round(time.time(), 6),
                    "meta": dict(meta or {})}
            # the sidecar LAST: its presence certifies a complete put
            journalio.fsync_write(sidecar, json.dumps(
                side, sort_keys=True, separators=(",", ":"),
                default=str).encode())
        except OSError as e:
            if is_enospc(e):
                self._count("enospc")
                raise errors.StorageExhausted(
                    "checkpoint write hit ENOSPC", key=_stem(key)[:12],
                    step=int(step)) from e
            self._count("write_errors")
            _LOG.warning("checkpoint put failed for %s@step%d: %s",
                         _stem(key)[:12], step, e)
            return None
        self._count("writes")
        # re-anchored on the directory: an overwrite replaces bytes
        self._refresh_bytes()
        self._count_metric("raft_tpu_checkpoint_writes_total")
        return cdigest

    def _refresh_bytes(self):
        n = journalio.dir_bytes(self.dir)
        with self._lock:
            self._bytes = n
        disk_gauge(self.component, n)

    # -- read path -------------------------------------------------------

    def _read_step(self, key: str, step: int) -> tuple | None:
        """One fully verified checkpoint, or None."""
        entry, sidecar = self._paths(key, step)
        try:
            with open(sidecar, encoding="utf-8") as f:
                side = json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._corrupt(key, step, "sidecar_unreadable")
            return None
        except OSError:
            self._count("read_errors")
            return None
        if not isinstance(side, dict):
            self._corrupt(key, step, "sidecar_unreadable")
            return None
        try:
            if faults.fire_info("checkpoint", action="eio",
                                entry=_stem(key), step=int(step)):
                raise OSError(_errno.EIO, "injected EIO (fault)")
            with open(entry, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            self._corrupt(key, step, "payload_unreadable")
            return None
        except OSError:
            # transient I/O trouble: a counted plain miss, no deletion
            self._count("read_errors")
            return None
        if faults.fire_info("checkpoint", action="corrupt",
                            entry=_stem(key), step=int(step)):
            head = bytes([data[0] ^ 0xFF]) if data else b"\x00"
            data = head + data[1: max(1, len(data) - 16)]
        if len(data) != int(side.get("size", -1)) or \
                hashlib.sha256(data).hexdigest() != side.get("sha256"):
            self._corrupt(key, step, "sha_mismatch")
            return None
        if side.get("key") != str(key) \
                or int(side.get("step", -1)) != int(step):
            self._corrupt(key, step, "key_mismatch")
            return None
        try:
            arrays = _unpack(data)
        except (ValueError, OSError, KeyError):
            self._corrupt(key, step, "unparseable")
            return None
        self._count("hits")
        return int(step), arrays, dict(side.get("meta") or {})

    def get(self, key: str, step: int) -> tuple | None:
        """The exact ``(key, step)`` checkpoint, verified, as ``(step,
        arrays, meta)``, or None."""
        found = self._read_step(key, int(step))
        if found is None:
            self._count("misses")
        return found

    def latest(self, key: str, max_step: int = None) -> tuple | None:
        """The newest valid checkpoint of ``key`` (at most ``max_step``),
        as ``(step, arrays, meta)``, or None: a corrupt one is deleted,
        counted, and the walk falls back one step.  Aged torn-put orphans
        of the key are reclaimed on the way."""
        self._reclaim_orphans(key)
        for step in reversed(self.steps(key)):
            if max_step is not None and step > int(max_step):
                continue
            found = self._read_step(key, step)
            if found is not None:
                return found
        self._count("misses")
        return None

    def delete(self, key: str, step: int = None):
        """Drop checkpoint ``step`` of ``key``, or every checkpoint of it
        and its orphans when ``step`` is None."""
        paths = [p for s in ([step] if step is not None else self.steps(key))
                 for p in self._paths(key, s)]
        if step is None:
            paths += self._orphan_paths(key)
        n = 0
        for p in paths:
            try:
                os.unlink(p)
                n += 1
            except OSError:
                pass
        if n:
            self._count("deletes")
            self._refresh_bytes()

    # -- introspection ---------------------------------------------------

    def disk_bytes(self) -> int:
        with self._lock:
            return int(self._bytes)

    def stats(self) -> dict:
        with self._lock:
            return {**self._counts, "disk_bytes": int(self._bytes),
                    "dir": self.dir}
