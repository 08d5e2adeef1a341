"""Persistent content-addressed result store (the millisecond read tier).

The port's copy of ``raft_tpu/serve/resultstore.py``: the same on-disk
format (a directory written by either package is read by the other).

The serving stack already content-addresses everything — requests by
``rdigest`` (:func:`raft_tpu_torch.serve.journal.request_digest`, the digest
of the submitted ``(Hs, Tp, beta, tenant)``) and results by the ledger
digest of their physics — but until this module only crash-recovery
replay exploited it.  :class:`ResultStore` promotes the address space
into a first-class *read-through tier*: a directory-shaped, crash-safe
store of completed results the service consults **at admission**
(:meth:`SweepService.submit`), so an exact-digest repeat returns at
memory speed without ever entering the batch window, across restarts
and across replicas sharing (or mirroring) the same directory.

Integrity contract (the robustness half of the feature):

- every entry is written ``tmp -> fsync -> rename`` with a size+sha256
  **sidecar** written last — a crash mid-put leaves a torn entry that
  reads as a miss, never a wrong answer;
- reads verify, in order: sidecar presence, payload size+sha256, JSON
  parse, the **key check** (the payload's own ``rdigest`` must equal
  the requested key — a stale/swapped entry is corruption, not an
  answer), and the **semantic check** (the payload's recorded result
  ``digest`` must equal ``digest_metrics`` recomputed over its own
  std/iters/converged metrics);
- any failure is **delete-and-miss**: the entry (payload, sidecar, seed)
  is removed, ``raft_tpu_serve_result_store_corrupt_total{reason}`` is
  incremented, and ``None`` is returned — the request re-solves; the
  service never dies and a corrupt byte is never served.  Strict
  callers (``strict=True``) get the typed
  :class:`raft_tpu_torch.errors.ResultStoreCorrupt` instead.

Warm-start seeds: entries solved *cold* may carry the converged
response ``Xi`` (a ``(6, nw)`` complex array, stored binary next to the
payload and covered by the same sidecar hashes).  :meth:`nearest` finds
the closest seed-bearing entry in ``(Hs, Tp, beta)`` under a radius —
the case tables are smooth, so a neighbor's solution drops the drag
fixed point's iteration count — and :meth:`quarantine` removes a seed
the divergence guard rejected from all future seeding, so one poisoned
entry can never keep corrupting warm starts.

Fault seams (:mod:`raft_tpu_torch.testing.faults`):
``corrupt@resultstore[:entry=HEX]`` damages the raw bytes before the
sidecar check (the torn/bit-rot path); ``stale@resultstore`` perturbs
the *parsed* payload after the byte checks pass, which only the
semantic digest check can reject — proving the integrity ladder is
end-to-end, not just a checksum.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import numpy as np

from raft_tpu_torch import errors
from raft_tpu_torch.utils.profiling import get_logger

_LOG = get_logger("serve.resultstore")

SCHEMA = "raft_tpu.serve.resultstore/v1"

#: payload keys every entry must carry (the service writes them; the
#: read path rejects anything less as corruption)
REQUIRED = ("rdigest", "digest", "std", "iters", "converged", "tenant",
            "Hs", "Tp", "beta")


def _stem(rdigest: str) -> str:
    """Filename stem of one entry: the bare hex of the request digest
    (``sha256:<hex>`` -> ``<hex>``), which is also what the
    ``entry=HEX`` fault qualifier matches."""
    return str(rdigest).rsplit(":", 1)[-1]


def _result_digest(doc: dict) -> str:
    from raft_tpu_torch.ledger import digest_metrics
    return digest_metrics({"std": [float(v) for v in doc["std"]],
                           "iters": int(doc["iters"]),
                           "converged": bool(doc["converged"])})


def _fsync_write(path: str, data: bytes):
    # the shared crash-safe write discipline, one implementation for
    # every persistence tier (per-writer tmp -> fsync -> rename; see
    # obs/journalio.fsync_write — raftlint RTL007 pins write paths
    # onto it)
    from raft_tpu_torch.obs.journalio import fsync_write
    fsync_write(path, data)


class ResultStore:
    """One result-store directory (see module docstring).

    Thread-safe; every method is crash-tolerant in both directions — a
    failed write is a counted gap (the result is still delivered from
    memory and the WAL), a failed read is a counted miss.  ``keep_xi``
    retains warm-start seeds next to payloads (the service enables it
    with ``ServeConfig.warm_start``).
    """

    #: a payload younger than this may be a concurrent put that has not
    #: yet landed its certifying sidecar — read as a plain miss, not a
    #: torn put (deleting it would destroy the fresh entry mid-commit).
    #: Generous on purpose: the age is filesystem mtime vs local clock,
    #: and on a shared/NFS store those clocks can disagree by seconds;
    #: a real torn entry lingering this long costs nothing (it reads as
    #: a miss either way, and the re-solve's put overwrites it)
    TORN_GRACE_S = 60.0

    #: minimum interval between forced full index rescans on a
    #: get_by_digest miss — clients poll ``GET /result?digest=`` while
    #: a solve is in flight, and every poll must not pay an os.listdir
    FORCE_RESCAN_MIN_S = 0.5

    def __init__(self, store_dir: str, *, keep_xi: bool = False):
        self.dir = str(store_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.keep_xi = bool(keep_xi)
        self._lock = threading.RLock()
        #: rdigest -> {"Hs","Tp","beta","tenant","digest","xi"} — the
        #: neighbor/nearest index, loaded from sidecars (payloads are
        #: never read until a hit needs one)
        self._index: dict[str, dict] | None = None
        self._index_mtime: int = -1
        #: vectorized :meth:`nearest` arrays (rdigests, (N,3) coords,
        #: tenants, seed mask, rdigest->row map), rebuilt lazily after
        #: any index mutation — the per-query cost is O(1) NumPy array
        #: ops, not a Python loop over every entry
        self._narr = None
        self._last_force_rescan = float("-inf")
        self._quarantined: set[str] = set()
        self._counts = {k: 0 for k in (
            "puts", "put_errors", "hits", "misses", "corrupt",
            "quarantined", "seed_reads", "enospc")}

    # ------------------------------------------------------------------
    # paths / index
    # ------------------------------------------------------------------

    def _paths(self, rdigest: str) -> tuple[str, str, str]:
        stem = _stem(rdigest)
        base = os.path.join(self.dir, stem)
        return base + ".json", base + ".sum", base + ".xi"

    def _index_sidecar_locked(self, stem: str):
        """Parse one sidecar into the index (skipping malformed ones).
        The ``xi`` flag additionally requires the seed FILE to exist,
        so a durably quarantined seed (unlinked ``.xi``) stays out of
        :meth:`nearest` across restarts and sibling replicas."""
        try:
            with open(os.path.join(self.dir, stem + ".sum"),
                      encoding="utf-8") as f:
                side = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        rd = side.get("rdigest")
        if not rd or _stem(rd) != stem:
            return
        self._index[rd] = {
            "Hs": side.get("Hs"), "Tp": side.get("Tp"),
            "beta": side.get("beta"), "tenant": side.get("tenant"),
            "digest": side.get("digest"),
            "xi": bool(side.get("xi_sha256"))
            and os.path.exists(os.path.join(self.dir, stem + ".xi"))}

    def _dir_mtime(self) -> int:
        try:
            return os.stat(self.dir).st_mtime_ns
        except OSError:
            return -1

    def _ensure_index_locked(self):
        if self._index is not None:
            return
        self._index = {}
        self._index_mtime = self._dir_mtime()
        self._narr = None
        try:
            names = os.listdir(self.dir)
        except OSError:
            names = []
        for name in names:
            if name.endswith(".sum"):
                self._index_sidecar_locked(name[:-4])

    def _refresh_index_locked(self, force: bool = False):
        """Fold sibling-process writes into the neighbor/digest index:
        a cheap directory-mtime guard, then read only sidecars not yet
        indexed and drop entries whose sidecar vanished — replicas
        sharing (or mirroring) the directory see each other's results
        without re-reading the whole store per lookup."""
        self._ensure_index_locked()
        mtime = self._dir_mtime()
        if not force and mtime == self._index_mtime:
            return
        self._index_mtime = mtime
        self._narr = None
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        stems = {n[:-4] for n in names if n.endswith(".sum")}
        xi_stems = {n[:-3] for n in names if n.endswith(".xi")}
        known = {_stem(rd): rd for rd in self._index}
        for gone in known.keys() - stems:
            self._index.pop(known[gone], None)
        for stem in stems - known.keys():
            self._index_sidecar_locked(stem)
        # a sibling's durable quarantine unlinks only the .xi — clear
        # the seed flag of still-indexed entries whose seed vanished
        for stem, rd in known.items():
            if stem not in xi_stems and rd in self._index:
                self._index[rd]["xi"] = False

    def __len__(self) -> int:
        with self._lock:
            self._refresh_index_locked()
            return len(self._index)

    # ------------------------------------------------------------------
    # telemetry (must never take down the serving path)
    # ------------------------------------------------------------------

    def _count_corrupt(self, reason: str):
        with self._lock:
            self._counts["corrupt"] += 1
        try:
            from raft_tpu_torch import obs
            obs.counter(
                "raft_tpu_serve_result_store_corrupt_total",
                "result-store entries that failed an integrity check "
                "and were deleted (read as a miss, re-solved)").inc(
                    1.0, reason=reason)
            obs.events.emit("store_corrupt", reason=reason)
        except Exception:  # pragma: no cover  # raftlint: disable=RTL004
            pass

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------

    def put(self, payload: dict, xi=None) -> bool:
        """Persist one completed result, keyed by its ``rdigest``.

        ``payload`` must carry :data:`REQUIRED`; ``xi`` (optional, only
        retained with ``keep_xi``) is the converged ``(6, nw)`` complex
        response the drag fixed point warm-starts from — pass it only
        for COLD-solved results, so every seed in the store traces back
        to an unseeded solve.  Returns False (and counts a
        ``put_errors``) on any I/O trouble — EXCEPT a *proven* full
        disk (ENOSPC), which raises the typed
        :class:`~raft_tpu_torch.errors.StorageExhausted` so the service can
        shed the write-through rung; nothing else ever raises into the
        serving path."""
        try:
            doc = {k: payload[k] for k in REQUIRED}
        except KeyError as e:
            with self._lock:
                self._counts["put_errors"] += 1
            _LOG.warning("result store: put missing field %s", e)
            return False
        doc.update({k: v for k, v in payload.items() if k not in doc})
        doc["schema"] = SCHEMA
        rdigest = str(doc["rdigest"])
        entry, sidecar, xi_path = self._paths(rdigest)
        try:
            from raft_tpu_torch.testing import faults
            if faults.fire_info("resultstore", action="enospc",
                                entry=_stem(rdigest)) is not None:
                import errno as _errno
                raise OSError(_errno.ENOSPC, "injected ENOSPC (fault)")
            data = json.dumps(doc, sort_keys=True,
                              separators=(",", ":")).encode()
            side = {"schema": SCHEMA, "rdigest": rdigest,
                    "digest": doc["digest"], "size": len(data),
                    "sha256": hashlib.sha256(data).hexdigest(),
                    "Hs": float(doc["Hs"]), "Tp": float(doc["Tp"]),
                    "beta": float(doc["beta"]),
                    "tenant": str(doc["tenant"])}
            xi_arr = None
            if xi is not None and self.keep_xi:
                xi_arr = np.ascontiguousarray(np.asarray(xi, complex))
                xi_bytes = xi_arr.tobytes()
                side.update({"xi_shape": list(xi_arr.shape),
                             "xi_dtype": str(xi_arr.dtype),
                             "xi_size": len(xi_bytes),
                             "xi_sha256": hashlib.sha256(
                                 xi_bytes).hexdigest()})
                _fsync_write(xi_path, xi_bytes)
            _fsync_write(entry, data)
            # sidecar LAST: its presence certifies a complete put — a
            # crash before this line leaves a torn entry that reads as
            # a (counted) miss, never as data
            _fsync_write(sidecar, json.dumps(
                side, sort_keys=True, separators=(",", ":")).encode())
        # the store protects the serving path, never endangers it: any
        # filesystem trouble is a counted durability gap — EXCEPT a
        # proven full disk, which raises the typed StorageExhausted so
        # the service can shed the write-through rung (admission and
        # delivery stay alive; the caller catches, counts, and skips
        # puts for the shed hold)
        except Exception as e:  # raftlint: disable=RTL004
            with self._lock:
                self._counts["put_errors"] += 1
            from raft_tpu_torch.serve.checkpoint import is_enospc
            if is_enospc(e):
                with self._lock:
                    self._counts["enospc"] += 1
                raise errors.StorageExhausted(
                    "result-store write hit ENOSPC",
                    component="resultstore",
                    rdigest=_stem(rdigest)[:12]) from e
            _LOG.warning("result store: put failed for %s", rdigest,
                         exc_info=True)
            return False
        with self._lock:
            self._ensure_index_locked()
            self._index[rdigest] = {
                "Hs": side["Hs"], "Tp": side["Tp"], "beta": side["beta"],
                "tenant": side["tenant"], "digest": doc["digest"],
                "xi": xi_arr is not None}
            self._narr = None
            self._counts["puts"] += 1
        return True

    # ------------------------------------------------------------------
    # read path (the integrity ladder)
    # ------------------------------------------------------------------

    def _drop_locked(self, rdigest: str):
        for p in self._paths(rdigest):
            try:
                os.unlink(p)
            except OSError:
                pass
        if self._index is not None:
            self._index.pop(rdigest, None)
            self._narr = None

    def _corrupt(self, rdigest: str, reason: str, strict: bool):
        with self._lock:
            self._drop_locked(rdigest)
        self._count_corrupt(reason)
        _LOG.warning("result store: entry %s failed integrity (%s) — "
                     "deleted, request re-solves", _stem(rdigest)[:12],
                     reason)
        if strict:
            raise errors.ResultStoreCorrupt(
                "result-store entry failed its integrity check",
                rdigest=rdigest, reason=reason)
        return None

    def get(self, rdigest: str, strict: bool = False) -> dict | None:
        """The payload stored under ``rdigest``, fully verified (see
        the module integrity contract), or None on miss; corrupt/torn/
        stale entries are delete-and-miss (``strict=True`` raises the
        typed :class:`~raft_tpu_torch.errors.ResultStoreCorrupt` instead)."""
        from raft_tpu_torch.testing import faults

        entry, sidecar, _ = self._paths(rdigest)
        stem = _stem(rdigest)
        # -- injection seam: transient read I/O error (eio@resultstore)
        # — a plain counted miss, the entry is NOT deleted (deletion is
        # reserved for proven corruption; an EIO may clear)
        if faults.fire_info("resultstore", action="eio",
                            entry=stem) is not None:
            with self._lock:
                self._counts["misses"] += 1
            return None
        try:
            with open(sidecar, encoding="utf-8") as f:
                side = json.load(f)
        except FileNotFoundError:
            try:
                age = time.time() - os.path.getmtime(entry)
            except OSError:
                age = None
            if age is not None:
                # a negative age means the fileserver clock runs ahead
                # of ours — treat as fresh, same as any skew-suspect
                # young entry
                if age < self.TORN_GRACE_S:
                    # a concurrent put has landed the payload but not
                    # yet its certifying sidecar — a plain miss, never
                    # a deletion of the mid-commit entry
                    with self._lock:
                        self._counts["misses"] += 1
                    return None
                # payload without its certifying sidecar: a torn put
                return self._corrupt(rdigest, "torn_put", strict)
            with self._lock:
                self._counts["misses"] += 1
            return None
        except json.JSONDecodeError:
            return self._corrupt(rdigest, "sidecar_unreadable", strict)
        except OSError:
            # transient I/O trouble (shared-mount blip, momentary
            # permission hiccup): a plain miss — deletion is reserved
            # for PROVEN corruption, never a read error that may clear
            with self._lock:
                self._counts["misses"] += 1
            return None
        try:
            with open(entry, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            # sidecar without its payload: a genuine orphan (e.g. the
            # remnant of a torn-put deletion racing the writer)
            return self._corrupt(rdigest, "payload_unreadable", strict)
        except OSError:
            with self._lock:
                self._counts["misses"] += 1
            return None
        # -- injection seam: bit-rot / truncation BEFORE the checks
        # (action-filtered, so a corrupt probe can never burn a stale
        # spec's once/times budget and vice versa)
        if faults.fire_info("resultstore", action="corrupt",
                            entry=stem) is not None:
            head = bytes([data[0] ^ 0xFF]) if data else b"\x00"
            data = head + data[1: max(1, len(data) - 16)]
        if len(data) != int(side.get("size", -1)) \
                or hashlib.sha256(data).hexdigest() != side.get("sha256"):
            return self._corrupt(rdigest, "sha_mismatch", strict)
        try:
            doc = json.loads(data)
        except json.JSONDecodeError:
            return self._corrupt(rdigest, "unparseable", strict)
        if not isinstance(doc, dict) \
                or any(k not in doc for k in REQUIRED):
            return self._corrupt(rdigest, "schema", strict)
        # -- injection seam: a STALE entry — byte-consistent but
        # semantically wrong (simulates an entry rewritten with a
        # recomputed sidecar); only the digest checks below catch it
        f = faults.fire_info("resultstore", action="stale", entry=stem)
        if f is not None:
            doc = dict(doc)
            doc["std"] = [float(doc["std"][0]) + 1.0] \
                + [float(v) for v in doc["std"][1:]]
        # key check: the entry must answer for the requested physics
        if doc.get("rdigest") != str(rdigest):
            return self._corrupt(rdigest, "key_mismatch", strict)
        # semantic check: the recorded result digest must still match
        # the payload's own metrics — the end-to-end guarantee that a
        # served std row is exactly the one the solver produced
        if _result_digest(doc) != doc.get("digest"):
            return self._corrupt(rdigest, "digest_mismatch", strict)
        with self._lock:
            self._counts["hits"] += 1
            self._ensure_index_locked()
            if str(rdigest) not in self._index:
                self._index[str(rdigest)] = {
                    "Hs": float(doc["Hs"]), "Tp": float(doc["Tp"]),
                    "beta": float(doc["beta"]),
                    "tenant": str(doc["tenant"]),
                    "digest": doc["digest"],
                    "xi": bool(side.get("xi_sha256"))
                    and os.path.exists(self._paths(rdigest)[2])}
                self._narr = None
        return doc

    def get_by_digest(self, digest: str, strict: bool = False) -> dict | None:
        """Payload lookup by RESULT digest (the ledger content address
        of the physics) — the ``GET /result?digest=`` read path.  A
        miss forces a full index rescan (directory mtime has coarse
        granularity on some filesystems), so entries written by a
        sibling replica are found before the caller falls back —
        rate-limited to one rescan per ``FORCE_RESCAN_MIN_S`` so
        clients polling for an in-flight solve don't pay an os.listdir
        per poll."""
        with self._lock:
            self._refresh_index_locked()
            rd = next((r for r, m in self._index.items()
                       if m.get("digest") == digest), None)
            if rd is None:
                now = time.monotonic()
                if now - self._last_force_rescan >= self.FORCE_RESCAN_MIN_S:
                    self._last_force_rescan = now
                    self._refresh_index_locked(force=True)
                    rd = next((r for r, m in self._index.items()
                               if m.get("digest") == digest), None)
        return self.get(rd, strict=strict) if rd else None

    def _drop_seed(self, rdigest: str, reason: str):
        """Remove ONLY the damaged seed file: the payload passed (or
        will pass) its own independent integrity ladder, and deleting a
        verified cached result over an optional seed would trade a
        memory-speed hit for a full re-solve."""
        _, _, xi_path = self._paths(rdigest)
        try:
            os.unlink(xi_path)
        except OSError:
            pass
        with self._lock:
            if self._index is not None and rdigest in self._index:
                self._index[rdigest]["xi"] = False
                self._narr = None
        self._count_corrupt(reason)
        _LOG.warning("result store: seed of %s failed integrity (%s) "
                     "— seed dropped, payload kept",
                     _stem(rdigest)[:12], reason)

    def get_xi(self, rdigest: str):
        """The warm-start seed stored next to an entry — the converged
        ``(6, nw)`` complex response — verified against the sidecar's
        own size+sha256; damage drops the SEED only (counted), never
        the independently-verified payload."""
        _, sidecar, xi_path = self._paths(rdigest)
        try:
            with open(sidecar, encoding="utf-8") as f:
                side = json.load(f)
            if not side.get("xi_sha256"):
                return None
            with open(xi_path, "rb") as f:
                raw = f.read()
        except (OSError, json.JSONDecodeError):
            return None
        if len(raw) != int(side.get("xi_size", -1)) \
                or hashlib.sha256(raw).hexdigest() != side["xi_sha256"]:
            self._drop_seed(rdigest, "seed_sha_mismatch")
            return None
        with self._lock:
            self._counts["seed_reads"] += 1
        try:
            return np.frombuffer(
                raw, dtype=np.dtype(side["xi_dtype"])).reshape(
                    side["xi_shape"]).copy()
        except (TypeError, ValueError):
            self._drop_seed(rdigest, "seed_shape")
            return None

    # ------------------------------------------------------------------
    # neighbor seeding
    # ------------------------------------------------------------------

    def _nearest_arrays_locked(self):
        """Parallel NumPy views of the index for :meth:`nearest` —
        rebuilt only after an index mutation (every mutator clears
        ``_narr``; the rebuild itself rides the same directory-mtime
        guard the dict index does), so each neighbor query is O(1)
        vectorized array ops instead of a per-entry Python loop."""
        if self._narr is None:
            rds, coords, tenants, xi = [], [], [], []
            for rd, m in self._index.items():
                try:
                    c = (float(m["Hs"]), float(m["Tp"]),
                         float(m["beta"]))
                except (TypeError, ValueError):
                    continue
                rds.append(rd)
                coords.append(c)
                tenants.append(str(m.get("tenant")))
                xi.append(bool(m.get("xi"))
                          and rd not in self._quarantined)
            self._narr = (
                np.asarray(rds, dtype=object),
                np.asarray(coords, dtype=np.float64).reshape(
                    len(rds), 3),
                np.asarray(tenants, dtype=object),
                np.asarray(xi, dtype=bool),
                {rd: i for i, rd in enumerate(rds)})
        return self._narr

    def nearest(self, Hs: float, Tp: float, beta: float, tenant: str,
                radius: float, exclude=()) -> tuple[str, float] | None:
        """The closest seed-bearing entry to ``(Hs, Tp, beta)`` for
        ``tenant`` within ``radius`` (Euclidean over Hs [m], Tp [s],
        beta [rad] — the case tables are smooth on roughly unit scales
        in all three), skipping quarantined keys and ``exclude``.
        Returns ``(rdigest, distance)`` or None."""
        with self._lock:
            self._refresh_index_locked()
            rds, coords, tenants, xi, pos = self._nearest_arrays_locked()
            if not len(rds):
                return None
            ok = xi & (tenants == tenant)
            for rd in exclude:
                i = pos.get(rd)
                if i is not None:
                    ok[i] = False
            if not ok.any():
                return None
            d2 = coords - np.asarray(
                [float(Hs), float(Tp), float(beta)])
            d2 = np.einsum("ij,ij->i", d2, d2)
            d2 = np.where(ok, d2, np.inf)
            i = int(np.argmin(d2))
            d = float(np.sqrt(d2[i]))
            if d > float(radius):
                return None
            return str(rds[i]), d

    def quarantine(self, rdigest: str):
        """Remove one entry from all future seeding (the divergence
        guard rejected a solve it seeded); its payload stays readable —
        payload integrity has its own ladder.  Durable: the seed FILE
        is unlinked, so the quarantine survives restarts and is seen
        by sibling replicas sharing the directory, not just this
        process's in-memory set."""
        with self._lock:
            if rdigest in self._quarantined:
                return
            self._quarantined.add(rdigest)
            self._counts["quarantined"] += 1
            _, _, xi_path = self._paths(rdigest)
            try:
                os.unlink(xi_path)
            except OSError:
                pass
            if self._index is not None and rdigest in self._index:
                self._index[rdigest]["xi"] = False
            self._narr = None
        try:
            from raft_tpu_torch import obs
            obs.counter(
                "raft_tpu_serve_warm_starts_total",
                "warm-start seeding outcomes of the serving loop").inc(
                    1.0, outcome="quarantined")
            obs.events.emit("store_seed_quarantined", rdigest=rdigest)
        except Exception:  # pragma: no cover  # raftlint: disable=RTL004
            pass
        _LOG.warning("result store: seed %s quarantined (divergence "
                     "guard)", _stem(rdigest)[:12])

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def disk_bytes(self) -> int:
        """Bytes held by the store directory; also refreshes the
        per-component ``raft_tpu_disk_bytes`` gauge."""
        from raft_tpu_torch.obs.journalio import dir_bytes
        from raft_tpu_torch.serve.checkpoint import disk_gauge

        n = dir_bytes(self.dir)
        disk_gauge("resultstore", n)
        return n

    def stats(self) -> dict:
        with self._lock:
            self._refresh_index_locked()
            out = {**self._counts, "entries": len(self._index),
                   "seeds": sum(1 for m in self._index.values()
                                if m.get("xi")),
                   "dir": self.dir}
        out["disk_bytes"] = self.disk_bytes()
        return out
