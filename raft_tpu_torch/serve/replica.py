"""WAL mirroring to peer stores (replicated serving, layer 1 of 3).

The port's copy of ``raft_tpu/serve/replica.py``.

The write-ahead request journal makes the sweep service survive its
own death — but only while the journal directory survives the host.
This module streams the WAL to one or more *peer* directories (a local
path today, an object-store mount tomorrow) so a successor on a
different host can replay the same zero-loss guarantees from a mirror
alone (:meth:`SweepService.recover` accepts any journal-shaped
directory, including one whose live part is missing the torn tail of
the dying write).

Shape: :class:`WalMirror` attaches to the journal's
:class:`raft_tpu_torch.obs.journalio.JsonlWriter` through its post-flush /
post-rotate hooks.

- **post-flush** ships the fresh *complete lines* of the live part to
  every peer — inline (synchronous mirroring, the default: the record
  is on every reachable peer before the admission/result is
  acknowledged) or deferred to the catch-up worker when mirroring is
  lagging (the ``lag@replica`` fault models exactly that);
- **post-rotate** mirrors the rotation (peer generations shuffle up)
  and ships the freshly-sealed part wholesale — the
  ``drop@replica:part=N`` fault swallows one such ship so the resync
  path is provable;
- a background **catch-up worker** drains a bounded queue of deferred
  ship tasks; :meth:`sync_now` reconciles any divergence (dropped
  parts, failed writes, live-file resets) by size comparison —
  mirroring is idempotent byte copying, so a resync after any fault
  converges.  The queue coalesces on overflow (a dropped token never
  loses data, only immediacy — the next pass re-ships to convergence).

Accounting (one dashboard row per peer):

- ``raft_tpu_serve_wal_replication_lag_records{peer}`` — complete
  records present at the source but not yet on the peer;
- ``raft_tpu_serve_wal_replication_errors_total{peer}`` — failed ship
  attempts (the peer store erroring, never the service);
- lag beyond ``max_lag_records`` trips the typed
  :class:`raft_tpu_torch.errors.ReplicaLagExceeded` **degradation signal**:
  :meth:`check` raises it for strict callers (health gates, tests),
  the serving loop folds :attr:`lag_exceeded` into its degradation
  ladder, and the condition clears itself when the mirror catches up.

A peer failure must never take down the service the mirror protects:
every ship is guarded, counted, and retried by the next pass — the
same keep-alive stance as the WAL write path itself.
"""
from __future__ import annotations

import collections
import os
import threading
import time

from raft_tpu_torch import errors
from raft_tpu_torch.utils.profiling import get_logger

_LOG = get_logger("serve.replica")

#: catch-up worker idle poll cadence
_TICK_S = 0.05


def _count_errors(peer: str, n: int = 1):
    try:
        from raft_tpu_torch import obs
        obs.counter("raft_tpu_serve_wal_replication_errors_total",
                    "failed WAL-mirror ship attempts, by peer"
                    ).inc(float(n), peer=str(peer))
    # telemetry guard: replication accounting must never take down the
    # mirror (obs contract)
    except Exception:  # pragma: no cover  # raftlint: disable=RTL004
        pass


def _count_lines(path: str, start: int = 0) -> int:
    """Complete lines in ``path`` at byte ``start`` and beyond (0 on a
    missing/unreadable file — an absent part has nothing to lag)."""
    try:
        with open(path, "rb") as f:
            f.seek(int(start))
            n = 0
            while True:
                chunk = f.read(1 << 16)
                if not chunk:
                    return n
                n += chunk.count(b"\n")
    except OSError:
        return 0


class _Peer:
    """One mirror target: ``<dir>/<basename(source)>`` plus rotated
    ``.N`` siblings, with byte-offset bookkeeping for the live part.
    ``fh`` is the persistent append handle — the steady-state inline
    ship is one write+flush, not an open/stat/truncate per record."""

    __slots__ = ("dir", "path", "offset", "errors", "shipped", "fh")

    def __init__(self, peer_dir: str, basename: str):
        self.dir = str(peer_dir)
        self.path = os.path.join(self.dir, basename)
        self.offset = 0          # live-part bytes already on the peer
        self.errors = 0
        self.shipped = 0         # records shipped (all parts, lifetime)
        self.fh = None


class WalMirror:
    """Stream one journal (live part + rotated generations) to peer
    directories.  See the module docstring for semantics; thread-safe."""

    def __init__(self, source_path: str, peer_dirs, *,
                 max_lag_records: int = 1024, queue_max: int = 256,
                 keep: int = 4, sync: bool = True):
        self.source = str(source_path)
        self._base = os.path.basename(self.source)
        self.max_lag_records = int(max_lag_records)
        self.keep = int(keep)
        self.sync = bool(sync)
        self.peers = [_Peer(d, self._base) for d in (peer_dirs or [])]
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        #: bounded catch-up queue — overflow coalesces (drops the
        #: oldest token, counted)
        self._queue: collections.deque = collections.deque(
            maxlen=max(1, int(queue_max)))
        self.coalesced = 0
        self._defer_until = 0.0
        self._degraded = False
        self._closed = False
        self._thread = None
        #: persistent read handle on the source live part (re-opened
        #: after rotation/truncation)
        self._src_fh = None
        #: True whenever lag MIGHT be nonzero (rotation, drop, error,
        #: deferral): the clean steady-state flush skips the full lag
        #: scan entirely; a full fold at lag 0 clears it
        self._dirty = True
        for p in self.peers:
            os.makedirs(p.dir, exist_ok=True)
        if self.peers:
            self._thread = threading.Thread(
                target=self._worker, name="raft-wal-mirror", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    # journal-side notifications (JsonlWriter hooks)
    # ------------------------------------------------------------------

    def notify_flush(self, writer=None):
        """Post-flush hook: ship the live part's fresh complete lines.
        Inline in sync mode (record on every reachable peer before the
        caller acks) unless a ``lag@replica`` fault defers mirroring to
        the catch-up worker."""
        if not self.peers:
            return
        from raft_tpu_torch.testing import faults

        f = (faults.fire_info("replica", action="lag")
             if faults.any_active() else None)
        if f is not None:
            with self._cond:
                self._defer_until = max(
                    self._defer_until,
                    time.monotonic() + float(f.get("lag_s", 2.0)))
                self._dirty = True
                self._enqueue_locked("live")
                self._cond.notify_all()
            self._fold_lag()
            return
        if self.sync:
            with self._lock:
                clean = all([self._ship_live_locked(p)
                             for p in self.peers])
            if clean and not self._dirty:
                return                   # steady state: peers current
            if not clean:
                # a peer refused the inline ship: hand the record to
                # the catch-up worker, which retries until the peer
                # recovers — an idle service must not sit on an acked
                # record its mirror never got
                with self._cond:
                    self._enqueue_locked("live")
                    self._cond.notify_all()
            self._fold_lag()
        else:
            with self._cond:
                self._enqueue_locked("live")
                self._cond.notify_all()

    def notify_rotate(self, writer=None, sealed_part: int = None):
        """Post-rotate hook: mirror the generation shuffle and ship the
        freshly-sealed part (now ``<source>.1``) wholesale.  The
        ``drop@replica:part=N`` fault swallows this one ship — only a
        reconciliation pass (:meth:`sync_now`: the next rotation, a
        graceful close, or an operator resync) recovers it, which is
        exactly the catch-up property the fault exists to prove."""
        if not self.peers:
            return
        from raft_tpu_torch.testing import faults

        dropped = (faults.any_active()
                   and faults.fire_info("replica", action="drop",
                                        part=sealed_part) is not None)
        with self._cond:
            self._dirty = True
            self._close_src_locked()     # the live path is a new file
            for p in self.peers:
                self._rotate_peer_locked(p)
            if dropped:
                # the ship of this sealed part is swallowed — and so is
                # whatever incremental copy the peer already held (the
                # lost-part failure this fault models): only a
                # reconciliation pass may bring it back
                for p in self.peers:
                    try:
                        os.remove(p.path + ".1")
                    except OSError:      # pragma: no cover
                        pass
                _LOG.warning("replica: injected drop of sealed part %s "
                             "(catch-up resync must recover it)",
                             sealed_part)
            else:
                self._enqueue_locked("seal")
            self._cond.notify_all()
        if not dropped and self.sync:
            self.sync_now()

    # ------------------------------------------------------------------
    # shipping primitives (called under self._lock)
    # ------------------------------------------------------------------

    def _enqueue_locked(self, token: str):
        if len(self._queue) == self._queue.maxlen:
            self.coalesced += 1          # deque drops the oldest token
        self._queue.append(token)

    def _close_src_locked(self):
        if self._src_fh is not None:
            try:
                self._src_fh.close()
            except OSError:              # pragma: no cover
                pass
            self._src_fh = None

    def _close_peer_fh_locked(self, p: _Peer):
        if p.fh is not None:
            try:
                p.fh.close()
            except OSError:              # pragma: no cover
                pass
            p.fh = None

    def _rotate_peer_locked(self, p: _Peer):
        """Shuffle the peer's generations up exactly like the source
        writer's rotation, and reset the live-part offset — the source
        live file is fresh now."""
        self._close_peer_fh_locked(p)
        try:
            for i in range(self.keep - 1, 0, -1):
                src, dst = f"{p.path}.{i}", f"{p.path}.{i + 1}"
                if os.path.exists(src):
                    os.replace(src, dst)
            if os.path.exists(p.path):
                os.replace(p.path, p.path + ".1")
        except OSError:
            p.errors += 1
            _count_errors(p.dir)
        p.offset = 0

    def _ship_live_locked(self, p: _Peer) -> bool:
        """Append the source live part's complete lines beyond the
        peer's offset (full re-copy when either side shrank — a torn-
        tail truncation or a damaged peer store).  Steady state runs on
        the persistent handles: one seek+read of the source, one
        write+flush to the peer.  Returns True when the peer holds
        every complete source line."""
        src = self._src_fh
        if src is None:
            try:
                src = self._src_fh = open(self.source, "rb")
            except OSError:
                return True              # no source yet: nothing lags
        try:
            src.seek(0, os.SEEK_END)
            if src.tell() < p.offset:
                # source shrank under us (torn-tail truncation):
                # re-mirror the live part whole
                p.offset = 0
                self._close_peer_fh_locked(p)
            src.seek(p.offset)
            data = src.read()
        except (OSError, ValueError):
            self._close_src_locked()
            return False
        end = data.rfind(b"\n")
        if end < 0:
            return True
        chunk = data[:end + 1]
        try:
            if p.fh is None:
                # (re)open: reconcile the peer's on-disk size with our
                # offset once, then the handle owns the file
                try:
                    have = os.path.getsize(p.path)
                except OSError:
                    have = 0
                if have < p.offset:
                    p.offset = 0         # peer lost bytes: re-mirror
                    src.seek(0)
                    data = src.read()
                    end = data.rfind(b"\n")
                    if end < 0:
                        return True
                    chunk = data[:end + 1]
                p.fh = open(p.path, "r+b" if have else "wb")
                p.fh.truncate(p.offset)
                p.fh.seek(p.offset)
            p.fh.write(chunk)
            p.fh.flush()
            p.offset += len(chunk)
            p.shipped += chunk.count(b"\n")
            return True
        except (OSError, ValueError):
            self._close_peer_fh_locked(p)
            p.errors += 1
            _count_errors(p.dir)
            return False

    def _resync_parts_locked(self, p: _Peer):
        """Reconcile every sealed generation by size (idempotent
        wholesale copy of any missing/short part) — the catch-up path a
        dropped or failed seal ship converges through."""
        i = 1
        while True:
            src = f"{self.source}.{i}"
            if not os.path.exists(src):
                break
            dst = f"{p.path}.{i}"
            try:
                want = os.path.getsize(src)
                have = (os.path.getsize(dst)
                        if os.path.exists(dst) else -1)
                if have != want:
                    with open(src, "rb") as fin, open(dst, "wb") as fout:
                        data = fin.read()
                        fout.write(data)
                        fout.flush()
                    p.shipped += data.count(b"\n")
            except OSError:
                p.errors += 1
                _count_errors(p.dir)
            i += 1

    # ------------------------------------------------------------------
    # catch-up worker
    # ------------------------------------------------------------------

    def _worker(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(_TICK_S * 4)
                if self._closed and not self._queue:
                    return
                deferred = self._defer_until - time.monotonic()
                tokens = set(self._queue)
                if deferred <= 0:
                    self._queue.clear()  # one pass serves every token
            if deferred > 0:
                # a lag fault (or a slow peer) deferred mirroring: keep
                # the backlog visible in the lag gauge while waiting
                self._fold_lag()
                time.sleep(min(deferred, _TICK_S))
                continue
            try:
                if "seal" in tokens:
                    self.sync_now()
                else:
                    with self._lock:
                        ok = all([self._ship_live_locked(p)
                                  for p in self.peers])
                    self._fold_lag()
                    if not ok:
                        # the peer is still refusing live bytes: keep
                        # retrying at the tick cadence until it heals
                        # (sealed-part divergence is resync territory —
                        # healed at the next rotation/close/sync_now)
                        time.sleep(_TICK_S)
                        with self._cond:
                            self._enqueue_locked("live")
            # keep-alive seam: the mirror worker must survive any peer
            # trouble — errors are counted per peer, the pass retries
            except Exception:
                _LOG.exception("replica: catch-up pass failed (retrying)")

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    def sync_now(self):
        """One full reconciliation pass: sealed parts by size, live
        part by offset — idempotent; callable by tests and operators."""
        with self._lock:
            for p in self.peers:
                self._resync_parts_locked(p)
                self._ship_live_locked(p)
        self._fold_lag()

    def lag_records(self) -> dict:
        """Per-peer lag in complete records (live-part lines beyond the
        peer's offset plus the lines of missing/short sealed parts)."""
        out = {}
        with self._lock:
            for p in self.peers:
                lag = _count_lines(self.source, p.offset)
                i = 1
                while True:
                    src = f"{self.source}.{i}"
                    if not os.path.exists(src):
                        break
                    dst = f"{p.path}.{i}"
                    try:
                        if (not os.path.exists(dst)
                                or os.path.getsize(dst)
                                != os.path.getsize(src)):
                            lag += _count_lines(src)
                    except OSError:      # pragma: no cover
                        lag += _count_lines(src)
                    i += 1
                out[p.dir] = lag
        return out

    def _fold_lag(self):
        """Refresh the per-peer lag gauges and the degradation signal."""
        lags = self.lag_records()
        try:
            from raft_tpu_torch import obs
            g = obs.gauge(
                "raft_tpu_serve_wal_replication_lag_records",
                "complete WAL records not yet on the peer, by peer")
            for peer, lag in lags.items():
                g.set(float(lag), peer=peer)
        # telemetry guard: lag gauges must never take down the mirror
        except Exception:  # pragma: no cover  # raftlint: disable=RTL004
            pass
        worst = max(lags.values(), default=0)
        self._dirty = worst > 0
        if worst > self.max_lag_records and not self._degraded:
            self._degraded = True
            _LOG.warning("replica: mirror lag %d records exceeds the "
                         "%d budget — a failover now could lose the "
                         "lagging tail (degradation signal raised)",
                         worst, self.max_lag_records)
            try:
                from raft_tpu_torch import obs
                obs.events.emit("replica_lag", lag=int(worst),
                                budget=int(self.max_lag_records))
            except Exception:  # pragma: no cover  # raftlint: disable=RTL004
                pass
        elif self._degraded and worst == 0:
            self._degraded = False
            _LOG.info("replica: mirror caught up (degradation cleared)")

    @property
    def lag_exceeded(self) -> bool:
        return self._degraded

    def check(self):
        """Raise the typed degradation signal when the mirror is behind
        budget (strict callers only — the serving loop reads
        :attr:`lag_exceeded` instead)."""
        if self._degraded:
            lags = self.lag_records()
            raise errors.ReplicaLagExceeded(
                "WAL mirror lag exceeds the configured record budget",
                max_lag_records=self.max_lag_records,
                lag=max(lags.values(), default=0),
                peers=",".join(sorted(lags)))

    def status(self) -> dict:
        """Flat replication facts (service summary / healthz)."""
        lags = self.lag_records()
        with self._lock:
            peers = {p.dir: {"lag_records": int(lags.get(p.dir, 0)),
                             "shipped_records": int(p.shipped),
                             "errors": int(p.errors)}
                     for p in self.peers}
        return {"peers": peers,
                "lag_records": max(lags.values(), default=0),
                "errors": sum(p["errors"] for p in peers.values()),
                "coalesced": int(self.coalesced),
                "lag_exceeded": bool(self._degraded),
                "sync": self.sync}

    def close(self, final_sync: bool = True):
        """Stop the worker; by default run one last reconciliation so a
        graceful stop leaves every peer bit-identical to the source."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._defer_until = 0.0
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(2.0)
        if final_sync:
            self.sync_now()
        with self._lock:
            self._close_src_locked()
            for p in self.peers:
                self._close_peer_fh_locked(p)
