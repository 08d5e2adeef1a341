"""Deadline watchdog for in-flight serve batches.

The port's copy of ``raft_tpu/serve/watchdog.py``.  A hung solve (a
wedged card, a pathological input, an injected ``hang@serve`` fault)
blocks the worker thread indefinitely: neither a launched kernel nor a
Python thread can be cancelled.  The watchdog is the out-of-band escape: a
daemon thread polling a registry of armed deadlines; when one expires
it fires the owner's ``on_expire`` callback exactly once (the service
uses it to abandon the batch, quarantine repeat offenders, re-admit the
survivors, and replace the stuck worker).

Arm/disarm race contract: :meth:`disarm` returns ``False`` when the
entry already expired — the normally-completing worker uses that return
to learn it lost the race and must discard its (late) results.
Callbacks run on the watchdog thread and must never block for long.
"""
from __future__ import annotations

import threading
import time

from raft_tpu_torch.utils.profiling import get_logger

_LOG = get_logger("serve.watchdog")


class Watchdog:
    """Poll-based deadline monitor (daemon thread)."""

    def __init__(self, tick_s: float = 0.05):
        self.tick_s = float(tick_s)
        self._lock = threading.Lock()
        self._armed: dict[int, tuple[float, object]] = {}
        self._next_id = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="raft-serve-watchdog",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    # -- arming -------------------------------------------------------

    def arm(self, deadline_ts: float, on_expire) -> int:
        """Register a deadline; returns the handle for :meth:`disarm`."""
        with self._lock:
            wid = self._next_id
            self._next_id += 1
            self._armed[wid] = (float(deadline_ts), on_expire)
        return wid

    def disarm(self, wid: int) -> bool:
        """Withdraw a deadline.  True = it had not expired (the caller
        owns the result); False = the watchdog already fired for it
        (the caller lost the race and must discard)."""
        with self._lock:
            return self._armed.pop(wid, None) is not None

    def armed_count(self) -> int:
        with self._lock:
            return len(self._armed)

    # -- the loop -----------------------------------------------------

    def _loop(self):
        while not self._stop.wait(self.tick_s):
            now = time.monotonic()
            expired = []
            with self._lock:
                for wid, (deadline, cb) in list(self._armed.items()):
                    if now >= deadline:
                        expired.append((wid, cb))
                        del self._armed[wid]
            for wid, cb in expired:
                # the service keeps running whatever a callback does —
                # a watchdog that dies on its own expiry handler would
                # silently disable every future deadline (the broad
                # catch is the design; config-sanctioned for RTL004)
                try:
                    cb()
                except Exception:
                    _LOG.exception("watchdog: on_expire callback failed "
                                   "(wid=%d)", wid)
