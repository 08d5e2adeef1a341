"""Multi-tenant warm-runner registry for the sweep service.

One device, one :class:`~raft_tpu_torch.serve.service.SweepService`, several
models: each *tenant* is a named model (plus optional degraded-rung
siblings and solver-kwarg overrides) whose warm batch runner
(:func:`raft_tpu_torch.parallel.sweep.make_batch_runner`: the model's
constants resident on the card, the kernels built) is built on first use,
held live, and served to every batch of that tenant's requests (the
port's copy of ``raft_tpu/serve/tenancy.py``; a rebuild after eviction
recomputes the constants, the kernels stay loaded).

Live runners hold device memory, so the registry bounds them:
at most ``max_live_programs`` runners stay resident, evicted LRU when a
new tenant/mode needs a slot.  Every eviction and re-warm is

- **journaled** (a ``tenant`` record in the serve write-ahead journal,
  when one is attached),
- **typed** (misconfiguration — duplicate/unknown tenant names, a
  budget below 1 — raises :class:`raft_tpu_torch.errors.ModelConfigError`),
- **metered** (``raft_tpu_serve_tenant_evictions_total{tenant,mode}``,
  ``raft_tpu_serve_tenant_live_programs``), and
- **streamed** (``tenant_evict`` / ``tenant_rewarm`` flight-recorder
  events),

and per-tenant admission/outcome counts
(``raft_tpu_serve_tenant_requests_total{tenant,outcome}``) land in the
service summary so the trend store can gate per-tenant SLOs.

The registry is also used single-tenant: a service constructed the
single-model way gets one implicit ``default`` tenant, so there is exactly one
runner-lifecycle code path.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

from raft_tpu_torch import errors
from raft_tpu_torch.utils.profiling import get_logger

_LOG = get_logger("serve.tenancy")

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class Tenant:
    """One served model: ``name`` keys requests to it, ``fowt`` is its
    full-fidelity model, ``degraded_fowts`` optionally maps service
    ladder rungs to degraded siblings (``{"coarse": ...}``), and
    ``solver_kw`` overrides the service's solver kwargs for this tenant
    only."""

    name: str
    fowt: object = None
    degraded_fowts: dict = None
    solver_kw: dict = None


class TenantRegistry:
    """Warm-runner registry with an LRU live-program budget."""

    def __init__(self, max_live_programs: int = 4, journal=None):
        if int(max_live_programs) < 1:
            raise errors.ModelConfigError(
                "tenancy needs a live-program budget of at least 1",
                max_live_programs=max_live_programs)
        self.max_live_programs = int(max_live_programs)
        self.journal = journal
        self._lock = threading.RLock()
        #: name -> {"fowts": {mode: fowt}, "solver_kw": dict}
        self._tenants: dict[str, dict] = {}
        #: (name, mode) -> runner, LRU order (most recent last)
        self._runners: collections.OrderedDict = collections.OrderedDict()
        #: keys that were evicted at least once (re-warm accounting)
        self._evicted_keys: set = set()
        self._counts: dict[str, dict] = {}

    # -- configuration -----------------------------------------------

    def add(self, name: str, fowts: dict, solver_kw: dict = None):
        """Register one tenant with its mode->model ladder (built by
        the service, same shape as the single-model ladder)."""
        name = str(name)
        with self._lock:
            if name in self._tenants:
                raise errors.ModelConfigError(
                    "duplicate tenant name", tenant=name)
            self._tenants[name] = {"fowts": dict(fowts),
                                   "solver_kw": dict(solver_kw or {})}
            self._counts[name] = {k: 0 for k in (
                "admitted", "rejected", "completed", "failed",
                "evictions", "rewarms")}

    def names(self) -> list[str]:
        with self._lock:
            return list(self._tenants)

    def require(self, name: str) -> str:
        """Validate a submission's tenant name (typed on miss)."""
        name = str(name)
        with self._lock:
            if name not in self._tenants:
                raise errors.ModelConfigError(
                    "unknown tenant", tenant=name,
                    known=",".join(sorted(self._tenants)))
        return name

    def fowts(self, name: str) -> dict:
        with self._lock:
            return dict(self._tenants[name]["fowts"])

    def resolve_mode(self, name: str, mode: str) -> str:
        """The rung this tenant actually serves ``mode`` at — a tenant
        without a degraded sibling for the rung falls back to its full
        model (degrading the *schedule* is service-wide, degrading the
        *physics* is per-tenant capability)."""
        with self._lock:
            fowts = self._tenants[name]["fowts"]
        return mode if mode in fowts else "full"

    def solver_kw(self, name: str, base: dict) -> dict:
        with self._lock:
            over = self._tenants[name]["solver_kw"]
        return {**base, **over}

    # -- accounting ---------------------------------------------------

    def count(self, name: str, key: str, n: int = 1):
        with self._lock:
            c = self._counts.get(str(name))
            if c is not None and key in c:
                c[key] += int(n)
        if key in ("admitted", "rejected", "completed", "failed"):
            try:
                from raft_tpu_torch import obs
                obs.counter(
                    "raft_tpu_serve_tenant_requests_total",
                    "per-tenant request admissions/outcomes of the "
                    "sweep service").inc(float(n), tenant=str(name),
                                         outcome=key)
            # telemetry guard: tenant metrics must never take down the
            # serving loop (obs contract)
            except Exception:  # pragma: no cover  # raftlint: disable=RTL004
                pass

    def live(self) -> int:
        with self._lock:
            return len(self._runners)

    def facts(self) -> dict:
        """Per-tenant counts + live-program census (service summary)."""
        with self._lock:
            tenants = {n: {**c} for n, c in self._counts.items()}
            for (name, mode), r in self._runners.items():
                t = tenants.setdefault(name, {})
                t.setdefault("live", []).append(
                    {"mode": mode,
                     "cache": getattr(r, "cache_state", "n/a")})
            return {"tenants": tenants,
                    "live_programs": len(self._runners),
                    "max_live_programs": self.max_live_programs,
                    "evictions": sum(c["evictions"]
                                     for c in self._counts.values()),
                    "rewarms": sum(c["rewarms"]
                                   for c in self._counts.values())}

    def exec_keys(self) -> dict:
        """Exec-cache keys of the live runners, ``tenant/mode``-keyed —
        what the handoff manifest names for the successor's warm
        start (runners without a key — stubs, cache-disabled builds —
        are omitted)."""
        with self._lock:
            out = {}
            for (name, mode), r in self._runners.items():
                key = getattr(r, "key", None)
                if key:
                    out[f"{name}/{mode}"] = key
            return out

    # -- the runner lifecycle ----------------------------------------

    def _gauge_live_locked(self):
        try:
            from raft_tpu_torch import obs
            obs.gauge("raft_tpu_serve_tenant_live_programs",
                      "warm compiled batch programs resident across "
                      "all tenants").set(float(len(self._runners)))
        # telemetry guard: the live-program gauge must never take down
        # the serving loop (obs contract)
        except Exception:  # pragma: no cover  # raftlint: disable=RTL004
            pass

    def _evict_locked(self, protect: tuple):
        from raft_tpu_torch import obs

        while len(self._runners) >= self.max_live_programs:
            victim = next((k for k in self._runners if k != protect),
                          None)
            if victim is None:                       # pragma: no cover
                return
            self._runners.pop(victim)
            self._evicted_keys.add(victim)
            vname, vmode = victim
            if vname in self._counts:
                self._counts[vname]["evictions"] += 1
            obs.counter(
                "raft_tpu_serve_tenant_evictions_total",
                "warm-runner LRU evictions under the live-program "
                "budget").inc(1.0, tenant=vname, mode=vmode)
            obs.events.emit("tenant_evict", tenant=vname, mode=vmode,
                            live=len(self._runners),
                            budget=self.max_live_programs)
            if self.journal is not None:
                self.journal.record_tenant("evict", vname, vmode)
            _LOG.info("tenancy: evicted warm runner %s/%s "
                      "(budget %d)", vname, vmode,
                      self.max_live_programs)

    def runner(self, name: str, mode: str, build):
        """The live runner for ``(tenant, mode)``, building (and
        LRU-evicting to budget) on miss.  ``build(fowt, solver_kw)``
        constructs the warm runner.  The build runs OUTSIDE the registry
        lock: a cold build takes seconds and ``submit``/``stats`` paths
        need ``require``/``count`` on the same lock — admission
        control must stay instant while a program builds."""
        from raft_tpu_torch import obs

        key = (str(name), str(mode))
        with self._lock:
            runner = self._runners.get(key)
            if runner is not None:
                self._runners.move_to_end(key)
                return runner
            fowt = self._tenants[key[0]]["fowts"].get(mode)
            kw = self._tenants[key[0]]["solver_kw"]
            rewarm = key in self._evicted_keys
        runner = build(fowt, kw)
        with self._lock:
            existing = self._runners.get(key)
            if existing is not None:
                # lost a build race (two workers during a watchdog
                # replacement): serve the registered one
                return existing
            self._evict_locked(protect=key)
            self._runners[key] = runner
            self._gauge_live_locked()
            if rewarm:
                self._counts[key[0]]["rewarms"] += 1
                obs.events.emit(
                    "tenant_rewarm", tenant=key[0], mode=key[1],
                    cache=getattr(runner, "cache_state", "n/a"))
                if self.journal is not None:
                    self.journal.record_tenant("rewarm", key[0], key[1])
        return runner
