"""The always-on sweep service: admission, batching, deadlines, retry.

:class:`SweepService` turns the batch-shaped sweep stack into a
long-lived, request-driven loop whose headline property is *staying up
and degrading gracefully* under sustained, partially-faulty traffic:

- **Admission control / load shedding** — a bounded request queue;
  above the ``queue_max`` watermark (or when the estimated queue wait
  already blows the request's deadline, or while the service sits in
  its ``reject`` degradation mode) ``submit`` raises a typed
  :class:`raft_tpu_torch.errors.AdmissionRejected` carrying a ``Retry-After``
  hint derived from queue depth and the observed batch cadence.
- **Batching window** — admitted requests coalesce for ``window_s``
  into fixed-size batches solved by ONE warm runner
  (:func:`raft_tpu_torch.parallel.sweep.make_batch_runner`): model state is
  device-resident across requests.
- **Deadlines + watchdog** — a stuck solve cannot be cancelled, so the :class:`raft_tpu_torch.serve.watchdog.Watchdog` abandons the
  batch out-of-band: members are re-admitted *solo* (so a repeat
  offender isolates itself), repeat offenders are quarantined as typed
  :class:`~raft_tpu_torch.errors.DeadlineExceeded` failures, and a fresh
  worker replaces the stuck one — the process never dies.
- **Retry/backoff** — typed solver failures walk the per-error-class
  budgets of :class:`raft_tpu_torch.serve.retry.RetryPolicy` with
  deterministic jittered exponential backoff; transient faults never
  surface to callers.
- **Service degradation ladder** — sustained SLO violation steps the
  service ``full -> no_qtf -> coarse -> reject`` (and back up when
  healthy); every transition is a flight-recorder event, a metric, and
  a manifest record.
- **Durability** — with ``ServeConfig.journal_dir`` set, every
  admission, batch assignment, typed failure, and result digest is
  appended to a crash-safe write-ahead journal
  (:mod:`raft_tpu_torch.serve.journal`) *before* it is acknowledged;
  :meth:`SweepService.recover` replays it after a crash (re-admitting
  accepted-but-unfinished requests under their original seqs, marking
  completed digests fetchable without re-solving, deduping duplicate
  submissions by content digest) and :meth:`SweepService.drain` hands
  a live service off to a successor with every in-flight request
  either completed or journaled as pending — never dropped.
- **Multi-tenant warm runners** — several models share the device
  behind one service (:mod:`raft_tpu_torch.serve.tenancy`): requests name a
  tenant, batches never mix tenants, and each tenant/mode's warm
  runner is held under an LRU live-program budget with
  journaled, metered eviction/re-warm.
- **Replication** — with ``ServeConfig.mirror_dirs`` the WAL streams
  to peer stores (:mod:`raft_tpu_torch.serve.replica`): a successor on a
  different host recovers from a mirror alone, duplicate delivery
  across replicas dedupes by request digest
  (:meth:`fetch_rdigest`), and mirror lag beyond budget is a typed
  degradation signal folded into the service ladder.

Results are delivered asynchronously: ``submit`` returns a
:class:`Ticket`; each completed request carries the ledger-style
content digest of its physics outputs (identical to the ``case<i>``
entry digest a clean ``sweep_cases`` ledger would hold), and completed
results are additionally fetchable by that digest.

Everything here is host-side orchestration; all solve work happens
through the injected ``runner_factory`` (default: the warm batch runner
over the service's FOWT model).

The port's copy of ``raft_tpu/serve/service.py``.  What differs:

- the engine is ``raft_tpu_torch.parallel.sweep.make_batch_runner`` on the
  service's ``device`` (the card unless ``device="cpu"``), K1 (or K3
  under ``RAFT_TPU_PRECISION=mixed``) on every batch; the worker threads
  run under ``torch.cuda.device`` of it;
- each batch's results reach the host in ONE counted pull
  (``obs.transfers``, ``what="serve_batch"``, phase ``serve``; the drag
  fixed point's chunk checks count there too);
- a batch the watchdog abandons keeps running on its (uncancellable)
  thread and its kernels share the card's stream with the next batch;
  its late results are dropped by generation, as in the JAX package;
- there is no executable cache (runners report ``cache_state``
  ``"disabled"``) and no learned read tier (``surrogate_dir`` raises,
  ROADMAP A10).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import threading
import time
import uuid

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch._config import resolve_device
from raft_tpu_torch.obs.tracing import TraceContext
from raft_tpu_torch.parallel.sweep import on_device
from raft_tpu_torch.serve import journal as wal
from raft_tpu_torch.serve.config import MODES, ServeConfig
from raft_tpu_torch.serve.retry import RetryPolicy
from raft_tpu_torch.serve.tenancy import DEFAULT_TENANT, Tenant, TenantRegistry
from raft_tpu_torch.serve.watchdog import Watchdog
from raft_tpu_torch.utils.profiling import get_logger

_LOG = get_logger("serve")

#: the fixed phase vocabulary of the per-request latency breakdown
#: (raft_tpu_serve_request_phase_seconds{phase=...}), the JAX package's
#: names: "compile_cold" / "compile_warm" is the runner's acquisition,
#: a build (constants, warm-up batch) or a live runner
PHASES = ("admission", "queue_wait", "batch_fill", "compile_cold",
          "compile_warm", "solve", "store_write", "delivery")

#: phase-latency buckets: sub-millisecond admission/delivery up through
#: minutes-long descents
PHASE_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5,
                 5.0, 10.0, 30.0, 60.0, 120.0)


def _coerce_trace(trace) -> TraceContext:
    """The submit edge's trace-context normalizer: an inbound header
    string or upstream context derives a child hop; anything
    missing/malformed mints a fresh root.  Allocation-only — no I/O,
    no locks (the submit edge's hot-path contract)."""
    if isinstance(trace, TraceContext):
        return trace
    if isinstance(trace, str):
        parsed = TraceContext.parse(trace)
        return parsed.child() if parsed else TraceContext.mint()
    if isinstance(trace, dict):
        parsed = TraceContext.from_dict(trace)
        return parsed.child() if parsed else TraceContext.mint()
    return TraceContext.mint()


@dataclasses.dataclass
class SweepResult:
    """One request's terminal outcome (ok or typed failure)."""

    ok: bool
    request_id: str
    seq: int
    mode: str
    attempts: int
    latency_s: float
    digest: str | None = None
    std: list | None = None
    iters: int | None = None
    converged: bool | None = None
    quarantined: bool = False
    error: dict | None = None
    tenant: str = DEFAULT_TENANT
    #: how this result reached the caller: "solved" (this process ran
    #: it), "replayed" (journal recovery re-solved it), "recovered"
    #: (journaled result re-delivered without a solve), or "deduped"
    #: (duplicate submission matched a completed request digest)
    source: str = "solved"
    #: digest-addressed payload beyond the std row — the optimize
    #: tenant's optimized design + provenance (iterations, final
    #: gradient norm, objective trace); None for plain sweep results
    extra: dict | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Ticket:
    """Async handle of one admitted request.  ``trace`` is the
    request's distributed trace context (when known at admission) —
    the HTTP layer echoes it so async callers can correlate a 202
    with the eventual result."""

    def __init__(self, request_id: str, seq: int,
                 trace: "TraceContext" = None):
        self.id = request_id
        self.seq = seq
        self.trace = trace
        self._event = threading.Event()
        self._result: SweepResult | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float = None) -> SweepResult:
        """Block for the terminal result; raises a typed
        :class:`~raft_tpu_torch.errors.DeadlineExceeded` on wait timeout."""
        if not self._event.wait(timeout):
            raise errors.DeadlineExceeded("result wait timed out",
                                          request=self.id)
        return self._result

    def _finish(self, result: SweepResult):
        self._result = result
        self._event.set()


class _Request:
    __slots__ = ("seq", "id", "Hs", "Tp", "beta", "deadline_ts",
                 "submitted_ts", "attempts", "total_attempts", "strikes",
                 "solo", "not_before", "ticket", "tenant", "rdigest",
                 "replayed", "followers", "opt", "farm", "trace",
                 "t_admitted", "t_gathered", "t_solve0", "t_solved")

    def __init__(self, seq, Hs, Tp, beta, deadline_ts, now,
                 tenant=DEFAULT_TENANT, request_id=None, rdigest=None,
                 opt=None, farm=None, trace=None):
        self.seq = int(seq)
        self.id = request_id or f"req{seq}-{uuid.uuid4().hex[:8]}"
        self.Hs = float(Hs)
        self.Tp = float(Tp)
        self.beta = float(beta)
        self.deadline_ts = float(deadline_ts)
        self.submitted_ts = float(now)
        self.attempts: dict[str, int] = {}
        self.total_attempts = 0
        self.strikes = 0
        self.solo = False
        self.not_before = 0.0
        self.tenant = str(tenant)
        # callers that already hashed the admission (the store-enabled
        # submit edge — the exact path the serve bench measures) pass
        # the digest through instead of hashing twice; an optimize
        # request is content-addressed over its spec, never its
        # placeholder Hs/Tp/beta
        self.rdigest = rdigest or (
            wal.optimize_digest(opt, str(tenant)) if opt
            else wal.farm_digest(farm, str(tenant)) if farm
            else wal.request_digest(Hs, Tp, beta, self.tenant))
        self.replayed = False
        #: optimize-tenant request: the canonical design-optimization
        #: spec (bounds + objective + descent knobs); None = sweep case
        self.opt = dict(opt) if opt else None
        #: farm-tenant request: the canonical farm spec (layout + case
        #: table + wake knobs); None = single-FOWT sweep case
        self.farm = dict(farm) if farm else None
        #: single-flight followers: duplicate submissions attached to
        #: this (primary) request — they never enter the queue, and the
        #: primary's terminal outcome fans out to them
        self.followers: list["_Request"] = []
        #: distributed trace identity (obs.tracing.TraceContext) —
        #: every request carries one; callers without an inbound
        #: context get a freshly minted root
        self.trace: TraceContext = trace or TraceContext.mint()
        #: lock-free phase timestamps (monotonic), stamped along the
        #: request's journey and folded into the phase histograms only
        #: inside the already-locked completion paths
        self.t_admitted = 0.0
        self.t_gathered = 0.0
        self.t_solve0 = 0.0
        self.t_solved = 0.0
        self.ticket = Ticket(self.id, self.seq, trace=self.trace)


class SweepService:
    """Long-lived request-driven sweep service (see module docstring).

    ``fowt``: the model every request solves against (device-pinned for
    the service lifetime).  ``degraded_fowts`` optionally maps ladder
    rungs to degraded models (``{"coarse": fowt_on_decimated_grid}``);
    the ``no_qtf`` rung is auto-derived when the model carries
    second-order terms, and rungs with no model are skipped.
    ``runner_factory(mode, fowt, ncases, **solver_kw)`` overrides the
    batch engine (tests inject stubs; default is the warm
    ``make_batch_runner``).  ``tenants`` adds further served models
    (:class:`raft_tpu_torch.serve.tenancy.Tenant` records) next to the
    implicit ``default`` tenant built from ``fowt``; with
    ``config.journal_dir`` set the service keeps a write-ahead request
    journal and becomes crash-recoverable (:meth:`recover`) and
    hand-off-able (:meth:`drain`).

    ``device`` (resolved by ``_config.resolve_device``: the card unless
    ``device="cpu"``; no card raises) is the device every runner of the
    service solves on: each served model is carried there once, and the
    batch and long-request workers run under ``torch.cuda.device`` of it
    (the current device is per thread).
    """

    def __init__(self, fowt=None, config: ServeConfig = None, *,
                 degraded_fowts: dict = None, runner_factory=None,
                 tenants: list[Tenant] = None, device=None):
        self.cfg = config or ServeConfig()
        self.device = resolve_device(device)
        self._runner_factory = runner_factory
        if runner_factory is None and fowt is not None:
            fowt = on_device(fowt, self.device)
        self.fowt = fowt
        self.retry = RetryPolicy.from_config(self.cfg)
        self._watchdog = Watchdog(self.cfg.watchdog_tick_s)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queue: collections.deque[_Request] = collections.deque()
        self._inflight: dict[int, dict] = {}
        #: requests popped by _gather but not yet registered in
        #: _inflight — without it, stop()'s idle check can declare the
        #: service drained inside the pop->register window and a retry
        #: requeued after that leaves its ticket unresolved forever
        self._ngathered = 0
        # -- durability: the WAL opens with the service object, so a
        # recover()/submit() before start() is journaled too.  _open
        # tracks every admitted-but-unfinished request under its own
        # leaf lock (never held while taking any other lock) so the
        # journal's rotation checkpoint can snapshot it without a
        # lock-order cycle against the serving paths
        self._open_lock = threading.Lock()
        self._open: dict[int, _Request] = {}
        self._journal = None
        if self.cfg.journal_dir:
            self._journal = wal.RequestJournal(
                self.cfg.journal_dir, run_id=uuid.uuid4().hex[:12],
                snapshot_fn=self._journal_snapshot,
                mirror_dirs=self.cfg.mirror_dirs,
                mirror_max_lag=self.cfg.replica_max_lag_records,
                mirror_sync=self.cfg.mirror_sync)
        # -- tenancy: every model (including the single-model
        # shape) lives in the registry as a tenant
        self._tenants = TenantRegistry(self.cfg.max_live_programs,
                                       journal=self._journal)
        self._fowts = self._build_fowt_ladder(fowt, degraded_fowts or {})
        self._tenants.add(DEFAULT_TENANT, self._fowts)
        for t in (tenants or []):
            if t.name == DEFAULT_TENANT:
                raise errors.ModelConfigError(
                    "tenant name 'default' is reserved for the "
                    "service-level model", tenant=t.name)
            self._tenants.add(t.name,
                              self._build_fowt_ladder(
                                  t.fowt, t.degraded_fowts or {}),
                              t.solver_kw)
        self.ladder = tuple(m for m in MODES
                            if m in self._fowts or m == "reject")
        self._recover_info = None
        self._handoff_info = None
        self._replayed_pending: set[int] = set()
        self._successor = None
        self._mode_idx = 0
        self._mode_entered = time.monotonic()
        self._bad_streak = 0
        self._good_streak = 0
        self._seq = 0
        self._batch_seq = 0
        self._gen = 0
        self._worker: threading.Thread | None = None
        self._state = "new"            # new | running | draining | stopped
        self._ema_batch_s: float | None = None
        # bounded: a long-lived service must not grow per-request state
        # without limit; 10k samples is plenty for p50/p99 reporting
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=10_000)
        self._delivered: collections.OrderedDict[str, SweepResult] = \
            collections.OrderedDict()
        #: request digest -> result digest of delivered results — the
        #: cross-replica re-resolution index: a router (or a duplicate
        #: submission that landed on another replica) fetches by the
        #: CONTENT of the request when the replica that held its ticket
        #: died; bounded alongside _delivered
        self._rdigest_index: collections.OrderedDict[str, str] = \
            collections.OrderedDict()
        self._transitions: list[dict] = []
        self._counts = {k: 0 for k in (
            "admitted", "rejected", "completed", "failed", "quarantined",
            "retries", "retried_recovered", "deadline_misses",
            "unhandled", "batches", "abandoned_batches", "expired",
            "store_hits", "coalesced", "warm_seeded", "warm_rejected",
            "warm_mismatch", "ckpt_resumed", "ckpt_shed", "store_shed")}
        # -- storage-shed ladder (serve/checkpoint.py, ENOSPC): typed
        # StorageExhausted from a persistence write sheds THAT rung for
        # storage_shed_hold_s — checkpointing first, then the
        # result-store write-through; admission and delivery never
        # degrade on a full disk.  component -> monotonic shed-until
        self._storage_shed: dict[str, float] = {}
        self._last_resumed_step = 0
        # -- result tier (serve/resultstore.py): the persistent
        # content-addressed read-through store, single-flight request
        # coalescing, and neighbor warm starts all key off store_dir
        self._store = None
        if self.cfg.store_dir:
            from raft_tpu_torch.serve.resultstore import ResultStore
            self._store = ResultStore(self.cfg.store_dir,
                                      keep_xi=self.cfg.warm_start)
        #: rdigest -> the PRIMARY in-flight request duplicates attach to
        self._flight: dict[str, _Request] = {}
        # -- preemption tolerance (serve/checkpoint.py): descent
        # progress persists every checkpoint_every steps; recover()
        # resumes an accepted-unfinished optimization from its newest
        # valid checkpoint instead of step 0
        self._ckpt = None
        if self.cfg.ckpt_dir:
            from raft_tpu_torch.serve.checkpoint import CheckpointStore
            self._ckpt = CheckpointStore(
                self.cfg.ckpt_dir,
                budget_bytes=self.cfg.disk_budget_bytes)
        # -- optimize tenant (parallel/optimize.py): design-optimization
        # requests ride their own bounded queue and dedicated worker —
        # one descent is a whole batch of its own, not a lane in
        # a case batch — but share the WAL, the delivered-result
        # indexes, the single-flight map, and the admission ladder
        self._opt_queue: collections.deque[_Request] = collections.deque()
        self._opt_worker: threading.Thread | None = None
        self._opt_busy = False
        #: EMA of one descent's wall time — the optimize queue's own
        #: Retry-After basis (the sweep estimate knows nothing about
        #: minutes-long descents)
        self._opt_ema_s: float | None = None
        #: read-tier latencies (ms) for the p50/p99 summary facts
        self._read_ms: collections.deque[float] = collections.deque(
            maxlen=10_000)
        #: per-phase latency samples (s) behind the phase_p50/p99
        #: trend facts; bounded like _latencies
        self._phase_s: dict[str, collections.deque] = {
            p: collections.deque(maxlen=10_000) for p in PHASES}
        #: did the latest _ensure_runner acquisition build (cold) or
        #: reuse (warm)?  Read only by the batch worker that just called
        self._runner_was_cold = False
        self._last_health = None
        #: observed cold-start iteration baseline (EMA over unseeded
        #: lanes) — what non-audited warm batches report savings against
        self._cold_iters_ema: float | None = None
        self._warm_iter_savings = 0.0
        self._manifest = None

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _build_fowt_ladder(self, fowt, degraded: dict) -> dict:
        if self._runner_factory is None:
            # the port's engines solve on the service's device: carry
            # every rung's model there once (a no-op when it is)
            fowt = (on_device(fowt, self.device) if fowt is not None
                    else None)
            degraded = {m: on_device(f, self.device)
                        for m, f in degraded.items()}
        out = {"full": fowt}
        if "no_qtf" in degraded:
            out["no_qtf"] = degraded["no_qtf"]
        elif fowt is not None and getattr(fowt, "potSecOrder", 0):
            try:
                out["no_qtf"] = dataclasses.replace(fowt, potSecOrder=0)
            except (TypeError, ValueError):
                pass                    # rung unavailable: skipped
        if "coarse" in degraded:
            out["coarse"] = degraded["coarse"]
        if self._runner_factory is not None:
            # an injected engine serves every configured rung
            for m in degraded:
                out.setdefault(m, degraded[m])
        return out

    # ------------------------------------------------------------------
    # observability plumbing
    # ------------------------------------------------------------------

    def _obs(self):
        from raft_tpu_torch import obs
        return obs

    def _emit(self, type_: str, **fields):
        self._obs().events.emit(type_, **fields)

    def _observe_phase(self, phase: str, seconds: float):
        """Fold one phase-latency sample into the labeled histogram and
        the bounded summary deque.  Called only from completion paths
        (never the submit edge); negative/unset stamps are dropped."""
        if seconds is None or not (seconds >= 0.0):
            return
        self._obs().histogram(
            "raft_tpu_serve_request_phase_seconds",
            "per-request latency breakdown by phase (admission, queue "
            "wait, batch fill, compile cold/warm, solve, store write, "
            "delivery)", buckets=PHASE_BUCKETS).observe(
                float(seconds), phase=phase)
        dq = self._phase_s.get(phase)
        if dq is not None:
            dq.append(float(seconds))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "SweepService":
        obs = self._obs()
        with self._lock:
            if self._state not in ("new", "stopped"):
                return self
            self._state = "running"
        self._manifest = obs.RunManifest.begin(
            kind="serve",
            config={**self.cfg.scalars(),
                    "ladder": "->".join(self.ladder),
                    "tenants": ",".join(self._tenants.names()),
                    "journaled": self._journal is not None,
                    "nw": (len(self.fowt.w)
                           if self.fowt is not None else 0)})
        obs.record_build_info(run_id=self._manifest.run_id)
        self._watchdog.start()
        self._spawn_worker()
        self._emit("service_start", run_id=self._manifest.run_id,
                   ladder=list(self.ladder))
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _spawn_worker(self):
        with self._lock:
            self._gen += 1
            gen = self._gen
            t = threading.Thread(target=self._worker_loop, args=(gen,),
                                 name=f"raft-serve-worker-{gen}",
                                 daemon=True)
            self._worker = t
        t.start()

    def stop(self, drain: bool = True, timeout: float = 120.0) -> dict:
        """Stop the service (optionally draining the queue first),
        finish the run manifest (-> trend store), and return the serve
        summary."""
        with self._cond:
            if self._state == "stopped":
                return self.summary()
            self._state = "draining" if drain else "stopped"
            self._cond.notify_all()
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                idle = (not self._queue and not self._inflight
                        and self._ngathered == 0
                        and not self._opt_queue and not self._opt_busy)
            if idle:
                break
            time.sleep(0.02)
        with self._cond:
            self._state = "stopped"
            # flush anything left (non-drain stop or drain timeout)
            leftovers = list(self._queue) + list(self._opt_queue)
            self._queue.clear()
            self._opt_queue.clear()
            self._cond.notify_all()
        for r in leftovers:
            self._fail(r, errors.DeadlineExceeded(
                "service stopped before the request ran", req=r.seq))
        worker = self._worker
        if worker is not None:
            worker.join(2.0)
        opt_worker = self._opt_worker
        if opt_worker is not None:
            opt_worker.join(2.0)
        self._watchdog.stop()
        summary = self.summary()
        if self._manifest is not None:
            obs = self._obs()
            self._manifest.extra["serve"] = summary
            self._manifest.extra["retry_matrix"] = self.retry.matrix()
            obs.finish_run(self._manifest, status="ok")
            self._manifest = None
        if self._journal is not None:
            self._journal.close()
        return summary

    # ------------------------------------------------------------------
    # durability: crash recovery + graceful handoff
    # ------------------------------------------------------------------

    def _journal_snapshot(self) -> list[dict]:
        """Admit records of every still-open request — what the WAL
        re-appends into a fresh part on size rotation, so an open
        request's admission can never age out with a dropped part."""
        with self._open_lock:
            reqs = list(self._open.values())
        now = time.monotonic()
        out = []
        for r in reqs:
            rec = {"t": round(time.time(), 6), "type": "admit",
                   "seq": r.seq, "id": r.id, "rdigest": r.rdigest,
                   "Hs": r.Hs, "Tp": r.Tp, "beta": r.beta,
                   "deadline_s": max(0.0, r.deadline_ts - now),
                   "tenant": r.tenant, "checkpoint": True,
                   "trace": r.trace.as_dict()}
            if r.opt is not None:
                rec["opt"] = dict(r.opt)
            out.append(rec)
        return out

    def _track_open(self, r: _Request):
        with self._open_lock:
            self._open[r.seq] = r

    def _untrack_open(self, seq: int):
        with self._open_lock:
            self._open.pop(seq, None)

    def recover(self, journal_dir: str = None) -> dict:
        """Replay a write-ahead journal into this (fresh) service.

        ``journal_dir`` (default: the configured ``cfg.journal_dir``)
        may equally be a **mirror** directory left by the WAL
        replication layer (:mod:`raft_tpu_torch.serve.replica`) on a
        different host — a mirror replays exactly like a primary, its
        possibly-missing torn live-part tail skip-and-counted like any
        other torn line.  ``recover`` may be called more than once on
        the same service (own journal, then a dead peer's mirror): a
        later replay's pending request whose request digest matches a
        result an earlier replay already delivered resolves as a
        **dedupe hit** — duplicate delivery across replicas never
        re-solves.

        Scans the directory and

        - marks every journaled **completed** result fetchable by its
          ledger digest without re-solving (``recovered``),
        - re-admits every **accepted-but-unfinished** request under its
          *original admission seq* — so the deterministic retry/backoff
          keys (``req<seq>``) line up with the crashed process —
          returning fresh tickets for them (``replayed``); a seq this
          life already uses (a SECOND fold whose seq space overlaps
          the first's) is remapped onto fresh seq space, and admits
          inherited from a foreign directory are re-journaled into our
          own WAL (the returned ``tickets`` stay keyed by the source
          journal's seqs either way),
        - resolves **duplicate submissions** whose request digest
          matches an already-completed one from the journal instead of
          re-solving (``deduped``), journaling the dedupe as a
          ``complete`` record so the *next* replay is idempotent too,
        - **skips** torn/corrupt lines, counted in
          ``raft_tpu_journal_corrupt_total{kind="serve"}``.

        Returns ``{"recovered", "replayed", "deduped", "corrupt",
        "tickets": {seq: Ticket}}``; the accounting is also emitted to
        the flight recorder (``journal_recovered``), the
        ``raft_tpu_serve_journal_replayed_total{outcome}`` metric, the
        service summary/manifest, and appended to the journal as a
        ``recover`` record.  Call before or just after :meth:`start`,
        on a service pointed at the dead process's journal directory.
        """
        obs = self._obs()
        src = journal_dir or self.cfg.journal_dir
        if not src:
            raise errors.ModelConfigError(
                "recover() needs a journal directory (config "
                "journal_dir or the journal_dir argument)")
        is_mirror = bool(
            self.cfg.journal_dir
            and os.path.abspath(str(src))
            != os.path.abspath(str(self.cfg.journal_dir)))
        state = wal.replay(src)
        now = time.monotonic()
        tickets: dict[int, Ticket] = {}
        recovered = replayed = deduped = 0
        with self._cond:
            # seqs below this life's high-water mark are already taken
            # (live traffic or an earlier fold): a second folded
            # journal's colliding seq is REMAPPED onto fresh seq space,
            # or its _open/_replayed_pending tracking would alias the
            # earlier request's and a rotation checkpoint could drop a
            # still-pending admit (zero-loss broken).  Fresh seqs are
            # allocated past BOTH this life's counter and the fold's
            # own max_seq — a remap must never land on a seq the same
            # fold still carries.  Tickets stay keyed by the SOURCE
            # journal's seq — the caller's frame.
            base_seq = self._seq
            next_fresh = max(self._seq, state["max_seq"] + 1)

            def claim_seq(orig: int) -> int:
                nonlocal next_fresh
                if orig >= base_seq:
                    return orig
                fresh, next_fresh = next_fresh, next_fresh + 1
                return fresh

            for seq, rec in sorted(state["completed"].items()):
                res = SweepResult(
                    ok=True, request_id=str(rec.get("id") or f"req{seq}"),
                    seq=int(seq), mode=str(rec.get("mode", "full")),
                    attempts=int(rec.get("attempts", 0)), latency_s=0.0,
                    digest=rec.get("digest"), std=rec.get("std"),
                    iters=rec.get("iters"), converged=rec.get("converged"),
                    extra=rec.get("extra"),
                    tenant=str(state["admitted"].get(seq, {}).get(
                        "tenant", DEFAULT_TENANT)), source="recovered")
                if rec.get("digest"):
                    self._delivered[rec["digest"]] = res
                    if rec.get("rdigest"):
                        self._rdigest_index[rec["rdigest"]] = \
                            rec["digest"]
                    recovered += 1
                    # migrate the recovered result into the persistent
                    # read tier: the NEXT life (and every replica on
                    # this store) serves it at memory speed even after
                    # the journal rotates it away
                    adm = state["admitted"].get(seq, {})
                    if self._store is not None and rec.get("rdigest") \
                            and "Hs" in adm and res.mode == "full":
                        self._store_put({
                            "rdigest": rec["rdigest"],
                            "digest": rec["digest"],
                            "std": rec.get("std") or [],
                            "iters": int(rec.get("iters") or 0),
                            "converged": bool(rec.get("converged")),
                            "tenant": res.tenant, "Hs": adm["Hs"],
                            "Tp": adm.get("Tp"), "beta": adm.get("beta"),
                            "mode": res.mode, "id": res.request_id,
                            "seq": int(seq)})
            while len(self._delivered) > self.cfg.result_cache:
                self._delivered.popitem(last=False)
            while len(self._rdigest_index) > self.cfg.result_cache:
                self._rdigest_index.popitem(last=False)
            for orig, prior in sorted(state["deduped"].items()):
                # the duplicate's physics already solved: deliver the
                # journaled payload under the duplicate's seq and make
                # it terminal in the WAL
                dup = state["admitted"][orig]
                seq = claim_seq(int(orig))
                res = SweepResult(
                    ok=True, request_id=str(dup.get("id") or f"req{seq}"),
                    seq=seq, mode=str(prior.get("mode", "full")),
                    attempts=0, latency_s=0.0, digest=prior.get("digest"),
                    std=prior.get("std"), iters=prior.get("iters"),
                    converged=prior.get("converged"),
                    extra=prior.get("extra"),
                    tenant=str(dup.get("tenant", DEFAULT_TENANT)),
                    source="deduped")
                if self._journal is not None:
                    self._journal.record_complete(
                        seq, dup.get("rdigest"), prior.get("digest"),
                        res.mode, 0, res.std or [], res.iters or 0,
                        bool(res.converged), extra=res.extra,
                        trace=dup.get("trace"))
                t = Ticket(res.request_id, seq)
                t._finish(res)
                tickets[int(orig)] = t
                deduped += 1
            for rec in state["pending"]:
                orig = int(rec["seq"])
                seq = claim_seq(orig)
                tenant = str(rec.get("tenant", DEFAULT_TENANT))
                deadline_s = float(rec.get("deadline_s",
                                           self.cfg.deadline_s))
                # cross-replica dedupe: a request this service already
                # delivered (an earlier recover — own journal or another
                # replica's mirror — or live traffic) re-resolves from
                # the delivered payload instead of re-solving
                prior_digest = self._rdigest_index.get(rec.get("rdigest"))
                prior_res = (self._delivered.get(prior_digest)
                             if prior_digest else None)
                if prior_res is not None:
                    res = dataclasses.replace(
                        prior_res,
                        request_id=str(rec.get("id") or f"req{seq}"),
                        seq=seq, tenant=tenant, attempts=0,
                        latency_s=0.0, source="deduped")
                    if self._journal is not None:
                        self._journal.record_complete(
                            seq, rec.get("rdigest"), res.digest,
                            res.mode, 0, res.std or [], res.iters or 0,
                            bool(res.converged), extra=res.extra,
                            trace=rec.get("trace"))
                    t = Ticket(res.request_id, seq)
                    t._finish(res)
                    tickets[orig] = t
                    deduped += 1
                    continue
                # resume linkage: the replayed request keeps the dead
                # process's trace_id and parents its fresh span on the
                # journaled one — the successor's spans LINK to the
                # original trace instead of starting a new one (legacy
                # trace-less WALs mint a fresh root)
                inherited = TraceContext.from_dict(rec.get("trace"))
                req = _Request(seq, rec.get("Hs", 0.0),
                               rec.get("Tp", 1.0), rec.get("beta", 0.0),
                               now + deadline_s,
                               now, tenant=tenant,
                               request_id=rec.get("id"),
                               rdigest=rec.get("rdigest"),
                               opt=rec.get("opt"),
                               farm=rec.get("farm"),
                               trace=(inherited.child()
                                      if inherited else None))
                req.replayed = True
                tickets[orig] = req.ticket
                # a foreign fold (a dead peer's mirror) replays admits
                # OUR journal never saw: re-journal them, or a crash of
                # THIS process before solving them would lose them from
                # our own mirror chain — WAL-before-ack applies to
                # inherited work too
                if self._journal is not None and (is_mirror
                                                  or seq != orig):
                    self._journal.record_admit(
                        seq, req.id, req.rdigest, req.Hs, req.Tp,
                        req.beta, deadline_s, tenant, opt=req.opt,
                        farm=req.farm,
                        trace=req.trace.as_dict())
                if tenant not in self._tenants.names():
                    # the successor was configured without this tenant:
                    # a typed failure, never a silent drop
                    self._counts["admitted"] += 1
                    replayed += 1
                    self._replayed_pending.add(seq)
                    self._fail(req, errors.ModelConfigError(
                        "replayed request names a tenant this service "
                        "does not carry", tenant=tenant, seq=seq))
                    continue
                if req.opt is not None or req.farm is not None:
                    # an accepted-but-unfinished optimization or farm
                    # solve replays onto the long-request queue (re-run
                    # as submitted); single-flight holds through replay
                    # like any duplicate pair
                    prim = self._flight.get(req.rdigest)
                    if prim is not None and not prim.ticket.done():
                        prim.followers.append(req)
                        self._counts["coalesced"] += 1
                    else:
                        self._flight[req.rdigest] = req
                        self._opt_queue.append(req)
                    self._counts["admitted"] += 1
                    self._replayed_pending.add(seq)
                    self._track_open(req)
                    replayed += 1
                    continue
                if self._store is not None:
                    # single-flight holds through replay too: a second
                    # pending admit carrying the same request digest
                    # attaches to the first as a follower — a storm
                    # interrupted by a crash still performs exactly one
                    # solve per distinct digest after recovery
                    prim = self._flight.get(req.rdigest)
                    if prim is not None and not prim.ticket.done():
                        prim.followers.append(req)
                        self._counts["admitted"] += 1
                        self._counts["coalesced"] += 1
                        self._replayed_pending.add(seq)
                        self._track_open(req)
                        replayed += 1
                        continue
                    self._flight[req.rdigest] = req
                self._queue.append(req)
                self._counts["admitted"] += 1
                self._replayed_pending.add(seq)
                self._track_open(req)
                replayed += 1
            # preserve the crashed process's seq space so new
            # admissions and replayed backoff keys can never collide
            self._seq = max(self._seq, state["max_seq"] + 1, next_fresh)
            self._cond.notify_all()
        if self._opt_queue:
            self._ensure_opt_worker()
        info = {"recovered": recovered, "replayed": replayed,
                "deduped": deduped, "corrupt": int(state["corrupt"])}
        # journaled ckpt records tie a pending descent's digest to its
        # last persisted segment — the resume audit trail the preempt
        # soak's second replay agrees on (the resume itself reads the
        # checkpoint STORE by rdigest when the descent re-runs)
        ckpt_records = len(state.get("ckpts") or {})
        # accumulate across calls (own journal, then a peer's mirror);
        # the mirror flag is sticky — ANY fold of a foreign directory
        # makes this life a failover, which the failover SLO facts gate
        prev = self._recover_info or {}
        self._recover_info = {
            **{k: prev.get(k, 0) + v for k, v in info.items()},
            "journal_dir": str(src),
            "records": prev.get("records", 0) + int(state["records"]),
            "ckpt_records": prev.get("ckpt_records", 0) + ckpt_records,
            "mirror": bool(prev.get("mirror")) or is_mirror}
        for outcome, n in info.items():
            if n:
                obs.counter(
                    "raft_tpu_serve_journal_replayed_total",
                    "journal replay outcomes of SweepService.recover"
                    ).inc(float(n), outcome=outcome)
        if self._journal is not None:
            self._journal.record_recover(info)
        self._emit("journal_recovered", mirror=is_mirror, **info)
        _LOG.info("serve: journal recovery%s — %d result(s) restored, "
                  "%d request(s) re-admitted, %d deduped, %d corrupt "
                  "line(s) skipped",
                  " (from mirror)" if is_mirror else "", recovered,
                  replayed, deduped, state["corrupt"])
        return {**info, "ckpt_records": ckpt_records,
                "mirror": is_mirror, "tickets": tickets}

    def drain(self, successor: str = None, timeout: float = 30.0) -> dict:
        """Gracefully hand the service off: stop admitting (callers get
        429/``AdmissionRejected`` with ``successor`` in the context and
        Retry-After pointing at the handoff), flush in-flight batches
        for up to ``timeout`` seconds, journal whatever could not
        finish as handoff-pending (their live tickets resolve as typed
        ``DeadlineExceeded`` failures with ``handoff=True`` — the WAL
        keeps them *pending* so the successor re-solves them), and
        write the ``handoff.json`` manifest naming the exec-cache keys
        a successor warm-starts from.  Returns the handoff manifest."""
        obs = self._obs()
        with self._cond:
            already = self._state in ("draining", "stopped")
            self._successor = successor or self._successor
            if not already:
                self._state = "draining"
                self._cond.notify_all()
        self._emit("drain_begin", successor=successor)
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                idle = (not self._queue and not self._inflight
                        and self._ngathered == 0)
            if idle:
                break
            time.sleep(0.02)
        with self._cond:
            leftovers = list(self._queue)
            self._queue.clear()
            for b in self._inflight.values():
                leftovers.extend(r for r in b["reqs"]
                                 if not r.ticket.done())
            self._cond.notify_all()
        pending = sorted({r.seq for r in leftovers})
        for r in leftovers:
            if not r.ticket.done():
                self._fail(r, errors.DeadlineExceeded(
                    "request handed off to successor", req=r.seq,
                    handoff=True, successor=successor), journal=False)
        exec_keys = self._tenants.exec_keys()
        doc = {"schema": "raft_tpu.serve.handoff/v1",
               "t": time.time(),
               "run_id": (self._manifest.run_id
                          if self._manifest is not None else None),
               "pending": pending,
               "next_seq": self._seq,
               "successor": successor,
               "exec_keys": exec_keys,
               "tenants": self._tenants.names(),
               "config": self.cfg.scalars()}
        if self._journal is not None:
            self._journal.record_handoff(pending, exec_keys, self._seq,
                                         successor)
            wal.write_handoff_manifest(self.cfg.journal_dir, doc)
        self._handoff_info = {"pending": len(pending),
                              "successor": successor,
                              "exec_keys": len(exec_keys)}
        obs.counter("raft_tpu_serve_handoffs_total",
                    "graceful drain/handoff completions").inc(1.0)
        self._emit("handoff", pending=len(pending), successor=successor,
                   exec_keys=list(exec_keys))
        _LOG.info("serve: drained — %d request(s) handed off pending, "
                  "%d warm exec-cache key(s) named for the successor",
                  len(pending), len(exec_keys))
        # teardown (worker join, watchdog stop, manifest -> trend
        # store); the queue is already flushed so the bound is short
        self.stop(drain=False, timeout=5.0)
        return doc

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _estimate_wait_locked(self) -> float:
        depth = len(self._queue) + sum(
            len(b["reqs"]) for b in self._inflight.values())
        batches_ahead = -(-max(1, depth) // self.cfg.batch_cases)
        per_batch = self._ema_batch_s if self._ema_batch_s is not None \
            else 1.0
        return batches_ahead * per_batch + self.cfg.window_s

    def submit(self, Hs: float, Tp: float, heading_rad: float,
               deadline_s: float = None,
               tenant: str = DEFAULT_TENANT, trace=None,
               exact: bool = False) -> Ticket:
        """Admit one case request; returns its :class:`Ticket`.

        Raises :class:`~raft_tpu_torch.errors.AdmissionRejected` (with a
        ``retry_after_s`` hint, plus a ``successor`` pointer while
        draining for a handoff) when the queue watermark, deadline
        pressure, the ``reject`` degradation mode, or shutdown forbids
        admission; an unknown ``tenant`` is a typed
        :class:`~raft_tpu_torch.errors.ModelConfigError`.  With a journal
        configured the admission is written to the WAL *before* the
        ticket is returned — an accepted request survives a crash.

        With the result tier configured (``cfg.store_dir``) admission
        consults the content-addressed read path first: an exact
        request-digest hit returns an already-resolved ticket at memory
        speed — it never enters the batch window, the queue accounting,
        or the WAL (the caller holds the payload synchronously, so
        there is nothing a crash could lose) — and a duplicate of a
        request already in flight attaches to that single solve as a
        *follower* instead of occupying a queue slot (a storm of N
        duplicates over D distinct digests performs exactly D
        solves).

        ``trace``: the caller's distributed trace context — an
        ``X-Raft-Trace`` header string, a :class:`TraceContext`, or a
        serialized context dict; anything missing/malformed mints a
        fresh root.  The context rides the request through the WAL,
        batch membership, and the delivered result's
        ``provenance["trace"]``.

        ``exact`` is accepted for the JAX package's signature: it
        bypasses the learned read tier there, which the port does not
        have yet (ROADMAP A10), so it changes nothing here."""
        obs = self._obs()
        tenant = self._tenants.require(tenant)
        ctx = _coerce_trace(trace)
        now = time.monotonic()
        deadline_s = float(deadline_s if deadline_s is not None
                           else self.cfg.deadline_s)
        if self._store is not None:
            rdigest = wal.request_digest(Hs, Tp, heading_rad, tenant)
            hit = self._lookup_cached(rdigest)
            if hit is not None:
                hit = dataclasses.replace(hit, extra={
                    **(hit.extra or {}),
                    "provenance": {
                        **((hit.extra or {}).get("provenance") or {}),
                        "trace": ctx.as_dict()}})
                t = Ticket(hit.request_id, hit.seq, trace=ctx)
                t._finish(hit)
                return t
        follower = None
        with self._cond:
            retry_after = self._estimate_wait_locked()
            successor = self._successor
            reason = None
            if self._state in ("draining", "stopped"):
                reason = "stopped"
            elif self._store is not None:
                # single-flight: whatever the queue pressure, a
                # duplicate of an in-flight digest rides that solve —
                # it costs no queue slot and no solver work, so even
                # the reject rung admits it
                prim = self._flight.get(rdigest)
                if prim is not None and not prim.ticket.done():
                    seq = self._seq
                    self._seq += 1
                    follower = _Request(seq, Hs, Tp, heading_rad,
                                        now + deadline_s, now,
                                        tenant=tenant, rdigest=rdigest,
                                        trace=ctx)
                    # track BEFORE the attach is visible: the primary's
                    # fan-out may deliver (and untrack) the follower
                    # the instant it appears in prim.followers — a
                    # track after that window would pin the delivered
                    # seq in _open for the life of the process
                    self._track_open(follower)
                    prim.followers.append(follower)
                    self._counts["admitted"] += 1
                    self._counts["coalesced"] += 1
            if follower is None and reason is None:
                if self.ladder[self._mode_idx] == "reject":
                    reason = "degraded"
                    retry_after = max(retry_after,
                                      self.cfg.reject_hold_s)
                elif len(self._queue) >= self.cfg.queue_max:
                    reason = "queue_full"
                elif retry_after > deadline_s * self.cfg.deadline_pressure:
                    reason = "deadline_pressure"
            if reason is not None:
                self._counts["rejected"] += 1
                depth = len(self._queue)
            elif follower is None:
                seq = self._seq
                self._seq += 1
                req = _Request(seq, Hs, Tp, heading_rad,
                               now + deadline_s, now, tenant=tenant,
                               rdigest=(rdigest
                                        if self._store is not None
                                        else None), trace=ctx)
                self._queue.append(req)
                if self._store is not None:
                    self._flight[req.rdigest] = req
                self._counts["admitted"] += 1
                depth = len(self._queue)
                self._cond.notify_all()
        if follower is not None:
            # WAL-before-ack applies to followers too: the attached
            # duplicate is journaled as its own admission, and its
            # delivery (or failure) will be journaled terminal — replay
            # after a crash re-resolves it by digest, never re-solves
            if self._journal is not None:
                self._journal.record_admit(
                    follower.seq, follower.id, follower.rdigest,
                    follower.Hs, follower.Tp, follower.beta, deadline_s,
                    tenant, trace=follower.trace.as_dict())
            follower.t_admitted = time.monotonic()
            self._tenants.count(tenant, "admitted")
            obs.counter("raft_tpu_serve_coalesced_total",
                        "duplicate submissions single-flighted onto an "
                        "in-flight solve").inc(1.0)
            obs.counter("raft_tpu_serve_requests_total",
                        "request admissions/outcomes of the sweep "
                        "service").inc(1.0, outcome="admitted")
            self._emit("coalesced", req=follower.seq,
                       rdigest=follower.rdigest)
            return follower.ticket
        obs.gauge("raft_tpu_serve_queue_depth",
                  "requests queued (not in flight) in the sweep "
                  "service").set(float(depth))
        if reason is not None:
            self._tenants.count(tenant, "rejected")
            obs.counter(
                "raft_tpu_serve_admission_rejects_total",
                "requests shed at admission, by reason").inc(
                    1.0, reason=reason)
            self._emit("admission_reject", reason=reason,
                       retry_after_s=retry_after, queue_depth=depth)
            ctx = {"reason": reason, "queue_depth": depth}
            if reason == "stopped" and successor:
                # the load-shed hint names who IS serving: a draining
                # process points its callers at the successor
                ctx["successor"] = successor
            raise errors.AdmissionRejected(
                f"admission rejected ({reason})",
                retry_after_s=retry_after, **ctx)
        # WAL before ack: the journal line hits disk before the caller
        # holds a ticket, so an accepted request can never be lost
        self._track_open(req)
        if self._journal is not None:
            self._journal.record_admit(
                req.seq, req.id, req.rdigest, req.Hs, req.Tp, req.beta,
                deadline_s, tenant, trace=req.trace.as_dict())
        req.t_admitted = time.monotonic()
        self._tenants.count(tenant, "admitted")
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome="admitted")
        return req.ticket

    # ------------------------------------------------------------------
    # optimize tenant: batched design descents as journaled requests
    # ------------------------------------------------------------------

    def submit_optimize(self, spec: dict, deadline_s: float = None,
                        tenant: str = DEFAULT_TENANT,
                        trace=None) -> Ticket:
        """Admit one design-optimization request; returns its
        :class:`Ticket` whose :class:`SweepResult` carries the
        digest-addressed optimized design with full provenance
        (iterations, final gradient norm, objective trace) in
        ``result.extra``.

        ``spec`` is the JSON request body: ``{"bounds": {design_var:
        [lo, hi]}, "objective": {...}, "nlanes", "steps", "method",
        "lr", "gtol", "seed", "nIter", "tol"}`` — validated and
        canonicalized (typed :class:`~raft_tpu_torch.errors.ModelConfigError`
        on junk, with ``cfg.optimize_lanes_max``/``optimize_steps_max``
        as resource guards).  Requests are content-addressed over the
        canonical spec + tenant: a repeat of an already-delivered
        optimization resolves from the result index without
        re-descending, and a duplicate of one in flight attaches to it
        single-flight.  With a journal configured the admission is
        WAL-journaled (admit record carrying the spec) BEFORE the
        ticket returns, and the terminal record carries the optimized
        design — replay after a crash re-delivers completed
        optimizations and re-runs accepted-unfinished ones."""
        from raft_tpu_torch.parallel import optimize as optmod

        obs = self._obs()
        tenant = self._tenants.require(tenant)
        ctx = _coerce_trace(trace)
        spec = optmod.normalize_request(
            spec, lanes_max=self.cfg.optimize_lanes_max,
            steps_max=self.cfg.optimize_steps_max)
        rdigest = wal.optimize_digest(spec, tenant)
        now = time.monotonic()
        deadline_s = float(deadline_s if deadline_s is not None
                           else self.cfg.deadline_s)
        follower = None
        dedup = None
        with self._cond:
            # the load-shed hint must reflect THIS queue's cadence: a
            # descent runs minutes, not a batch window — estimate from
            # the optimize backlog and the observed descent EMA (the
            # first-ever descent has no EMA; a conservative 60 s beats
            # telling callers to hammer a compiling service)
            retry_after = max(
                self._estimate_wait_locked(),
                (len(self._opt_queue) + (1 if self._opt_busy else 0))
                * float(self._opt_ema_s or 60.0))
            reason = None
            if self._state in ("draining", "stopped"):
                reason = "stopped"
            else:
                prior_digest = self._rdigest_index.get(rdigest)
                prior = (self._delivered.get(prior_digest)
                         if prior_digest else None)
                if prior is not None and prior.ok:
                    seq = self._seq
                    self._seq += 1
                    dedup = dataclasses.replace(
                        prior, request_id=f"opt{seq}-{uuid.uuid4().hex[:8]}",
                        seq=seq, attempts=0, latency_s=0.0,
                        source="deduped", extra={
                            **(prior.extra or {}),
                            "provenance": {
                                **((prior.extra or {}).get("provenance")
                                   or {}),
                                "trace": ctx.as_dict()}})
                else:
                    prim = self._flight.get(rdigest)
                    if prim is not None and not prim.ticket.done():
                        seq = self._seq
                        self._seq += 1
                        follower = _Request(seq, 0.0, 1.0, 0.0,
                                            now + deadline_s, now,
                                            tenant=tenant,
                                            rdigest=rdigest, opt=spec,
                                            trace=ctx)
                        self._track_open(follower)
                        prim.followers.append(follower)
                        self._counts["admitted"] += 1
                        self._counts["coalesced"] += 1
            if dedup is None and follower is None and reason is None:
                if self.ladder[self._mode_idx] == "reject":
                    reason = "degraded"
                    retry_after = max(retry_after,
                                      self.cfg.reject_hold_s)
                elif len(self._opt_queue) >= self.cfg.queue_max:
                    reason = "queue_full"
            if reason is not None:
                self._counts["rejected"] += 1
            elif dedup is None and follower is None:
                seq = self._seq
                self._seq += 1
                req = _Request(seq, 0.0, 1.0, 0.0, now + deadline_s,
                               now, tenant=tenant, rdigest=rdigest,
                               opt=spec, trace=ctx)
                # track BEFORE the request becomes poppable: an
                # already-running opt worker may terminate it the
                # instant it appears on the queue, and untrack-then-
                # track would pin the seq in _open for the process
                # lifetime (same ordering contract as the follower
                # attach above)
                self._track_open(req)
                self._opt_queue.append(req)
                self._flight[rdigest] = req
                self._counts["admitted"] += 1
                self._cond.notify_all()
        if reason is not None:
            self._tenants.count(tenant, "rejected")
            obs.counter(
                "raft_tpu_serve_admission_rejects_total",
                "requests shed at admission, by reason").inc(
                    1.0, reason=reason)
            self._emit("admission_reject", reason=reason,
                       retry_after_s=retry_after, optimize=True)
            raise errors.AdmissionRejected(
                f"admission rejected ({reason})",
                retry_after_s=retry_after, reason=reason,
                optimize=True)
        obs.counter(
            "raft_tpu_serve_optimize_requests_total",
            "optimize-tenant request admissions/outcomes").inc(
                1.0, outcome="deduped" if dedup is not None
                else "admitted")
        if dedup is not None:
            # the caller holds the payload synchronously — like a
            # result-store hit, nothing a crash could lose, so the
            # dedupe is deliberately not journaled
            t = Ticket(dedup.request_id, dedup.seq, trace=ctx)
            t._finish(dedup)
            return t
        r = follower if follower is not None else req
        # WAL before ack, spec on the admit record: an accepted
        # optimization survives a crash and replays as submitted
        if self._journal is not None:
            self._journal.record_admit(r.seq, r.id, r.rdigest, r.Hs,
                                       r.Tp, r.beta, deadline_s, tenant,
                                       opt=spec,
                                       trace=r.trace.as_dict())
        r.t_admitted = time.monotonic()
        if follower is not None:
            self._emit("coalesced", req=r.seq, rdigest=r.rdigest,
                       optimize=True)
        else:
            self._ensure_opt_worker()
        self._tenants.count(tenant, "admitted")
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome="admitted")
        return r.ticket

    def submit_farm(self, spec: dict, deadline_s: float = None,
                    tenant: str = DEFAULT_TENANT,
                    trace=None) -> Ticket:
        """Admit one farm request — N turbines x M cases solved as ONE
        batch of lanes on the device
        (:func:`raft_tpu_torch.parallel.sweep.make_farm_runner`) — returning
        its :class:`Ticket` whose :class:`SweepResult` carries the
        per-turbine motion statistics, waked wind field, and wake
        fixed-point provenance in ``result.extra``.

        ``spec`` is the JSON request body: ``{"layout": [[x, y], ...],
        "Hs": [...], "Tp": [...], "beta": [...], "U_inf": [...],
        "wind_dir": [...], "k_w": 0.05}`` — validated and canonicalized
        (typed :class:`~raft_tpu_torch.errors.ModelConfigError` on junk, with
        ``cfg.farm_turbines_max``/``farm_cases_max`` as resource
        guards).  Requests are content-addressed over the canonical
        spec + tenant — the digest is salted with the LAYOUT, so two
        farms with identical sea states but different turbine positions
        never dedupe onto each other.  Farm solves ride the long-request
        lane (the optimize queue): their runner is built once per
        (layout, case-count) and they outlast a batch window.
        With a journal configured the admission is WAL-journaled (admit
        record carrying the spec) BEFORE the ticket returns — replay
        after a crash re-delivers completed farms and re-runs
        accepted-unfinished ones."""
        from raft_tpu_torch.parallel import sweep as sweepmod

        obs = self._obs()
        tenant = self._tenants.require(tenant)
        ctx = _coerce_trace(trace)
        norm = sweepmod.normalize_farm_request(
            spec, turbines_max=self.cfg.farm_turbines_max,
            cases_max=self.cfg.farm_cases_max)
        # the canonical spec is plain JSON (lists, floats): the WAL
        # admit record and the content digest both see the SAME bytes
        # a replay reconstructs — numpy arrays never reach the journal
        spec = {"layout": norm["layout"].tolist(),
                "Hs": norm["Hs"].tolist(), "Tp": norm["Tp"].tolist(),
                "beta": norm["beta"].tolist(),
                "U_inf": norm["U_inf"].tolist(),
                "wind_dir": norm["wind_dir"].tolist(),
                "k_w": float(norm["k_w"]),
                "n_turbines": int(norm["n_turbines"]),
                "ncases": int(norm["ncases"])}
        rdigest = wal.farm_digest(spec, tenant)
        now = time.monotonic()
        deadline_s = float(deadline_s if deadline_s is not None
                           else self.cfg.deadline_s)
        follower = None
        dedup = None
        with self._cond:
            # same load-shed cadence as optimize: the farm rides the
            # long-request queue, so the hint folds its backlog and EMA
            retry_after = max(
                self._estimate_wait_locked(),
                (len(self._opt_queue) + (1 if self._opt_busy else 0))
                * float(self._opt_ema_s or 60.0))
            reason = None
            if self._state in ("draining", "stopped"):
                reason = "stopped"
            else:
                prior_digest = self._rdigest_index.get(rdigest)
                prior = (self._delivered.get(prior_digest)
                         if prior_digest else None)
                if prior is not None and prior.ok:
                    seq = self._seq
                    self._seq += 1
                    dedup = dataclasses.replace(
                        prior,
                        request_id=f"farm{seq}-{uuid.uuid4().hex[:8]}",
                        seq=seq, attempts=0, latency_s=0.0,
                        source="deduped", extra={
                            **(prior.extra or {}),
                            "provenance": {
                                **((prior.extra or {}).get("provenance")
                                   or {}),
                                "trace": ctx.as_dict()}})
                else:
                    prim = self._flight.get(rdigest)
                    if prim is not None and not prim.ticket.done():
                        seq = self._seq
                        self._seq += 1
                        follower = _Request(seq, 0.0, 1.0, 0.0,
                                            now + deadline_s, now,
                                            tenant=tenant,
                                            rdigest=rdigest, farm=spec,
                                            trace=ctx)
                        self._track_open(follower)
                        prim.followers.append(follower)
                        self._counts["admitted"] += 1
                        self._counts["coalesced"] += 1
            if dedup is None and follower is None and reason is None:
                if self.ladder[self._mode_idx] == "reject":
                    reason = "degraded"
                    retry_after = max(retry_after,
                                      self.cfg.reject_hold_s)
                elif len(self._opt_queue) >= self.cfg.queue_max:
                    reason = "queue_full"
            if reason is not None:
                self._counts["rejected"] += 1
            elif dedup is None and follower is None:
                seq = self._seq
                self._seq += 1
                req = _Request(seq, 0.0, 1.0, 0.0, now + deadline_s,
                               now, tenant=tenant, rdigest=rdigest,
                               farm=spec, trace=ctx)
                # track BEFORE the request becomes poppable (same
                # ordering contract as submit_optimize)
                self._track_open(req)
                self._opt_queue.append(req)
                self._flight[rdigest] = req
                self._counts["admitted"] += 1
                self._cond.notify_all()
        if reason is not None:
            self._tenants.count(tenant, "rejected")
            obs.counter(
                "raft_tpu_serve_admission_rejects_total",
                "requests shed at admission, by reason").inc(
                    1.0, reason=reason)
            self._emit("admission_reject", reason=reason,
                       retry_after_s=retry_after, farm=True)
            raise errors.AdmissionRejected(
                f"admission rejected ({reason})",
                retry_after_s=retry_after, reason=reason,
                optimize=True)
        obs.counter(
            "raft_tpu_serve_farm_requests_total",
            "farm-tenant request admissions/outcomes").inc(
                1.0, outcome="deduped" if dedup is not None
                else "admitted")
        if dedup is not None:
            # synchronous payload — like a result-store hit, nothing a
            # crash could lose, so the dedupe is not journaled
            t = Ticket(dedup.request_id, dedup.seq, trace=ctx)
            t._finish(dedup)
            return t
        r = follower if follower is not None else req
        # WAL before ack, spec on the admit record: an accepted farm
        # survives a crash and replays as submitted
        if self._journal is not None:
            self._journal.record_admit(r.seq, r.id, r.rdigest, r.Hs,
                                       r.Tp, r.beta, deadline_s, tenant,
                                       farm=spec,
                                       trace=r.trace.as_dict())
        r.t_admitted = time.monotonic()
        if follower is not None:
            self._emit("coalesced", req=r.seq, rdigest=r.rdigest,
                       farm=True)
        else:
            self._ensure_opt_worker()
        self._tenants.count(tenant, "admitted")
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome="admitted")
        return r.ticket

    def _ensure_opt_worker(self):
        with self._lock:
            if self._opt_worker is not None \
                    and self._opt_worker.is_alive():
                return
            t = threading.Thread(target=self._opt_worker_loop,
                                 name="raft-serve-optimize",
                                 daemon=True)
            self._opt_worker = t
        t.start()

    def _opt_worker_loop(self):
        with self._device_scope():
            self._opt_worker_loop_body()

    def _opt_worker_loop_body(self):
        while True:
            with self._cond:
                while not self._opt_queue and self._state != "stopped":
                    self._cond.wait(0.25)
                if not self._opt_queue:
                    return                       # stopped and drained
                r = self._opt_queue.popleft()
                r.t_gathered = time.monotonic()
                self._opt_busy = True
            try:
                # the long-request lane carries both tenants: design
                # optimizations and farm solves (each with a heavy build,
                # each outlasting a batch window)
                if r.farm is not None:
                    self._run_farm(r)
                else:
                    self._run_optimize(r)
            except errors.RaftError as e:
                self._fail(r, e)
            # the worker seam mirrors the sweep worker's config-
            # sanctioned contract: a bug becomes a typed result +
            # counted unhandled, never a dead service
            except BaseException as e:  # raftlint: disable=RTL004
                _LOG.error("optimize worker: unhandled %s",
                           type(e).__name__, exc_info=True)
                with self._lock:
                    self._counts["unhandled"] += 1
                self._fail(r, errors.KernelFailure(
                    f"unhandled optimize failure: "
                    f"{type(e).__name__}: {e}", req=r.seq))
            finally:
                with self._cond:
                    self._opt_busy = False
                    self._cond.notify_all()

    def _run_optimize(self, r: _Request):
        """One journaled design optimization end to end."""
        from raft_tpu_torch.parallel import optimize as optmod

        if r.deadline_ts < time.monotonic():
            with self._lock:
                self._counts["deadline_misses"] += 1
            self._fail(r, errors.DeadlineExceeded(
                "optimize request expired before its descent started",
                req=r.seq))
            return
        spec = r.opt
        fowt = self._tenants.fowts(r.tenant).get("full")
        if fowt is None:
            self._fail(r, errors.ModelConfigError(
                "optimize tenant has no full-mode model",
                tenant=r.tenant))
            return
        space = optmod.DesignSpace(
            fowt, {k: tuple(v) for k, v in spec["bounds"].items()})
        # -- preemption tolerance: segment the descent and persist its
        # carry every checkpoint_every steps, keyed by the request's
        # content address — recover() re-runs an accepted-unfinished
        # optimization through here, and the store's newest valid
        # checkpoint resumes it instead of step 0.  A shed checkpoint
        # tier (ENOSPC) keeps the chunking (bitwise-identical numerics
        # either way) but stops persisting until the hold lapses.
        ckpt_kw = {}
        if self.cfg.checkpoint_every:
            ckpt_kw["checkpoint_every"] = int(self.cfg.checkpoint_every)
            if self._ckpt is not None:
                # the store is ALWAYS passed: resuming persisted
                # progress is a read and must survive the shed hold —
                # only the write path is suppressed while shed
                ckpt_kw["ckpt_store"] = self._ckpt
                ckpt_kw["ckpt_key"] = r.rdigest
                if self._shed_active("checkpoint"):
                    ckpt_kw["ckpt_resume_only"] = True
                elif self._journal is not None:
                    journal = self._journal

                    def _on_ckpt(step, cdigest, _r=r):
                        journal.record_ckpt(_r.seq, _r.rdigest, step,
                                            cdigest,
                                            trace=_r.trace.as_dict())
                    ckpt_kw["on_checkpoint"] = _on_ckpt
        r.t_solve0 = time.monotonic()
        with self._obs().span("serve_optimize", req=r.seq,
                              nlanes=spec["nlanes"],
                              trace_id=r.trace.trace_id,
                              span_id=r.trace.span_id,
                              parent_id=r.trace.parent_id):
            out = optmod.optimize_designs(
                fowt, space, objective=spec["objective"],
                nlanes=spec["nlanes"], steps=spec["steps"],
                method=spec["method"], lr=spec["lr"],
                gtol=spec["gtol"], seed=spec["seed"],
                nIter=spec["nIter"], tol=spec["tol"], **ckpt_kw)
        r.t_solved = time.monotonic()
        best = int(out["lane_best"])
        prov = dict(out["provenance"])
        if prov.get("ckpt_shed"):
            self._shed("checkpoint", errors.StorageExhausted(
                "checkpoint tier shed mid-descent",
                component="checkpoint", req=r.seq),
                trace_id=r.trace.trace_id)
        resumed = int(prov.get("resumed_from_step") or 0)
        if resumed:
            with self._lock:
                self._counts["ckpt_resumed"] += 1
                self._last_resumed_step = resumed
            self._emit("ckpt_resumed", req=r.seq, step=resumed,
                       steps=spec["steps"],
                       trace_id=r.trace.trace_id)
            _LOG.info("serve: optimize req %d resumed from checkpoint "
                      "step %d/%d", r.seq, resumed, spec["steps"])
        wall = float(prov.get("wall_s") or 0.0)
        if wall > 0.0:
            with self._lock:
                self._opt_ema_s = (wall if self._opt_ema_s is None
                                   else 0.7 * self._opt_ema_s
                                   + 0.3 * wall)
        prov["objective_trace"] = [
            float(v) for v in out["obj_trace"][:, best]]
        payload = {"design": out["design"],
                   "x_best": [float(v) for v in out["x_best"]],
                   "f_best": float(out["f_best"]),
                   "provenance": prov}
        self._complete_optimize(r, payload)

    def _complete_optimize(self, r: _Request, payload: dict):
        """Deliver + journal one optimize result (the optimize twin of
        ``_complete``): digest-addressed over the optimized design,
        WAL-terminal before the ticket resolves, indexed for dedupe and
        cross-replica re-resolution, fanned out to single-flight
        followers."""
        obs = self._obs()
        # the shared recipe (journal.optimize_result_digest): the
        # preempt-soak verdict compares a resumed run's digest to an
        # uninterrupted clean run's through the same function
        digest = wal.optimize_result_digest(
            payload["design"], payload["f_best"],
            payload["provenance"]["iterations"])
        prov = payload["provenance"]
        # after the digest: the trace block must not perturb the
        # resumed-vs-clean digest equality the preempt soak asserts
        prov["trace"] = r.trace.as_dict()
        res = SweepResult(
            ok=True, digest=digest, std=[float(payload["f_best"])],
            iters=int(prov["iterations"]),
            converged=bool(prov["converged"] > 0), extra=payload,
            source="replayed" if r.replayed else "solved",
            **self._result_base(r, "optimize"))
        if self._journal is not None:
            self._journal.record_complete(
                r.seq, r.rdigest, digest, "optimize",
                r.total_attempts, res.std, res.iters, res.converged,
                extra=payload, trace=r.trace.as_dict())
        with self._lock:
            self._counts["completed"] += 1
            self._latencies.append(res.latency_s)
            self._delivered[digest] = res
            self._rdigest_index[r.rdigest] = digest
            while len(self._delivered) > self.cfg.result_cache:
                self._delivered.popitem(last=False)
            while len(self._rdigest_index) > self.cfg.result_cache:
                self._rdigest_index.popitem(last=False)
            self._replayed_pending.discard(r.seq)
        self._untrack_open(r.seq)
        self._tenants.count(r.tenant, "completed")
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome="ok")
        obs.counter(
            "raft_tpu_serve_optimize_requests_total",
            "optimize-tenant request admissions/outcomes").inc(
                1.0, outcome="ok")
        self._emit("request_done", req=r.seq, digest=digest,
                   latency_s=res.latency_s, mode="optimize",
                   attempts=r.total_attempts,
                   f_best=payload["f_best"],
                   trace_id=r.trace.trace_id)
        r.ticket._finish(res)
        if r.t_admitted:
            self._observe_phase("admission",
                                r.t_admitted - r.submitted_ts)
            if r.t_gathered:
                self._observe_phase("queue_wait",
                                    r.t_gathered - r.t_admitted)
        if r.t_solve0 and r.t_solved:
            self._observe_phase("solve", r.t_solved - r.t_solve0)
            self._observe_phase("delivery",
                                time.monotonic() - r.t_solved)
        self._fanout_complete(r, res)

    def _run_farm(self, r: _Request):
        """One journaled farm solve end to end (the farm twin of
        :meth:`_run_optimize`): warm (layout, case-count)-keyed runner
        from the tenant registry, one N-turbines x M-cases batch,
        per-turbine results + wake provenance delivered."""
        from raft_tpu_torch.parallel import sweep as sweepmod

        if r.deadline_ts < time.monotonic():
            with self._lock:
                self._counts["deadline_misses"] += 1
            self._fail(r, errors.DeadlineExceeded(
                "farm request expired before its solve started",
                req=r.seq))
            return
        spec = r.farm
        base = self._tenants.fowts(r.tenant).get("full")
        if base is None:
            self._fail(r, errors.ModelConfigError(
                "farm tenant has no full-mode model", tenant=r.tenant))
            return
        xy = np.asarray(spec["layout"], float)
        nt = int(spec["n_turbines"])
        nc = int(spec["ncases"])
        from raft_tpu_torch.parallel import exec_cache
        ldig = exec_cache.layout_digest(xy)

        def build(_fowt, kw):
            # farm is a MODE of the tenant, not a degraded sibling: the
            # registry has no "farm:..." fowt, so the program is built
            # over the tenant's full-physics model — one warm runner
            # per (layout digest, case count, wake k_w), LRU-evicted
            # like any other mode's program.  k_w is fixed into the
            # wake when the runner is built, so it is part of the key
            solver_kw = {k: v for k, v in kw.items()
                         if k in ("nIter", "tol", "fp_chunk")}
            return sweepmod.make_farm_runner(
                base, xy, nc, mesh=self.cfg.mesh, device=self.device,
                k_w=k_w, **solver_kw)

        k_w = float(spec["k_w"])
        runner = self._tenants.runner(
            r.tenant, f"farm:{ldig[:8]}x{nc}k{k_w!r}", build)
        # the warm program's case axis may be padded up to the mesh
        # batch multiple — pad by repeating the last case, strip after
        pad = int(runner.ncases) - nc
        arrs = [np.asarray(spec[k], float)
                for k in ("Hs", "Tp", "beta", "U_inf", "wind_dir")]
        if pad:
            arrs = [np.concatenate([a, np.repeat(a[-1:], pad)])
                    for a in arrs]
        r.t_solve0 = time.monotonic()
        with self._obs().span("serve_farm", req=r.seq, n_turbines=nt,
                              ncases=nc,
                              trace_id=r.trace.trace_id,
                              span_id=r.trace.span_id,
                              parent_id=r.trace.parent_id):
            out = runner(*arrs)
            shaped = sweepmod._farm_reshape(out, nt, nc)
            # ONE counted host pull of the farm's results
            std, iters, conv, U_wake, power, wake_iters = \
                self._obs().transfers.device_get(
                    tuple(shaped[k] for k in (
                        "std", "iters", "converged", "U_wake",
                        "aero_power", "wake_iters")),
                    what="serve_farm", phase="serve")
            std = np.asarray(std)                    # (nt, nc, 6)
            iters = np.asarray(iters)
            conv = np.asarray(conv)
            U_wake = np.asarray(U_wake)              # (nt, nc)
            power = np.asarray(power)
            wake_iters = np.asarray(wake_iters)
        r.t_solved = time.monotonic()
        payload = {
            "std": std.tolist(),
            "std_norm": float(np.linalg.norm(std)),
            "iters": int(np.max(iters)),
            "converged": bool(np.all(conv)),
            "U_wake": U_wake.tolist(),
            "aero_power": power.tolist(),
            "wake_iters": [int(v) for v in wake_iters],
            "n_turbines": nt, "ncases": nc,
            "layout_digest": ldig,
            "provenance": {
                "cache_state": str(runner.cache_state),
                "build_s": float(runner.build_s),
                "k_w": float(spec["k_w"])}}
        self._complete_farm(r, payload)

    def _complete_farm(self, r: _Request, payload: dict):
        """Deliver + journal one farm result (the farm twin of
        ``_complete_optimize``): digest-addressed over the per-turbine
        response statistics + wake provenance, WAL-terminal before the
        ticket resolves, indexed for dedupe, fanned out to
        single-flight followers."""
        obs = self._obs()
        digest = wal.farm_result_digest(
            payload["std_norm"], payload["n_turbines"],
            payload["ncases"], max(payload["wake_iters"]))
        # after the digest: the trace block must not perturb the
        # replayed-vs-clean digest equality recovery asserts
        payload["provenance"]["trace"] = r.trace.as_dict()
        res = SweepResult(
            ok=True, digest=digest, std=[float(payload["std_norm"])],
            iters=int(payload["iters"]),
            converged=bool(payload["converged"]), extra=payload,
            source="replayed" if r.replayed else "solved",
            **self._result_base(r, "farm"))
        if self._journal is not None:
            self._journal.record_complete(
                r.seq, r.rdigest, digest, "farm",
                r.total_attempts, res.std, res.iters, res.converged,
                extra=payload, trace=r.trace.as_dict())
        with self._lock:
            self._counts["completed"] += 1
            self._latencies.append(res.latency_s)
            self._delivered[digest] = res
            self._rdigest_index[r.rdigest] = digest
            while len(self._delivered) > self.cfg.result_cache:
                self._delivered.popitem(last=False)
            while len(self._rdigest_index) > self.cfg.result_cache:
                self._rdigest_index.popitem(last=False)
            self._replayed_pending.discard(r.seq)
        self._untrack_open(r.seq)
        self._tenants.count(r.tenant, "completed")
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome="ok")
        obs.counter(
            "raft_tpu_serve_farm_requests_total",
            "farm-tenant request admissions/outcomes").inc(
                1.0, outcome="ok")
        self._emit("request_done", req=r.seq, digest=digest,
                   latency_s=res.latency_s, mode="farm",
                   attempts=r.total_attempts,
                   n_turbines=payload["n_turbines"],
                   trace_id=r.trace.trace_id)
        r.ticket._finish(res)
        if r.t_admitted:
            self._observe_phase("admission",
                                r.t_admitted - r.submitted_ts)
            if r.t_gathered:
                self._observe_phase("queue_wait",
                                    r.t_gathered - r.t_admitted)
        if r.t_solve0 and r.t_solved:
            self._observe_phase("solve", r.t_solved - r.t_solve0)
            self._observe_phase("delivery",
                                time.monotonic() - r.t_solved)
        self._fanout_complete(r, res)

    # ------------------------------------------------------------------
    # storage-shed ladder (ENOSPC / disk budget; serve/checkpoint.py)
    # ------------------------------------------------------------------

    def _shed_active(self, component: str) -> bool:
        """True while ``component``'s storage shed holds; a lapsed hold
        self-clears (the next write re-probes the disk)."""
        with self._lock:
            until = self._storage_shed.get(component)
            if until is None:
                return False
            if time.monotonic() < until:
                return True
            del self._storage_shed[component]
        self._emit("storage_recovered", component=component)
        _LOG.info("serve: storage shed of %s lapsed — re-probing",
                  component)
        return False

    def _shed(self, component: str, e: BaseException,
              trace_id: str = None):
        """Fold one typed :class:`~raft_tpu_torch.errors.StorageExhausted`
        into the storage ladder: shed ``component`` for the configured
        hold (checkpointing sheds first, then the result-store
        write-through; the WAL and the serving loop never shed)."""
        obs = self._obs()
        hold = float(self.cfg.storage_shed_hold_s)
        with self._lock:
            self._storage_shed[component] = time.monotonic() + hold
            self._counts["ckpt_shed" if component == "checkpoint"
                         else "store_shed"] += 1
        obs.counter(
            "raft_tpu_serve_storage_shed_total",
            "persistence rungs shed on proven resource exhaustion "
            "(ENOSPC / disk budget), by component").inc(
                1.0, component=component)
        fields = {"component": component, "hold_s": hold,
                  "error": str(e)[:200]}
        if trace_id:
            fields["trace_id"] = trace_id
        self._emit("storage_degraded", **fields)
        _LOG.warning("serve: storage exhausted at %s — shedding for "
                     "%.1fs (%s)", component, hold, e)

    def _store_put(self, payload: dict, xi=None):
        """Result-store write-through under the shed ladder: an ENOSPC
        put sheds THIS rung (typed, counted, held, self-clearing) —
        the result still delivers from memory and the WAL."""
        if self._store is None or self._shed_active("resultstore"):
            return
        try:
            self._store.put(payload, xi=xi)
        except errors.StorageExhausted as e:
            self._shed("resultstore", e)

    # ------------------------------------------------------------------
    # worker: gather -> solve -> split
    # ------------------------------------------------------------------

    def _pop_ready_locked(self, now: float, solo_ok: bool = True,
                          tenant: str = None):
        for i, r in enumerate(self._queue):
            if r.not_before <= now and (solo_ok or not r.solo) \
                    and (tenant is None or r.tenant == tenant):
                del self._queue[i]
                return r
        return None

    def _device_scope(self):
        """The service's card as this thread's current device (a no-op
        on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _worker_loop(self, gen: int):
        with self._device_scope():
            self._worker_loop_body(gen)

    def _worker_loop_body(self, gen: int):
        while True:
            batch = self._gather(gen)
            if batch is None:
                return
            try:
                self._run_batch(batch, gen)
            # the serve worker is the service's keep-alive seam
            # (config-sanctioned for RTL004): any escape here would
            # kill the loop, so unexpected failures are counted,
            # logged, and turned into typed results
            except Exception:
                _LOG.exception("serve: unhandled batch failure")
                with self._lock:
                    self._counts["unhandled"] += 1
                for r in batch:
                    if not r.ticket.done():
                        self._fail(r, errors.KernelFailure(
                            "unhandled service error", unhandled=True))

    def _gather(self, gen: int) -> list[_Request] | None:
        """Block until a batch is ready (None = this worker retires)."""
        first = None
        with self._cond:
            while True:
                if self._gen != gen or self._state == "stopped":
                    return None
                now = time.monotonic()
                first = self._pop_ready_locked(now)
                if first is not None:
                    first.t_gathered = now
                    self._ngathered += 1
                    break
                if self._state == "draining" and not self._queue \
                        and not self._inflight:
                    return None
                # idle: a held reject mode probes back up once the
                # backlog is gone and the hold elapsed
                if not self._queue \
                        and self.ladder[self._mode_idx] == "reject" \
                        and now - self._mode_entered \
                        >= self.cfg.reject_hold_s:
                    self._step_mode_locked(-1, reason="reject_hold")
                self._cond.wait(0.02)
        if first.deadline_ts < time.monotonic():
            self._ungather(1)
            self._expire(first)
            return []                   # empty batch: loop again
        batch = [first]
        if not first.solo and self.cfg.batch_cases > 1:
            window_end = time.monotonic() + self.cfg.window_s
            while len(batch) < self.cfg.batch_cases:
                now = time.monotonic()
                with self._cond:
                    # batches never mix tenants: one warm program, one
                    # model, one device execution
                    r = self._pop_ready_locked(now, solo_ok=False,
                                               tenant=first.tenant)
                    if r is not None:
                        r.t_gathered = now
                        self._ngathered += 1
                    elif now >= window_end:
                        break
                    else:
                        self._cond.wait(min(0.01, window_end - now))
                        continue
                if r.deadline_ts < time.monotonic():
                    self._ungather(1)
                    self._expire(r)
                    continue
                batch.append(r)
        return batch

    def _ungather(self, n: int):
        with self._lock:
            self._ngathered = max(0, self._ngathered - n)

    def _ensure_runner(self, mode: str, tenant: str = DEFAULT_TENANT):
        rmode = self._tenants.resolve_mode(tenant, mode)
        built = [False]

        def build(fowt, tenant_kw):
            built[0] = True
            kw = {**self.cfg.solver_kw(), **tenant_kw}
            if self._runner_factory is not None:
                return self._runner_factory(rmode, fowt,
                                            self.cfg.batch_cases, **kw)
            if fowt is None:
                raise errors.ModelConfigError(
                    "no model available for service mode", mode=rmode,
                    tenant=tenant)
            from raft_tpu_torch.parallel.sweep import make_batch_runner
            return make_batch_runner(fowt, self.cfg.batch_cases,
                                     mesh=self.cfg.mesh,
                                     device=self.device, **kw)

        runner = self._tenants.runner(tenant, rmode, build)
        # phase-breakdown exemplar: did THIS acquisition pay a build
        # (the model's constants, the warm-up batch) or reuse the live
        # runner?  Only the batch worker that just called reads it.
        self._runner_was_cold = built[0]
        return runner

    def _solve_mode_locked(self) -> str:
        mode = self.ladder[self._mode_idx]
        if mode != "reject":
            return mode
        # reject mode still drains the backlog at the deepest solve rung
        return self.ladder[max(0, self._mode_idx - 1)]

    def _run_batch(self, batch: list[_Request], gen: int):
        if not batch:
            return
        obs = self._obs()
        from raft_tpu_torch.testing import faults

        cfg = self.cfg
        tenant = batch[0].tenant
        t0 = time.monotonic()
        with self._lock:
            solve_mode = self._solve_mode_locked()
            batch_id = self._batch_seq
            self._batch_seq += 1
            binfo = {"reqs": batch, "abandoned": False, "done": False}
            self._inflight[batch_id] = binfo
            # the gathered requests are now visible as in-flight state
            self._ngathered = max(0, self._ngathered - len(batch))
        if self._journal is not None:
            self._journal.record_batch(batch_id,
                                       [r.seq for r in batch],
                                       solve_mode, tenant,
                                       traces=[r.trace.as_dict()
                                               for r in batch])
        # phase breakdown: queue wait (admit -> gathered) and batch
        # fill (gathered -> dispatch) per member, from the lock-free
        # monotonic stamps submit/_gather left on the request
        for r in batch:
            adm = r.t_admitted or r.submitted_ts
            if r.t_gathered:
                self._observe_phase("queue_wait", r.t_gathered - adm)
                self._observe_phase("batch_fill", t0 - r.t_gathered)
        wid = None
        try:
            t_build = time.monotonic()
            runner = self._ensure_runner(solve_mode, tenant)
            self._observe_phase(
                "compile_cold" if self._runner_was_cold
                else "compile_warm", time.monotonic() - t_build)
            # the watchdog deadline covers the SOLVE: a cold runner
            # build (the constants and the warm-up batch) above may
            # legitimately take longer than batch_deadline_s and must
            # not pre-expire the batch it is about to serve.  A
            # warm-start batch may legitimately run TWO solves (every
            # warm_audit_every-th batch is audited, and a guard
            # fallback re-solves cold) — the window must cover both,
            # or every healthy audited batch would be abandoned and
            # accrue hang strikes toward quarantine
            window = cfg.batch_deadline_s
            if (self._store is not None and cfg.warm_start
                    and getattr(runner, "warm_start", False)):
                window *= 2.0
            wid = self._watchdog.arm(
                time.monotonic() + window,
                lambda: self._abandon_batch(batch_id))
            # -- injection seam (pre-solve): a hang stalls THIS worker
            # with the watchdog armed — exactly what a wedged device
            # looks like from the host; a kill IS the crash mid-batch
            # the write-ahead journal exists for
            for r in batch:
                f = faults.fire_info("serve", req=r.seq)
                if f is not None:
                    if f["action"] == "kill":
                        _LOG.warning("serve: injected kill at req %d "
                                     "(os._exit)", r.seq)
                        os._exit(137)
                    elif f["action"] == "hang":
                        time.sleep(float(f.get("hang_s", 30.0)))
                    elif f["action"] == "raise":
                        raise errors.KernelFailure(
                            "injected serve failure", injected=True,
                            req=r.seq)
            n = len(batch)
            Hs = np.array([r.Hs for r in batch], float)
            Tp = np.array([r.Tp for r in batch], float)
            beta = np.array([r.beta for r in batch], float)
            ncases = getattr(runner, "ncases", cfg.batch_cases)
            if n < ncases:               # pad by repeating the last lane
                pad = ncases - n
                Hs = np.concatenate([Hs, np.repeat(Hs[-1:], pad)])
                Tp = np.concatenate([Tp, np.repeat(Tp[-1:], pad)])
                beta = np.concatenate([beta, np.repeat(beta[-1:], pad)])
            # the watchdog stays armed through the whole solve phase —
            # warm attempt, guard fallback, and audit reference alike
            t_solve0 = time.monotonic()
            for r in batch:
                r.t_solve0 = t_solve0
            self._last_health = None
            with obs.span("serve_batch", n=n, mode=solve_mode,
                          batch_id=batch_id,
                          trace_ids=",".join(r.trace.trace_id
                                             for r in batch)) as bsp:
                # every pull of the solve (the fixed point's chunk
                # checks, the one summary pull) counts in phase "serve"
                with obs.transfers.phase("serve"):
                    std, iters, conv, xi = self._solve_lanes(
                        runner, batch, batch_id, Hs, Tp, beta, n,
                        ncases, solve_mode)
                # health mode: per-lane arrays from the delivered
                # solve's pull (the LAST pull _solve_lanes made)
                health = self._last_health
                hsum = None
                if health is not None:
                    from raft_tpu_torch.parallel.sweep import _health_summary
                    hsum = _health_summary(
                        "serve", health["health_residual"],
                        health.get("health_cond",
                                   np.zeros(0, float)),
                        np.isfinite(np.asarray(std, float)
                                    ).all(axis=-1),
                        iters)
                    bsp.set(health_residual_max=hsum[
                                "residual_rel_max"],
                            health_nonfinite=hsum["nonfinite_lanes"])
            t_solved = time.monotonic()
            for r in batch:
                r.t_solved = t_solved
            owned = self._watchdog.disarm(wid)
            wid = None
            if not owned:
                # watchdog won the race: it (has or will) pop the batch
                # and re-admit/quarantine the members — this (stale)
                # worker discards its late results and retires
                return
            with self._lock:
                binfo["done"] = True
                self._inflight.pop(batch_id, None)
            # -- injection seam (post-solve, per lane): the dynamics /
            # sweep-lane fault sites poison or fail single requests
            for i, r in enumerate(batch):
                if r.ticket.done():
                    # already resolved out-of-band (a drain handed it
                    # off while this solve ran): discard the late
                    # result — the WAL keeps it pending for the
                    # successor, and the delivered ticket must never
                    # flip state
                    continue
                action = (faults.fire("dynamics", case=r.seq)
                          or faults.fire("sweep", lane=r.seq))
                if action == "nan":
                    std[i] = np.nan
                elif action == "raise":
                    self._retry_or_fail(r, errors.DynamicsSingular(
                        "injected lane failure", injected=True,
                        case=r.seq))
                    std[i] = np.nan
                    continue
                if np.all(np.isfinite(std[i])):
                    hrow = None
                    if health is not None and i < len(
                            health["health_residual"]):
                        res_i = float(health["health_residual"][i])
                        cond_i = (float(health["health_cond"][i])
                                  if "health_cond" in health else None)
                        hrow = {
                            "residual_rel": (res_i if np.isfinite(res_i)
                                             else None),
                            "cond": (cond_i if cond_i is not None
                                     and np.isfinite(cond_i) else None),
                            "batch_residual_rel_max":
                                hsum["residual_rel_max"],
                            "batch_nonfinite_lanes":
                                hsum["nonfinite_lanes"]}
                    self._complete(r, std[i], int(iters[i]),
                                   bool(conv[i]), solve_mode,
                                   xi_row=(xi[i] if xi is not None
                                           else None),
                                   health=hrow)
                else:
                    self._retry_or_fail(r, errors.NonFiniteResult(
                        "non-finite response lane", case=r.seq))
            batch_s = time.monotonic() - t0
            with self._lock:
                self._counts["batches"] += 1
                self._ema_batch_s = (batch_s if self._ema_batch_s is None
                                     else 0.8 * self._ema_batch_s
                                     + 0.2 * batch_s)
            obs.counter("raft_tpu_serve_batches_total",
                        "batches solved by the sweep service, by mode"
                        ).inc(1.0, mode=solve_mode)
            # a WAL mirror behind its lag budget is an SLO violation
            # too: a failover right now could lose the lagging tail, so
            # the ladder sheds load until replication catches up
            self._fold_health(batch_s > cfg.latency_slo_s
                              or self._replica_degraded())
        except errors.RaftError as e:
            owned = True
            if wid is not None:
                owned = self._watchdog.disarm(wid)
            if not owned:
                # the watchdog already abandoned this batch and owns its
                # requests (re-admitted solo / quarantined) — a second
                # requeue here would double-solve them
                return
            with self._lock:
                binfo["done"] = True
                self._inflight.pop(batch_id, None)
            for r in batch:
                if not r.ticket.done():
                    self._retry_or_fail(r, e)
            self._fold_health(True)
        except Exception:
            # non-taxonomy escape (a bug): release the in-flight slot
            # and the armed deadline BEFORE the keep-alive seam in
            # _worker_loop turns it into typed results — otherwise the
            # dead batch inflates _estimate_wait_locked forever and a
            # later watchdog expiry re-queues already-finished tickets
            owned = True
            if wid is not None:
                owned = self._watchdog.disarm(wid)
            with self._lock:
                binfo["done"] = True
                if owned:
                    self._inflight.pop(batch_id, None)
            if not owned:
                _LOG.exception("serve: stale worker error after "
                               "watchdog abandon (discarded)")
                return
            raise

    # ------------------------------------------------------------------
    # the solve phase: neighbor warm starts + divergence guard + audit
    # ------------------------------------------------------------------

    def _pull(self, out, n: int, with_xi: bool):
        """The sanctioned counted host pull of one batch's outputs
        (one pull per solve; an audited warm batch
        performs two solves and therefore two pulls).  When the runner
        was built in health mode its output dict carries the per-lane
        solver-health arrays — they ride the SAME pull (no extra
        transfer) and land on ``self._last_health`` for the batch
        worker that just called (the ``_runner_was_cold`` pattern)."""
        obs = self._obs()
        hkeys = [k for k in ("health_residual", "health_cond")
                 if k in out]
        extras = tuple(out[k] for k in hkeys)
        if with_xi:
            pulled = obs.transfers.device_get(
                (out["std"], out["iters"], out["converged"], out["Xi"])
                + extras,
                what="serve_batch", phase="serve")
            std, iters, conv, xi = pulled[:4]
            rest = pulled[4:]
            xi = np.asarray(xi)[:n]
        else:
            pulled = obs.transfers.device_get(
                (out["std"], out["iters"], out["converged"]) + extras,
                what="serve_batch", phase="serve")
            std, iters, conv = pulled[:3]
            rest = pulled[3:]
            xi = None
        self._last_health = ({k: np.asarray(v)[:n]
                              for k, v in zip(hkeys, rest)}
                             if hkeys else None)
        return (np.array(std, float)[:n], np.asarray(iters)[:n],
                np.asarray(conv)[:n], xi)

    def _gather_seeds(self, batch, ncases: int, nw: int,
                      xistart: float):
        """Per-lane drag-fixed-point seeds from the nearest cold-solved
        store neighbors: ``(seeds, {lane: neighbor rdigest})`` —
        unseeded lanes carry the cold ``XiStart`` fill, so the seeded
        program with no neighbors is numerically the cold program."""
        seeds = np.full((ncases, 6, nw), complex(xistart), complex)
        lanes: dict[int, str] = {}
        for i, r in enumerate(batch):
            found = self._store.nearest(r.Hs, r.Tp, r.beta, r.tenant,
                                        radius=self.cfg.warm_radius)
            if found is None:
                continue
            rd, _dist = found
            seed = self._store.get_xi(rd)
            if seed is None or seed.shape != (6, nw):
                continue
            seeds[i] = seed
            lanes[i] = rd
        return (seeds if lanes else None), lanes

    def _warm_event(self, outcome: str, lane: int, neighbor: str,
                    detail: str, trace_id: str = None):
        """Count + record one divergence-guard rejection (or audit
        mismatch) as the typed :class:`~raft_tpu_torch.errors.WarmStartRejected`
        signal — the fallback result is delivered regardless."""
        obs = self._obs()
        e = errors.WarmStartRejected(
            "warm-started solve rejected by the divergence guard",
            lane=lane, neighbor=neighbor, outcome=outcome,
            detail=detail)
        obs.counter("raft_tpu_serve_warm_starts_total",
                    "warm-start seeding outcomes of the serving loop"
                    ).inc(1.0, outcome=outcome)
        ctx = e.context()
        if trace_id:
            ctx["trace_id"] = trace_id   # exemplar: alert -> full trace
        self._emit("warm_start_rejected", **ctx)
        _LOG.warning("serve: %s", e)

    def _solve_lanes(self, runner, batch, batch_id: int, Hs, Tp, beta,
                     n: int, ncases: int, solve_mode: str):
        """Solve one gathered batch, warm-starting misses when the
        result tier is configured for it.  Returns the delivered
        ``(std, iters, conv, xi)`` host arrays (``xi`` only for
        cold-solved lanes — seeds always trace to unseeded solves).

        Guard ladder (``docs/robustness.md``): (1) a seeded lane that
        failed to converge or went non-finite is a
        ``WarmStartRejected`` — its neighbor seed is quarantined and
        the whole batch re-solves cold (no digest deviation possible);
        (2) every ``warm_audit_every``-th seeded batch is *audited*:
        solved both ways, the cold results delivered, and any seeded
        lane whose warm response deviates past the solver tolerance is
        a counted ``warm_start_digest_mismatch`` + quarantine — the
        tripwire that a poisoned seed changed physics; (3) accepted
        non-audited warm lanes deliver the seeded solution (converged
        under the same tolerance a cold start faces) and report
        iteration savings against the cold baseline EMA."""
        obs = self._obs()
        cfg = self.cfg
        # the port's runner always takes Xi0 (``.warm_start`` True); a
        # stub engine without the attribute is never seeded
        warm_on = (self._store is not None and cfg.warm_start
                   and getattr(runner, "warm_start", False))
        if not warm_on:
            return self._pull(runner(Hs, Tp, beta), n, with_xi=False)
        nw = int(getattr(runner, "nw", 0))
        seeds, seed_lanes = self._gather_seeds(
            batch, ncases, nw, getattr(runner, "xistart", 0.1))
        if not seed_lanes:
            # no neighbors yet: a cold solve that BOOTSTRAPS the seed
            # pool (xi rows ride the one pull and land in the store)
            pulled = self._pull(runner(Hs, Tp, beta), n, with_xi=True)
            self._fold_cold_iters(pulled[1])
            return pulled
        audit = (batch_id % cfg.warm_audit_every) == 0
        with self._lock:
            self._counts["warm_seeded"] += len(seed_lanes)
        obs.counter("raft_tpu_serve_warm_starts_total",
                    "warm-start seeding outcomes of the serving loop"
                    ).inc(float(len(seed_lanes)), outcome="seeded")
        std_w, iters_w, conv_w, _ = self._pull(
            runner(Hs, Tp, beta, seeds), n, with_xi=False)
        bad = [i for i in seed_lanes
               if i < n and not (bool(conv_w[i])
                                 and np.all(np.isfinite(std_w[i])))]
        if not (audit or bad):
            # accepted: the seeded solution converged under the cold
            # tolerance; savings measured against the cold-iters EMA.
            # No xi capture — warm results never become seeds.
            ema = self._cold_iters_ema
            if ema is not None:
                saving = sum(max(0.0, ema - float(iters_w[i]))
                             for i in seed_lanes if i < n)
                with self._lock:
                    self._warm_iter_savings += saving
            return std_w, iters_w, conv_w, None
        # guard fallback / audit reference: one cold solve, delivered
        std, iters, conv, xi = self._pull(runner(Hs, Tp, beta), n,
                                          with_xi=True)
        for i in bad:
            self._store.quarantine(seed_lanes[i])
            with self._lock:
                self._counts["warm_rejected"] += 1
            self._warm_event(
                "rejected", i, seed_lanes[i],
                "seeded lane non-converged/non-finite; cold fallback",
                trace_id=(batch[i].trace.trace_id if i < n else None))
        if audit:
            tol = float(cfg.tol)
            for i, rd in sorted(seed_lanes.items()):
                if i in bad or i >= n:
                    continue
                rel = np.abs(std_w[i] - std[i]) / (np.abs(std[i]) + tol)
                if np.any(rel > tol):
                    # the warm solve CLAIMED convergence but landed on
                    # different physics — the poisoned-seed signature
                    self._store.quarantine(rd)
                    with self._lock:
                        self._counts["warm_mismatch"] += 1
                    self._warm_event(
                        "mismatch", i, rd,
                        f"audit deviation {float(np.max(rel)):.3e} > "
                        f"{tol:g}",
                        trace_id=batch[i].trace.trace_id)
                else:
                    with self._lock:
                        self._warm_iter_savings += max(
                            0.0, float(iters[i]) - float(iters_w[i]))
        # cold delivery refreshes the cold-iteration baseline
        self._fold_cold_iters(iters, exclude=())
        return std, iters, conv, xi

    def _fold_cold_iters(self, iters, exclude=()):
        with self._lock:
            for i, v in enumerate(iters):
                if i in exclude:
                    continue
                v = float(v)
                self._cold_iters_ema = (
                    v if self._cold_iters_ema is None
                    else 0.8 * self._cold_iters_ema + 0.2 * v)

    # ------------------------------------------------------------------
    # watchdog abandon path
    # ------------------------------------------------------------------

    def _abandon_batch(self, batch_id: int):
        obs = self._obs()
        with self._lock:
            binfo = self._inflight.pop(batch_id, None)
            if binfo is None or binfo["done"]:
                return
            binfo["abandoned"] = True
            reqs = list(binfo["reqs"])
            self._counts["abandoned_batches"] += 1
            self._counts["deadline_misses"] += len(reqs)
        obs.counter("raft_tpu_serve_deadline_misses_total",
                    "requests whose batch overran the watchdog deadline"
                    ).inc(float(len(reqs)))
        self._emit("watchdog_abandon", batch_id=batch_id,
                   reqs=[r.seq for r in reqs],
                   trace_ids=[r.trace.trace_id for r in reqs])
        _LOG.warning("serve: watchdog abandoned batch %d (%d requests); "
                     "spawning replacement worker", batch_id, len(reqs))
        # the stuck worker still owns a (possibly wedged) solve — a
        # fresh worker takes over the queue, the old one retires when
        # (if) its call returns and it sees the generation moved on
        self._spawn_worker()
        for r in reqs:
            r.strikes += 1
            if r.strikes >= self.cfg.hang_quarantine_after:
                self._fail(r, errors.DeadlineExceeded(
                    "batch abandoned by watchdog", req=r.seq,
                    strikes=r.strikes), quarantined=True)
            else:
                r.solo = True            # isolate: offenders self-select
                self._requeue(r, front=True)
        self._fold_health(True)

    # ------------------------------------------------------------------
    # per-request outcomes
    # ------------------------------------------------------------------

    def _requeue(self, r: _Request, front: bool = False):
        with self._cond:
            if front:
                self._queue.appendleft(r)
            else:
                self._queue.append(r)
            self._cond.notify_all()

    def _retry_or_fail(self, r: _Request, e: BaseException):
        obs = self._obs()
        key = self.retry.classify(e)
        n = r.attempts.get(key, 0)
        now = time.monotonic()
        if self.retry.should_retry(e, n) and now < r.deadline_ts:
            # keyed on the admission seq, not r.id (which embeds a
            # uuid): two runs of the same soak schedule the same delays
            backoff = self.retry.backoff_s(f"req{r.seq}",
                                           r.total_attempts)
            r.attempts[key] = n + 1
            r.total_attempts += 1
            r.not_before = now + backoff
            with self._lock:
                self._counts["retries"] += 1
            obs.counter("raft_tpu_serve_retries_total",
                        "request retries by error class").inc(
                            1.0, error=key)
            self._emit("retry", req=r.seq, error=key, attempt=n + 1,
                       backoff_s=backoff)
            self._requeue(r)
        else:
            self._fail(r, e)

    def _expire(self, r: _Request):
        with self._lock:
            self._counts["deadline_misses"] += 1
            self._counts["expired"] += 1
        self._obs().counter(
            "raft_tpu_serve_deadline_misses_total",
            "requests whose batch overran the watchdog deadline").inc(1.0)
        self._fail(r, errors.DeadlineExceeded(
            "deadline expired in queue", req=r.seq))

    def _result_base(self, r: _Request, mode: str) -> dict:
        return {"request_id": r.id, "seq": r.seq, "mode": mode,
                "attempts": r.total_attempts, "tenant": r.tenant,
                "latency_s": time.monotonic() - r.submitted_ts}

    def _complete(self, r: _Request, std_row, iters: int,
                  converged: bool, mode: str, xi_row=None,
                  health: dict = None):
        obs = self._obs()
        from raft_tpu_torch.ledger import digest_metrics
        digest = digest_metrics({"std": std_row, "iters": int(iters),
                                 "converged": bool(converged)})
        # per-lane solver-health facts (health mode only) ride the
        # served result's provenance — NOT its digest: the digest
        # identifies the physics, health describes how it was solved
        prov = {"trace": r.trace.as_dict()}
        if health is not None:
            prov["solve_health"] = dict(health)
        res = SweepResult(ok=True, digest=digest,
                          std=[float(v) for v in std_row],
                          iters=int(iters), converged=bool(converged),
                          source="replayed" if r.replayed else "solved",
                          extra={"provenance": prov},
                          **self._result_base(r, mode))
        # WAL before ack: the result (digest + payload) is durable
        # before the ticket resolves — a crash after this line loses
        # nothing, a crash before it re-solves deterministically.
        # The trace ctx rides its own WAL field, not ``extra``.
        if self._journal is not None:
            self._journal.record_complete(
                r.seq, r.rdigest, digest, mode, r.total_attempts,
                res.std, res.iters, res.converged,
                trace=r.trace.as_dict())
        # result tier: persist the payload under the request's content
        # address (fsync'd + sidecar'd; a put failure is a counted gap,
        # never a lost delivery — memory and the WAL still have it).
        # ``xi_row`` carries the warm-start seed only for COLD-solved
        # lanes, so every seed in the store traces to an unseeded solve.
        # FULL-rung results only: a no_qtf/coarse solve is a legitimate
        # delivery to ITS caller under degradation pressure, but it must
        # never become the canonical cached answer every future repeat
        # (on every replica, forever) short-circuits to
        if self._store is not None and mode == "full":
            t_put = time.monotonic()
            self._store_put({"rdigest": r.rdigest, "digest": digest,
                             "std": res.std, "iters": res.iters,
                             "converged": res.converged,
                             "tenant": r.tenant, "Hs": r.Hs, "Tp": r.Tp,
                             "beta": r.beta, "mode": mode, "id": r.id,
                             "seq": r.seq}, xi=xi_row)
            self._observe_phase("store_write",
                                time.monotonic() - t_put)
        with self._lock:
            self._counts["completed"] += 1
            if r.total_attempts:
                self._counts["retried_recovered"] += 1
            self._latencies.append(res.latency_s)
            self._delivered[digest] = res
            self._rdigest_index[r.rdigest] = digest
            while len(self._delivered) > self.cfg.result_cache:
                self._delivered.popitem(last=False)
            while len(self._rdigest_index) > self.cfg.result_cache:
                self._rdigest_index.popitem(last=False)
            self._replayed_pending.discard(r.seq)
        self._untrack_open(r.seq)
        self._tenants.count(r.tenant, "completed")
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome="ok")
        obs.histogram("raft_tpu_serve_request_latency_s",
                      "submit-to-result latency of completed requests",
                      buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                               30.0, 60.0, 120.0)).observe(res.latency_s)
        self._emit("request_done", req=r.seq, digest=digest,
                   latency_s=res.latency_s, attempts=r.total_attempts,
                   mode=mode, trace_id=r.trace.trace_id)
        r.ticket._finish(res)
        if r.t_admitted:
            self._observe_phase("admission",
                                r.t_admitted - r.submitted_ts)
        if r.t_solve0 and r.t_solved:
            self._observe_phase("solve", r.t_solved - r.t_solve0)
            self._observe_phase("delivery",
                                time.monotonic() - r.t_solved)
        self._fanout_complete(r, res)

    def _fanout_complete(self, r: _Request, res: SweepResult):
        """Deliver a primary's result to its single-flight followers:
        each gets the identical payload under its own identity,
        journaled terminal (replay stays idempotent), unless its OWN
        deadline lapsed while the shared solve ran — per-follower
        deadlines hold even inside a coalesced flight."""
        obs = self._obs()
        with self._lock:
            if self._flight.get(r.rdigest) is r:
                del self._flight[r.rdigest]
            followers, r.followers = r.followers, []
        now = time.monotonic()
        for f in followers:
            if f.ticket.done():
                continue
            if f.deadline_ts < now:
                self._fail(f, errors.DeadlineExceeded(
                    "coalesced solve finished past this follower's "
                    "deadline", req=f.seq, coalesced=True))
                continue
            fextra = dict(res.extra) if res.extra else {}
            fextra["provenance"] = {
                **(fextra.get("provenance") or {}),
                "trace": f.trace.as_dict()}
            fres = dataclasses.replace(
                res, request_id=f.id, seq=f.seq,
                latency_s=now - f.submitted_ts, attempts=0,
                source="coalesced", extra=fextra)
            if self._journal is not None:
                self._journal.record_complete(
                    f.seq, f.rdigest, res.digest, res.mode, 0, res.std,
                    res.iters, res.converged, extra=res.extra,
                    trace=f.trace.as_dict())
            with self._lock:
                self._counts["completed"] += 1
                self._latencies.append(fres.latency_s)
                # a recovery-coalesced follower is a REPLAYED request:
                # its delivery must clear the no-silent-drop gate
                # exactly like a primary's does
                self._replayed_pending.discard(f.seq)
            self._untrack_open(f.seq)
            self._tenants.count(f.tenant, "completed")
            obs.counter("raft_tpu_serve_requests_total",
                        "request admissions/outcomes of the sweep "
                        "service").inc(1.0, outcome="ok")
            self._emit("request_done", req=f.seq, digest=res.digest,
                       latency_s=fres.latency_s, attempts=0,
                       mode=res.mode, coalesced=True,
                       trace_id=f.trace.trace_id)
            f.ticket._finish(fres)

    def _fail(self, r: _Request, e: BaseException,
              quarantined: bool = False, journal: bool = True):
        obs = self._obs()
        ctx = (e.context() if isinstance(e, errors.RaftError)
               else {"error": type(e).__name__, "message": str(e)})
        res = SweepResult(ok=False, quarantined=quarantined, error=ctx,
                          **self._result_base(
                              r, self.ladder[self._mode_idx]))
        # ``journal=False`` is the handoff path: the request must STAY
        # pending in the WAL so the successor re-solves it
        if journal and self._journal is not None:
            self._journal.record_fail(r.seq, r.rdigest, ctx, quarantined,
                                      trace=r.trace.as_dict())
        with self._lock:
            self._counts["failed"] += 1
            if quarantined:
                self._counts["quarantined"] += 1
            self._replayed_pending.discard(r.seq)
        if journal:
            # the handoff path (journal=False) keeps the request OPEN:
            # it must stay in rotation checkpoints until the journal
            # closes, exactly like it stays pending in the WAL
            self._untrack_open(r.seq)
        self._tenants.count(r.tenant, "failed")
        outcome = "quarantined" if quarantined else "failed"
        obs.counter("raft_tpu_serve_requests_total",
                    "request admissions/outcomes of the sweep service"
                    ).inc(1.0, outcome=outcome)
        self._emit("quarantine" if quarantined else "request_failed",
                   **{**ctx, "phase": "serve", "req": r.seq,
                      "trace_id": r.trace.trace_id})
        r.ticket._finish(res)
        # single-flight: a primary's terminal failure fans out to its
        # followers with the same typed error (the handoff path's
        # ``journal=False`` rides along — followers stay pending in the
        # WAL for the successor exactly like their primary)
        with self._lock:
            if self._flight.get(r.rdigest) is r:
                del self._flight[r.rdigest]
            followers, r.followers = r.followers, []
        for f in followers:
            if not f.ticket.done():
                self._fail(f, e, quarantined=quarantined,
                           journal=journal)

    # ------------------------------------------------------------------
    # degradation ladder
    # ------------------------------------------------------------------

    def _fold_health(self, violation: bool):
        with self._lock:
            if violation:
                self._bad_streak += 1
                self._good_streak = 0
                if self._bad_streak >= self.cfg.degrade_after \
                        and self._mode_idx < len(self.ladder) - 1:
                    self._step_mode_locked(+1, reason="slo_violation")
            else:
                self._good_streak += 1
                self._bad_streak = 0
                if self._good_streak >= self.cfg.upgrade_after \
                        and self._mode_idx > 0:
                    self._step_mode_locked(-1, reason="healthy")

    def _step_mode_locked(self, delta: int, reason: str):
        obs = self._obs()
        src = self.ladder[self._mode_idx]
        self._mode_idx = min(len(self.ladder) - 1,
                             max(0, self._mode_idx + delta))
        dst = self.ladder[self._mode_idx]
        if dst == src:
            return
        self._mode_entered = time.monotonic()
        self._bad_streak = 0
        self._good_streak = 0
        rec = {"t": time.time(), "from": src, "to": dst,
               "reason": reason}
        self._transitions.append(rec)
        obs.counter("raft_tpu_serve_mode_transitions_total",
                    "service degradation-ladder transitions").inc(
                        1.0, **{"from": src, "to": dst})
        obs.gauge("raft_tpu_serve_mode",
                  "active service mode as its ladder index "
                  "(0 = full; see the mode label)").set(
                      float(self._mode_idx), mode=dst)
        self._emit("service_mode", **rec)
        log = _LOG.warning if delta > 0 else _LOG.info
        log("serve: mode %s -> %s (%s)", src, dst, reason)

    # ------------------------------------------------------------------
    # introspection / delivery
    # ------------------------------------------------------------------

    @property
    def mode(self) -> str:
        with self._lock:
            return self.ladder[self._mode_idx]

    def fetch(self, digest: str) -> SweepResult | None:
        """Completed result by its ledger digest (async delivery);
        falls through to the result store after the in-memory LRU
        evicts."""
        with self._lock:
            res = self._delivered.get(digest)
        if res is None and self._store is not None:
            doc = self._store.get_by_digest(digest)
            if doc is not None:
                res = self._result_from_store(doc)
        return res

    @staticmethod
    def _result_from_store(doc: dict) -> SweepResult:
        return SweepResult(
            ok=True, request_id=str(doc.get("id") or "stored"),
            seq=int(doc.get("seq", -1)), mode=str(doc.get("mode",
                                                          "full")),
            attempts=0, latency_s=0.0, digest=doc.get("digest"),
            std=[float(v) for v in doc["std"]], iters=int(doc["iters"]),
            converged=bool(doc["converged"]),
            tenant=str(doc.get("tenant", DEFAULT_TENANT)),
            source="stored")

    def _lookup_cached(self, rdigest: str) -> SweepResult | None:
        """The read-through tier: in-memory LRU first, then the
        persistent store — a hit is counted, its latency sampled, and
        the result returned already terminal (memory speed: no queue,
        no batch window, no WAL)."""
        obs = self._obs()
        t0 = time.perf_counter()
        with self._lock:
            digest = self._rdigest_index.get(rdigest)
            res = self._delivered.get(digest) if digest else None
        # full-rung answers only: a result solved under ladder
        # degradation (a replay-dedupe index entry, or a store written
        # by an older/foreign service) must not short-circuit future
        # full-mode admissions with degraded physics
        if res is not None and res.mode != "full":
            res = None
        source = "memory"
        if res is None:
            doc = self._store.get(rdigest)
            if doc is None or doc.get("mode", "full") != "full":
                return None
            res = self._result_from_store(doc)
            source = "store"
        elapsed = time.perf_counter() - t0
        res = dataclasses.replace(res, latency_s=elapsed,
                                  source="cached")
        with self._lock:
            self._counts["store_hits"] += 1
            self._read_ms.append(elapsed * 1e3)
        self._tenants.count(res.tenant, "completed")
        obs.counter(
            "raft_tpu_serve_result_store_reads_total",
            "read-through-tier hits at admission, by serving tier"
            ).inc(1.0, source=source)
        obs.histogram(
            "raft_tpu_serve_store_read_s",
            "read-through-tier hit latency (admission to payload)",
            buckets=(1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5)
            ).observe(elapsed)
        return res

    def fetch_rdigest(self, rdigest: str) -> SweepResult | None:
        """Completed result by its REQUEST digest (the content address
        of the submitted physics) — how a router re-resolves an
        in-flight fetch against a successor after the replica that held
        the original ticket died: the successor knows the request from
        the replayed WAL even though it never issued the ticket.

        Read ladder: the in-memory index first; after the bounded LRU
        has evicted, the persistent result store; last, the write-ahead
        journal itself (a full scan — the journal keeps terminal
        records the LRU has long forgotten)."""
        with self._lock:
            digest = self._rdigest_index.get(rdigest)
            res = self._delivered.get(digest) if digest else None
        if res is not None:
            return res
        if self._store is not None:
            doc = self._store.get(rdigest)
            if doc is not None:
                return self._result_from_store(doc)
        if self.cfg.journal_dir:
            rec = wal.find_rdigest(self.cfg.journal_dir, rdigest)
            if rec is not None and rec.get("digest"):
                return SweepResult(
                    ok=True,
                    request_id=str(rec.get("id")
                                   or f"req{rec.get('seq', -1)}"),
                    seq=int(rec.get("seq", -1)),
                    mode=str(rec.get("mode", "full")),
                    attempts=int(rec.get("attempts", 0)), latency_s=0.0,
                    digest=rec.get("digest"), std=rec.get("std"),
                    iters=rec.get("iters"),
                    converged=rec.get("converged"), source="recovered")
        return None

    def _replica_degraded(self) -> bool:
        mirror = self._journal.mirror if self._journal is not None \
            else None
        return mirror is not None and mirror.lag_exceeded

    def stats(self) -> dict:
        with self._lock:
            out = {**self._counts, "queue_depth": len(self._queue),
                   "mode": self.ladder[self._mode_idx],
                   "state": self._state}
        if self._journal is not None and self._journal.mirror is not None:
            out["replica_lag_exceeded"] = self._replica_degraded()
        return out

    @staticmethod
    def _percentile(values, q: float) -> float | None:
        """Nearest-rank percentile (None on no data): the rule of the
        JAX package's ``obs.trendstore``, whose port is ROADMAP A8's, so
        a copy of it here."""
        if not values:
            return None
        vs = sorted(values)
        k = max(0, min(len(vs) - 1, math.ceil(q / 100.0 * len(vs)) - 1))
        return vs[k]

    def summary(self) -> dict:
        """Flat serve facts (manifest ``extra["serve"]`` -> trend row)."""
        tenancy = self._tenants.facts()
        with self._lock:
            counts = dict(self._counts)
            lat = list(self._latencies)
            transitions = list(self._transitions)
            mode = self.ladder[self._mode_idx]
            ema = self._ema_batch_s
            recover_info = (dict(self._recover_info)
                            if self._recover_info else None)
            handoff_info = (dict(self._handoff_info)
                            if self._handoff_info else None)
            replayed_open = len(self._replayed_pending)
            read_ms = list(self._read_ms)
            warm_savings = self._warm_iter_savings
            last_resumed = self._last_resumed_step
            phase_s = {p: list(d) for p, d in self._phase_s.items()
                       if d}
        runners = {}
        for name, t in tenancy["tenants"].items():
            for live in t.get("live", []):
                runners[f"{name}/{live['mode']}"] = live["cache"]
        out = {
            **counts,
            "requests": counts["admitted"] + counts["rejected"],
            "mode": mode,
            "mode_transitions": transitions,
            "n_mode_transitions": len(transitions),
            "p50_latency_s": self._percentile(lat, 50),
            "p99_latency_s": self._percentile(lat, 99),
            # per-phase breakdown facts (phase_<name>_p50_s/_p99_s) —
            # the trend-store columns `obsctl slo` and the fleet
            # controller gate on
            **{f"phase_{p}_p{q}_s": self._percentile(v, q)
               for p, v in sorted(phase_s.items()) for q in (50, 99)},
            "ema_batch_s": ema,
            "exec_cache": runners,
            "tenancy": tenancy,
            "tenant_evictions": tenancy["evictions"],
            "tenant_rewarms": tenancy["rewarms"],
        }
        if self._store is not None:
            # result-tier facts (serve/resultstore.py): hit ratio over
            # every request that COULD have hit (hits + admissions),
            # read-path latency percentiles, single-flight coalescing,
            # and the warm-start guard/audit counters the
            # serve_warm_start_digest_mismatch SLO rule gates
            st = self._store.stats()
            out["store"] = st
            out["requests"] += counts["store_hits"]
            out["store_hit_ratio"] = counts["store_hits"] / max(
                1, counts["store_hits"] + counts["admitted"])
            out["read_p50_ms"] = self._percentile(read_ms, 50)
            out["read_p99_ms"] = self._percentile(read_ms, 99)
            out["store_corrupt"] = st["corrupt"]
            out["store_entries"] = st["entries"]
            out["store_quarantined"] = st["quarantined"]
            out["warm_start_seeded"] = counts["warm_seeded"]
            out["warm_start_rejected"] = counts["warm_rejected"]
            out["warm_start_digest_mismatch"] = counts["warm_mismatch"]
            out["warm_start_iter_savings"] = round(warm_savings, 3)
        if self._journal is not None:
            out["journal"] = {"path": self._journal.path,
                              "errors": self._journal.errors}
            out["journal_errors"] = self._journal.errors
            if self._journal.mirror is not None:
                # replication facts (serve/replica.py): peer census,
                # worst-peer lag, ship errors — the SLO rule
                # serve_replication_lag_records gates the lag column
                rep = self._journal.mirror.status()
                out["replication"] = rep
                out["replication_lag_records"] = rep["lag_records"]
                out["replication_errors"] = rep["errors"]
        if self._ckpt is not None:
            # preemption-tolerance facts (serve/checkpoint.py): present
            # only on checkpoint-enabled services, so the resume SLO
            # rules skip every ordinary serve row
            st = self._ckpt.stats()
            out["ckpt"] = st
            out["ckpt_writes"] = st["writes"]
            out["ckpt_corrupt"] = st["corrupt"]
            out["ckpt_resumes"] = counts["ckpt_resumed"]
            out["ckpt_resumed_from_step"] = last_resumed
        # per-component disk census -> raft_tpu_disk_bytes gauges +
        # flat disk_* facts for the trend store
        disk = {}
        if self._journal is not None and self.cfg.journal_dir:
            from raft_tpu_torch.obs.journalio import dir_bytes
            from raft_tpu_torch.serve.checkpoint import disk_gauge
            n = dir_bytes(self.cfg.journal_dir)
            disk_gauge("journal", n)
            disk["journal"] = n
        if self._store is not None:
            # stats() above already walked the store directory (and
            # set the gauge) — reuse its census instead of a second
            # O(entries) scandir per summary poll
            disk["resultstore"] = (
                out["store"]["disk_bytes"] if "store" in out
                else self._store.disk_bytes())
        if self._ckpt is not None:
            disk["checkpoint"] = self._ckpt.disk_bytes()
        if disk:
            out["disk_bytes"] = disk
            for comp, n in disk.items():
                out[f"disk_{comp}_bytes"] = n
        if handoff_info:
            out["handoff"] = handoff_info
            out["handoff_pending"] = handoff_info["pending"]
        if recover_info:
            # restart facts exist ONLY on recovered services, so the
            # SLO rules gating them skip every ordinary serve row
            out["recovery"] = recover_info
            out["replayed"] = recover_info["replayed"]
            out["recovered_results"] = recover_info["recovered"]
            out["deduped"] = recover_info["deduped"]
            # replayed requests that never reached a terminal state
            # (handed-off ones resolved typed and stay pending in the
            # WAL): MUST be zero — the no-silent-drop gate
            out["replayed_lost_count"] = replayed_open
            if recover_info["replayed"]:
                # warm-start is measurable only when the recovery
                # actually re-ran work: a fresh boot against an empty
                # journal (an elastic-fleet scale-up) replays nothing
                # and must not trip the restart-latency SLO rule
                out["restart_warm_start"] = int(
                    any(c == "hit" for c in runners.values()))
            if recover_info.get("mirror"):
                # this life is a FAILOVER (it folded a foreign mirror
                # directory): the zero-loss gate gets its own fact so
                # the serve_failover_lost_count SLO rule skips ordinary
                # same-host restarts
                out["failover"] = 1
                out["failover_lost_count"] = replayed_open
        return out
