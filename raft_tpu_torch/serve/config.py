"""Serving-layer configuration (:class:`ServeConfig`).

The port's copy of ``raft_tpu/serve/config.py``: the same fields, the
same defaults and the same validation, with two differences.  The
learned read tier is not ported yet (ROADMAP A10): of its knobs only
``surrogate_dir`` is kept, and a config that names one raises a typed
``ModelConfigError`` at construction; the tier's tuning knobs come with
it.  The ``mesh`` hook takes a ``raft_tpu_torch.parallel.partition.Mesh``.

One frozen-ish dataclass carries every knob of the always-on sweep
service: admission watermarks, the batching window, deadlines, the
watchdog, retry budgets, and the service degradation ladder.  Values
are validated eagerly (a service that boots with a nonsensical
watermark is a worse failure mode than a loud
:class:`raft_tpu_torch.errors.ModelConfigError` at construction).

See docs/robustness.md "Serving" for the semantics of each group.
"""
from __future__ import annotations

import dataclasses
import os

from raft_tpu_torch import errors

#: the service degradation ladder, best -> worst.  ``full`` runs the
#: configured solver; ``no_qtf`` drops second-order (QTF/mean-drift)
#: excitation from the solve; ``coarse`` additionally runs on a
#: decimated frequency grid (both need a degraded model handed to the
#: service — rungs without one are skipped); ``reject`` sheds every new
#: request at admission until the backlog drains and the SLO recovers.
MODES = ("full", "no_qtf", "coarse", "reject")


@dataclasses.dataclass
class ServeConfig:
    """Knobs of one :class:`raft_tpu_torch.serve.SweepService`."""

    # -- admission / queue -------------------------------------------
    #: hard bound on queued (not yet in-flight) requests; admission
    #: rejects above it with a Retry-After hint
    queue_max: int = 64
    #: reject a request at admission when its deadline cannot plausibly
    #: be met: estimated queue wait > deadline_pressure * deadline
    deadline_pressure: float = 1.0

    # -- batching window ---------------------------------------------
    #: fixed case-batch size of the warm batch runner (short
    #: batches are padded, pad lanes stripped)
    batch_cases: int = 8
    #: coalescing window: after the first request of a batch arrives,
    #: wait at most this long for more before solving
    window_s: float = 0.05

    # -- deadlines / watchdog ----------------------------------------
    #: default per-request deadline (admission + in-queue expiry)
    deadline_s: float = 120.0
    #: watchdog deadline for one in-flight batch: a solve still running
    #: after this is abandoned, its members re-admitted solo (repeat
    #: offenders quarantined)
    batch_deadline_s: float = 60.0
    #: watchdog poll cadence
    watchdog_tick_s: float = 0.05
    #: abandoned-batch strikes after which a request is quarantined as a
    #: typed DeadlineExceeded failure instead of re-admitted
    hang_quarantine_after: int = 2

    # -- retry / backoff (serve/retry.py) ----------------------------
    retry_base_s: float = 0.05
    retry_cap_s: float = 2.0
    retry_jitter: float = 0.5
    retry_seed: int = 0

    # -- degradation ladder ------------------------------------------
    #: per-batch latency SLO the mode controller folds (seconds)
    latency_slo_s: float = 30.0
    #: consecutive violating batches before stepping DOWN the ladder
    degrade_after: int = 2
    #: consecutive healthy batches before stepping back UP
    upgrade_after: int = 4
    #: minimum dwell in ``reject`` mode before probing back up
    reject_hold_s: float = 1.0

    # -- results ------------------------------------------------------
    #: completed results kept for fetch-by-digest delivery
    result_cache: int = 256

    # -- durability (serve/journal.py) --------------------------------
    #: directory of the write-ahead request journal; None (default)
    #: serves from memory only — set it to make every admission,
    #: completion, and failure crash-recoverable via
    #: ``SweepService.recover()``
    journal_dir: str | None = None

    # -- result tier (serve/resultstore.py) ---------------------------
    #: directory of the persistent content-addressed result store; None
    #: (default) disables the whole read-through tier.  With it set:
    #: an exact request-digest hit at admission returns at memory speed
    #: without entering the batch window (across restarts, and across
    #: replicas sharing or mirroring the directory), concurrent
    #: duplicate submissions single-flight onto one solve, and
    #: ``fetch_rdigest`` falls through to the store after the
    #: in-memory LRU evicts
    store_dir: str | None = None
    #: seed the drag fixed point of cache MISSES from the nearest
    #: cold-solved neighbor in (Hs, Tp, beta), guarded by the
    #: divergence watchdog + the warm audit (requires ``store_dir``;
    #: composes with ``mesh`` — seeds are placed onto the mesh via the
    #: partition rules' ``XI_SPEC``, exactly like the in-program
    #: resharding boundary)
    warm_start: bool = False
    #: neighbor-seeding radius — Euclidean distance over (Hs [m],
    #: Tp [s], beta [rad]); a seed farther than this is worse than a
    #: cold start
    warm_radius: float = 1.0
    #: every Nth warm batch is AUDITED: solved both seeded and cold,
    #: the cold results delivered (bit-identical to an unseeded
    #: service by construction) and the two compared — a divergence
    #: past the solver tolerance is a counted
    #: ``warm_start_digest_mismatch`` and quarantines the seed.  1 =
    #: audit every batch (the parity-proof mode the storm soak runs)
    warm_audit_every: int = 8

    # -- learned read tier (serve/surrogate.py, not ported yet) --------
    #: directory of distilled surrogate bundles; must stay None in the
    #: port (the tier is ROADMAP A10's): any other value raises
    surrogate_dir: str | None = None

    # -- replication (serve/replica.py) -------------------------------
    #: peer directories the write-ahead journal is mirrored to (local
    #: paths now, object-store mounts later); requires ``journal_dir``.
    #: A successor on a DIFFERENT host recovers from a mirror alone
    #: (``SweepService.recover(mirror_dir)``) with the same zero-loss
    #: replay guarantees
    mirror_dirs: tuple = ()
    #: mirror records behind which the typed ``ReplicaLagExceeded``
    #: degradation signal trips (folded into the service ladder)
    replica_max_lag_records: int = 1024
    #: True (default): ship each WAL record to every reachable peer
    #: inline, before the write is acknowledged (zero-loss failover);
    #: False: mirror asynchronously via the bounded catch-up queue
    mirror_sync: bool = True

    # -- preemption tolerance (serve/checkpoint.py) --------------------
    #: directory of the descent/sweep checkpoint store; None (default)
    #: keeps no progress — a preempted descent restarts from step 0.
    #: With it set, optimize requests checkpoint their carry every
    #: ``checkpoint_every`` steps and ``recover()`` resumes an
    #: accepted-unfinished descent from its newest valid checkpoint
    ckpt_dir: str | None = None
    #: descent steps per segment between checkpoints; 0
    #: (default) runs the monolithic scan.  Chunking is numerically
    #: bitwise-identical to the monolithic descent (pinned)
    checkpoint_every: int = 0
    #: hard byte budget of the checkpoint directory: a put that would
    #: exceed it raises the same typed ``StorageExhausted`` shed a real
    #: ENOSPC does (None = only proven ENOSPC sheds)
    disk_budget_bytes: int | None = None
    #: seconds a storage-shed rung (checkpointing first, then the
    #: result-store write-through) holds before re-probing the disk —
    #: the self-clear cadence of the ENOSPC degradation ladder
    storage_shed_hold_s: float = 5.0

    # -- sharding (parallel/partition.py) ------------------------------
    #: named mesh (``parallel.partition.Mesh``, batch axes) the warm
    #: batch programs solve on (None = one device); the runner rounds
    #: its batch up to the mesh's batch size
    mesh: object = None

    # -- optimize tenant (parallel/optimize.py) ------------------------
    #: resource guards on POST /optimize requests: descent lanes and
    #: steps a single request may ask for (a compile-bomb spec is a
    #: typed reject at admission, never a wedged service)
    optimize_lanes_max: int = 256
    optimize_steps_max: int = 200

    # -- farm tenant (parallel/sweep.sweep_farm) -----------------------
    #: resource guards on POST /farm requests: turbines and per-turbine
    #: cases one request may ask for (a compile-bomb layout is a typed
    #: reject at admission, never a wedged service)
    farm_turbines_max: int = 16
    farm_cases_max: int = 1024

    # -- tenancy (serve/tenancy.py) -----------------------------------
    #: warm batch runners kept live across all tenants;
    #: least-recently-used runners are evicted (and rebuilt on next use)
    #: beyond this budget
    max_live_programs: int = 4

    # -- solver kwargs forwarded to make_case_solver -----------------
    nIter: int = 10
    tol: float = 0.01
    fp_chunk: int = 2

    def __post_init__(self):
        if self.surrogate_dir is not None:
            raise errors.ModelConfigError(
                "the learned read tier (surrogate_dir) is not ported to "
                "raft_tpu_torch yet (ROADMAP A10)",
                fields="surrogate_dir")
        checks = [
            ("queue_max", self.queue_max >= 1),
            ("batch_cases", self.batch_cases >= 1),
            ("window_s", self.window_s >= 0.0),
            ("deadline_s", self.deadline_s > 0.0),
            ("batch_deadline_s", self.batch_deadline_s > 0.0),
            ("watchdog_tick_s", self.watchdog_tick_s > 0.0),
            ("hang_quarantine_after", self.hang_quarantine_after >= 1),
            ("deadline_pressure", self.deadline_pressure > 0.0),
            ("retry_base_s", self.retry_base_s >= 0.0),
            ("retry_cap_s", self.retry_cap_s >= self.retry_base_s),
            ("retry_jitter", 0.0 <= self.retry_jitter <= 1.0),
            ("degrade_after", self.degrade_after >= 1),
            ("upgrade_after", self.upgrade_after >= 1),
            ("reject_hold_s", self.reject_hold_s >= 0.0),
            ("result_cache", self.result_cache >= 1),
            ("journal_dir", self.journal_dir is None
             or bool(str(self.journal_dir).strip())),
            ("mirror_dirs", not self.mirror_dirs
             or (self.journal_dir is not None
                 and all(str(d).strip() for d in self.mirror_dirs)
                 and not any(os.path.abspath(str(d))
                             == os.path.abspath(str(self.journal_dir))
                             for d in self.mirror_dirs))),
            ("replica_max_lag_records", self.replica_max_lag_records >= 1),
            ("store_dir", self.store_dir is None
             or bool(str(self.store_dir).strip())),
            ("warm_start", not self.warm_start
             or self.store_dir is not None),
            ("warm_radius", self.warm_radius > 0.0),
            ("warm_audit_every", self.warm_audit_every >= 1),
            ("ckpt_dir", self.ckpt_dir is None
             or bool(str(self.ckpt_dir).strip())),
            ("checkpoint_every", self.checkpoint_every >= 0),
            ("disk_budget_bytes", self.disk_budget_bytes is None
             or self.disk_budget_bytes >= 1),
            ("storage_shed_hold_s", self.storage_shed_hold_s >= 0.0),
            ("max_live_programs", self.max_live_programs >= 1),
            ("optimize_lanes_max", self.optimize_lanes_max >= 1),
            ("optimize_steps_max", self.optimize_steps_max >= 1),
            ("farm_turbines_max", self.farm_turbines_max >= 1),
            ("farm_cases_max", self.farm_cases_max >= 1),
            ("nIter", self.nIter >= 1),
        ]
        bad = [name for name, ok in checks if not ok]
        if bad:
            raise errors.ModelConfigError(
                "invalid ServeConfig", fields=",".join(bad))

    def solver_kw(self) -> dict:
        """kwargs forwarded to ``make_case_solver`` / the batch runner."""
        return {"nIter": int(self.nIter), "tol": float(self.tol),
                "fp_chunk": int(self.fp_chunk)}

    def scalars(self) -> dict:
        """Flat scalar snapshot for the service run manifest (field
        iteration, not ``asdict`` — the ``mesh`` field holds a device
        mesh that must not be deep-copied)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (bool, int, float, str)):
                out[f.name] = v
        if self.mirror_dirs:
            out["mirror_peers"] = len(self.mirror_dirs)
        if self.mesh is not None:
            from raft_tpu_torch.parallel import partition
            facts = partition.mesh_facts(self.mesh)
            if facts:
                out["mesh"] = facts["topology"]
        return out
