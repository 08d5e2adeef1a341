"""Write-ahead request journal for the sweep service (durability).

The port's copy of ``raft_tpu/serve/journal.py``.  The record format, the
schema string and the digests are the JAX package's, unchanged: a journal
written by either package replays in the other, and `request_digest`,
`optimize_digest` and `farm_digest` give the same hex for the same
request.

The :class:`~raft_tpu_torch.serve.service.SweepService` survives faults
*it can see*; this module makes it survive the fault it cannot — its
own death.  Every externally-visible state change of a request is
appended to a crash-safe JSONL journal (the
:mod:`raft_tpu_torch.obs.journalio` codec: flush-per-line, torn-tail-skip,
size rotation) **before** the change is acknowledged to the caller:

==========  ==========================================================
record      written when
==========  ==========================================================
begin       journal (part) opens — schema + service run identity
admit       a request passes admission, BEFORE its ticket is returned
batch       a gathered batch is registered in-flight, before solving
complete    a result is ready, BEFORE the ticket resolves; carries the
            ledger ``case<i>`` result digest AND the payload needed to
            re-deliver without re-solving
fail        a typed terminal failure, BEFORE the ticket resolves
tenant      a warm-runner eviction / re-warm (serve/tenancy.py)
ckpt        a descent segment's checkpoint landed (serve/checkpoint.py):
            request digest -> segment step + checkpoint content digest,
            the resume audit trail (non-terminal)
recover     a replay happened: the recovered/replayed/deduped counts
handoff     a graceful drain: pending seqs + exec-cache keys the
            successor warm-starts from
==========  ==========================================================

Records are keyed twice: by the **request digest** (``rdigest`` — the
content address of the submitted ``(Hs, Tp, beta, tenant)``) and, once
solved, by the deterministic ledger **result digest** the async
delivery path already uses.  That makes replay idempotent: a re-run of
an already-completed request is recognized by its request digest and
becomes a *dedupe hit* (the journaled result is re-delivered), never a
duplicate solve.

:func:`replay` is the read half: scan a journal directory (rotated
parts oldest-first), classify every admitted request as completed /
failed / pending, skip-and-count torn lines
(``raft_tpu_journal_corrupt_total{kind="serve"}``), and return the
structured state :meth:`SweepService.recover` re-admits from.

Journal writes must never take down the service they protect: an I/O
failure is logged, counted (``raft_tpu_serve_journal_errors_total``)
and serving continues — the operator sees the durability gap in the
metrics instead of a dead endpoint.  The ``torn@journal`` fault action
(:mod:`raft_tpu_torch.testing.faults`) truncates the freshly-written record
mid-line to drive the torn-tail replay path deterministically in CI.

With ``mirror_dirs`` the journal additionally streams every record and
every sealed part to peer stores (:mod:`raft_tpu_torch.serve.replica`), so
:func:`replay`/:meth:`SweepService.recover` work against a *mirror*
directory on a different host with the same zero-loss guarantees — the
cross-host failover the ``raftserve soak --failover`` harness proves.
"""
from __future__ import annotations

import os
import threading
import time

from raft_tpu_torch import errors
from raft_tpu_torch.obs import journalio
from raft_tpu_torch.utils.profiling import get_logger

_LOG = get_logger("serve.journal")

SCHEMA = "raft_tpu.serve.journal/v1"
FILENAME = "serve.journal.jsonl"
HANDOFF = "handoff.json"

#: record types replay understands; anything else in the stream is
#: schema drift and counts as corruption
RECORD_TYPES = ("begin", "admit", "batch", "complete", "fail", "tenant",
                "recover", "handoff", "ckpt", "surrogate")

#: journaled ``objective_trace`` entries beyond which the WAL keeps
#: only first/last + length: a long descent's trace is delivered in
#: full to the caller, but journaling (and re-journaling: dedupe
#: fan-outs, rotation-checkpointed parts) the whole series would bloat
#: every rotated part of a long-lived WAL
TRACE_CAP = 16

#: terminal record types — an admitted seq carrying one of these is no
#: longer pending
_TERMINAL = ("complete", "fail")


def journal_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, FILENAME)


def handoff_path(journal_dir: str) -> str:
    return os.path.join(journal_dir, HANDOFF)


def max_bytes() -> int:
    try:
        return int(os.environ.get("RAFT_TPU_SERVE_JOURNAL_MAX_BYTES",
                                  str(64 << 20)))
    except ValueError:                               # pragma: no cover
        return 64 << 20


def request_digest(Hs: float, Tp: float, beta: float,
                   tenant: str = "default") -> str:
    """Content address of one submission — the dedupe key.  Two
    requests for the same physics under the same tenant share it; the
    deadline deliberately does not participate (a resubmission with a
    different deadline is still the same solve)."""
    from raft_tpu_torch.ledger import digest_metrics
    return digest_metrics({"Hs": float(Hs), "Tp": float(Tp),
                           "beta": float(beta), "tenant": str(tenant)})


def cap_trace(extra: dict, cap: int = None) -> dict:
    """The journal-facing copy of an optimize result payload: an
    ``objective_trace`` longer than ``cap`` (default
    :data:`TRACE_CAP`) collapses to ``{"first", "last", "n"}``.  Pure
    (the caller's payload is never mutated); short traces and
    trace-less extras pass through structurally unchanged."""
    cap = TRACE_CAP if cap is None else int(cap)
    prov = extra.get("provenance") if isinstance(extra, dict) else None
    trace = (prov or {}).get("objective_trace")
    if not isinstance(trace, list) or len(trace) <= cap:
        return dict(extra)
    half = max(1, cap // 2)
    out = dict(extra)
    out["provenance"] = {**prov, "objective_trace": {
        "first": [float(v) for v in trace[:half]],
        "last": [float(v) for v in trace[-half:]],
        "n": len(trace)}}
    return out


def optimize_result_digest(design: dict, f_best: float,
                           iterations: int) -> str:
    """The content address of one optimize delivery — shared by
    ``SweepService._complete_optimize`` and the preempt-soak verdict,
    so "resumed digest == clean-run digest" is compared in one
    recipe."""
    import json

    from raft_tpu_torch.ledger import digest_metrics
    return digest_metrics({
        "optimize": json.dumps(design, sort_keys=True),
        "f_best": float(f_best), "iterations": int(iterations)})


def optimize_digest(spec: dict, tenant: str = "default") -> str:
    """Content address of one design-optimization request: the dedupe/
    single-flight key over the CANONICAL spec (bounds + objective +
    descent knobs; json with sorted keys so dict ordering never forks
    the digest) under the tenant."""
    import json

    from raft_tpu_torch.ledger import digest_metrics
    return digest_metrics({"optimize": json.dumps(spec, sort_keys=True,
                                                  default=str),
                           "tenant": str(tenant)})


def farm_digest(spec: dict, tenant: str = "default") -> str:
    """Content address of one farm request: the dedupe/single-flight
    key over the canonical farm spec — which INCLUDES the layout, so
    the rdigest is salted by turbine positions (two farms with the same
    case table but different layouts never dedupe into one flight)."""
    import json

    from raft_tpu_torch.ledger import digest_metrics
    return digest_metrics({"farm": json.dumps(spec, sort_keys=True,
                                              default=str),
                           "tenant": str(tenant)})


def farm_result_digest(std_norm: float, n_turbines: int,
                       ncases: int, wake_iters: int) -> str:
    """The content address of one farm delivery — the recover/replay
    verdict's "resumed digest == clean-run digest" comparison key."""
    from raft_tpu_torch.ledger import digest_metrics
    return digest_metrics({
        "farm_std_norm": float(std_norm),
        "n_turbines": int(n_turbines), "ncases": int(ncases),
        "wake_iters": int(wake_iters)})


class RequestJournal:
    """The service's append-only WAL (one per journal directory).

    Thread-safe; every ``record_*`` method serializes, writes, and
    flushes one line before returning, so the caller may acknowledge
    the state change the instant the call returns.  All methods are
    crash-tolerant in the other direction too: a failed write degrades
    to a counted, logged gap — never an exception into the serving
    loop.
    """

    def __init__(self, journal_dir: str, run_id: str = None, *,
                 snapshot_fn=None, mirror_dirs=None,
                 mirror_max_lag: int = 1024, mirror_sync: bool = True):
        self.dir = str(journal_dir)
        self.run_id = str(run_id or "")
        self.path = journal_path(self.dir)
        self._lock = threading.Lock()
        self.errors = 0
        #: checkpoint source: called (lock-free from the service side)
        #: on every size rotation to re-append the ``admit`` records of
        #: still-open requests into the fresh part — rotation may drop
        #: old parts, and an open request's admit record must outlive
        #: them or a crash after rotation silently loses it.  (The
        #: dedupe index of COMPLETED results is deliberately bounded by
        #: the retained parts instead — losing a dedupe hit costs one
        #: redundant solve, never a request.)
        self._snapshot = snapshot_fn
        #: WAL mirroring (serve/replica.py): every flushed record and
        #: every sealed part streams to the peer directories through
        #: the writer hooks, BEFORE the journaled change is acked when
        #: mirror_sync (the default) — a mirror replays like the
        #: primary on any other host
        self.mirror = None
        if mirror_dirs:
            from raft_tpu_torch.serve.replica import WalMirror
            self.mirror = WalMirror(
                self.path, [str(d) for d in mirror_dirs],
                max_lag_records=mirror_max_lag, keep=4,
                sync=mirror_sync)
        self._writer = journalio.JsonlWriter(
            self.path, max_bytes=max_bytes(), keep=4,
            header=self._begin_record,
            post_flush=(self.mirror.notify_flush
                        if self.mirror is not None else None),
            post_rotate=(
                (lambda w, part: self.mirror.notify_rotate(w, part))
                if self.mirror is not None else None))

    def _begin_record(self, part: int) -> dict:
        return {"t": round(time.time(), 6), "type": "begin",
                "schema": SCHEMA, "run_id": self.run_id,
                "pid": os.getpid(), "part": int(part)}

    # -- the one write path ------------------------------------------

    def _write(self, type_: str, **fields):
        from raft_tpu_torch.testing import faults

        rec = {"t": round(time.time(), 6), "type": str(type_)}
        rec.update(fields)
        try:
            with self._lock:
                if self._writer.closed:
                    return
                # deterministic full-disk injection: the same errno a
                # real ENOSPC surfaces, proven below before the typed
                # degradation signal fires (action-filtered so it can
                # never burn a torn spec's once/times budget)
                if faults.fire_info("journal", action="enospc",
                                    record=type_) is not None:
                    import errno as _errno
                    raise OSError(_errno.ENOSPC,
                                  "injected ENOSPC (fault)")
                part = self._writer.part
                self._writer.write(rec)
                if self._writer.part != part and self._snapshot:
                    # rotated: checkpoint every still-open request's
                    # admit record into the fresh part before old
                    # parts age out
                    for srec in self._snapshot():
                        self._writer.write(dict(srec), rotate=False)
                # deterministic torn-tail injection: what a crash
                # between write and flush of this record looks like
                if faults.fire_info("journal", action="torn",
                                    record=type_) is not None:
                    self._writer.tear_tail()
        # a journal write failure must not take down the service it
        # protects: count the durability gap and keep serving — a
        # PROVEN full disk additionally emits the storage_degraded
        # signal the operator's ENOSPC dashboards key on (the WAL is
        # the deepest tier: it never sheds, admission and delivery
        # stay alive, the gap is visible)
        except Exception as e:  # raftlint: disable=RTL004
            self.errors += 1
            _LOG.warning("serve journal: write failed (%s record); "
                         "durability gap", type_, exc_info=True)
            try:
                from raft_tpu_torch import obs
                from raft_tpu_torch.serve.checkpoint import is_enospc
                obs.counter(
                    "raft_tpu_serve_journal_errors_total",
                    "serve WAL writes that failed (durability gaps)"
                    ).inc(1.0)
                if is_enospc(e):
                    obs.events.emit("storage_degraded",
                                    component="journal",
                                    record=str(type_))
            except Exception:                        # pragma: no cover
                pass

    # -- record emitters (see module table) --------------------------

    def record_admit(self, seq: int, request_id: str, rdigest: str,
                     Hs: float, Tp: float, beta: float,
                     deadline_s: float, tenant: str, opt: dict = None,
                     farm: dict = None, trace: dict = None):
        """``opt`` (optimize tenant): the canonical design-optimization
        request spec — bounds + objective + descent knobs.  Carried in
        the admit record so replay can re-run an accepted-but-unfinished
        optimization exactly as submitted.  ``farm`` (farm tenant): the
        canonical farm request spec (layout + case table + wake knobs),
        journaled for exactly the same replay reason.

        ``trace``: the request's distributed trace context
        (``{trace_id, span_id, parent_id}``) — journaled so the trace
        identity survives crash + failover by construction: any
        successor that replays the WAL inherits it."""
        rec = dict(seq=int(seq), id=str(request_id),
                   rdigest=rdigest, Hs=float(Hs), Tp=float(Tp),
                   beta=float(beta), deadline_s=float(deadline_s),
                   tenant=str(tenant))
        if opt is not None:
            rec["opt"] = dict(opt)
        if farm is not None:
            rec["farm"] = dict(farm)
        if trace is not None:
            rec["trace"] = dict(trace)
        self._write("admit", **rec)

    def record_batch(self, batch_id: int, seqs: list[int], mode: str,
                     tenant: str, traces: list = None):
        """``traces``: the member requests' trace contexts (parallel to
        ``seqs``) — the cross-process linkage ``obsctl trace`` draws
        batch-membership flow arrows from."""
        rec = dict(batch_id=int(batch_id),
                   seqs=[int(s) for s in seqs], mode=str(mode),
                   tenant=str(tenant))
        if traces is not None:
            rec["traces"] = [dict(t) if t else None for t in traces]
        self._write("batch", **rec)

    def record_complete(self, seq: int, rdigest: str, digest: str,
                        mode: str, attempts: int, std: list,
                        iters: int, converged: bool, extra: dict = None,
                        trace: dict = None):
        """``extra`` (optimize tenant): the digest-addressed result
        payload beyond the std row — optimized design + provenance —
        journaled so replay re-delivers it without re-descending.  The
        provenance ``objective_trace`` is capped at :data:`TRACE_CAP`
        entries (first/last halves + total length) in the journaled
        copy: the caller's delivered result keeps the full series, but
        a long descent must not bloat every rotated WAL part (the
        record is re-appended on dedupe fan-outs and replay
        re-journaling too)."""
        rec = dict(seq=int(seq), rdigest=rdigest,
                   digest=digest, mode=str(mode), attempts=int(attempts),
                   std=[float(v) for v in std], iters=int(iters),
                   converged=bool(converged))
        if extra is not None:
            rec["extra"] = cap_trace(extra)
        if trace is not None:
            rec["trace"] = dict(trace)
        self._write("complete", **rec)

    def record_ckpt(self, seq: int, rdigest: str, step: int,
                    cdigest: str, trace: dict = None):
        """A descent segment's checkpoint landed: ties the request
        digest to the segment boundary (``step``) and the checkpoint's
        content digest — the audit trail the preempt-soak verdict (and
        a second replay) agree on.  Non-terminal: a seq carrying only
        admit+ckpt records is still pending."""
        rec = dict(seq=int(seq), rdigest=rdigest,
                   step=int(step), cdigest=str(cdigest))
        if trace is not None:
            rec["trace"] = dict(trace)
        self._write("ckpt", **rec)

    def record_fail(self, seq: int, rdigest: str, error: dict,
                    quarantined: bool, trace: dict = None):
        rec = dict(seq=int(seq), rdigest=rdigest,
                   error=dict(error or {}), quarantined=bool(quarantined))
        if trace is not None:
            rec["trace"] = dict(trace)
        self._write("fail", **rec)

    def record_tenant(self, event: str, tenant: str, mode: str):
        self._write("tenant", event=str(event), tenant=str(tenant),
                    mode=str(mode))

    def record_recover(self, counts: dict):
        self._write("recover", **{k: int(v) for k, v in counts.items()})

    def record_handoff(self, pending: list[int], exec_keys: dict,
                       next_seq: int, successor: str = None):
        self._write("handoff", pending=[int(s) for s in pending],
                    exec_keys=dict(exec_keys), next_seq=int(next_seq),
                    successor=successor)

    def close(self):
        with self._lock:
            self._writer.close()
        if self.mirror is not None:
            # graceful stop: one final reconciliation leaves every peer
            # bit-identical to the primary before the worker retires
            self.mirror.close()


def write_handoff_manifest(journal_dir: str, doc: dict) -> str:
    """Atomically write the successor-facing handoff manifest
    (``handoff.json``) next to the journal; returns its path."""
    import json

    path = handoff_path(journal_dir)
    journalio.fsync_write(path, json.dumps(
        doc, indent=1, default=str).encode())
    return path


def read_handoff_manifest(journal_dir: str) -> dict | None:
    import json

    try:
        with open(handoff_path(journal_dir), encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def find_rdigest(journal_dir: str, rdigest: str) -> dict | None:
    """The journaled ``complete`` record for one request digest, or
    None — the last-resort read path of
    :meth:`SweepService.fetch_rdigest` once both the in-memory LRU and
    the result store have missed.  A full directory scan (rotated
    parts included), so callers should try the cheaper tiers first."""
    try:
        return replay(journal_dir)["by_rdigest"].get(str(rdigest))
    except OSError:
        return None


def _journal_parts(journal_dir: str) -> list[str]:
    """Journal files oldest-first (rotated ``.N`` parts then the live
    file), so replay folds records in write order."""
    main = journal_path(journal_dir)
    parts = []
    i = 1
    while os.path.exists(f"{main}.{i}"):
        parts.append(f"{main}.{i}")
        i += 1
    parts.reverse()
    if os.path.exists(main):
        parts.append(main)
    return parts


def replay(journal_dir: str, strict: bool = False) -> dict:
    """Scan a journal directory into the structured replay state::

        {"admitted":  {seq: admit record},
         "completed": {seq: complete record},
         "failed":    {seq: fail record},
         "pending":   [admit records with no terminal record, seq-asc],
         "deduped":   {seq: complete record of the SAME rdigest},
         "ckpts":     {seq: newest ckpt record (pending descents'
                      resume audit trail)},
         "surrogates": [surrogate provenance records, stream order —
                      answers served by the learned read tier; never
                      terminal, never replayed as physics],
         "by_rdigest": {rdigest: complete record},
         "max_seq":   highest admitted seq (-1 when empty),
         "corrupt":   torn/unparseable lines skipped (counted in
                      raft_tpu_journal_corrupt_total{kind="serve"}),
         "records":   parsed record count,
         "handoff":   last handoff record or None}

    A *pending* request whose ``rdigest`` matches an already-completed
    one is a **dedupe hit**: it appears in ``deduped`` (mapped to the
    completed record that already carries its result) instead of
    ``pending`` — replay never solves the same physics twice.

    Corruption is skip-and-count by default; ``strict=True`` raises a
    typed :class:`raft_tpu_torch.errors.JournalCorrupt` instead (integrity
    audits, not the recovery path).
    """
    admitted: dict[int, dict] = {}
    completed: dict[int, dict] = {}
    failed: dict[int, dict] = {}
    ckpts: dict[int, dict] = {}
    surrogates: list[dict] = []
    handoff = None
    corrupt = 0
    records = 0
    for path in _journal_parts(journal_dir):
        docs, bad = journalio.read_counted(path, kind="serve")
        corrupt += bad
        for doc in docs:
            t = doc.get("type")
            if t not in RECORD_TYPES:
                corrupt += 1
                journalio.count_corrupt("serve")
                continue
            records += 1
            seq = doc.get("seq")
            if t == "admit" and seq is not None:
                admitted[int(seq)] = doc
            elif t == "complete" and seq is not None:
                completed[int(seq)] = doc
            elif t == "fail" and seq is not None:
                failed[int(seq)] = doc
            elif t == "ckpt" and seq is not None:
                # newest wins: the record ties a pending descent's
                # request digest to its last journaled segment
                ckpts[int(seq)] = doc
            elif t == "surrogate":
                surrogates.append(doc)
            elif t == "handoff":
                handoff = doc
    if strict and corrupt:
        raise errors.JournalCorrupt(
            "serve journal carries corrupt records",
            journal_dir=str(journal_dir), corrupt=corrupt)
    by_rdigest = {}
    for rec in completed.values():
        if rec.get("rdigest"):
            by_rdigest[rec["rdigest"]] = rec
    pending = []
    deduped = {}
    for seq in sorted(admitted):
        if seq in completed or seq in failed:
            continue
        rec = admitted[seq]
        prior = by_rdigest.get(rec.get("rdigest"))
        if prior is not None:
            deduped[seq] = prior
        else:
            pending.append(rec)
    return {"admitted": admitted, "completed": completed,
            "failed": failed, "pending": pending, "deduped": deduped,
            "ckpts": ckpts, "surrogates": surrogates,
            "by_rdigest": by_rdigest,
            "max_seq": max(admitted) if admitted else -1,
            "corrupt": corrupt, "records": records, "handoff": handoff}
