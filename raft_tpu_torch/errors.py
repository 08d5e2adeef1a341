"""Typed errors raised by the PyTorch port.

A copy of the classes of ``raft_tpu/errors.py`` that this package raises
(the port never imports the JAX package).  Each error keeps its
structured context on ``err.ctx`` and renders it into the message; the
builtin bases keep plain ``except ValueError`` / ``RuntimeError``
callers working.  ``phase`` and :meth:`RaftError.context` are what the
per-case quarantine of ``Model.analyzeCases`` records.

The degradation ladder (:mod:`raft_tpu_torch.recovery`) retries the types
in `RECOVERABLE`, with one difference from the JAX package, decided by
`recoverable`: a `KernelFailure` that a kernel's build, load or launch
raised is fatal — only one injected by the ``kernel`` / ``sweep`` fault
seams (``injected=True``) walks the ladder.
"""
from __future__ import annotations

import math


class RaftError(Exception):
    """Base of the error taxonomy; ``context`` keywords are kept on
    ``err.ctx`` and rendered into the message."""

    #: phase tag of the failure
    phase = "unknown"

    def __init__(self, message: str = "", **context):
        self.ctx = dict(context)
        self.injected = bool(self.ctx.pop("injected", False))
        super().__init__(message)

    def __str__(self):
        base = super().__str__()
        facts = ", ".join(f"{k}={v}" for k, v in sorted(self.ctx.items()))
        inj = " [injected]" if self.injected else ""
        return f"{base}{inj}" + (f" ({facts})" if facts else "")

    def context(self) -> dict:
        """JSON-able structured record of this failure (non-finite
        floats become the strings "nan"/"inf")."""
        out = {"error": type(self).__name__, "phase": self.phase,
               "message": Exception.__str__(self),
               "injected": self.injected}
        for k, v in self.ctx.items():
            if isinstance(v, float) and not math.isfinite(v):
                v = "nan" if math.isnan(v) else (
                    "inf" if v > 0 else "-inf")
            out[str(k)] = v if isinstance(v, (bool, int, float, str,
                                              type(None))) else str(v)
        return out


class StaticsDivergence(RaftError, RuntimeError):
    """The mean-offset Newton produced a non-finite pose or diverged."""

    phase = "statics"


class DynamicsSingular(RaftError, RuntimeError):
    """The frequency-domain impedance system is singular or otherwise
    unsolvable."""

    phase = "dynamics"


class NonFiniteResult(RaftError, FloatingPointError, ValueError):
    """A solver output or parsed input carries NaN/Inf."""

    phase = "dynamics"


class KernelFailure(RaftError, RuntimeError):
    """A hand-written solve kernel failed to build, load or launch."""

    phase = "dynamics"


class CacheCorruption(RaftError, RuntimeError):
    """A persisted artifact (a journal record, a result-store entry)
    failed its integrity check.  The stores recover by delete-and-miss;
    this type surfaces only when a caller opts into strict mode."""

    phase = "cache"


class JournalCorrupt(CacheCorruption):
    """A write-ahead/resume journal record failed to parse or verify
    (torn tail, bit rot, schema drift).  Replay treats corruption as a
    skip-and-count miss by default; this type surfaces only under strict
    scanning (``serve.journal.replay(..., strict=True)``)."""

    phase = "journal"


class ResultStoreCorrupt(CacheCorruption):
    """A persistent result-store entry (:mod:`raft_tpu_torch.serve.
    resultstore`) failed an integrity check: size/sha256 sidecar
    mismatch, a torn or unparseable payload, a key/payload digest
    disagreement (a *stale* entry answering for the wrong request), or a
    payload whose recorded result digest no longer matches its own
    metrics.  The store recovers by delete-and-miss; this type surfaces
    only when a caller opts into strict reads."""

    phase = "cache"


class StorageExhausted(RaftError, OSError):
    """A persistence tier (the checkpoint store) hit proven resource
    exhaustion: an ``ENOSPC`` write failure.  Raised only from write
    paths whose caller can shed the write (``sweep_cases_chunked`` keeps
    solving and stops persisting)."""

    phase = "storage"


class WarmStartRejected(RaftError, RuntimeError):
    """A neighbour-seeded (warm-started) solve tripped the divergence
    guard and the service fell back to a cold start, quarantining the
    seed.  A degradation signal recorded per occurrence, never a
    caller-visible failure: the fallback result is always delivered,
    bit-identical to a cold start."""

    phase = "serve"


class FaultInjected(RaftError, RuntimeError):
    """Raised by :mod:`raft_tpu_torch.testing.faults` for ``raise@...``
    specs at sites without a more specific mapped type."""

    phase = "injected"


class EigenFailure(RaftError, RuntimeError):
    """The eigen solve produced unusable system matrices or
    non-positive eigenvalues."""

    phase = "eigen"


class MooringSingular(RaftError, RuntimeError):
    """A mooring tension Jacobian / stiffness evaluation is singular."""

    phase = "outputs"


class ModelConfigError(RaftError, ValueError):
    """The model/design configuration cannot be analyzed as requested."""

    phase = "setup"


class PartitionRuleError(RaftError, ValueError):
    """The partition layer cannot place a pytree on the mesh as asked —
    an unmatched leaf, a mesh/axes shape mismatch, or a mesh wanting
    more devices than exist (not recoverable by the ladder: the sharding
    request itself is wrong; see parallel/partition.py)."""

    phase = "setup"


class AdmissionRejected(RaftError, RuntimeError):
    """The serving layer (:mod:`raft_tpu_torch.serve`) refused a request
    at admission: queue depth or deadline pressure beyond the configured
    watermarks, or the service is in its ``reject`` degradation mode.
    Carries ``retry_after_s``, the caller's earliest useful resubmission
    time, as an attribute and in :meth:`context`.  Not recoverable by
    the ladder: backpressure only works if the rejection reaches the
    caller."""

    phase = "admission"

    def __init__(self, message: str = "", retry_after_s: float = 0.0,
                 **context):
        self.retry_after_s = float(retry_after_s)
        super().__init__(message, retry_after_s=self.retry_after_s,
                         **context)


class ReplicaLagExceeded(RaftError, RuntimeError):
    """The write-ahead-journal mirror (:mod:`raft_tpu_torch.serve.
    replica`) fell further behind the primary than its record budget.
    A degradation signal: raised only from :meth:`WalMirror.check`;
    the serving loop folds it into the degradation ladder instead."""

    phase = "replication"


class DeadlineExceeded(RaftError, TimeoutError):
    """A request (or the batch carrying it) overran its deadline: the
    serving watchdog's abandon signal and the typed failure of a request
    quarantined for hanging."""

    phase = "serve"


#: failure types the degradation ladder may retry (everything a solver
#: can plausibly survive by re-solving or damping); configuration errors
#: are excluded on purpose, and a KernelFailure only when injected
#: (`recoverable`)
RECOVERABLE = (StaticsDivergence, DynamicsSingular, NonFiniteResult,
               KernelFailure, FaultInjected)


def recoverable(err: BaseException) -> bool:
    """May the ladder retry ``err`` (and the quarantine record it)?  A
    type of `RECOVERABLE`, except a `KernelFailure` that is not
    injected: a kernel that fails to build, load or launch is fatal, so
    the card and its kernels are never silently stepped around."""
    if not isinstance(err, RECOVERABLE):
        return False
    return not (isinstance(err, KernelFailure) and not err.injected)
