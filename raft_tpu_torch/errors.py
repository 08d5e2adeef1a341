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


class StorageExhausted(RaftError, OSError):
    """A persistence tier (the checkpoint store) hit proven resource
    exhaustion: an ``ENOSPC`` write failure.  Raised only from write
    paths whose caller can shed the write (``sweep_cases_chunked`` keeps
    solving and stops persisting)."""

    phase = "storage"


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
