"""Retry/backoff policy for the serving layer.

The port's copy of ``raft_tpu/serve/retry.py``: the same matrix, keyed by
error-class name along the MRO, and the same deterministic backoff (the
same delays for the same seed, key and attempt).

The in-solve recovery machinery (the degradation ladder and lane
quarantine) retries *within* one solve attempt.  This module is the
layer above it: when a whole batch (or one lane of it) still fails with
a typed :class:`raft_tpu_torch.errors.RaftError`, the service decides — per
error class — whether the request goes back into the queue or fails to
the caller.

The retry matrix keys on the error taxonomy (``errors.py``):

=================  =========  =====================================
error class        budget     why
=================  =========  =====================================
KernelFailure      3          transient (injected) kernel failures
CacheCorruption    3          delete-and-miss recovers on re-entry
DynamicsSingular   2          damping/backoff may clear it
StaticsDivergence  2          ditto
NonFiniteResult    2          a poisoned lane may be transient
FaultInjected      2          injected stand-in for the above
EigenFailure       1          rarely transient
DeadlineExceeded   1          one re-admission after an abandoned
                              batch; repeat offenders are quarantined
                              by the strike counter, not the budget
ModelConfigError   terminal   the request itself is wrong
AdmissionRejected  terminal   backpressure must reach the caller
PartitionRuleError terminal   the sharding request is wrong
=================  =========  =====================================

Backoff is jittered exponential — ``min(cap, base * 2**attempt)``
scaled by a *deterministic* jitter in ``[1 - jitter, 1]`` derived from
``(seed, key, attempt)``: two runs of the same chaos soak schedule the
same delays, so the soak is reproducible while a real fleet still
decorrelates (every request id seeds differently).
"""
from __future__ import annotations

import hashlib
import struct

from raft_tpu_torch import errors

#: per-error-class retry budgets (attempts AFTER the first try)
DEFAULT_BUDGETS = {
    "KernelFailure": 3,
    "CacheCorruption": 3,
    "DynamicsSingular": 2,
    "StaticsDivergence": 2,
    "NonFiniteResult": 2,
    "FaultInjected": 2,
    "EigenFailure": 1,
    "DeadlineExceeded": 1,
}

#: error classes that must surface to the caller immediately
TERMINAL = ("ModelConfigError", "AdmissionRejected", "PartitionRuleError")


class RetryPolicy:
    """Per-error-class retry budgets + deterministic jittered backoff."""

    def __init__(self, budgets: dict = None, base_s: float = 0.05,
                 cap_s: float = 2.0, jitter: float = 0.5, seed: int = 0):
        self.budgets = dict(DEFAULT_BUDGETS)
        if budgets:
            self.budgets.update(budgets)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter = float(jitter)
        self.seed = int(seed)

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        return cls(base_s=cfg.retry_base_s, cap_s=cfg.retry_cap_s,
                   jitter=cfg.retry_jitter, seed=cfg.retry_seed)

    @staticmethod
    def classify(err: BaseException) -> str:
        """The budget/terminal key of ``err`` (its class name; walks the
        MRO so a taxonomy subclass inherits its parent's policy)."""
        for cls in type(err).__mro__:
            name = cls.__name__
            if name in TERMINAL or name in DEFAULT_BUDGETS:
                return name
        return type(err).__name__

    def budget(self, err: BaseException) -> int:
        """Retries allowed for ``err`` (0 = terminal).  Unknown /
        non-taxonomy errors get 0 — a bug is not a transient."""
        key = self.classify(err)
        if key in TERMINAL:
            return 0
        return int(self.budgets.get(key, 0))

    def should_retry(self, err: BaseException, attempts: int) -> bool:
        """``attempts`` = retries already consumed for this error class
        on this request."""
        return attempts < self.budget(err)

    def backoff_s(self, key: str, attempt: int) -> float:
        """Deterministic jittered exponential delay for retry number
        ``attempt`` (0-based) of request ``key``."""
        raw = min(self.cap_s, self.base_s * (2.0 ** max(0, int(attempt))))
        if self.jitter <= 0.0:
            return raw
        h = hashlib.sha256(
            f"{self.seed}:{key}:{int(attempt)}".encode()).digest()
        unit = struct.unpack(">Q", h[:8])[0] / float(2 ** 64)
        return raw * (1.0 - self.jitter * unit)

    def matrix(self) -> dict:
        """The effective retry matrix (manifest / docs rendering)."""
        out = {name: {"budget": n, "terminal": False}
               for name, n in sorted(self.budgets.items())}
        for name in TERMINAL:
            out[name] = {"budget": 0, "terminal": True}
        return out


def is_injected(err: BaseException) -> bool:
    """Whether a taxonomy error came from the fault-injection harness."""
    return bool(getattr(err, "injected", False))
