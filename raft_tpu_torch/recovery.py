"""Degradation ladder and per-case resume journal.

Port of ``raft_tpu/recovery.py``:

- :func:`run_ladder` retries a failing phase down a chain of
  :class:`LadderStep`\\ s (each applies solver overrides for the duration
  of its retry) and records every transition as a
  :class:`RecoveryAttempt` through a recorder callback;
- :class:`CaseJournal` persists each completed case of
  ``Model.analyzeCases`` so ``analyzeCases(resume=True)`` re-runs only
  what is missing or failed.

The rungs differ from the JAX package's in one way: none runs the plain
version on the card and none moves work to the CPU.  The JAX package's
host Newton and jnp solve become a plain re-solve on the model's device
(the kernel on the card, the plain version on CPU tensors), which clears
a one-shot fault at exact parity as they do there; its f64 re-solve is
always skipped, the port's pipeline being float64 throughout
(``RAFT_TPU_PRECISION`` narrows only the solve, as in the JAX package).
`JAX_STEP` maps the JAX package's rung names onto the port's.  A
``KernelFailure`` from a kernel's build, load or launch is not retried at
all (``errors.recoverable``).

Knobs, as in the JAX package: ``RAFT_TPU_RECOVERY=0`` turns the ladder and
the quarantine off; ``RAFT_TPU_JOURNAL=0`` turns journaling off;
``RAFT_TPU_JOURNAL_DIR`` moves the journal (default
``~/.cache/raft_tpu_torch/journal``, apart from the JAX package's);
``RAFT_TPU_JOURNAL_MAX_MODELS`` bounds the per-model directories kept
(default 16, 0 = unbounded).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import pickle
import threading

import numpy as np

from raft_tpu_torch import _config, errors

_LOG = logging.getLogger("raft_tpu_torch.recovery")


def enabled() -> bool:
    """Automatic recovery (ladder + quarantine) active?  The programmatic
    override beats ``RAFT_TPU_RECOVERY``; default on."""
    return _config.recovery_mode() != "0"


def journal_enabled() -> bool:
    return os.environ.get("RAFT_TPU_JOURNAL", "1").strip() != "0"


def journal_dir() -> str:
    return (os.environ.get("RAFT_TPU_JOURNAL_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "raft_tpu_torch", "journal"))


# ---------------------------------------------------------------------------
# solver overrides read by the retry targets
# ---------------------------------------------------------------------------

_OVR_LOCK = threading.Lock()
_OVERRIDES: dict[str, float] = {}


@contextlib.contextmanager
def override(**kw):
    """Apply ladder-step solver overrides (``clip_scale``, ``fp_relax``,
    ``fp_iter_mult``) for the duration of a retry; the solvers read them
    through :func:`current`."""
    with _OVR_LOCK:
        saved = dict(_OVERRIDES)
        _OVERRIDES.update(kw)
    try:
        yield
    finally:
        with _OVR_LOCK:
            _OVERRIDES.clear()
            _OVERRIDES.update(saved)


def current(name: str, default):
    with _OVR_LOCK:
        return _OVERRIDES.get(name, default)


def relax_weights(relax) -> tuple[float, float]:
    """(keep, relax) weights of the drag fixed point's under-relaxation
    ``keep*XiLast + relax*Xin``.  The default 0.8 keeps the literal 0.2
    complement (``1.0 - 0.8`` is ``0.19999...96`` in float64, and the
    golden parity is bitwise), for every solve path."""
    relax = float(relax)
    return (0.2 if relax == 0.8 else 1.0 - relax), relax


# ---------------------------------------------------------------------------
# attempts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryAttempt:
    """One ladder transition: ``phase`` failed under ``step_from`` and was
    retried under ``step_to`` with ``outcome`` recovered / failed."""

    phase: str
    case: str
    step_from: str
    step_to: str
    outcome: str            # recovered | failed
    error: str              # class name of the failure that caused it
    detail: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def record_attempt(attempt: RecoveryAttempt, recorder=None):
    """Count ``attempt`` in ``raft_tpu_recovery_attempts_total{phase,
    from,to,outcome}``, stream it to the flight recorder as a
    ``recovery`` event, hand it to ``recorder`` (when given) and log
    it."""
    try:
        from raft_tpu_torch import obs
        obs.counter(
            "raft_tpu_recovery_attempts_total",
            "degradation-ladder retries by phase, from/to step, and "
            "outcome").inc(1.0, phase=attempt.phase,
                           **{"from": attempt.step_from,
                              "to": attempt.step_to},
                           outcome=attempt.outcome)
        obs.events.emit("recovery", **attempt.to_dict())
    except Exception:                                 # pragma: no cover
        pass
    if recorder is not None:
        recorder(attempt)
    log = _LOG.warning if attempt.outcome == "failed" else _LOG.info
    log("recovery[%s case=%s]: %s -> %s (%s) after %s%s",
        attempt.phase, attempt.case, attempt.step_from, attempt.step_to,
        attempt.outcome, attempt.error,
        f": {attempt.detail}" if attempt.detail else "")


# ---------------------------------------------------------------------------
# ladder steps and the engine
# ---------------------------------------------------------------------------

class SkipStep(Exception):
    """Raised by a step's context factory when the step does not apply."""


@dataclasses.dataclass
class LadderStep:
    name: str
    ctx_factory: object      # () -> context manager (may raise SkipStep)


def _ctx_damped():
    return override(clip_scale=0.2)


def _ctx_damped_restart():
    return override(fp_relax=0.5, fp_iter_mult=2)


def _ctx_f64_resolve():
    raise SkipStep("the port's pipeline is float64")


def statics_ladder() -> list[LadderStep]:
    """configured -> the same Newton again -> the Newton with its step
    clip scaled by 0.2, all on the model's device."""
    return [LadderStep("configured", contextlib.nullcontext),
            LadderStep("re_solve", contextlib.nullcontext),
            LadderStep("damped", _ctx_damped)]


def dynamics_ladder() -> list[LadderStep]:
    """configured -> the configured dispatch again (the kernel on the
    card) -> a damped fixed-point restart (under-relaxation 0.5, twice
    the iteration budget) -> the f64 re-solve, always skipped (kept so
    the sequences match the JAX package's)."""
    return [LadderStep("configured", contextlib.nullcontext),
            LadderStep("re_solve", contextlib.nullcontext),
            LadderStep("damped_restart", _ctx_damped_restart),
            LadderStep("f64_resolve", _ctx_f64_resolve)]


#: the JAX package's rung names -> the port's (``raft_tpu/recovery.py``
#: statics and dynamics ladders, ``raft_tpu/parallel/sweep.py``'s lanes)
JAX_STEP = {"configured": "configured", "host_statics": "re_solve",
            "host_statics_damped": "damped", "jnp_solve": "re_solve",
            "damped_restart": "damped_restart",
            "f64_resolve": "f64_resolve", "batched": "batched",
            "re_solve": "re_solve"}


def run_ladder(phase: str, case: str, fn, steps: list[LadderStep],
               recorder=None):
    """Run ``fn`` down ``steps`` until one succeeds.

    The first step is the as-configured attempt.  A recoverable failure
    (``errors.recoverable``) moves to the next applicable step, and every
    transition is recorded; any other exception — a kernel that failed to
    build, load or launch among them — propagates at once.  Exhausting
    the ladder re-raises the last failure.  With recovery disabled the
    first attempt runs bare."""
    if not enabled():
        return fn()
    last_err = None
    failed_step = None
    for step in steps:
        try:
            ctx = step.ctx_factory()
        except SkipStep:
            continue
        try:
            with ctx:
                result = fn()
        except errors.RECOVERABLE as e:
            if not errors.recoverable(e):
                raise
            if last_err is not None:
                record_attempt(RecoveryAttempt(
                    phase=phase, case=str(case),
                    step_from=failed_step, step_to=step.name,
                    outcome="failed", error=type(last_err).__name__,
                    detail=str(e)[:200]), recorder)
            last_err, failed_step = e, step.name
            continue
        if last_err is not None:
            record_attempt(RecoveryAttempt(
                phase=phase, case=str(case), step_from=failed_step,
                step_to=step.name, outcome="recovered",
                error=type(last_err).__name__), recorder)
        return result
    raise last_err


# ---------------------------------------------------------------------------
# per-case resume journal
# ---------------------------------------------------------------------------

class CaseJournal:
    """Per-case completion journal for ``Model.analyzeCases``.

    One pickle per completed case under
    ``<journal_dir>/<key>/case<N>.pkl`` holding the case's metrics, its
    mean offset, its solver record and the carry one case hands the next
    (the stale-heading quirk, a pending mean drift, an array's free
    points), all on the host, so a resumed run reproduces a continuous
    one.  The key covers the FOWT models, an array's shared mooring, the
    case table, the frequency grid, the solver settings, the precision
    mode and the device type:
    the kernels and their plain versions differ at rounding, so a journal
    written on the CPU never resumes on the card, nor the reverse."""

    def __init__(self, key: str, base_dir: str = None):
        self.key = key
        self.dir = os.path.join(base_dir or journal_dir(), key)

    @classmethod
    def for_model(cls, model, base_dir: str = None) -> "CaseJournal":
        from raft_tpu_torch.parallel import exec_cache

        digest = exec_cache.model_digest({
            "fowts": model.fowtList,
            "array_mooring": model.arr_ms,
            "cases": model.design.get("cases"),
            "w": np.asarray(model.w),
            "nFOWT": model.nFOWT,
            "mooring_currentMod": model.mooring_currentMod,
            "nIter": model.nIter,
            "XiStart": model.XiStart,
            "precision": [_config.precision_mode(),
                          _config.precision_width(),
                          _config.precision_tol()],
            "device": model.device.type,
        })
        j = cls(digest.removeprefix("sha256:")[:32], base_dir=base_dir)
        prune_journals(base_dir or journal_dir(), keep=j.key)
        return j

    def _path(self, iCase: int) -> str:
        return os.path.join(self.dir, f"case{int(iCase)}.pkl")

    def load_case(self, iCase: int) -> dict | None:
        """The journaled record of a completed case, or None.  A missing
        entry is a miss; a torn or malformed one is deleted, counted
        (``raft_tpu_journal_corrupt_total{kind="case"}``) and read as a miss — it never
        raises into the resume path."""
        from raft_tpu_torch.obs import journalio

        path = self._path(iCase)
        try:
            with open(path, "rb") as f:
                doc = pickle.load(f)
        except OSError:
            return None
        except Exception:
            _LOG.warning("journal: corrupt entry %s, deleted", path)
            journalio.count_corrupt("case")
            with contextlib.suppress(OSError):
                os.remove(path)
            return None
        if not isinstance(doc, dict) or doc.get("iCase") != int(iCase):
            _LOG.warning("journal: malformed entry %s, ignored", path)
            journalio.count_corrupt("case")
            return None
        return doc

    def store_case(self, iCase: int, record: dict):
        """Persist one completed case atomically (never raises: a
        read-only file system must not fail the run)."""
        from raft_tpu_torch.obs import journalio

        try:
            os.makedirs(self.dir, exist_ok=True)
            journalio.fsync_write(self._path(iCase), pickle.dumps(
                {"iCase": int(iCase), **record},
                protocol=pickle.HIGHEST_PROTOCOL))
        except Exception as e:
            _LOG.warning("journal: could not store case %d: %s", iCase, e)

    def completed(self) -> list[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("case") and n.endswith(".pkl"):
                with contextlib.suppress(ValueError):
                    out.append(int(n[4:-4]))
        return sorted(out)

    def clear(self):
        for i in self.completed():
            with contextlib.suppress(OSError):
                os.remove(self._path(i))


def journal_max_models() -> int:
    """Bound on the per-model journal directories kept (newest first;
    ``RAFT_TPU_JOURNAL_MAX_MODELS``, default 16, 0 = unbounded)."""
    try:
        return int(os.environ.get("RAFT_TPU_JOURNAL_MAX_MODELS", "16"))
    except ValueError:
        return 16


def prune_journals(base_dir: str, keep: str = None):
    """Delete the oldest per-model journal directories so that at most
    ``journal_max_models()`` remain, counting the one being opened
    (``keep``, never pruned).  Runs when a journal opens; never raises."""
    bound = journal_max_models()
    if bound <= 0:
        return
    try:
        entries = [(e.path, e.stat().st_mtime) for e in os.scandir(base_dir)
                   if e.is_dir() and e.name != keep]
    except OSError:
        return
    for path, _ in sorted(entries, key=lambda t: t[1])[:max(
            0, len(entries) + 1 - bound)]:
        with contextlib.suppress(OSError):
            for name in os.listdir(path):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(path, name))
            os.rmdir(path)
