"""Logging helpers and the flat timing report over :mod:`raft_tpu_torch.obs`.

The port's copy of ``raft_tpu/utils/profiling.py``:

- `get_logger(name)` / `set_verbosity(n)` / `temp_verbosity(n)`:
  namespaced loggers under "raft_tpu_torch"; ``set_verbosity`` maps the
  reference's integer ``display`` levels onto logging levels,
  ``temp_verbosity`` for one block;
- `timed(name)`: a wall-time section, a shim over ``obs.span(name)``;
- `timing_report()` / `print_timing_report()`: the span aggregate
  (``solveStatics``, ``solveDynamics``, ``fowt_linearize``, ...);
- `trace(log_dir)`: a ``torch.profiler`` trace (CPU and, where there is
  one, CUDA activity) written for TensorBoard / Perfetto, in place of the
  JAX package's ``jax.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import logging
import time

from raft_tpu_torch.obs import tracing as _tracing

_ROOT = "raft_tpu_torch"


def get_logger(name: str = "") -> logging.Logger:
    logger = logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s", "%H:%M:%S"))
        root.addHandler(h)
        root.setLevel(logging.WARNING)
    return logger


def set_verbosity(display: int):
    """Map the reference's integer display levels to logging levels
    (0 = warnings only, 1 = info, 2+ = debug)."""
    level = (logging.WARNING if display <= 0
             else logging.INFO if display == 1 else logging.DEBUG)
    get_logger()   # ensure the handler exists (it installs WARNING)
    logging.getLogger(_ROOT).setLevel(level)


@contextlib.contextmanager
def temp_verbosity(display: int):
    """Per-call verbosity override mirroring the reference's ``display``
    arguments: ``display > 0`` raises the raft_tpu_torch logger for the
    block and restores the previous level after; ``display <= 0`` leaves
    the ambient verbosity (a user's ``set_verbosity``) untouched."""
    if display <= 0:
        yield
        return
    root = logging.getLogger(_ROOT)
    prev = root.level
    set_verbosity(display)
    try:
        yield
    finally:
        root.setLevel(prev)


@contextlib.contextmanager
def timed(name: str, logger: logging.Logger = None):
    """Accumulate wall time for a named section (a shim over
    ``obs.span``); optionally log it at DEBUG."""
    t0 = time.perf_counter()
    try:
        with _tracing.span(name):
            yield
    finally:
        (logger or get_logger("timing")).debug(
            "%s: %.4f s", name, time.perf_counter() - t0)


def timing_report(reset: bool = False) -> dict:
    """{section: (total_seconds, calls)} over every finished span."""
    return _tracing.aggregate(reset=reset)


def format_timing_report() -> str:
    """`timing_report` as a table, the costliest section first."""
    rep = timing_report()
    if not rep:
        return "no timed sections recorded"
    width = max(len(k) for k in rep)
    lines = [f"{'section'.ljust(width)}  total [s]   calls   per-call [s]"]
    for k, (tot, n) in sorted(rep.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{k.ljust(width)}  {tot:9.4f}   {n:5d}   "
                     f"{tot / max(n, 1):10.5f}")
    return "\n".join(lines)


def print_timing_report():
    print(format_timing_report())


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity where a card is present), written to ``log_dir`` for
    TensorBoard / Perfetto."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
