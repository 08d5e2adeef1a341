"""Dtypes, device resolution and the knobs of the PyTorch port.

Everything the port computes is float64 / complex128 (the H100 has native
FP64).  ``torch.get_default_dtype()`` stays float32 and is never changed:
every tensor the package creates names its dtype through these helpers.
"""
from __future__ import annotations

import os

import numpy as np
import torch

REAL = torch.float64
COMPLEX = torch.complex128


def real_dtype():
    return REAL


def complex_dtype():
    return COMPLEX


def as_real(x, device=None):
    """``x`` as a float64 tensor (on ``device`` when given; a tensor
    already there is returned as is).  A host value goes to the card
    without a host-side wait (see `to_device`)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=REAL) if device is not None \
            else x.to(dtype=REAL)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return to_device(torch.as_tensor(x, dtype=REAL), device)


def to_device(x, device=None, dtype=None):
    """``x`` (a tensor, array, list or number) as a tensor on ``device``
    (at ``dtype`` when given).  A host-to-card copy is issued with
    ``non_blocking=True``: from pageable memory it returns once the
    source has been staged, so the values are the same and the host does
    not wait for the card (a blocking copy is a synchronization, which
    ``obs.transfers.guard`` traps)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if dtype is not None:
        t = t.to(dtype=dtype)
    if device is None or t.device == torch.device(device):
        return t
    return t.to(device, non_blocking=True)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``).  With no CUDA device present that
    raises instead of quietly running on the CPU; pass ``device="cpu"``
    to run the plain PyTorch versions on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "by default — pass device='cpu' to run on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    return dev


# ---------------------------------------------------------------------------
# solve precision ladder (ops/linalg.py, ops/kernels/gj_solve.py)
# ---------------------------------------------------------------------------
#
# The same environment names and parsing as the JAX package, so one
# setting means the same thing in both: RAFT_TPU_PRECISION = "f64"
# (default) | "mixed" | "f32"; RAFT_TPU_PRECISION_WIDTH = "f32" (default)
# | "bf16", the width the mixed ladder eliminates in;
# RAFT_TPU_PRECISION_TOL, the per-lane promotion tolerance (default
# 1e-9).  Read at every solve dispatch; a programmatic override beats the
# environment, unknown values fall back to the default.

_PRECISION_MODES = ("f64", "mixed", "f32")
_PRECISION_WIDTHS = ("f32", "bf16")
_PRECISION_TOL_DEFAULT = 1e-9
_precision_override: str | None = None
_precision_width_override: str | None = None


def precision_mode() -> str:
    """Active solve-precision mode ("f64" | "mixed" | "f32")."""
    if _precision_override is not None:
        return _precision_override
    mode = os.environ.get("RAFT_TPU_PRECISION", "f64").strip().lower()
    return mode if mode in _PRECISION_MODES else "f64"


def set_precision_mode(mode: str | None):
    """Override the solve-precision mode in-process (None clears)."""
    global _precision_override
    if mode is not None and str(mode) not in _PRECISION_MODES:
        raise ValueError(
            f"precision mode {mode!r} not in {_PRECISION_MODES}")
    _precision_override = None if mode is None else str(mode)


def precision_width() -> str:
    """Active mixed-ladder elimination width ("f32" | "bf16")."""
    if _precision_width_override is not None:
        return _precision_width_override
    w = os.environ.get("RAFT_TPU_PRECISION_WIDTH", "f32").strip().lower()
    return w if w in _PRECISION_WIDTHS else "f32"


def set_precision_width(width: str | None):
    """Override the mixed-ladder elimination width (None clears)."""
    global _precision_width_override
    if width is not None and str(width) not in _PRECISION_WIDTHS:
        raise ValueError(
            f"precision width {width!r} not in {_PRECISION_WIDTHS}")
    _precision_width_override = None if width is None else str(width)


def precision_tol() -> float:
    """Per-lane promotion tolerance of the mixed ladder
    (``RAFT_TPU_PRECISION_TOL``, default 1e-9); non-numeric values fall
    back to the default."""
    raw = os.environ.get("RAFT_TPU_PRECISION_TOL", "")
    try:
        return float(raw) if raw.strip() else _PRECISION_TOL_DEFAULT
    except ValueError:
        return _PRECISION_TOL_DEFAULT


# ---------------------------------------------------------------------------
# automatic recovery (recovery.py ladder + model.py case quarantine)
# ---------------------------------------------------------------------------
#
# RAFT_TPU_RECOVERY, as in the JAX package: "1" (default) — a recoverable
# solver failure walks the degradation ladder and a case the ladder cannot
# save is quarantined while the others run; "0" — the first failure
# propagates out of analyzeCases / sweep_cases unchanged.

_RECOVERY_MODES = ("0", "1")
_recovery_override: str | None = None


def recovery_mode() -> str:
    """Active recovery mode ("0" | "1"); a programmatic override beats the
    ``RAFT_TPU_RECOVERY`` environment variable."""
    if _recovery_override is not None:
        return _recovery_override
    mode = os.environ.get("RAFT_TPU_RECOVERY", "1").strip().lower()
    if mode in ("off", "false"):
        mode = "0"
    return mode if mode in _RECOVERY_MODES else "1"


def set_recovery_mode(mode: str | None):
    """Override the recovery mode in-process (None clears)."""
    global _recovery_override
    if mode is not None and str(mode) not in _RECOVERY_MODES:
        raise ValueError(f"recovery mode {mode!r} not in {_RECOVERY_MODES}")
    _recovery_override = None if mode is None else str(mode)


# ---------------------------------------------------------------------------
# solver-health telemetry placement (model.py solveDynamics)
# ---------------------------------------------------------------------------
#
# RAFT_TPU_TELEMETRY, as in the JAX package: "fast" (default) computes the
# impedance condition estimate on the device (``torch.linalg.cond``) and
# pulls two scalars; "full" pulls the whole (nw, 6N, 6N) impedance stack
# to the host and runs ``np.linalg.cond`` there.

_TELEMETRY_MODES = ("fast", "full")
_telemetry_override: str | None = None


def telemetry_mode() -> str:
    """Active telemetry placement ("fast" | "full"); a programmatic
    override beats ``RAFT_TPU_TELEMETRY``, unknown values fall back to
    "fast"."""
    if _telemetry_override is not None:
        return _telemetry_override
    mode = os.environ.get("RAFT_TPU_TELEMETRY", "fast").strip().lower()
    return mode if mode in _TELEMETRY_MODES else "fast"


def set_telemetry_mode(mode: str | None):
    """Override the telemetry placement in-process (None clears)."""
    global _telemetry_override
    if mode is not None and str(mode) not in _TELEMETRY_MODES:
        raise ValueError(
            f"telemetry mode {mode!r} not in {_TELEMETRY_MODES}")
    _telemetry_override = None if mode is None else str(mode)


# ---------------------------------------------------------------------------
# probes (obs/probes.py)
# ---------------------------------------------------------------------------
#
# RAFT_TPU_PROBES, as in the JAX package: "off" — no probe records
# anything; "sampled" (default) — the statics Newton, each drag pass and
# each sweep batch record the host values their sanctioned pulls already
# brought back; "full" — also the sites tagged level="full".  A probe
# never pulls anything itself.

_PROBE_MODES = ("off", "sampled", "full")
_probes_override: str | None = None


def probes_mode() -> str:
    """Active probe mode ("off" | "sampled" | "full"); a programmatic
    override beats ``RAFT_TPU_PROBES``, unknown values fall back to
    "sampled"."""
    if _probes_override is not None:
        return _probes_override
    mode = os.environ.get("RAFT_TPU_PROBES", "sampled").strip().lower()
    if mode in ("0", "false"):
        mode = "off"
    return mode if mode in _PROBE_MODES else "sampled"


def set_probes_mode(mode: str | None):
    """Override the probe mode in-process (None clears)."""
    global _probes_override
    if mode is not None and str(mode) not in _PROBE_MODES:
        raise ValueError(f"probes mode {mode!r} not in {_PROBE_MODES}")
    _probes_override = None if mode is None else str(mode)


# ---------------------------------------------------------------------------
# batched solve health (parallel/sweep.py)
# ---------------------------------------------------------------------------
#
# RAFT_TPU_HEALTH, as in the JAX package: "0" (default) — the batched
# solve returns its physics alone; "1" — it also returns each lane's
# relative residual and conditioning at the final drag iterate (one more
# drag linearization and impedance solve a batch).

_HEALTH_MODES = ("0", "1")
_health_override: str | None = None


def health_mode() -> str:
    """Active solve-health mode ("0" | "1"); a programmatic override beats
    ``RAFT_TPU_HEALTH``."""
    if _health_override is not None:
        return _health_override
    mode = os.environ.get("RAFT_TPU_HEALTH", "0").strip().lower()
    if mode in ("off", "false"):
        mode = "0"
    if mode in ("on", "true"):
        mode = "1"
    return mode if mode in _HEALTH_MODES else "0"


def set_health_mode(mode: str | None):
    """Override the solve-health mode in-process (None clears)."""
    global _health_override
    if mode is not None and str(mode) not in _HEALTH_MODES:
        raise ValueError(f"health mode {mode!r} not in {_HEALTH_MODES}")
    _health_override = None if mode is None else str(mode)


def health_enabled() -> bool:
    """True when the batched solve-health outputs are on."""
    return health_mode() == "1"


# ---------------------------------------------------------------------------
# observability output (obs/__init__.py, obs/events.py)
# ---------------------------------------------------------------------------
#
# RAFT_TPU_OBS_DIR: where run manifests, traces, ledgers and flight-recorder
# streams are written (unset: nothing is written); RAFT_TPU_OBS_MAX_RUNS:
# the runs kept there (0 / unset: all); RAFT_TPU_EVENTS=0 turns the flight
# recorder off; RAFT_TPU_EVENTS_MAX_BYTES (default 16 MiB) and
# RAFT_TPU_EVENTS_KEEP (default 2) set its size rotation.  The same names
# as the JAX package's.


def obs_dir() -> str | None:
    """``RAFT_TPU_OBS_DIR``, or None when unset or empty."""
    return os.environ.get("RAFT_TPU_OBS_DIR") or None


def obs_max_runs() -> int | None:
    """``RAFT_TPU_OBS_MAX_RUNS`` (None: unbounded or not a number)."""
    try:
        n = int(os.environ.get("RAFT_TPU_OBS_MAX_RUNS", "0"))
    except ValueError:
        return None
    return n or None


def events_enabled() -> bool:
    """False when ``RAFT_TPU_EVENTS=0``."""
    return os.environ.get("RAFT_TPU_EVENTS", "1").strip() != "0"


def events_max_bytes() -> int:
    """``RAFT_TPU_EVENTS_MAX_BYTES``, the size at which an event file
    rotates (default 16 MiB)."""
    try:
        return int(os.environ.get("RAFT_TPU_EVENTS_MAX_BYTES",
                                  str(16 << 20)))
    except ValueError:
        return 16 << 20


def events_keep() -> int:
    """``RAFT_TPU_EVENTS_KEEP``, the rotated generations kept (default
    2)."""
    try:
        return max(0, int(os.environ.get("RAFT_TPU_EVENTS_KEEP", "2")))
    except ValueError:
        return 2
