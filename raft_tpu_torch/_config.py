"""Dtypes and device resolution for the PyTorch port.

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
    already there is returned as is)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=REAL) if device is not None \
            else x.to(dtype=REAL)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=REAL, device=device)


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
