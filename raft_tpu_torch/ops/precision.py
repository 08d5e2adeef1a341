"""Shared facts of the mixed-precision solve ladder.

Port of ``raft_tpu/ops/precision.py``: the numbers both Gauss-Jordan
implementations (the plain PyTorch versions and the CUDA kernels of
``ops/kernels/gj_solve.py``) must agree on.

- the equilibration underflow floor of the row scale ``1/max|row|``;
- the elimination widths the ladder can drop to
  (``RAFT_TPU_PRECISION_WIDTH``): f32, and bf16, which shares f32's
  exponent and so its floor;
- the promotion predicate: which lanes the full-width pass re-solves.
"""
from __future__ import annotations

import torch

#: elimination widths of the ladder, by RAFT_TPU_PRECISION_WIDTH value
FACTOR_WIDTHS = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


def equilibration_eps(dtype) -> float:
    """Underflow floor for the row-equilibration scale ``1/max|row|``:
    1e-300 in float64; 1e-30 in float32 and bfloat16 (same exponent
    range)."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def factor_dtype(width: str):
    """The torch dtype of a ``RAFT_TPU_PRECISION_WIDTH`` name; unknown
    names give float32 (never silently wider than asked)."""
    return FACTOR_WIDTHS.get(str(width).strip().lower(), torch.float32)


def narrows(factor, solve_dtype) -> bool:
    """True when ``factor`` is strictly narrower than the solve dtype, so
    the mixed ladder has a low rung to drop to."""
    return factor.itemsize < solve_dtype.itemsize


def promotion_mask(rn, tol):
    """``(mask, promoted_count)`` for a vector of per-lane relative
    residuals.  Negated converged, not ``rn > tol``: a lane whose
    low-width elimination overflowed has a NaN residual, and
    ``nan > tol`` is False — that lane must promote."""
    mask = ~(rn <= tol)
    return mask, torch.sum(mask.to(torch.int32))


def width_name(dtype) -> str:
    """Short ladder name of a real dtype ("f64" / "f32" / "bf16")."""
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return "f32"
    return str(dtype).removeprefix("torch.")
