"""Complex solves through the real block embedding, and their dispatch.

Port of ``raft_tpu/ops/linalg.py`` (forward only).  The frequency-domain
impedance solves Z X = F run through the real 2n x 2n embedding

    [Re Z  -Im Z] [Re X]   [Re F]
    [Im Z   Re Z] [Im X] = [Im F]

because that is what the hand-written Gauss-Jordan kernels solve.

Dispatch rule (written out here and in PERF.md):

- every real-embedded system with 2n <= 16 goes to the Gauss-Jordan
  kernels of ``ops/kernels/gj_solve.py``, whatever the batch size: on a
  CUDA tensor the hand-written CUDA kernel (K1 fused impedance solve, K2
  batched solve), on a CPU tensor their plain PyTorch versions.  The JAX
  package's batch >= 4096 threshold came from the TPU's LU custom call
  and has nothing behind it on the H100; dropping it puts both kernels on
  the single-case path (nw = 80 lanes for OC3spar);
- 2n > 16 goes to ``torch.linalg.solve`` (LU), as the JAX package runs
  those sizes outside any Pallas kernel;
- there is no knob that sends a CUDA tensor to the plain version or to
  ``torch.linalg.solve``, and no fallback when a build or a launch fails:
  the wrapper raises ``KernelFailure``.

Every decision is recorded for ``last_dispatch()``.
"""
from __future__ import annotations

import math

import torch

from raft_tpu_torch._config import COMPLEX, as_real
from raft_tpu_torch.ops.kernels.gj_solve import (  # noqa: F401
    equilibration_eps, gj_solve, gj_solve_plain, impedance_gj_solve)

#: largest real-embedded system size the Gauss-Jordan kernels take
_GJ_MAX_N = 16

_LAST_DISPATCH: dict = {}


def gauss_jordan_solve(A, b, refine: int = 1):
    """Solve real A (..., n, n) x = b (..., n, k) by Gauss-Jordan
    elimination with row equilibration, partial pivoting and ``refine``
    residual re-solves — the plain path, the algorithm of the kernels."""
    return gj_solve_plain(A, b, refine)


def last_dispatch() -> dict:
    """Most recent solve dispatch: ``{"backend", "kernel", "n",
    "batch_elems", "fused", "device"}``; empty before any solve."""
    return dict(_LAST_DISPATCH)


def _record_dispatch(backend, kernel, n, batch_elems, fused, device):
    _LAST_DISPATCH.clear()
    _LAST_DISPATCH.update(backend=backend, kernel=kernel, n=int(n),
                          batch_elems=int(batch_elems), fused=bool(fused),
                          device=str(device))


def _solve_real_embedded(M, rhs, n2, batch_elems):
    if n2 <= _GJ_MAX_N:
        backend = "cuda_gj" if M.device.type == "cuda" else "plain_gj"
        _record_dispatch(backend, "gj_solve", n2, batch_elems, False,
                         M.device)
        return gj_solve(M, rhs)
    _record_dispatch("lu", None, n2, batch_elems, False, M.device)
    return torch.linalg.solve(M, rhs)


def solve_complex(A, b):
    """Solve complex A (..., n, n) x = b, b (..., n) or (..., n, k), via
    the real block embedding."""
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    Ar, Ai = A.real, A.imag
    M = torch.cat([torch.cat([Ar, -Ai], dim=-1),
                   torch.cat([Ai, Ar], dim=-1)], dim=-2)
    rhs = torch.cat([b.real, b.imag], dim=-2)
    batch_elems = math.prod(A.shape[:-2])
    x = _solve_real_embedded(M, rhs, 2 * n, batch_elems)
    out = torch.complex(x[..., :n, :], x[..., n:, :])
    return out[..., 0] if vec else out


def inv_complex(A):
    """Inverse of complex A (..., n, n) via the real block embedding —
    the factor-once system solve of each case (the reference's Zinv)."""
    n = A.shape[-1]
    eye = torch.broadcast_to(torch.eye(n, dtype=A.dtype, device=A.device),
                             A.shape)
    return solve_complex(A, eye)


def impedance_solve(w, M, B, C, F):
    """Solve [-w^2 M + i w B + C] X(w) = F(w) over the trailing frequency
    axis: w (nw,), M/B (..., n, n, nw), C (..., n, n), F (..., n, nw)
    complex -> X (..., n, nw) complex.

    2n <= 16 goes to the fused impedance kernel (K1), which assembles the
    embedding itself; larger systems assemble Z and solve by LU."""
    n = M.shape[-3]
    nw = M.shape[-1]
    batch_elems = math.prod(M.shape[:-3]) * nw
    w = as_real(w, M.device)
    if 2 * n <= _GJ_MAX_N:
        backend = "cuda_fused" if M.device.type == "cuda" else "plain_fused"
        _record_dispatch(backend, "impedance_gj", 2 * n, batch_elems, True,
                         M.device)
        return impedance_gj_solve(w, M, B, C, F)
    Z = (-w ** 2 * M + 1j * w * B + C[..., None]).to(COMPLEX)
    Xin = solve_complex(Z.movedim(-1, -3), F.movedim(-1, -2))
    return Xin.movedim(-2, -1)
