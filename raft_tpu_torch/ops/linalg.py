"""Complex solves through the real block embedding, and their dispatch.

Port of ``raft_tpu/ops/linalg.py``.  The frequency-domain
impedance solves Z X = F run through the real 2n x 2n embedding

    [Re Z  -Im Z] [Re X]   [Re F]
    [Im Z   Re Z] [Im X] = [Im F]

because that is what the hand-written Gauss-Jordan kernels solve.

Dispatch rule (written out here and in PERF.md):

- every real-embedded system with 2n <= 16 goes to the Gauss-Jordan
  kernels of ``ops/kernels/gj_solve.py``, whatever the batch size: on a
  CUDA tensor the hand-written CUDA kernel (K1 fused impedance solve, K2
  batched solve; K3/K4 under the mixed ladder), on a CPU tensor their
  plain PyTorch versions.  The JAX package's batch >= 4096 threshold came
  from the TPU's LU custom call and has nothing behind it on the H100;
- 2n > 16 goes to ``torch.linalg.solve`` (LU), as the JAX package runs
  those sizes outside any Pallas kernel: the system solve of a farm,
  (nw, 6N, 6N) complex, 24 or 48 real rows for 2 or 4 FOWTs;
- there is no knob that sends a CUDA tensor to the plain version or to
  ``torch.linalg.solve``, and no fallback when a build or a launch fails:
  the wrapper raises ``KernelFailure``.

Precision (``RAFT_TPU_PRECISION``, read at every dispatch, as
``raft_tpu/ops/linalg.py:_precision_plan``):

- ``f64`` (default): the solve at the input width;
- ``mixed``: the ladder kernels with ``refine=2``, eliminating at
  ``RAFT_TPU_PRECISION_WIDTH`` and promoting lanes past
  ``RAFT_TPU_PRECISION_TOL``; a request whose width does not narrow the
  input degenerates to the native solve and is recorded as such;
- ``f32``: the solve cast down to float32 (K1/K2's float32
  instantiation), the result cast back up.

For 2n > 16 the same modes run around LU (``raft_tpu/ops/linalg.py:
_solve_real_embedded``'s LU branch): ``f32`` casts down, solves with
LU (``torch.linalg.solve_ex``) and casts back up; ``mixed`` runs the batch-first
ladder `_mixed_ladder` with LU at the low width
(LAPACK has no bfloat16 LU: a bf16 low rung eliminates with `_gj_core`,
the JAX package's jnp Gauss-Jordan core, outside any kernel) and
re-solves the promoted lanes in float64 by LU.

Every decision is recorded for ``last_dispatch()`` and counted in
``raft_solve_dispatch_total{backend,n,fused}``; the ladder's host reads
(the promoted count, the promotion mask) are counted pulls
(``obs.transfers.device_get``).

Differentiation (``raft_tpu/ops/linalg.py:453-517``, the JAX package's
``custom_vjp``): ``impedance_solve`` is the `torch.autograd.Function`
`ImpedanceSolve`.  Its forward is the dispatch above, run without a
graph, so the plain version is never differentiated natively; its
backward is ONE adjoint impedance solve through the same dispatch (K1 on
the card, K3 under ``mixed``, the plain version on the CPU, LU above
2n > 16), recorded with ``adjoint: True`` in ``last_dispatch()``.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from raft_tpu_torch import _config
from raft_tpu_torch._config import COMPLEX, as_real
from raft_tpu_torch.obs import metrics as _metrics, transfers
from raft_tpu_torch.ops import precision as _prec
from raft_tpu_torch.ops.kernels.gj_solve import (
    gj_solve, gj_solve_plain, impedance_gj_solve)
from raft_tpu_torch.testing import faults

#: largest real-embedded system size the Gauss-Jordan kernels take
_GJ_MAX_N = 16

_LAST_DISPATCH: dict = {}

#: set while `ImpedanceSolve.backward` solves: the dispatch it records is
#: an adjoint solve.  Thread-local, as the JAX package's flag: PyTorch runs
#: a CUDA backward on its own device thread, and a solve of another thread
#: in the meantime is no adjoint.
_ADJOINT = threading.local()

_COMPLEX_OF = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def gauss_jordan_solve(A, b, refine: int = 1):
    """Solve real A (..., n, n) x = b (..., n, k) by Gauss-Jordan
    elimination with row equilibration, partial pivoting and ``refine``
    residual re-solves — the plain path, the algorithm of the kernels."""
    return gj_solve_plain(A, b, refine)


def _gj_core(Af, bf, n, k):
    """Gauss-Jordan elimination with partial pivoting of Af (B, n, n),
    bf (B, n, k) at their own dtype, one batch-wide step per pivot: the
    counterpart of ``raft_tpu/ops/linalg.py:_gj_core`` (a jnp function
    outside any Pallas kernel), which the ladder around LU runs for a
    bfloat16 low rung.  Af must be equilibrated."""
    M = torch.cat([Af, bf], dim=-1).movedim(0, -1)       # (n, n+k, B)
    rows = torch.arange(n, device=Af.device)
    ninf = torch.tensor(-float("inf"), dtype=M.dtype, device=M.device)
    for kk in range(n):
        col = M[:, kk, :]                                  # (n, B)
        mag = torch.where((rows >= kk)[:, None], torch.abs(col), ninf)
        p = torch.argmax(mag, dim=0)                       # (B,)
        sel = (rows[:, None] == p[None, :]).to(M.dtype)    # (n, B)
        ek = (rows == kk).to(M.dtype)                      # (n,)
        pivrow = torch.sum(sel[:, None, :] * M, dim=0)     # (n+k, B)
        rowk = M[kk, :, :]
        # swap rows kk <-> p (a no-op when p == kk)
        M = (M + ek[:, None, None] * (pivrow - rowk)[None, :, :]
             + sel[:, None, :] * (rowk - pivrow)[None, :, :])
        piv = pivrow[kk, :]
        rowk_n = pivrow / piv[None, :]
        colk = M[:, kk, :] * (1.0 - ek)[:, None]          # not the pivot row
        M = M - colk[:, None, :] * rowk_n[None, :, :]
        M = torch.cat([M[:kk], rowk_n[None], M[kk + 1:]], dim=0)
    return M[:, n:, :].movedim(-1, 0)                      # (B, n, k)


def _mixed_ladder(A, b, core_low, core_hi, refine, factor_dtype, tol):
    """The batch-first mixed-precision ladder around LU (``raft_tpu/ops/
    linalg.py:_mixed_ladder``): equilibrate rows at the input width,
    solve at ``factor_dtype`` through ``core_low(Af, rhs_f)``, take
    ``refine`` residual corrections at the input width, then re-solve
    every lane whose max relative residual is not within ``tol`` at the
    input width through ``core_hi`` on masked identity systems — a pass
    that is skipped when no lane promotes (one host read of the count).

    A (B, n, n), b (B, n, k); returns (x, {"promoted", "lanes",
    "resid_max"})."""
    B, n, _ = A.shape
    eps = _prec.equilibration_eps(A.dtype)
    scale = 1.0 / torch.clamp(torch.amax(torch.abs(A), dim=-1, keepdim=True),
                              min=eps)
    As = A * scale
    bs = b * scale
    Af = As.to(factor_dtype)
    x = core_low(Af, bs.to(factor_dtype)).to(A.dtype)
    for _ in range(refine):
        r = bs - torch.einsum("bij,bjk->bik", As, x)
        x = x + core_low(Af, r.to(factor_dtype)).to(A.dtype)
    r = bs - torch.einsum("bij,bjk->bik", As, x)
    rn = (torch.amax(torch.abs(r), dim=(-2, -1))
          / (torch.amax(torch.abs(bs), dim=(-2, -1)) + eps))   # (B,)
    mask, promoted = _prec.promotion_mask(rn, tol)
    # the promoted count in one counted pull
    if int(transfers.device_get(promoted, what="promotion_count")) > 0:
        m = mask[:, None, None]
        eye = torch.eye(n, dtype=As.dtype, device=As.device).expand_as(As)
        xh = core_hi(torch.where(m, As, eye),
                     torch.where(m, bs, torch.zeros((), dtype=bs.dtype,
                                                    device=bs.device)))
        x = torch.where(m, xh, x)
    return x, {"promoted": promoted, "lanes": B, "resid_max": torch.amax(rn)}


def _solve_lu(M, rhs, n2, batch_elems, plan):
    """The LU branch (2n > 16) under every precision mode."""
    in_dtype = M.dtype
    _record = lambda stats=None: _record_dispatch(  # noqa: E731
        "lu", None, n2, batch_elems, False, M.device, plan, stats)
    if plan["factor"] is not None:
        k = rhs.shape[-1]
        batch = M.shape[:-2]
        Bn = math.prod(batch)
        low = _solve_unchecked if plan["factor"] != torch.bfloat16 \
            else (lambda a, r: _gj_core(a, r, n2, k))
        x, stats = _mixed_ladder(
            M.reshape(Bn, n2, n2), rhs.reshape(Bn, n2, k), low,
            torch.linalg.solve, refine=2, factor_dtype=plan["factor"],
            tol=plan["tol"])
        _record(stats)
        return x.reshape(*batch, n2, k)
    _record()
    if plan["cast"] is not None:
        return _solve_unchecked(M.to(plan["cast"]),
                                rhs.to(plan["cast"])).to(in_dtype)
    return torch.linalg.solve(M, rhs)


def _solve_unchecked(A, b):
    """LU solve at a low width that, like ``jnp.linalg.solve``, returns
    non-finite values for a lane that is singular at that width instead of
    raising: the ladder then promotes the lane (its residual is NaN)."""
    return torch.linalg.solve_ex(A, b)[0]


def last_dispatch() -> dict:
    """Most recent solve dispatch: ``{"backend", "kernel", "n",
    "batch_elems", "fused", "device", "precision", "solve_width",
    "factor_width", "promote_tol"}``, plus ``adjoint: True`` for the
    adjoint solve of `ImpedanceSolve.backward`, ``precision_degenerate``
    for a mixed request that could not narrow, and under the mixed ladder the
    promotion stats ``promoted``, ``lanes``, ``resid_max`` (``promoted``
    and ``resid_max`` are tensors on the solve's device, read without a
    sync); empty before any solve."""
    return dict(_LAST_DISPATCH)


def _precision_plan(dtype) -> dict:
    """Resolve the ambient ``RAFT_TPU_PRECISION`` request against the
    (real-embedded) solve dtype: the dispatch facts plus ``factor`` (the
    elimination dtype of the mixed ladder, or None), ``cast`` (float32
    under ``f32``, or None) and ``tol``."""
    mode = _config.precision_mode()
    plan = {"mode": mode, "solve_width": _prec.width_name(dtype),
            "factor": None, "factor_width": None, "cast": None,
            "tol": None}
    if mode == "mixed":
        fd = _prec.factor_dtype(_config.precision_width())
        if _prec.narrows(fd, dtype):
            plan.update(factor=fd, factor_width=_prec.width_name(fd),
                        tol=_config.precision_tol())
        else:
            plan["degenerate"] = True
    elif mode == "f32" and dtype != torch.float32:
        plan.update(cast=torch.float32, solve_width="f32")
    return plan


def _record_dispatch(backend, kernel, n, batch_elems, fused, device,
                     plan=None, stats=None):
    # cleared, not merged: a later single-width dispatch must not keep an
    # earlier mixed dispatch's facts
    _LAST_DISPATCH.clear()
    _LAST_DISPATCH.update(backend=backend, kernel=kernel, n=int(n),
                          batch_elems=int(batch_elems), fused=bool(fused),
                          device=str(device))
    if getattr(_ADJOINT, "active", False):
        _LAST_DISPATCH["adjoint"] = True
    _metrics.record_solve_dispatch(backend, n, batch_elems, fused)
    if plan is not None:
        _LAST_DISPATCH.update(
            precision=plan["mode"], solve_width=plan["solve_width"],
            factor_width=plan["factor_width"], promote_tol=plan["tol"])
        if plan.get("degenerate"):
            _LAST_DISPATCH["precision_degenerate"] = True
    if stats is not None:
        _LAST_DISPATCH.update(promoted=stats["promoted"],
                              lanes=int(stats["lanes"]),
                              resid_max=stats["resid_max"])


def _kernel_name(base, plan):
    if plan["factor"] is not None:
        return f"{base}_mixed" if plan["factor_width"] == "f32" \
            else f"{base}_mixed_{plan['factor_width']}"
    return f"{base}_f32" if plan["cast"] is not None else base


def _solve_real_embedded(M, rhs, n2, batch_elems):
    """Solve the real-embedded M x = rhs under the active precision mode;
    returns x at the input width."""
    in_dtype = M.dtype
    plan = _precision_plan(in_dtype)
    if n2 > _GJ_MAX_N:
        return _solve_lu(M, rhs, n2, batch_elems, plan)
    backend = "cuda_gj" if M.device.type == "cuda" else "plain_gj"
    kernel = _kernel_name("gj_solve", plan)
    if plan["factor"] is not None:
        x, stats = gj_solve(M, rhs, refine=2, precision="mixed",
                            factor_dtype=plan["factor"],
                            promote_tol=plan["tol"], return_stats=True)
        _record_dispatch(backend, kernel, n2, batch_elems, False, M.device,
                         plan, stats)
        return x
    if plan["cast"] is not None:
        M = M.to(plan["cast"])
        rhs = rhs.to(plan["cast"])
    _record_dispatch(backend, kernel, n2, batch_elems, False, M.device, plan)
    return gj_solve(M, rhs).to(in_dtype)


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

    2n <= 16 goes to the fused impedance kernel (K1; K3 under the mixed
    ladder), which assembles the embedding itself; larger systems
    assemble Z and solve by LU (the ladder around LU under mixed).

    Differentiable in all five inputs through `ImpedanceSolve`: its
    backward is one adjoint solve through this same dispatch.

    The ``kernel`` fault seam sits before any launch: ``raise@kernel``
    raises an injected ``KernelFailure`` and the call launches
    nothing (the adjoint solve's seam too)."""
    return ImpedanceSolve.apply(as_real(w, M.device), M, B, C, F)


def _unbroadcast(x, shape):
    """Sum a gradient down to its input's (broadcast) shape
    (``raft_tpu/ops/linalg.py:_unbroadcast``)."""
    if tuple(x.shape) == tuple(shape):
        return x
    extra = x.ndim - len(shape)
    if extra > 0:
        x = torch.sum(x, dim=tuple(range(extra)))
    dims = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b)
    if dims:
        x = torch.sum(x, dim=dims, keepdim=True)
    return x.reshape(shape)


@contextlib.contextmanager
def _adjoint_scope():
    prev = getattr(_ADJOINT, "active", False)
    _ADJOINT.active = True
    try:
        yield
    finally:
        _ADJOINT.active = prev


class ImpedanceSolve(torch.autograd.Function):
    """`impedance_solve` with the JAX package's implicit adjoint
    (``raft_tpu/ops/linalg.py:_impedance_solve_bwd``).

    PyTorch's gradient of a complex tensor is the conjugate of JAX's
    cotangent.  For X = Z^-1 F and an incoming gradient G the backward
    solves Z^H lam = G, Z^H = -w^2 M^T - i w B^T + C^T: the same kernel on
    (w, M^T, -B^T, C^T), whose transposes and negation are materialized
    before the launch (by the wrapper's ``contiguous``).  Then
    Zbar = -lam X^H per frequency, and the real inputs take JAX's
    gradients: M -w^2 Re Zbar, B w Im Zbar, C the frequency sum of
    Re Zbar, w Re sum(conj(Zbar) (-2 w M + i B)); F takes lam, the
    conjugate of JAX's cotangent.  Each is summed down to its input's
    shape (a shared M, B or C gets the sum over the lanes)."""

    @staticmethod
    def forward(w, M, B, C, F):
        return _impedance_solve_impl(w, M, B, C, F)

    @staticmethod
    def setup_context(ctx, inputs, output):
        w, M, B, C, _ = inputs
        ctx.save_for_backward(w, M, B, C, output)
        ctx.shapes = [tuple(t.shape) for t in inputs]

    @staticmethod
    def backward(ctx, Xbar):
        need = ctx.needs_input_grad
        if not any(need):
            return (None,) * 5
        w, M, B, C, X = ctx.saved_tensors
        with _adjoint_scope():
            lam = _impedance_solve_impl(
                w, M.transpose(-3, -2), -B.transpose(-3, -2),
                C.transpose(-2, -1), Xbar.resolve_conj())
        Zbar = -lam[..., :, None, :] * X.conj()[..., None, :, :]
        sw, sM, sB, sC, sF = ctx.shapes
        gw = gM = gB = gC = gF = None
        if need[0]:
            dZ = -2.0 * w * M + 1j * B
            gw = _unbroadcast(torch.sum(
                torch.real(Zbar.conj() * dZ),
                dim=tuple(range(Zbar.ndim - 1))), sw)
        if need[1]:
            gM = _unbroadcast(-w ** 2 * Zbar.real, sM)
        if need[2]:
            gB = _unbroadcast(w * Zbar.imag, sB)
        if need[3]:
            gC = _unbroadcast(torch.sum(Zbar.real, dim=-1), sC)
        if need[4]:
            gF = _unbroadcast(lam, sF)
        return gw, gM, gB, gC, gF


def _impedance_solve_impl(w, M, B, C, F):
    """The dispatch of `impedance_solve`, without a graph."""
    faults.maybe_raise("kernel")
    n = M.shape[-3]
    nw = M.shape[-1]
    batch_elems = math.prod(torch.broadcast_shapes(
        M.shape[:-3], B.shape[:-3], C.shape[:-2], F.shape[:-2])) * nw
    w = as_real(w, M.device)
    in_dtype = M.dtype
    plan = _precision_plan(in_dtype)
    if 2 * n > _GJ_MAX_N:
        Z = (-w ** 2 * M + 1j * w * B + C[..., None]).to(COMPLEX)
        Xin = solve_complex(Z.movedim(-1, -3), F.movedim(-1, -2))
        return Xin.movedim(-2, -1)
    backend = "cuda_fused" if M.device.type == "cuda" else "plain_fused"
    kernel = _kernel_name("impedance_gj", plan)
    if plan["factor"] is not None:
        X, stats = impedance_gj_solve(
            w, M, B, C, F, refine=2, precision="mixed",
            factor_dtype=plan["factor"], promote_tol=plan["tol"],
            return_stats=True)
        _record_dispatch(backend, kernel, 2 * n, batch_elems, True,
                         M.device, plan, stats)
        return X
    _record_dispatch(backend, kernel, 2 * n, batch_elems, True, M.device,
                     plan)
    if plan["cast"] is not None:
        c = plan["cast"]
        X = impedance_gj_solve(w.to(c), M.to(c), B.to(c), C.to(c),
                               F.to(_COMPLEX_OF[c]))
        return X.to(_COMPLEX_OF[in_dtype])
    return impedance_gj_solve(w, M, B, C, F)
