"""The Gauss-Jordan solve kernels (K1-K4), their wrappers and their plain
PyTorch versions.

``impedance_gj_solve`` (K1, and K3 under ``precision="mixed"``) replaces
the Pallas kernel ``raft_tpu/ops/pallas/gj_solve.py:impedance_gj_solve``:
it solves [-w^2 M + i w B + C] X = F per (case, frequency) lane through
the real 2n x 2n block embedding, assembled inside the kernel so Z never
exists in memory.  ``gj_solve`` (K2, and K4 under ``precision="mixed"``)
replaces ``gj_solve`` there: the batched real solve A x = b behind
``ops.linalg.solve_complex`` / ``inv_complex``.  Both equilibrate rows by
1/max|row|, eliminate with partial pivoting and refine.

The mixed ladder (K3/K4) eliminates at ``factor_dtype`` (float32 by
default, bfloat16 opt-in) and keeps the residual and correction at
float64 with ``refine`` passes; each lane's final relative residual is
returned, and lanes with ``~(rn <= promote_tol)`` are re-solved at
float64.  float32 inputs run K1/K2's float32 instantiation.

Dispatch: a CUDA tensor launches the hand-written kernel of ``csrc/``
(built at first use, see ``_build.py``) or raises
:class:`~raft_tpu_torch.errors.KernelFailure`; a CPU tensor runs the
plain version below.  There is no other route.  What bounds the kernels
on the card and what their design does about it is written in
``csrc/gj_kernels.cuh``.

The plain versions repeat the TPU kernels' algorithm in their op order,
lane-last like ``_gj_batchlast`` / ``_gj_elim`` (including the
arithmetic row swap, which is why the kernels' exchange — two rows
trading logical positions — agrees with them to rounding, not
bitwise).  They are the CPU path, the tests' reference, and the
yardstick the card's kernels are held against.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from raft_tpu_torch import errors
from raft_tpu_torch.ops.precision import (
    equilibration_eps, promotion_mask, width_name)

#: kernel launches per kernel and width; incremented only where a kernel
#: launches (the K3/K4 keys count the f32 elimination width, the
#: ``_bf16`` keys the bf16 one)
LAUNCHES = {"impedance_gj": 0, "impedance_gj_f32": 0,
            "impedance_gj_mixed": 0, "impedance_gj_mixed_bf16": 0,
            "gj_solve": 0, "gj_solve_f32": 0,
            "gj_solve_mixed": 0, "gj_solve_mixed_bf16": 0}

#: default promotion tolerance of the mixed ladder
DEFAULT_PROMOTE_TOL = 1e-9


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (lane-last, the TPU kernels' op order)
# ---------------------------------------------------------------------------

def _gj_elim(A, rhs):
    """Unrolled Gauss-Jordan with partial pivoting on lane-last blocks:
    A (n, n, B), rhs (n, k, B) -> x (n, k, B), in A's dtype."""
    n = A.shape[0]
    M = torch.cat([A, rhs], dim=1)                       # (n, n+k, B)
    rows = torch.arange(n, device=A.device)[:, None]     # (n, 1)
    for kk in range(n):
        col = M[:, kk, :]
        mag = torch.where(rows >= kk, torch.abs(col), -math.inf)
        p = torch.argmax(mag, dim=0)                     # first maximal row
        sel = (rows == p[None, :]).to(M.dtype)           # (n, B)
        ek = (rows == kk).to(M.dtype)                    # (n, 1)
        pivrow = torch.sum(sel[:, None, :] * M, dim=0)   # (n+k, B)
        rowk = M[kk]
        # arithmetic swap of rows kk <-> p (no-op when p == kk)
        M = (M + ek[:, :, None] * (pivrow - rowk)[None, :, :]
             + sel[:, None, :] * (rowk - pivrow)[None, :, :])
        piv = pivrow[kk]
        rowk_n = pivrow / piv[None, :]
        colk = M[:, kk, :] * (1.0 - ek)
        M = M - colk[:, None, :] * rowk_n[None, :, :]
        M = torch.cat([M[:kk], rowk_n[None], M[kk + 1:]], dim=0)
    return M[:, n:, :]


def _matmul_bl(A, x):
    """A @ x with the batch on the last axis: (n,n,B),(n,k,B)->(n,k,B)."""
    return torch.sum(A[:, :, None, :] * x[None, :, :, :], dim=1)


def _gj_batchlast(A, rhs, refine, factor_dtype=None, resid=False):
    """Equilibrate + eliminate + refine on lane-last blocks.

    ``factor_dtype`` narrower than A's dtype is the mixed ladder: the
    elimination runs at that width on the full-width-equilibrated block
    while the residual ``rhs - A x`` and the correction stay at A's
    width.  ``resid=True`` also returns each lane's final relative
    residual max|rhs - A x| / (max|rhs| + eps), shape (B,).  Returns
    (x, rn or None)."""
    eps = equilibration_eps(A.dtype)
    scale = 1.0 / torch.clamp(torch.amax(torch.abs(A), dim=1, keepdim=True),
                              min=eps)
    A = A * scale
    rhs = rhs * scale
    # at the input width the casts are no-ops: the single-width solve
    fd = A.dtype if factor_dtype is None else factor_dtype
    Af = A.to(fd)
    x = _gj_elim(Af, rhs.to(fd)).to(A.dtype)
    for _ in range(refine):
        r = rhs - _matmul_bl(A, x)
        x = x + _gj_elim(Af, r.to(fd)).to(A.dtype)
    if not resid:
        return x, None
    r = rhs - _matmul_bl(A, x)
    den = torch.amax(torch.abs(rhs), dim=(0, 1)) + eps
    return x, torch.amax(torch.abs(r), dim=(0, 1)) / den


def _ladder_plain(A, rhs, refine, precision, factor_dtype, promote_tol):
    """The plain ladder on lane-last blocks: (x, stats).  ``precision``
    None or "native" is the single-width solve; "mixed" eliminates at
    ``factor_dtype`` and re-solves the lanes with ``~(rn <= tol)`` at the
    full width (the TPU kernel's second pass, on the promoted lanes
    only)."""
    lanes = A.shape[-1]
    if precision in (None, "native"):
        x, _ = _gj_batchlast(A, rhs, refine)
        return x, _stats(lanes, A.dtype, A.device)
    fd = _factor(precision, factor_dtype)
    tol = DEFAULT_PROMOTE_TOL if promote_tol is None else float(promote_tol)
    x, rn = _gj_batchlast(A, rhs, refine, factor_dtype=fd, resid=True)
    mask, promoted = promotion_mask(rn, tol)
    idx = _promoted_lanes(mask)
    if idx is not None:
        xh, _ = _gj_batchlast(A[..., idx], rhs[..., idx], refine)
        x = x.clone()
        x[..., idx] = xh
    return x, _stats(lanes, A.dtype, A.device, promoted, rn)


def _promoted_lanes(mask):
    """The indices (a tensor on the mask's device) of the lanes ``mask``
    promotes, or None when it promotes none: the mask comes to the host
    in one counted pull (``obs.transfers.device_get``)."""
    from raft_tpu_torch._config import to_device
    from raft_tpu_torch.obs import transfers

    m = transfers.device_get(mask.reshape(-1), what="promotion_mask")
    if not m.any():
        return None
    return to_device(np.flatnonzero(m), mask.device)


def _stats(lanes, dtype, dev, promoted=None, rn=None):
    """The ladder's stats: {"promoted", "lanes", "resid_max"} (tensors on
    ``dev``), plus the per-lane residuals "rn" under the mixed ladder."""
    if rn is None:
        return {"promoted": torch.zeros((), dtype=torch.int32, device=dev),
                "lanes": lanes,
                "resid_max": torch.zeros((), dtype=dtype, device=dev)}
    resid_max = torch.amax(rn) if lanes else torch.zeros(
        (), dtype=dtype, device=dev)
    return {"promoted": promoted, "lanes": lanes, "resid_max": resid_max,
            "rn": rn}


def _factor(precision, factor_dtype):
    if precision != "mixed":
        raise errors.ModelConfigError(
            f"unknown gj_solve precision {precision!r}")
    return torch.float32 if factor_dtype is None else factor_dtype


def gj_solve_plain(A, b, refine: int = 1, precision: str = None,
                   factor_dtype=None, promote_tol=None,
                   return_stats: bool = False):
    """Plain version of K2 (K4 under ``precision="mixed"``): solve real
    A (..., n, n) x = b (..., n, k)."""
    n = A.shape[-1]
    k = b.shape[-1]
    batch = A.shape[:-2]
    Bn = math.prod(batch)
    Af = A.reshape(Bn, n, n).movedim(0, -1)              # (n, n, B)
    bf = b.reshape(Bn, n, k).movedim(0, -1)              # (n, k, B)
    x, stats = _ladder_plain(Af, bf, refine, precision, factor_dtype,
                             promote_tol)
    out = x.movedim(-1, 0).reshape(*batch, n, k)
    return (out, stats) if return_stats else out


def _imp_batch(M, B, C, F):
    """The case batch of an impedance solve: the broadcast of the leading
    axes of M, B (..., n, n, nw), C (..., n, n) and F (..., n, nw)."""
    return tuple(torch.broadcast_shapes(M.shape[:-3], B.shape[:-3],
                                        C.shape[:-2], F.shape[:-2]))


def _flat_impedance(w, M, B, C, F):
    """Lane-last operands of K1: the (batch, nw) product flattened
    case-major / frequency-minor, as the TPU wrapper orders it."""
    n = M.shape[-3]
    nw = M.shape[-1]
    batch = _imp_batch(M, B, C, F)
    Bt = math.prod(batch) * nw

    def flat_ml(x):
        x = torch.broadcast_to(x, batch + (n, n, nw))
        x = x.movedim(-1, -3).reshape(Bt, n, n)
        return x.movedim(0, -1)

    Mf = flat_ml(M)
    Bf = flat_ml(B)
    Cf = flat_ml(C[..., None])
    wf = torch.broadcast_to(w, batch + (nw,)).reshape(1, Bt)
    Ff = torch.broadcast_to(F, batch + (n, nw)).movedim(-1, -2).reshape(Bt, n, 1)
    Ff = Ff.movedim(0, -1)                               # (n, 1, B)
    return wf, Mf, Bf, Cf, Ff.real.to(M.dtype), Ff.imag.to(M.dtype)


def impedance_gj_solve_plain(w, M, B, C, F, refine: int = 1,
                             precision: str = None, factor_dtype=None,
                             promote_tol=None, return_stats: bool = False):
    """Plain version of K1 (K3 under ``precision="mixed"``): solve
    [-w^2 M + i w B + C] X = F.  w (nw,); M, B (..., n, n, nw);
    C (..., n, n); F (..., n, nw) complex -> X (..., n, nw) complex."""
    n = M.shape[-3]
    nw = M.shape[-1]
    batch = _imp_batch(M, B, C, F)
    w = w.to(device=M.device, dtype=M.dtype) if isinstance(w, torch.Tensor) \
        else torch.as_tensor(w, dtype=M.dtype, device=M.device)
    wf, Mf, Bf, Cf, Fre, Fim = _flat_impedance(w, M, B, C, F)
    wl = wf[0]
    reZ = Cf - (wl * wl)[None, None, :] * Mf
    imZ = wl[None, None, :] * Bf
    A = torch.cat([torch.cat([reZ, -imZ], dim=1),
                   torch.cat([imZ, reZ], dim=1)], dim=0)   # (2n, 2n, B)
    rhs = torch.cat([Fre, Fim], dim=0)                     # (2n, 1, B)
    x, stats = _ladder_plain(A, rhs, refine, precision, factor_dtype,
                             promote_tol)
    X = torch.complex(x[:n, 0, :], x[n:, 0, :])            # (n, B)
    X = X.movedim(-1, 0).reshape(batch + (nw, n))
    X = X.movedim(-1, -2)
    return (X, stats) if return_stats else X


# ---------------------------------------------------------------------------
# wrappers: CUDA tensor -> kernel (or raise), CPU tensor -> plain version
# ---------------------------------------------------------------------------

_IMP_N = range(1, 9)
#: the K2/K4 kernels instantiate even n up to this; odd n are padded
_GJ_N_MAX = 16
_REAL_OF = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def _require(cond, msg, **ctx):
    if not cond:
        raise errors.KernelFailure(msg, **ctx)


def impedance_gj_solve(w, M, B, C, F, refine: int = 1, precision: str = None,
                       factor_dtype=None, promote_tol=None,
                       return_stats: bool = False):
    """K1 (K3 under ``precision="mixed"``): solve [-w^2 M + i w B + C] X = F
    without materialising Z.  Launches the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  ``return_stats=True`` also
    returns ``{"promoted", "lanes", "resid_max", "rn"}`` (tensors on the
    input's device; ``rn`` only under mixed)."""
    if M.device.type == "cpu":
        return impedance_gj_solve_plain(w, M, B, C, F, refine, precision,
                                        factor_dtype, promote_tol,
                                        return_stats)
    _require(M.device.type == "cuda", f"no kernel for device {M.device}",
             kernel="impedance_gj")
    return _impedance_cuda(w, M, B, C, F, refine, precision, factor_dtype,
                           promote_tol, return_stats)


def gj_solve(A, b, refine: int = 1, precision: str = None, factor_dtype=None,
             promote_tol=None, return_stats: bool = False):
    """K2 (K4 under ``precision="mixed"``): batched real solve
    A (..., n, n) x = b (..., n, k).  Launches the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  On the card every n <= 16
    and every k run: an odd n padded exactly (``pad_odd``), k beyond the
    kernels' 1 and n/2 in column chunks, the ladder's chunks with one
    promotion decision per lane (``ladder_in_chunks``)."""
    if A.device.type == "cpu":
        return gj_solve_plain(A, b, refine, precision, factor_dtype,
                              promote_tol, return_stats)
    _require(A.device.type == "cuda", f"no kernel for device {A.device}",
             kernel="gj_solve")
    return _gj_cuda(A, b, refine, precision, factor_dtype, promote_tol,
                    return_stats)


def _variant(kernel, dtype, precision, factor_dtype):
    """(entry-point suffix, launch key, factor dtype or None) of a call."""
    if precision in (None, "native"):
        _require(dtype in _REAL_OF, f"{kernel} takes float64 or float32, "
                 f"got {dtype}", kernel=kernel)
        if dtype == torch.float64:
            return "f64", kernel, None
        return "f32", f"{kernel}_f32", None
    fd = _factor(precision, factor_dtype)
    _require(dtype == torch.float64, "the mixed ladder kernels take "
             f"float64 inputs, got {dtype}", kernel=f"{kernel}_mixed")
    _require(fd in (torch.float32, torch.bfloat16), "the mixed ladder "
             f"eliminates in float32 or bfloat16, not {fd}",
             kernel=f"{kernel}_mixed")
    name = width_name(fd)
    key = f"{kernel}_mixed" if name == "f32" else f"{kernel}_mixed_{name}"
    return f"mixed_{name}", key, fd


def _impedance_cuda(w, M, B, C, F, refine, precision, factor_dtype,
                    promote_tol, return_stats):
    from raft_tpu_torch.ops.kernels import _build

    dev = M.device
    dt = M.dtype
    n = M.shape[-3]
    nw = M.shape[-1]
    batch = _imp_batch(M, B, C, F)
    nb = math.prod(batch)
    suffix, key, fd = _variant("impedance_gj", dt, precision, factor_dtype)
    _require(n in _IMP_N, f"impedance_gj kernel has no n={n} instantiation",
             kernel=key, n=n)
    _require(M.shape[-2] == n and B.shape[-3:] == M.shape[-3:]
             and C.shape[-2:] == (n, n) and F.shape[-2:] == (n, nw),
             "impedance_gj shape mismatch", kernel=key,
             M=tuple(M.shape), B=tuple(B.shape), C=tuple(C.shape),
             F=tuple(F.shape))
    for name, t, want in (("B", B, dt), ("C", C, dt),
                          ("F", F, _REAL_OF[dt])):
        _require(t.device == dev, f"{name} is on {t.device}, M on {dev}",
                 kernel=key)
        _require(t.dtype == want, f"{name} must be {want}, got {t.dtype}",
                 kernel=key)
    w = w.to(device=dev, dtype=dt).contiguous() \
        if isinstance(w, torch.Tensor) \
        else torch.as_tensor(w, dtype=dt, device=dev)
    _require(w.shape == (nw,), "w must be (nw,)", kernel=key)
    Mc = torch.broadcast_to(M, batch + (n, n, nw)).contiguous()
    Bc = torch.broadcast_to(B, batch + (n, n, nw)).contiguous()
    Cc = torch.broadcast_to(C, batch + (n, n)).contiguous()
    Fc = torch.view_as_real(torch.broadcast_to(F, batch + (n, nw)).contiguous())
    X = torch.empty(batch + (n, nw), dtype=_REAL_OF[dt], device=dev)
    lanes = nb * nw
    rn = promoted = None
    if fd is not None:
        rn = torch.zeros(lanes, dtype=dt, device=dev)
        promoted = torch.zeros(1, dtype=torch.int32, device=dev)
    if lanes:
        lib = _build.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (w.data_ptr(), Mc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                Fc.data_ptr(), torch.view_as_real(X).data_ptr())
        if fd is None:
            rc = getattr(lib, f"raft_impedance_gj_{suffix}")(
                *ptrs, nb, nw, n, int(refine), stream)
        else:
            tol = DEFAULT_PROMOTE_TOL if promote_tol is None \
                else float(promote_tol)
            rc = getattr(lib, f"raft_impedance_gj_{suffix}")(
                *ptrs, rn.data_ptr(), promoted.data_ptr(), nb, nw, n,
                int(refine), tol, stream)
        _build.check(rc, key, n=n, lanes=lanes)
        LAUNCHES[key] += 1
    if not return_stats:
        return X
    if fd is None:
        return X, _stats(lanes, dt, dev)
    return X, _stats(lanes, dt, dev, promoted[0], rn)


def pad_odd(A, b):
    """(A, b) with an odd n padded to n + 1, for the kernels, which take
    even n only: A gets a decoupled identity row and column (1 on the new
    diagonal, 0 elsewhere in them) and b a zero row; the solution's last
    row is then exactly 0 and is dropped.  The padding is exact:
    - the pad row and column are 0 off the diagonal, so no multiplier,
      row maximum or equilibration scale of a real row changes, and the
      pad row's own scale is 1;
    - at a real column the pad row holds 0, so the pivot scan never
      prefers it (a tie at 0 goes to the first, real, row), and it is
      pivot only at the last step, where it is alone;
    - the residual of a real row adds 0 * 0, and the pad row's residual
      is 0 - 1 * 0.
    An even n is returned as it is."""
    n = A.shape[-1]
    if n % 2 == 0:
        return A, b
    batch = tuple(A.shape[:-2])
    Ap = A.new_zeros(batch + (n + 1, n + 1))
    Ap[..., :n, :n] = A
    Ap[..., n, n] = 1.0
    bp = b.new_zeros(batch + (n + 1, b.shape[-1]))
    bp[..., :n, :] = b
    return Ap, bp


def ladder_in_chunks(A, b, kc, solve_chunk, solve_full, promote_tol):
    """The mixed ladder of A (..., n, n) x = b (..., n, k) run over column
    chunks of ``kc`` right-hand sides (the last zero-padded), with the
    reference's one promotion decision per lane over all its columns
    (``raft_tpu/ops/pallas/gj_solve.py:_gj_mixed_kernel``).

    ``solve_chunk(bc)`` runs the ladder on one chunk with no promotion but
    of NaN lanes (tolerance inf) and returns (x, rn per lane);
    ``solve_full(A, b)`` is the full-width solve.  A chunk's rn is its
    max|r| over max|rhs| + eps on the equilibrated system, so max|r| is
    rn (max|rhs| + eps); the lane's rn is the largest max|r| over the
    largest max|rhs| + eps of all chunks: the unchunked rn up to
    rounding.  Every lane with ``~(rn <= promote_tol)`` is then solved at
    full width on all its k columns.  Returns (x, rn, promoted)."""
    n, k = A.shape[-1], b.shape[-1]
    batch = tuple(A.shape[:-2])
    eps = equilibration_eps(A.dtype)
    scale = 1.0 / torch.clamp(torch.amax(torch.abs(A), dim=-1), min=eps)
    xs, rmax, bmax = [], None, None
    for c0 in range(0, k, kc):
        bc = b[..., c0:c0 + kc]
        if bc.shape[-1] < kc:
            bc = torch.cat([bc, bc.new_zeros(batch + (n, kc - bc.shape[-1]))],
                           dim=-1)
        x, rn = solve_chunk(bc.contiguous())
        bm = torch.amax(torch.abs(bc * scale[..., None]), dim=(-2, -1))
        rm = rn.reshape(batch) * (bm + eps)
        rmax = rm if rmax is None else torch.maximum(rmax, rm)
        bmax = bm if bmax is None else torch.maximum(bmax, bm)
        xs.append(x)
    x = torch.cat(xs, dim=-1)[..., :k]
    rn = (rmax / (bmax + eps)).reshape(-1)
    mask, promoted = promotion_mask(rn, promote_tol)
    idx = _promoted_lanes(mask)
    if idx is not None:
        x = x.reshape(-1, n, k).clone()
        x[idx] = solve_full(A.reshape(-1, n, n)[idx], b.reshape(-1, n, k)[idx])
        x = x.reshape(batch + (n, k))
    return x, rn, promoted


def _gj_cuda(A, b, refine, precision, factor_dtype, promote_tol,
             return_stats):
    from raft_tpu_torch.ops.kernels import _build

    dev = A.device
    dt = A.dtype
    n = A.shape[-1]
    k = b.shape[-1]
    batch = tuple(A.shape[:-2])
    lanes = math.prod(batch)
    suffix, key, fd = _variant("gj_solve", dt, precision, factor_dtype)
    _require(1 <= n <= _GJ_N_MAX, f"gj_solve kernel takes n <= "
             f"{_GJ_N_MAX}, got n={n}", kernel=key, n=n)
    _require(A.shape[-2] == n and tuple(b.shape) == batch + (n, k),
             "gj_solve shape mismatch", kernel=key,
             A=tuple(A.shape), b=tuple(b.shape))
    _require(b.device == dev, f"b is on {b.device}, A on {dev}", kernel=key)
    _require(b.dtype == dt, f"b must be {dt}, got {b.dtype}", kernel=key)
    # the kernels instantiate even n: an odd n is padded exactly
    Ac, b = pad_odd(A.contiguous(), b)
    ne = Ac.shape[-1]
    # instantiated right-hand-side counts: 1 and n/2; other k run as
    # column chunks of n/2, zero-padded (the elimination of each column is
    # independent of the others, so chunking changes no single-width
    # result).  The ladder over several chunks takes one promotion
    # decision per lane over all its columns (ladder_in_chunks).
    kc = 1 if k == 1 else ne // 2
    tol = DEFAULT_PROMOTE_TOL if promote_tol is None else float(promote_tol)

    def launch(bc, fn_suffix, launch_key, chunk_tol):
        """One launch on a chunk of exactly kc columns: (x, rn, promoted)."""
        x = torch.empty(batch + (ne, kc), dtype=dt, device=dev)
        mixed = fn_suffix.startswith("mixed")
        rn = torch.zeros(lanes, dtype=dt, device=dev) if mixed else None
        promoted = torch.zeros(1, dtype=torch.int32, device=dev) \
            if mixed else None
        if lanes:
            lib = _build.load()
            stream = torch.cuda.current_stream(dev).cuda_stream
            fn = getattr(lib, f"raft_gj_solve_{fn_suffix}")
            if not mixed:
                rc = fn(Ac.data_ptr(), bc.data_ptr(), x.data_ptr(), lanes, ne,
                        kc, int(refine), stream)
            else:
                rc = fn(Ac.data_ptr(), bc.data_ptr(), x.data_ptr(),
                        rn.data_ptr(), promoted.data_ptr(), lanes, ne, kc,
                        int(refine), chunk_tol, stream)
            _build.check(rc, launch_key, n=ne, k=kc, lanes=lanes)
            LAUNCHES[launch_key] += 1
        return x, rn, promoted

    if fd is not None and k > kc:
        def solve_chunk(bc):
            x, rn, _ = launch(bc, suffix, key, math.inf)
            return x, rn

        def solve_full(Ap, bp):
            return _gj_cuda(Ap, bp, refine, None, None, None, False)

        x, rn, promoted = ladder_in_chunks(Ac, b, kc, solve_chunk,
                                           solve_full, tol)
        x = x[..., :n, :]
        return (x, _stats(lanes, dt, dev, promoted, rn)) if return_stats \
            else x
    outs = []
    rn = promoted = None
    for c0 in range(0, k, kc):
        bc = b[..., c0:c0 + kc]
        if bc.shape[-1] < kc:
            bc = torch.cat([bc, bc.new_zeros(batch + (ne, kc - bc.shape[-1]))],
                           dim=-1)
        x, rn, promoted = launch(bc.contiguous(), suffix, key, tol)
        outs.append(x)
    x = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    x = x[..., :n, :k]
    if not return_stats:
        return x
    if fd is None:
        return x, _stats(lanes, dt, dev)
    return x, _stats(lanes, dt, dev, promoted[0], rn)
