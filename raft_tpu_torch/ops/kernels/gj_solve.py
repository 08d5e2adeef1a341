"""The two Gauss-Jordan solve kernels of the main path, their wrappers and
their plain PyTorch versions.

``impedance_gj_solve`` (K1) replaces the Pallas kernel
``raft_tpu/ops/pallas/gj_solve.py:impedance_gj_solve``: it solves
[-w^2 M + i w B + C] X = F per (case, frequency) lane through the real
2n x 2n block embedding, assembled inside the kernel so Z never exists
in memory.  ``gj_solve`` (K2) replaces ``gj_solve`` there: the batched
real solve A x = b behind ``ops.linalg.solve_complex`` / ``inv_complex``.
Both equilibrate rows by 1/max|row| (floored at 1e-300), eliminate with
partial pivoting and refine once.

Dispatch: a CUDA tensor launches the hand-written kernel of
``csrc/gj_solve.cu`` (built at first use, see ``_build.py``) or raises
:class:`~raft_tpu_torch.errors.KernelFailure`; a CPU tensor runs the
plain version below.  There is no other route.  What bounds the kernels
on the card and what their design does about it is written in the CUDA
source.

The plain versions repeat the TPU kernels' algorithm in their op order,
lane-last like ``_gj_batchlast`` / ``_gj_elim`` (including the
arithmetic row swap, which is why the kernel's real swap agrees with them
to rounding, not bitwise).  They are the CPU path, the tests' reference,
and the yardstick the card's kernels are held against.
"""
from __future__ import annotations

import math

import torch

from raft_tpu_torch import errors
from raft_tpu_torch._config import as_real

#: kernel launches per wrapper; incremented only where a kernel launches
LAUNCHES = {"impedance_gj": 0, "gj_solve": 0}



def equilibration_eps(dtype) -> float:
    """Underflow floor for the row-equilibration scale 1/max|row| (the
    JAX package's ops/precision.py:equilibration_eps)."""
    return 1e-300 if dtype == torch.float64 else 1e-30


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (lane-last, the TPU kernels' op order)
# ---------------------------------------------------------------------------

def _gj_elim(A, rhs):
    """Unrolled Gauss-Jordan with partial pivoting on lane-last blocks:
    A (n, n, B), rhs (n, k, B) -> x (n, k, B)."""
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


def _gj_batchlast(A, rhs, refine):
    """Equilibrate + eliminate + refine on lane-last blocks."""
    scale = 1.0 / torch.clamp(torch.amax(torch.abs(A), dim=1, keepdim=True),
                              min=equilibration_eps(A.dtype))
    A = A * scale
    rhs = rhs * scale
    x = _gj_elim(A, rhs)
    for _ in range(refine):
        r = rhs - _matmul_bl(A, x)
        x = x + _gj_elim(A, r)
    return x


def gj_solve_plain(A, b, refine: int = 1):
    """Plain version of K2: solve real A (..., n, n) x = b (..., n, k)."""
    n = A.shape[-1]
    k = b.shape[-1]
    batch = A.shape[:-2]
    Bn = math.prod(batch)
    Af = A.reshape(Bn, n, n).movedim(0, -1)              # (n, n, B)
    bf = b.reshape(Bn, n, k).movedim(0, -1)              # (n, k, B)
    x = _gj_batchlast(Af, bf, refine)
    return x.movedim(-1, 0).reshape(*batch, n, k)


def _flat_impedance(w, M, B, C, F):
    """Lane-last operands of K1: the (batch, nw) product flattened
    case-major / frequency-minor, as the TPU wrapper orders it."""
    n = M.shape[-3]
    nw = M.shape[-1]
    batch = M.shape[:-3]
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


def impedance_gj_solve_plain(w, M, B, C, F, refine: int = 1):
    """Plain version of K1: solve [-w^2 M + i w B + C] X = F.
    w (nw,); M, B (..., n, n, nw); C (..., n, n); F (..., n, nw) complex
    -> X (..., n, nw) complex."""
    n = M.shape[-3]
    nw = M.shape[-1]
    batch = M.shape[:-3]
    w = as_real(w, M.device)
    wf, Mf, Bf, Cf, Fre, Fim = _flat_impedance(w, M, B, C, F)
    wl = wf[0]
    reZ = Cf - (wl * wl)[None, None, :] * Mf
    imZ = wl[None, None, :] * Bf
    A = torch.cat([torch.cat([reZ, -imZ], dim=1),
                   torch.cat([imZ, reZ], dim=1)], dim=0)   # (2n, 2n, B)
    rhs = torch.cat([Fre, Fim], dim=0)                     # (2n, 1, B)
    x = _gj_batchlast(A, rhs, refine)
    X = torch.complex(x[:n, 0, :], x[n:, 0, :])            # (n, B)
    X = X.movedim(-1, 0).reshape(batch + (nw, n))
    return X.movedim(-1, -2)


# ---------------------------------------------------------------------------
# wrappers: CUDA tensor -> kernel (or raise), CPU tensor -> plain version
# ---------------------------------------------------------------------------

_IMP_N = range(1, 9)
_GJ_N = (2, 4, 6, 8, 10, 12, 14, 16)


def _require(cond, msg, **ctx):
    if not cond:
        raise errors.KernelFailure(msg, **ctx)


def impedance_gj_solve(w, M, B, C, F, refine: int = 1):
    """K1: solve [-w^2 M + i w B + C] X = F without materialising Z.
    Launches the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if M.device.type == "cpu":
        return impedance_gj_solve_plain(w, M, B, C, F, refine)
    _require(M.device.type == "cuda", f"no kernel for device {M.device}",
             kernel="impedance_gj")
    return _impedance_cuda(w, M, B, C, F, refine)


def gj_solve(A, b, refine: int = 1):
    """K2: batched real solve A (..., n, n) x = b (..., n, k).  Launches
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if A.device.type == "cpu":
        return gj_solve_plain(A, b, refine)
    _require(A.device.type == "cuda", f"no kernel for device {A.device}",
             kernel="gj_solve")
    return _gj_cuda(A, b, refine)


def _impedance_cuda(w, M, B, C, F, refine):
    from raft_tpu_torch.ops.kernels import _build

    dev = M.device
    n = M.shape[-3]
    nw = M.shape[-1]
    batch = tuple(M.shape[:-3])
    nb = math.prod(batch)
    _require(n in _IMP_N, f"impedance_gj kernel has no n={n} instantiation",
             kernel="impedance_gj", n=n)
    _require(M.shape[-2] == n and B.shape[-3:] == M.shape[-3:]
             and C.shape[-2:] == (n, n) and F.shape[-2:] == (n, nw),
             "impedance_gj shape mismatch", kernel="impedance_gj",
             M=tuple(M.shape), B=tuple(B.shape), C=tuple(C.shape),
             F=tuple(F.shape))
    for name, t, dt in (("M", M, torch.float64), ("B", B, torch.float64),
                        ("C", C, torch.float64), ("F", F, torch.complex128)):
        _require(t.device == dev, f"{name} is on {t.device}, M on {dev}",
                 kernel="impedance_gj")
        _require(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}",
                 kernel="impedance_gj")
    w = as_real(w, dev).contiguous()
    _require(w.shape == (nw,), "w must be (nw,)", kernel="impedance_gj")
    Mc = torch.broadcast_to(M, batch + (n, n, nw)).contiguous()
    Bc = torch.broadcast_to(B, batch + (n, n, nw)).contiguous()
    Cc = torch.broadcast_to(C, batch + (n, n)).contiguous()
    Fc = torch.view_as_real(torch.broadcast_to(F, batch + (n, nw)).contiguous())
    X = torch.empty(batch + (n, nw), dtype=torch.complex128, device=dev)
    if nb * nw == 0:
        return X
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.raft_impedance_gj_f64(
        w.data_ptr(), Mc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        Fc.data_ptr(), torch.view_as_real(X).data_ptr(), nb, nw, n,
        int(refine), stream)
    _build.check(rc, "impedance_gj", n=n, lanes=nb * nw)
    LAUNCHES["impedance_gj"] += 1
    return X


def _gj_cuda(A, b, refine):
    from raft_tpu_torch.ops.kernels import _build

    dev = A.device
    n = A.shape[-1]
    k = b.shape[-1]
    batch = tuple(A.shape[:-2])
    lanes = math.prod(batch)
    _require(n in _GJ_N, f"gj_solve kernel has no n={n} instantiation "
             "(even n <= 16)", kernel="gj_solve", n=n)
    _require(A.shape[-2] == n and tuple(b.shape) == batch + (n, k),
             "gj_solve shape mismatch", kernel="gj_solve",
             A=tuple(A.shape), b=tuple(b.shape))
    for name, t in (("A", A), ("b", b)):
        _require(t.device == dev, f"{name} is on {t.device}, A on {dev}",
                 kernel="gj_solve")
        _require(t.dtype == torch.float64,
                 f"{name} must be float64, got {t.dtype}", kernel="gj_solve")
    Ac = A.contiguous()
    # instantiated right-hand-side counts: 1 and n/2; other k run as
    # column chunks of n/2 (the elimination of each column is independent
    # of the others, so chunking changes no result)
    kc = 1 if k == 1 else max(n // 2, 1)
    nchunk = -(-k // kc)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = []
    for c in range(nchunk):
        bc = b[..., c * kc:(c + 1) * kc]
        if bc.shape[-1] < kc:
            bc = torch.cat([bc, bc.new_zeros(batch + (n, kc - bc.shape[-1]))],
                           dim=-1)
        bc = bc.contiguous()
        x = torch.empty(batch + (n, kc), dtype=torch.float64, device=dev)
        if lanes:
            rc = lib.raft_gj_solve_f64(Ac.data_ptr(), bc.data_ptr(),
                                       x.data_ptr(), lanes, n, kc,
                                       int(refine), stream)
            _build.check(rc, "gj_solve", n=n, k=kc, lanes=lanes)
            LAUNCHES["gj_solve"] += 1
        outs.append(x)
    x = outs[0] if nchunk == 1 else torch.cat(outs, dim=-1)
    return x[..., :k]
