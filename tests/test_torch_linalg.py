"""Parity of the port's Gauss-Jordan solves with the JAX package's.

The plain PyTorch versions of the two kernels (the CPU path, and the
yardstick the CUDA kernels are held against on the card) against the JAX
Pallas kernels in interpret mode — as tests/test_pallas_gj.py runs them —
and against ``raft_tpu.ops.linalg.gauss_jordan_solve``.  Same algorithm,
same op order, float64: relative 1e-12.  Plus the dispatch rule: CPU
tensors take the plain versions, and nothing runs on a card that is not
there.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.ops import linalg as JL
from raft_tpu.ops.pallas.gj_solve import gj_solve as j_gj_solve
from raft_tpu.ops.pallas.gj_solve import impedance_gj_solve as j_impedance

from raft_tpu_torch import errors
from raft_tpu_torch._config import resolve_device
from raft_tpu_torch.ops import linalg as TL
from raft_tpu_torch.ops.kernels import gj_solve as G

TOL = 1e-12


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / np.max(np.abs(np.asarray(b))))


def _systems(rng, kind, B, n):
    if kind == "random":
        return rng.standard_normal((B, n, n)) + 5.0 * np.eye(n)
    if kind == "pivoting":
        P = np.stack([np.eye(n)[rng.permutation(n)] for _ in range(B)])
        return P * rng.uniform(1.0, 3.0, (B, n, 1)) \
            + 0.05 * rng.standard_normal((B, n, n)) * (P == 0)
    # the impedance blocks' mixed ~1e7 force / ~1e12 moment row scales
    return (0.1 * rng.standard_normal((B, n, n)) + np.eye(n)) \
        * 10.0 ** rng.uniform(3, 10, (B, n, 1))


@pytest.mark.parametrize("kind", ["random", "pivoting", "row_scales"])
@pytest.mark.parametrize("k", [6, 1])
def test_gj_solve_plain_matches_pallas_and_jnp(kind, k):
    rng = np.random.default_rng(3 + k)
    B, n = 40, 12
    A = _systems(rng, kind, B, n)
    b = rng.standard_normal((B, n, k)) * 1e3
    x_pl = np.asarray(j_gj_solve(jnp.asarray(A), jnp.asarray(b),
                                 interpret=True))
    x_jnp = np.asarray(JL.gauss_jordan_solve(jnp.asarray(A), jnp.asarray(b)))
    x_t = G.gj_solve_plain(torch.tensor(A), torch.tensor(b)).numpy()
    assert _rel(x_t, x_pl) < TOL
    assert _rel(x_t, x_jnp) < TOL
    x_gj = TL.gauss_jordan_solve(torch.tensor(A), torch.tensor(b)).numpy()
    assert _rel(x_gj, x_jnp) < TOL


def test_gj_solve_small_pivoting_system():
    A = np.array([[0.0, 2.0, 1.0],
                  [1.0, 0.0, 3.0],
                  [2.0, 1.0, 0.0]])
    b = np.array([[1.0], [2.0], [3.0]])
    x = G.gj_solve(torch.tensor(A[None]), torch.tensor(b[None])).numpy()[0]
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-12)


def _impedance_inputs(rng, nb, n, nw, kind):
    w = np.linspace(0.2, 1.5, nw)
    M = rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[None, :, :, None]
    B = 0.1 * rng.standard_normal((nb, n, n, nw))
    C = rng.standard_normal((nb, n, n)) + 10.0 * np.eye(n)
    F = rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal((nb, n, nw))
    if kind == "pivoting":
        C = 10.0 * _systems(rng, "pivoting", nb, n)
        M, B = 0.01 * M, 0.01 * B
    elif kind == "row_scales":
        s = 10.0 ** rng.uniform(3, 10, (nb, n, 1))
        M, B, C, F = M * s[..., None], B * s[..., None], C * s, F * 1e6
    return w, M, B, C, F


@pytest.mark.parametrize("kind", ["random", "pivoting", "row_scales"])
def test_impedance_plain_matches_pallas(kind):
    rng = np.random.default_rng(17)
    w, M, B, C, F = _impedance_inputs(rng, 3, 6, 17, kind)
    X_pl = np.asarray(j_impedance(w, M, B, C, F, interpret=True))
    X_t = G.impedance_gj_solve_plain(*(torch.tensor(a) for a in
                                       (w, M, B, C, F))).numpy()
    assert _rel(X_t, X_pl) < TOL


def test_impedance_unbatched_rank_and_solve_complex():
    """The Model path calls with no case batch; the same solve through
    the unfused embedding must agree."""
    rng = np.random.default_rng(5)
    w, M, B, C, F = _impedance_inputs(rng, 1, 6, 11, "random")
    w, M, B, C, F = w, M[0], B[0], C[0], F[0]
    X_j = np.asarray(j_impedance(w, M, B, C, F, interpret=True))
    tw, tM, tB, tC, tF = (torch.tensor(a) for a in (w, M, B, C, F))
    X_t = TL.impedance_solve(tw, tM, tB, tC, tF).numpy()
    assert _rel(X_t, X_j) < TOL
    Z = (-tw ** 2 * tM + 1j * tw * tB + tC[..., None]).movedim(-1, -3)
    X_sc = TL.solve_complex(Z, tF.movedim(-1, -2)).movedim(-2, -1).numpy()
    assert _rel(X_sc, X_j) < 1e-10


def test_inv_complex_matches_jax():
    rng = np.random.default_rng(9)
    Z = rng.standard_normal((20, 6, 6)) + 1j * rng.standard_normal((20, 6, 6)) \
        + 8.0 * np.eye(6)
    Zi_j = np.asarray(JL.inv_complex(jnp.asarray(Z)))
    Zi_t = TL.inv_complex(torch.tensor(Z)).numpy()
    assert _rel(Zi_t, Zi_j) < 1e-10
    np.testing.assert_allclose(Zi_t @ Z, np.broadcast_to(np.eye(6), Z.shape),
                               atol=1e-12)


def test_cpu_tensors_take_the_plain_path():
    rng = np.random.default_rng(1)
    G.reset_launches()
    Z = torch.tensor(rng.standard_normal((4, 6, 6)) + 6 * np.eye(6),
                     dtype=torch.complex128)
    TL.inv_complex(Z)
    d = TL.last_dispatch()
    assert d["backend"] == "plain_gj" and d["kernel"] == "gj_solve"
    assert d["n"] == 12 and d["batch_elems"] == 4
    w, M, B, C, F = (torch.tensor(a) for a in _impedance_inputs(
        rng, 1, 6, 5, "random"))
    TL.impedance_solve(w, M[0], B[0], C[0], F[0])
    d = TL.last_dispatch()
    assert d["backend"] == "plain_fused" and d["fused"]
    assert d["batch_elems"] == 5
    # systems above the kernels' size go to LU
    Zbig = torch.tensor(rng.standard_normal((2, 9, 9)) + 9 * np.eye(9),
                        dtype=torch.complex128)
    TL.inv_complex(Zbig)
    assert TL.last_dispatch()["backend"] == "lu"
    assert set(G.LAUNCHES) >= {"impedance_gj", "gj_solve"}
    assert all(v == 0 for v in G.LAUNCHES.values())


def test_no_card_raises(monkeypatch):
    from raft_tpu_torch import Model
    from raft_tpu_torch.io.designs import load_design

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Model(load_design("OC3spar"))
    assert resolve_device("cpu") == torch.device("cpu")


def test_unroutable_tensor_raises_kernel_failure():
    A = torch.zeros((2, 4, 4), dtype=torch.float64, device="meta")
    b = torch.zeros((2, 4, 1), dtype=torch.float64, device="meta")
    with pytest.raises(errors.KernelFailure):
        G.gj_solve(A, b)


def test_failed_build_raises_kernel_failure(monkeypatch, tmp_path):
    from raft_tpu_torch.ops.kernels import _build

    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here; the missing-compiler path "
                    "cannot be exercised")
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(errors.KernelFailure, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 3, 5, 7, 9, 11, 13, 15])
def test_odd_n_padding_is_exact(n, dtype):
    """``pad_odd``, which the card's wrapper applies before the kernels
    (they instantiate even n only): the plain version on the system padded
    to n + 1 with a decoupled identity row and column gives the unpadded
    system's x, and exactly 0 in the pad row, on random, pivoting and
    row-scaled systems.  x agrees to rounding, not bitwise: the plain
    version's refinement residual is a ``torch.sum`` over n + 1 terms in
    place of n, which vectorises in another order at some lengths."""
    rng = np.random.default_rng(90 + n)
    A = torch.tensor(np.concatenate([_systems(rng, kind, 7, n) for kind in
                                     ("random", "pivoting", "row_scales")]),
                     dtype=dtype)
    b = torch.tensor(rng.standard_normal((21, n, 3)), dtype=dtype)
    Ap, bp = G.pad_odd(A, b)
    assert Ap.shape == (21, n + 1, n + 1) and bp.shape == (21, n + 1, 3)
    xp = G.gj_solve_plain(Ap, bp)
    assert torch.all(xp[:, n] == 0)
    assert _rel(xp[:, :n], G.gj_solve_plain(A, b)) <= \
        10 * torch.finfo(dtype).eps
    assert G.pad_odd(Ap, bp)[0] is Ap
