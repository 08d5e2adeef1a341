"""The port's precision ladder against the JAX package's.

- the knobs (``RAFT_TPU_PRECISION``, ``_WIDTH``, ``_TOL``) parse the same
  in both packages;
- the plain versions of K3/K4 (``precision="mixed"``) against the JAX
  Pallas kernels in interpret mode, at the f32 and bf16 widths, on
  random, pivoting, row-scale and SVD-conditioned (cond 1e9) systems:
  X to 1e-10 (f32) / 1e-7 (bf16) relative and the promoted counts equal
  (the cond-1e9 lanes, promoted and solved at f64 by both, agree to
  cond * eps: their residual sums are taken in another order);
- the f32 mode against JAX's f32 mode, to 1e-5;
- the dispatch facts per mode, and mixed / f32 with 2n > 16 through
  the ladder around LU (no longer refused).
All inputs are made with numpy from fixed seeds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import _config as j_config
from raft_tpu.ops import linalg as JL
from raft_tpu.ops.pallas.gj_solve import (
    gj_solve as j_gj_solve, impedance_gj_solve as j_impedance_gj_solve)

from raft_tpu_torch import _config, errors
from raft_tpu_torch.ops import linalg as TL
from raft_tpu_torch.ops import precision as prec
from raft_tpu_torch.ops.kernels import gj_solve as G

WIDTHS = {"f32": (torch.float32, jnp.float32, 1e-10),
          "bf16": (torch.bfloat16, jnp.bfloat16, 1e-7)}
#: bound for the promoted cond-1e9 lanes: cond * eps * 10
ILL_TOL = 1e9 * 2.2e-16 * 10
N_ILL = 9


@pytest.fixture(autouse=True)
def _clear_overrides():
    yield
    for cfg in (_config, j_config):
        cfg.set_precision_mode(None)
        cfg.set_precision_width(None)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _systems(rng, kind, lanes, n):
    if kind == "pivoting":
        P = np.stack([np.eye(n)[rng.permutation(n)] for _ in range(lanes)])
        return P * rng.uniform(1.0, 3.0, (lanes, n, 1)) \
            + 0.05 * rng.standard_normal((lanes, n, n)) * (P == 0)
    if kind == "row_scales":
        return (0.1 * rng.standard_normal((lanes, n, n)) + np.eye(n)) \
            * 10.0 ** rng.uniform(3, 10, (lanes, n, 1))
    A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
    if kind == "svd_ill":
        for i in range(N_ILL):
            U, _, Vt = np.linalg.svd(A[i])
            A[i] = (U * np.geomspace(1.0, 1e-9, n)) @ Vt
    return A


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("var,values", [
    ("RAFT_TPU_PRECISION", [None, "f64", "mixed", "f32", " MIXED ", "bogus",
                            ""]),
    ("RAFT_TPU_PRECISION_WIDTH", [None, "f32", "bf16", "BF16", "f8", ""]),
    ("RAFT_TPU_PRECISION_TOL", [None, "1e-6", " 3e-12 ", "not-a-number",
                                ""]),
])
def test_knobs_parse_as_jax(monkeypatch, var, values):
    read = {"RAFT_TPU_PRECISION": "precision_mode",
            "RAFT_TPU_PRECISION_WIDTH": "precision_width",
            "RAFT_TPU_PRECISION_TOL": "precision_tol"}[var]
    for v in values:
        if v is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, v)
        assert getattr(_config, read)() == getattr(j_config, read)(), v


def test_overrides_behave_as_jax(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_PRECISION", "mixed")
    for cfg in (_config, j_config):
        cfg.set_precision_mode("f32")
        assert cfg.precision_mode() == "f32"
        cfg.set_precision_mode(None)
        assert cfg.precision_mode() == "mixed"
        cfg.set_precision_width("bf16")
        assert cfg.precision_width() == "bf16"
        with pytest.raises(ValueError):
            cfg.set_precision_mode("f16")
        with pytest.raises(ValueError):
            cfg.set_precision_width("f8")


def test_precision_helpers():
    assert prec.equilibration_eps(torch.float64) == 1e-300
    assert prec.equilibration_eps(torch.float32) == 1e-30
    assert prec.equilibration_eps(torch.bfloat16) == 1e-30
    assert prec.factor_dtype("f32") == torch.float32
    assert prec.factor_dtype("bf16") == torch.bfloat16
    assert prec.factor_dtype("nonsense") == torch.float32
    assert prec.narrows(torch.float32, torch.float64)
    assert not prec.narrows(torch.float32, torch.float32)
    assert prec.narrows(torch.bfloat16, torch.float32)
    assert [prec.width_name(d) for d in (torch.float64, torch.float32,
                                         torch.bfloat16)] == \
        ["f64", "f32", "bf16"]


def test_promotion_mask_is_nan_safe():
    rn = torch.tensor([1e-12, 1e-9, 2e-9, float("nan"), float("inf")],
                      dtype=torch.float64)
    mask, n = prec.promotion_mask(rn, 1e-9)
    assert mask.tolist() == [False, False, True, True, True]
    assert int(n) == 3


# ---------------------------------------------------------------------------
# the plain K3 / K4 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["random", "pivoting", "row_scales",
                                  "svd_ill"])
def test_k4_plain_matches_pallas(width, kind):
    t_fd, j_fd, tol = WIDTHS[width]
    rng = np.random.default_rng(41)
    A = _systems(rng, kind, 96, 12)
    b = rng.standard_normal((96, 12, 6)) * 1e3
    xj, sj = j_gj_solve(jnp.asarray(A), jnp.asarray(b), refine=2,
                        precision="mixed", factor_dtype=j_fd,
                        promote_tol=1e-9, return_stats=True)
    xt, st = G.gj_solve(torch.tensor(A), torch.tensor(b), refine=2,
                        precision="mixed", factor_dtype=t_fd,
                        promote_tol=1e-9, return_stats=True)
    xj, xt = np.asarray(xj), xt.numpy()
    assert int(st["promoted"]) == int(np.asarray(sj["promoted"]))
    assert st["lanes"] == sj["lanes"] == 96
    if kind == "svd_ill":
        assert int(st["promoted"]) >= N_ILL
        assert _rel(xt[:N_ILL], xj[:N_ILL]) < ILL_TOL
        xt, xj = xt[N_ILL:], xj[N_ILL:]
    assert _rel(xt, xj) < tol
    if width == "bf16":
        # the bf16 rung cannot refine to 1e-9: every lane promotes
        assert int(st["promoted"]) == 96


@pytest.mark.parametrize("width", ["f32", "bf16"])
def test_k3_plain_matches_pallas(width):
    t_fd, j_fd, tol = WIDTHS[width]
    rng = np.random.default_rng(43)
    nb, n, nw = 3, 6, 11
    w = np.linspace(0.1, 2.5, nw)
    M = rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[None, :, :, None]
    B = 0.3 * rng.standard_normal((nb, n, n, nw))
    C = rng.standard_normal((nb, n, n)) + 10.0 * np.eye(n)
    # case 1: Z = C with cond(C) = 1e9 at every bin -> its lanes promote
    M[1] = 0.0
    B[1] = 0.0
    U, _, Vt = np.linalg.svd(C[1])
    C[1] = (U * np.geomspace(1.0, 1e-9, n)) @ Vt
    F = rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal((nb, n, nw))
    Xj, sj = j_impedance_gj_solve(w, M, B, C, F, refine=2, precision="mixed",
                                  factor_dtype=j_fd, promote_tol=1e-9,
                                  return_stats=True)
    Xt, st = G.impedance_gj_solve(*(torch.tensor(a) for a in (w, M, B, C, F)),
                                  refine=2, precision="mixed",
                                  factor_dtype=t_fd, promote_tol=1e-9,
                                  return_stats=True)
    Xj, Xt = np.asarray(Xj), Xt.numpy()
    assert int(st["promoted"]) == int(np.asarray(sj["promoted"])) >= nw
    assert st["lanes"] == sj["lanes"] == nb * nw
    assert _rel(Xt[1], Xj[1]) < ILL_TOL
    assert _rel(Xt[[0, 2]], Xj[[0, 2]]) < tol


# ---------------------------------------------------------------------------
# the dispatch under each mode
# ---------------------------------------------------------------------------

def _impedance_inputs(rng, nb=2, n=6, nw=7):
    w = np.linspace(0.2, 1.5, nw)
    M = rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[None, :, :, None]
    B = 0.1 * rng.standard_normal((nb, n, n, nw))
    C = rng.standard_normal((nb, n, n)) + 10.0 * np.eye(n)
    F = rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal((nb, n, nw))
    return w, M, B, C, F


def test_f32_mode_matches_jax():
    rng = np.random.default_rng(47)
    args = _impedance_inputs(rng)
    Z = rng.standard_normal((5, 6, 6)) + 6 * np.eye(6) \
        + 1j * rng.standard_normal((5, 6, 6))
    _config.set_precision_mode("f32")
    j_config.set_precision_mode("f32")
    Xt = TL.impedance_solve(*(torch.tensor(a) for a in args))
    Xj = np.asarray(JL.impedance_solve(*(jnp.asarray(a) for a in args)))
    assert Xt.dtype == torch.complex128
    assert _rel(Xt.numpy(), Xj) < 1e-5
    It = TL.inv_complex(torch.tensor(Z))
    Ij = np.asarray(JL.inv_complex(jnp.asarray(Z)))
    assert _rel(It.numpy(), Ij) < 1e-5
    d = TL.last_dispatch()
    assert d["precision"] == "f32" and d["solve_width"] == "f32"
    assert d["kernel"] == "gj_solve_f32" and d["factor_width"] is None


def test_mixed_mode_matches_f64_and_records_the_ladder():
    rng = np.random.default_rng(53)
    args = [torch.tensor(a) for a in _impedance_inputs(rng)]
    X64 = TL.impedance_solve(*args)
    assert TL.last_dispatch()["precision"] == "f64"
    for width in ("f32", "bf16"):
        _config.set_precision_mode("mixed")
        _config.set_precision_width(width)
        Xm = TL.impedance_solve(*args)
        d = TL.last_dispatch()
        assert _rel(Xm.numpy(), X64.numpy()) < 1e-10
        assert d["precision"] == "mixed" and d["solve_width"] == "f64"
        assert d["factor_width"] == width and d["promote_tol"] == 1e-9
        assert d["fused"] and d["backend"] == "plain_fused"
        assert d["kernel"] == ("impedance_gj_mixed" if width == "f32"
                               else "impedance_gj_mixed_bf16")
        assert d["lanes"] == 14
        assert int(d["promoted"]) == (0 if width == "f32" else 14)
        assert "precision_degenerate" not in d


def test_mixed_request_that_cannot_narrow_is_recorded():
    """complex64 systems embed at f32: an f32 elimination width does not
    narrow them, so the solve runs native and says so."""
    rng = np.random.default_rng(59)
    Z = torch.tensor(rng.standard_normal((3, 4, 4)) + 4 * np.eye(4),
                     dtype=torch.complex64)
    _config.set_precision_mode("mixed")
    TL.inv_complex(Z)
    d = TL.last_dispatch()
    assert d["precision_degenerate"] is True
    assert d["kernel"] == "gj_solve" and d["factor_width"] is None
    assert "promoted" not in d


@pytest.mark.parametrize("mode", ["mixed", "f32"])
def test_mixed_and_f32_around_lu_at_2n_18_match_f64(mode):
    """Above the kernels (2n = 18) mixed and f32 used to raise; they now
    run around LU, recorded as such, and agree with the f64 solve (the
    ladder to its promotion tolerance, f32 to its width)."""
    rng = np.random.default_rng(61)
    Z = torch.tensor(rng.standard_normal((2, 9, 9)) + 9 * np.eye(9),
                     dtype=torch.complex128)
    _config.set_precision_mode("f64")
    ref = TL.inv_complex(Z)
    assert TL.last_dispatch()["backend"] == "lu"
    _config.set_precision_mode(mode)
    try:
        got = TL.inv_complex(Z)
        d = TL.last_dispatch()
    finally:
        _config.set_precision_mode("f64")
    assert d["backend"] == "lu" and d["precision"] == mode and d["n"] == 18
    rel = float(torch.max(torch.abs(got - ref)) / torch.max(torch.abs(ref)))
    if mode == "mixed":
        assert d["factor_width"] == "f32" and d["lanes"] == 2
        assert "promoted" in d and rel < 1e-9
    else:
        assert d["solve_width"] == "f32" and rel < 1e-5


def test_unknown_precision_raises_typed():
    A = torch.eye(4, dtype=torch.float64)[None]
    b = torch.ones((1, 4, 1), dtype=torch.float64)
    with pytest.raises(errors.ModelConfigError):
        G.gj_solve(A, b, precision="f16")


@pytest.mark.parametrize("width", ["f32", "bf16"])
@pytest.mark.parametrize("n,k", [(2, 3), (6, 7), (12, 7), (12, 12),
                                 (16, 13)])
def test_ladder_in_column_chunks_matches_unchunked(width, n, k):
    """``ladder_in_chunks``, the card wrapper's rule for the ladder with
    k > n/2 right-hand sides (the kernels take at most n/2): run on the
    plain version in column chunks of n/2, with one promotion decision per
    lane from the rn of all chunks, it gives the unchunked plain ladder's
    x (to rounding) and promoted count.  Every 4th lane is conditioned to
    1e9 (it promotes), one has a NaN, and one lane's last column is 1e6x the
    others (a chunk's own rn would misjudge it)."""
    t_fd = WIDTHS[width][0]
    rng = np.random.default_rng(60 + n + k)
    lanes = 23
    A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
    for i in range(0, lanes, 4):
        U, _, Vt = np.linalg.svd(A[i])
        A[i] = (U * np.geomspace(1.0, 1e-9, n)) @ Vt
    A[5, 0, 1] = np.nan
    b = rng.standard_normal((lanes, n, k))
    b[7, :, -1] *= 1e6
    A, b = torch.tensor(A), torch.tensor(b)
    kw = dict(refine=2, precision="mixed", factor_dtype=t_fd)
    x0, st0 = G.gj_solve_plain(A, b, promote_tol=1e-9, return_stats=True,
                               **kw)

    def solve_chunk(bc):
        x, st = G.gj_solve_plain(A, bc, promote_tol=float("inf"),
                                 return_stats=True, **kw)
        return x, st["rn"]

    x, rn, promoted = G.ladder_in_chunks(
        A, b, n // 2, solve_chunk, lambda Ap, bp: G.gj_solve_plain(
            Ap, bp, refine=2), 1e-9)
    assert int(promoted) == int(st0["promoted"]) >= 6
    np.testing.assert_array_equal((rn <= 1e-9).numpy(),
                                  (st0["rn"] <= 1e-9).numpy())
    # the residual sums vectorise in another order at another column
    # count, so x after refinement agrees to rounding (and the rn of a
    # diverging cond-1e9 lane by far less than its distance from tol)
    bad = torch.isnan(x0)
    assert torch.equal(torch.isnan(x), bad) and bool(bad[5].all())
    ill = torch.arange(0, lanes, 4)
    well = torch.tensor([i for i in range(lanes) if i % 4 and i != 5])
    assert _rel(x[ill], x0[ill]) < ILL_TOL
    assert _rel(x[well], x0[well]) < WIDTHS[width][2]
