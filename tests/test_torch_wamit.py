"""WAMIT coefficient files: the port's readers, writers, interpolation and
potential-flow excitation against the JAX package's, on the same files.

1. Synthetic files that the JAX package's writers put in ``tmp_path``
   (with zero- and infinite-frequency rows appended): the readers equal
   (periods and the HAMS omega convention, the single-frequency warning,
   the NaN screens raising ``NonFiniteResult``), ``load_bem`` at 1e-12
   with the A-infinity extension above the data and the missing-.3
   branch, the port's writers byte for byte equal to JAX's,
   ``rotate_to_wave_frame`` and ``bem_excitation`` over a batch of
   headings (wraparound, ``heading_adjust``, an array position) at 1e-12.
2. The committed OC4semi cache (``tests/golden/oc4semi_bem/``, the JAX
   package's native-BEM solve at the YAML's settings): the parsed files
   equal, and ``load_bem`` on the model grid, ``bem_coeffs`` and
   ``bem_excitation`` over every cache heading and a batch of seeded
   cases at 1e-12.
"""
import os

import numpy as np
import pytest
import torch

from raft_tpu.io import wamit as JW

from raft_tpu_torch import errors
from raft_tpu_torch.io import wamit as TW

TOL = 1e-12
RHO, G = 1025.0, 9.81
W_MODEL = np.arange(0.05, 1.6, 0.05)
CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                     "oc4semi_bem", "Output")
#: OC4semi's own grid, 0.005-0.40 Hz (80 bins)
OC4SEMI_W = np.arange(0.005, 0.4025, 0.005) * 2 * np.pi


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _coeffs(seed=3, nf=6, nh=4):
    rng = np.random.default_rng(seed)
    w = np.sort(rng.uniform(0.2, 1.2, nf))
    A = rng.normal(size=(6, 6, nf)) * 1e6
    B = rng.normal(size=(6, 6, nf)) * 1e5
    X = (rng.normal(size=(nh, 6, nf)) + 1j * rng.normal(size=(nh, 6, nf))) \
        * 1e6
    heads = np.array([0.0, 90.0, 200.0, 330.0])[:nh]
    return w, A, B, X, heads


@pytest.fixture
def wamit_files(tmp_path):
    """Output.1 (with zero- and infinite-frequency rows) and Output.3 by
    the JAX writers."""
    w, A, B, X, heads = _coeffs()
    base = str(tmp_path / "Output")
    JW.write_wamit1(base + ".1", w, A, B, rho=RHO)
    JW.write_wamit3(base + ".3", w, heads, X, rho=RHO, g=G)
    rng = np.random.default_rng(5)
    with open(base + ".1", "a") as f:
        for T, M in ((-1.0, rng.normal(size=(6, 6))),
                     (0.0, rng.normal(size=(6, 6)))):
            for i in range(6):
                for j in range(6):
                    f.write(f"{T:14.6e} {i+1:d} {j+1:d} {M[i, j]:14.6e}\n")
    return base


# ---------------------------------------------------------------------------
# 1. synthetic files
# ---------------------------------------------------------------------------

def test_read_wamit_matches_jax(wamit_files):
    _same(TW.read_wamit1(wamit_files + ".1"), JW.read_wamit1(wamit_files + ".1"))
    _same(TW.read_wamit3(wamit_files + ".3"), JW.read_wamit3(wamit_files + ".3"))
    d1 = TW.read_wamit1(wamit_files + ".1")
    assert d1["A0"] is not None and d1["Ainf"] is not None
    assert np.all(np.diff(d1["w"]) > 0)


def test_read_wamit_omega_convention(tmp_path):
    """A HAMS omega-format file (column 1 rad/s ascending) is detected as
    such, as by the JAX reader; 'period' forces the other reading."""
    w, A, B, _, _ = _coeffs(nf=4)
    path = str(tmp_path / "hams.1")
    with open(path, "w") as f:
        for n in range(len(w)):
            for i in range(6):
                for j in range(6):
                    f.write(f"{w[n]:14.6e} {i+1} {j+1} {A[i, j, n]:14.6e} "
                            f"{B[i, j, n]:14.6e}\n")
    assert TW._detect_freq_convention([w[0], w[1], w[1], w[2]]) == "omega"
    assert TW._detect_freq_convention([9.0, 7.0, 7.0, 5.0]) == "period"
    got = TW.read_wamit1(path)
    np.testing.assert_allclose(got["w"], np.sort(w), rtol=1e-6)
    _same(got, JW.read_wamit1(path))
    _same(TW.read_wamit1(path, freq="period"),
          JW.read_wamit1(path, freq="period"))


def test_freq_convention_warns_on_one_frequency():
    with pytest.warns(UserWarning, match="fewer than 2"):
        assert TW._detect_freq_convention([6.0, 6.0, -1.0]) == "period"


@pytest.mark.parametrize("ext,col", [(".1", 3), (".3", 5)])   # Abar; Re X
def test_nan_screens(wamit_files, ext, col):
    path = wamit_files + ext
    with open(path) as f:
        lines = f.readlines()
    parts = lines[3].split()
    parts[col] = "nan"
    lines[3] = " ".join(parts) + "\n"
    with open(path, "w") as f:
        f.writelines(lines)
    reader = TW.read_wamit1 if ext == ".1" else TW.read_wamit3
    with pytest.raises(errors.NonFiniteResult, match="non-finite"):
        reader(path)


def test_load_bem_matches_jax(wamit_files):
    """Model grid below and above the data: the zero-frequency pad, the
    interpolation, and A-infinity above the data's top."""
    got = TW.load_bem(wamit_files, W_MODEL, rho=RHO, g=G)
    ref = JW.load_bem(wamit_files, W_MODEL, rho=RHO, g=G)
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        assert _rel(getattr(got, k), getattr(ref, k)) < TOL, k
    np.testing.assert_array_equal(got.headings, ref.headings)
    d1 = TW.read_wamit1(wamit_files + ".1")
    above = W_MODEL > d1["w"][-1]
    assert above.any()
    np.testing.assert_array_equal(
        got.A_BEM[:, :, above],
        RHO * np.repeat(d1["Ainf"][:, :, None], above.sum(), axis=2))


def test_load_bem_without_excitation_file(wamit_files):
    os.remove(wamit_files + ".3")
    got = TW.load_bem(wamit_files, W_MODEL)
    assert got.X_BEM.shape == (1, 6, len(W_MODEL)) and not got.X_BEM.any()
    np.testing.assert_array_equal(got.headings, [0.0])
    with pytest.raises(FileNotFoundError):
        TW.load_bem(wamit_files + "_missing", W_MODEL)


@pytest.mark.parametrize("ext", [".1", ".3"])
def test_writers_match_jax_bytes(tmp_path, ext):
    w, A, B, X, heads = _coeffs()
    tw, jw, args = ((TW.write_wamit1, JW.write_wamit1, (w, A, B))
                    if ext == ".1" else
                    (TW.write_wamit3, JW.write_wamit3, (w, heads, X)))
    tw(str(tmp_path / f"t{ext}"), *args)
    jw(str(tmp_path / f"j{ext}"), *args)
    assert (tmp_path / f"t{ext}").read_bytes() == \
        (tmp_path / f"j{ext}").read_bytes()


def test_rotate_to_wave_frame_matches_jax():
    _, _, _, X, heads = _coeffs()
    np.testing.assert_array_equal(TW.rotate_to_wave_frame(X, heads),
                                  JW.rotate_to_wave_frame(X, heads))


def _excitation_pair(bem, beta, zeta, k, **kw):
    """(port's batched excitation, JAX's one heading at a time)."""
    tbem = TW.BEMData(A_BEM=bem.A_BEM, B_BEM=bem.B_BEM, X_BEM=bem.X_BEM,
                      headings=bem.headings)
    got = TW.bem_excitation(tbem, torch.tensor(beta), torch.tensor(zeta),
                            torch.tensor(k), **kw)
    ref = np.stack([np.asarray(JW.bem_excitation(bem, b, z, k, **kw))
                    for b, z in zip(beta, zeta)])
    return got, ref


@pytest.mark.parametrize("adjust,xy", [(0.0, (0.0, 0.0)),
                                       (10.0, (50.0, -30.0))])
def test_bem_excitation_matches_jax(wamit_files, adjust, xy):
    bem = JW.load_bem(wamit_files, W_MODEL, rho=RHO, g=G)
    rng = np.random.default_rng(9)
    beta = np.deg2rad([0.0, 45.0, 200.0, 345.0, 359.5])
    zeta = rng.uniform(0.1, 1.0, (len(beta), len(W_MODEL))) + 0j
    got, ref = _excitation_pair(bem, beta, zeta, W_MODEL**2 / G,
                                x_ref=xy[0], y_ref=xy[1],
                                heading_adjust=adjust)
    assert got.shape == (len(beta), 6, len(W_MODEL))
    assert _rel(got, ref) < TOL


# ---------------------------------------------------------------------------
# 2. the committed OC4semi cache
# ---------------------------------------------------------------------------

def test_oc4semi_cache_reads_match_jax():
    for ext, t, j in ((".1", TW.read_wamit1, JW.read_wamit1),
                      (".3", TW.read_wamit3, JW.read_wamit3)):
        _same(t(CACHE + ext), j(CACHE + ext))
    d3 = TW.read_wamit3(CACHE + ".3")
    assert d3["X"].shape == (12, 6, 14)
    np.testing.assert_array_equal(d3["headings"], np.arange(0.0, 360.0, 30.0))


@pytest.fixture(scope="module")
def oc4semi_bem():
    """(port, JAX) BEMData of the cache on OC4semi's grid."""
    return (TW.load_bem(CACHE, OC4SEMI_W, rho=RHO, g=G),
            JW.load_bem(CACHE, OC4SEMI_W, rho=RHO, g=G))


def test_oc4semi_load_bem_and_coeffs_match_jax(oc4semi_bem):
    got, ref = oc4semi_bem
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        assert _rel(getattr(got, k), getattr(ref, k)) < TOL, k
    A, B = TW.bem_coeffs(got, len(OC4SEMI_W), device="cpu")
    Aj, Bj = JW.bem_coeffs(ref, len(OC4SEMI_W))
    assert A.dtype == torch.float64 and A.shape == (6, 6, 80)
    assert _rel(A, np.asarray(Aj)) < TOL and _rel(B, np.asarray(Bj)) < TOL
    # the added mass varies over the grid: the impedance's M(w)
    assert float(np.max(np.abs(got.A_BEM - got.A_BEM[..., :1]))) > 0


def test_oc4semi_bem_excitation_matches_jax(oc4semi_bem):
    """Every cache heading, the midpoints and the wraparound, each with a
    seeded sea state."""
    _, ref = oc4semi_bem
    beta = np.deg2rad(np.r_[np.arange(0.0, 360.0, 15.0), 352.5])
    rng = np.random.default_rng(11)
    zeta = (rng.uniform(0.0, 1.0, (len(beta), 80))
            * np.exp(1j * rng.uniform(0, 2 * np.pi, (len(beta), 80))))
    k = np.asarray(torch.tensor(OC4SEMI_W**2 / G))
    got, want = _excitation_pair(ref, beta, zeta, k)
    assert _rel(got, want) < TOL
