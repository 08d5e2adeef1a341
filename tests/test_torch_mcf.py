"""MacCamy-Fuchs members in the port, function by function, against the JAX
package (float64, CPU) on OC4semi with ``MCF: True`` on its circular
columns (``models/mcf_cases.py``):

- the special functions against ``raft_tpu.ops.special`` at 1e-12
  relative over the kR the configurations reach (1e-3 to 8, orders
  0-12), ``bessel_jn`` against ``jax.scipy.special.bessel_jn`` and
  ``scipy.special.jv`` at 1e-12, and H^(1)_n and its derivative against
  ``scipy.special.hankel1`` at the JAX test's 1e-6 (``tests/test_mcf.py``);
- the build: the member flags and the node columns ``MCF`` / ``R``
  carried across by ``convert.state_from_numpy``;
- ``fowt_hydro_constants``' (N, 3, 3, nw) complex ``Imat`` and
  ``fowt_hydro_excitation`` (two headings on the case axis) at an offset
  pose against the JAX functions at 1e-12, on the coarse grid;
- ``kim_yue_correction`` against the JAX function at 1e-10 of max|F|, at
  two headings and an offset pose on the coarse second-order grid (8
  bins) and on (c2)'s full one (30 bins);
- the QTF cache key changes when one member's MCF flag does.
"""
import copy
import dataclasses

import numpy as np
import pytest
import scipy.special as sp
import torch

from raft_tpu.models import fowt as JF
from raft_tpu.models import qtf as JQ
from raft_tpu.ops import special as JS

from raft_tpu_torch.convert import state_from_numpy
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import mcf_cases as FC
from raft_tpu_torch.models import qtf as TQ
from raft_tpu_torch.ops import special as TS

SPECIAL_TOL = 1e-12
IMAT_TOL = 1e-12
KY_TOL = 1e-10
#: kR over the configurations' range, and the points of tests/test_mcf.py
X = np.concatenate([np.geomspace(1e-3, 8.0, 120),
                    [0.02, 0.3, 1.0, 2.9, 3.1, 5.0, 9.0, 15.0]])
#: an offset pose, so that the member poses are not the build's
POSE = np.array([1.0, 0.2, -0.3, 0.01, 0.02, 0.015])


def _rel(a, b):
    """Largest elementwise relative deviation."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _rel_max(a, b):
    """Largest deviation relative to max|b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("name", ["bessel_j0", "bessel_j1", "bessel_y0",
                                  "bessel_y1"])
def test_bessel_matches_jax(name):
    ref = np.asarray(getattr(JS, name)(X))
    got = getattr(TS, name)(X)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < SPECIAL_TOL


@pytest.mark.parametrize("fn", ["hankel1_all", "hankel1p_all"])
def test_hankel_matches_jax(fn):
    ref = np.asarray(getattr(JS, fn)(X, 12))
    got = getattr(TS, fn)(X, 12).numpy()
    assert got.shape == ref.shape == (13, len(X))
    assert _rel(got, ref) < SPECIAL_TOL


@pytest.mark.parametrize("nmax", [0, 4, 12])
def test_bessel_jn_matches_jax_scipy_and_scipy(nmax):
    from jax.scipy.special import bessel_jn

    got = TS.bessel_jn(X, nmax).numpy()
    ref = np.asarray(bessel_jn(X, v=nmax))
    assert got.shape == ref.shape == (nmax + 1, len(X))
    assert _rel(got, ref) < SPECIAL_TOL
    jv = np.stack([sp.jv(n, X) for n in range(nmax + 1)])
    assert _rel(got, jv) < SPECIAL_TOL


def test_hankel_vs_scipy():
    x = np.array([0.02, 0.3, 1.0, 2.9, 3.1, 5.0, 9.0, 15.0])
    H = TS.hankel1_all(x, 12).numpy()
    ref = np.stack([sp.hankel1(n, x) for n in range(13)])
    assert np.abs((H - ref) / ref).max() < 1e-6
    Hp = TS.hankel1p_all(x, 11).numpy()
    refp = np.stack([0.5 * (sp.hankel1(n - 1, x) - sp.hankel1(n + 1, x))
                     for n in range(12)])
    assert np.abs((Hp - refp) / refp).max() < 1e-6


def _built(design):
    s = design["settings"]
    w = np.arange(s["min_freq"], s["max_freq"] + 0.5 * s["min_freq"],
                  s["min_freq"]) * 2 * np.pi
    depth = float(design["site"]["water_depth"])
    jf = JF.build_fowt(design, w, depth=depth)
    tf = TF.build_fowt(design, w, depth=depth, device="cpu")
    return jf, tf, JF.fowt_pose(jf, POSE), TF.fowt_pose(tf, POSE)


@pytest.fixture(scope="module")
def semi():
    """(c2) on the coarse grid, built by both packages."""
    return _built(FC.mcf_qtf_design(coarse=True))


def test_mcf_flags_built_and_carried_across(semi):
    jf, tf, _, _ = semi
    flags = [m.MCF for m in tf.members]
    assert flags == [m.MCF for m in jf.members]
    assert sum(flags) == 4
    assert {n for n, f in zip(tf.member_names, flags) if f} \
        == set(FC.MCF_MEMBERS)
    # convert.state_from_numpy carries the member flag and the node
    # columns MCF (bool) and R across from the JAX package's build
    cf = state_from_numpy(jf, "cpu")
    assert [m.MCF for m in cf.members] == flags
    assert cf.nodes.MCF.dtype == torch.bool
    assert torch.equal(cf.nodes.MCF, torch.as_tensor(np.asarray(
        jf.nodes.MCF)))
    assert torch.equal(cf.nodes.MCF, torch.as_tensor(tf.nodes.MCF))
    np.testing.assert_array_equal(cf.nodes.R.numpy(), np.asarray(jf.nodes.R))
    assert int(cf.nodes.MCF.sum()) > 0


def test_mcf_imat_and_excitation_match_jax(semi):
    jf, tf, jp, tp = semi
    jh, th = JF.fowt_hydro_constants(jf, jp), TF.fowt_hydro_constants(tf, tp)
    a, b = np.asarray(jh["Imat"]), th["Imat"].numpy()
    assert b.shape == (tf.nodes.n, 3, 3, tf.nw) and b.dtype == np.complex128
    assert _rel_max(b, a) <= IMAT_TOL
    # frequency-dependent on the MCF nodes only
    mcf = np.asarray(torch.as_tensor(tf.nodes.MCF).numpy(), bool)
    assert np.ptp(np.abs(b[mcf]), axis=-1).max() > 0
    assert np.ptp(np.abs(b[~mcf]), axis=-1).max() == 0
    sea = dict(beta=np.array([0.3, 1.1]),
               zeta=np.full((2, tf.nw), 0.5 + 0.1j))
    je = JF.fowt_hydro_excitation(jf, jp, sea, jh)
    te = TF.fowt_hydro_excitation(tf, tp, sea, th)
    a, b = np.asarray(je["F_hydro_iner"]), te["F_hydro_iner"].numpy()
    assert b.shape == (2, 6, tf.nw)
    assert _rel_max(b, a) <= IMAT_TOL


@pytest.mark.parametrize("beta", [0.0, 0.4])
def test_kim_yue_matches_jax(semi, beta):
    jf, tf, jp, tp = semi
    ref = np.asarray(JQ.kim_yue_correction(jf, jp, beta))
    got = TQ.kim_yue_correction(tf, tp, beta)
    assert isinstance(got, torch.Tensor) and got.shape == (8, 8, 6)
    assert np.max(np.abs(ref)) > 0
    assert _rel_max(got.numpy(), ref) <= KY_TOL


def test_kim_yue_matches_jax_on_the_full_grid():
    """(c2)'s own second-order grid, 30 x 30 pairs."""
    d = FC.mcf_qtf_design(coarse=False)
    d["settings"].update(max_freq=0.05)     # the first-order grid: unused
    jf, tf, jp, tp = _built(d)
    assert len(tf.w1_2nd) == 30
    ref = np.asarray(JQ.kim_yue_correction(jf, jp, 0.25))
    got = TQ.kim_yue_correction(tf, tp, 0.25).numpy()
    assert _rel_max(got, ref) <= KY_TOL


def test_qtf_cache_key_sees_the_mcf_flag(semi):
    _, tf, _, _ = semi
    args = (np.zeros(6), 0.0, np.ones((6, tf.nw), complex), np.eye(6))
    key = TQ.cache_key(tf, *args)
    assert TQ.cache_key(tf, *args) == key
    off = copy.copy(tf)
    off.members = [dataclasses.replace(tf.members[0], MCF=False)] \
        + list(tf.members[1:])
    assert tf.members[0].MCF
    assert TQ.cache_key(off, *args) != key
