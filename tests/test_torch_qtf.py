"""The port's second-order wave loads against the JAX package's, function
by function.

1. Wave-field gradients and the second-order potential
   (``ops/waves.py``) against JAX at rtol 1e-12 (normwise over each
   output): nodes above and below water, the w1 == w2 diagonal, headings
   0 and 0.35 rad, deep and shallow kh.
2. The pair grid: the port's ``calc_qtf_slender_body`` (K5's plain
   version on the CPU) against the JAX package's vmapped path and its
   Pallas K5 in interpret mode (``RAFT_TPU_QTF_KERNEL=1``, reset after),
   on the spar of tests/test_qtf_kernel.py at nw2 = 5 in its four
   variants, 1e-10 relative to max|Q|.
3. Host code: ``hydro_force_2nd`` in both interpolation modes, the
   ``.12d`` round trip between the two packages' writers and readers,
   ``write_rao_4`` byte for byte, ``interp`` against ``jnp.interp``, the
   QTF cache key against the JAX Model's hash of the same inputs, the
   spar flagged MacCamy-Fuchs (its QTF with the Kim & Yue correction),
   and ``outFolderQTF``: the port's Model writes the .4 /
   .12d / .key snapshot, a second run reloads it (no K5 evaluation) with
   the same results, and the JAX reader reads the port's .12d.
Inputs are made from numpy seeds and handed to both packages.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import _config as jconfig
from raft_tpu.models import fowt as JF
from raft_tpu.models import qtf as JQ
from raft_tpu.ops import waves as JW

from raft_tpu_torch import Model, errors
from raft_tpu_torch.convert import state_from_numpy
from raft_tpu_torch.io.designs import load_design
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import qtf as TQ
from raft_tpu_torch.models.qtf_cases import SPAR_W, seeded_rao, spar_design
from raft_tpu_torch.ops import waves as TW
from raft_tpu_torch.ops.kernels import qtf_pair as K

OPS_TOL = 1e-12
QTF_TOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(got - ref))) / scale if scale else \
        float(np.max(np.abs(got)))


# ---------------------------------------------------------------------------
# 1. ops
# ---------------------------------------------------------------------------

#: nodes below, at and above the free surface
NODES = np.array([[0.0, 0.0, -20.0], [3.0, -2.0, -5.0], [-4.0, 1.5, -0.5],
                  [1.0, 1.0, 0.0], [2.0, 0.0, 3.0]])


@pytest.fixture(params=[(200.0, 0.0), (200.0, 0.35), (25.0, 0.0),
                        (25.0, 0.35)], ids=["deep-b0", "deep-b035",
                                            "shallow-b0", "shallow-b035"])
def sea(request):
    """(depth, heading, w, k): 0.005-0.4 Hz, so kh spans both sides of
    the gradient kernels' kh >= 10 switch at 200 m and stays shallow at
    25 m."""
    h, beta = request.param
    w = np.linspace(0.03, 2.5, 12)
    k = np.asarray(JW.wave_number(w, h))
    return h, beta, w, k


def test_wave_vel_gradient_matches_jax(sea):
    h, beta, w, k = sea
    r = NODES[:, None, :]
    ref = JW.wave_vel_gradient(w, k, beta, h, r)
    got = TW.wave_vel_gradient(torch.tensor(w), torch.tensor(k), beta, h,
                               torch.tensor(r))
    assert _rel(got, ref) < OPS_TOL
    # the acceleration gradient at one frequency (both packages scale by
    # a w that broadcasts against the trailing (3, 3) axes)
    ref = JW.wave_acc_gradient(w[3], k[3], beta, h, NODES)
    got = TW.wave_acc_gradient(torch.tensor(w[3]), torch.tensor(k[3]), beta,
                               h, torch.tensor(NODES))
    assert _rel(got, ref) < OPS_TOL


def test_wave_pres1st_gradient_matches_jax(sea):
    h, beta, w, k = sea
    r = NODES[:, None, :]
    ref = JW.wave_pres1st_gradient(k, beta, h, r, rho=1025.0, g=9.81)
    got = TW.wave_pres1st_gradient(torch.tensor(k), beta, h,
                                   torch.tensor(r), rho=1025.0, g=9.81)
    assert _rel(got, ref) < OPS_TOL


def test_wave_pot_2nd_order_matches_jax(sea):
    """Every pair of the grid (the diagonal included) at every node."""
    h, beta, w, k = sea
    w1, w2 = w[:, None, None], w[None, :, None]
    k1, k2 = k[:, None, None], k[None, :, None]
    ref_a, ref_p = JW.wave_pot_2nd_order(w1, w2, k1, k2, beta, beta, h,
                                         NODES)
    T = torch.tensor
    got_a, got_p = TW.wave_pot_2nd_order(T(w1), T(w2), T(k1), T(k2), beta,
                                         beta, h, T(NODES))
    assert _rel(got_a, ref_a) < OPS_TOL
    assert _rel(got_p, ref_p) < OPS_TOL
    # zero on the diagonal and above water
    idx = np.arange(len(w))
    assert np.all(_np(got_p)[idx, idx] == 0.0)
    assert np.all(_np(got_a)[:, :, NODES[:, 2] > 0] == 0.0)


# ---------------------------------------------------------------------------
# 2. the pair grid
# ---------------------------------------------------------------------------

VARIANTS = {
    "waterline": dict(rB_z=10.0, beta=0.0, motion=True),
    "no_waterline": dict(rB_z=-5.0, beta=0.0, motion=True),
    "no_motion": dict(rB_z=10.0, beta=0.0, motion=False),
    "beta_035": dict(rB_z=10.0, beta=0.35, motion=True),
}


def spar_inputs(rB_z, motion):
    """The JAX-built spar, its pose and the (Xi0, M_struc) keywords."""
    jf = JF.build_fowt(spar_design(rB_z), SPAR_W, depth=200.0)
    jp = JF.fowt_pose(jf, np.zeros(6))
    kw = {}
    if motion:
        stat = JF.fowt_statics(jf, jp)
        kw = dict(Xi0=seeded_rao(len(SPAR_W)),
                  M_struc=np.asarray(stat["M_struc"]))
    return jf, jp, kw


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_qtf_matches_jax_vmapped_and_pallas(variant):
    v = VARIANTS[variant]
    jf, jp, kw = spar_inputs(v["rB_z"], v["motion"])
    ref = np.asarray(JQ.calc_qtf_slender_body(jf, jp, v["beta"], **kw))
    jconfig.set_qtf_kernel_mode("1")
    try:
        ref_k = np.asarray(JQ.calc_qtf_slender_body(jf, jp, v["beta"], **kw))
    finally:
        jconfig.set_qtf_kernel_mode(None)
    tf = state_from_numpy(jf, "cpu")
    tp = TF.fowt_pose(tf, np.zeros(6))
    got = TQ.calc_qtf_slender_body(tf, tp, v["beta"], **kw)
    assert got.shape == (5, 5, 6) and got.dtype == torch.complex128
    assert _rel(got, ref) < QTF_TOL
    assert _rel(got, ref_k) < QTF_TOL
    fields = TQ.qtf_fields(tf, tp, v["beta"], **kw)
    assert (fields["wl"] is None) == (v["rB_z"] < 0)


def test_pair_grid_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch; the kernel's operands are lane-last, as ``qtf_fields`` builds
    them, contiguous and checked."""
    jf, jp, kw = spar_inputs(10.0, True)
    tf = state_from_numpy(jf, "cpu")
    tp = TF.fowt_pose(tf, np.zeros(6))
    fields = TQ.qtf_fields(tf, tp, 0.0, **kw)
    K.reset_launches()
    Q = K.qtf_pair_grid(fields, 0.0, 200.0, 1025.0, 9.81)
    assert K.LAUNCHES["qtf_pair"] == 0
    assert torch.equal(Q, K.qtf_pair_grid_plain(fields, 0.0, 200.0, 1025.0,
                                                9.81))
    ops, (nw2, N, nm) = K.kernel_operands(fields)
    assert (nw2, nm) == (5, 1) and N == fields["q"].shape[0]
    assert ops["gu"].shape == (N, 3, 3, 5) and ops["gu"].is_contiguous()
    assert ops["wlc"].shape == (1, 3, 3, 5)
    bad = dict(fields, u=fields["u"].to(torch.complex64))
    with pytest.raises(errors.KernelFailure):
        K.kernel_operands(bad)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in fields.items()}
    with pytest.raises(errors.KernelFailure):
        K.qtf_pair_grid(meta, 0.0, 200.0, 1025.0, 9.81)


def test_qtf_plain_chunking_is_exact(monkeypatch):
    """The plain version's w1-row chunks change no value."""
    jf, jp, kw = spar_inputs(10.0, True)
    tf = state_from_numpy(jf, "cpu")
    fields = TQ.qtf_fields(tf, TF.fowt_pose(tf, np.zeros(6)), 0.35, **kw)
    whole = K.qtf_pair_grid_plain(fields, 0.35, 200.0, 1025.0, 9.81)
    monkeypatch.setattr(K, "_PLAIN_CHUNK_BYTES", 1)
    rows = K.qtf_pair_grid_plain(fields, 0.35, 200.0, 1025.0, 9.81)
    assert _rel(rows, whole) < 1e-15


def test_non_finite_field_at_a_dry_node_raises(monkeypatch):
    """K5 skips the nodes above water, where the plain version and the
    JAX package multiply the wrench by 0; ``qtf_fields`` refuses a
    non-finite field there, so a NaN cannot come out of one and not the
    other.  A NaN at a submerged node is left to reach both."""
    jf, jp, kw = spar_inputs(10.0, True)
    tf = state_from_numpy(jf, "cpu")
    tp = TF.fowt_pose(tf, np.zeros(6))
    seen = []
    monkeypatch.setattr(TQ, "check_dry_nodes",
                        lambda fl: seen.append(K.check_dry_nodes(fl)))
    fields = TQ.qtf_fields(tf, tp, 0.0, **kw)
    assert len(seen) == 1
    dry = fields["nodescal"][:, 3] == 0.0
    assert 0 < int(dry.sum()) < int(dry.numel())
    for name in ("u", "gu", "nax", "Minert"):
        t = fields[name].clone()
        t[dry] = float("nan")
        with pytest.raises(errors.NonFiniteResult, match=name):
            K.check_dry_nodes(dict(fields, **{name: t}))
        t = fields[name].clone()
        t[~dry] = float("nan")
        K.check_dry_nodes(dict(fields, **{name: t}))


def test_mcf_spar_qtf_with_kim_yue_matches_jax():
    """The spar flagged MacCamy-Fuchs in both packages, once refused here:
    its QTF, the Kim & Yue correction added to the pair grid, against the
    JAX package's at 1e-10 of max|Q|, and the correction moves it."""
    jf, jp, kw = spar_inputs(10.0, True)
    jf.members[0] = dataclasses.replace(jf.members[0], MCF=True)
    tf = state_from_numpy(jf, "cpu")
    assert tf.members[0].MCF
    tp = TF.fowt_pose(tf, np.zeros(6))
    ref = np.asarray(JQ.calc_qtf_slender_body(jf, jp, 0.35, **kw))
    got = TQ.calc_qtf_slender_body(tf, tp, 0.35, **kw)
    assert _rel(got, ref) <= QTF_TOL
    ky = _np(TQ.kim_yue_correction(tf, tp, 0.35))
    assert np.max(np.abs(ky)) > 1e-6 * np.max(np.abs(ref))


# ---------------------------------------------------------------------------
# 3. host code
# ---------------------------------------------------------------------------

def _qtf_and_spectrum(rng, nh):
    w2 = np.arange(0.02, 0.17, 0.02) * 2 * np.pi
    nw2 = len(w2)
    Q = rng.normal(size=(nw2, nw2, nh, 6)) \
        + 1j * rng.normal(size=(nw2, nw2, nh, 6))
    Q = Q + np.conj(np.swapaxes(Q, 0, 1))        # Hermitian per heading
    w = np.arange(0.01, 0.205, 0.01) * 2 * np.pi  # wider than the QTF grid
    S = np.abs(rng.normal(size=len(w)))
    return Q, w2, w, S


@pytest.mark.parametrize("mode", ["qtf", "spectrum"])
@pytest.mark.parametrize("nh,beta", [(1, 0.0), (3, 0.2), (3, -1.0),
                                     (3, 2.0)])
def test_hydro_force_2nd_matches_jax(mode, nh, beta):
    """Both interpolation modes; one heading, and three with the case
    heading between them and clamped below and above."""
    rng = np.random.default_rng(11 + nh)
    Q, w2, w, S = _qtf_and_spectrum(rng, nh)
    heads = np.linspace(0.0, 0.6, nh)
    ref_m, ref_f = JQ.hydro_force_2nd(Q, heads, w2, beta, S, w,
                                      interp_mode=mode)
    got_m, got_f = TQ.hydro_force_2nd(Q, heads, w2, beta, S, w,
                                      interp_mode=mode)
    assert got_f.shape == (6, len(w))
    assert _rel(got_m, ref_m) < OPS_TOL
    assert _rel(got_f, ref_f) < OPS_TOL
    with pytest.raises(ValueError):
        TQ.hydro_force_2nd(Q, heads, w2, beta, S, w, interp_mode="none")


def test_interp_matches_jnp():
    rng = np.random.default_rng(5)
    xp = np.sort(rng.uniform(0.0, 1.0, 9))
    fp = rng.normal(size=(3, 9))
    x = np.concatenate([[-0.1, xp[0], xp[-1], 1.3], rng.uniform(0, 1, 20)])
    got = TQ.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp))
    for i in range(3):
        ref = np.asarray(jnp.interp(x, xp, fp[i], left=0.0, right=0.0))
        np.testing.assert_allclose(_np(got[i]), ref, rtol=1e-15, atol=0.0)


def test_qtf_12d_round_trip(tmp_path):
    """Port writer -> JAX reader -> JAX writer -> port reader, and the two
    writers' bytes are the same."""
    rng = np.random.default_rng(9)
    Q, w2, _, _ = _qtf_and_spectrum(rng, 2)
    heads = [0.0, 0.5]
    TQ.write_qtf_12d(tmp_path / "port.12d", Q, w2, heads)
    JQ.write_qtf_12d(tmp_path / "jax.12d", Q, w2, heads)
    assert (tmp_path / "port.12d").read_bytes() == \
        (tmp_path / "jax.12d").read_bytes()
    jd = JQ.read_qtf_12d(tmp_path / "port.12d")
    JQ.write_qtf_12d(tmp_path / "again.12d", jd.qtf, jd.w, jd.heads_rad)
    td = TQ.read_qtf_12d(tmp_path / "again.12d")
    np.testing.assert_allclose(td.w, w2, rtol=1e-8)
    np.testing.assert_allclose(td.heads_rad, heads, atol=1e-12)
    # 9 significant digits in the file
    assert np.max(np.abs(td.qtf - Q)) < 1e-7 * np.max(np.abs(Q))
    jd2 = JQ.read_qtf_12d(tmp_path / "again.12d")
    np.testing.assert_array_equal(td.qtf, jd2.qtf)


def test_write_rao_4_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    w = np.arange(0.02, 0.21, 0.02) * 2 * np.pi
    Xi = rng.normal(size=(6, len(w))) + 1j * rng.normal(size=(6, len(w)))
    TQ.write_rao_4(tmp_path / "p.4", w, 0.35, Xi)
    JQ.write_rao_4(tmp_path / "j.4", w, 0.35, Xi)
    assert (tmp_path / "p.4").read_bytes() == (tmp_path / "j.4").read_bytes()


def test_cache_key_matches_the_jax_models_hash():
    """``cache_key`` on the port's copy of a FOWT gives the digest the JAX
    Model computes (raft_tpu/model.py:1172-1199) from the JAX objects."""
    jf, jp, kw = spar_inputs(10.0, True)
    tf = state_from_numpy(jf, "cpu")
    rng = np.random.default_rng(4)
    r6 = rng.normal(size=6)
    RAO = rng.normal(size=(6, len(SPAR_W))) \
        + 1j * rng.normal(size=(6, len(SPAR_W)))
    M = np.asarray(kw["M_struc"])
    beta0 = 0.35

    h = hashlib.sha256()        # the JAX Model's lines, on the JAX objects
    for a in (r6, [beta0], RAO, M, jf.w1_2nd):
        h.update(np.ascontiguousarray(np.asarray(a, dtype=complex)).tobytes())
    for fld in sorted(f.name for f in dataclasses.fields(jf.nodes)):
        val = getattr(jf.nodes, fld)
        h.update(fld.encode())
        if val is not None:
            h.update(np.ascontiguousarray(np.asarray(val, dtype=float))
                     .tobytes())
    h.update(np.asarray([jf.depth, jf.rho_water, jf.g]).tobytes())
    h.update(np.asarray([bool(getattr(m, "MCF", False)) for m in jf.members],
                        dtype=bool).tobytes())
    for m in jf.members:
        h.update(np.ascontiguousarray(np.asarray([m.rA0, m.rB0],
                                                 dtype=float)).tobytes())
    assert TQ.cache_key(tf, r6, beta0, torch.tensor(RAO), torch.tensor(M)) \
        == h.hexdigest()


def test_out_folder_qtf_snapshot_and_reload(tmp_path, monkeypatch):
    out = tmp_path / "qtf"
    d = load_design("Vertical_cylinder")
    d["settings"].update(min_freq=0.02, max_freq=0.2)
    d["platform"].update(potSecOrder=1, min_freq2nd=0.02, max_freq2nd=0.16,
                         outFolderQTF=str(out))
    keys = d["cases"]["keys"]
    row = dict(zip(keys, d["cases"]["data"][0]))
    row.update(wave_spectrum="JONSWAP", wave_period=10.0, wave_height=6.0)
    d["cases"]["data"] = [[row[k] for k in keys]]
    m1 = Model(d, device="cpu")
    m1.analyzeCases()
    tag = "Head0_Case1_WT0"
    q12 = out / f"qtf-slender_body-total_{tag}.12d"
    assert (out / f"raos-slender_body_{tag}.4").is_file()
    assert q12.is_file() and (out / (q12.name + ".key")).is_file()
    jd = JQ.read_qtf_12d(str(q12))
    assert jd.qtf.shape == (8, 8, 1, 6)

    def no_k5(*a, **k):
        raise AssertionError("the cached QTF was not reloaded")

    monkeypatch.setattr(TQ, "calc_qtf_slender_body", no_k5)
    m2 = Model(d, device="cpu")
    m2.analyzeCases()
    c1, c2 = m1.results["case_metrics"][0][0], m2.results["case_metrics"][0][0]
    for ch in ("surge", "heave", "pitch"):
        assert abs(c2[f"{ch}_std"] - c1[f"{ch}_std"]) \
            <= 1e-7 * abs(c1[f"{ch}_std"])
