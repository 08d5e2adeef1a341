"""The farm slice's parts against the JAX package, function by function.

- ``parse_moordyn``: the stand-in shared mooring of the farm goldens
  (``tests/golden/farm/shared_mooring_standin.dat``) and a variant in the
  schema's other spellings (``Body``/``Vessel``/``Connect``/``Anchor``, the
  depth passed in), every field of the ``ArrayMooring`` equal, dtype too;
- the multi-body mooring on the stand-in (two bodies, seven lines, two
  free points) at its reference poses and at a pose that moves both
  bodies: the free points, the body wrenches and the current wrenches
  (N, 6), the free points' residual, both coupled stiffness flavours
  (12 x 12), the tensions and the tension Jacobian (14 x 12), each
  against the jitted JAX function at 1e-9 of its largest entry;
- the ladder around LU (``ops/linalg.py``, 2n > 16) at 2n = 24 and 48
  under f32, mixed f32 and mixed bf16 against the JAX package's
  ``_solve_real_embedded`` on the same systems (impedance-like stacks
  with a few cond-1e9 lanes that promote): the promoted counts equal and
  the solutions at the ladder's bars;
- the wake module: the host functions against the JAX package's at 1e-12
  (``find_wake_equilibrium`` and ``calc_aep`` on a stand-in model object
  with an explicit curve, iterations equal), every ``*_torch`` function
  against its ``*_jnp`` counterpart at 1e-12 on a case axis whose lanes
  converge at different iterations (each count equal), and
  ``power_thrust_curve`` through the VolturnUS-S rotor's BEM at a few
  speeds, parked ones included.
All inputs are made with numpy from fixed seeds.
"""
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu import _config as j_config
from raft_tpu.models import mooring_array as JA
from raft_tpu.models import wake as JW
from raft_tpu.ops import linalg as JL

from raft_tpu_torch import _config
from raft_tpu_torch.models import farm_cases as FC
from raft_tpu_torch.models import mooring_array as TA
from raft_tpu_torch.models import wake as TW
from raft_tpu_torch.ops import linalg as TL

TOL = 1e-9
WAKE_TOL = 1e-12
XB0 = np.array([[0.0, 0, 0, 0, 0, 0], [1600.0, 0, 0, 0, 0, 0]])
POSES = {"reference": XB0,
         "moved": XB0 + np.array([[12.0, -3.0, 0.4, 0.01, 0.04, -0.02],
                                  [-6.0, 2.0, -0.3, -0.02, 0.03, 0.015]])}
U = np.array([0.8, 0.3, 0.0])
#: the ladder tests' near-singular lanes, and the bar of float32 LU on the
#: others
ILL = (3, 7)
F32_TOL = 1e-3
#: bound for the promoted cond-1e9 lanes: cond * eps * 10
ILL_TOL = 1e9 * 2.2e-16 * 10


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x, float), dtype=torch.float64)


@pytest.fixture(autouse=True)
def _clear_overrides():
    yield
    for cfg in (_config, j_config):
        cfg.set_precision_mode(None)
        cfg.set_precision_width(None)


# ---------------------------------------------------------------------------
# parse_moordyn
# ---------------------------------------------------------------------------

def _variant_file(path):
    """The stand-in in the schema's other spellings, without OPTIONS."""
    with open(FC.STANDIN_FILE) as f:
        text = f.read()
    text = text.split("---------------------- OPTIONS")[0]
    for a, b in (("Turbine1", "Body1"), ("Turbine2", "Vessel2"),
                 ("Free ", "Connect "), ("Fixed", "Anchor")):
        text = text.replace(a, b)
    with open(path, "w") as f:
        f.write(text)
    return path


def _assert_same(ta, ja):
    import dataclasses
    for fld in dataclasses.fields(ja):
        x, y = getattr(ja, fld.name), getattr(ta, fld.name)
        assert type(x) is type(y), fld.name
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, fld.name
            np.testing.assert_array_equal(y, x, err_msg=fld.name)
        else:
            assert x == y, fld.name


def test_parse_moordyn_field_for_field(tmp_path):
    ta = TA.parse_moordyn(FC.STANDIN_FILE, nbodies=2)
    _assert_same(ta, JA.parse_moordyn(FC.STANDIN_FILE, nbodies=2))
    assert (ta.nbodies, ta.n_free, ta.n_lines) == (2, 2, 7)
    path = _variant_file(str(tmp_path / "variant.dat"))
    with pytest.raises(ValueError, match="water depth"):
        TA.parse_moordyn(path, nbodies=2)
    _assert_same(TA.parse_moordyn(path, nbodies=2, depth=200.0),
                 JA.parse_moordyn(path, nbodies=2, depth=200.0))
    with pytest.raises(ValueError, match="body 2"):
        TA.parse_moordyn(FC.STANDIN_FILE, nbodies=1)


# ---------------------------------------------------------------------------
# the multi-body mooring
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def systems():
    return (TA.parse_moordyn(FC.STANDIN_FILE, nbodies=2),
            JA.parse_moordyn(FC.STANDIN_FILE, nbodies=2))


@pytest.fixture(scope="module")
def jax_ref(systems):
    """The JAX package's quantities at each pose, one jitted function."""
    _, js = systems

    @jax.jit
    def at(Xb):
        xf = JA.solve_free_points(js, Xb)
        return dict(
            xf=xf, body_wrenches=JA.body_wrenches(js, Xb, xf),
            current_wrenches=JA.current_wrenches(js, Xb, xf, U),
            free_net_force=JA.free_net_force(js, Xb, xf),
            coupled_stiffness=JA.coupled_stiffness(js, Xb, xf),
            coupled_stiffness_rotvec=JA.coupled_stiffness_rotvec(js, Xb, xf),
            tensions=JA.tensions(js, Xb, xf),
            tension_jacobian=JA.tension_jacobian(js, Xb, xf))

    return {name: {k: np.asarray(v) for k, v in at(jnp.asarray(X)).items()}
            for name, X in POSES.items()}


@pytest.mark.parametrize("pose", sorted(POSES))
def test_multibody_functions_match_jax(systems, jax_ref, pose):
    ts, _ = systems
    ref = jax_ref[pose]
    Xb = _t(POSES[pose])
    xf = TA.solve_free_points(ts, Xb)
    live = dict(
        xf=xf, body_wrenches=TA.body_wrenches(ts, Xb, xf),
        current_wrenches=TA.current_wrenches(ts, Xb, xf, _t(U)),
        coupled_stiffness=TA.coupled_stiffness(ts, Xb, xf),
        coupled_stiffness_rotvec=TA.coupled_stiffness_rotvec(ts, Xb, xf),
        tensions=TA.tensions(ts, Xb, xf),
        tension_jacobian=TA.tension_jacobian(ts, Xb, xf))
    shapes = dict(xf=(2, 3), body_wrenches=(2, 6), current_wrenches=(2, 6),
                  coupled_stiffness=(12, 12),
                  coupled_stiffness_rotvec=(12, 12), tensions=(14,),
                  tension_jacobian=(14, 12))
    for key, val in live.items():
        assert tuple(val.shape) == shapes[key], key
        assert _rel(val.numpy(), ref[key]) < TOL, key
    # both the port's and the JAX package's free points are in
    # equilibrium (each buoy lifts ~3.2 MN)
    res = TA.free_net_force(ts, Xb, xf).numpy()
    assert np.max(np.abs(res)) < 1e-5
    assert np.max(np.abs(ref["free_net_force"])) < 1e-5
    # the shared line couples the two bodies' surge
    K = live["coupled_stiffness"].numpy()
    assert abs(K[0, 6]) > 1e3 and abs(K[6, 0]) > 1e3


# ---------------------------------------------------------------------------
# the ladder around LU
# ---------------------------------------------------------------------------

def _impedance_stack(rng, nw, n):
    """(nw, n, n) complex impedance-like systems: a stiff real part, mass
    and damping rising with frequency, cond ~1e4-1e6, and lanes 3 and 7
    made cond ~1e9 by a near-dependent row pair."""
    w = np.linspace(0.1, 1.0, nw)
    C = rng.standard_normal((n, n)) + 20.0 * np.eye(n)
    M = rng.standard_normal((n, n)) * 0.1 + np.eye(n)
    B = rng.standard_normal((n, n)) * 0.2 + 0.5 * np.eye(n)
    Z = (C[None] - w[:, None, None] ** 2 * M[None] * 10
         + 1j * w[:, None, None] * B[None])
    Z = Z * 10.0 ** rng.uniform(0, 6, (1, n, 1))     # force/moment rows
    for lane in ILL:
        Z[lane, 1] = Z[lane, 0] * (1 + 1e-9) + 1e-9 * Z[lane, 1]
    return Z


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("mode,width", [("f32", None), ("mixed", "f32"),
                                        ("mixed", "bf16")])
def test_ladder_around_lu_matches_jax(n, mode, width):
    rng = np.random.default_rng(70 + n)
    nw = 10
    Z = _impedance_stack(rng, nw, n)
    M = np.block([[Z.real, -Z.imag], [Z.imag, Z.real]])
    rhs = np.concatenate([np.broadcast_to(np.eye(n), Z.shape),
                          np.zeros(Z.shape)], axis=-2)
    for cfg in (_config, j_config):
        cfg.set_precision_mode(mode)
        cfg.set_precision_width(width)
    jx = np.asarray(JL._solve_real_embedded(jnp.asarray(M), jnp.asarray(rhs),
                                            2 * n, nw))
    assert JL.last_dispatch()["backend"] == "lu"
    tx = TL._solve_real_embedded(_t(M), _t(rhs), 2 * n, nw)
    d = TL.last_dispatch()
    assert d["backend"] == "lu" and d["precision"] == mode
    x64 = np.linalg.solve(M, rhs)
    if mode == "f32":
        # LU in float32 on the well-conditioned lanes (the cond-1e9 ones
        # are float32 noise in both packages)
        assert d["solve_width"] == "f32" and "promoted" not in d
        ok = np.setdiff1d(np.arange(nw), ILL)
        assert _rel(tx.numpy()[ok], x64[ok]) < F32_TOL
        assert _rel(jx[ok], x64[ok]) < F32_TOL
        return
    assert d["factor_width"] == width and d["lanes"] == nw
    # the JAX package streams its count to a probe, not to a return
    # value: recompute it through its _mixed_ladder on the same systems
    low = jnp.linalg.solve if width == "f32" \
        else (lambda a, r: JL._gj_core(a, r, 2 * n, n))
    fd = jnp.float32 if width == "f32" else jnp.bfloat16
    _, st = JL._mixed_ladder(jnp.asarray(M), jnp.asarray(rhs), low,
                             jnp.linalg.solve, refine=2, factor_dtype=fd,
                             tol=1e-9)
    promoted = int(d["promoted"])
    assert promoted == int(st["promoted"])
    assert promoted >= 2 if width == "f32" else promoted == nw
    # promoted lanes are f64 LU solves of the equilibrated systems in
    # both (the cond-1e9 ones agree with numpy's to cond * eps); the rest
    # meet the tolerance
    ok = np.setdiff1d(np.arange(nw), ILL)
    for x in (tx.numpy(), jx):
        assert _rel(x[ok], x64[ok]) < 1e-8
        assert _rel(x[list(ILL)], x64[list(ILL)]) < ILL_TOL


def test_bf16_core_matches_jax():
    """`_gj_core`, the bf16 low rung's elimination, against the JAX
    package's jnp core on equilibrated systems at f64 (bitwise-level) and
    at bf16 (within the width)."""
    rng = np.random.default_rng(77)
    A = rng.standard_normal((6, 10, 10)) + 4 * np.eye(10)
    A = A / np.max(np.abs(A), axis=-1, keepdims=True)
    b = rng.standard_normal((6, 10, 3))
    jx = np.asarray(JL._gj_core(jnp.asarray(A), jnp.asarray(b), 10, 3))
    tx = TL._gj_core(_t(A), _t(b), 10, 3).numpy()
    assert _rel(tx, jx) < 1e-13
    jb = np.asarray(JL._gj_core(jnp.asarray(A, jnp.bfloat16),
                                jnp.asarray(b, jnp.bfloat16), 10, 3)
                    .astype(jnp.float64))
    tb = TL._gj_core(_t(A).to(torch.bfloat16), _t(b).to(torch.bfloat16),
                     10, 3).to(torch.float64).numpy()
    assert _rel(tb, np.linalg.solve(A, b)) < 0.2
    assert _rel(tb, jb) < 0.2


# ---------------------------------------------------------------------------
# the wake module
# ---------------------------------------------------------------------------

def _curve():
    ws = np.linspace(3.0, 25.0, 45)
    Ct = np.clip(0.85 - 0.028 * (ws - 3.0), 0.06, 0.85)
    power = 5.0e6 * np.clip((ws - 3.0) / 8.0, 0.0, 1.0) ** 3
    return {"wind_speed": ws, "Ct": Ct, "power": power}


def _fake_model(xy, R=120.0):
    fowts = [types.SimpleNamespace(x_ref=float(x), y_ref=float(y),
                                   rotors=[types.SimpleNamespace(R_rot=R)])
             for x, y in xy]
    return types.SimpleNamespace(fowtList=fowts, nFOWT=len(fowts))


def test_wake_host_functions_match_jax(monkeypatch):
    rng = np.random.default_rng(80)
    x, y = rng.uniform(-2, 30, (5, 7)), rng.uniform(-3, 3, (5, 7))
    Ct = rng.uniform(0.0, 1.2, (5, 7))
    np.testing.assert_array_equal(TW.gaussian_deficit(x, y, Ct),
                                  JW.gaussian_deficit(x, y, Ct))
    xy = rng.uniform(0, 3000, (6, 2))
    for wd in (0.0, 17.0, -40.0):
        np.testing.assert_array_equal(
            TW.wake_velocities(xy, 240.0, Ct[0, :6], 11.0, wd),
            JW.wake_velocities(xy, 240.0, Ct[0, :6], 11.0, wd))
    U = np.array([1.0, 3.0, 7.5, 25.0, 26.0])
    for key in ("Ct", "power"):
        np.testing.assert_array_equal(TW._curve_interp(U, _curve(), key),
                                      JW._curve_interp(U, _curve(), key))
    model = _fake_model(FC.F3_LAYOUT)
    for case in (dict(wind_speed=10.0, wind_heading=5.0),
                 dict(wind_speed=[8.0, 12.0, 9.0, 9.0],
                      wind_heading=[350.0, 10.0, 0.0, 0.0])):
        a = TW.find_wake_equilibrium(model, case, curve=_curve())
        b = JW.find_wake_equilibrium(model, case, curve=_curve())
        assert a["iterations"] == b["iterations"] > 1
        for k in ("U", "Ct", "power"):
            assert _rel(a[k], b[k]) < WAKE_TOL, k
        assert a["case"]["wind_speed"] == b["case"]["wind_speed"]
    # calc_aep builds one curve per rotor (the BEM): hand both packages
    # the explicit curve instead
    rose = [(8.0, 0.0, 0.3), (11.0, 20.0, 0.5), (27.0, 0.0, 0.2)]
    for mod in (TW, JW):
        monkeypatch.setattr(mod, "_farm_curves",
                            lambda m, c=None: [_curve()] * m.nFOWT)
    a, b = TW.calc_aep(model, rose), JW.calc_aep(model, rose)
    assert _rel(a["AEP"], b["AEP"]) < WAKE_TOL and a["AEP"] > 0
    assert [s["farm_power"] for s in a["states"]][-1] == 0.0


def test_wake_torch_functions_match_jnp():
    rng = np.random.default_rng(81)
    x, y = rng.uniform(-2, 30, (5, 7)), rng.uniform(-3, 3, (5, 7))
    Ct = rng.uniform(0.0, 1.2, (5, 7))
    assert _rel(TW.gaussian_deficit_torch(_t(x), _t(y), _t(Ct)).numpy(),
                np.asarray(JW.gaussian_deficit_jnp(x, y, Ct))) < WAKE_TOL
    c = _curve()
    cs, cCt, cP = TW.curve_tensors(c, "cpu")
    U = rng.uniform(1.0, 28.0, 40)
    assert _rel(TW._curve_interp_torch(_t(U), cs, cCt).numpy(),
                np.asarray(JW._curve_interp_jnp(U, c["wind_speed"],
                                                c["Ct"]))) < WAKE_TOL
    xy_w = rng.uniform(0, 3000, (3, 5, 2))
    Ctw = rng.uniform(0.1, 0.9, (3, 5))
    Uinf = np.array([8.0, 10.0, 12.0])
    ref = np.stack([np.asarray(JW.wake_velocities_jnp(
        xy_w[i], jnp.full(5, 240.0), Ctw[i], Uinf[i])) for i in range(3)])
    assert _rel(TW.wake_velocities_torch(_t(xy_w), _t(np.full(5, 240.0)),
                                         _t(Ctw), _t(Uinf)).numpy(),
                ref) < WAKE_TOL
    # the case axis: free streams below cut-in, in the wake-sensitive
    # band and above rated converge at different iterations
    case = FC.f3_cases(48, seed=5)
    case["U_inf"][:3] = (2.0, 11.0, 30.0)
    D = np.full(4, 240.0)
    j = JW.wake_equilibria_jnp(
        jnp.asarray(FC.F3_LAYOUT), jnp.asarray(D), *(jnp.asarray(c[k]) for k
                                                     in ("wind_speed", "Ct",
                                                         "power")),
        jnp.asarray(case["U_inf"]), jnp.asarray(case["wind_dir"]))
    t = TW.wake_equilibria_torch(_t(FC.F3_LAYOUT), _t(D), cs, cCt, cP,
                                 _t(case["U_inf"]), _t(case["wind_dir"]))
    for k in ("U", "Ct", "power"):
        assert _rel(t[k].numpy(), np.asarray(j[k])) < WAKE_TOL, k
    its = t["iterations"].numpy()
    np.testing.assert_array_equal(its, np.asarray(j["iterations"]))
    assert len(np.unique(its)) >= 3
    one = TW.wake_equilibrium_torch(_t(FC.F3_LAYOUT), _t(D), cs, cCt, cP,
                                    11.0, 4.0)
    jo = JW.wake_equilibrium_jnp(jnp.asarray(FC.F3_LAYOUT), jnp.asarray(D),
                                 *(jnp.asarray(c[k]) for k in
                                   ("wind_speed", "Ct", "power")), 11.0, 4.0)
    assert int(one["iterations"]) == int(jo["iterations"])
    assert _rel(one["U"].numpy(), np.asarray(jo["U"])) < WAKE_TOL


def test_power_thrust_curve_matches_jax():
    """The BEM rotor behind the curve: the VolturnUS-S rotor at parked
    (below cut-in, above cut-out) and operating speeds."""
    from raft_tpu.io.designs import load_design
    from raft_tpu.models.fowt import build_fowt as j_build
    from raft_tpu_torch.convert import state_from_numpy

    d = load_design("VolturnUS-S")
    w = np.arange(0.02, 0.2, 0.02) * 2 * np.pi
    jf = j_build(d, w, depth=float(d["site"]["water_depth"]))
    tf = state_from_numpy(jf, "cpu")
    speeds = np.array([2.0, 6.0, 10.5, 14.0, 26.0])
    a = TW.power_thrust_curve(tf, speeds=speeds)
    b = JW.power_thrust_curve(jf, speeds=speeds)
    for k in ("power", "thrust", "Cp", "Ct", "pitch_deg", "omega_rpm"):
        assert _rel(a[k], b[k]) < 1e-10, k
    assert a["power"][0] == 0.0 and a["thrust"][-1] == 0.0
    assert a["rotor_area"] == b["rotor_area"]
    assert os.path.isfile(FC.STANDIN_FILE)
