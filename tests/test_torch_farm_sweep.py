"""The farm axis of ``parallel/sweep.py`` against the JAX package and
against the port's own per-turbine solves.

- ``sweep_farm`` on the coarse rotor-less ``Vertical_cylinder`` with an
  explicit power/thrust curve and three turbines, as
  ``tests/test_farm_sweep.py:57-90`` sets it up, against the JAX
  package's ``sweep_farm`` on the same built FOWT: the responses at
  1e-9, the wake outputs at 1e-12, every count equal;
- the farm's lanes against ``make_case_solver``'s ``batched`` run per
  turbine with that turbine's pose and stiffness (``r6_b``/``C_moor_b``)
  and against single-lane solves, at 1e-9;
- with a rotor (the farm design's FOWT on the coarse grid, its BEM curve):
  the lanes' aero damping (``B_add``, the curve's dT/dU at each turbine's
  waked wind speed) against single-lane solves at 1e-9, and downstream
  turbines waked below the free stream;
- ``make_case_solver``'s ``batched`` with all four farm hooks (``r6_b``,
  ``C_moor_b``, ``B_add``, ``F_add``) against the JAX package's at 1e-9;
- the ``r6_b``/``C_moor_b`` pair rule.
"""
import numpy as np
import pytest
import torch


from raft_tpu.io.designs import load_design
from raft_tpu.models.fowt import build_fowt as j_build_fowt
from raft_tpu.parallel.sweep import sweep_farm as j_sweep_farm

from raft_tpu_torch import errors
from raft_tpu_torch.convert import state_from_numpy
from raft_tpu_torch.models import farm_cases as FC
from raft_tpu_torch.parallel import sweep as TS

XY = np.array([[0.0, 0.0], [800.0, 100.0], [1600.0, -150.0]])
TOL = 1e-9


def _curve():
    ws = np.linspace(3.0, 25.0, 45)
    Ct = np.clip(0.85 - 0.028 * (ws - 3.0), 0.06, 0.85)
    power = 5.0e6 * np.clip((ws - 3.0) / 8.0, 0.0, 1.0) ** 3
    return {"wind_speed": ws, "Ct": Ct, "power": power,
            "rotor_diameter": 240.0}


def _cases(nc, seed=3):
    rng = np.random.default_rng(seed)
    return (4.0 + 2.0 * rng.random(nc), 8.0 + 4.0 * rng.random(nc),
            rng.uniform(0.0, 2 * np.pi, nc), 6.0 + 8.0 * rng.random(nc),
            rng.uniform(-20.0, 20.0, nc))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def cyl():
    """The coarse Vertical_cylinder built once by the JAX package, and the
    port's copy of it."""
    design = load_design("Vertical_cylinder")
    w = np.arange(0.05, 0.5, 0.05) * 2 * np.pi
    jf = j_build_fowt(design, w, depth=float(design["site"]["water_depth"]))
    return jf, state_from_numpy(jf, "cpu")


def test_sweep_farm_matches_jax(cyl):
    jf, tf = cyl
    args = _cases(4)
    j = j_sweep_farm(jf, XY, *args, curve=_curve(), nIter=4)
    t = TS.sweep_farm(tf, XY, *args, curve=_curve(), nIter=4)
    assert tuple(t["std"].shape) == (3, 4, 6)
    assert tuple(t["Xi"].shape) == (3, 4, 6, len(tf.w))
    for k in ("std", "Xi"):
        assert _rel(t[k].numpy(), np.asarray(j[k])) < TOL, k
    for k in ("U_wake", "Ct_wake", "aero_power"):
        assert _rel(t[k].numpy(), np.asarray(j[k])) < 1e-12, k
    for k in ("iters", "converged", "wake_iters"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    assert t["fp_chunks"] == int(j["fp_chunks"])


def test_farm_lanes_match_serial_per_turbine(cyl):
    _, tf = cyl
    nc, nt = 4, len(XY)
    Hs, Tp, beta, U_inf, wind_dir = _cases(nc, seed=4)
    solver = TS.make_farm_solver(tf, XY, curve=_curve(), nIter=4)
    assert solver.n_turbines == nt and solver.aero is False
    lane = lambda x: TS._farm_lane_tile(torch.as_tensor(x), nt)  # noqa: E731
    out = solver(lane(Hs), lane(Tp), lane(beta), U_inf, wind_dir)
    std = out["std"].numpy().reshape(nt, nc, 6)
    iters = out["iters"].numpy().reshape(nt, nc)
    case = TS.make_case_solver(tf, nIter=4)
    for t in range(nt):
        r6 = np.zeros((nc, 6))
        r6[:, :2] = XY[t]
        C = solver.C_moor_t[t].expand(nc, 6, 6)
        ref = case.batched(Hs, Tp, beta, r6_b=r6, C_moor_b=C)
        assert _rel(std[t], ref["std"].numpy()) < TOL
        np.testing.assert_array_equal(iters[t], ref["iters"].numpy())
    # one lane at a time (a batch of one) gives the same lanes
    for lane_i in (0, 5, 7, 11):
        t, c = divmod(lane_i, nc)
        one = case.batched(Hs[c:c + 1], Tp[c:c + 1], beta[c:c + 1],
                           r6_b=np.r_[XY[t], 0, 0, 0, 0][None],
                           C_moor_b=solver.C_moor_t[t][None])
        assert _rel(out["Xi"][lane_i].numpy(), one["Xi"][0].numpy()) < TOL


def test_rotor_farm_lanes_take_the_waked_aero_damping():
    from raft_tpu_torch.parallel.sweep import design_fowt

    d = FC.f1_design(FC.GRID)
    d.pop("array")
    fowt = design_fowt(d, "cpu")
    xy = FC.F3_LAYOUT[:3]
    c = FC.f3_cases(3, seed=2)
    c["U_inf"][:] = (9.0, 11.0, 13.0)
    c["wind_dir"][:] = 0.0
    solver = TS.make_farm_solver(fowt, xy, nIter=4)
    assert solver.aero and solver.B_tab.shape == (23, 6, 6)
    lane = lambda x: TS._farm_lane_tile(torch.as_tensor(x), 3)  # noqa: E731
    out = solver(lane(c["Hs"]), lane(c["Tp"]), lane(c["beta"]), c["U_inf"],
                 c["wind_dir"])
    U = out["U_wake"].numpy()
    assert np.all(U[1:] < U[:1]) and np.allclose(U[0], c["U_inf"])
    case = solver.case
    for lane_i in (1, 4, 8):
        t, k = divmod(lane_i, 3)
        B = TS._interp_along0(solver.curve_speed, solver.B_tab,
                              out["U_wake"][t, k:k + 1])
        one = case.batched(c["Hs"][k:k + 1], c["Tp"][k:k + 1],
                           c["beta"][k:k + 1],
                           r6_b=np.r_[xy[t], 0, 0, 0, 0][None],
                           C_moor_b=solver.C_moor_t[t][None], B_add=B)
        assert float(B[0, 0, 0]) != 0.0
        assert _rel(out["Xi"][lane_i].numpy(), one["Xi"][0].numpy()) < TOL


def test_lane_hooks_match_jax(cyl):
    """``make_case_solver``'s ``batched`` with every farm hook — per-lane
    poses and stiffness, added damping and added excitation — against the
    JAX package's on the same lanes."""
    import jax
    import jax.numpy as jnp
    from raft_tpu.parallel.sweep import make_case_solver as j_case_solver

    jf, tf = cyl
    rng = np.random.default_rng(6)
    nc, nw = 5, len(tf.w)
    Hs, Tp, beta, _, _ = _cases(nc, seed=6)
    r6 = np.zeros((nc, 6))
    r6[:, :2] = XY[rng.integers(0, len(XY), nc)]
    C = np.broadcast_to(np.diag([4e4, 4e4, 0, 0, 0, 1e7]), (nc, 6, 6))
    B = np.broadcast_to(np.diag([2e4, 2e4, 0, 0, 1e6, 0]), (nc, 6, 6)) \
        * rng.uniform(0.5, 1.5, (nc, 1, 1))
    F = 1e4 * (rng.standard_normal((nc, 6, nw))
               + 1j * rng.standard_normal((nc, 6, nw)))
    hooks = dict(r6_b=r6, C_moor_b=C, B_add=B, F_add=F)
    j = jax.jit(j_case_solver(jf, nIter=4).batched)(
        jnp.asarray(Hs), jnp.asarray(Tp), jnp.asarray(beta),
        **{k: jnp.asarray(v) for k, v in hooks.items()})
    t = TS.make_case_solver(tf, nIter=4).batched(Hs, Tp, beta, **hooks)
    assert _rel(t["Xi"].numpy(), np.asarray(j["Xi"])) < TOL
    np.testing.assert_array_equal(t["iters"].numpy(), np.asarray(j["iters"]))


def test_r6_and_stiffness_come_as_a_pair(cyl):
    _, tf = cyl
    case = TS.make_case_solver(tf, nIter=2)
    Hs, Tp, beta = (np.array([4.0]), np.array([9.0]), np.array([0.3]))
    with pytest.raises(errors.ModelConfigError, match="pair"):
        case.batched(Hs, Tp, beta, r6_b=np.zeros((1, 6)))
    with pytest.raises(errors.ModelConfigError, match="pair"):
        case.batched(Hs, Tp, beta, C_moor_b=np.zeros((1, 6, 6)))
    with pytest.raises(errors.ModelConfigError, match="one length"):
        TS.sweep_farm(tf, XY, Hs, Tp, beta, np.array([8.0, 9.0]),
                      curve=_curve())
