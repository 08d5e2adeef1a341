"""The general single-body mooring (free points, multi-segment lines): the
port's ``models/mooring.py`` general branches and
``models/mooring_array.py`` against the JAX package on
``tests/test_mooring_general.py``'s design (three lines, each split at a
free 2000 kg junction into two segments).

- ``parse_mooring``: the same topology and line properties, exactly;
- at r6 = 0 and at a 5 m surge: the free points, the wrench (with and
  without the free points passed in), both stiffness flavours, the
  tensions, the tension Jacobian, the lumped current wrench and the
  central-difference stiffness and tension Jacobian, each against the JAX
  function at relative 1e-9 of its largest entry.  The JAX functions run
  jitted (their eager first calls take minutes); the difference formulas
  are applied to the JAX package's own wrench and tensions at the same 12
  perturbed poses, as ``coupled_stiffness_fd`` and ``tension_jacobian_fd``
  do;
- a massless junction splitting a line into two segments of the same
  total length reproduces the simple topology
  (``tests/test_mooring_general.py:90``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.models import mooring as JM

from raft_tpu_torch.models import mooring as TM
from raft_tpu_torch.models import mooring_array as TA

from test_mooring_general import _general_design, _simple_design

TOL = 1e-9
POSES = {"zero": np.zeros(6), "surge5": np.array([5.0, 0, 0, 0, 0, 0])}
U = np.array([1.0, 0.2, 0.0])
STEPS = np.array([0.1, 0.1, 0.1, 0.1, 0.1, 0.1])


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x, float), dtype=torch.float64)


@pytest.fixture(scope="module")
def systems():
    d = _general_design()
    return TM.parse_mooring(d), JM.parse_mooring(d)


@pytest.fixture(scope="module")
def jax_ref(systems):
    """The JAX package's quantities at both poses, from one jitted
    function, and its wrench and tensions at each pose's 12 centrally
    perturbed poses."""
    _, js = systems

    @jax.jit
    def at(r6):
        xf = JM.free_points(js, r6)
        return dict(
            xf=xf, body_wrench=JM.body_wrench(js, r6),
            coupled_stiffness=JM.coupled_stiffness(js, r6),
            coupled_stiffness_rotvec=JM.coupled_stiffness_rotvec(js, r6),
            tensions=JM.tensions(js, r6),
            tension_jacobian=JM.tension_jacobian(js, r6),
            current_wrench=JM.current_wrench(js, r6, U))

    perturbed = jax.jit(jax.vmap(lambda x: (JM.body_wrench(js, x),
                                            JM.tensions(js, x))))
    out = {}
    for name, r6 in POSES.items():
        ref = {k: np.asarray(v) for k, v in at(jnp.asarray(r6)).items()}
        X = np.concatenate([r6 + np.diag(STEPS), r6 - np.diag(STEPS)])
        F, T = (np.asarray(a) for a in perturbed(jnp.asarray(X)))
        ref["K_fd"] = (-0.5 * (F[:6] - F[6:]) / STEPS[:, None]).T
        ref["J_fd"] = (0.5 * (T[:6] - T[6:]) / STEPS[:, None]).T
        out[name] = ref
    return out


def test_parse_general_topology(systems):
    ts, js = systems
    assert TM._is_general(ts) and not TM._is_general(_simple_sys())
    assert ts.nbodies == 1 and ts.n_free == 3 and ts.n_lines == 6
    for f in ("attach", "free_idx", "iA", "iB", "contact_ok"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    for f in ("r0", "pmass", "pvol", "L", "EA", "w", "d_vol", "Cd_t",
              "Cd_a"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert (ts.depth, ts.g, ts.rho) == (js.depth, js.g, js.rho)


def _simple_sys():
    return TM.parse_mooring(_simple_design())


@pytest.mark.parametrize("pose", sorted(POSES))
def test_general_functions_match_jax(systems, jax_ref, pose):
    ts, _ = systems
    ref = jax_ref[pose]
    r6 = _t(POSES[pose])
    xf = TM.free_points(ts, r6)
    live = dict(
        xf=xf,
        body_wrench=TM.body_wrench(ts, r6, xf=xf),
        coupled_stiffness=TM.coupled_stiffness(ts, r6, xf=xf),
        coupled_stiffness_rotvec=TM.coupled_stiffness_rotvec(ts, r6, xf=xf),
        tensions=TM.tensions(ts, r6, xf=xf),
        tension_jacobian=TM.tension_jacobian(ts, r6, xf=xf),
        current_wrench=TM.current_wrench(ts, r6, _t(U), xf=xf))
    for key, val in live.items():
        assert _rel(val.numpy(), ref[key]) < TOL, key
    # the wrench's own free-point solve gives the shared one's answer
    assert _rel(TM.body_wrench(ts, r6).numpy(), ref["body_wrench"]) < TOL
    # the free points are in equilibrium (each clump weighs 19.6 kN)
    res = TA.free_net_force(ts, r6[None], xf)
    assert xf.shape == (3, 3) and float(torch.max(torch.abs(res))) < 1e-6


@pytest.mark.parametrize("pose", sorted(POSES))
def test_central_differences_match_jax(systems, jax_ref, pose):
    ts, _ = systems
    r6 = _t(POSES[pose])
    K, J = TM.coupled_stiffness_fd(ts, r6, tensions_too=True)
    assert _rel(K.numpy(), jax_ref[pose]["K_fd"]) < TOL
    assert _rel(J.numpy(), jax_ref[pose]["J_fd"]) < TOL
    assert _rel(TM.tension_jacobian_fd(ts, r6).numpy(),
                jax_ref[pose]["J_fd"]) < TOL


def test_inline_junction_matches_simple_system():
    """A massless free junction splitting each line into two segments of
    the same total length relaxes onto the single catenary, so the
    general path reproduces the simple system (the JAX package's own
    bars: heave force 1e-3, surge stiffness 1e-2)."""
    gen = _general_design()
    for p in gen["points"]:
        p.pop("mass", None)
    sys_g = TM.parse_mooring(gen)
    sys_s = TM.parse_mooring(_simple_design(length=458.0 + 372.0))
    r6 = torch.zeros(6, dtype=torch.float64)
    Wg, Ws = TM.body_wrench(sys_g, r6), TM.body_wrench(sys_s, r6)
    np.testing.assert_allclose(Wg[2].item(), Ws[2].item(), rtol=1e-3)
    Kg, Ks = TM.coupled_stiffness(sys_g, r6), TM.coupled_stiffness(sys_s, r6)
    np.testing.assert_allclose(Kg[0, 0].item(), Ks[0, 0].item(), rtol=1e-2)
