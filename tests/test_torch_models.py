"""Parity of the port's model layers with the JAX package's, from shared
state.

Each design is built ONCE by the JAX package (member geometry, node set,
rotor tables, mooring system) and carried across with
``raft_tpu_torch.convert.state_from_numpy``, so both implementations
compute from identical state; every member / mooring / rotor / FOWT
function of the slice then takes the same inputs on both sides.  Float64,
relative 1e-10 (normwise over each output array).  The JAX side runs
under ``jax.jit`` (one compile per function instead of eager per-op
dispatch, which keeps the file cheap).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_tpu.io.designs import load_design
from raft_tpu.models import fowt as JF
from raft_tpu.models import member as JM
from raft_tpu.models import mooring as JMr
from raft_tpu.models import rotor as JR

from raft_tpu_torch.convert import state_from_numpy
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import member as TM
from raft_tpu_torch.models import mooring as TMr
from raft_tpu_torch.models import rotor as TR

TOL = 1e-10
#: golden grid (Hz); 10 bins keeps the JAX side cheap
W = np.arange(0.02, 0.21, 0.02) * 2 * np.pi
POSE = np.array([1.2, -0.4, -0.3, 0.01, 0.03, -0.05])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _cmp(t, j, tol=TOL, path=""):
    """Recursive normwise relative comparison of (nested) outputs."""
    if isinstance(j, dict):
        for k in j:
            if k in ("members",) or k not in t:
                continue
            _cmp(t[k], j[k], tol, f"{path}.{k}")
        return
    if isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _cmp(a, b, tol, f"{path}[{i}]")
        return
    a, b = _np(t), np.asarray(j)
    assert a.shape == b.shape, f"{path}: {a.shape} vs {b.shape}"
    if b.dtype == bool:
        assert np.array_equal(a, b), path
        return
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    err = float(np.max(np.abs(a - b))) if b.size else 0.0
    assert err <= tol * max(scale, 1e-300) or err == 0.0, \
        f"{path}: rel {err / max(scale, 1e-300):.3e}"


def _T(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module", params=["OC3spar", "VolturnUS-S"])
def built(request):
    design = load_design(request.param)
    jf = JF.build_fowt(design, W, depth=float(design["site"]["water_depth"]))
    tf = state_from_numpy(jf, "cpu")
    case = dict(zip(design["cases"]["keys"], design["cases"]["data"][0]))
    return request.param, jf, tf, case


# ---------------------------------------------------------------------------
# member
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["pose", "inertia", "hydrostatics",
                                "hydro_constants"])
def test_member(built, fn):
    _, jf, tf, _ = built
    j_fn = {"pose": lambda m, p: JM.member_pose(m, p),
            "inertia": lambda m, p: JM.member_inertia(
                m, JM.member_pose(m, p), rPRP=p[:3]),
            "hydrostatics": lambda m, p: JM.member_hydrostatics(
                m, JM.member_pose(m, p), rPRP=p[:3]),
            "hydro_constants": lambda m, p: JM.member_hydro_constants(
                m, JM.member_pose(m, p), r_ref=p[:3])}[fn]
    t_fn = {"pose": lambda m, p: TM.member_pose(m, p),
            "inertia": lambda m, p: TM.member_inertia(
                m, TM.member_pose(m, p), rPRP=p[:3]),
            "hydrostatics": lambda m, p: TM.member_hydrostatics(
                m, TM.member_pose(m, p), rPRP=p[:3]),
            "hydro_constants": lambda m, p: TM.member_hydro_constants(
                m, TM.member_pose(m, p), r_ref=p[:3])}[fn]
    for jm, tm in zip(jf.members, tf.members):
        _cmp(t_fn(tm, _T(POSE)),
             jax.jit(lambda p, m=jm: j_fn(m, p))(jnp.asarray(POSE)))


# ---------------------------------------------------------------------------
# mooring
# ---------------------------------------------------------------------------

def test_catenary_solve(built):
    _, jf, tf, _ = built
    ms = jf.mooring
    rng = np.random.default_rng(4)
    nl = ms.n_lines
    dxy = np.linalg.norm(np.asarray(ms.rFair0)[:, :2]
                         - np.asarray(ms.rAnchor)[:, :2], axis=1)
    XF = dxy[None, :] * rng.uniform(0.97, 1.03, (4, nl))
    ZF = (np.asarray(ms.rFair0)[:, 2] - np.asarray(ms.rAnchor)[:, 2])[None, :] \
        * rng.uniform(0.98, 1.02, (4, nl))
    j = jax.jit(lambda x, z: JMr.catenary_solve(x, z, ms.L, ms.EA, ms.w))(
        XF, ZF)
    t = TMr.catenary_solve(_T(XF), _T(ZF), _T(ms.L), _T(ms.EA), _T(ms.w))
    _cmp(t, j)


@pytest.mark.parametrize("fn", ["body_wrench", "coupled_stiffness",
                                "coupled_stiffness_rotvec", "tensions",
                                "tension_jacobian", "tension_jacobian_fd"])
@pytest.mark.parametrize("current", [None, (0.6, 0.3, 0.0)])
def test_mooring(built, fn, current):
    _, jf, tf, _ = built
    if fn == "tension_jacobian" and current is not None:
        pytest.skip("tension_jacobian takes no current (as in the JAX "
                    "package)")
    kw_j = {} if current is None else {"current": jnp.asarray(current)}
    kw_t = {} if current is None else {"current": _T(current)}
    if fn == "tension_jacobian_fd":          # host finite differences
        j = JMr.tension_jacobian_fd(jf.mooring, POSE, **kw_j)
    else:
        j = jax.jit(lambda p: getattr(JMr, fn)(jf.mooring, p, **kw_j))(
            jnp.asarray(POSE))
    t = getattr(TMr, fn)(tf.mooring, _T(POSE), **kw_t)
    _cmp(t, j)


def test_current_wrench(built):
    _, jf, tf, _ = built
    U = np.array([0.8, -0.2, 0.0])
    _cmp(TMr.current_wrench(tf.mooring, _T(POSE), _T(U)),
         jax.jit(lambda p: JMr.current_wrench(jf.mooring, p, jnp.asarray(U)))(
             jnp.asarray(POSE)))


# ---------------------------------------------------------------------------
# rotor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def aero(built):
    """calc_aero on both sides for the design's first case: aeroServoMod 1
    on OC3spar, 2 on VolturnUS-S.  It runs bem_evaluate for the mean loads
    and bem_thrust_torque_derivs (jacfwd) for the derivatives."""
    _, jf, tf, case = built
    j = JR.calc_aero(jf.rotors[0], W, case, r6=POSE)
    t = TR.calc_aero(tf.rotors[0], _T(W), case, r6=_T(POSE))
    return t, j


def test_bem_evaluate(aero):
    t, j = aero
    _cmp(t["loads"], j["loads"], path="loads")


def test_bem_thrust_torque_derivs(built):
    """dT, dQ w.r.t. (U, Omega, pitch) by jacfwd on both sides, at an
    operating point where the BEM solution is smooth.  (At OC3spar's rated
    design case the JAX derivative itself moves by 2e-8 relative in
    dQ/dpitch when the tilt changes by 1e-15 relative — an element sits on
    a branch switch of the induction model — so no two implementations can
    agree there to 1e-10; calc_aero's outputs below are compared instead.)"""
    _, jf, tf, _ = built
    args = (11.0, 8.0, 2.0)
    kw = dict(tilt=-0.08, yaw=0.05)
    TQ_t, J_t = TR.bem_thrust_torque_derivs(tf.rotors[0],
                                            *(_T(a) for a in args),
                                            tilt=_T(kw["tilt"]),
                                            yaw=_T(kw["yaw"]))
    TQ_j, J_j = JR.bem_thrust_torque_derivs(jf.rotors[0], *args, **kw)
    _cmp(TQ_t, TQ_j)
    for i in range(2):
        for k in range(3):
            _cmp(J_t[i, k], J_j[i, k], path=f"J[{i},{k}]")


def test_calc_aero(aero):
    t, j = aero
    for k in ("f0", "f", "a", "b", "C", "V_w"):
        _cmp(t[k], j[k], path=k)
    _cmp(t["pose"], dict(j["pose"]))


# ---------------------------------------------------------------------------
# FOWT assembly
# ---------------------------------------------------------------------------

def test_fowt_statics_and_hydro_constants(built):
    _, jf, tf, _ = built

    @jax.jit
    def j_fn(p):
        jp = JF.fowt_pose(jf, p)
        return jp, JF.fowt_statics(jf, jp), JF.fowt_hydro_constants(jf, jp)

    jp, jst, jhc = j_fn(jnp.asarray(POSE))
    tp = TF.fowt_pose(tf, _T(POSE))
    _cmp(tp, jp)
    _cmp(TF.fowt_statics(tf, tp), jst)
    _cmp(TF.fowt_hydro_constants(tf, tp), jhc)


def test_fowt_excitation_and_drag(built):
    _, jf, tf, case = built
    ss_j = JF.build_seastate(jf, case)
    ss_t = TF.build_seastate(tf, case)
    _cmp(ss_t, ss_j)
    rng = np.random.default_rng(8)
    Xi = (rng.standard_normal((6, W.size))
          + 1j * rng.standard_normal((6, W.size))) * 0.3

    @jax.jit
    def j_fn(p, Xi):
        jp = JF.fowt_pose(jf, p)
        hc = JF.fowt_hydro_constants(jf, jp)
        ex = JF.fowt_hydro_excitation(jf, jp, ss_j, hc)
        pre = JF.fowt_drag_precompute(jf, jp, ex["u"][0])
        Bd, Bm = JF.fowt_hydro_linearization_pre(jf, jp, pre, Xi)
        return (ex, pre, Bd, Bm, JF.fowt_drag_excitation(jf, jp, Bm, ex["u"]),
                JF.fowt_current_loads(jf, jp, 1.1, 30.0))

    ex_j, pre_j, Bd_j, Bm_j, Fd_j, D_j = j_fn(jnp.asarray(POSE),
                                              jnp.asarray(Xi))
    tp = TF.fowt_pose(tf, _T(POSE))
    hc_t = TF.fowt_hydro_constants(tf, tp)
    ex_t = TF.fowt_hydro_excitation(tf, tp, ss_t, hc_t)
    _cmp(ex_t, ex_j)
    pre_t = TF.fowt_drag_precompute(tf, tp, ex_t["u"][0])
    _cmp(pre_t, pre_j)
    Bd_t, Bm_t = TF.fowt_hydro_linearization_pre(tf, tp, pre_t,
                                                 torch.tensor(Xi))
    _cmp(Bd_t, Bd_j)
    _cmp(Bm_t, Bm_j)
    _cmp(TF.fowt_drag_excitation(tf, tp, Bm_t, ex_t["u"]), Fd_j)
    _cmp(TF.fowt_current_loads(tf, tp, 1.1, 30.0), D_j)


def test_fowt_turbine_constants(built):
    _, jf, tf, case = built
    r6 = np.array([0.0, 0.0, 0, 0, 0, 0])
    j = JF.fowt_turbine_constants(jf, case, r6, transfer_heading=[0.2])
    t = TF.fowt_turbine_constants(tf, case, _T(r6), transfer_heading=[0.2])
    _cmp(t, j)
