"""The long-request tenants and multi-tenancy of the port's service.

- the farm tenant (``submit_farm`` over ``make_farm_runner``) on the
  coarse OC3 spar with its rotor (4 bins, so that the BEM power/thrust
  curve and the aero damping engage; the JAX package's
  ``tests/test_serve_farm.py`` model: the service passes no curve, so
  its farm needs a rotor) against the JAX package's service at the sweep
  bar (1e-9; the wake at 1e-12; counts exact), the port's farm runner
  bitwise the port's ``sweep_farm``, and a repeat deduped;
- ``normalize_farm_request``'s typed caps equal to the JAX package's;
- one optimize request on the cylinder (``submit_optimize``) bitwise the
  port's direct ``optimize_designs`` call;
- two tenants on their own models, each answer its own model's solve.
"""
import numpy as np
import pytest
import torch

from raft_tpu import errors as j_errors
from raft_tpu import serve as j_serve
from raft_tpu.parallel.sweep import normalize_farm_request as j_norm_farm
from raft_tpu.serve.soak import build_fowt as j_soak_fowt

from raft_tpu_torch import errors, obs
from raft_tpu_torch import serve as t_serve
from raft_tpu_torch.convert import state_from_numpy
from raft_tpu_torch.io.designs import load_design
from raft_tpu_torch.models.fowt import build_fowt
from raft_tpu_torch.parallel import optimize as opt
from raft_tpu_torch.parallel import sweep as TS
from raft_tpu_torch.serve import ServeConfig, SweepService, Tenant

WAIT = 300.0
SPEC = {"layout": [[0.0, 0.0], [800.0, 0.0]],
        "Hs": [1.0, 2.0], "Tp": [8.0, 10.0], "beta": [0.0, 0.1],
        "U_inf": [10.0, 12.0]}

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


@pytest.fixture(autouse=True)
def _port_isolation():
    obs.reset_all()
    yield
    obs.reset_all()


@pytest.fixture(scope="module")
def spar():
    """The coarse OC3 spar with its rotor, built by the JAX package, and
    the port's copy of it."""
    jf = j_soak_fowt("OC3spar.yaml", min_freq=0.1, max_freq=0.5, dfreq=0.1)
    return jf, state_from_numpy(jf, "cpu")


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_farm_tenant_matches_jax_and_sweep_farm(spar, tmp_path,
                                                monkeypatch):
    jf, tf = spar
    monkeypatch.setenv("RAFT_TPU_EXEC_CACHE_DIR", str(tmp_path / "xc"))
    out = {}
    for name, pkg, fowt, extra in (("port", t_serve, tf, {"device": "cpu"}),
                                   ("jax", j_serve, jf, {})):
        cfg = pkg.ServeConfig(journal_dir=str(tmp_path / name), nIter=4)
        svc = pkg.SweepService(fowt, cfg, **extra)
        svc.start()
        res = svc.submit_farm(dict(SPEC)).result(WAIT)
        dup = svc.submit_farm(dict(SPEC)).result(WAIT)
        svc.stop(timeout=WAIT)
        assert res.ok and res.mode == "farm" and res.source == "solved"
        assert dup.source == "deduped" and dup.digest == res.digest
        out[name] = res.extra
    p, j = out["port"], out["jax"]
    assert np.asarray(p["std"]).shape == (2, 2, 6)
    assert _rel(p["std"], j["std"]) < 1e-9
    assert _rel(p["U_wake"], j["U_wake"]) < 1e-12
    assert _rel(p["aero_power"], j["aero_power"]) < 1e-12
    for k in ("iters", "converged", "wake_iters", "n_turbines", "ncases",
              "layout_digest"):
        assert p[k] == j[k], k
    assert p["provenance"]["cache_state"] == "disabled"
    # the tenant's runner is the port's sweep_farm, bit for bit (as in
    # the JAX package, the farm runner takes the tenant's solver knobs,
    # not the config's: nIter is make_case_solver's default here)
    spec = TS.normalize_farm_request(SPEC)
    ref = TS.sweep_farm(tf, spec["layout"], spec["Hs"], spec["Tp"],
                        spec["beta"], spec["U_inf"], spec["wind_dir"],
                        device="cpu", k_w=spec["k_w"])
    assert np.array_equal(np.asarray(p["std"]), ref["std"].numpy())
    runner = TS.make_farm_runner(tf, spec["layout"], 2, device="cpu",
                                 k_w=spec["k_w"])
    got = TS._farm_reshape(runner(spec["Hs"], spec["Tp"], spec["beta"],
                                  spec["U_inf"], spec["wind_dir"]), 2, 2)
    for k in ("std", "Xi", "U_wake", "iters"):
        assert torch.equal(got[k], ref[k]), k
    assert runner.n_turbines == 2 and runner.ncases == 2
    assert runner.cache_state == "disabled" and runner.devprof is None


def test_farm_runner_is_keyed_by_k_w(spar, tmp_path):
    """Two requests on one layout and case count but different wake
    ``k_w`` each get a runner built at their own ``k_w``: each answer is
    the port's ``sweep_farm`` at that ``k_w``, bit for bit."""
    _, tf = spar
    cfg = ServeConfig(journal_dir=str(tmp_path / "j"), nIter=4)
    svc = SweepService(tf, cfg, device="cpu")
    svc.start()
    got = {k_w: svc.submit_farm({**SPEC, "k_w": k_w}).result(WAIT)
           for k_w in (0.05, 0.1)}
    svc.stop(timeout=WAIT)
    for k_w, res in got.items():
        assert res.ok and res.source == "solved", k_w
        assert res.extra["provenance"]["k_w"] == k_w
        spec = TS.normalize_farm_request({**SPEC, "k_w": k_w})
        ref = TS.sweep_farm(tf, spec["layout"], spec["Hs"], spec["Tp"],
                            spec["beta"], spec["U_inf"], spec["wind_dir"],
                            device="cpu", k_w=spec["k_w"])
        assert np.array_equal(np.asarray(res.extra["std"]),
                              ref["std"].numpy()), k_w
        assert np.array_equal(np.asarray(res.extra["U_wake"]),
                              ref["U_wake"].numpy()), k_w
    # the downstream turbine sees a different wake at the two k_w
    assert not np.array_equal(np.asarray(got[0.05].extra["U_wake"]),
                              np.asarray(got[0.1].extra["U_wake"]))


_BAD_FARMS = [
    [[0.0, 0.0]],
    {"Hs": [1.0]},
    {"layout": "nope", "Hs": [1.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0]},
    {"layout": [[0.0, 0.0, 1.0]], "Hs": [1.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0]},
    {"layout": [[0.0, np.inf]], "Hs": [1.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0]},
    {"layout": [[float(i), 0.0] for i in range(17)], "Hs": [1.0],
     "Tp": [8.0], "beta": [0.0], "U_inf": [10.0]},
    {"layout": [[0.0, 0.0]], "Hs": [1.0], "Tp": [8.0], "beta": [0.0]},
    {"layout": [[0.0, 0.0]], "Hs": [1.0, 2.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0]},
    {"layout": [[0.0, 0.0]], "Hs": [], "Tp": [], "beta": [], "U_inf": []},
    {"layout": [[0.0, 0.0]], "Hs": [1.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0], "wind_dir": [0.0, 1.0]},
    {"layout": [[0.0, 0.0]], "Hs": [1.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0], "k_w": 1.5},
    {"layout": [[0.0, 0.0]], "Hs": [1.0], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0], "k_w": "x"},
    {"layout": [[0.0, 0.0]], "Hs": [np.nan], "Tp": [8.0], "beta": [0.0],
     "U_inf": [10.0]},
]


@pytest.mark.parametrize("spec", _BAD_FARMS)
def test_farm_request_caps_equal_jax(spec):
    with pytest.raises(errors.ModelConfigError) as p:
        TS.normalize_farm_request(spec, turbines_max=16, cases_max=8)
    with pytest.raises(j_errors.ModelConfigError) as j:
        j_norm_farm(spec, turbines_max=16, cases_max=8)
    assert str(p.value) == str(j.value)
    assert p.value.context() == j.value.context()


def test_farm_request_canonical_equal_jax():
    spec = dict(SPEC, wind_dir=[5.0, -5.0], k_w=0.07)
    p, j = TS.normalize_farm_request(spec), j_norm_farm(spec)
    assert p.keys() == j.keys()
    for k in p:
        np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(j[k]))


def test_optimize_request_is_the_direct_descent(tmp_path):
    d = load_design("Vertical_cylinder")
    w = np.array([0.6283185307179586, 3.141592653589793])
    base = build_fowt(d, w, depth=200.0, device="cpu")
    spec = {"bounds": {"d_scale": [0.9, 1.1], "moor_L": [0.95, 1.05]},
            "objective": {"metric": "std", "Hs": 5.0, "Tp": 9.0},
            "nlanes": 2, "steps": 1, "seed": 3, "nIter": 10}
    svc = SweepService(base, ServeConfig(journal_dir=str(tmp_path / "wal")),
                       device="cpu")
    svc.start()
    res = svc.submit_optimize(dict(spec)).result(WAIT)
    again = svc.submit_optimize(dict(spec)).result(WAIT)
    svc.stop(timeout=WAIT)
    assert res.ok and res.mode == "optimize" and again.source == "deduped"
    norm = opt.normalize_request(spec)
    space = opt.DesignSpace(base, {k: tuple(v) for k, v in
                                   norm["bounds"].items()})
    direct = opt.optimize_designs(
        base, space, objective=norm["objective"], nlanes=norm["nlanes"],
        steps=norm["steps"], method=norm["method"], lr=norm["lr"],
        gtol=norm["gtol"], seed=norm["seed"], nIter=norm["nIter"],
        tol=norm["tol"])
    assert res.extra["design"] == direct["design"]
    assert res.extra["f_best"] == direct["f_best"]
    assert res.extra["x_best"] == [float(v) for v in direct["x_best"]]
    assert res.extra["provenance"]["objective_trace"] == [
        float(v) for v in direct["obj_trace"][:, direct["lane_best"]]]
    assert res.iters == direct["provenance"]["iterations"]


def test_two_tenants_solve_on_their_own_models(tmp_path):
    spar_d = load_design("OC3spar")
    cyl_d = load_design("Vertical_cylinder")
    w = np.arange(0.05, 0.5, 0.05) * 2 * np.pi
    spar = build_fowt(spar_d, w, depth=float(spar_d["site"]["water_depth"]),
                      device="cpu")
    cyl = build_fowt(cyl_d, w, depth=float(cyl_d["site"]["water_depth"]),
                     device="cpu")
    cfg = ServeConfig(batch_cases=2, window_s=0.02, max_live_programs=2)
    svc = SweepService(spar, cfg, tenants=[Tenant("cyl", cyl)],
                       device="cpu")
    with pytest.raises(errors.ModelConfigError):
        svc.submit(2.0, 9.0, 0.0, tenant="nobody")
    ts = [svc.submit(2.0, 9.0, 0.0), svc.submit(2.0, 9.0, 0.0, tenant="cyl"),
          svc.submit(3.0, 10.0, 0.5, tenant="cyl")]
    svc.start()
    got = [t.result(WAIT) for t in ts]
    summary = svc.stop(timeout=WAIT)
    assert all(r.ok for r in got)
    assert [r.tenant for r in got] == ["default", "cyl", "cyl"]
    assert summary["batches"] == 2
    ref_s = TS.make_case_solver(spar).batched([2.0, 2.0], [9.0, 9.0],
                                              [0.0, 0.0])
    ref_c = TS.make_case_solver(cyl).batched([2.0, 3.0], [9.0, 10.0],
                                             [0.0, 0.5])
    assert np.array_equal(got[0].std, ref_s["std"][0].numpy())
    assert np.array_equal(got[1].std, ref_c["std"][0].numpy())
    assert np.array_equal(got[2].std, ref_c["std"][1].numpy())
    assert got[0].std != got[1].std
