"""The port's batched entry points on meshes of CPU shards, against the
unsharded calls (``tests/test_partition.py``'s parity tests, batch axes
only) and the JAX package's sharded sweep.

On the coarse ``Vertical_cylinder`` (10 bins, the JAX package's test
setup), built once by the JAX package and carried over:

- ``sweep_cases`` on ``("cases",)`` meshes of 2 and 4 shards and a
  ``("variants", "cases")`` mesh of 2 x 2, f64 and mixed: ``Xi`` and
  ``std`` within ``partition_cases.ATOL`` (1e-12,
  ``tests/test_partition.py:46``) of the
  unsharded call; ``iters``, ``converged``, ``fp_chunks`` and the counted
  pulls by ``what`` exactly the same (under mixed, the plain ladder's
  promotion-mask read is one a solve, so one a shard a pass: K3 on the
  card promotes inside the kernel and reads nothing);
- the JAX package's ``sweep_cases`` on its ``("cases",)`` mesh of 2
  virtual devices against the port's on 2 shards, at the unsharded
  sweeps' bars (``tests/test_torch_sweep.py``: rtol 1e-9, counts exact);
- a prime batch of 13 on 4 shards: the padding (3 lanes) is invisible in
  the results, the metrics (batch size 13), and the manifest
  (``config["mesh"]``, ``extra["partition"]`` with ``npad`` and the rules'
  fingerprint, the ``raft_tpu_mesh_devices`` gauge's topology label);
- ``sweep_cases_chunked``: the mesh is part of the chunks' guard;
- ``sweep_variants`` (5 variants padded to 8 on 2 x 2) at rtol 1e-12 /
  atol 1e-12 for std, Xi, mass, Xeq, GMT, counts and pulls exact;
- ``sweep_farm`` (4 turbines x 5 cases, the cases padded to 6 on 2
  shards), every output within 1e-12, counts and pulls exact;
- ``optimize_designs(mesh=)`` (3 lanes padded to 4 on 2 shards, 2 Adam
  steps): x, objective, the traces and gradient norms within 1e-12,
  masks and counts exact, pulls exact, ``provenance["mesh"]``.
"""
import glob
import json

import numpy as np
import pytest
import torch

from raft_tpu.io.designs import load_design as j_load_design
from raft_tpu.models.fowt import build_fowt as j_build_fowt
from raft_tpu.parallel import partition as jpart
from raft_tpu.parallel.sweep import sweep_cases as j_sweep_cases

from raft_tpu_torch import _config, obs
from raft_tpu_torch.convert import state_from_numpy
from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.models import partition_cases as PC
from raft_tpu_torch.parallel import optimize as opt
from raft_tpu_torch.parallel import partition
from raft_tpu_torch.parallel.sweep import (
    sweep_cases, sweep_cases_chunked, sweep_farm)
from raft_tpu_torch.parallel.variants import sweep_variants
from raft_tpu_torch.serve.checkpoint import CheckpointStore

CPU = torch.device("cpu")
MESHES = [((2,), ("cases",)), ((4,), ("cases",)),
          ((2, 2), ("variants", "cases"))]


def _mesh(shape, axes):
    return partition.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def _run(fn, *a, **kw):
    """(result, counted pulls by what) of one call."""
    before = DC.pulls_by_what()
    out = fn(*a, **kw)
    return out, DC.pulls_between(before, DC.pulls_by_what())


def _parity(out, ref, keys=PC.SWEEP_KEYS, rtol=0.0):
    """The sharded result within the partition bars of the unsharded."""
    assert PC.failures(PC.parity(out, ref, keys, rtol=rtol)) == []


@pytest.fixture(scope="module")
def cyl():
    """The coarse cylinder, built by the JAX package, and the port's copy."""
    design = j_load_design("Vertical_cylinder")
    w = np.arange(0.05, 0.55, 0.05) * 2 * np.pi
    jf = j_build_fowt(design, w, depth=float(design["site"]["water_depth"]))
    return jf, state_from_numpy(jf, "cpu")


@pytest.fixture(scope="module")
def plain(cyl):
    return _run(sweep_cases, cyl[1], *PC.cases(8), nIter=4, device="cpu")


@pytest.mark.parametrize("shape, axes", MESHES)
def test_sweep_matches_unsharded(cyl, plain, shape, axes):
    out, pulls = _run(sweep_cases, cyl[1], *PC.cases(8), nIter=4,
                      mesh=_mesh(shape, axes))
    _parity(out, plain[0])
    assert pulls == plain[1]
    assert out["Xi"].device == CPU


@pytest.mark.parametrize("shape, axes", MESHES[::2])
def test_mixed_sweep_matches_unsharded(cyl, shape, axes):
    _config.set_precision_mode("mixed")
    try:
        ref, rp = _run(sweep_cases, cyl[1], *PC.cases(8), nIter=4,
                       device="cpu")
        out, pulls = _run(sweep_cases, cyl[1], *PC.cases(8), nIter=4,
                          mesh=_mesh(shape, axes))
    finally:
        _config.set_precision_mode(None)
    _parity(out, ref)
    # the plain mixed ladder (the CPU's) reads its promotion mask once a
    # solve, so once a shard a pass; K3 promotes inside the kernel
    n = int(np.prod(shape))
    assert pulls.pop("promotion_mask") == n * rp.pop("promotion_mask")
    assert pulls == rp


def test_sharded_sweep_matches_the_jax_package(cyl):
    jf, tf = cyl
    Hs, Tp, beta = PC.cases(8)
    jout = j_sweep_cases(jf, Hs, Tp, beta, nIter=4,
                         mesh=jpart.make_mesh((2,), ("cases",)))
    out = sweep_cases(tf, Hs, Tp, beta, nIter=4,
                      mesh=_mesh((2,), ("cases",)))
    for k in ("Xi", "std"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-9, atol=1e-12, err_msg=k)
    for k in ("iters", "converged"):
        assert np.array_equal(out[k].numpy(), np.asarray(jout[k])), k
    assert out["fp_chunks"] == int(jout["fp_chunks"])


def test_padded_prime_batch_is_invisible(cyl, tmp_path):
    obs.reset_all()
    obs.configure(str(tmp_path))
    try:
        Hs, Tp, beta = PC.cases(13, seed=5)
        ref = sweep_cases(cyl[1], Hs, Tp, beta, nIter=3, device="cpu")
        out = sweep_cases(cyl[1], Hs, Tp, beta, nIter=3,
                          mesh=_mesh((2, 2), ("variants", "cases")))
    finally:
        obs.configure(None)
    assert tuple(out["std"].shape) == (13, 6)
    assert out["Xi"].shape[0] == 13 and tuple(out["iters"].shape) == (13,)
    _parity(out, ref)
    snap = obs.snapshot()
    assert {s["value"] for s in
            snap["raft_sweep_batch_cases"]["series"]} == {13.0}
    meshg = snap["raft_tpu_mesh_devices"]["series"]
    assert meshg[0]["labels"]["topology"] == "variants=2xcases=2"
    assert meshg[0]["value"] == 4.0
    docs = [json.load(open(f)) for f in
            sorted(glob.glob(str(tmp_path / "sweep_cases_*.manifest.json")))]
    doc = [d for d in docs if d["config"].get("mesh")][-1]
    assert doc["config"]["mesh"]["axes"] == ["variants", "cases"]
    assert doc["config"]["sharded"] is True
    assert doc["config"]["mesh_devices"] == 4
    assert doc["config"]["ncases"] == 13
    assert doc["extra"]["partition"]["npad"] == 3
    assert doc["extra"]["partition"]["rules"] == jpart.rules_fingerprint(
        jpart.CASE_INPUT_RULES, jpart.STATE_RULES, jpart.XI_SPEC)
    unsharded = [d for d in docs if not d["config"].get("mesh")]
    assert unsharded and "partition" not in unsharded[0]["extra"]


def test_chunked_sweep_keys_its_chunks_by_the_mesh(cyl, tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    Hs, Tp, beta = PC.cases(8)
    mesh = _mesh((2,), ("cases",))
    out, info = sweep_cases_chunked(cyl[1], Hs, Tp, beta, store=store,
                                    key="k", chunk=4, nIter=4, mesh=mesh)
    assert info["solved"] == [0, 1]
    again, info2 = sweep_cases_chunked(cyl[1], Hs, Tp, beta, store=store,
                                       key="k", chunk=4, nIter=4, mesh=mesh)
    assert info2["resumed"] == [0, 1] and not info2["solved"]
    # another topology's chunks are never reused
    _, info3 = sweep_cases_chunked(cyl[1], Hs, Tp, beta, store=store,
                                   key="k", chunk=4, nIter=4, device="cpu")
    assert info3["solved"] == [0, 1]
    ref = sweep_cases(cyl[1], Hs, Tp, beta, nIter=4, device="cpu")
    np.testing.assert_allclose(again["Xi"], ref["Xi"].numpy(), rtol=0,
                               atol=PC.ATOL)


def test_sweep_variants_matches_unsharded(cyl):
    tf = cyl[1]
    nv = 5
    scales = np.linspace(0.9, 1.1, nv)
    thetas = {"d_scale": np.ones((nv, len(tf.members), 2))
              * scales[:, None, None]}
    kw = dict(ballast=False, nIter=3, newton_iters=4)
    ref, rp = _run(sweep_variants, tf, thetas, device="cpu", **kw)
    out, pulls = _run(sweep_variants, tf, thetas,
                      mesh=_mesh((2, 2), ("variants", "cases")), **kw)
    _parity(out, ref, keys=PC.VARIANT_KEYS, rtol=PC.VARIANT_RTOL)
    assert pulls == rp


def test_sweep_farm_matches_unsharded(cyl):
    xy = np.array([[0.0, 0.0], [800.0, 100.0], [1600.0, -150.0],
                   [2400.0, 50.0]])
    ws = np.linspace(3.0, 25.0, 45)
    curve = {"wind_speed": ws,
             "Ct": np.clip(0.85 - 0.028 * (ws - 3.0), 0.06, 0.85),
             "power": 5.0e6 * np.clip((ws - 3.0) / 8.0, 0.0, 1.0) ** 3,
             "rotor_diameter": 240.0}
    rng = np.random.default_rng(3)
    nc = 5
    args = (4.0 + 2.0 * rng.random(nc), 8.0 + 4.0 * rng.random(nc),
            rng.uniform(0.0, 2 * np.pi, nc), 6.0 + 8.0 * rng.random(nc),
            rng.uniform(-20.0, 20.0, nc))
    ref, rp = _run(sweep_farm, cyl[1], xy, *args, curve=curve, nIter=4,
                   device="cpu")
    out, pulls = _run(sweep_farm, cyl[1], xy, *args, curve=curve, nIter=4,
                      mesh=_mesh((2,), ("cases",)))
    _parity(out, ref, keys=PC.FARM_KEYS)
    assert torch.equal(out["wake_iters"], ref["wake_iters"])
    assert pulls == rp


def test_optimize_designs_matches_unsharded():
    gold = DC.load("cylinder")["adam"]
    base, space = DC.build(gold, "cpu")
    rec = dict(gold, x0=gold["x0"][:3], steps=2,
               solver={"nIter": 2, "tol": 1e-3, "adjoint_iters": 2,
                       "newton_iters": 1})
    ref, rp = _run(opt.optimize_designs, base, space,
                   **DC.call_kwargs(rec))
    out, pulls = _run(opt.optimize_designs, base, space,
                      mesh=_mesh((2,), ("cases",)), **DC.call_kwargs(rec))
    _parity(out, ref, keys=PC.DESCENT_KEYS, rtol=1e-12)
    assert pulls == rp
    assert out["provenance"]["mesh"]["topology"] == "cases=2"
    assert "mesh" not in ref["provenance"]
