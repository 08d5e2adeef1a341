"""The native BEM on the port's side: the panel mesher, the cache key, the
ctypes wrapper around ``native/bem/bem.cpp`` as the port builds it,
``Model.preprocess_BEM`` and the case sweep on potential-flow data,
against the JAX package on the same inputs.

1. The mesher: vertices and panels bitwise equal to JAX's on a lidded
   cylinder and on OC4semi's potential-flow members at the YAML's own
   ``dz_BEM`` / ``da_BEM``; the port's cache key equal to the one the JAX
   package wrote beside the committed OC4semi cache; ``write_pnl`` and
   ``write_gdf`` byte for byte.
2. The wrapper: one solve per package of a ~100-panel cylinder at 3
   frequencies and 2 headings, A, B and X at 1e-9 of their largest entry
   (two LAPACKs and two OpenMP reductions, so not bitwise); a compiler
   that is missing or fails, a library that does not load, and a PyTorch
   without its OpenMP runtime each raise ``KernelFailure``.
3. ``preprocess_BEM`` on the cylinder design: the files each package
   writes (mesh and key byte for byte, coefficients at 1e-9), then again
   on a changed grid, which must miss the cache and rewrite them.
4. ``sweep_cases`` on OC4semi's native-BEM FOWT (from the committed
   cache): 8 seeded cases against the serial solve at rtol 1e-9.
"""
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from raft_tpu.io import bem_native as JB
from raft_tpu.io import mesh as JMe
from raft_tpu.io.designs import load_design as jload
from raft_tpu.model import Model as JModel
from raft_tpu.models import fowt as JF

from raft_tpu_torch import errors
from raft_tpu_torch.io import bem_native as TB
from raft_tpu_torch.io import mesh as TMe
from raft_tpu_torch.model import Model
from raft_tpu_torch.models import fowt as TF
from raft_tpu_torch.models import potflow_cases as PC
from raft_tpu_torch.parallel import sweep as S

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CACHE = os.path.join(GOLDEN, "oc4semi_bem")
BEM_TOL = 1e-9
#: OC4semi's own grid, 0.005-0.40 Hz (80 bins)
OC4SEMI_W = np.arange(0.005, 0.4025, 0.005) * 2 * np.pi


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# 1. mesher and cache key
# ---------------------------------------------------------------------------

def _cyl(mm):
    b = mm.mesh_member([0, 30.0], [10.0, 10.0], np.array([0, 0, -20.0]),
                       np.array([0, 0, 10.0]), dz_max=4.0, da_max=4.0)
    nbody = len(b.panels)
    mm.lid_disk(b, 0.0, 0.0, 5.0, 4.0, z_lid=-0.04)
    mesh = b.mesh()
    mesh.n_body = nbody
    return mesh


@pytest.fixture(scope="module")
def cylinder():
    """(port mesh, JAX mesh) of the lidded cylinder and one solve each."""
    tm, jm = _cyl(TMe), _cyl(JMe)
    w, heads = [0.3, 0.8, 1.5], [0.0, 45.0]
    return dict(tm=tm, jm=jm,
                t=TB.solve_radiation_diffraction(tm, w, heads, depth=200.0),
                j=JB.solve_radiation_diffraction(jm, w, heads, depth=200.0))


def test_mesh_cylinder_matches_jax(cylinder):
    tm, jm = cylinder["tm"], cylinder["jm"]
    assert 80 <= tm.npanels <= 120 and tm.nbody < tm.npanels
    np.testing.assert_array_equal(tm.verts, jm.verts)
    np.testing.assert_array_equal(tm.panels, jm.panels)
    assert tm.nbody == jm.nbody
    for a, b in zip(tm.panel_geometry(), jm.panel_geometry()):
        np.testing.assert_array_equal(a, b)


def test_mesh_and_cache_key_of_oc4semi_match_jax():
    """OC4semi's potMod members at the YAML's dz_BEM / da_BEM: the JAX
    mesh bit for bit, and the key the JAX package wrote for that solve."""
    d = PC.oc4semi_bem_design(d=jload("OC4semi"))
    depth = float(d["site"]["water_depth"])
    jf = JF.build_fowt(d, OC4SEMI_W, depth=depth, geometry_only=True)
    tf = TF.build_fowt(d, OC4SEMI_W, depth=depth, geometry_only=True,
                       device="cpu")
    dz, da = d["platform"]["dz_BEM"], d["platform"]["da_BEM"]
    jm = JMe.mesh_fowt_members(jf, dz, da)
    tm = TMe.mesh_fowt_members(tf, dz, da)
    np.testing.assert_array_equal(tm.verts, jm.verts)
    np.testing.assert_array_equal(tm.panels, jm.panels)
    assert tm.nbody == jm.nbody and tm.npanels == 3762
    key = TB.cache_key(tf, tm, np.arange(0.0, 360.0, 30.0),
                       dw_bem=2 * np.pi * d["platform"]["min_freq_BEM"])
    with open(os.path.join(CACHE, "cache_key.txt")) as f:
        assert key == f.read().strip()
    for m in tf.members:
        m.potMod = False
    with pytest.raises(errors.ModelConfigError):
        TMe.mesh_fowt_members(tf)


def test_mesh_writers_match_jax_bytes(cylinder, tmp_path):
    TMe.write_pnl(cylinder["tm"], str(tmp_path / "t"))
    JMe.write_pnl(cylinder["jm"], str(tmp_path / "j"))
    assert (tmp_path / "t" / "HullMesh.pnl").read_bytes() == \
        (tmp_path / "j" / "HullMesh.pnl").read_bytes()
    TMe.write_gdf(cylinder["tm"], str(tmp_path / "t.gdf"))
    JMe.write_gdf(cylinder["jm"], str(tmp_path / "j.gdf"))
    assert (tmp_path / "t.gdf").read_bytes() == \
        (tmp_path / "j.gdf").read_bytes()


# ---------------------------------------------------------------------------
# 2. the wrapper and its build
# ---------------------------------------------------------------------------

def test_bem_wrapper_matches_jax(cylinder):
    (At, Bt, Xt), (Aj, Bj, Xj) = cylinder["t"], cylinder["j"]
    assert At.shape == (3, 6, 6) and Xt.shape == (3, 2, 6)
    assert _rel(At, Aj) < BEM_TOL
    assert _rel(Bt, Bj) < BEM_TOL
    assert _rel(Xt, Xj) < BEM_TOL
    assert np.all(np.diagonal(Bt, axis1=1, axis2=2)[:, :3] >= 0.0)


@pytest.mark.parametrize("compiler", ["/nonexistent/g++", "/bin/false"])
def test_bem_build_failure_raises_kernel_failure(tmp_path, monkeypatch,
                                                 compiler):
    """A compiler that is not there, or one that fails: no fallback."""
    monkeypatch.setattr(TB, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(TB.shutil, "which", lambda name: compiler)
    with pytest.raises(errors.KernelFailure, match="native BEM core"):
        TB.build()


def test_bem_load_failure_raises_kernel_failure(tmp_path, monkeypatch):
    bad = tmp_path / "libraftbem.so"
    bad.write_bytes(b"not a shared library\n")
    monkeypatch.setattr(TB, "_LIB", None)
    monkeypatch.setattr(TB, "build", lambda: str(bad))
    with pytest.raises(errors.KernelFailure, match="failed to load"):
        TB.load()


def test_bem_build_without_torch_openmp_raises_kernel_failure(monkeypatch):
    monkeypatch.setattr(TB.glob, "glob", lambda pattern: [])
    with pytest.raises(errors.KernelFailure, match="no GNU OpenMP runtime"):
        TB._openmp_runtime()


def test_bem_library_links_no_system_lapack():
    lib = TB.build()
    assert lib.startswith(TB.BUILD_ROOT)
    with open(lib, "rb") as f:
        blob = f.read()
    assert b"liblapack" not in blob and b"libblas" not in blob
    assert TB.load() is TB.load()


# ---------------------------------------------------------------------------
# 3. preprocess_BEM
# ---------------------------------------------------------------------------

def _same_export(t_dir, j_dir):
    for name in ("HullMesh.pnl", "cache_key.txt"):
        assert (t_dir / name).read_bytes() == (j_dir / name).read_bytes(), \
            name
    assert PC.wamit_deviation(j_dir, t_dir)[0] < BEM_TOL


def test_preprocess_bem_matches_jax(tmp_path):
    """Each package builds the cylinder (its own BEM solve) and exports
    it on a custom grid; a changed grid misses the cache and rewrites."""
    d = PC.cylinder_design()
    tm, jm = Model(d, device="cpu"), JModel(d)
    for k in ("A_BEM", "B_BEM", "X_BEM"):
        assert _rel(getattr(tm.fowtList[0].bem, k).cpu(),
                    getattr(jm.fowtList[0].bem, k)) < BEM_TOL, k
    kw = dict(wMax=0.6, headings=[0.0], dz=4.0, da=4.0)
    for dw in (0.2, 0.3):
        keys = []
        for name, m in (("t", tm), ("j", jm)):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                out = m.preprocess_BEM(dw=dw, mesh_dir=str(tmp_path / name),
                                       **kw)
            assert len(out) == 1
            # the second grid finds the first grid's key: a stale cache
            assert any("cache key changed" in str(x.message)
                       for x in seen) == (dw == 0.3), name
            keys.append((tmp_path / name / "cache_key.txt").read_text())
        _same_export(tmp_path / "t", tmp_path / "j")
        periods = {ln.split()[0] for ln in
                   (tmp_path / "t" / "Output.1").read_text().splitlines()}
        assert len(periods) == len(np.arange(dw, 0.6 + 0.5 * dw, dw))
        if dw == 0.2:
            first = keys[0]
        else:
            assert keys[0] != first          # the grid is in the key


# ---------------------------------------------------------------------------
# 4. the case sweep on potential-flow data
# ---------------------------------------------------------------------------

def test_sweep_cases_with_bem_matches_serial(tmp_path):
    """A(w) and B(w) shared by the cases, F_BEM per case and heading."""
    shutil.copytree(CACHE, tmp_path / "cache")
    fowt = S.design_fowt(PC.oc4semi_bem_design(tmp_path / "cache"), "cpu")
    assert fowt.bem is not None and fowt.bem.A_BEM.device.type == "cpu"
    rng = np.random.default_rng(2026)
    n = 8
    Hs = 1.0 + 11.0 * rng.random(n)
    Tp = 4.0 + 14.0 * rng.random(n)
    beta = np.deg2rad(360.0 * rng.random(n))
    out = S.sweep_cases(fowt, Hs, Tp, beta, nIter=10, tol=0.01,
                        device="cpu")
    assert bool(torch.all(torch.isfinite(out["std"])))
    solver = S.make_case_solver(fowt, nIter=10, tol=0.01)
    for i in range(n):
        ref = solver(Hs[i], Tp[i], beta[i])
        scale = float(torch.abs(ref["Xi"]).max())
        assert torch.allclose(out["Xi"][i], ref["Xi"], rtol=1e-9,
                              atol=1e-12 * scale), i
        assert torch.allclose(out["std"][i], ref["std"], rtol=1e-9), i
