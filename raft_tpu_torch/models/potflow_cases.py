"""First-order potential-flow cases shared by the tests, the golden
generator (``tests/golden/potflow_golden.py``) and ``chip_smoke.py``.

Each function returns a plain design dict (numpy and Python values only),
so the JAX package and the port can be driven on the same input.  Nothing
here runs on import.

- `oc4semi_bem_design`: OC4semi on the native BEM (``potModMaster: 2``)
  at the YAML's own ``dz_BEM`` 3.0, ``da_BEM`` 2.0, ``min_freq_BEM``
  0.03 Hz and 80-bin grid, the solve cached in ``meshDir``;
- `oc4semi_wamit_design`: the same model with every member ``potMod`` and
  its coefficients read from WAMIT files (``potModMaster: 3``);
- `oc4semi_bem_qtf_design`: the native-BEM model plus the internal
  slender-body QTF (``potSecOrder: 1``) on ``examples/example_qtf.py``'s
  second-order grid, 0.005-0.15 Hz;
- `spar_design`: the spar of ``tests/test_bem_native.py`` (water depth
  300 m, one 10 m column to 60 m draft, three chain lines), whose
  `PREPROCESS` call is the one of that file's
  ``test_preprocess_bem_custom_grid``;
- `cylinder_design`: a ~100-panel lidded cylinder on a 5-bin grid, small
  enough that the JAX package and the port both solve it in a test.

`metrics_record` / `metrics_deviation` hold a run by its physics where
its ledger cannot be held (ROADMAP C7); `wamit_deviation` compares two
directories of WAMIT files.
"""
from __future__ import annotations

import copy
import os

import numpy as np

#: ``Model.preprocess_BEM`` keywords of the spar's custom-grid export
#: (``tests/test_bem_native.py:test_preprocess_bem_custom_grid``)
PREPROCESS = dict(dw=0.1, wMax=0.6, headings=[0.0], dz=4.0, da=4.0)

#: ``examples/example_qtf.py``'s second-order grid [Hz]
QTF_GRID = dict(potSecOrder=1, min_freq2nd=0.005, max_freq2nd=0.15)


def _oc4semi():
    from raft_tpu_torch.io.designs import load_design

    return load_design("OC4semi")


def oc4semi_bem_design(mesh_dir=None, d=None) -> dict:
    """OC4semi (``d``, as loaded; the vendored YAML by default) on the
    native BEM at its own panel sizes and BEM grid; ``mesh_dir`` caches
    the solve as WAMIT files."""
    d = copy.deepcopy(d if d is not None else _oc4semi())
    d["platform"]["potModMaster"] = 2
    if mesh_dir is not None:
        d["platform"]["meshDir"] = str(mesh_dir)
    return d


def oc4semi_wamit_design(hydro_path, d=None) -> dict:
    """The same model, every member ``potMod`` and its coefficients read
    from ``hydro_path``.1/.3 (``potModMaster: 3``)."""
    d = copy.deepcopy(d if d is not None else _oc4semi())
    d["platform"].update(potModMaster=3, hydroPath=str(hydro_path))
    return d


def oc4semi_bem_qtf_design(mesh_dir=None, d=None) -> dict:
    """The native-BEM model plus ``potSecOrder: 1`` on the 0.005 Hz
    second-order grid up to 0.15 Hz."""
    d = oc4semi_bem_design(mesh_dir, d)
    d["platform"].update(QTF_GRID)
    return d


def spar_design(potModMaster: int = 2, hydro_path=None) -> dict:
    """The native-BEM tests' spar.  With ``hydro_path`` every member is
    ``potMod`` and the build reads its coefficients from that WAMIT pair
    (``potModMaster: 3``) instead of solving: the geometry, grid and
    fluid, so a `PREPROCESS` export, stay those of ``potModMaster: 2``."""
    platform = dict(potModMaster=potModMaster, members=[dict(
        name="spar", type=2, rA=[0, 0, -60], rB=[0, 0, 10],
        shape="circ", stations=[0, 70], d=10.0, t=0.05,
        l_fill=[30.0], rho_fill=[2500.0], Cd=0.6, Ca=0.97,
        CdEnd=0.6, CaEnd=0.6, rho_shell=7850)])
    if hydro_path is not None:
        platform.update(potModMaster=3, hydroPath=str(hydro_path))
    return dict(
        settings=dict(min_freq=0.01, max_freq=0.30, nIter=6, XiStart=0.1),
        site=dict(water_depth=300.0, rho_water=1025.0, g=9.81,
                  rho_air=1.225, mu_air=1.81e-5, shearExp=0.12),
        platform=platform,
        mooring=dict(
            water_depth=300.0,
            points=[dict(name="anch1", type="fixed", location=[600, 0, -300]),
                    dict(name="anch2", type="fixed",
                         location=[-300, 519.6, -300]),
                    dict(name="anch3", type="fixed",
                         location=[-300, -519.6, -300]),
                    dict(name="fair1", type="vessel", location=[5, 0, -20]),
                    dict(name="fair2", type="vessel",
                         location=[-2.5, 4.33, -20]),
                    dict(name="fair3", type="vessel",
                         location=[-2.5, -4.33, -20])],
            lines=[dict(name="l1", endA="anch1", endB="fair1", type="chain",
                        length=680),
                   dict(name="l2", endA="anch2", endB="fair2", type="chain",
                        length=680),
                   dict(name="l3", endA="anch3", endB="fair3", type="chain",
                        length=680)],
            line_types=[dict(name="chain", diameter=0.15, mass_density=300.0,
                             stiffness=2.0e9)]),
        cases=dict(keys=["wind_speed", "wind_heading", "turbulence",
                         "turbine_status", "yaw_misalign", "wave_spectrum",
                         "wave_period", "wave_height", "wave_heading"],
                   data=[[0, 0, 0, "parked", 0, "JONSWAP", 8.0, 2.0, 0]]))


def cylinder_design(mesh_dir=None) -> dict:
    """A 10 m cylinder to 20 m draft on the native BEM at 4 m panels
    (about 100 with the interior lid), on a 0.05-0.25 Hz grid (5 bins,
    which the build solves at 12 headings)."""
    d = spar_design(2)
    d["settings"].update(min_freq=0.05, max_freq=0.25)
    m = d["platform"]["members"][0]
    m.update(rA=[0, 0, -20], rB=[0, 0, 10], stations=[0, 30],
             l_fill=[5.0])
    d["platform"].update(dz_BEM=4.0, da_BEM=4.0)
    if mesh_dir is not None:
        d["platform"]["meshDir"] = str(mesh_dir)
    return d


#: the physics record of a potential-flow run that is held at 1e-6 where
#: its ledger cannot be (ROADMAP C7): case 0's mean, std and maximum of
#: every DOF and the mean offsets of its statics, with the statics and
#: drag iteration counts held exactly
DOFS = ("surge", "sway", "heave", "roll", "pitch", "yaw")
METRICS_TOL = 1e-6


def metrics_record(results: dict, led: dict, icase: int = 0) -> dict:
    """The record of case ``icase`` of a finished run, from a Model's
    ``results`` and ``last_ledger`` (the JAX package's or the port's: the
    same keys)."""
    c0 = results["case_metrics"][icase][0]
    metrics = {f"{ch}_{stat}": float(c0[f"{ch}_{stat}"])
               for ch in DOFS for stat in ("avg", "std", "max")}
    metrics["mean_offset"] = [float(x)
                              for x in results["mean_offsets"][icase]]
    ent = {e["key"]: e["metrics"] for e in led["entries"]}
    sysm, fm = ent[f"case{icase}/system"], ent[f"case{icase}/fowt0"]
    iters = dict(statics_iters=int(sysm["statics_iters"]),
                 drag_iters=int(fm["drag_iters"]))
    return dict(metrics=metrics, iters=iters,
                statics_residual=float(sysm["statics_residual"]))


def metrics_deviation(ref: dict, live: dict) -> tuple:
    """(worst relative deviation over the metrics, by the ledger's own
    measure; True when the iteration counts are equal)."""
    from raft_tpu_torch.ledger import _compare_values

    assert set(ref["metrics"]) == set(live["metrics"])
    worst = max(_compare_values(ref["metrics"][k], live["metrics"][k])[0]
                for k in ref["metrics"])
    return worst, ref["iters"] == live["iters"]


def wamit_deviation(ref_dir, live_dir) -> tuple:
    """(worst relative difference of two directories' WAMIT pairs, each
    array against its largest entry; True when their cache keys are
    equal)."""
    from raft_tpu_torch.io import wamit

    worst = 0.0
    for ext, reader, keys in ((".1", wamit.read_wamit1, ("w", "A", "B")),
                              (".3", wamit.read_wamit3, ("w", "X"))):
        a = reader(os.path.join(ref_dir, "Output" + ext))
        b = reader(os.path.join(live_dir, "Output" + ext))
        for k in keys:
            worst = max(worst, float(np.max(np.abs(a[k] - b[k]))
                                     / np.max(np.abs(a[k]))))
    keys = []
    for d in (ref_dir, live_dir):
        with open(os.path.join(d, "cache_key.txt")) as f:
            keys.append(f.read().strip())
    return worst, keys[0] == keys[1]
