"""The farm cases shared by the tests, the golden generator
(``tests/golden/farm_golden.py``) and ``chip_smoke.py``.

Each design function returns a plain design dict (numpy and Python values
only), so the JAX package and the port run the same input: the vendored
``VolturnUS-S_farm.yaml`` (the IEA 15 MW on the VolturnUS-S semi, its own
grid 0.001-0.1 Hz, 100 bins; its one case operating at 10.5 m/s under
``aeroServoMod: 2``, JONSWAP Hs 6 m, Tp 12 s), with its ``array`` rows
replaced.  ``grid`` replaces the frequency grid (`GRID`, 0.005-0.1 Hz,
20 bins, is the coarse grid of the CPU tests); ``None`` keeps the
design's own.

- `f1_design`: the file's own four-turbine layout with individual
  moorings (its commented rows ``VolturnUS-S_farm.yaml:29-32``), each FOWT
  on the design's ``mooring:`` section; ``array_mooring`` dropped.  Four
  FOWTs, 24 DOFs.
- `f2_design`: the shipped two-turbine rows (``:34-35``: 1600 m apart,
  ``heading_adjust`` 180 and 0, ``mooringID: 0``) on `STANDIN_FILE`, a
  stand-in shared mooring written for these goldens because the file the
  YAML names, ``SharedMooring2.dat``, is not in the repository (its
  header says what it holds: 7 lines, 2 free points).
- `f3_cases` / `F3_LAYOUT`: the farm sweep's seeded cases on four
  turbines in a row along +x, 1600 m apart.

`farm_records` is the physics record a farm run is held by (every FOWT's
DOF statistics, the mean offsets, the array lines' tensions, the rotor
channels, the iteration counts); `array_record` holds the array mooring's
free points and coupled stiffness.  Nothing here runs on import.
"""
from __future__ import annotations

import copy
import os

import numpy as np

#: the coarse grid [Hz] of the CPU tests (20 bins)
GRID = dict(min_freq=0.005, max_freq=0.1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))

#: the stand-in shared mooring of (f2) (see its header)
STANDIN_FILE = os.path.join(_REPO, "tests", "golden", "farm",
                            "shared_mooring_standin.dat")

#: (f1): the four distinct individual-mooring rows of the farm file
#: (turbineID, platformID, mooringID, x, y, heading_adjust)
F1_ROWS = [[1, 1, 1, 800, 800, 0],
           [1, 1, 1, -800, 800, 0],
           [1, 1, 1, -800, -800, 0],
           [1, 1, 1, 800, -800, 180]]

#: (f2): the shipped two-turbine rows
F2_ROWS = [[1, 1, 0, 0, 0, 180],
           [1, 1, 0, 1600, 0, 0]]

#: (f3): four turbines in a row along +x, 1600 m apart
F3_LAYOUT = np.array([[0.0, 0.0], [1600.0, 0.0], [3200.0, 0.0],
                      [4800.0, 0.0]])
#: (f3): the number of seeded cases and their seed
F3_NCASES = 256
F3_SEED = 0


def _load():
    from raft_tpu_torch.io.designs import load_design

    return load_design("VolturnUS-S_farm")


def _with_rows(rows, grid):
    d = _load()
    if grid is not None:
        d["settings"].update(grid)
    d["array"]["data"] = copy.deepcopy(rows)
    return d


def f1_design(grid=None) -> dict:
    """(f1): four FOWTs on individual moorings, no array mooring."""
    d = _with_rows(F1_ROWS, grid)
    d.pop("array_mooring", None)
    return d


def f2_design(grid=None, mooring_file=STANDIN_FILE) -> dict:
    """(f2): the shipped two-turbine rows on the stand-in shared
    mooring."""
    d = _with_rows(F2_ROWS, grid)
    d["array_mooring"] = {"file": mooring_file}
    return d


def f3_cases(ncases=F3_NCASES, seed=F3_SEED) -> dict:
    """(f3): seeded cases — Hs 1-12 m, Tp 4-18 s, wave heading 0-360 deg
    (``beta`` [rad]), free-stream wind 6-14 m/s, wind direction +-15
    deg."""
    rng = np.random.default_rng(seed)
    return dict(Hs=1.0 + 11.0 * rng.random(ncases),
                Tp=4.0 + 14.0 * rng.random(ncases),
                beta=rng.uniform(0.0, 2.0 * np.pi, ncases),
                U_inf=6.0 + 8.0 * rng.random(ncases),
                wind_dir=rng.uniform(-15.0, 15.0, ncases))


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

DOFS = ("surge", "sway", "heave", "roll", "pitch", "yaw")
#: per-FOWT channels a record holds beside each DOF's mean, std and max
FOWT_CHANNELS = ("Tmoor_avg", "Tmoor_std", "omega_avg", "omega_std",
                 "torque_avg", "power_avg", "bPitch_avg", "Mbase_avg",
                 "Mbase_std", "AxRNA_std")


def _host(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def farm_records(results, led) -> dict:
    """The physics record of every case of a finished farm run, from the
    JAX package's or the port's ``results`` and ``last_ledger``: per
    case, every FOWT's DOF mean, std and maximum and `FOWT_CHANNELS`, the
    mean offsets, the array lines' tension mean and std, the statics and
    every FOWT's drag iteration counts, and ``statics_residual``."""
    ent = {e["key"]: e["metrics"] for e in led["entries"]}
    cases = []
    for i in range(len(results["case_metrics"])):
        cm = results["case_metrics"][i]
        metrics = {"mean_offset": [float(x)
                                   for x in results["mean_offsets"][i]]}
        iters = {"statics_iters":
                 int(ent[f"case{i}/system"]["statics_iters"])}
        for f in sorted(k for k in cm if isinstance(k, int)):
            c = cm[f]
            for ch in DOFS:
                for stat in ("avg", "std", "max"):
                    metrics[f"fowt{f}/{ch}_{stat}"] = float(c[f"{ch}_{stat}"])
            for k in FOWT_CHANNELS:
                if k in c:
                    metrics[f"fowt{f}/{k}"] = [float(x)
                                               for x in np.ravel(c[k])]
            iters[f"fowt{f}/drag_iters"] = int(
                ent[f"case{i}/fowt{f}"]["drag_iters"])
        if "array_mooring" in cm:
            for k in ("Tmoor_avg", "Tmoor_std"):
                metrics[f"array/{k}"] = [float(x) for x in
                                         np.ravel(cm["array_mooring"][k])]
        cases.append(dict(metrics=metrics, iters=iters,
                          statics_residual=float(
                              ent[f"case{i}/system"]["statics_residual"])))
    return dict(cases=cases)


def array_record(model) -> dict:
    """The array mooring of a model after its statics: the free points and
    the coupled (6N, 6N) stiffness at the last pose."""
    return dict(xf=_host(model._arr_xf).tolist(),
                K_array=_host(model._K_array).tolist())


def array_deviation(ref: dict, live: dict) -> float:
    """Worst relative deviation of two `array_record` s, each array against
    its own largest entry."""
    worst = 0.0
    for k in ("xf", "K_array"):
        a, b = np.asarray(ref[k], float), np.asarray(live[k], float)
        worst = max(worst, float(np.max(np.abs(a - b)) / np.max(np.abs(a))))
    return worst


#: the farm sweep outputs a golden holds
SWEEP_KEYS = ("std", "U_wake", "Ct_wake", "aero_power")


def sweep_record(out) -> dict:
    """The outputs of a farm sweep a golden holds (`SWEEP_KEYS`, the
    lanes' iteration counts and convergence, the wake iterations)."""
    rec = {k: _host(out[k]).tolist() for k in SWEEP_KEYS}
    rec.update(iters=_host(out["iters"]).astype(int).tolist(),
               converged=_host(out["converged"]).astype(bool).tolist(),
               wake_iters=_host(out["wake_iters"]).astype(int).tolist())
    return rec


def sweep_deviation(ref: dict, live: dict) -> tuple:
    """(worst relative deviation over `SWEEP_KEYS`, each against its own
    largest entry; True when every count and flag is equal)."""
    worst = 0.0
    for k in SWEEP_KEYS:
        a, b = np.asarray(ref[k], float), np.asarray(live[k], float)
        worst = max(worst, float(np.max(np.abs(a - b))
                                 / max(np.max(np.abs(a)), 1e-300)))
    same = all(np.array_equal(np.asarray(ref[k]), np.asarray(live[k]))
               for k in ("iters", "converged", "wake_iters"))
    return worst, same
