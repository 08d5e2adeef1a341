"""The fault-tolerance cases shared by the tests, the golden generator
(``tests/golden/recovery_golden.py``) and ``chip_smoke.py``.

Each function returns plain design dicts or arrays (numpy and Python
values only), so the JAX package and the port run the same input.

- `cyl_design`: ``Vertical_cylinder`` on the coarse grid `NW_SETTINGS`
  (0.05-0.5 Hz, 10 bins), its first case repeated with the wave height
  1.0 + 0.5 i m — ``tests/test_recovery.py``'s ``_cyl_design``;
- `oc3spar_design`: OC3spar with its three shipped cases, on its own
  80-bin grid or on the coarse golden grid (`mhk_cases.GRID`);
- `sweep_fowt_args` / `sweep_inputs`: the four-case cylinder sweep of
  ``test_sweep_lane_quarantine_parity`` (nIter `SWEEP_NITER`), poisoned
  by `SWEEP_FAULT`.

Nothing here runs on import.
"""
from __future__ import annotations

import numpy as np

from raft_tpu_torch.models.mhk_cases import GRID

#: the coarse frequency grid of the cylinder runs
NW_SETTINGS = {"min_freq": 0.05, "max_freq": 0.5}
#: the sweep's lane fault and its fixed-point iteration budget
SWEEP_FAULT = "nan@sweep:lane=2"
SWEEP_NITER = 6


def cyl_design(ncases: int = 3) -> dict:
    """``Vertical_cylinder`` at `NW_SETTINGS` with ``ncases`` copies of
    its first case, the wave height 1.0 + 0.5 i m."""
    from raft_tpu_torch.io.designs import load_design

    design = load_design("Vertical_cylinder")
    design.setdefault("settings", {})
    design["settings"].update(NW_SETTINGS)
    row0 = list(design["cases"]["data"][0])
    ih = design["cases"]["keys"].index("wave_height")
    rows = []
    for i in range(ncases):
        row = list(row0)
        row[ih] = 1.0 + 0.5 * i
        rows.append(row)
    design["cases"]["data"] = rows
    return design


def oc3spar_design(coarse: bool = False, ncases: int = 3) -> dict:
    """OC3spar with its first ``ncases`` shipped cases (three), on its own
    80-bin grid or, ``coarse``, on the golden grid."""
    from raft_tpu_torch.io.designs import load_design

    design = load_design("OC3spar")
    if coarse:
        design.setdefault("settings", {})
        design["settings"].update(GRID)
    design["cases"]["data"] = design["cases"]["data"][:ncases]
    return design


def sweep_fowt_args():
    """(design, w, depth) of the cylinder the sweep runs on: its own
    design at the nine bins 0.05-0.45 Hz."""
    from raft_tpu_torch.io.designs import load_design

    design = load_design("Vertical_cylinder")
    w = np.arange(0.05, 0.5, 0.05) * 2 * np.pi
    return design, w, float(design["site"]["water_depth"])


def sweep_inputs():
    """Hs, Tp, beta of the four seeded sweep cases."""
    rng = np.random.default_rng(7)
    nc = 4
    Hs = 2.0 + rng.random(nc)
    Tp = 8.0 + 2.0 * rng.random(nc)
    beta = np.deg2rad(rng.integers(0, 360, nc).astype(float))
    return Hs, Tp, beta
