"""The MacCamy-Fuchs cases shared by the tests, the golden generator
(``tests/golden/mcf_golden.py``) and ``chip_smoke.py``.

No vendored design sets ``MCF``.  These set ``MCF: True`` on OC4semi's
circular vertical columns (`MCF_MEMBERS`: the main column and the three
offset columns, each a base column of 24 m and an upper column of 12 m
diameter); the braces and pontoons stay Morison members.  Each function
returns a plain design dict (numpy and Python values only), so the JAX
package and the port run the same input.  ``coarse`` puts the model on
the coarse golden grid of the CPU tests (``mhk_cases.GRID``, 0.02-0.2 Hz,
10 bins; second-order grid `QTF_GRID_COARSE`, 8 bins); otherwise the
design's own grid stays (80 bins, 0.005-0.40 Hz; second-order grid
`QTF_GRID`, ``examples/example_qtf.py``'s, 0.005-0.15 Hz, 30 bins).

- (c1) `mcf_design`: strip theory, its one case;
- (c2) `mcf_qtf_design`: (c1) under ``potSecOrder: 1``: the slender-body
  QTF (kernel K5) plus the Kim & Yue correction of the four
  surface-piercing MCF columns;
- (c3) `sweep_inputs`: `SWEEP_CASES` seeded sea states for
  ``sweep_cases`` on (c1)'s FOWT.

Nothing here runs on import.
"""
from __future__ import annotations

import numpy as np

from raft_tpu_torch.models.mhk_cases import GRID

#: the OC4semi members flagged MCF (every circular vertical column)
MCF_MEMBERS = ("main_column", "offset_column")

#: the second-order grid of (c2) at full width (examples/example_qtf.py)
QTF_GRID = dict(min_freq2nd=0.005, max_freq2nd=0.15)
#: the second-order grid of (c2) on the coarse golden grid (8 bins)
QTF_GRID_COARSE = dict(min_freq2nd=0.02, max_freq2nd=0.16,
                       df_freq2nd=0.02)

#: the runs with a ledger golden beside their physics record: those whose
#: two JAX statics backends pass each other's ledger golden check
LEDGER_STEMS = ("oc4semi_mcf_qtf",)
#: runs whose JAX statics backends agree but which have no ledger golden,
#: and why.  (c1)'s dyn_solve_residual sits at the machine floor on both
#: sides (the JAX package's LU ~1e-16, the port's Gauss-Jordan with one
#: refinement 2-3e-16), where the ledger's 0.5 band decides by rounding;
#: its physics record holds it, and (c2)'s ledger golden holds the same
#: first-order build and drag fixed point under every other ledger metric
NO_LEDGER = {"oc4semi_mcf": "dyn_solve_residual at the machine floor "
             "(ROADMAP C3)"}
#: (c3): cases of the sweep, its seed, and its nIter
SWEEP_CASES = 1024
SWEEP_SEED = 2029
SWEEP_NITER = 10


def mcf_design(coarse: bool = False) -> dict:
    """(c1) OC4semi with ``MCF: True`` on `MCF_MEMBERS`."""
    from raft_tpu_torch.io.designs import load_design

    d = load_design("OC4semi")
    if coarse:
        d["settings"].update(GRID)
    for mem in d["platform"]["members"]:
        if mem["name"] in MCF_MEMBERS:
            mem["MCF"] = True
    return d


def mcf_qtf_design(coarse: bool = False) -> dict:
    """(c2) (c1) with ``potSecOrder: 1`` on its second-order grid."""
    d = mcf_design(coarse)
    d["platform"].update(potSecOrder=1,
                         **(QTF_GRID_COARSE if coarse else QTF_GRID))
    return d


def sweep_inputs(n: int = SWEEP_CASES, seed: int = SWEEP_SEED):
    """(c3) sea states: Hs 1-12 m, Tp 4-18 s, heading 0-360 deg [rad],
    numpy (n,) each."""
    rng = np.random.default_rng(seed)
    Hs = 1.0 + 11.0 * rng.random(n)
    Tp = 4.0 + 14.0 * rng.random(n)
    beta = np.deg2rad(360.0 * rng.random(n))
    return Hs, Tp, beta
