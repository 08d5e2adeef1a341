"""Second-order test cases shared by the tests and ``chip_smoke.py``: the
single spar of ``tests/test_qtf_kernel.py`` and the OC4semi of
``examples/example_qtf.py`` with random first-order RAOs made from a seed
(the pair grid's inputs), and a two-heading Vertical_cylinder case (the
Model's).  Nothing here runs on import.
"""
from __future__ import annotations

import numpy as np

#: the spar's first-order grid (0.02-0.24 Hz; its second-order grid is
#: 0.04-0.12 Hz, nw2 = 5)
SPAR_W = np.arange(0.02, 0.25, 0.02) * 2 * np.pi

#: OC4semi's own first-order grid, 0.005-0.40 Hz (80 bins)
OC4SEMI_W = np.arange(0.005, 0.4025, 0.005) * 2 * np.pi

#: an offset pose: surge, sway, heave [m] and roll, pitch, yaw [rad]
OFFSET_POSE = np.array([2.0, 0.1, -0.2, 0.01, 0.03, 0.02])


def spar_design(rB_z: float = 10.0) -> dict:
    """The single spar: ``rB_z`` above water gives one waterline-crossing
    member, below water none."""
    return {
        "site": {"water_depth": 200.0, "rho_water": 1025.0, "g": 9.81},
        "platform": {
            "potModMaster": 1, "potSecOrder": 1,
            "min_freq2nd": 0.04, "max_freq2nd": 0.12, "df_freq2nd": 0.02,
            "members": [{
                "name": "spar", "type": 2,
                "rA": [0, 0, -20], "rB": [0, 0, rB_z],
                "shape": "circ", "gamma": 0.0, "potMod": False,
                "stations": [0, 0.5, 1], "d": [10.0, 8.0, 8.0],
                "t": 0.05, "Cd": 0.6, "Ca": 0.97,
                "CdEnd": 0.6, "CaEnd": 0.6, "rho_shell": 7850.0,
                "dlsMax": 5.0,
            }],
        },
    }


def oc4semi_design(max_freq2nd: float = 0.15) -> dict:
    """``examples/example_qtf.py``'s design: OC4semi with potSecOrder 1 on
    a 0.005 Hz second-order grid up to ``max_freq2nd`` [Hz]."""
    from raft_tpu_torch.io.designs import load_design

    d = load_design("OC4semi")
    d["platform"].update(potSecOrder=1, min_freq2nd=0.005,
                         max_freq2nd=max_freq2nd)
    return d


def cylinder_two_headings(d: dict) -> dict:
    """Vertical_cylinder (``d``, as loaded) on the coarse 0.02-0.2 Hz grid
    with potSecOrder 1 (second-order grid 0.02-0.16 Hz) and one case of
    two JONSWAP headings, 0 and 30 deg (the vendored case row is
    'still')."""
    d["settings"].update(min_freq=0.02, max_freq=0.2)
    d["platform"].update(potSecOrder=1, min_freq2nd=0.02, max_freq2nd=0.16)
    keys = d["cases"]["keys"]
    row = dict(zip(keys, d["cases"]["data"][0]))
    row.update(wave_spectrum=["JONSWAP"] * 2, wave_period=[10.0, 8.0],
               wave_height=[6.0, 4.0], wave_heading=[0.0, 30.0])
    d["cases"]["data"] = [[row[k] for k in keys]]
    return d


def seeded_rao(nw: int, seed: int = 3) -> np.ndarray:
    """Random (6, nw) complex RAOs, the rotations scaled by 0.01."""
    rng = np.random.default_rng(seed)
    Xi0 = rng.normal(size=(6, nw)) + 1j * rng.normal(size=(6, nw))
    Xi0[3:] *= 0.01
    return Xi0


def case_fields(design: dict, w, beta: float, *, motion: bool = True,
                pose=None, seed: int = 3, device="cpu"):
    """Build ``design`` on the first-order grid ``w`` [rad/s] on
    ``device``, pose it (``pose`` None is the undisplaced body) and make
    the pair grid's fields for heading ``beta`` [rad]: with ``motion``
    the RAOs are ``seeded_rao(len(w), seed)`` and the structural mass the
    body's own, else the body is fixed.  Returns (fowt, pose, keywords of
    ``calc_qtf_slender_body``, fields)."""
    from raft_tpu_torch.models import fowt as TF
    from raft_tpu_torch.models import qtf as TQ

    f = TF.build_fowt(design, w, depth=float(design["site"]["water_depth"]),
                      device=device)
    p = TF.fowt_pose(f, np.zeros(6) if pose is None else pose)
    kw = {}
    if motion:
        kw = dict(Xi0=seeded_rao(len(w), seed),
                  M_struc=TF.fowt_statics(f, p)["M_struc"])
    return f, p, kw, TQ.qtf_fields(f, p, beta, **kw)
