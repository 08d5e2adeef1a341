"""The submerged-rotor (MHK) and general-mooring cases shared by the
tests, the golden generator (``tests/golden/mhk_golden.py``) and
``chip_smoke.py``.

Each design function returns a plain design dict (numpy and Python values
only), so the JAX package and the port run the same input.  ``grid``
replaces the design's frequency grid (`GRID` is the coarse golden grid of
the CPU tests, 0.02-0.2 Hz, 10 bins); ``None`` keeps the design's own.

- `rm1_design` (m1): ``RM1_Floating.yaml`` as shipped — its one case,
  operating in still water at a 1.9 m/s current — then the same case under
  JONSWAP Hs 2.0 m, Tp 8.0 s, heading 0 (the YAML's commented case), the
  case that exercises the drag fixed point and the RAOs;
- `foctt_design` (m2): ``FOCTT_example.yaml`` (the rotor driven by the
  current under ``aeroServoMod: 2``), its shipped case with any case
  field replaced (m2a: as shipped; m2b: `M2B_CASE`);
- `clump_design` (m3): OC3spar with each of its three lines split at a
  free 2000 kg clump weight into two segments of the line's own total
  length (the schema of ``tests/test_mooring_general.py``).

`case_records` is the physics record every model here is held by; m1 and
m3, on which the JAX package's two statics backends agree within the
ledger's bars, also have a ledger golden (`LEDGER_STEMS`).  Each model's
``statics_residual`` lands at the rounding floor of the force sum, where
the ledger's 0.5 residual band decides by rounding (ROADMAP C7); the port
is held there one-sided (`residual_held`) and the band's verdict is
reported (`ledger_golden_check`).
`build_record` holds m2's build and case constants where its statics
cannot be held (ROADMAP C8); `record_deviation` compares two such
records.  Nothing here runs on import.
"""
from __future__ import annotations

import copy
import os

import numpy as np

#: the coarse golden grid [Hz] of the CPU tests (10 bins)
GRID = dict(min_freq=0.02, max_freq=0.2)

#: RM1's added wave case (the YAML's commented case, operating)
RM1_WAVE = dict(wave_spectrum="JONSWAP", wave_period=8.0, wave_height=2.0,
                wave_heading=0.0)

#: m2b: the one FOCTT case found on which both of the JAX package's
#: statics backends converge — the shipped case (rotor operating on the
#: current under aeroServoMod 2, JONSWAP Hs 1 m, Tp 12 s) with the
#: current and the waves from 180 degrees at 1.0 m/s (ROADMAP C8)
M2B_CASE = dict(current_speed=1.0, current_heading=180.0, wave_heading=180.0)

#: m3's clump weight [kg], and where each line is split: the fairlead
#: segment's share of the line's length and the clump's start position as
#: (radius [m], z [m]) on the line's own bearing
CLUMP_MASS = 2000.0
CLUMP_SPLIT = 0.5
CLUMP_START = (400.0, -220.0)


def _load(name):
    from raft_tpu_torch.io.designs import load_design

    return load_design(name)


def _regrid(d, grid):
    if grid is not None:
        d["settings"].update(grid)
    return d


def rm1_design(grid=None) -> dict:
    """m1: RM1_Floating's shipped case, then that case under `RM1_WAVE`."""
    d = _regrid(_load("RM1_Floating"), grid)
    keys = d["cases"]["keys"]
    row = list(d["cases"]["data"][0])
    wave = list(row)
    for k, v in RM1_WAVE.items():
        wave[keys.index(k)] = v
    d["cases"]["data"] = [row, wave]
    return d


def foctt_design(grid=None, **case) -> dict:
    """m2: FOCTT_example with its shipped case, the given case fields
    (``current_speed=1.0``, ...) replaced."""
    d = _regrid(_load("FOCTT_example"), grid)
    keys = d["cases"]["keys"]
    row = list(d["cases"]["data"][0])
    for k, v in case.items():
        row[keys.index(k)] = v
    d["cases"]["data"] = [row]
    return d


def split_lines(moor: dict, mass=CLUMP_MASS, split=CLUMP_SPLIT,
                start=CLUMP_START) -> dict:
    """A copy of a design's ``mooring`` dict with each anchor->fairlead
    line split at a free point of ``mass`` [kg] into an anchor segment
    and a fairlead segment (``split`` of the length) of the same total
    length; the free point starts at ``start`` = (radius, z) on the
    line's bearing."""
    moor = copy.deepcopy(moor)
    pts = {p["name"]: p for p in moor["points"]}
    points = list(moor["points"])
    lines = []
    for ln in moor["lines"]:
        anchor = np.asarray(pts[ln["endA"]]["location"], float)
        ang = float(np.arctan2(anchor[1], anchor[0]))
        clump = ln["name"] + "_clump"
        points.append(dict(name=clump, type="free", mass=mass,
                           location=[start[0] * np.cos(ang),
                                     start[0] * np.sin(ang), start[1]]))
        L = float(ln["length"])
        lines.append(dict(name=ln["name"] + "_lower", endA=ln["endA"],
                          endB=clump, type=ln["type"],
                          length=L * (1.0 - split)))
        lines.append(dict(name=ln["name"] + "_upper", endA=clump,
                          endB=ln["endB"], type=ln["type"],
                          length=L * split))
    moor.update(points=points, lines=lines)
    return moor


def clump_design(grid=None, ncases=None) -> dict:
    """m3: OC3spar with its lines split at clump weights (`split_lines`:
    `CLUMP_MASS`, `CLUMP_SPLIT`, `CLUMP_START`); the free-point Newton
    finds where each clump settles.  ``ncases`` keeps the first cases."""
    d = _regrid(_load("OC3spar"), grid)
    if ncases is not None:
        d["cases"]["data"] = d["cases"]["data"][:ncases]
    d["mooring"] = split_lines(d["mooring"])
    return d


# ---------------------------------------------------------------------------
# m2's build and case constants (either package)
# ---------------------------------------------------------------------------

#: fowt_statics entries held by `build_record`
STATICS_KEYS = ("M_struc", "C_struc", "C_hydro", "W_struc", "W_hydro", "V",
                "m", "rCG", "rCB", "AWP")
#: fowt_turbine_constants entries held by `build_record` (complex split)
TURBINE_KEYS = ("A_aero", "B_aero", "f_aero", "f_aero0", "B_gyro")
RECORD_TOL = 1e-9


def _host(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _pack(x):
    a = _host(x)
    if np.iscomplexobj(a):
        return dict(re=a.real.tolist(), im=a.imag.tolist())
    return a.tolist()


def build_record(fowt, fowt_mod, rotor_mod, case, cavitation) -> dict:
    """m2's build and the shipped case's constants at the zero pose: the
    member names and types, every submerged rotor's blade members
    (``blade_member_dicts``: ends, sides, twist, added mass),
    `STATICS_KEYS` of ``fowt_statics``, the Morison added mass, and
    `TURBINE_KEYS` of ``fowt_turbine_constants`` (the heading transfer
    at heading 0, as the first case's statics use it), plus the given
    cavitation array.  ``fowt_mod``/``rotor_mod``: the package's
    ``models.fowt`` and ``models.rotor`` (the JAX package's or the
    port's)."""
    X0 = np.array([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0], float)
    pose = fowt_mod.fowt_pose(fowt, X0)
    stat = fowt_mod.fowt_statics(fowt, pose)
    hc = fowt_mod.fowt_hydro_constants(fowt, pose)
    tc = fowt_mod.fowt_turbine_constants(
        fowt, case, X0, transfer_heading=[0.0] * len(fowt.rotors))
    blades = {}
    for ir, rot in enumerate(fowt.rotors):
        if rot.hubHt + rot.R_rot < 0:
            bm = rotor_mod.blade_member_dicts(rot)
            blades[str(ir)] = {k: np.asarray([b[k] for b in bm],
                                             float).tolist()
                               for k in ("rA", "rB", "d", "gamma", "Ca")}
    return dict(
        member_names=[str(n) for n in fowt.member_names],
        member_types=[int(t) for t in fowt.member_types],
        blades=blades,
        statics={k: _pack(stat[k]) for k in STATICS_KEYS},
        A_hydro_morison=_pack(hc["A_hydro_morison"]),
        turbine={k: _pack(tc[k]) for k in TURBINE_KEYS},
        cavitation=_pack(cavitation))


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _leaves(x[k], f"{path}/{k}")
    else:
        yield path, x


def record_deviation(ref: dict, live: dict) -> tuple:
    """(worst relative deviation over the numeric leaves of two records,
    each leaf against its own largest entry; the paths of any leaf whose
    shape or value (strings, integers) differs)."""
    a, b = dict(_leaves(ref)), dict(_leaves(live))
    bad = sorted(set(a) ^ set(b))
    worst = 0.0
    for k in set(a) & set(b):
        if any(isinstance(v, str) for v in np.ravel(a[k])):
            if a[k] != b[k]:
                bad.append(k)
            continue
        x, y = np.asarray(a[k], float), np.asarray(b[k], float)
        if x.shape != y.shape:
            bad.append(k)
            continue
        if x.size:
            scale = max(float(np.max(np.abs(x))), 1e-300)
            worst = max(worst, float(np.max(np.abs(x - y))) / scale)
    return worst, bad


# ---------------------------------------------------------------------------
# the goldens of tests/golden/mhk_golden.py
# ---------------------------------------------------------------------------

#: per-case output channels a physics record holds beside the mean, std
#: and maximum of every DOF (the mooring tensions at both ends of every
#: segment, the rotor's control channels), where the run has them
RECORD_CHANNELS = ("Tmoor_avg", "Tmoor_std", "omega_avg", "omega_std",
                   "torque_avg", "power_avg", "bPitch_avg")


#: the models whose two JAX statics backends pass each other's ledger
#: golden check, so that each has a ledger golden beside its record
LEDGER_STEMS = ("rm1_floating", "oc3spar_clump")

#: the port's statics_residual against the JAX package's on the same
#: case, one-sided: at most this factor times the larger of the two
#: statics backends' residuals.  The largest ratio read is 2.74 (the
#: density-trimmed BEM spar on the H100, ROADMAP C7), then 2.44 (m3 on
#: the CPU)
RESIDUAL_FACTOR = 4.0


def golden_file(golden_dir, stem, coarse):
    """The path of a model's committed physics record."""
    suffix = "_coarse" if coarse else ""
    return os.path.join(golden_dir, f"{stem}{suffix}.metrics.json")


def ledger_golden_file(golden_dir, stem, coarse):
    """The path of a model's committed ledger golden (`LEDGER_STEMS`)."""
    suffix = "_coarse" if coarse else ""
    return os.path.join(golden_dir, f"{stem}{suffix}.ledger.json")


def residual_held(ref: dict, live: dict) -> tuple:
    """(the largest ratio, over the cases, of the port's statics_residual
    to the larger of the JAX package's two backends' in the physics
    record ``ref``; True when it is at most `RESIDUAL_FACTOR`)."""
    worst = max(b["statics_residual"] / max(a["statics_residual"], d)
                for a, b, d in zip(ref["cases"], live["cases"],
                                   ref["statics_residual_default"]))
    return worst, worst <= RESIDUAL_FACTOR


def ledger_golden_check(gold: dict, live: dict, tol=1e-6,
                        resid_tol=0.5) -> dict:
    """The port's ledger against a ledger golden at the golden bars
    (``chip_smoke.py:_golden_check``'s diff): ``blocking``, the blocking
    regressions (``ledger.blocking_regressions``) other than
    ``statics_residual``, with any added or removed entry; ``floor``,
    the statics_residual ones, at the rounding floor and reported, the
    port being held there by `residual_held` (ROADMAP C7); ``iters_ok``,
    every iteration count equal; ``report``, the diff."""
    from raft_tpu_torch import ledger

    rep = ledger.diff(gold, live, tol_rel=tol,
                      per_metric={"*_residual*": resid_tol})
    found = ledger.blocking_regressions(rep)
    floor = [r for r in found if r["metric"] == "statics_residual"
             and "why" not in r]
    blocking = [r for r in found if r not in floor] \
        + rep["added"] + rep["removed"]
    gm = {e["key"]: e["metrics"] for e in gold["entries"]}
    lm = {e["key"]: e["metrics"] for e in live["entries"]}
    iters_ok = all(
        lm.get(key, {}).get(it) == gm[key][it] for key in gm
        for it in ("statics_iters", "drag_iters", "drag_converged")
        if it in gm[key])
    return dict(blocking=blocking, floor=floor, iters_ok=iters_ok,
                report=rep)


def case_records(results, led) -> dict:
    """The physics record of every case of a finished run: the JAX
    package's or the port's ``results`` and ``last_ledger``
    (``potflow_cases.metrics_record`` plus `RECORD_CHANNELS`)."""
    from raft_tpu_torch.models.potflow_cases import metrics_record

    cases = []
    for i in range(len(results["case_metrics"])):
        rec = metrics_record(results, led, i)
        c = results["case_metrics"][i][0]
        for k in RECORD_CHANNELS:
            if k in c:
                rec["metrics"][k] = [float(x) for x in np.ravel(c[k])]
        cases.append(rec)
    return dict(cases=cases)


def case_records_deviation(ref: dict, live: dict) -> tuple:
    """(worst relative deviation, by the ledger's own measure, over the
    channels ``ref`` holds in every case — ``live`` must have each; True
    when the case counts and every iteration count are equal)."""
    from raft_tpu_torch.ledger import _compare_values

    worst = 0.0
    same = len(ref["cases"]) == len(live["cases"])
    for a, b in zip(ref["cases"], live["cases"]):
        for k, v in a["metrics"].items():
            worst = max(worst, _compare_values(v, b["metrics"][k])[0])
        same = same and a["iters"] == b["iters"]
    return worst, same


def held_record(host: dict, default: dict, tol: float = 1e-6) -> dict:
    """The record a golden holds: the host backend's, without the
    channels on which the JAX package's two statics backends differ by
    more than ``tol`` (those are set by rounding, not physics; each is
    listed under ``unheld`` with the backends' relative difference)."""
    from raft_tpu_torch.ledger import _compare_values

    out = copy.deepcopy(host)
    out["unheld"] = {}
    for i, (a, b) in enumerate(zip(out["cases"], default["cases"])):
        for k in list(a["metrics"]):
            rel = _compare_values(a["metrics"][k], b["metrics"][k])[0]
            if rel > tol:
                out["unheld"][f"case{i}/{k}"] = rel
                del a["metrics"][k]
    return out
