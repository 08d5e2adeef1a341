"""The ballast-trim cases shared by the tests, the golden generator
(``tests/golden/ballast_golden.py``) and ``chip_smoke.py``, and the bars
they are held by.

Every design is a vendored one as a plain dict (numpy and Python values
only), so the JAX package and the port run the same input.  ``coarse``
puts a model on the coarse golden grid of the CPU tests
(``mhk_cases.GRID``, 0.02-0.2 Hz, 10 bins); otherwise the design's own
grid stays.  The trim itself is statics only and does not depend on the
grid.

- (b1) `TRIMS` ``b1_*``: VolturnUS-S, OC3spar and OC4semi, each through
  ``analyzeUnloaded(ballast=1)`` at ``heave_tol`` 1.0 (the fill-level
  walk) and ``analyzeUnloaded(ballast=2)`` (the density shift);
- (b2) `TRIMS` ``b2_*``: the walk at ``heave_tol`` 1e-5 on OC4semi and
  VolturnUS-S.  Together the walks take every branch of the walk: the
  bisection (every walk's first section), ``Vtarget >= Vmax`` (b2
  VolturnUS-S: its rectangular pontoons, full as built), ``Vtarget <= 0``
  (b2 OC4semi: its five empty pontoon and brace groups) and a group of
  three members (the outer / offset columns of both);
- (b3) `RUNS`: ``run_raft(design, ballast=True)`` on VolturnUS-S (its one
  case) and OC3spar (its first case), each held by its physics record
  (``mhk_cases.case_records``) and, where the JAX package's two statics
  backends agree, its ledger golden.

`trim_record` is the record of one trim (either package's model);
`trim_deviation` holds a live record against a golden one: every fill
level equal (they are rounded to the centimetre, so a difference is a
flipped rounding), each visited section's unrounded fill level at
`UNROUNDED_TOL`, the density shift and every fill density at
`DENSITY_TOL`, the rest at `GOLDEN_TOL` but for the offset components
at the rounding floor (`floor_zeros`), and the outputs the trim drives
to zero (`NEAR_ZERO`) by `floor_bar`.  Nothing here runs on import.
"""
from __future__ import annotations

import math

import numpy as np

from raft_tpu_torch.ledger import _rel
from raft_tpu_torch.models.mhk_cases import GRID

#: the vendored design of each key
DESIGNS = {"volturnus": "VolturnUS-S", "oc3spar": "OC3spar",
           "oc4semi": "OC4semi"}

#: (b1) and (b2): id -> (design key, ballast mode, heave_tol)
TRIMS = {
    "b1_volturnus_walk": ("volturnus", 1, 1.0),
    "b1_volturnus_density": ("volturnus", 2, 1.0),
    "b1_oc3spar_walk": ("oc3spar", 1, 1.0),
    "b1_oc3spar_density": ("oc3spar", 2, 1.0),
    "b1_oc4semi_walk": ("oc4semi", 1, 1.0),
    "b1_oc4semi_density": ("oc4semi", 2, 1.0),
    "b2_oc4semi_walk": ("oc4semi", 1, 1e-5),
    "b2_volturnus_walk": ("volturnus", 1, 1e-5),
}

#: (b3): golden stem -> (design key, number of leading cases kept; None:
#: all)
RUNS = {"volturnus_ballast": ("volturnus", None),
        "oc3spar_ballast": ("oc3spar", 1)}

#: the (b3) runs with a ledger golden beside their physics record: those
#: whose two JAX statics backends pass each other's ledger golden check
LEDGER_STEMS = ("volturnus_ballast", "oc3spar_ballast")

#: the branches of the walk the (b1) and (b2) walks take together
BRANCHES = ("bisect", "full", "empty")

#: each visited section's unrounded fill level [relative]
UNROUNDED_TOL = 1e-9
#: the density shift and every fill density [relative]
DENSITY_TOL = 1e-12
#: the heave imbalance before any trim [relative]
IMBALANCE_TOL = 1e-12
#: everything downstream of a trim [relative]
GOLDEN_TOL = 1e-6
#: the factor of machine epsilon in `floor_bar`
FLOOR_FACTOR = 16.0

#: the outputs a density trim drives to zero, held by `floor_bar`: the
#: heave imbalance after the trim and the heave of the unloaded offset
NEAR_ZERO = ("heave_after", "offset_unloaded[2]")


def design(key: str, coarse: bool = False, ncases=None) -> dict:
    """The vendored design of ``key`` (`DESIGNS`), on the coarse golden
    grid when ``coarse``, its first ``ncases`` cases kept."""
    from raft_tpu_torch.io.designs import load_design

    d = load_design(DESIGNS[key])
    if coarse:
        d["settings"].update(GRID)
    if ncases is not None:
        d["cases"]["data"] = d["cases"]["data"][:ncases]
    return d


#: the labels (``what``) of the trim's counted host pulls
PULLS = ("ballast_geometry", "ballast_imbalance", "ballast_density")


def trim_pulls(ballast: int, sections: int) -> int:
    """The port's counted host pulls of one trim: a walk reads the
    platform's geometry once and the heave imbalance before it and after
    each of the ``sections`` it visits; a density shift reads its shift
    and the ballast volume once."""
    return 2 + sections if ballast == 1 else 1


def floor_bar(m, V, AWP, Fz_moor, rho, g) -> float:
    """The absolute bar on an output the trim drives to zero, the rounding
    floor of the vertical force sum it balances:

        |port − JAX| ≤ 16 · eps64 · (|m g| + |V ρ g| + |Fz_moor|) / (ρ g AWP)

    from the trimmed design's own mass ``m`` [kg], displaced volume ``V``
    [m^3], waterplane area ``AWP`` [m^2] and mooring heave force
    ``Fz_moor`` [N] at the reference pose.  A relative bar on such a
    value (~1e-15 m) would compare rounding noise; it applies only to the
    outputs of `NEAR_ZERO`, every other output keeps its relative bar."""
    eps = float(np.finfo(np.float64).eps)
    return FLOOR_FACTOR * eps * (abs(m * g) + abs(V * rho * g)
                                 + abs(Fz_moor)) / (rho * g * AWP)


def floor_zeros(rec: dict) -> dict:
    """The components of a trim record's unloaded offset that are zero:
    no larger than the rounding floor of its force sum (`floor_bar` of
    its ``floor_terms``), set by rounding, not by the physics (sway, roll
    and yaw of a symmetric platform, ~1e-16).  They are listed in the
    golden's ``zero`` with their value and not held; the non-zero
    components keep the relative bar, and a `NEAR_ZERO` one its own."""
    bar = floor_bar(**rec["floor_terms"])
    return {f"offset_unloaded[{i}]": x
            for i, x in enumerate(rec["offset_unloaded"])
            if abs(x) <= bar
            and f"offset_unloaded[{i}]" not in rec.get("near_zero", {})}


def rounding_margin(x: float) -> float:
    """Distance [m] of an unrounded fill level to the nearest boundary of
    ``round(x, 2)`` (a half centimetre)."""
    c = x * 100.0
    return abs(abs(c - math.floor(c)) - 0.5) / 100.0


def _host(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float)


def trim_record(fowt, walk, heave_before, heave_after, delta_rho,
                offset_unloaded, unloaded_iters) -> dict:
    """The record of one trim on either package's model: every member's
    fill levels and densities after it, the visited sections of a walk
    (``walk``: the port's ``Model.ballast_walk`` records, each given its
    rounding margin), the heave imbalance before and after, the density
    shift (None for a walk), the unloaded offset and its Newton
    iterations."""
    return dict(
        l_fill=[np.atleast_1d(_host(m.l_fill)).tolist() for m in fowt.members],
        rho_fill=[np.atleast_1d(_host(m.rho_fill)).tolist()
                  for m in fowt.members],
        walk=[dict(w, margin=rounding_margin(w["l_new_unrounded"]))
              for w in walk],
        heave_before=float(heave_before), heave_after=float(heave_after),
        delta_rho=None if delta_rho is None else float(delta_rho),
        offset_unloaded=_host(offset_unloaded).tolist(),
        unloaded_iters=None if unloaded_iters is None
        else int(unloaded_iters))


def run_trim_record(model, heave_before=None) -> dict:
    """`trim_record` of a port model whose ``analyzeUnloaded`` ran a trim
    (``heave_before``: the imbalance before it, by default the walk's
    first).  ``analyzeCases`` (``run_raft``) forgets the unloaded
    statics' record: ``unloaded_iters`` is then None, for the caller to
    fill from what it read before."""
    trim = model.ballast_trim
    fowt = model.fowtList[0]
    return trim_record(
        fowt, trim["walk"],
        trim["heave0"] if heave_before is None else heave_before,
        model._heave_imbalance(fowt)[1], trim["delta_rho"],
        model.results["properties"]["offset_unloaded"],
        model._case_records.get("unloaded", {}).get("statics_iters"))


def trim_deviation(gold: dict, live: dict) -> dict:
    """A live trim record against its golden: ``ok`` and the readings
    (``fills_equal``, ``walk_equal``: every section's group, section,
    branch and rounded fill level; ``unrounded``: the worst relative
    deviation of the unrounded fill levels and the smallest rounding
    margin; ``imbalance``: the heave before the trim; ``density``;
    ``downstream``: the worst relative deviation of the walk's heaves,
    the final heave and the held offset components: not those at the
    rounding floor, listed under the golden's ``zero`` (`floor_zeros`),
    nor those the JAX package's two statics backends disagree on, under
    its ``unheld``);
    ``near_zero``: each `NEAR_ZERO` output's deviation beside its bar;
    ``iters_equal``: the unloaded Newton iterations)."""
    walk_equal = len(gold["walk"]) == len(live["walk"]) and all(
        (a["group"], a["section"], a["branch"], a["l_new"])
        == (b["group"], b["section"], b["branch"], b["l_new"])
        for a, b in zip(gold["walk"], live["walk"]))
    unrounded = max((_rel(a["l_new_unrounded"], b["l_new_unrounded"])
                     for a, b in zip(gold["walk"], live["walk"])),
                    default=0.0)
    density = 0.0
    if gold["delta_rho"] is not None:
        density = max([_rel(gold["delta_rho"], live["delta_rho"])]
                      + [_rel(a, b) for ga, gb in zip(gold["rho_fill"],
                                                      live["rho_fill"])
                         for a, b in zip(ga, gb)])
    near = gold.get("near_zero", {})
    imbalance = _rel(gold["heave_before"], live["heave_before"])
    down = [_rel(a["heave"], b["heave"])
            for a, b in zip(gold["walk"], live["walk"])]
    if "heave_after" not in near:
        down.append(_rel(gold["heave_after"], live["heave_after"]))
    for i, (a, b) in enumerate(zip(gold["offset_unloaded"],
                                   live["offset_unloaded"])):
        key = f"offset_unloaded[{i}]"
        if key not in near and key not in gold.get("unheld", {}) \
                and key not in gold.get("zero", {}):
            down.append(_rel(a, b))
    zero = {}
    for key, bar in near.items():
        if key == "heave_after":
            a, b = gold["heave_after"], live["heave_after"]
        else:
            i = int(key[key.index("[") + 1:-1])
            a, b = gold["offset_unloaded"][i], live["offset_unloaded"][i]
        zero[key] = dict(jax=a, port=b, dev=abs(a - b), bar=bar)
    fills_equal = gold["l_fill"] == live["l_fill"]
    out = dict(
        fills_equal=fills_equal, walk_equal=walk_equal,
        unrounded=dict(rel=unrounded, min_margin=min(
            (w["margin"] for w in gold["walk"] if w["branch"] == "bisect"),
            default=None)),
        imbalance=imbalance, density=density, downstream=max(down),
        near_zero=zero,
        iters_equal=gold["unloaded_iters"] == live["unloaded_iters"])
    out["ok"] = (fills_equal and walk_equal and unrounded <= UNROUNDED_TOL
                 and imbalance <= IMBALANCE_TOL and density <= DENSITY_TOL
                 and max(down) <= GOLDEN_TOL
                 and all(z["dev"] <= z["bar"] for z in zero.values())
                 and out["iters_equal"])
    return out
