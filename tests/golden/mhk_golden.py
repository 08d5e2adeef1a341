"""Write or check the submerged-rotor (MHK) and general-mooring goldens with
the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per run, on the designs of ``raft_tpu_torch/models/mhk_cases.py`` (plain
dicts, so the port runs the same ones), each at two widths: the design's
own grid (``full``: 400 bins for RM1 and FOCTT, OC3spar's 80 for the
clump-weight mooring; ``chip_smoke.py`` holds the port to these) and the
coarse golden grid 0.02-0.2 Hz, 10 bins (``coarse``; the CPU tests).

- (m1) ``rm1_floating[_coarse].{metrics,ledger}.json``: RM1_Floating as
  shipped (still water at a 1.9 m/s current) and the same case under JONSWAP
  Hs 2 m, Tp 8 s; ``analyzeUnloaded`` then ``analyzeCases``.
- (m2a) ``foctt_build[_coarse].json``: FOCTT_example's build and its
  shipped case's constants at the zero pose
  (``mhk_cases.build_record``).  Its statics are not held: no statics
  Newton of this design converges as shipped (ROADMAP C8; the script
  prints the unloaded and shipped-case iterations and residuals of both
  statics backends).
- (m2b) ``foctt_current[_coarse].metrics.json``: ``mhk_cases.M2B_CASE``,
  the one FOCTT case found on which both statics backends converge: the
  shipped case (rotor operating on the current under ``aeroServoMod:
  2``, JONSWAP Hs 1 m, Tp 12 s) with the current and the waves from 180
  degrees at 1.0 m/s.  The shipped case stops at the 50-iteration cap on
  both backends, as do 0.5, 1.0 and 1.5 m/s from 0 degrees (the default
  backend converges at 1.5 m/s, the host one does not); the port, whose
  statics are the host backend's algorithm, also stops at the cap at
  0.25-3.0 m/s from 0 degrees and at 1.0 and 2.0 m/s from 45, 90 and
  (2.0 m/s) 180 degrees.
- (m3) ``oc3spar_clump[_coarse].{metrics,ledger}.json``: OC3spar with each
  line split at a free 2000 kg clump weight (``mhk_cases.clump_design``),
  its first case.
- ``rm1_cavitation.json`` / ``foctt_cavitation.json``: ``calc_cavitation``
  at case 0 (FOCTT: the shipped case and m2b's) at the defaults and at
  ``Pvap=3e5``.

Every model runs on both statics backends (``RAFT_TPU_STATICS=host``, the
port's algorithm, and the default jitted one); the goldens are written
from the host backend.  m1, m2b and m3 each have a physics record
(``mhk_cases.case_records``: every case's mean, std and maximum of each
DOF, mean offsets, mooring tensions and rotor channels at 1e-6, the
statics and drag iteration counts exactly, and both backends'
``statics_residual``; a channel on which the two backends themselves
differ by more than 1e-6 is left out and listed under ``unheld``).
Where the two backends' ledgers pass each other's golden check (metrics
at 1e-6, residuals in the 0.5 band, iteration counts equal), the host
backend's ledger is committed as well, ``<stem>[_coarse].ledger.json``:
m1 and m3 (``mhk_cases.LEDGER_STEMS``; the script fails if the backends
say otherwise).  m2b's backends leave ``statics_residual`` 0.66 apart,
at the rounding floor of the force sum (ROADMAP C7), so it has no
ledger golden.  The script prints both backends' residuals.

    JAX_PLATFORMS=cpu python tests/golden/mhk_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/mhk_golden.py --write  # rewrite

Without ``--write`` the runs are diffed against the committed files at the
same bars (the build record and the cavitation arrays at 1e-9).
Regenerate only after an intentional physics change.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
TOL = 1e-6
RESIDUAL_TOL = 0.5
BACKENDS = ("host", "default")
WIDTHS = ("full", "coarse")
#: the golden file stem of each model held by its physics record
STEMS = {"m1": "rm1_floating", "m2b": "foctt_current", "m3": "oc3spar_clump"}
#: parallel JAX processes
JOBS = 4


def _design(name, width):
    from raft_tpu_torch.models import mhk_cases as MC

    grid = MC.GRID if width == "coarse" else None
    if name == "m1":
        return MC.rm1_design(grid)
    if name == "m2b":
        return MC.foctt_design(grid, **MC.M2B_CASE)
    if name == "m3":
        return MC.clump_design(grid, ncases=1)
    return MC.foctt_design(grid)          # m2a, shipped


def _case0(design):
    return dict(zip(design["cases"]["keys"], design["cases"]["data"][0]))


def cavitation_pair(rot, case):
    """calc_cavitation at the defaults and at Pvap=3e5 (the JAX
    package's)."""
    from raft_tpu.models.rotor import calc_cavitation

    return {"default": calc_cavitation(rot, case).tolist(),
            "Pvap_3e5": calc_cavitation(rot, case, Pvap=3e5).tolist()}


def run_one(name: str, backend: str, width: str, out: str) -> None:
    """One JAX run in this process, its outputs written into ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_JOURNAL"] = "0"       # no case journal to resume
    if backend == "host":
        os.environ["RAFT_TPU_STATICS"] = "host"
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu.model import Model
    from raft_tpu.models import fowt as JF
    from raft_tpu.models import rotor as JR
    from raft_tpu.obs.ledger import write_ledger
    from raft_tpu_torch.models import mhk_cases as MC

    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    d = _design(name, width)
    rec = {"run": name, "backend": backend, "width": width}
    m = Model(d)
    rot = m.fowtList[0].rotors[0] if m.fowtList[0].rotors else None
    if name == "m2a":
        case = _case0(d)
        cav = cavitation_pair(rot, case)
        build = MC.build_record(m.fowtList[0], JF, JR, case,
                                cav["default"])
        with open(os.path.join(out, "build.json"), "w") as f:
            json.dump(dict(build=build, cavitation=cav), f)
        # the statics the record leaves out (ROADMAP C8)
        m.analyzeUnloaded()
        unl = m._case_records.get("unloaded", {})
        m.analyzeCases()
        ent = {e["key"]: e["metrics"] for e in m.last_ledger["entries"]}
        rec.update(unloaded_iters=unl.get("statics_iters"),
                   unloaded_residual=unl.get("statics_residual"),
                   shipped_iters=ent["case0/system"]["statics_iters"],
                   shipped_residual=ent["case0/system"]["statics_residual"],
                   shipped_mean=[float(x)
                                 for x in m.results["mean_offsets"][0]])
    else:
        m.analyzeUnloaded()
        m.analyzeCases()
        write_ledger(m.last_ledger, os.path.join(out, "ledger.json"))
        recs = MC.case_records(m.results, m.last_ledger)
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(recs, f)
        recs = recs["cases"]
        if rot is not None and rot.hubHt < 0:
            with open(os.path.join(out, "cavitation.json"), "w") as f:
                json.dump(cavitation_pair(rot, _case0(d)), f)
        rec.update(statics_residual=[r["statics_residual"] for r in recs],
                   iters=[r["iters"] for r in recs])
    rec["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)


def _sub(args):
    name, backend, width, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", name, backend, width, out], check=True)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def ledgers_agree(a: dict, b: dict, label: str) -> bool:
    """Two ledgers under the golden bars: metrics at 1e-6, the solver
    residuals at 0.5, the iteration counts equal."""
    from raft_tpu.obs.ledger import _compare_values

    ma = {e["key"]: e["metrics"] for e in a["entries"]}
    mb = {e["key"]: e["metrics"] for e in b["entries"]}
    worst = {False: 0.0, True: 0.0}
    same = set(ma) == set(mb)
    for key in set(ma) & set(mb):
        same = same and set(ma[key]) == set(mb[key])
        for n in set(ma[key]) & set(mb[key]):
            if n.endswith("_iters") or n == "drag_converged":
                same = same and ma[key][n] == mb[key][n]
                continue
            res = "residual" in n
            worst[res] = max(worst[res],
                             _compare_values(ma[key][n], mb[key][n])[0])
    print(json.dumps({label: {"max_rel": worst[False],
                              "max_rel_residuals": worst[True],
                              "same_keys_and_iters": same}}))
    return worst[False] <= TOL and worst[True] <= RESIDUAL_TOL and same


def records_agree(a: dict, b: dict, label: str) -> bool:
    from raft_tpu_torch.models import mhk_cases as MC

    rel, same = MC.case_records_deviation(a, b)
    print(json.dumps({label: {"max_rel": rel, "iters_equal": same}}))
    return rel <= TOL and same


def builds_agree(a: dict, b: dict, label: str) -> bool:
    from raft_tpu_torch.models import mhk_cases as MC

    rel, bad = MC.record_deviation(a, b)
    print(json.dumps({label: {"max_rel": rel, "differing": bad}}))
    return rel <= MC.RECORD_TOL and not bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--run", nargs=4,
                    metavar=("NAME", "BACKEND", "WIDTH", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(*args.run)
        return 0

    from raft_tpu.obs import ledger
    from raft_tpu_torch.models import mhk_cases as MC

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(n, b, w, os.path.join(tmp, f"{n}_{b}_{w}"))
                for n in ("m1", "m2a", "m2b", "m3") for b in BACKENDS
                for w in WIDTHS]
        with ThreadPoolExecutor(JOBS) as pool:
            list(pool.map(_sub, jobs))
        out = {(n, b, w): o for n, b, w, o in jobs}

        # m2a: the build record, equal on both backends (no statics in it)
        for w in WIDTHS:
            suffix = "" if w == "full" else "_coarse"
            live = _load_json(os.path.join(out["m2a", "host", w],
                                           "build.json"))
            other = _load_json(os.path.join(out["m2a", "default", w],
                                            "build.json"))
            ok = builds_agree(live["build"], other["build"],
                              f"m2a_{w}_host_vs_default") and ok
            gold = os.path.join(HERE, f"foctt_build{suffix}.json")
            if args.write:
                with open(gold, "w") as f:
                    json.dump(live["build"], f)
                    f.write("\n")
            else:
                ok = builds_agree(_load_json(gold), live["build"],
                                  f"m2a_{w}_golden") and ok

        # the cavitation arrays (grid-independent: the full-width runs)
        cav = {"rm1": _load_json(os.path.join(out["m1", "host", "full"],
                                              "cavitation.json")),
               "foctt": {
                   "shipped": _load_json(os.path.join(
                       out["m2a", "host", "full"], "build.json"))
                   ["cavitation"],
                   "m2b": _load_json(os.path.join(
                       out["m2b", "host", "full"], "cavitation.json"))}}
        for key, val in cav.items():
            gold = os.path.join(HERE, f"{key}_cavitation.json")
            if args.write:
                with open(gold, "w") as f:
                    json.dump(val, f, indent=1)
                    f.write("\n")
            else:
                ok = builds_agree(_load_json(gold), val,
                                  f"{key}_cavitation_golden") and ok

        # m1, m2b, m3: the physics record, and the ledger golden of m1
        # and m3
        for name, stem in STEMS.items():
            for w in WIDTHS:
                led = {b: ledger.load_ledger(os.path.join(
                    out[name, b, w], "ledger.json")) for b in BACKENDS}
                recs = {b: _load_json(os.path.join(out[name, b, w],
                                                   "metrics.json"))
                        for b in BACKENDS}
                print(json.dumps({f"{name}_{w}_statics_residual": {
                    b: [c["statics_residual"] for c in recs[b]["cases"]]
                    for b in BACKENDS}}))
                held = MC.held_record(recs["host"], recs["default"], TOL)
                print(json.dumps({f"{name}_{w}_unheld": held["unheld"]}))
                ok = records_agree(held, recs["default"],
                                   f"{name}_{w}_records_host_vs_default") \
                    and ok
                # a ledger golden where the two backends' ledgers pass
                # each other's golden check (MC.LEDGER_STEMS says which)
                agree = ledgers_agree(led["host"], led["default"],
                                      f"{name}_{w}_ledgers_host_vs_default")
                if agree != (stem in MC.LEDGER_STEMS):
                    print(f"{name}_{w}: backends' ledgers agree {agree}, "
                          f"but mhk_cases.LEDGER_STEMS says "
                          f"{stem in MC.LEDGER_STEMS}")
                    ok = False
                if agree:
                    gl = MC.ledger_golden_file(HERE, stem,
                                               coarse=w == "coarse")
                    if args.write:
                        ledger.write_ledger(led["host"], gl)
                    else:
                        ok = ledgers_agree(ledger.load_ledger(gl),
                                           led["host"],
                                           f"{name}_{w}_ledger_golden") \
                            and ok
                gm = MC.golden_file(HERE, stem, coarse=w == "coarse")
                if args.write:
                    with open(gm, "w") as f:
                        json.dump(dict(
                            held, statics_backend="host",
                            statics_residual_default=[
                                c["statics_residual"]
                                for c in recs["default"]["cases"]]),
                            f, indent=1)
                        f.write("\n")
                else:
                    gold = _load_json(gm)
                    ok = gold["unheld"].keys() == held["unheld"].keys() \
                        and records_agree(gold, recs["host"],
                                          f"{name}_{w}_golden") and ok
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
