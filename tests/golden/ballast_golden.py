"""Write or check the ballast-trim goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per run, on the cases of ``raft_tpu_torch/models/ballast_cases.py`` (plain
dicts, so the port runs the same ones).  Every file is written under
``tests/golden/ballast/``.

- (b1), (b2) ``trims.json``: one record per ``ballast_cases.TRIMS`` id
  (``ballast_cases.trim_record``): a fresh ``Model`` of the design at its
  own grid, its heave imbalance, then ``analyzeUnloaded(ballast=1,
  heave_tol=...)`` or ``analyzeUnloaded(ballast=2)``: every member's fill
  levels and densities after it, each visited section of a walk (group,
  section, branch, start, unrounded and rounded fill level, the heave
  after it, the margin of the unrounded value to its rounding boundary),
  the density shift, the heave imbalance after the trim and the unloaded
  offset with its Newton iterations.  Each record also holds the
  trimmed design's mass, displacement, waterplane area and mooring heave
  force at the reference pose (``floor_terms``) and, for a density trim,
  the bar ``ballast_cases.floor_bar`` gives from them for each output of
  ``ballast_cases.NEAR_ZERO`` (``near_zero``); the offset components no
  larger than that floor are listed under ``zero`` and not held
  (``ballast_cases.floor_zeros``).  The JAX walk does not
  expose its unrounded fill levels: the script reads them at the walk's
  ``round(l_new, 2)`` and pairs them with the sections in walk order.
- (b3) ``<stem>[_coarse].metrics.json`` for each ``ballast_cases.RUNS``
  stem: ``analyzeUnloaded(ballast=1)`` -> ``analyzeCases`` ->
  ``calcOutputs`` (the JAX ``run_raft(ballast=True)``) at the design's own
  80 bins (``chip_smoke.py`` holds the port to these) and on the coarse
  golden grid (the CPU tests): the physics record of every case
  (``mhk_cases.case_records``), the trim record, and ``calcOutputs``'
  ballast densities and masses; ``<stem>[_coarse].ledger.json`` where the
  two backends' ledgers pass each other's golden check
  (``ballast_cases.LEDGER_STEMS``; the script fails if they say
  otherwise).

Every run goes through both statics backends (``RAFT_TPU_STATICS=host``,
the port's algorithm, and the default jitted one); the goldens are
written from the host backend.  An offset component or a physics-record
channel on which the two backends differ by more than 1e-6 is left out
and listed under ``unheld``; the script checks that the backends agree on
everything else at the bars of ``ballast_cases.trim_deviation`` and
prints, for every walk, each section's rounding margin.

    JAX_PLATFORMS=cpu python tests/golden/ballast_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/ballast_golden.py --write  # rewrite

Without ``--write`` the runs are diffed against the committed files at the
same bars.  Regenerate only after an intentional physics change.
"""
import argparse
import contextlib
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
sys.path.insert(0, HERE)
OUT = os.path.join(HERE, "ballast")
BACKENDS = ("host", "default")
WIDTHS = ("full", "coarse")
TOL = 1e-6
#: parallel JAX processes
JOBS = 4


@contextlib.contextmanager
def walk_spy(model):
    """Inside: every ``round(l_new, 2)`` of the JAX walk records its
    argument, and every ``_heave_imbalance`` of ``model`` its heave."""
    import raft_tpu.model as JM

    seen = {"unrounded": [], "heave": []}
    imbalance = model._heave_imbalance

    def spy_round(x, n):
        seen["unrounded"].append(float(x))
        return round(x, n)

    def spy_imbalance(fowt):
        out = imbalance(fowt)
        seen["heave"].append(float(out[1]))
        return out

    JM.round = spy_round
    model._heave_imbalance = spy_imbalance
    try:
        yield seen
    finally:
        del JM.round
        del model._heave_imbalance


def jax_walk(model, fowt, l_fill0, seen) -> list:
    """The visited sections of a JAX walk, as ``Model.ballast_trim["walk"]``
    records them in the port: the sections with a positive fill density in
    walk order, paired with the spy's unrounded fill levels and heaves."""
    import numpy as np

    sections = [(ig, g[0], j) for ig, g in enumerate(model._member_groups(fowt))
                for j, rho in enumerate(np.atleast_1d(np.asarray(
                    fowt.members[g[0]].rho_fill, float))) if rho > 0]
    walk = []
    for (ig, mem, j), x, h in zip(sections, seen["unrounded"],
                                  seen["heave"][1:]):
        branch = ("full" if x == fowt.members[mem].l
                  else "empty" if x == 0.0 else "bisect")
        walk.append(dict(group=ig, member=mem, section=j,
                         l_fill0=float(l_fill0[mem][j]), l_new_unrounded=x,
                         l_new=round(x, 2), branch=branch, heave=h))
    return walk


def trim_jax(model, ballast, heave_tol) -> dict:
    """One trim on a fresh JAX model through ``analyzeUnloaded``: its
    ``ballast_cases.trim_record`` with ``floor_terms`` and, for a density
    trim, ``near_zero``."""
    import numpy as np

    from raft_tpu.models import mooring as mr
    from raft_tpu_torch.models import ballast_cases as BC

    fowt = model.fowtList[0]
    heave_before = model._heave_imbalance(fowt)[1]
    l_fill0 = [np.atleast_1d(np.asarray(m.l_fill, float)).copy()
               for m in fowt.members]
    delta = []
    density = model.adjustBallastDensity
    model.adjustBallastDensity = lambda *a, **k: delta.append(
        density(*a, **k))
    with walk_spy(model) as seen:
        model.analyzeUnloaded(ballast=ballast, heave_tol=heave_tol)
    del model.adjustBallastDensity
    walk = jax_walk(model, fowt, l_fill0, seen) if ballast == 1 else []
    _, heave_after, stat = model._heave_imbalance(fowt)
    ref = np.array([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0], float)
    terms = dict(
        m=float(np.asarray(stat["M_struc"])[0, 0]),
        V=float(np.asarray(stat["V"])), AWP=float(np.asarray(stat["AWP"])),
        Fz_moor=0.0 if fowt.mooring is None else float(
            np.asarray(mr.body_wrench(fowt.mooring, ref))[2]),
        rho=float(fowt.rho_water), g=float(fowt.g))
    rec = BC.trim_record(
        fowt, walk, heave_before, heave_after, delta[0] if delta else None,
        model.results["properties"]["offset_unloaded"],
        model._case_records["unloaded"]["statics_iters"])
    rec["floor_terms"] = terms
    if ballast == 2:
        rec["near_zero"] = {k: BC.floor_bar(**terms) for k in BC.NEAR_ZERO}
    return rec


def run_one(job: str, backend: str, width: str, out: str) -> None:
    """One JAX process: ``trims:<design key>`` (every TRIMS id of that
    design) or ``run:<stem>``, at ``width``; outputs into ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_JOURNAL"] = "0"       # no case journal to resume
    if backend == "host":
        os.environ["RAFT_TPU_STATICS"] = "host"
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from raft_tpu.model import Model
    from raft_tpu.obs.ledger import write_ledger
    from raft_tpu_torch.models import ballast_cases as BC
    from raft_tpu_torch.models import mhk_cases as MC

    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    kind, name = job.split(":")
    coarse = width == "coarse"
    if kind == "trims":
        recs = {tid: trim_jax(Model(BC.design(key, coarse)), ballast, tol)
                for tid, (key, ballast, tol) in BC.TRIMS.items()
                if key == name}
        with open(os.path.join(out, "trims.json"), "w") as f:
            json.dump(recs, f)
    else:
        key, ncases = BC.RUNS[name]
        m = Model(BC.design(key, coarse, ncases))
        trim = trim_jax(m, 1, 1.0)
        m.analyzeCases()
        m.calcOutputs()
        write_ledger(m.last_ledger, os.path.join(out, "ledger.json"))
        rec = MC.case_records(m.results, m.last_ledger)
        props = m.results["properties"]
        rec.update(trim=trim, properties={
            k: np.asarray(props[k], float).tolist()
            for k in ("ballast densities", "ballast mass")})
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(rec, f)
    print(json.dumps({"job": job, "backend": backend, "width": width,
                      "wall_s": time.perf_counter() - t0}), flush=True)


def _sub(args):
    job, backend, width, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", job, backend, width, out], check=True)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def unheld_offsets(host: dict, default: dict) -> dict:
    """The unloaded offset components on which the two backends differ
    by more than ``TOL`` (rounding, not physics), with that difference;
    the `NEAR_ZERO` ones are held by their bar instead."""
    from raft_tpu_torch.ledger import _rel

    near = host.get("near_zero", {})
    return {f"offset_unloaded[{i}]": _rel(a, b)
            for i, (a, b) in enumerate(zip(host["offset_unloaded"],
                                           default["offset_unloaded"]))
            if _rel(a, b) > TOL and f"offset_unloaded[{i}]" not in near}


def trims_agree(gold: dict, live: dict, label: str) -> bool:
    from raft_tpu_torch.models import ballast_cases as BC

    dev = BC.trim_deviation(gold, live)
    print(json.dumps({label: dev}))
    return dev["ok"]


def properties_agree(a: dict, b: dict, label: str) -> bool:
    """calcOutputs' ballast densities and masses at ``TOL``."""
    from raft_tpu_torch.ledger import _compare_values

    rel = max(_compare_values(a[k], b[k])[0] for k in a)
    print(json.dumps({label: {"max_rel": rel}}))
    return rel <= TOL and a.keys() == b.keys()


def margins(label: str, rec: dict) -> None:
    print(json.dumps({f"{label}_walk": [
        dict(group=w["group"], section=w["section"], branch=w["branch"],
             l_new_unrounded=w["l_new_unrounded"], l_new=w["l_new"],
             margin=w["margin"]) for w in rec["walk"]]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--run", nargs=4,
                    metavar=("JOB", "BACKEND", "WIDTH", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(*args.run)
        return 0

    from mhk_golden import ledgers_agree, records_agree

    from raft_tpu.obs import ledger
    from raft_tpu_torch.models import ballast_cases as BC
    from raft_tpu_torch.models import mhk_cases as MC

    ok = True
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(f"trims:{k}", b, "full", os.path.join(tmp, f"t_{k}_{b}"))
                for k in BC.DESIGNS for b in BACKENDS]
        jobs += [(f"run:{s}", b, w, os.path.join(tmp, f"r_{s}_{b}_{w}"))
                 for s in BC.RUNS for b in BACKENDS for w in WIDTHS]
        with ThreadPoolExecutor(JOBS) as pool:
            list(pool.map(_sub, jobs))
        out = {(j, b, w): o for j, b, w, o in jobs}

        # (b1), (b2): the trim records
        recs = {b: {} for b in BACKENDS}
        for b in BACKENDS:
            for k in BC.DESIGNS:
                recs[b].update(_load_json(os.path.join(
                    out[f"trims:{k}", b, "full"], "trims.json")))
        gold_trims = {}
        for tid in BC.TRIMS:
            host, default = recs["host"][tid], recs["default"][tid]
            host["unheld"] = unheld_offsets(host, default)
            host["zero"] = BC.floor_zeros(host)
            default.update(unheld=host["unheld"], zero=host["zero"])
            ok = trims_agree(host, default, f"{tid}_host_vs_default") and ok
            margins(tid, host)
            gold_trims[tid] = host
        branches = {w["branch"] for r in gold_trims.values()
                    for w in r["walk"]}
        if branches != set(BC.BRANCHES):
            print(f"the walks take the branches {sorted(branches)}, not "
                  f"{BC.BRANCHES}")
            ok = False
        gpath = os.path.join(OUT, "trims.json")
        if args.write:
            with open(gpath, "w") as f:
                json.dump(gold_trims, f, indent=1)
                f.write("\n")
        else:
            gold = _load_json(gpath)
            for tid in BC.TRIMS:
                ok = all(gold[tid][k].keys() == gold_trims[tid][k].keys()
                         for k in ("unheld", "zero")) and trims_agree(
                        gold[tid], gold_trims[tid], f"{tid}_golden") and ok

        # (b3): the physics records, the trims, and the ledger goldens
        for stem in BC.RUNS:
            for w in WIDTHS:
                coarse = w == "coarse"
                led = {b: ledger.load_ledger(os.path.join(
                    out[f"run:{stem}", b, w], "ledger.json"))
                    for b in BACKENDS}
                run = {b: _load_json(os.path.join(
                    out[f"run:{stem}", b, w], "metrics.json"))
                    for b in BACKENDS}
                print(json.dumps({f"{stem}_{w}_statics_residual": {
                    b: [c["statics_residual"] for c in run[b]["cases"]]
                    for b in BACKENDS}}))
                held = MC.held_record(run["host"], run["default"], TOL)
                trim = held["trim"]
                trim["unheld"] = unheld_offsets(trim, run["default"]["trim"])
                trim["zero"] = BC.floor_zeros(trim)
                run["default"]["trim"].update(unheld=trim["unheld"],
                                              zero=trim["zero"])
                print(json.dumps({f"{stem}_{w}_unheld": held["unheld"],
                                  f"{stem}_{w}_trim_unheld": trim["unheld"]}))
                ok = records_agree(held, run["default"],
                                   f"{stem}_{w}_records_host_vs_default") \
                    and ok
                ok = trims_agree(trim, run["default"]["trim"],
                                 f"{stem}_{w}_trim_host_vs_default") and ok
                ok = properties_agree(held["properties"],
                                      run["default"]["properties"],
                                      f"{stem}_{w}_properties_host_vs_default"
                                      ) and ok
                margins(f"{stem}_{w}", trim)
                agree = ledgers_agree(led["host"], led["default"],
                                      f"{stem}_{w}_ledgers_host_vs_default")
                if agree != (stem in BC.LEDGER_STEMS):
                    print(f"{stem}_{w}: backends' ledgers agree {agree}, "
                          f"but ballast_cases.LEDGER_STEMS says "
                          f"{stem in BC.LEDGER_STEMS}")
                    ok = False
                gl = MC.ledger_golden_file(OUT, stem, coarse)
                gm = MC.golden_file(OUT, stem, coarse)
                held.update(statics_backend="host",
                            statics_residual_default=[
                                c["statics_residual"]
                                for c in run["default"]["cases"]])
                if args.write:
                    if agree:
                        ledger.write_ledger(led["host"], gl)
                    with open(gm, "w") as f:
                        json.dump(held, f, indent=1)
                        f.write("\n")
                    continue
                if agree:
                    ok = ledgers_agree(ledger.load_ledger(gl), led["host"],
                                       f"{stem}_{w}_ledger_golden") and ok
                gold = _load_json(gm)
                ok = gold["unheld"].keys() == held["unheld"].keys() \
                    and records_agree(gold, run["host"],
                                      f"{stem}_{w}_golden") \
                    and trims_agree(gold["trim"], trim,
                                    f"{stem}_{w}_trim_golden") \
                    and properties_agree(gold["properties"],
                                         held["properties"],
                                         f"{stem}_{w}_properties_golden") \
                    and ok
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
