"""Write or check the MacCamy-Fuchs goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per run, on the designs of ``raft_tpu_torch/models/mcf_cases.py`` (OC4semi
with ``MCF: True`` on its circular vertical columns; plain dicts, so the
port runs the same ones), each at two widths: the design's own grid
(``full``: 80 bins, and under ``potSecOrder: 1`` examples/example_qtf.py's
second-order grid, 30 bins; ``chip_smoke.py`` holds the port to these)
and the coarse golden grid 0.02-0.2 Hz, 10 bins (``coarse``, second-order
grid 0.02-0.16 Hz, 8 bins; the CPU tests).  Each run is Model ->
analyzeUnloaded -> analyzeCases:

- (c1) ``oc4semi_mcf``: strip theory, the design's one case;
- (c2) ``oc4semi_mcf_qtf``: (c1) under ``potSecOrder: 1``, the
  slender-body QTF plus the Kim & Yue correction of the four MCF columns.

Every run goes on both statics backends (``RAFT_TPU_STATICS=host``, the
port's algorithm, and the default jitted one); the goldens are written
from the host backend: a physics record ``<stem>[_coarse].metrics.json``
(``mhk_cases.case_records``, as ``mhk_golden.py`` writes it) and, where
the two backends' ledgers pass each other's golden check, the host
backend's ledger ``<stem>[_coarse].ledger.json``
(``mcf_cases.LEDGER_STEMS``; the script fails if the backends say
otherwise).  (c1) has none although its backends agree: its
``dyn_solve_residual`` sits at the machine floor on both sides, where the
ledger's 0.5 band decides by rounding, and (c2)'s ledger golden holds the
same first-order build (``mcf_cases.NO_LEDGER``, ROADMAP C3).  The
script prints both backends' ``statics_residual`` and
``dyn_solve_residual`` of every run.

    JAX_PLATFORMS=cpu python tests/golden/mcf_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/mcf_golden.py --write  # rewrite

Without ``--write`` the runs are diffed against the committed files at the
same bars.  Regenerate only after an intentional physics change.
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
sys.path.insert(0, HERE)
from mhk_golden import (BACKENDS, TOL, WIDTHS, ledgers_agree,  # noqa: E402
                        records_agree)

#: run -> golden file stem
STEMS = {"c1": "oc4semi_mcf", "c2": "oc4semi_mcf_qtf"}
#: parallel JAX processes
JOBS = 4


def _design(name, width):
    from raft_tpu_torch.models import mcf_cases as FC

    coarse = width == "coarse"
    return FC.mcf_design(coarse) if name == "c1" \
        else FC.mcf_qtf_design(coarse)


def run_one(name: str, backend: str, width: str, out: str) -> None:
    """One JAX run in this process, its outputs written into ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_JOURNAL"] = "0"       # no case journal to resume
    if backend == "host":
        os.environ["RAFT_TPU_STATICS"] = "host"
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu.model import Model
    from raft_tpu.obs.ledger import write_ledger
    from raft_tpu_torch.models import mhk_cases as MC

    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    m = Model(_design(name, width))
    m.analyzeUnloaded()
    m.analyzeCases()
    write_ledger(m.last_ledger, os.path.join(out, "ledger.json"))
    recs = MC.case_records(m.results, m.last_ledger)
    with open(os.path.join(out, "metrics.json"), "w") as f:
        json.dump(recs, f)
    print(json.dumps({"run": name, "backend": backend, "width": width,
                      "statics_residual": [c["statics_residual"]
                                           for c in recs["cases"]],
                      "dyn_solve_residual": [
                          e["metrics"]["dyn_solve_residual"]
                          for e in m.last_ledger["entries"]
                          if "dyn_solve_residual" in e["metrics"]],
                      "iters": [c["iters"] for c in recs["cases"]],
                      "wall_s": time.perf_counter() - t0}), flush=True)


def _sub(args):
    name, backend, width, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", name, backend, width, out], check=True)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


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
    from raft_tpu_torch.models import mcf_cases as FC
    from raft_tpu_torch.models import mhk_cases as MC

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(n, b, w, os.path.join(tmp, f"{n}_{b}_{w}"))
                for n in STEMS for b in BACKENDS for w in WIDTHS]
        with ThreadPoolExecutor(JOBS) as pool:
            list(pool.map(_sub, jobs))
        out = {(n, b, w): o for n, b, w, o in jobs}

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
                dres = {b: [e["metrics"]["dyn_solve_residual"]
                            for e in led[b]["entries"]
                            if "dyn_solve_residual" in e["metrics"]]
                        for b in BACKENDS}
                print(json.dumps({f"{name}_{w}_dyn_solve_residual": dres}))
                held = MC.held_record(recs["host"], recs["default"], TOL)
                print(json.dumps({f"{name}_{w}_unheld": held["unheld"]}))
                ok = records_agree(held, recs["default"],
                                   f"{name}_{w}_records_host_vs_default") \
                    and ok
                agree = ledgers_agree(led["host"], led["default"],
                                      f"{name}_{w}_ledgers_host_vs_default")
                if agree != (stem in FC.LEDGER_STEMS) \
                        and not (agree and stem in FC.NO_LEDGER):
                    print(f"{name}_{w}: backends' ledgers agree {agree}, "
                          f"but mcf_cases.LEDGER_STEMS says "
                          f"{stem in FC.LEDGER_STEMS}")
                    ok = False
                if stem in FC.LEDGER_STEMS:
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
                                for c in recs["default"]["cases"]],
                            dyn_solve_residual_host=dres["host"],
                            dyn_solve_residual_default=dres["default"]),
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
