"""Write or check the first-order potential-flow goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, on the designs of
``raft_tpu_torch/models/potflow_cases.py`` (plain dicts, so the port runs
the same ones):

- ``oc4semi_bem/``: the WAMIT cache (``Output.1``, ``Output.3``,
  ``cache_key.txt``) of ``solve_bem_fowt`` on OC4semi at the YAML's own
  ``dz_BEM`` 3.0, ``da_BEM`` 2.0 and ``min_freq_BEM`` 0.03 Hz (3762 panels,
  14 frequencies x 12 headings, about 13 minutes on 8 cores);
- ``oc4semi_bem.ledger.json``: (a), OC4semi with ``potModMaster: 2`` on
  that cache, ``analyzeUnloaded`` then ``analyzeCases``;
- ``oc4semi_bem_qtf.metrics.json``: (c), the same plus ``potSecOrder: 1``
  on ``examples/example_qtf.py``'s second-order grid: case 0's mean, std
  and maximum of every DOF, the mean offsets of the statics and the
  statics and drag iteration counts (``potflow_cases.metrics_record``).
  Its ``statics_residual`` lands at the rounding floor of the force sum,
  where the package's own two statics backends disagree by more than the
  ledger's residual band (ROADMAP C7), so (c) is held by this record;
- ``bem_spar_preprocess/``: (e), ``Model.preprocess_BEM`` on the spar of
  ``tests/test_bem_native.py`` at that file's custom-grid settings.

The goldens are written from the host statics backend
(``RAFT_TPU_STATICS=host``), the algorithm of the port's
``Model.solveStatics``.  (a) and (c) also run on the default (jitted)
backend, and the script prints both backends' ``statics_residual`` and
their largest relative difference elsewhere.  Each run is a fresh
process and prints its wall time.  (a) and (c) read a copy of the cache
in a temporary directory, so a run never rewrites it.

    JAX_PLATFORMS=cpu python tests/golden/potflow_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/potflow_golden.py --write  # rewrite

Without ``--write`` the runs are diffed against the committed files:
ledgers at 1e-6 with equal iteration counts (the solver residuals at
0.5), the metrics at 1e-6 with equal counts, the WAMIT files' values at
1e-6 of each array's largest entry with an equal cache key.  The check
re-solves nothing unless ``--resolve`` is given; ``--write`` solves
unless ``--mesh-dir`` names a directory that already holds the solve
under the same key.  Regenerate only after an intentional physics change.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
TOL = 1e-6
RESIDUAL_TOL = 0.5
CACHE = os.path.join(HERE, "oc4semi_bem")
SPAR = os.path.join(HERE, "bem_spar_preprocess")
CACHE_FILES = ("Output.1", "Output.3", "cache_key.txt")
BACKENDS = ("host", "default")


def run_one(name: str, backend: str, out: str) -> None:
    """One JAX run in this process: ``solve`` (the OC4semi cache into
    ``out``), ``a`` or ``c`` on the cache in ``out`` (ledger and record
    written beside it), ``e`` (the spar export into ``out``)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_JOURNAL"] = "0"       # no case journal to resume
    if backend == "host":
        os.environ["RAFT_TPU_STATICS"] = "host"
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu.io.designs import load_design
    from raft_tpu.model import Model
    from raft_tpu.obs.ledger import write_ledger
    from raft_tpu_torch.models import potflow_cases as PC

    t0 = time.perf_counter()
    rec = {"run": name, "backend": backend}
    if name == "e":
        m = Model(PC.spar_design(2))
        t1 = time.perf_counter()
        m.preprocess_BEM(mesh_dir=out, **PC.PREPROCESS)
        rec["preprocess_s"] = time.perf_counter() - t1
    elif name == "solve":
        Model(PC.oc4semi_bem_design(out, load_design("OC4semi")))
    else:
        make = PC.oc4semi_bem_design if name == "a" \
            else PC.oc4semi_bem_qtf_design
        m = Model(make(os.path.join(out, "cache"), load_design("OC4semi")))
        m.analyzeUnloaded()
        m.analyzeCases()
        write_ledger(m.last_ledger, os.path.join(out, "ledger.json"))
        r = PC.metrics_record(m.results, m.last_ledger)
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(r, f, indent=1)
        rec.update(statics_residual=r["statics_residual"], **r["iters"],
                   surge_std=r["metrics"]["surge_std"])
    rec["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)


def _sub(name, backend, out):
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", name, backend, out], check=True)


def max_rel(a: dict, b: dict) -> tuple:
    """Largest relative difference between two ledgers over the metrics
    held at 1e-6, and over the solver residuals (held at 0.5)."""
    from raft_tpu.obs.ledger import _compare_values

    ma = {e["key"]: e["metrics"] for e in a["entries"]}
    mb = {e["key"]: e["metrics"] for e in b["entries"]}
    assert set(ma) == set(mb), (sorted(ma), sorted(mb))
    worst = {False: 0.0, True: 0.0}
    for key in ma:
        assert set(ma[key]) == set(mb[key]), key
        for name in ma[key]:
            rel = _compare_values(ma[key][name], mb[key][name])[0]
            res = "residual" in name
            worst[res] = max(worst[res], rel)
    return worst[False], worst[True]


def iters(doc: dict) -> dict:
    m = {e["key"]: e["metrics"] for e in doc["entries"]}
    return {k: v for key, mets in m.items() for k, v in
            ((f"{key}:{n}", mets[n]) for n in mets if n.endswith("_iters"))}


def ledgers_agree(a: dict, b: dict, label: str) -> bool:
    rel, rel_res = max_rel(a, b)
    same = iters(a) == iters(b)
    print(json.dumps({label: {"max_rel": rel, "max_rel_residuals": rel_res,
                              "iters_equal": same}}))
    return rel <= TOL and rel_res <= RESIDUAL_TOL and same


def records_agree(a: dict, b: dict, label: str) -> bool:
    from raft_tpu_torch.models import potflow_cases as PC

    rel, same = PC.metrics_deviation(a, b)
    print(json.dumps({label: {"max_rel": rel, "iters_equal": same}}))
    return rel <= TOL and same


def wamit_agree(ref_dir: str, live_dir: str, label: str) -> bool:
    """The WAMIT pairs in two directories: equal cache keys, and every
    coefficient array within TOL of its largest entry."""
    from raft_tpu_torch.models import potflow_cases as PC

    worst, same_key = PC.wamit_deviation(ref_dir, live_dir)
    print(json.dumps({label: {"max_rel": worst, "key_equal": same_key}}))
    return worst <= TOL and same_key


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--resolve", action="store_true",
                    help="check mode: solve OC4semi again and check the "
                         "committed cache against it")
    ap.add_argument("--mesh-dir",
                    help="--write: a directory holding (or to receive) the "
                         "OC4semi solve")
    ap.add_argument("--run", nargs=3, metavar=("NAME", "BACKEND", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(*args.run)
        return 0

    from raft_tpu.obs import ledger

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        # the OC4semi cache
        solve_dir = None
        if args.write or args.resolve:
            solve_dir = args.mesh_dir if args.write and args.mesh_dir \
                else os.path.join(tmp, "solve")
            _sub("solve", "host", solve_dir)
            if args.write:
                os.makedirs(CACHE, exist_ok=True)
                for name in CACHE_FILES:
                    shutil.copy(os.path.join(solve_dir, name), CACHE)
            else:
                ok = wamit_agree(CACHE, solve_dir, "cache_vs_solve") and ok

        # (a) and (c) on both statics backends, each on its own copy
        runs = {}
        for name in ("a", "c"):
            for backend in BACKENDS:
                out = os.path.join(tmp, f"{name}_{backend}")
                shutil.copytree(CACHE, os.path.join(out, "cache"))
                _sub(name, backend, out)
                with open(os.path.join(out, "metrics.json")) as f:
                    runs[name, backend] = dict(
                        record=json.load(f),
                        ledger=ledger.load_ledger(
                            os.path.join(out, "ledger.json")))
            res = {b: runs[name, b]["record"]["statics_residual"]
                   for b in BACKENDS}
            print(json.dumps({f"{name}_statics_residual": res}))
            ok = records_agree(runs[name, "host"]["record"],
                               runs[name, "default"]["record"],
                               f"{name}_host_vs_default") and ok

        # (e) the spar export
        spar_dir = os.path.join(tmp, "spar")
        _sub("e", "host", spar_dir)

        gold_a = os.path.join(HERE, "oc4semi_bem.ledger.json")
        gold_c = os.path.join(HERE, "oc4semi_bem_qtf.metrics.json")
        if args.write:
            ledger.write_ledger(runs["a", "host"]["ledger"], gold_a)
            rec = dict(runs["c", "host"]["record"],
                       statics_backend="host",
                       statics_residual_default=runs["c", "default"]
                       ["record"]["statics_residual"])
            with open(gold_c, "w") as f:
                json.dump(rec, f, indent=1)
                f.write("\n")
            os.makedirs(SPAR, exist_ok=True)
            for name in CACHE_FILES:
                shutil.copy(os.path.join(spar_dir, name), SPAR)
        else:
            ok = ledgers_agree(ledger.load_ledger(gold_a),
                               runs["a", "host"]["ledger"],
                               "golden_vs_a") and ok
            with open(gold_c) as f:
                ok = records_agree(json.load(f), runs["c", "host"]["record"],
                                   "golden_vs_c") and ok
            ok = wamit_agree(SPAR, spar_dir, "golden_vs_e") and ok
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
