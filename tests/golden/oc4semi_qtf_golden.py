"""Write or check tests/golden/oc4semi_qtf.ledger.json with the JAX package.

The golden is ``raft_tpu.Model`` in float64 on the CPU at
``examples/example_qtf.py``'s settings without ``outFolderQTF`` (OC4semi,
``potSecOrder: 1``, second-order grid 0.005-0.15 Hz; ``analyzeUnloaded``
then ``analyzeCases``), written with ``obs.ledger.write_ledger``.  The
script runs that model twice, each in a fresh process: once through the
vmapped QTF path and once with the pair grid through the Pallas kernel in
interpret mode (``RAFT_TPU_QTF_KERNEL=1``).  It prints each run's wall
time and the largest relative difference between the two ledgers, and
fails unless they agree at 1e-6 with equal iteration counts (the solver
residuals, which sit at the machine floor, at 0.5 as in the port's golden
tests).

    JAX_PLATFORMS=cpu python tests/golden/oc4semi_qtf_golden.py           # check
    JAX_PLATFORMS=cpu python tests/golden/oc4semi_qtf_golden.py --write   # rewrite

Without ``--write`` it also diffs both runs against the committed file.
Regenerate only after an intentional physics change.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))   # the repo root
GOLDEN = os.path.join(HERE, "oc4semi_qtf.ledger.json")
TOL = 1e-6
RESIDUAL_TOL = 0.5


def run_one(mode: str, out: str) -> None:
    """One JAX run of the example; writes its ledger to ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu import _config
    from raft_tpu.io.designs import load_design
    from raft_tpu.model import Model
    from raft_tpu.obs.ledger import write_ledger

    if mode == "kernel":
        _config.set_qtf_kernel_mode("1")
    design = load_design("OC4semi")
    design["platform"].update(potSecOrder=1, min_freq2nd=0.005,
                              max_freq2nd=0.15)
    t0 = time.perf_counter()
    model = Model(design)
    model.analyzeUnloaded()
    model.analyzeCases()
    wall = time.perf_counter() - t0
    write_ledger(model.last_ledger, out)
    c0 = model.results["case_metrics"][0][0]
    print(json.dumps({"mode": mode, "wall_s": wall,
                      "surge_std": float(c0["surge_std"]),
                      "surge_avg": float(c0["surge_avg"])}), flush=True)


def max_rel(a: dict, b: dict) -> tuple:
    """Largest relative difference between two ledgers over the metrics
    held at 1e-6, and over the solver residuals (held at 0.5: they sit at
    the machine floor, as in the port's golden tests)."""
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


def agree(a: dict, b: dict, label: str) -> bool:
    rel, rel_res = max_rel(a, b)
    same = iters(a) == iters(b)
    print(json.dumps({label: {"max_rel": rel, "max_rel_residuals": rel_res,
                              "iters_equal": same}}))
    return rel <= TOL and rel_res <= RESIDUAL_TOL and same


def iters(doc: dict) -> dict:
    m = {e["key"]: e["metrics"] for e in doc["entries"]}
    return {k: v for key, mets in m.items() for k, v in
            ((f"{key}:{n}", mets[n]) for n in mets if n.endswith("_iters"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed golden from the vmapped run")
    ap.add_argument("--run", nargs=2, metavar=("MODE", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_one(*args.run)
        return 0

    from raft_tpu.obs import ledger

    docs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("vmapped", "kernel"):
            out = os.path.join(tmp, f"{mode}.json")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", mode, out], check=True)
            docs[mode] = ledger.load_ledger(out)
    ok = agree(docs["vmapped"], docs["kernel"], "vmapped_vs_kernel")
    if args.write:
        if ok:
            ledger.write_ledger(docs["vmapped"], GOLDEN)
    else:
        gold = ledger.load_ledger(GOLDEN)
        for mode, doc in docs.items():
            ok = agree(gold, doc, f"golden_vs_{mode}") and ok
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
