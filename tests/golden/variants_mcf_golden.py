"""Write or check the MacCamy-Fuchs design-variant golden with the JAX
package.

(c4) of ``raft_tpu_torch/models/mcf_cases.py``: OC4semi with ``MCF:
True`` on its circular vertical columns (the 4-D complex ``Imat`` of the
MacCamy-Fuchs members), on the coarse golden grid (0.02-0.2 Hz, 10
bins), and ``mcf_cases.VARIANT_SCALES`` design variants of it (every
member's diameters scaled) through the JAX package's ``sweep_variants``
(``mcf_cases.VARIANT_KW``: the ballast trim, nIter 6, newton_iters 8),
float64 on the CPU, in one fresh process.  The golden
``variants/oc4semi_mcf_coarse.json`` holds the knobs and every output:
mass, displacement, GMT, offset, pitch_deg, Xeq, std, Xi (real, imaginary
pairs), iters, converged.

    JAX_PLATFORMS=cpu python tests/golden/variants_mcf_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/variants_mcf_golden.py --write  # rewrite

Without ``--write`` the run is diffed against the committed file (1e-12
relative, counts exact).
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

PATH = os.path.join(HERE, "variants", "oc4semi_mcf_coarse.json")
CHECK_RTOL = 1e-12


def run() -> dict:
    """The JAX package's sweep_variants of (c4), as a JSON-able record."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from raft_tpu.models.fowt import build_fowt
    from raft_tpu.parallel.variants import sweep_variants
    from raft_tpu_torch.models import mcf_cases as FC

    design = FC.mcf_design(coarse=True)
    s = design["settings"]
    w = np.arange(s["min_freq"], s["max_freq"] + 0.5 * s["min_freq"],
                  s["min_freq"]) * 2 * np.pi
    depth = float(design["site"]["water_depth"])
    t0 = time.perf_counter()
    fowt = build_fowt(design, w, depth=depth)
    thetas = FC.variant_thetas(len(fowt.members))
    out = sweep_variants(fowt, thetas, **FC.VARIANT_KW)
    out = {k: np.asarray(v) for k, v in out.items()
           if k in ("mass", "displacement", "GMT", "offset", "pitch_deg",
                    "Xeq", "std", "Xi", "iters", "converged")}
    out["Xi"] = np.stack([out["Xi"].real, out["Xi"].imag], axis=-1)
    return {"design": "mcf_cases.mcf_design(coarse=True)",
            "nw": int(len(w)), "depth": depth,
            "nmem": len(fowt.members),
            "scales": list(FC.VARIANT_SCALES), "kw": FC.VARIANT_KW,
            "imat_ndim": 4,
            "wall_s": time.perf_counter() - t0,
            "out": {k: v.tolist() for k, v in out.items()}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    rec = run()
    print(f"JAX sweep_variants (c4): {rec['wall_s']:.1f} s", flush=True)
    if args.write:
        os.makedirs(os.path.dirname(PATH), exist_ok=True)
        with open(PATH, "w") as f:
            json.dump(rec, f)
        print(f"wrote {PATH}")
        return 0
    import numpy as np

    with open(PATH) as f:
        gold = json.load(f)
    bad = []
    for k, ref in gold["out"].items():
        a, b = np.asarray(rec["out"][k], float), np.asarray(ref, float)
        rel = float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))
        ok = rel <= CHECK_RTOL if k not in ("iters", "converged") \
            else np.array_equal(a, b)
        print(f"  {k}: rel {rel:.2e}{'' if ok else '  OFF'}")
        bad += [] if ok else [k]
    print("ok" if not bad else f"off: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
