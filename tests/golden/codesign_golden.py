"""Write or check the co-design gradient goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per group: ``parallel/optimize.make_design_objective`` (the implicit-diff
variant pipeline: ``DesignSpace.to_theta`` -> ``make_variant_solver(
implicit_diff=True)`` -> ``solve.implicit`` -> objective), differentiated
by ``jax.jit(jax.vmap(jax.value_and_grad(obj)))`` over the lanes.  Each
record holds the design, its frequency grid and water depth, the space's
fingerprint, the canonical objective spec, the solver knobs and, per
lane, x, the value and the gradient.

- ``cylinder.json``: ``Vertical_cylinder`` at 2 bins (0.1 and 0.5 Hz,
  ``serve.soak.build_fowt("Vertical_cylinder", 0.1, 0.9, 0.4)``), space
  {d_scale (0.9, 1.1), moor_L (0.95, 1.05)}, metrics std, offset and del
  (Hs 5, Tp 9), at x = 1 and one interior point, nIter 40, tol 1e-10,
  newton_iters 6 (the Newton is at its 1e-16 floor after 3);
- ``volturn10.json``: ``VolturnUS-S`` at 10 bins (0.02-0.2 Hz), 4 lanes
  of ``DesignSpace.sample(4, seed=0)`` over {d_scale, moor_L, moor_EA,
  moor_anchor}, metric std (Hs 6, Tp 12), the solver's nIter 10 and tol
  0.01, newton_iters 8 (a cut for the CPU tests: each Newton iteration
  of the port's vmapped setup costs ~1 s on a CPU core); and 1 lane of
  ``sample(1, seed=0)`` over {ballast} (the solver then runs without the
  density trim);
- ``volturn80.json``: the same 4 lanes at the design's own 80 bins
  (0.005-0.40 Hz) and the default newton_iters 20, for ``chip_smoke.py``'s
  codesign phase.

    JAX_PLATFORMS=cpu python tests/golden/codesign_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/codesign_golden.py --write  # rewrite
    JAX_PLATFORMS=cpu python tests/golden/codesign_golden.py --write volturn80

Without ``--write`` the runs are compared with the committed files at
1e-12 relative.  Regenerate only after an intentional change of the JAX
package.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_DIR = os.path.join(HERE, "codesign")
sys.path.insert(0, ROOT)

GROUPS = ("cylinder", "volturn10", "volturn80")
TOL = 1e-12

CYL_BOUNDS = {"d_scale": (0.9, 1.1), "moor_L": (0.95, 1.05)}
CYL_X = [[1.0, 1.0], [1.05, 0.98]]
CYL_SOLVER = {"nIter": 40, "tol": 1e-10, "newton_iters": 6}
VOLTURN_BOUNDS = {"d_scale": (0.9, 1.1), "moor_L": (0.98, 1.02),
                  "moor_EA": (0.8, 1.2), "moor_anchor": (0.95, 1.05)}
BALLAST_BOUNDS = {"ballast": (0.9, 1.1)}
VOLTURN_SOLVER = {"nIter": 10, "tol": 0.01, "newton_iters": 8}
VOLTURN80_SOLVER = {"nIter": 10, "tol": 0.01, "newton_iters": 20}


def _grid(min_freq, max_freq, dfreq=None):
    """The frequency grid [rad/s]: ``np.arange(min, max, dfreq)`` as the
    soak's ``build_fowt`` makes it, or the design's own grid (``dfreq`` None:
    bins of min_freq up to max_freq, as ``Model``)."""
    if dfreq is not None:
        return np.arange(min_freq, max_freq, dfreq) * 2.0 * np.pi
    return np.arange(min_freq, max_freq + 0.5 * min_freq,
                     min_freq) * 2.0 * np.pi


def _record(design, w, depth, bounds, objective, solver, X):
    import jax
    import jax.numpy as jnp

    from raft_tpu.io.designs import load_design
    from raft_tpu.models.fowt import build_fowt
    from raft_tpu.parallel import optimize as opt

    base = build_fowt(load_design(design), w, depth=depth)
    space = opt.DesignSpace(base, bounds)
    obj = opt.make_design_objective(base, space, objective, **solver)
    X = np.asarray(X, float)
    t0 = time.perf_counter()
    v, g = jax.jit(jax.vmap(jax.value_and_grad(obj)))(jnp.asarray(X))
    v, g = np.asarray(v), np.asarray(g)
    wall = time.perf_counter() - t0
    return {"design": design, "w": [float(x) for x in w],
            "depth": float(depth), "space": space.fingerprint(),
            "objective": obj.spec, "solver": dict(solver),
            "lanes": [{"x": X[i].tolist(), "value": float(v[i]),
                       "grad": g[i].tolist()} for i in range(len(X))],
            "wall_s": wall}


def run_group(group: str, out: str) -> None:
    """One group of JAX runs in this process, written to ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu.io.designs import load_design
    from raft_tpu.models.fowt import build_fowt
    from raft_tpu.parallel import optimize as opt

    t0 = time.perf_counter()
    doc = {}
    if group == "cylinder":
        d = load_design("Vertical_cylinder")
        depth = float(d["site"]["water_depth"])
        w = _grid(0.1, 0.9, 0.4)
        for metric in ("std", "offset", "del"):
            doc[metric] = _record("Vertical_cylinder", w, depth, CYL_BOUNDS,
                                  {"metric": metric, "Hs": 5.0, "Tp": 9.0},
                                  CYL_SOLVER, CYL_X)
    else:
        d = load_design("VolturnUS-S")
        depth = float(d["site"]["water_depth"])
        w = _grid(0.02, 0.21, 0.02) if group == "volturn10" \
            else _grid(0.005, 0.40)
        base = build_fowt(d, w, depth=depth)
        X = opt.DesignSpace(base, VOLTURN_BOUNDS).sample(4, seed=0)
        solver = VOLTURN_SOLVER if group == "volturn10" \
            else VOLTURN80_SOLVER
        doc["std"] = _record("VolturnUS-S", w, depth, VOLTURN_BOUNDS,
                             {"metric": "std"}, solver, X)
        if group == "volturn10":
            Xb = opt.DesignSpace(base, BALLAST_BOUNDS).sample(1, seed=0)
            doc["ballast"] = _record("VolturnUS-S", w, depth, BALLAST_BOUNDS,
                                     {"metric": "std"}, VOLTURN_SOLVER, Xb)
    doc["wall_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(doc, f)


def _sub(args):
    group, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", group, out], check=True)


def _close(a, b, path=""):
    """Nested equality: strings, ints and bools exactly, floats at TOL
    relative; returns the list of paths that differ (``wall_s`` keys are
    skipped)."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a if k != "wall_s"
                for d in _close(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _close(x, y, f"{path}[{i}]")]
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        return [] if abs(fa - fb) <= TOL * max(abs(fa), abs(fb)) \
            else [f"{path}: {fa!r} != {fb!r}"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--run", nargs=2, metavar=("GROUP", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("groups", nargs="*", metavar="GROUP",
                    help=f"the groups to run, of {', '.join(GROUPS)} "
                    "(default: all)")
    args = ap.parse_args()
    unknown = set(args.groups) - set(GROUPS)
    if unknown:
        ap.error(f"unknown groups {sorted(unknown)}")
    if args.run:
        run_group(*args.run)
        return 0

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(g, os.path.join(tmp, f"{g}.json"))
                for g in args.groups or GROUPS]
        with ThreadPoolExecutor(len(jobs)) as pool:
            list(pool.map(_sub, jobs))
        for group, path in jobs:
            with open(path) as f:
                doc = json.load(f)
            print(json.dumps({group: {
                "wall_s": doc.pop("wall_s"),
                **{k: r["wall_s"] for k, r in doc.items()}}}))
            gold = os.path.join(OUT_DIR, f"{group}.json")
            if args.write:
                os.makedirs(OUT_DIR, exist_ok=True)
                with open(gold, "w") as f:
                    json.dump(doc, f, indent=1)
                    f.write("\n")
                continue
            with open(gold) as f:
                diffs = _close(json.load(f), doc, group)
            for d in diffs[:20]:
                print("  DIFFERS", d)
            ok = ok and not diffs
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
