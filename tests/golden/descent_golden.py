"""Write or check the batched design-descent goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per group: ``parallel/optimize.make_descent`` (Adam or L-BFGS with the
zoom linesearch, through optax, over the implicit-diff variant pipeline),
stepped by chaining ``descend.segment(carry, 1)`` (bitwise the same scan
as the whole descent), then ``descend.finalize``; and
``optimize_designs`` on the same call.  Each record holds the design,
its frequency grid and water depth, the space's fingerprint, the
canonical objective, the solver knobs, the method, steps, lr, gtol, xtol
and x0; per step and lane, x before and after the step, the value, the
gradient (a separate ``vmap(value_and_grad)`` at that x), the gradient
norm, the masks and the steps counted, and for L-BFGS the linesearch's
``num_linesearch_steps`` and ``learning_rate``; ``finalize``'s output;
``optimize_designs``' result (its ``provenance`` without ``wall_s``, its
``solver`` as the sorted keys of the dispatch record), and the keys of
its run manifest and of the manifest's ``extra["optimize"]``.

- ``cylinder.json`` (the CPU tests): ``Vertical_cylinder`` at 2 bins
  (``serve.soak.build_fowt("Vertical_cylinder", 0.1, 0.9, 0.4)``), std,
  Hs 5, Tp 9.
  - ``adam``: ``tests/test_optimize.py``'s lane-isolation call: space
    {d_scale (0.9, 1.1), moor_L (0.95, 1.05)}, x0 [[1, 1], [nan, 1],
    [0.95, 1.02]], steps 3, lr 0.03, nIter 5, tol 1e-3, adjoint_iters 6,
    newton_iters 6 (the codesign goldens' CPU cut);
  - ``adam_all_nan``: that test's all-NaN batch (2 lanes), steps 2,
    nIter 4, tol 1e-3, adjoint_iters 4, newton_iters 1 (only the typed
    raise is recorded);
  - ``lbfgs``: 2 lanes x0 [[1, 1], [0.95, 1.02]], steps 2, over the
    wider box {d_scale (0.5, 1.5), moor_L (0.8, 1.2)}: with the
    lane-isolation box both lanes sit on its corner after two steps and
    the record would hold only the clip (the first step, of unit norm
    and step size 1 or more, clips both lanes to a corner of this box
    too; the second leaves one inside).  nIter 5, tol 1e-3,
    adjoint_iters 6, newton_iters 3 (the Newton is at its 1e-16 floor
    after 3 on this design): 8 gradients (one a step, one a linesearch
    trial, one final).
- ``volturn80.json`` and ``volturn10.json`` (``chip_smoke.py``'s descent
  phase): ``VolturnUS-S``, std, Hs 6, Tp 12, nIter 10, tol 0.01,
  newton_iters 20 (the codesign ``volturn80`` knobs), space {d_scale
  (0.9, 1.1), moor_L (0.98, 1.02), moor_EA (0.8, 1.2), moor_anchor
  (0.95, 1.05)}.
  - ``volturn80.json`` ``adam``, at the design's own 80 bins
    (0.005-0.40 Hz): the codesign lanes (``DesignSpace.sample(4,
    seed=0)``) and a NaN lane, steps 2, lr 0.02;
  - ``volturn10.json`` ``lbfgs``, at 10 bins (0.02-0.2 Hz): lanes 1 and
    3 of those, 1 step.  Lanes 0 and 2 are set aside: their linesearch
    runs to its 8-step cap, whose final step size then turns on the
    last bits of nearly equal values (lane 0's was 2.8 % apart between
    the two packages on the CPU, its value and gradient 1e-13): a test
    of rounding, not of the port.  At 80 bins the JAX package's L-BFGS
    programs did not compile in one CPU process: after 40 minutes LLVM
    ran out of memory maps (a cut of the frequency grid, listed in
    ``PERF.md`` section 4).

Every gradient component of a finite lane must stand above
``codesign_cases.GRAD_FLOOR`` times its lane's largest at every step
(Adam's first step is -lr g / (|g| + eps): a component at the rounding
floor would move by +-lr in either package); the writer reports any lane
that breaks this (``floor_lanes``) and fails.  No lane was set aside.

Write time, the groups' two processes each on one CPU core, the groups
side by side: ``cylinder_adam`` 7 minutes, ``cylinder_lbfgs`` 14,
``volturn80_adam`` 15, ``volturn10_lbfgs`` 23 (``wall_s`` in the
records).

    JAX_PLATFORMS=cpu python tests/golden/descent_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/descent_golden.py --write  # rewrite
    JAX_PLATFORMS=cpu python tests/golden/descent_golden.py --write volturn80_adam

Without ``--write`` the runs are compared with the committed files at
1e-12 relative (NaN where the file has NaN).  Regenerate only after an
intentional change of the JAX package.
"""
import argparse
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT_DIR = os.path.join(HERE, "descent")
sys.path.insert(0, ROOT)

#: group -> (file, record names)
GROUPS = {"cylinder_adam": ("cylinder", ("adam", "adam_all_nan")),
          "cylinder_lbfgs": ("cylinder", ("lbfgs",)),
          "volturn80_adam": ("volturn80", ("adam",)),
          "volturn10_lbfgs": ("volturn10", ("lbfgs",))}
TOL = 1e-12
GRAD_FLOOR = 1e-6          # models/codesign_cases.GRAD_FLOOR

CYL_OBJECTIVE = {"metric": "std", "Hs": 5.0, "Tp": 9.0}
CYL_BOUNDS = {"d_scale": (0.9, 1.1), "moor_L": (0.95, 1.05)}
CYL_LBFGS_BOUNDS = {"d_scale": (0.5, 1.5), "moor_L": (0.8, 1.2)}
NAN = float("nan")
CYL_CALLS = {
    "adam": dict(bounds=CYL_BOUNDS, method="adam", steps=3, lr=0.03,
                 x0=[[1.0, 1.0], [NAN, 1.0], [0.95, 1.02]],
                 solver={"nIter": 5, "tol": 1e-3, "adjoint_iters": 6,
                         "newton_iters": 6}),
    "adam_all_nan": dict(bounds=CYL_BOUNDS, method="adam", steps=2,
                         lr=0.02, x0=[[NAN, NAN], [NAN, NAN]],
                         solver={"nIter": 4, "tol": 1e-3,
                                 "adjoint_iters": 4, "newton_iters": 1}),
    "lbfgs": dict(bounds=CYL_LBFGS_BOUNDS, method="lbfgs", steps=2,
                  lr=0.02, x0=[[1.0, 1.0], [0.95, 1.02]],
                  solver={"nIter": 5, "tol": 1e-3, "adjoint_iters": 6,
                          "newton_iters": 3}),
}
VOLTURN_BOUNDS = {"d_scale": (0.9, 1.1), "moor_L": (0.98, 1.02),
                  "moor_EA": (0.8, 1.2), "moor_anchor": (0.95, 1.05)}
VOLTURN_SOLVER = {"nIter": 10, "tol": 0.01, "newton_iters": 20}


def _lists(a):
    """JSON-able copy of an array (NaN stays NaN)."""
    a = np.asarray(a)
    if a.dtype == bool:
        return a.tolist()
    if np.issubdtype(a.dtype, np.integer):
        return a.astype(int).tolist()
    return a.astype(float).tolist()


def _floor_lanes(g, fin):
    """Lanes (finite) with a gradient component below GRAD_FLOOR of the
    lane's largest."""
    out = []
    for i in range(g.shape[0]):
        if fin[i] and np.any(np.abs(g[i]) < GRAD_FLOOR
                             * np.max(np.abs(g[i]))):
            out.append(i)
    return out


def _record(base, design, w, depth, call, objective, part):
    """One record's ``part``: ``trace`` (the stepped descent and
    ``finalize``) or ``result`` (``optimize_designs`` and its manifest)."""
    import jax
    import jax.numpy as jnp

    from raft_tpu import errors
    from raft_tpu.parallel import optimize as opt

    space = opt.DesignSpace(base, call["bounds"])
    kw = dict(method=call["method"], steps=call["steps"], lr=call["lr"],
              gtol=1e-4, xtol=0.0)
    X0 = np.asarray(call["x0"], float)
    rec = {"design": design, "w": [float(x) for x in w],
           "depth": float(depth), "space": space.fingerprint(),
           "method": kw["method"], "steps": kw["steps"], "lr": kw["lr"],
           "gtol": kw["gtol"], "xtol": kw["xtol"], "x0": _lists(X0),
           "solver": dict(call["solver"])}
    t0 = time.perf_counter()
    if part == "result":
        if not np.all(np.isnan(X0)):
            rec.update(_result(base, space, objective, X0, kw,
                               call["solver"]))
        rec["wall_s"] = time.perf_counter() - t0
        return rec
    if np.all(np.isnan(X0)):
        try:
            opt.optimize_designs(base, space, objective, x0=X0,
                                 **kw, **call["solver"])
        except errors.NonFiniteResult as e:
            rec["raises"] = {"type": type(e).__name__, "phase": e.phase,
                             "message": str(e),
                             "ctx": {k: v for k, v in e.ctx.items()}}
        rec["objective"] = opt.normalize_objective(objective)
        rec["wall_s"] = time.perf_counter() - t0
        return rec

    descend = opt.make_descent(base, space, objective, **kw,
                               **call["solver"])
    rec["objective"] = descend.objective_spec
    obj = opt.make_design_objective(base, space, objective,
                                    **call["solver"])
    vg = jax.jit(jax.vmap(jax.value_and_grad(obj)))
    seg1 = jax.jit(lambda c: descend.segment(c, 1))
    carry = descend.init_carry(jnp.asarray(X0))
    trace, obj_t, gn_t, floor = [], [], [], set()
    for _ in range(kw["steps"]):
        x = np.asarray(carry[0])
        v, g = (np.asarray(a) for a in vg(jnp.asarray(x)))
        fin = np.isfinite(v) & np.all(np.isfinite(g), axis=-1)
        floor.update(_floor_lanes(g, fin))
        carry, (ot, gt) = seg1(carry)
        step = {"x": _lists(x), "value": _lists(v), "grad": _lists(g),
                "obj_trace": _lists(ot[0]), "gnorm_trace": _lists(gt[0]),
                "x_next": _lists(carry[0]), "done": _lists(carry[2]),
                "bad": _lists(carry[3]), "iters": _lists(carry[4])}
        if kw["method"] == "lbfgs":
            ls = carry[1][2]
            step["ls_steps"] = _lists(ls.info.num_linesearch_steps)
            step["learning_rate"] = _lists(ls.learning_rate)
        trace.append(step)
        obj_t.append(ot[0])
        gn_t.append(gt[0])
    fin_out = jax.jit(descend.finalize)(carry, jnp.stack(obj_t),
                                        jnp.stack(gn_t))
    rec["trace"] = trace
    rec["final"] = {k: _lists(v) for k, v in fin_out.items()}
    rec["floor_lanes"] = sorted(floor)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def _result(base, space, objective, X0, kw, solver) -> dict:
    """``optimize_designs``' result (NumPy arrays as lists, provenance
    without ``wall_s``, its ``solver`` as the dispatch record's keys) and
    its run manifest's keys."""
    from raft_tpu import obs
    from raft_tpu.parallel import optimize as opt

    with tempfile.TemporaryDirectory() as d:
        obs.configure(d)
        try:
            res = opt.optimize_designs(base, space, objective, x0=X0,
                                       **kw, **solver)
        finally:
            obs.configure(None)
        with open(glob.glob(os.path.join(
                d, "optimize_*.manifest.json"))[0]) as f:
            man = json.load(f)
    prov = dict(res["provenance"])
    prov.pop("wall_s")
    prov["solver"] = sorted(prov["solver"])
    out = {k: (_lists(v) if isinstance(v, np.ndarray) else v)
           for k, v in res.items() if k != "provenance"}
    out["provenance"] = prov
    return {"result": out, "manifest_keys": sorted(man),
            "manifest_optimize_keys": sorted(man["extra"]["optimize"]),
            "manifest_config": man["config"]}


def run_group(group: str, part: str, out: str) -> None:
    """One part (``trace`` or ``result``) of a group of JAX runs in this
    process, written to ``out``.  The parts run in two processes: one
    process compiling both L-BFGS programs at 80 bins ran out of memory
    maps in LLVM."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_EXEC_CACHE"] = "0"
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu.io.designs import load_design
    from raft_tpu.models.fowt import build_fowt
    from raft_tpu.parallel import optimize as opt

    t0 = time.perf_counter()
    fname, names = GROUPS[group]
    doc = {}
    if fname == "cylinder":
        d = load_design("Vertical_cylinder")
        depth = float(d["site"]["water_depth"])
        w = np.arange(0.1, 0.9, 0.4) * 2.0 * np.pi
        base = build_fowt(d, w, depth=depth)
        for name in names:
            doc[name] = _record(base, "Vertical_cylinder", w, depth,
                                CYL_CALLS[name], CYL_OBJECTIVE, part)
    else:
        d = load_design("VolturnUS-S")
        depth = float(d["site"]["water_depth"])
        w = (np.arange(0.005, 0.40 + 0.0025, 0.005) if fname == "volturn80"
             else np.arange(0.02, 0.21, 0.02)) * 2.0 * np.pi
        base = build_fowt(d, w, depth=depth)
        X = opt.DesignSpace(base, VOLTURN_BOUNDS).sample(4, seed=0)
        calls = {"adam": dict(bounds=VOLTURN_BOUNDS, method="adam",
                              steps=2, lr=0.02,
                              x0=X.tolist() + [[NAN] * 4],
                              solver=VOLTURN_SOLVER),
                 "lbfgs": dict(bounds=VOLTURN_BOUNDS, method="lbfgs",
                               steps=1, lr=0.02, x0=X[[1, 3]].tolist(),
                               solver=VOLTURN_SOLVER)}
        for name in names:
            doc[name] = _record(base, "VolturnUS-S", w, depth, calls[name],
                                {"metric": "std"}, part)
    doc["wall_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(doc, f)


def _sub(args):
    group, part, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", group, part, out], check=True)


def _merge(a: dict, b: dict) -> dict:
    """One group's trace and result parts as one document."""
    out = {}
    for name in a:
        if name == "wall_s":
            continue
        out[name] = {**a[name], **b[name],
                     "wall_s": a[name]["wall_s"] + b[name]["wall_s"]}
    out["wall_s"] = a["wall_s"] + b["wall_s"]
    return out


def _close(a, b, path=""):
    """Nested equality: strings, ints and bools exactly, floats at TOL
    relative, NaN only against NaN; returns the list of paths that
    differ (``wall_s`` keys are skipped)."""
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
        if math.isnan(fa) or math.isnan(fb):
            return [] if math.isnan(fa) and math.isnan(fb) \
                else [f"{path}: {fa!r} != {fb!r}"]
        return [] if fa == fb or abs(fa - fb) <= TOL * max(abs(fa),
                                                           abs(fb)) \
            else [f"{path}: {fa!r} != {fb!r}"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def _facts(name, rec):
    """One line of what a record shows: linesearch steps, lanes inside
    the box, lanes at the gradient floor."""
    facts = {"wall_s": round(rec["wall_s"], 1)}
    if "trace" in rec:
        facts["floor_lanes"] = rec["floor_lanes"]
        if rec["method"] == "lbfgs":
            facts["ls_steps"] = [s["ls_steps"] for s in rec["trace"]]
        lo, hi = rec["space"]["lower"], rec["space"]["upper"]
        facts["inside_box"] = [
            all(lo[j] < v < hi[j] for j, v in enumerate(x))
            for x in rec["final"]["x"]]
    return {name: facts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--run", nargs=3, metavar=("GROUP", "PART", "OUT"),
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
        groups = args.groups or list(GROUPS)
        jobs = [(g, part, os.path.join(tmp, f"{g}.{part}.json"))
                for g in groups for part in ("trace", "result")]
        with ThreadPoolExecutor(len(jobs)) as pool:
            list(pool.map(_sub, jobs))
        for group in groups:
            parts = []
            for part in ("trace", "result"):
                with open(os.path.join(tmp, f"{group}.{part}.json")) as f:
                    parts.append(json.load(f))
            doc = _merge(*parts)
            print(json.dumps({group: doc.pop("wall_s")}))
            for name, rec in doc.items():
                print("  ", json.dumps(_facts(name, rec)))
                if rec.get("floor_lanes"):
                    print(f"  {group}/{name}: lanes {rec['floor_lanes']} "
                          "have a gradient component at the floor")
                    ok = False
            gold = os.path.join(OUT_DIR, GROUPS[group][0] + ".json")
            old = {}
            if os.path.isfile(gold):
                with open(gold) as f:
                    old = json.load(f)
            if args.write:
                os.makedirs(OUT_DIR, exist_ok=True)
                old.update(doc)
                with open(gold, "w") as f:
                    json.dump(old, f, indent=1)
                    f.write("\n")
                continue
            diffs = [d for name in doc
                     for d in _close(old.get(name), doc[name],
                                     f"{group}/{name}")]
            for d in diffs[:20]:
                print("  DIFFERS", d)
            ok = ok and not diffs
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
