"""Write or check the farm goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU, one fresh process
per run, on the designs of ``raft_tpu_torch/models/farm_cases.py`` (plain
dicts, so the port runs the same ones), each at two widths: the farm
file's own grid 0.001-0.1 Hz, 100 bins (``full``; ``chip_smoke.py`` holds
the port to these) and the coarse grid 0.005-0.1 Hz, 20 bins (``coarse``;
the CPU tests).  Every file is written under ``tests/golden/farm/``.

- (f1) ``f1[_coarse].{metrics,ledger}.json``: ``VolturnUS-S_farm.yaml``
  on its own four-turbine layout with individual moorings, its shipped
  case, ``Model`` -> ``analyzeCases`` (the JAX package, as the reference,
  runs no ``analyzeUnloaded`` and no ``calcOutputs`` for a farm);
  ``f1[_coarse].ladder.json``: the JAX package's mixed ladder around LU
  (``raft_tpu/ops/linalg.py:_mixed_ladder``, refine 2, tolerance 1e-9)
  on that run's (nw, 24, 24) system — the inverse, 48 real rows and 24
  right-hand sides — with its f32 and bf16 low rungs: the promoted
  counts and the relative deviation from the f64 inverse.
- (f2) ``f2[_coarse].{metrics,ledger}.json``: the shipped two-turbine
  rows on the stand-in shared mooring ``farm/shared_mooring_standin.dat``;
  ``f2[_coarse].array.json``: the free points and the coupled stiffness
  ``_K_array`` after the case's statics; ``f2[_coarse].sweep.json``:
  ``Model.sweep_farm`` on eight seeded cases (``farm_cases.f3_cases(8,
  seed=1)``) after the case.
- (f3) ``f3.json``: the power/thrust curve of (f1)'s first FOWT
  (``models/wake.py:power_thrust_curve``) and ``wake_equilibria_jnp`` on
  the 256 seeded cases of ``farm_cases.f3_cases`` over ``F3_LAYOUT``.

Every model runs on both statics backends (``RAFT_TPU_STATICS=host``, the
port's algorithm, and the default jitted one); the goldens are written
from the host backend.  Each farm has a physics record
(``farm_cases.farm_records``; a channel on which the two backends differ
by more than 1e-6 is left out and listed under ``unheld``, with the
default backend's ``statics_residual`` beside the host one's).  Where the
two backends' ledgers pass each other's golden check (metrics at 1e-6,
residuals in the 0.5 band, iteration counts equal) the host backend's
ledger is committed as well (the script prints the verdict; a floor
``statics_residual`` makes it fail, ROADMAP C7).

    JAX_PLATFORMS=cpu python tests/golden/farm_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/farm_golden.py --write  # rewrite

Without ``--write`` the runs are diffed against the committed files at the
same bars (the array record, the sweep and the wake outputs at 1e-9).
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
sys.path.insert(0, HERE)
OUT = os.path.join(HERE, "farm")
TOL = 1e-6
RECORD_TOL = 1e-9
BACKENDS = ("host", "default")
WIDTHS = ("full", "coarse")
#: parallel JAX processes
JOBS = 4


def _suffix(width):
    return "" if width == "full" else "_coarse"


def _design(name, width):
    from raft_tpu_torch.models import farm_cases as FC

    grid = FC.GRID if width == "coarse" else None
    return FC.f1_design(grid) if name == "f1" else FC.f2_design(grid)


def ladder_record(model) -> dict:
    """The JAX package's mixed ladder around LU on a finished farm run's
    system impedance (the inverse, as ``inv_complex`` solves it)."""
    import numpy as np
    import jax.numpy as jnp
    from raft_tpu.ops import linalg as JL

    N, nw = model.nFOWT, model.nw
    Z = np.zeros((nw, 6 * N, 6 * N), complex)
    for i, st in enumerate(model._state):
        Z[:, 6 * i:6 * i + 6, 6 * i:6 * i + 6] = np.moveaxis(
            np.asarray(st["Z"]), -1, 0)
    if model._K_array is not None:
        Z = Z + np.asarray(model._K_array)[None]
    n = 6 * N
    M = np.block([[Z.real, -Z.imag], [Z.imag, Z.real]])
    rhs = np.concatenate([np.broadcast_to(np.eye(n), Z.shape),
                          np.zeros(Z.shape)], axis=-2)       # (nw, 2n, n)
    x64 = np.linalg.solve(M, rhs)
    out = {"lanes": nw, "n2": 2 * n, "tol": 1e-9}
    for width, fd in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        low = (jnp.linalg.solve if width == "f32"
               else (lambda a, r: JL._gj_core(a, r, 2 * n, n)))
        x, st = JL._mixed_ladder(jnp.asarray(M), jnp.asarray(rhs), low,
                                 jnp.linalg.solve, refine=2,
                                 factor_dtype=fd, tol=1e-9)
        out[width] = {"promoted": int(st["promoted"]),
                      "resid_max": float(st["resid_max"]),
                      "rel_to_f64": float(np.max(np.abs(np.asarray(x) - x64))
                                          / np.max(np.abs(x64)))}
    return out


def run_one(name: str, backend: str, width: str, out: str) -> None:
    """One JAX run in this process, its outputs written into ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_JOURNAL"] = "0"       # no case journal to resume
    if backend == "host":
        os.environ["RAFT_TPU_STATICS"] = "host"
    import warnings

    import numpy as np
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu.model import Model
    from raft_tpu.obs.ledger import write_ledger
    from raft_tpu_torch.models import farm_cases as FC

    warnings.simplefilter("ignore")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    rec = {"run": name, "backend": backend, "width": width}

    def dump(fname, obj):
        with open(os.path.join(out, fname), "w") as f:
            json.dump(obj, f)

    if name == "f3":
        import jax.numpy as jnp
        from raft_tpu.models import wake as JW

        m = Model(FC.f1_design())
        curve = JW.power_thrust_curve(m, ifowt=0)
        c = FC.f3_cases()
        D = 2.0 * m.fowtList[0].rotors[0].R_rot
        eq = JW.wake_equilibria_jnp(
            jnp.asarray(FC.F3_LAYOUT), jnp.full(len(FC.F3_LAYOUT), D),
            jnp.asarray(curve["wind_speed"]), jnp.asarray(curve["Ct"]),
            jnp.asarray(curve["power"]), jnp.asarray(c["U_inf"]),
            jnp.asarray(c["wind_dir"]))
        dump("f3.json", dict(
            curve={k: np.asarray(v).tolist() for k, v in curve.items()},
            D=float(D),
            wake={k: np.asarray(v).tolist() for k, v in eq.items()}))
    else:
        m = Model(_design(name, width))
        m.analyzeCases()
        write_ledger(m.last_ledger, os.path.join(out, "ledger.json"))
        recs = FC.farm_records(m.results, m.last_ledger)
        dump("metrics.json", recs)
        rec.update(statics_residual=[r["statics_residual"]
                                     for r in recs["cases"]],
                   iters=[r["iters"] for r in recs["cases"]])
        if name == "f1":
            dump("ladder.json", ladder_record(m))
        else:
            dump("array.json", dict(xf=np.asarray(m._arr_xf).tolist(),
                                    K_array=np.asarray(m._K_array).tolist()))
            c = FC.f3_cases(8, seed=1)
            dump("sweep.json", FC.sweep_record(m.sweep_farm(cases=c)))
    rec["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)


def _sub(args):
    name, backend, width, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", name, backend, width, out], check=True)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def _write_json(path, obj, indent=None):
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)
        f.write("\n")


def _close(a, b, label, tol=RECORD_TOL) -> bool:
    """Two nested records of numbers: every leaf within ``tol`` of its
    array's largest entry, integers and flags equal."""
    from raft_tpu_torch.models import mhk_cases as MC

    rel, bad = MC.record_deviation(a, b)
    print(json.dumps({label: {"max_rel": rel, "differing": bad}}))
    return rel <= tol and not bad


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

    from mhk_golden import ledgers_agree, records_agree
    from raft_tpu.obs import ledger
    from raft_tpu_torch.models import mhk_cases as MC

    ok = True
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(n, b, w, os.path.join(tmp, f"{n}_{b}_{w}"))
                for n in ("f1", "f2") for b in BACKENDS for w in WIDTHS]
        jobs.append(("f3", "host", "full", os.path.join(tmp, "f3")))
        with ThreadPoolExecutor(JOBS) as pool:
            list(pool.map(_sub, jobs))
        out = {(n, b, w): o for n, b, w, o in jobs}

        live = _load_json(os.path.join(out["f3", "host", "full"], "f3.json"))
        gold = os.path.join(OUT, "f3.json")
        if args.write:
            _write_json(gold, live)
        else:
            ok = _close(_load_json(gold), live, "f3_golden") and ok

        for name in ("f1", "f2"):
            for w in WIDTHS:
                stem = os.path.join(OUT, f"{name}{_suffix(w)}")
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
                agree = ledgers_agree(led["host"], led["default"],
                                      f"{name}_{w}_ledgers_host_vs_default")
                if args.write:
                    if agree:
                        ledger.write_ledger(led["host"], stem + ".ledger.json")
                    elif os.path.exists(stem + ".ledger.json"):
                        os.remove(stem + ".ledger.json")
                    _write_json(stem + ".metrics.json", dict(
                        held, statics_backend="host",
                        ledger_golden=bool(agree),
                        statics_residual_default=[
                            c["statics_residual"]
                            for c in recs["default"]["cases"]]), indent=1)
                else:
                    gm = _load_json(stem + ".metrics.json")
                    if gm["ledger_golden"] != agree:
                        print(f"{name}_{w}: backends' ledgers agree "
                              f"{agree}, the golden says "
                              f"{gm['ledger_golden']}")
                        ok = False
                    if agree:
                        ok = ledgers_agree(
                            ledger.load_ledger(stem + ".ledger.json"),
                            led["host"], f"{name}_{w}_ledger_golden") and ok
                    ok = gm["unheld"].keys() == held["unheld"].keys() \
                        and records_agree(gm, recs["host"],
                                          f"{name}_{w}_golden") and ok
                extras = ("ladder",) if name == "f1" else ("array", "sweep")
                for x in extras:
                    vals = {b: _load_json(os.path.join(out[name, b, w],
                                                       f"{x}.json"))
                            for b in BACKENDS}
                    if x != "ladder":
                        ok = _close(vals["host"], vals["default"],
                                    f"{name}_{w}_{x}_host_vs_default",
                                    TOL) and ok
                    else:
                        print(json.dumps({f"{name}_{w}_ladder": vals}))
                    if args.write:
                        _write_json(f"{stem}.{x}.json", vals["host"],
                                    indent=1 if x == "ladder" else None)
                    else:
                        ok = _close(_load_json(f"{stem}.{x}.json"),
                                    vals["host"], f"{name}_{w}_{x}_golden") \
                            and ok
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
