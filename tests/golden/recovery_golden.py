"""Write or check the fault-tolerance goldens with the JAX package.

Everything here is ``raft_tpu`` in float64 on the CPU
(``RAFT_TPU_STATICS=host``, the port's statics algorithm), one fresh
process per group of runs, each with its own case-journal directory.
The scenarios are those of ``tests/test_recovery.py``, on its coarse
``Vertical_cylinder`` (``NW_SETTINGS``, ``_cyl_design``; a copy of each
lives in ``raft_tpu_torch/models/recovery_cases.py`` so the port runs the
same dicts):

- ``cylinder.json``: the clean three-case run; the run under
  ``nan@dynamics:case=1`` (persistent: the ladder is exhausted and case 1
  is quarantined); ``analyzeCases(resume=True)`` on that run's journal
  (with the number of statics and dynamics solves it made); one case
  under ``raise@kernel:case=0:once`` and the same case clean; one case
  under ``nan@dynamics:case=0:times=2`` (the damped restart recovers) —
  each run's ledger entries, ``failed_cases`` and the attempt sequence
  read from the JAX package's recorder (``Model._recovery_attempts``);
- ``cylinder_mixed.json``: the ``times=2`` run under
  ``RAFT_TPU_PRECISION=mixed``;
- ``sweep.json``: the four-case cylinder sweep of
  ``test_sweep_lane_quarantine_parity`` (nIter 6), clean and under
  ``nan@sweep:lane=2``: ``std``, ``Xi`` (real and imaginary parts),
  ``iters``, ``converged`` and the lane-quarantine info dict;
- ``oc3spar.json``: OC3spar's three shipped cases on the coarse golden
  grid (0.02-0.2 Hz), clean and under ``nan@dynamics:case=1``: the ladder
  sequence, the failure record, the solve counts and both ledgers —
  ``chip_smoke.py`` holds its full-width run of the same cases to the
  sequence, the failure record and the solve counts.

The JAX package's rung names are kept as they are; the port maps them
through ``raft_tpu_torch.recovery.JAX_STEP``.

    JAX_PLATFORMS=cpu python tests/golden/recovery_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/recovery_golden.py --write  # rewrite

Without ``--write`` the runs are compared with the committed files: the
attempt sequences, failure records and census lists exactly, the ledgers
and arrays at 1e-12.  Regenerate only after an intentional change of the
JAX package.
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
OUT_DIR = os.path.join(HERE, "recovery")
sys.path.insert(0, ROOT)

GROUPS = ("cylinder", "cylinder_mixed", "sweep", "oc3spar")
TOL = 1e-12


def _attempts(m):
    return [a.to_dict() for a in m._recovery_attempts]


def _entries(ledger):
    return {e["key"]: e["metrics"] for e in ledger["entries"]}


def _counting(Model):
    """Count solveStatics / solveDynamics calls of every Model."""
    seen = {"statics": 0, "dynamics": 0}
    s0, d0 = Model.solveStatics, Model.solveDynamics

    def statics(self, *a, **k):
        seen["statics"] += 1
        return s0(self, *a, **k)

    def dynamics(self, *a, **k):
        seen["dynamics"] += 1
        return d0(self, *a, **k)

    Model.solveStatics, Model.solveDynamics = statics, dynamics
    return seen


def _record(m, seen=None):
    rec = {"ledger": _entries(m.last_ledger),
           "failed_cases": list(m.failed_cases),
           "attempts": _attempts(m),
           "resumed_cases": list(m._resumed_cases)}
    if seen is not None:
        rec["solves"] = dict(seen)
    return rec


def _model_runs(design_fn, runs):
    """Run ``runs`` ((label, spec, ncases, resume) each) in order on fresh
    Models; the clean three-case run's journal is cleared, as
    tests/test_recovery.py does, so resume reads the faulted run's."""
    from raft_tpu import recovery
    from raft_tpu.model import Model
    from raft_tpu.testing import faults

    seen = _counting(Model)
    out = {}
    for label, spec, ncases, resume in runs:
        faults.install(spec)
        seen.update(statics=0, dynamics=0)
        m = Model(design_fn(ncases))
        try:
            m.analyzeCases(resume=resume)
        finally:
            faults.clear()
        out[label] = _record(m, dict(seen))
        if label == "clean":
            recovery.CaseJournal.for_model(m).clear()
    return out


def _sweep():
    from raft_tpu.models.fowt import build_fowt
    from raft_tpu.parallel import sweep as S
    from raft_tpu.testing import faults
    from raft_tpu_torch.models import recovery_cases as RC

    fowt = build_fowt(*RC.sweep_fowt_args())
    Hs, Tp, beta = RC.sweep_inputs()
    info = {}
    inner = S._quarantine_lanes

    def capture(*a, **k):
        res = inner(*a, **k)
        info["quarantine"] = res[3]
        return res

    S._quarantine_lanes = capture
    out = {}
    for label, spec in (("clean", None), ("faulted", RC.SWEEP_FAULT)):
        info.clear()
        faults.install(spec)
        try:
            o = S.sweep_cases(fowt, Hs, Tp, beta, nIter=RC.SWEEP_NITER)
        finally:
            faults.clear()
        Xi = np.asarray(o["Xi"])
        out[label] = {"std": np.asarray(o["std"]).tolist(),
                      "Xi_re": Xi.real.tolist(), "Xi_im": Xi.imag.tolist(),
                      "iters": np.asarray(o["iters"]).tolist(),
                      "converged": np.asarray(o["converged"]).tolist(),
                      "quarantine": info.get("quarantine")}
    return out


def run_group(group: str, out: str) -> None:
    """One group of JAX runs in this process, written to ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["RAFT_TPU_STATICS"] = "host"
    os.environ["RAFT_TPU_JOURNAL_DIR"] = os.path.join(
        os.path.dirname(out), f"journal_{group}")
    if group == "cylinder_mixed":
        os.environ["RAFT_TPU_PRECISION"] = "mixed"
    import jax

    jax.config.update("jax_enable_x64", True)
    from raft_tpu_torch.models import recovery_cases as RC

    t0 = time.perf_counter()
    if group == "cylinder":
        doc = _model_runs(RC.cyl_design, (
            ("clean", None, 3, False),
            ("faulted", "nan@dynamics:case=1", 3, False),
            ("resumed", None, 3, True),
            ("kernel_once", "raise@kernel:case=0:once", 1, False),
            ("clean1", None, 1, False),
            ("times2", "nan@dynamics:case=0:times=2", 1, False)))
    elif group == "cylinder_mixed":
        doc = _model_runs(RC.cyl_design, (
            ("times2", "nan@dynamics:case=0:times=2", 1, False),))
    elif group == "sweep":
        doc = _sweep()
    else:
        doc = _model_runs(lambda n: RC.oc3spar_design(True, n), (
            ("clean", None, 3, False),
            ("faulted", "nan@dynamics:case=1", 3, False)))
    doc["wall_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(doc, f)


def _sub(args):
    group, out = args
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--run", group, out], check=True)


def _close(a, b, path=""):
    """Nested equality: strings, ints and bools exactly, floats at TOL
    relative (NaN equal to NaN); returns the list of paths that differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in _close(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _close(x, y, f"{path}[{i}]")]
    if isinstance(a, float) or isinstance(b, float):
        try:
            fa, fb = float(a), float(b)
        except (TypeError, ValueError):
            return [f"{path}: {a!r} != {b!r}"]
        if np.isnan(fa) and np.isnan(fb):
            return []
        return [] if abs(fa - fb) <= TOL * max(abs(fa), abs(fb)) \
            else [f"{path}: {fa!r} != {fb!r}"]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite the committed goldens")
    ap.add_argument("--run", nargs=2, metavar=("GROUP", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        run_group(*args.run)
        return 0

    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(g, os.path.join(tmp, f"{g}.json")) for g in GROUPS]
        with ThreadPoolExecutor(len(jobs)) as pool:
            list(pool.map(_sub, jobs))
        for group, path in jobs:
            with open(path) as f:
                doc = json.load(f)
            print(json.dumps({group: {"wall_s": doc.pop("wall_s")}}))
            for label, rec in doc.items():
                if "attempts" in rec:
                    print(json.dumps({f"{group}/{label}": {
                        "failed": [(c["case"], c["phase"], c["error"])
                                   for c in rec["failed_cases"]],
                        "attempts": [(a["phase"], a["case"], a["step_from"],
                                      a["step_to"], a["outcome"], a["error"])
                                     for a in rec["attempts"]],
                        "resumed": rec["resumed_cases"],
                        "solves": rec.get("solves")}}))
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
