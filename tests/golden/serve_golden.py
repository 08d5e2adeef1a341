"""Write or check the serving golden with the JAX package.

``raft_tpu`` in float64 on the CPU, in one process: the JAX package's
``SweepService`` over its warm ``make_batch_runner`` on ``VolturnUS-S``
at the design's own 80 bins (``raft_tpu_torch/models/serve_cases.py``
holds the requests and the knobs, shared with ``chip_smoke.py``'s serve
phase):

- ``s1``: 24 seeded requests at batch 8, submitted before ``start()``
  (the batches form as 3 x 8), with a journal and a result store: each
  result's std, iters, converged and seq;
- ``warm``: a warm-starting service (``WARM_CONFIG``: every second
  seeded batch audited) over a fresh store, given s1's first batch, 8
  requests near it and 8 on its other side: each result's row and the
  service's warm-start facts.

    JAX_PLATFORMS=cpu python tests/golden/serve_golden.py          # check
    JAX_PLATFORMS=cpu python tests/golden/serve_golden.py --write  # rewrite

Without ``--write`` the run is compared with the committed file (std at
1e-12 relative, everything else exactly).  Regenerate only after an
intentional change of the JAX package.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

TOL = 1e-12
WAIT = 3600.0


def _serve(serve, fowt, cfg, reqs):
    svc = serve.SweepService(fowt, cfg)
    tickets = [svc.submit(float(h), float(t), float(b))
               for h, t, b in zip(*reqs)]
    svc.start()
    results = [t.result(WAIT) for t in tickets]
    summary = svc.stop(timeout=WAIT)
    if not all(r.ok for r in results):
        raise SystemExit(f"a request failed: {[r.error for r in results]}")
    return results, summary


def generate() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from raft_tpu import serve
    from raft_tpu.io.designs import load_design
    from raft_tpu.models.fowt import build_fowt

    from raft_tpu_torch.models import serve_cases as SC

    design = load_design(SC.DESIGN)
    w = SC.grid(design)
    fowt = build_fowt(design, w, depth=float(design["site"]["water_depth"]))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["RAFT_TPU_EXEC_CACHE_DIR"] = os.path.join(tmp, "xc")
        s1, _ = _serve(serve, fowt, serve.ServeConfig(
            batch_cases=SC.BATCH, journal_dir=os.path.join(tmp, "wal"),
            store_dir=os.path.join(tmp, "store")), SC.s1_requests())
        warm, summary = _serve(serve, fowt, serve.ServeConfig(
            store_dir=os.path.join(tmp, "warm"), **SC.WARM_CONFIG),
            SC.warm_requests())
    return {"design": SC.DESIGN, "w": [float(v) for v in w],
            "depth": float(design["site"]["water_depth"]),
            "s1": [SC.row(r) for r in s1],
            "warm": [SC.row(r) for r in warm],
            "warm_facts": {k: summary[k] for k in SC.WARM_FACTS},
            "warm_iter_savings": summary["warm_start_iter_savings"],
            "wall_s": time.perf_counter() - t0}


def compare(live: dict, gold: dict) -> list:
    bad = []
    for part in ("s1", "warm"):
        for i, (a, b) in enumerate(zip(live[part], gold[part])):
            rel = np.max(np.abs(np.subtract(a["std"], b["std"]))
                         / np.abs(b["std"]).clip(1e-300))
            if rel > TOL or {k: a[k] for k in a if k != "std"} != \
                    {k: b[k] for k in b if k != "std"}:
                bad.append(f"{part}[{i}]: std rel {rel:.2e}, {a} vs {b}")
    if live["warm_facts"] != gold["warm_facts"]:
        bad.append(f"warm facts {live['warm_facts']} vs "
                   f"{gold['warm_facts']}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true")
    args = ap.parse_args()
    from raft_tpu_torch.models import serve_cases as SC

    live = generate()
    print(f"serve golden: {len(live['s1'])} + {len(live['warm'])} requests "
          f"in {live['wall_s']:.1f} s; warm facts {live['warm_facts']}, "
          f"iteration savings {live['warm_iter_savings']}")
    if args.write:
        os.makedirs(SC.GOLDEN_DIR, exist_ok=True)
        with open(SC.GOLDEN_FILE, "w") as f:
            json.dump(live, f, indent=1)
        print(f"wrote {SC.GOLDEN_FILE}")
        return 0
    bad = compare(live, SC.load())
    for b in bad:
        print("  " + b)
    print("serve golden: " + ("FAILED" if bad else "matches"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
