"""The partition cases shared by the tests and ``chip_smoke.py``: the
parity of a sharded call against the unsharded one, its bars, and the
worker of the multi-process sweep.

A batched entry point on a mesh (``parallel/partition.py``) must give the
unsharded call's results: its floats within `ATOL` (the JAX package's
partition bar, ``tests/test_partition.py:46``; `VARIANT_RTOL` on top for
the variants, as there), its solver decisions (``iters``, ``converged``,
``fp_chunks``, the padded shapes) and its counted host pulls exactly.
`parity` measures one pair; `failures` lists what breaks the bars.

`dist_worker` is one process of a ``torch.distributed`` run (``gloo`` on
the CPU): it joins the group through ``partition.ensure_distributed``
(``RAFT_TPU_COORDINATOR`` on ``localhost``), sweeps its half of a small
cylinder case table and of a variant batch on a mesh over both
processes, and saves the gathered tables and its pulls for the parent.
"""
from __future__ import annotations

import json
import os

import numpy as np

#: float bar of a sharded output against the unsharded one (absolute)
ATOL = 1e-12
#: relative bar on top of `ATOL` for the variants' outputs
VARIANT_RTOL = 1e-12
#: the outputs compared, by entry point
SWEEP_KEYS = ("Xi", "std")
VARIANT_KEYS = ("std", "Xi", "mass", "Xeq", "GMT")
FARM_KEYS = ("Xi", "std", "U_wake", "Ct_wake", "aero_power")
DESCENT_KEYS = ("x", "objective", "obj_trace", "grad_norm")
#: the solver decisions compared exactly
EXACT_KEYS = ("iters", "converged")


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def parity(out: dict, ref: dict, keys, rtol: float = 0.0) -> dict:
    """A sharded result against the unsharded one: per key of ``keys``
    the worst |a - b| beyond ``rtol * |b|`` (inf on a shape mismatch),
    whether they are bitwise equal, and the exact facts that differ
    (``iters``, ``converged``, ``fp_chunks``, any of ``nonfinite`` /
    ``lane_best`` present)."""
    dev, bitwise, exact = {}, {}, []
    for k in keys:
        a, b = _host(out[k]), _host(ref[k])
        if a.shape != b.shape:
            dev[k] = float("inf")
            bitwise[k] = False
            continue
        excess = np.abs(a - b) - rtol * np.abs(b)
        dev[k] = float(np.nanmax(excess, initial=0.0)) if a.size else 0.0
        bitwise[k] = bool(np.array_equal(a, b, equal_nan=True))
    for k in EXACT_KEYS + ("nonfinite",):
        if k in ref and not np.array_equal(_host(out[k]), _host(ref[k])):
            exact.append(k)
    for k in ("fp_chunks", "lane_best"):
        if k in ref and int(out[k]) != int(ref[k]):
            exact.append(k)
    return {"dev": dev, "bitwise": bitwise, "exact": exact}


def failures(p: dict, atol: float = ATOL) -> list:
    """What of a `parity` record breaks the bars."""
    return [f"{k} {v:.2e} > {atol:g}" for k, v in p["dev"].items()
            if not v <= atol] + [f"{k} differs" for k in p["exact"]]


def cylinder(device="cpu"):
    """The coarse Vertical_cylinder (0.05-0.5 Hz, 10 bins) on ``device``."""
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.parallel.sweep import design_fowt

    design = load_design("Vertical_cylinder")
    design["settings"].update(min_freq=0.05, max_freq=0.5)
    return design_fowt(design, device)


def cases(n: int, seed: int = 11):
    """``n`` seeded sea states (Hs 4-6 m, Tp 8-14 s, whole-degree
    headings), numpy."""
    rng = np.random.default_rng(seed)
    return (4.0 + 2.0 * rng.random(n), 8.0 + 6.0 * rng.random(n),
            np.deg2rad(rng.integers(0, 360, n).astype(float)))


def variant_thetas(nmem: int, nv: int = 5) -> dict:
    """``nv`` diameter scalings (0.9-1.1) of every member (numpy)."""
    s = np.linspace(0.9, 1.1, nv)
    return {"d_scale": np.ones((nv, int(nmem), 2)) * s[:, None, None]}


#: the variant knobs of the small checks (no trim, few iterations)
VARIANT_KW = dict(ballast=False, nIter=3, newton_iters=4)
#: the sweep knobs of the small checks
SWEEP_KW = dict(nIter=4)


def dist_worker(rank: int, world: int, port: int, out_dir: str,
                ncases: int = 8):
    """One process of the ``gloo`` run (``torch.multiprocessing`` calls
    it with its ``rank`` first): join the group, sweep the cylinder's
    ``ncases`` cases and a 5-variant batch on a ``("cases",)`` mesh of
    one CPU shard a process, and save the gathered outputs and the
    counted pulls by ``what`` to ``out_dir/rank<N>.npz``."""
    os.environ.update(RAFT_TPU_COORDINATOR=f"localhost:{port}",
                      RAFT_TPU_NUM_PROCESSES=str(world),
                      RAFT_TPU_PROCESS_ID=str(rank))
    import torch.distributed as dist

    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.parallel import partition
    from raft_tpu_torch.parallel.sweep import sweep_cases
    from raft_tpu_torch.parallel.variants import sweep_variants

    facts = partition.ensure_distributed()
    try:
        fowt = cylinder("cpu")
        mesh = partition.make_mesh((world,), ("cases",), ["cpu"])
        before = DC.pulls_by_what()
        out = sweep_cases(fowt, *cases(ncases), mesh=mesh, **SWEEP_KW)
        pulls = DC.pulls_between(before, DC.pulls_by_what())
        var = sweep_variants(fowt, variant_thetas(len(fowt.members)),
                             mesh=mesh, **VARIANT_KW)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: _host(out[k]) for k in SWEEP_KEYS + EXACT_KEYS},
                 **{f"var_{k}": _host(var[k])
                    for k in VARIANT_KEYS + EXACT_KEYS},
                 fp_chunks=out["fp_chunks"], var_fp_chunks=var["fp_chunks"],
                 pulls=json.dumps(pulls), facts=json.dumps(facts),
                 mesh=json.dumps(partition.mesh_facts(mesh)))
    finally:
        dist.destroy_process_group()
