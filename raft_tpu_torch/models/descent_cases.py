"""The batched design-descent cases shared by the tests and
``chip_smoke.py``, and the bars they are held to.

The records are the JAX package's, written by
``tests/golden/descent_golden.py`` into ``tests/golden/descent/``:
``cylinder.json`` (``Vertical_cylinder`` at 2 bins: ``adam``, the
lane-isolation call with a NaN lane; ``adam_all_nan``, the typed raise;
``lbfgs``), ``volturn80.json`` (``VolturnUS-S`` at its 80 bins: ``adam``
over 4 lanes and a NaN lane) and ``volturn10.json`` (at 10 bins:
``lbfgs`` over 2 of those lanes).  Each record
names its design, grid, depth, space, objective, solver knobs, method,
steps, lr and x0, and holds per step the iterates, values, gradient
norms, masks and (L-BFGS) linesearch steps and step sizes, ``finalize``'s
output and ``optimize_designs``' result.

`stepped` runs a record's descent through ``make_descent``'s own
``segment``, one step at a time, for the per-step facts; `spans_since`
reads the ``descent_step`` spans of an ``optimize_designs`` run (walls,
gradients, linesearch trials, fixed-point passes); `deviations` holds a
run against its record: x, the objective and its trace relative (the
``value`` bar of ``CPU_BARS`` / ``CARD_BARS``), the gradient norms
relative (``grad``), steps counted, masks, the best lane and the
linesearch steps exactly, NaN where the record has NaN.
"""
from __future__ import annotations

import json
import os

import numpy as np

from raft_tpu_torch.models import codesign_cases

#: tests/golden/descent of the checkout holding this package
GOLDEN_DIR = os.path.join(os.path.dirname(codesign_cases.GOLDEN_DIR),
                          "descent")

#: relative bars: x, objective, obj_trace ("value"); grad_norm,
#: gnorm_trace ("grad"), on the CPU and on the card
CPU_BARS = {"value": 1e-9, "grad": 1e-7}
CARD_BARS = {"value": 1e-8, "grad": 1e-6}


def load(name: str) -> dict:
    """The golden file ``name`` (``cylinder``, ``volturn80``,
    ``volturn10``)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def build(rec: dict, device):
    """(base FOWTModel, DesignSpace) of a record, on ``device``."""
    return codesign_cases.build(rec, device)


def call_kwargs(rec: dict) -> dict:
    """``optimize_designs`` keywords of a record (x0 included)."""
    return dict(objective=rec["objective"],
                x0=np.asarray(rec["x0"], float), method=rec["method"],
                steps=rec["steps"], lr=rec["lr"], gtol=rec["gtol"],
                xtol=rec["xtol"], **rec["solver"])


def stepped(base, space, rec: dict) -> list:
    """The record's descent through ``make_descent``'s own ``segment``,
    one step at a time, and `step_facts` of its steps (one counted
    pull): the per-step view ``optimize_designs``' result does not
    hold."""
    from raft_tpu_torch.parallel import optimize as opt

    kw = call_kwargs(rec)
    x0 = kw.pop("x0")
    d = opt.make_descent(base, space, **kw)
    carry, rows = d.init_carry(x0), []
    for _ in range(int(rec["steps"])):
        carry, (_, gnorm) = d.segment(carry, 1)
        rows.append((carry, gnorm[0]))
    return step_facts(rows, rec["method"])


def step_facts(rows, method: str) -> list:
    """Host copies of (carry, gradient norm) after each step (one counted
    pull): per step x after it, done, bad, iters, the gradient norm and
    (L-BFGS) the linesearch's steps and step size."""
    from raft_tpu_torch.obs import transfers

    rows = [(c[0], c[2], c[3], c[4], g)
            + ((c[1]["num_linesearch_steps"], c[1]["learning_rate"])
               if method == "lbfgs" else ())
            for c, g in rows]
    host = transfers.device_get(rows, what="descent_trace")
    keys = ("x_next", "done", "bad", "iters", "gnorm", "ls_steps",
            "learning_rate")
    return [dict(zip(keys, (np.asarray(a) for a in row))) for row in host]


def spans_since(n0: int) -> tuple:
    """(``descent_step`` span attributes, in order, with their ``wall_s``;
    the totals of those and the ``descent_finalize`` spans) among the
    spans finished after the first ``n0`` (``obs.tracing.spans()``)."""
    from raft_tpu_torch.obs import tracing

    steps, tot = [], {}
    for sp in tracing.spans()[n0:]:
        if sp["name"] not in ("descent_step", "descent_finalize"):
            continue
        a = {k: v for k, v in sp["attrs"].items()
             if k not in ("method", "step")}
        for k, v in a.items():
            tot[k] = tot.get(k, 0) + v
        if sp["name"] == "descent_step":
            steps.append(dict(a, wall_s=sp["dur"]))
    return steps, tot


def expected_trials(rec: dict) -> list:
    """Per step, the linesearch trials the record's L-BFGS took: the most
    linesearch steps of a lane that step did not freeze (a lane done
    before it, or non-finite at it, leaves the search at once)."""
    trials, done = [], None
    for st in rec["trace"]:
        live = ~np.asarray(st["bad"], bool)
        if done is not None:
            live &= ~done
        ls = np.asarray(st["ls_steps"])[live]
        trials.append(int(ls.max()) if ls.size else 0)
        done = np.asarray(st["done"], bool)
    return trials


def _rel(a, b) -> float:
    """max |a - b| / |b| over the finite entries of b (|a - b| where b is
    0); inf where the NaN / inf entries differ."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    fin = np.isfinite(b)
    if not (np.array_equal(a[~fin], b[~fin], equal_nan=True)
            and np.isfinite(a[fin]).all()):
        return float("inf")
    if not fin.any():
        return 0.0
    d = np.abs(a[fin] - b[fin])
    scale = np.where(b[fin] == 0.0, 1.0, np.abs(b[fin]))
    return float(np.max(d / scale))


def deviations(rec: dict, result: dict, facts: list = None) -> dict:
    """A run against its record: the worst relative deviation of each
    held quantity (``value``: x, objective, obj_trace and, per step, x
    and the linesearch step size; ``grad``: grad_norm and, per step, the
    gradient norm), and
    ``exact``: the names of the exact facts that differ (iters,
    converged, nonfinite, lane_best, per step done, bad, iters and
    linesearch steps)."""
    gold = rec["result"]
    value = {"x": _rel(result["x"], gold["x"]),
             "objective": _rel(result["objective"], gold["objective"]),
             "obj_trace": _rel(result["obj_trace"], gold["obj_trace"])}
    grad = {"grad_norm": _rel(result["grad_norm"], gold["grad_norm"])}
    exact = [k for k in ("iters", "converged", "nonfinite")
             if not np.array_equal(np.asarray(result[k]),
                                   np.asarray(gold[k]))]
    if int(result["lane_best"]) != gold["lane_best"]:
        exact.append("lane_best")
    for i, (got, want) in enumerate(zip(facts or [], rec["trace"])):
        value[f"step{i}_x"] = _rel(got["x_next"], want["x_next"])
        grad[f"step{i}_gnorm"] = _rel(got["gnorm"], want["gnorm_trace"])
        for k in ("done", "bad", "iters", "ls_steps"):
            if k in got and not np.array_equal(got[k], np.asarray(want[k])):
                exact.append(f"step{i}_{k}")
        if "learning_rate" in got:
            value[f"step{i}_learning_rate"] = _rel(got["learning_rate"],
                                                   want["learning_rate"])
    if facts is not None and len(facts) != len(rec["trace"]):
        exact.append("steps")
    return {"value": value, "grad": grad, "exact": exact}


def failures(dev: dict, bars: dict) -> list:
    """What of `deviations` breaks ``bars`` (``CPU_BARS`` / ``CARD_BARS``)."""
    out = [f"{k} {v:.2e} > {bars[kind]:g}"
           for kind in ("value", "grad") for k, v in dev[kind].items()
           if not v <= bars[kind]]
    return out + [f"{k} differs" for k in dev["exact"]]


def pulls_by_what() -> dict:
    """{what: count} of the counted host pulls so far (process totals of
    ``raft_tpu_host_transfers_total``, summed over phases); the
    difference of two calls is one run's."""
    from raft_tpu_torch.obs import metrics

    snap = metrics.REGISTRY.snapshot().get(
        "raft_tpu_host_transfers_total") or {}
    out = {}
    for s in snap.get("series", []):
        what = s["labels"]["what"]
        out[what] = out.get(what, 0) + int(s["value"])
    return out


def pulls_between(before: dict, after: dict) -> dict:
    """The nonzero differences of two `pulls_by_what` results."""
    return {k: after[k] - before.get(k, 0) for k in sorted(after)
            if after[k] != before.get(k, 0)}


def expected_pulls(rec: dict, gradients: int, ls_tests: int = 0,
                   chunk: int = 2) -> dict:
    """The counted pulls of one ``optimize_designs`` run of ``rec``'s
    knobs that took ``gradients`` values and gradients and ``ls_tests``
    linesearch loop tests: per gradient, the setup's look at the
    MacCamy-Fuchs flags and one pull per chunk of the forward fixed point
    (ceil(nIter / chunk)) and of the adjoint (ceil(2 nIter / chunk) by
    default); one per linesearch loop test; one summary."""
    n = rec["solver"]["nIter"]
    adj = rec["solver"].get("adjoint_iters") or 2 * n
    out = {"implicit_fp_chunk": gradients * -(-n // chunk),
           "implicit_adjoint_chunk": gradients * -(-adj // chunk),
           "mcf_flags": gradients, "optimize_summary": 1}
    if ls_tests:
        out["lbfgs_linesearch"] = ls_tests
    return out
