"""The co-design gradient cases shared by the tests and ``chip_smoke.py``,
and the bar they are held to.

The records are the JAX package's, written by
``tests/golden/codesign_golden.py`` into ``tests/golden/codesign/``:
``cylinder.json`` (``Vertical_cylinder`` at 2 bins; std, offset, del),
``volturn10.json`` (``VolturnUS-S`` at 10 bins; std over four variables,
and ballast) and ``volturn80.json`` (the four-variable lanes at the
design's own 80 bins).  Each record names its design, frequency grid,
water depth, design space, objective and solver knobs, and holds x, the
value and the gradient of each lane.

`deviation` is the bar: the value relative to the golden's, and each
gradient component relative to max(|g_i|, ``floor`` x max|g|), so a
component that is zero or near it is held by an absolute bar.
"""
from __future__ import annotations

import json
import os

import numpy as np

#: tests/golden/codesign of the checkout holding this package
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "golden", "codesign")

#: the floor of a gradient component's bar, as a share of the largest
GRAD_FLOOR = 1e-6


def load(name: str) -> dict:
    """The golden file ``name`` (``cylinder``, ``volturn10``,
    ``volturn80``)."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def build(rec: dict, device):
    """(base FOWTModel, DesignSpace) of a record, on ``device``."""
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.models.fowt import build_fowt

    base = build_fowt(load_design(rec["design"]), np.asarray(rec["w"]),
                      depth=rec["depth"], device=device)
    return base, space_of(rec, base)


def space_of(rec: dict, base):
    """The record's DesignSpace over ``base``."""
    from raft_tpu_torch.parallel.optimize import DesignSpace

    sp = rec["space"]
    return DesignSpace(base, dict(zip(sp["names"],
                                      zip(sp["lower"], sp["upper"]))))


def objective(rec: dict, base, space):
    """The record's design objective (``make_design_objective`` with its
    objective spec and solver knobs)."""
    from raft_tpu_torch.parallel.optimize import make_design_objective

    return make_design_objective(base, space, rec["objective"],
                                 **rec["solver"])


def lanes_x(rec: dict) -> np.ndarray:
    """(lanes, P) design vectors of a record."""
    return np.asarray([lane["x"] for lane in rec["lanes"]], float)


def deviation(value, grad, lane: dict, floor: float = GRAD_FLOOR):
    """(value's relative deviation, the largest gradient component's
    deviation over its bar's scale) of one lane against its golden."""
    g = np.asarray(lane["grad"], float)
    scale = np.maximum(np.abs(g), floor * np.max(np.abs(g)))
    v_rel = abs(float(value) - lane["value"]) / abs(lane["value"])
    return v_rel, float(np.max(np.abs(np.asarray(grad, float) - g) / scale))
