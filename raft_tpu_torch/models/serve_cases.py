"""The serving cases shared by ``chip_smoke.py``'s serve phase and
``tests/golden/serve_golden.py``.

The served model is ``VolturnUS-S`` on its own 80 bins (0.005-0.40 Hz).
(s1) is 24 seeded requests at the service's default batch of 8,
submitted before the service starts so that the batches form as 3 x 8;
(s4) is a warm-starting service (``WARM_CONFIG``) over a fresh store,
given s1's first 8 requests (batch 0: cold, their fixed-point solutions
become the seeds), 8 requests near them (batch 1: seeded, not audited,
the warm results delivered) and 8 more on the other side (batch 2:
seeded and audited, the cold results delivered and the warm ones held
against them).  The JAX package's answers to both are
``tests/golden/serve/volturn80.json`` (written by the generator on the
CPU); the card holds its own at `GOLDEN_RTOL`.
"""
from __future__ import annotations

import json
import os

import numpy as np

DESIGN = "VolturnUS-S"
SEED = 2026
BATCH = 8
NBATCH = 3
#: the offset of (s4)'s near requests from s1's first batch, (Hs [m],
#: Tp [s], beta [rad]); batch 2 takes the negative
NEAR = (0.05, 0.05, 0.01)
#: the warm-starting service: every second seeded batch audited
WARM_CONFIG = dict(batch_cases=BATCH, warm_start=True, warm_audit_every=2,
                   warm_radius=1.0)
#: the card's results against the JAX package's golden (std); the
#: iteration counts and converged flags are held exactly
GOLDEN_RTOL = 1e-9
GOLDEN_ATOL = 1e-12

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "golden", "serve")
GOLDEN_FILE = os.path.join(GOLDEN_DIR, "volturn80.json")


def grid(design: dict) -> np.ndarray:
    """The design's own frequency grid [rad/s] (``settings.min_freq`` to
    ``max_freq``, as ``Model`` builds it)."""
    s = design.get("settings") or {}
    lo, hi = float(s.get("min_freq", 0.01)), float(s.get("max_freq", 1.0))
    return np.arange(lo, hi + 0.5 * lo, lo) * 2 * np.pi


def s1_requests(n: int = BATCH * NBATCH, seed: int = SEED):
    """(Hs, Tp, beta) of (s1): Hs 1-12 m, Tp 4-18 s, heading 0-2 pi."""
    rng = np.random.default_rng(seed)
    return (1.0 + 11.0 * rng.random(n), 4.0 + 14.0 * rng.random(n),
            2.0 * np.pi * rng.random(n))


def warm_requests():
    """(s4)'s 24 requests in submission order: s1's first batch, then its
    near side (+NEAR), then its far side (-NEAR)."""
    Hs, Tp, beta = (x[:BATCH] for x in s1_requests())
    dH, dT, db = NEAR
    return (np.concatenate([Hs, Hs + dH, Hs - dH]),
            np.concatenate([Tp, Tp + dT, Tp - dT]),
            np.concatenate([beta, beta + db, beta - db]))


def row(result) -> dict:
    """The held facts of one served result."""
    return {"std": [float(v) for v in result.std],
            "iters": int(result.iters), "converged": bool(result.converged),
            "seq": int(result.seq)}


#: the warm-start facts of (s4)'s service summary that are held exactly
WARM_FACTS = ("warm_start_seeded", "warm_start_rejected",
              "warm_start_digest_mismatch", "batches", "completed")


def load() -> dict:
    with open(GOLDEN_FILE) as f:
        return json.load(f)


def deviation(rows, gold_rows) -> tuple[float, list]:
    """(worst relative std deviation, |served - golden| / (|golden| +
    atol / rtol), to hold at `GOLDEN_RTOL`; the indices whose iters,
    converged or seq differ) of served rows against the golden's."""
    worst, differ = 0.0, []
    for i, (r, g) in enumerate(zip(rows, gold_rows)):
        a, b = np.asarray(r["std"], float), np.asarray(g["std"], float)
        scale = np.abs(b) + GOLDEN_ATOL / GOLDEN_RTOL
        worst = max(worst, float(np.max(np.abs(a - b) / scale)))
        if (r["iters"], r["converged"], r["seq"]) != \
                (g["iters"], g["converged"], g["seq"]):
            differ.append(i)
    if len(rows) != len(gold_rows):
        differ.append(-1)
    return worst, differ
