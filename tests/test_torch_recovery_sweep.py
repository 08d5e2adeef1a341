"""Sweep fault tolerance: lane quarantine in ``sweep_cases`` and the
checkpointed ``sweep_cases_chunked``, on the CPU.

- the four-case cylinder sweep of ``tests/test_recovery.py`` clean and
  under ``nan@sweep:lane=2`` against the JAX package's golden
  (``tests/golden/recovery/sweep.json``): ``Xi`` and ``std`` at 1e-9,
  ``iters`` and ``converged`` exact, the quarantine record (its ladder
  through ``recovery.JAX_STEP``) equal;
- ``quarantine="off"`` leaving NaN, ``RAFT_TPU_RECOVERY=0`` reporting
  the lane unrecovered, ``raise@sweep`` failing the batch;
- ``sweep_cases_chunked``: a first call against one ``sweep_cases`` over
  the table (1e-12: the CPU plain version's batched products round
  differently at other batch sizes; ``chip_smoke.py`` holds the card's
  kernel bitwise), a second a pure read, a deleted tail re-solved, an
  edited row re-solving its chunk alone, a corrupt chunk re-solved, and
  an ENOSPC store shed while the sweep goes on.
"""
import json
import os

import numpy as np
import pytest
import torch

from raft_tpu_torch import _config, errors, recovery
from raft_tpu_torch.models import recovery_cases as RC
from raft_tpu_torch.models.fowt import build_fowt
from raft_tpu_torch.parallel import sweep as S
from raft_tpu_torch.serve.checkpoint import CheckpointStore
from raft_tpu_torch.testing import faults

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "recovery", "sweep.json")
TOL = 1e-9


@pytest.fixture(autouse=True)
def _port_faults():
    faults.clear()
    yield
    faults.clear()
    _config.set_recovery_mode(None)


@pytest.fixture(scope="module")
def fowt():
    d, w, depth = RC.sweep_fowt_args()
    return build_fowt(d, w, depth=depth, device="cpu")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _sweep(fowt, **kw):
    return S.sweep_cases(fowt, *RC.sweep_inputs(), nIter=RC.SWEEP_NITER,
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def sweeps(fowt):
    faults.clear()
    clean = _sweep(fowt)
    faults.install(RC.SWEEP_FAULT)
    try:
        faulted = _sweep(fowt)
    finally:
        faults.clear()
    return {"clean": clean, "faulted": faulted}


def _close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("label", ["clean", "faulted"])
def test_sweep_matches_jax_golden(sweeps, golden, label):
    out, gold = sweeps[label], golden[label]
    Xi = out["Xi"].numpy()
    assert _close(Xi, np.array(gold["Xi_re"]) + 1j * np.array(gold["Xi_im"]))
    assert _close(out["std"].numpy(), gold["std"])
    assert out["iters"].tolist() == gold["iters"]
    assert out["converged"].tolist() == gold["converged"]
    q, gq = out["quarantine"], gold["quarantine"]
    if gq is None:
        assert q is None
        return
    for a in gq["ladder"]:
        a["step_from"] = recovery.JAX_STEP[a["step_from"]]
        a["step_to"] = recovery.JAX_STEP[a["step_to"]]
    assert q == gq


def test_quarantined_lane_spliced_back(sweeps):
    clean, faulted = sweeps["clean"], sweeps["faulted"]
    assert faulted["quarantine"]["recovered"] == [2]
    keep = [0, 1, 3]
    assert torch.equal(faulted["Xi"][keep], clean["Xi"][keep])
    assert _close(faulted["Xi"][2], clean["Xi"][2], 1e-12)
    assert torch.equal(faulted["iters"], clean["iters"])
    assert torch.equal(faulted["converged"], clean["converged"])


def test_quarantine_off_leaves_nan(fowt):
    faults.install("nan@sweep:lane=0")
    out = _sweep(fowt, quarantine="off")
    std = out["std"].numpy()
    assert np.all(np.isnan(std[0])) and np.all(np.isfinite(std[1:]))
    assert out["quarantine"] is None and not bool(out["converged"][0])


def test_recovery_off_reports_the_lane(fowt):
    _config.set_recovery_mode("0")
    faults.install("nan@sweep:lane=1")
    out = _sweep(fowt)
    assert out["quarantine"] == {"lanes": [1], "ladder": [], "recovered": [],
                                 "quarantined": [1]}
    assert np.all(np.isnan(out["std"][1].numpy()))


def test_quarantine_all_and_raise_at_the_seam(fowt, sweeps):
    # every lane converged: "all" finds nothing to re-solve
    assert _sweep(fowt, quarantine="all")["quarantine"] is None
    faults.install("raise@sweep:lane=3")
    with pytest.raises(errors.KernelFailure) as exc:
        _sweep(fowt)
    assert exc.value.injected and exc.value.ctx == {"lane": 3}
    with pytest.raises(errors.ModelConfigError):
        _sweep(fowt, quarantine="sometimes")


# ---------------------------------------------------------------------------
# the checkpointed chunked sweep
# ---------------------------------------------------------------------------

N_CHUNKED = 24
CHUNK = 6


def _table():
    rng = np.random.default_rng(11)
    return (1 + 11 * rng.random(N_CHUNKED), 4 + 14 * rng.random(N_CHUNKED),
            np.deg2rad(360 * rng.random(N_CHUNKED)))


def _chunked(fowt, store, table, **kw):
    return S.sweep_cases_chunked(fowt, *table, store=store, key="sweep:t",
                                 chunk=CHUNK, nIter=RC.SWEEP_NITER,
                                 device="cpu", **kw)


def test_chunked_resume_edit_and_corrupt(fowt, tmp_path):
    table = _table()
    whole = S.sweep_cases(fowt, *table, nIter=RC.SWEEP_NITER, device="cpu")
    store = CheckpointStore(str(tmp_path))
    first, info = _chunked(fowt, store, table)
    assert info == {"chunks": 4, "resumed": [], "solved": [0, 1, 2, 3],
                    "ckpt_shed": False}
    for k in ("Xi", "std"):
        assert _close(first[k], whole[k].numpy(), 1e-12)
    for k in ("iters", "converged"):
        assert np.array_equal(first[k], whole[k].numpy())

    def again(tab=table):
        out, info = _chunked(fowt, store, tab)
        return out, (info["resumed"], info["solved"])

    out, census = again()
    assert census == ([0, 1, 2, 3], [])
    assert all(np.array_equal(out[k], first[k]) for k in first)
    # a kill after two chunks: the tail was never stored
    store.delete("sweep:t", 2)
    store.delete("sweep:t", 3)
    out, census = again()
    assert census == ([0, 1], [2, 3])
    assert all(np.array_equal(out[k], first[k]) for k in first)
    # an edited row re-solves its chunk alone
    edited = tuple(x.copy() for x in table)
    edited[0][3 * CHUNK + 1] += 0.5
    out, census = again(edited)
    assert census == ([0, 1, 2], [3])
    assert not np.array_equal(out["std"][3 * CHUNK + 1],
                              first["std"][3 * CHUNK + 1])
    # a corrupt chunk is deleted and re-solved
    faults.install("corrupt@checkpoint:step=1")
    out, census = again(edited)
    faults.clear()
    assert census == ([0, 2, 3], [1])
    assert store.stats()["corrupt"] == 1
    assert np.array_equal(out["Xi"][CHUNK:2 * CHUNK],
                          first["Xi"][CHUNK:2 * CHUNK])


def test_chunked_sheds_a_full_disk(fowt, tmp_path):
    store = CheckpointStore(str(tmp_path))
    faults.install("enospc@checkpoint:step=1")
    out, info = _chunked(fowt, store, _table())
    assert info["ckpt_shed"] and info["solved"] == [0, 1, 2, 3]
    assert store.steps("sweep:t") == [0]
    assert out["std"].shape == (N_CHUNKED, 6)
    assert np.all(np.isfinite(out["std"]))
    with pytest.raises(errors.ModelConfigError):
        _chunked(fowt, store, _table(), Xi0=np.zeros((N_CHUNKED, 6, 9)))
