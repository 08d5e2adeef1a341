"""The segmented, checkpointed and resumable descent
(``optimize_designs(checkpoint_every=...)``), as
``tests/test_checkpoint.py:551-632`` holds the JAX package's.

On the cylinder golden's design and space (``descent_cases``) at cheap
knobs (2 lanes, 3 Adam steps, nIter 2, newton_iters 1):

- segmented (2 steps a segment) against monolithic: bitwise;
- a descent resumed from its persisted checkpoint against the
  uninterrupted one: bitwise, and ``on_checkpoint`` saw every write;
- the corrupt-checkpoint fallback (``corrupt@checkpoint:once``: the
  newest checkpoint is dropped, counted, and the resume falls back one
  segment): bitwise;
- the ENOSPC shed (``enospc@checkpoint``): checkpointing stops, counted,
  the descent finishes bitwise;
- another spec (another ``lr``) under the same key ignores the
  checkpoint (a ``ckpt_resume_rejected`` event) and starts fresh;
- ``ckpt_resume_only`` resumes and writes nothing; the finished
  descent's checkpoints are deleted; one counted pull a checkpointed
  segment (``optimize_checkpoint``).
"""
import pytest

from raft_tpu_torch import obs
from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.parallel import optimize as opt
from raft_tpu_torch.serve.checkpoint import CheckpointStore
from raft_tpu_torch.testing import faults

REC = DC.record("cylinder", "adam", x0=DC.load("cylinder")["adam"]["x0"][:2],
                steps=3, solver={"nIter": 2, "tol": 1e-3,
                                 "adjoint_iters": 2, "newton_iters": 1})


@pytest.fixture(scope="module")
def cyl():
    return DC.build(REC, "cpu")


@pytest.fixture(scope="module")
def mono(cyl):
    return opt.optimize_designs(*cyl, **DC.call_kwargs(REC))


def _keeping(store):
    """``store`` whose ``delete`` keeps the checkpoints (so a finished
    descent's can be resumed, as the JAX test does)."""
    store.delete = lambda key, step=None: None
    return store


def test_segmented_descent_matches_monolithic_bitwise(cyl, mono):
    seg = opt.optimize_designs(*cyl, checkpoint_every=2,
                               **DC.call_kwargs(REC))
    assert DC.bitwise_differs(seg, mono) == []
    prov = seg["provenance"]
    assert (prov["checkpoint_every"], prov["segments"],
            prov["resumed_from_step"], prov["ckpt_writes"]) == (2, 2, 0, 0)
    assert seg["resumed_from_step"] == 0
    assert "resumed_from_step" not in mono


def test_resume_reproduces_the_uninterrupted_run_bitwise(cyl, mono,
                                                         tmp_path):
    store = _keeping(CheckpointStore(str(tmp_path / "ck")))
    key = "sha256:resume0001"
    seen = []
    before = DC.pulls_by_what()
    full = opt.optimize_designs(
        *cyl, checkpoint_every=1, ckpt_store=store, ckpt_key=key,
        on_checkpoint=lambda s, d: seen.append((s, d)),
        **DC.call_kwargs(REC))
    pulls = DC.pulls_between(before, DC.pulls_by_what())
    assert DC.bitwise_differs(full, mono) == []
    assert [s for s, _ in seen] == [1, 2] == store.steps(key)
    assert all(d.startswith("sha256:") for _, d in seen)
    assert full["provenance"]["ckpt_writes"] == 2
    assert pulls["optimize_checkpoint"] == 2
    resumed = opt.optimize_designs(*cyl, checkpoint_every=1,
                                   ckpt_store=store, ckpt_key=key,
                                   **DC.call_kwargs(REC))
    assert resumed["resumed_from_step"] == 2
    assert resumed["provenance"]["segments"] == 1
    assert DC.bitwise_differs(resumed, mono) == []
    # the corrupt newest checkpoint is dropped and counted; the resume
    # falls back one segment and still lands on the same bits
    faults.install("corrupt@checkpoint:once")
    try:
        fallback = opt.optimize_designs(*cyl, checkpoint_every=1,
                                        ckpt_store=store, ckpt_key=key,
                                        **DC.call_kwargs(REC))
    finally:
        faults.clear()
    assert fallback["resumed_from_step"] == 1
    assert store.stats()["corrupt"] == 1
    assert DC.bitwise_differs(fallback, mono) == []
    snap = obs.snapshot()["raft_tpu_checkpoint_resumes_total"]["series"]
    assert sum(s["value"] for s in snap) >= 2


def test_enospc_sheds_checkpointing_and_finishes(cyl, mono, tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    faults.install("enospc@checkpoint")
    try:
        shed = opt.optimize_designs(*cyl, checkpoint_every=1,
                                    ckpt_store=store, ckpt_key="sha256:shed1",
                                    **DC.call_kwargs(REC))
    finally:
        faults.clear()
    prov = shed["provenance"]
    assert prov["ckpt_shed"] is True and prov["ckpt_writes"] == 0
    assert store.stats()["enospc"] == 1
    assert DC.bitwise_differs(shed, mono) == []


def test_another_spec_ignores_the_checkpoint(cyl, tmp_path, monkeypatch):
    store = _keeping(CheckpointStore(str(tmp_path / "ck")))
    key = "sha256:spec0001"
    kw = dict(DC.call_kwargs(REC), steps=2)
    opt.optimize_designs(*cyl, checkpoint_every=1, ckpt_store=store,
                         ckpt_key=key, **kw)
    assert store.steps(key) == [1]
    kinds = []
    monkeypatch.setattr(obs.events, "emit",
                        lambda kind, **f: kinds.append(kind))
    other = opt.optimize_designs(*cyl, checkpoint_every=1, ckpt_store=store,
                                 ckpt_key=key, **dict(kw, lr=kw["lr"] * 2),
                                 ckpt_resume_only=True)
    assert other["resumed_from_step"] == 0
    assert other["provenance"]["ckpt_resume_only"] is True
    assert other["provenance"]["ckpt_writes"] == 0
    assert "ckpt_resume_rejected" in kinds and "ckpt_resume" not in kinds
    # the same spec resumes; resume-only writes nothing more; a finished
    # descent's checkpoints are deleted (the real delete)
    store2 = CheckpointStore(store.dir)
    same = opt.optimize_designs(*cyl, checkpoint_every=1, ckpt_store=store2,
                                ckpt_key=key, ckpt_resume_only=True, **kw)
    assert same["resumed_from_step"] == 1
    assert store2.stats()["writes"] == 0
    assert store2.steps(key) == []
