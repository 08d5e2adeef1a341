"""The ``kill@optimize:step=N`` preemption seam and the successor's
resume.

A child process (``descent_cases.child_command``) runs the checkpointed
descent (``checkpoint_every=1``, 2 lanes, 3 Adam steps on the cylinder
golden's design at cheap knobs) under ``RAFT_TPU_FAULTS=
kill@optimize:step=N``: it exits 137 at the segment boundary whose
cumulative step is N, after step N's checkpoint is durable.  This
process then resumes from that checkpoint (``resumed_from_step == N``)
and lands on the uninterrupted descent's result bit for bit.
"""
import os
import subprocess

import pytest

from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.serve.checkpoint import CheckpointStore

OVERRIDES = dict(x0=DC.load("cylinder")["adam"]["x0"][:2], steps=3,
                 solver={"nIter": 2, "tol": 1e-3, "adjoint_iters": 2,
                         "newton_iters": 1})


@pytest.mark.parametrize("kill_at", [1, 2])
def test_killed_descent_resumes_bitwise(tmp_path, kill_at):
    spec = {"golden": "cylinder", "name": "adam", "overrides": OVERRIDES,
            "device": "cpu", "store": str(tmp_path / "ck"),
            "key": "sha256:kill0001", "every": 1}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RAFT_TPU_FAULTS"] = f"kill@optimize:step={kill_at}"
    child = subprocess.run(DC.child_command(spec), env=env,
                           capture_output=True, text=True, timeout=240)
    assert child.returncode == 137, child.stderr[-2000:]
    assert CheckpointStore(spec["store"]).steps(spec["key"]) == \
        list(range(1, kill_at + 1))
    resumed = DC.run_checkpointed(spec)
    assert resumed["resumed_from_step"] == kill_at
    assert resumed["provenance"]["segments"] == 3 - kill_at
    # the uninterrupted descent, fresh (no checkpoint under its key)
    fresh = DC.run_checkpointed(dict(spec, key="sha256:fresh0001"))
    assert fresh["resumed_from_step"] == 0
    assert DC.bitwise_differs(resumed, fresh) == []
