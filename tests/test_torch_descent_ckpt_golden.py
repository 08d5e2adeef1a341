"""The segmented descent against the JAX package's descent goldens, and
L-BFGS resumed from its checkpoint.

- ``cylinder.json``'s Adam record (the lane-isolation call: 3 lanes, one
  of them NaN) and its L-BFGS record (2 lanes, 2 steps, the zoom
  linesearch) run one step a segment (``checkpoint_every=1``) into a
  checkpoint store: held to the records at PR 18's bars
  (``descent_cases.CPU_BARS``: x, objectives and traces 1e-9, gradient
  norms 1e-7, counts and masks exact);
- the L-BFGS descent resumed from its step-1 checkpoint equals the
  uninterrupted one bit for bit: the optimizer's state is in the carry
  whole (its memory, its ``learning_rate`` — the step size the zoom
  linesearch of the next step starts from — and its counters), and is
  loaded back at each leaf's dtype.
"""
import numpy as np
import pytest

from raft_tpu_torch.models import descent_cases as DC
from raft_tpu_torch.parallel import optimize as opt
from raft_tpu_torch.serve.checkpoint import CheckpointStore


def _keeping(store):
    store.delete = lambda key, step=None: None
    return store


@pytest.mark.parametrize("name", ["adam", "lbfgs"])
def test_segmented_descent_holds_the_golden(name, tmp_path):
    rec = DC.load("cylinder")[name]
    base, space = DC.build(rec, "cpu")
    store = _keeping(CheckpointStore(str(tmp_path / "ck")))
    res = opt.optimize_designs(base, space, checkpoint_every=1,
                               ckpt_store=store, ckpt_key="sha256:gold",
                               **DC.call_kwargs(rec))
    assert res["provenance"]["segments"] == rec["steps"]
    assert store.steps("sha256:gold") == list(range(1, rec["steps"]))
    dev = DC.deviations(rec, res)
    assert DC.failures(dev, DC.CPU_BARS) == [], dev
    if name == "lbfgs":
        # the resumed L-BFGS descent: bitwise the uninterrupted one
        again = opt.optimize_designs(base, space, checkpoint_every=1,
                                     ckpt_store=store,
                                     ckpt_key="sha256:gold",
                                     **DC.call_kwargs(rec))
        assert again["resumed_from_step"] == rec["steps"] - 1
        assert DC.bitwise_differs(again, res) == []
        found = store.latest("sha256:gold")
        arrays = found[1]
        for k in ("c/state/learning_rate", "c/state/diff_params_memory",
                  "c/state/weights_memory", "c/state/count",
                  "c/state/num_linesearch_steps"):
            assert k in arrays, k
        assert arrays["c/state/count"].dtype == np.int32
        assert arrays["c/state/num_linesearch_steps"].dtype == np.int64
