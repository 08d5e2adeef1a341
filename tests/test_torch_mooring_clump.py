"""(m3) OC3spar with each line split at a free 2000 kg clump weight
(``mhk_cases.clump_design``) through the port's Model on the coarse
golden grid against the JAX package's physics record and ledger golden
(``tests/golden/mhk_golden.py``): the free points solved once per statics pose, the
rotation-vector stiffness with the free points eliminated, and the
tension statistics over every segment end; and the refusal of design
variants of such a mooring.
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch.model import Model
from raft_tpu_torch.models import mhk_cases as MC
from raft_tpu_torch.models import mooring as mr

from test_torch_mhk import check_golden


@pytest.fixture(scope="module")
def clump_model():
    m = Model(MC.clump_design(MC.GRID, ncases=1), device="cpu")
    m.analyzeUnloaded()
    m.analyzeCases()
    return m


def test_clump_golden(clump_model):
    m = clump_model
    assert mr._is_general(m.fowtList[0].mooring)
    check_golden(m, "oc3spar_clump")


def test_clump_outputs(clump_model):
    m = clump_model
    cm = m.results["case_metrics"][0][0]
    moor = m.fowtList[0].mooring
    # both ends of all six segments, all tensioned
    assert cm["Tmoor_avg"].shape == (2 * moor.n_lines,) == (12,)
    assert np.all(cm["Tmoor_avg"] > 0) and np.all(np.isfinite(cm["Tmoor_std"]))
    # the clump weights hang below the fairleads and above the seabed
    xf = mr.free_points(moor, torch.as_tensor(m._state[0]["r6"]))
    assert torch.all((xf[:, 2] < -70.0) & (xf[:, 2] > -320.0))


def test_variants_refuse_a_free_point_mooring(clump_model):
    """variant_fowt refuses the mooring keys on a free-point mooring (the
    JAX package has no such variants to hold the port to) and still takes
    member-only variants of such a design; volturn_grid refuses a design
    with a free-point mooring."""
    from raft_tpu_torch.errors import ModelConfigError
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.parallel.variants import variant_fowt, volturn_grid

    fowt = clump_model.fowtList[0]
    moor = fowt.mooring
    for key in ("moor_rFair0", "moor_rAnchor", "moor_L", "moor_EA"):
        with pytest.raises(ModelConfigError, match="ROADMAP A7"):
            variant_fowt(fowt, {key: torch.as_tensor(moor.L)})
    same = variant_fowt(fowt, dict(rA0=torch.stack(
        [torch.as_tensor(m.rA0) for m in fowt.members])))
    assert same.mooring is moor

    split = load_design("VolturnUS-S")
    split["mooring"] = MC.split_lines(split["mooring"], start=(300.0, -150.0))
    with pytest.raises(ModelConfigError, match="ROADMAP A7"):
        volturn_grid(split)
