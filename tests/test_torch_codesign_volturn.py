"""Co-design gradients of the port on VolturnUS-S at 10 frequency bins,
against the JAX package's golden ``tests/golden/codesign/volturn10.json``
(``tests/golden/codesign_golden.py``).

- 4 lanes of ``DesignSpace.sample(4, seed=0)`` over {d_scale, moor_L,
  moor_EA, moor_anchor}, metric std, with the ballast density trim in the
  setup: values at 1e-9, gradients at 1e-7 per component (the bar of
  ``tests/test_torch_codesign.py``, ``models/codesign_cases.deviation``);
- 1 lane over {ballast}, which runs the solver without the trim (as the
  JAX package does), at the same bars.
"""
import pytest

from raft_tpu_torch.models import codesign_cases as CC
from raft_tpu_torch.parallel import optimize as opt

GOLD = CC.load("volturn10")
VALUE_TOL, GRAD_TOL = 1e-9, 1e-7


@pytest.fixture(scope="module")
def base():
    return CC.build(GOLD["std"], "cpu")[0]


@pytest.mark.parametrize("key", ["std", "ballast"])
def test_golden_values_and_gradients(base, key):
    rec = GOLD[key]
    obj = CC.objective(rec, base, CC.space_of(rec, base))
    v, g, fin = opt.grad_guarded(obj)(CC.lanes_x(rec))
    assert fin.all()
    for i, lane in enumerate(rec["lanes"]):
        v_rel, g_rel = CC.deviation(float(v[i]), g[i].numpy(), lane)
        assert v_rel <= VALUE_TOL and g_rel <= GRAD_TOL, (i, v_rel, g_rel)
