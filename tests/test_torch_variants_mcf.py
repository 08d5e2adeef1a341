"""Design variants of an MCF platform (ROADMAP A9's third item), held
against the JAX package's ``sweep_variants``.

(c4) of ``raft_tpu_torch/models/mcf_cases.py``: OC4semi with ``MCF:
True`` on its circular vertical columns, on the coarse golden grid (10
bins), five variants of every member's diameters (0.9-1.1) through the
ballast trim, the Newton equilibrium and the drag fixed point.  The
golden ``tests/golden/variants/oc4semi_mcf_coarse.json`` is the JAX
package's (``tests/golden/variants_mcf_golden.py``).  The port's
``sweep_variants`` on one device and on a 2-shard mesh (the 5 variants
padded to 6) against it at ``mcf_cases.VARIANT_CPU_RTOL`` (1e-10;
``mcf_cases.variant_deviation``: the equilibrium's outputs on the
equilibrium's scale), and the variants' hydro constants carry the 4-D
complex ``Imat`` of the MacCamy-Fuchs members.
"""
import json
import os

import pytest
import torch

from raft_tpu_torch.models import mcf_cases as FC
from raft_tpu_torch.models.fowt import fowt_hydro_constants, fowt_pose
from raft_tpu_torch.parallel import partition
from raft_tpu_torch.parallel.sweep import design_fowt
from raft_tpu_torch.parallel.variants import sweep_variants, variant_fowt

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "variants", "oc4semi_mcf_coarse.json")


@pytest.fixture(scope="module")
def gold():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fowt(gold):
    f = design_fowt(FC.mcf_design(coarse=True), "cpu")
    assert f.nw == gold["nw"] and len(f.members) == gold["nmem"]
    return f


def test_variants_take_the_4d_imat(fowt):
    th = FC.variant_thetas(len(fowt.members), scales=(1.1,))
    v = variant_fowt(fowt, {k: torch.as_tensor(a[0]) for k, a in th.items()})
    hc = fowt_hydro_constants(v, fowt_pose(v, torch.zeros(6,
                                                          dtype=torch.float64)))
    assert hc["Imat"].ndim == 4 and hc["Imat"].is_complex()
    assert hc["Imat"].shape[-1] == fowt.nw


@pytest.mark.parametrize("nshards", [1, 2])
def test_mcf_variants_match_the_jax_package(fowt, gold, nshards):
    th = FC.variant_thetas(len(fowt.members))
    if nshards == 1:
        out = sweep_variants(fowt, th, device="cpu", **FC.VARIANT_KW)
    else:
        mesh = partition.make_mesh((nshards,), ("variants",),
                                   [torch.device("cpu")] * nshards)
        out = sweep_variants(fowt, th, mesh=mesh, **FC.VARIANT_KW)
    assert out["Xi"].shape[0] == len(FC.VARIANT_SCALES)
    dev = FC.variant_deviation(out, gold)
    assert set(dev) == set(gold["out"])
    bad = {k: v for k, v in dev.items() if not v <= FC.VARIANT_CPU_RTOL}
    assert not bad, bad
