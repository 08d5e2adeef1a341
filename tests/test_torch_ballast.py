"""The port's ballast trim, piece by piece, against the JAX package's.

- ``Model._section_fill_volume`` against the JAX function on seeded
  circular and rectangular geometries, empty, part-filled and full:
  bitwise equal;
- ``Model._heave_imbalance`` against the JAX function on VolturnUS-S,
  OC3spar and OC4semi at 1e-12;
- the density trim shared by ``Model.adjustBallastDensity`` and the
  variant sweep (``models.fowt.ballast_density_trim``): the variant
  setup's hydrostatic stiffness and force bitwise equal to those of the
  closed form it replaced, on two variants;
- the trim's host pulls, counted by ``obs.transfers`` and pinned: one
  geometry read, then one imbalance read before the walk and one per
  section visited; one read for a density shift; no host read outside
  ``transfers``;
- the refusals: a density shift with no ballast volume, and a farm.
"""
import contextlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from raft_tpu.model import Model as JModel

from raft_tpu_torch import errors
from raft_tpu_torch.io.designs import design_path
from raft_tpu_torch.model import Model
from raft_tpu_torch.models import ballast_cases as BC
from raft_tpu_torch.models import farm_cases
from raft_tpu_torch.models import mooring as mr
from raft_tpu_torch.models.fowt import (
    ballast_density_trim, build_fowt, fowt_pose, fowt_statics)
from raft_tpu_torch.models.member import member_inertia
from raft_tpu_torch.obs import transfers
from raft_tpu_torch.parallel import variants as vr


def _geometry(shape, seed):
    """A seeded tapered member: 4 stations over 10-60 m, diameters (or
    side pairs) of 4-16 m, walls of 2-8 cm."""
    rng = np.random.default_rng(seed)
    n = 4
    l = float(rng.uniform(10.0, 60.0))
    if shape == "circular":
        d = rng.uniform(4.0, 16.0, n)
    else:
        d = rng.uniform(4.0, 16.0, (n, 2))
    t = rng.uniform(0.02, 0.08, n)
    return SimpleNamespace(circular=shape == "circular", l=l, d=d, t=t)


@pytest.mark.parametrize("fill", ["empty", "mid", "full"])
@pytest.mark.parametrize("shape", ["circular", "rectangular"])
def test_section_fill_volume_bitwise_equals_the_jax_function(shape, fill):
    for seed in range(5):
        geom = _geometry(shape, seed)
        frac = {"empty": 0.0, "mid": 0.37 + 0.1 * seed, "full": 1.0}[fill]
        for j in range(len(geom.t) - 1):
            lf = frac * geom.l
            port = Model._section_fill_volume(geom, j, lf)
            jax = JModel._section_fill_volume(geom, j, lf)
            assert port == jax, (seed, j, port, jax)
            if fill != "empty":
                assert port > 0


@pytest.fixture(scope="module")
def models():
    """Per design key: the JAX model and the port's CPU model on the
    coarse grid, untrimmed."""
    out = {}
    for key in BC.DESIGNS:
        d = BC.design(key, coarse=True)
        out[key] = (JModel(d), Model(d, device="cpu"))
    return out


@pytest.mark.parametrize("key", list(BC.DESIGNS))
def test_heave_imbalance_matches_the_jax_package(models, key):
    jm, tm = models[key]
    js, jh, _ = jm._heave_imbalance(jm.fowtList[0])
    ts, th, stat = tm._heave_imbalance(tm.fowtList[0])
    print(f"{key}: sumFz JAX {js!r} port {ts!r}; heave JAX {jh!r} port "
          f"{th!r}")
    assert abs(ts - js) <= 1e-12 * abs(js)
    assert abs(th - jh) <= 1e-12 * abs(jh)
    assert float(stat["AWP"]) > 0


def _inline_trim(fowt, pose0, ref):
    """The closed form the variant setup held inline before it moved into
    ``ballast_density_trim``, line for line."""
    g, rho = fowt.g, fowt.rho_water
    l_fill = [torch.where(torch.atleast_1d(m.rho_fill) == 0.0, 0.0,
                          torch.atleast_1d(m.l_fill))
              for m in fowt.members]
    stat = fowt_statics(fowt, pose0, l_fill=l_fill)
    Fz_moor = (mr.body_wrench(fowt.mooring, ref)[2]
               if fowt.mooring is not None else 0.0)
    sumFz = (-stat["M_struc"][0, 0] * g + stat["V"] * rho * g + Fz_moor)
    vb = 0.0
    for i, m in enumerate(fowt.members):
        inert = member_inertia(m, pose0["members"][i], rPRP=ref[:3],
                               l_fill=l_fill[i])
        vb = vb + torch.sum(inert["vfill"])
    delta = torch.where(vb > 0.0,
                        sumFz / g / torch.where(vb > 0, vb, 1.0), 0.0)
    rho_fill = [torch.where(lf > 0.0, torch.atleast_1d(m.rho_fill) + delta,
                            torch.atleast_1d(m.rho_fill))
                for m, lf in zip(fowt.members, l_fill)]
    return fowt_statics(fowt, pose0, l_fill=l_fill, rho_fill=rho_fill)


@pytest.mark.parametrize("variant", [0, 31])
def test_variant_density_trim_bitwise_equals_the_inline_closed_form(
        variant):
    with open(design_path("VolturnUS-S")) as f:
        design = yaml.safe_load(f)
    w = np.arange(0.02, 0.21, 0.02) * 2 * np.pi
    base = build_fowt(design, w, depth=600.0, device="cpu")
    th, _ = vr.volturn_grid(design, factors=(0.9, 1.1))
    fowt = vr.variant_fowt(base, {k: torch.as_tensor(np.asarray(v)[variant])
                                  for k, v in th.items()})
    ref = torch.zeros(6, dtype=torch.float64)
    pose0 = fowt_pose(fowt, ref)
    old = _inline_trim(fowt, pose0, ref)
    l_fill, rho_fill, delta, _, vb = ballast_density_trim(fowt, pose0, ref)
    new = fowt_statics(fowt, pose0, l_fill=l_fill, rho_fill=rho_fill)
    assert float(vb) > 0 and float(delta) != 0.0
    for k in ("C_struc", "C_hydro", "W_struc", "W_hydro", "M_struc"):
        assert torch.equal(old[k], new[k]), k
    assert torch.equal(old["C_struc"] + old["C_hydro"],
                       new["C_struc"] + new["C_hydro"])
    assert torch.equal(old["W_struc"] + old["W_hydro"],
                       new["W_struc"] + new["W_hydro"])


@contextlib.contextmanager
def host_reads():
    """Inside: every read of a tensor's values on the host that does not
    go through ``obs.transfers`` (``.item``, ``.tolist``, ``.numpy``,
    ``.cpu``, ``float``, ``int``, ``bool``, ``__array__``) is recorded by
    name; those inside ``transfers.device_get`` are not."""
    seen = []
    inside = threading.local()
    host = transfers._host

    def counted_host(tree, stats):
        inside.on = True
        try:
            return host(tree, stats)
        finally:
            inside.on = False

    saved = {}
    for name in ("item", "tolist", "numpy", "cpu", "__float__", "__int__",
                 "__bool__", "__array__"):
        orig = getattr(torch.Tensor, name)
        saved[name] = orig

        def spy(self, *a, _orig=orig, _name=name, **k):
            if not getattr(inside, "on", False):
                seen.append(_name)
            return _orig(self, *a, **k)
        setattr(torch.Tensor, name, spy)
    transfers._host = counted_host
    try:
        yield seen
    finally:
        transfers._host = host
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)


@pytest.mark.parametrize("tid", ["b1_volturnus_walk", "b1_oc4semi_walk",
                                 "b2_oc4semi_walk", "b1_oc3spar_density"])
def test_trim_pulls_are_counted_and_pinned(tid):
    key, ballast, tol = BC.TRIMS[tid]
    m = Model(BC.design(key, coarse=True), device="cpu")
    fowt = m.fowtList[0]
    transfers.reset()
    with host_reads() as seen:
        if ballast == 1:
            m.adjustBallast(fowt, heave_tol=tol)
        else:
            m.adjustBallastDensity(fowt)
    got = transfers.counts("statics")["events"]
    walk = m.ballast_trim["walk"]
    want = BC.trim_pulls(ballast, len(walk))
    print(f"{tid}: {got} counted pulls ({len(walk)} sections visited), "
          f"reads outside transfers {seen}")
    assert got == want
    assert transfers.snapshot()["total"]["events"] == want
    assert seen == []


def test_density_trim_without_ballast_volume_raises():
    d = BC.design("oc3spar", coarse=True)
    for mem in d["platform"]["members"]:
        mem["l_fill"] = 0.0
    m = Model(d, device="cpu")
    with pytest.raises(errors.ModelConfigError, match="ballast volume"):
        m.analyzeUnloaded(ballast=2)


@pytest.mark.parametrize("ballast", [1, 2])
def test_a_farm_still_refuses_analyze_unloaded(ballast):
    m = Model(farm_cases.f1_design(BC.GRID), device="cpu")
    assert m.nFOWT > 1
    with pytest.raises(errors.ModelConfigError, match="single FOWT"):
        m.analyzeUnloaded(ballast=ballast)
