"""The port's partition layer (``raft_tpu_torch/parallel/partition.py``)
against the JAX package's, the tests of ``tests/test_partition.py`` that
need no frequency axis:

- the rules cover the port's real batched case state (every leaf gets a
  spec, the frequency stacks the ``FREQ`` placeholder), and each leaf's
  spec is the one the JAX package's rules give the JAX state's leaf of
  the same path;
- an unmatched leaf raises ``PartitionRuleError``; scalars are never
  partitioned;
- ``resolve_spec`` and ``batch_size`` across topologies (as the JAX
  package's, a ``freq`` mesh included: the mesh is only a topology);
- the shard and gather round trip over 2 and 4 CPU shards (complex, bool
  and replicated leaves), the blocks contiguous and in lane order;
- ``pad_batch`` / ``unpad_batch`` (tensors and arrays);
- ``make_mesh``'s facts and errors, ``ambient_mesh``, the rules'
  fingerprint (equal to the JAX package's for every table), the
  ``freq``-axis refusal naming ROADMAP A9, and ``ensure_distributed`` as
  a no-op in one process.
"""
import re

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from raft_tpu.parallel import partition as jpart

from torch.utils import _pytree as pytree

from raft_tpu_torch import errors
from raft_tpu_torch.io.designs import load_design
from raft_tpu_torch.parallel import partition
from raft_tpu_torch.parallel.sweep import design_fowt, make_case_solver

CPU = torch.device("cpu")


def _mesh(shape, axes):
    return partition.make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


@pytest.fixture(scope="module")
def case_state():
    """The port's batched statics->dynamics state of 3 cylinder cases."""
    design = load_design("Vertical_cylinder")
    design["settings"].update(min_freq=0.05, max_freq=0.5)
    fowt = design_fowt(design, "cpu")
    solver = make_case_solver(fowt, nIter=2)
    return solver.setup(torch.tensor([4.0, 5.0, 6.0], dtype=torch.float64),
                        torch.tensor([8.0, 9.0, 10.0], dtype=torch.float64),
                        torch.tensor([0.0, 0.3, 0.6], dtype=torch.float64))


def test_rules_cover_the_real_case_state_pytree(case_state):
    specs = partition.match_partition_rules(partition.STATE_RULES,
                                            case_state)
    flat, _ = pytree.tree_flatten_with_path(specs, is_leaf=lambda s:
                                            isinstance(s, partition.Spec))
    leaves = pytree.tree_leaves(case_state)
    assert len(flat) == len(leaves)
    names = {partition.path_name(p): s for p, s in flat}
    freq = [n for n, s in names.items() if partition.FREQ in s]
    for expected in ("M_lin", "B_BEM", "F_lin", "u0", "drag_pre/s_q",
                     "drag_pre/u_P"):
        assert any(expected in n for n in freq), expected
    # leaf by leaf, the JAX package's rule for the same path
    for (path, spec), leaf in zip(flat, leaves):
        name = partition.path_name(path)
        shape = tuple(leaf.shape)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            assert spec == partition.Spec()
            continue
        want = next(s for r, s in jpart.STATE_RULES if re.search(r, name))
        assert tuple(spec) == tuple(want), name


def test_unmatched_leaf_raises():
    with pytest.raises(errors.PartitionRuleError) as exc:
        partition.match_partition_rules(partition.CASE_INPUT_RULES,
                                        {"rogue": torch.ones((4, 3))})
    assert "rogue" in str(exc.value)
    assert isinstance(exc.value, ValueError)


def test_scalars_are_never_partitioned():
    specs = partition.match_partition_rules(
        (), {"a": torch.tensor(1.0), "b": np.ones((1, 1))})
    assert specs["a"] == partition.Spec() and specs["b"] == partition.Spec()


@pytest.mark.parametrize("shape, axes", [
    ((2, 4), ("cases", "freq")), ((4, 2), ("variants", "cases")),
    ((8,), ("freq",)), ((2,), ("cases",)), ((2, 2), ("turbines", "cases"))])
def test_resolve_spec_across_topologies(shape, axes):
    mesh = _mesh(shape, axes)
    jmesh = jpart.make_mesh(shape, axes)
    for tpl in (partition.XI_SPEC, partition.Spec(partition.BATCH),
                partition.Spec(None, partition.FREQ), partition.Spec()):
        got = partition.resolve_spec(tpl, mesh)
        want = jpart.resolve_spec(P(*tpl), jmesh)
        assert tuple(got) == tuple(want), (tpl, got, want)
    assert partition.batch_size(mesh) == jpart.batch_size(jmesh)
    assert partition.batch_size(None) == 1
    assert partition.mesh_key(mesh) == jpart.mesh_key(jmesh)


@pytest.mark.parametrize("nshards", [2, 4])
def test_shard_and_gather_round_trip(nshards):
    mesh = _mesh((nshards,), ("cases",))
    L = 8
    tree = {"Hs": torch.arange(L, dtype=torch.float64),
            "Xi0": (torch.arange(L * 6 * 3, dtype=torch.float64)
                    .reshape(L, 6, 3) * (1 + 2j)),
            "r6_b": torch.arange(L * 6, dtype=torch.float64).reshape(L, 6),
            "mask": torch.arange(L) % 3 == 0}
    rules = ((r"^(Hs|Xi0|r6_b|mask)$", partition.Spec(partition.BATCH)),)
    parts = partition.shard_tree(tree, mesh, rules)
    assert len(parts) == nshards
    b = L // nshards
    for i, p in enumerate(parts):
        for k in tree:
            assert torch.equal(p[k], tree[k][i * b:(i + 1) * b])
    back = partition.gather_tree(parts, mesh, CPU)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])
    # a replicated leaf goes whole to every shard
    rep = partition.shard_tree(
        {"U_inf": np.arange(3.0), "Hs": np.arange(L, dtype=float)}, mesh,
        partition.FARM_INPUT_RULES)
    assert all(torch.equal(p["U_inf"], torch.arange(3.0, dtype=torch.float64))
               for p in rep)
    assert [p["Hs"].shape[0] for p in rep] == [b] * nshards
    with pytest.raises(errors.PartitionRuleError):
        partition.shard_tree({"Hs": torch.arange(L + 1.0)}, mesh, rules)


def test_pad_and_unpad_batch():
    tree = {"a": torch.arange(13.0), "b": np.ones((13, 3))}
    padded, npad = partition.pad_batch(tree, 13, 8)
    assert npad == 3
    assert tuple(padded["a"].shape) == (16,) and padded["b"].shape == (16, 3)
    # padded lanes repeat the last valid row
    assert torch.equal(padded["a"][13:], torch.full((3,), 12.0))
    restored = partition.unpad_batch(padded, 13)
    assert torch.equal(restored["a"], torch.arange(13.0))
    assert restored["b"].shape == (13, 3)
    same, npad0 = partition.pad_batch(tree, 13, 1)
    assert npad0 == 0 and same is tree
    # the JAX package pads the same way
    jp, jn = jpart.pad_batch({"a": np.arange(13.0)}, 13, 8)
    assert jn == npad and np.array_equal(np.asarray(jp["a"]),
                                         padded["a"].numpy())


def test_make_mesh_and_facts():
    mesh = _mesh((2, 2), ("variants", "cases"))
    facts = partition.mesh_facts(mesh)
    assert facts == {"axes": ["variants", "cases"], "shape": [2, 2],
                     "devices": 4, "topology": "variants=2xcases=2",
                     "processes": 1}
    assert facts == {**jpart.mesh_facts(
        jpart.make_mesh((2, 2), ("variants", "cases"))), "devices": 4}
    assert partition.mesh_facts(None) is None
    assert [d for _, d, _ in partition.shards(mesh)] == [CPU] * 4
    with pytest.raises(errors.PartitionRuleError):
        partition.make_mesh((4, 4), ("cases", "variants"), [CPU] * 8)
    with pytest.raises(errors.PartitionRuleError):
        partition.make_mesh((2, 4), ("cases",), [CPU] * 8)
    if not torch.cuda.is_available():
        # the default devices are the cards: none here
        with pytest.raises(errors.PartitionRuleError):
            partition.make_mesh((1,), ("cases",))


def test_ambient_mesh_env(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_MESH", raising=False)
    assert partition.ambient_mesh(device="cpu") is None
    monkeypatch.setenv("RAFT_TPU_MESH", "variants=2,cases=2")
    mesh = partition.ambient_mesh(device="cpu")
    assert tuple(mesh.axis_names) == ("variants", "cases")
    assert partition.mesh_facts(mesh)["topology"] == "variants=2xcases=2"
    monkeypatch.setenv("RAFT_TPU_MESH", "cases=3")
    assert partition.ambient_mesh(devices=[CPU] * 3).size == 3
    with pytest.raises(errors.PartitionRuleError):
        partition.ambient_mesh(devices=[CPU] * 2)


def test_freq_axis_is_refused():
    mesh = _mesh((2, 2), ("cases", "freq"))
    with pytest.raises(errors.PartitionRuleError) as ei:
        partition.require_batch_only(mesh, "sweep_cases")
    assert "ROADMAP A9" in str(ei.value) and "freq" in str(ei.value)
    with pytest.raises(errors.PartitionRuleError):
        partition.shards(mesh)
    partition.require_batch_only(_mesh((2,), ("cases",)), "sweep_cases")
    partition.require_batch_only(None, "sweep_cases")


def test_ensure_distributed_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_DIST", raising=False)
    monkeypatch.delenv("RAFT_TPU_COORDINATOR", raising=False)
    assert partition.ensure_distributed() == {"process_index": 0,
                                              "process_count": 1}
    assert not torch.distributed.is_initialized()
    # outside a multi-process sharded call a flag is its own agreement
    assert partition.agree(True) and not partition.agree(False)


def test_rules_fingerprint_stability():
    f1 = partition.rules_fingerprint(partition.STATE_RULES)
    assert f1 == partition.rules_fingerprint(partition.STATE_RULES)
    assert f1 != partition.rules_fingerprint(partition.CASE_INPUT_RULES)
    edited = partition.STATE_RULES[:-1] + ((r".*", partition.Spec(None)),)
    assert f1 != partition.rules_fingerprint(edited)
    # the same digest as the JAX package's for the same tables
    for ours, theirs in (
            ((partition.STATE_RULES,), (jpart.STATE_RULES,)),
            ((partition.CASE_INPUT_RULES, partition.STATE_RULES,
              partition.XI_SPEC),
             (jpart.CASE_INPUT_RULES, jpart.STATE_RULES, jpart.XI_SPEC)),
            ((partition.FARM_INPUT_RULES,), (jpart.FARM_INPUT_RULES,)),
            ((partition.VARIANT_INPUT_RULES,), (jpart.VARIANT_INPUT_RULES,))):
        assert partition.rules_fingerprint(*ours) == \
            jpart.rules_fingerprint(*theirs)
