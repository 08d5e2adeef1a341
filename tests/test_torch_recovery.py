"""The port's fault-tolerance layer, unit by unit, against the JAX package.

- the fault grammar (``testing/faults.py``) parses a table of specs as
  the JAX package's does, and fires, matches and spends its budgets the
  same way;
- the error taxonomy: `RECOVERABLE` names the JAX package's types, and a
  `KernelFailure` is recoverable only when injected;
- `run_ladder` walks and records, re-raises on exhaustion, runs bare when
  recovery is off, and lets a non-injected `KernelFailure` through at
  once; the JAX package's rung names map onto the port's;
- the case journal round trip, its corrupt entries deleted and counted,
  its retention, its key (an edited shared mooring misses);
  `CheckpointStore` round trip, corruption, EIO, ENOSPC (injected, and
  from the file system, the only write failure that raises);
  `model_digest`;
- a non-injected `KernelFailure` (the kernel wrapper made to raise one)
  propagates out of ``Model.analyzeCases`` and ``sweep_cases`` with no
  attempt recorded and nothing quarantined.
"""
import errno
import os
import pickle

import numpy as np
import pytest
import torch

from raft_tpu import _config as j_config
from raft_tpu import errors as j_errors
from raft_tpu import recovery as j_recovery
from raft_tpu.testing import faults as j_faults
from raft_tpu_torch import _config, errors, recovery
from raft_tpu_torch.models import recovery_cases as RC
from raft_tpu_torch.obs import journalio
from raft_tpu_torch.ops import linalg
from raft_tpu_torch.parallel.exec_cache import model_digest
from raft_tpu_torch.serve.checkpoint import CheckpointStore
from raft_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _port_faults():
    """The port's fault registry and recovery override, cleared around
    every test (tests/conftest.py clears the JAX package's only)."""
    faults.clear()
    _config.set_recovery_mode(None)
    yield
    faults.clear()
    _config.set_recovery_mode(None)


SPECS = [
    "nan@dynamics:case=2,raise@statics:case=0:once,corrupt@exec_cache,"
    "raise@kernel:times=3,bogus@nowhere,garbage",
    "nan@dynamics:times=2x",
    "raise@exec_cache",
    "nan@kernel",
    "nan@sweep:lane=0,nan@sweep:lane=512,nan@sweep:lane=1023",
    "raise@sweep",
    "corrupt@checkpoint:step=1,enospc@checkpoint,eio@checkpoint:entry=ab12",
    "enospc@statics,eio@journal,torn@journal,kill@serve:req=3",
    "hang@serve:req=1:ms=400,lag@replica:s=2.5,drop@replica:part=1",
    "stale@resultstore:entry=ff,kill@optimize:step=4,hang@optimize:s=3",
    "kill@fleet:replica=1,raise@fleet,raise@checkpoint",
    " NAN@Dynamics : case=1 : once ,raise@dynamics:fowt=1:case=a",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_matches_jax(spec):
    assert faults.parse(spec) == j_faults.parse(spec)


def test_fault_fire_matching_and_exhaustion():
    faults.install("raise@statics:case=0:once,nan@dynamics:case=2")
    assert faults.fire("statics", case=1) is None
    assert faults.fire("dynamics", case=2) == "nan"
    assert faults.fire("dynamics", case=2) == "nan"      # unlimited
    with pytest.raises(errors.StaticsDivergence) as exc:
        faults.maybe_raise("statics", case=0)
    assert exc.value.injected and errors.recoverable(exc.value)
    assert faults.fire("statics", case=0) is None        # once: spent
    faults.install("raise@kernel:case=5:times=2")
    with faults.context(case=5):
        for _ in range(2):
            with pytest.raises(errors.KernelFailure) as exc:
                faults.maybe_raise("kernel")
            assert exc.value.injected and exc.value.ctx == {"case": 5}
        assert faults.fire("kernel") is None             # times=2: spent
    assert faults.fire("kernel", case=4) is None
    # a seam that implements one action spends no other spec's budget
    faults.install("corrupt@checkpoint:once,eio@checkpoint:once")
    assert faults.fire_info("checkpoint", action="eio")["action"] == "eio"
    assert faults.fire_info("checkpoint", action="eio") is None
    assert faults.fire("checkpoint") == "corrupt"


def test_faults_read_the_environment(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULTS", "nan@sweep:lane=3")
    assert faults.any_active()
    assert faults.fire("sweep", lane=3) == "nan"
    faults.install("")
    assert not faults.any_active()       # the programmatic override wins
    faults.clear()
    assert faults.fire("sweep", lane=3) == "nan"


def test_corrupt_bytes_deterministic():
    data = b"x" * 64
    faults.install("corrupt@exec_cache")
    c1 = faults.corrupt_bytes("exec_cache", data)
    j_faults.install("corrupt@exec_cache")
    try:
        assert c1 == j_faults.corrupt_bytes("exec_cache", data) != data
    finally:
        j_faults.clear()
    faults.install("corrupt@exec_cache")
    assert faults.corrupt_bytes("exec_cache", data) == c1
    faults.clear()
    assert faults.corrupt_bytes("exec_cache", data) == data
    assert c1 == bytes([data[0] ^ 0xFF]) + data[1:48]


def test_error_taxonomy():
    assert [c.__name__ for c in errors.RECOVERABLE] == \
        [c.__name__ for c in j_errors.RECOVERABLE]
    for cls in errors.RECOVERABLE:
        assert cls.phase == getattr(j_errors, cls.__name__).phase
    e = errors.NonFiniteResult("bad", case=3, n_bad=float("nan"))
    ctx = e.context()
    assert ctx["error"] == "NonFiniteResult" and ctx["case"] == 3
    assert ctx["n_bad"] == "nan" and ctx["phase"] == "dynamics"
    assert isinstance(errors.StorageExhausted("x"), OSError)
    assert isinstance(errors.DynamicsSingular("x"), RuntimeError)
    # a KernelFailure is recoverable only when a seam injected it
    assert not errors.recoverable(errors.KernelFailure("launch failed"))
    assert errors.recoverable(errors.KernelFailure("x", injected=True))
    assert not errors.recoverable(errors.ModelConfigError("x"))
    assert not errors.recoverable(RuntimeError("x"))


@pytest.mark.parametrize("env", [None, "0", "1", "off", "false", "bogus"])
def test_recovery_mode_matches_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("RAFT_TPU_RECOVERY", raising=False)
    else:
        monkeypatch.setenv("RAFT_TPU_RECOVERY", env)
    assert _config.recovery_mode() == j_config.recovery_mode()
    assert recovery.enabled() == j_recovery.enabled()


def test_relax_weights_keeps_the_literal_complement():
    keep, relax = recovery.relax_weights(0.8)
    assert keep == 0.2 and relax == 0.8 and 1.0 - 0.8 != 0.2
    assert recovery.relax_weights(0.5) == j_recovery.relax_weights(0.5)


def test_jax_rung_names_map_onto_the_port():
    for port, jax in ((recovery.statics_ladder(), j_recovery.statics_ladder()),
                      (recovery.dynamics_ladder(),
                       j_recovery.dynamics_ladder())):
        assert [recovery.JAX_STEP[s.name] for s in jax] == \
            [s.name for s in port]


def test_run_ladder_walks_and_records():
    calls, attempts = [], []

    def fn():
        calls.append(recovery.current("clip_scale", 1.0))
        if len(calls) < 3:
            raise errors.StaticsDivergence("nope", case=0)
        return "ok"

    out = recovery.run_ladder("statics", "0", fn, recovery.statics_ladder(),
                              recorder=attempts.append)
    assert out == "ok"
    # configured, the same Newton again, then the damped clip
    assert calls == [1.0, 1.0, 0.2]
    assert [(a.step_from, a.step_to, a.outcome) for a in attempts] == [
        ("configured", "re_solve", "failed"),
        ("re_solve", "damped", "recovered")]
    assert attempts[0].error == "StaticsDivergence"
    assert recovery.current("clip_scale", 1.0) == 1.0


def test_run_ladder_exhaustion_reraises():
    seen, attempts = [], []

    def fn():
        seen.append((recovery.current("fp_relax", 0.8),
                     recovery.current("fp_iter_mult", 1)))
        raise errors.NonFiniteResult("always")

    with pytest.raises(errors.NonFiniteResult):
        recovery.run_ladder("dynamics", "0", fn, recovery.dynamics_ladder(),
                            recorder=attempts.append)
    # f64_resolve is skipped: three attempts, the last damped
    assert seen == [(0.8, 1), (0.8, 1), (0.5, 2)]
    assert [(a.step_from, a.step_to) for a in attempts] == [
        ("configured", "re_solve"), ("re_solve", "damped_restart")]


def test_run_ladder_disabled_is_bare():
    _config.set_recovery_mode("0")
    calls = []

    def fn():
        calls.append(1)
        raise errors.NonFiniteResult("x")

    with pytest.raises(errors.NonFiniteResult):
        recovery.run_ladder("dynamics", "0", fn, recovery.dynamics_ladder())
    assert calls == [1]


def test_run_ladder_lets_a_real_kernel_failure_through():
    calls, attempts = [], []

    def fn():
        calls.append(1)
        raise errors.KernelFailure("kernel launch failed", kernel="K1")

    with pytest.raises(errors.KernelFailure):
        recovery.run_ladder("dynamics", "0", fn, recovery.dynamics_ladder(),
                            recorder=attempts.append)
    assert calls == [1] and attempts == []


# ---------------------------------------------------------------------------
# journal, checkpoint store, digests
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_corrupt_entries(tmp_path):
    j = recovery.CaseJournal("unitkey", base_dir=str(tmp_path))
    assert j.completed() == [] and j.load_case(0) is None
    j.store_case(0, {"case_metrics": {0: {"surge_std": 1.25}},
                     "mean_offset": np.arange(6.0)})
    j.store_case(1, {"case_metrics": {}, "mean_offset": np.zeros(6)})
    j.store_case(2, {"case_metrics": {}, "mean_offset": np.zeros(6)})
    assert j.completed() == [0, 1, 2]
    doc = j.load_case(0)
    assert doc["case_metrics"][0]["surge_std"] == 1.25
    assert np.all(doc["mean_offset"] == np.arange(6.0))
    before = journalio.corrupt_count("case")
    whole = open(j._path(1), "rb").read()
    with open(j._path(1), "wb") as f:                # a torn write
        f.write(whole[: len(whole) // 2])
    with open(j._path(2), "wb") as f:                # the wrong shape
        pickle.dump(["not", "a", "record"], f)
    assert j.load_case(1) is None and j.load_case(2) is None
    assert not os.path.exists(j._path(1))            # torn entry deleted
    assert journalio.corrupt_count("case") == before + 2
    j.store_case(1, {"case_metrics": {}, "mean_offset": np.ones(6)})
    assert j.load_case(1) is not None
    j.clear()
    assert j.completed() == []


def test_journal_retention_prunes_old_models(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_JOURNAL_MAX_MODELS", "2")
    base = str(tmp_path)
    for i, key in enumerate(("aaa", "bbb", "ccc")):
        j = recovery.CaseJournal(key, base_dir=base)
        j.store_case(0, {"case_metrics": {}, "mean_offset": np.zeros(6)})
        os.utime(j.dir, (i + 1, i + 1))
    recovery.prune_journals(base, keep="ddd")
    assert sorted(os.listdir(base)) == ["ccc"]


def test_journal_default_directory(monkeypatch):
    monkeypatch.delenv("RAFT_TPU_JOURNAL_DIR", raising=False)
    assert recovery.journal_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "raft_tpu_torch", "journal")
    assert recovery.journal_dir() != j_recovery.journal_dir()


def test_journal_key_sees_an_edited_shared_mooring(tmp_path):
    """A farm's shared mooring (``array_mooring``) is part of the journal
    key: after its file is edited the old entries must not resume."""
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import farm_cases as FC

    edited = tmp_path / "shared_edited.dat"
    text = open(FC.STANDIN_FILE).read()
    assert text.count("10000    330") == 2
    edited.write_text(text.replace("10000    330", "10000    340"))
    base = str(tmp_path / "journal")
    j = recovery.CaseJournal.for_model(
        Model(FC.f2_design(FC.GRID), device="cpu"), base_dir=base)
    j.store_case(0, {"case_metrics": {}, "mean_offset": np.zeros(12)})
    assert recovery.CaseJournal.for_model(
        Model(FC.f2_design(FC.GRID), device="cpu"),
        base_dir=base).load_case(0) is not None
    j2 = recovery.CaseJournal.for_model(
        Model(FC.f2_design(FC.GRID, mooring_file=str(edited)),
              device="cpu"), base_dir=base)
    assert j2.key != j.key and j2.load_case(0) is None


def _arrays():
    return {"Xi": np.arange(12.0).reshape(3, 4) * (1 + 2j),
            "iters": np.array([3, 4, 5], np.int32)}


def test_checkpoint_roundtrip(tmp_path):
    st = CheckpointStore(str(tmp_path))
    assert st.get("sha256:abc", 0) is None
    digest = st.put("sha256:abc", 0, _arrays(), meta={"kind": "x"})
    assert digest.startswith("sha256:")
    step, arrays, meta = st.get("sha256:abc", 0)
    assert step == 0 and meta == {"kind": "x"}
    assert np.array_equal(arrays["Xi"], _arrays()["Xi"])
    st.put("sha256:abc", 3, _arrays())
    assert st.steps("sha256:abc") == [0, 3]
    assert st.latest("sha256:abc")[0] == 3
    st.delete("sha256:abc", 3)
    assert st.steps("sha256:abc") == [0]
    st.delete("sha256:abc")
    assert st.steps("sha256:abc") == [] and st.stats()["writes"] == 2


def test_checkpoint_corruption_is_delete_and_miss(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.put("k", 0, _arrays())
    st.put("k", 1, _arrays())
    faults.install("corrupt@checkpoint:step=1")
    # latest falls back one step past the corrupt checkpoint
    assert st.latest("k")[0] == 0
    assert st.steps("k") == [0] and st.stats()["corrupt"] == 1
    faults.clear()
    # a sidecar answering for another key: the key/step check
    st.put("k", 2, _arrays())
    entry, side = st._paths("k", 2)
    doc = open(side).read().replace('"key":"k"', '"key":"q"')
    with open(side, "w") as f:
        f.write(doc)
    assert st.get("k", 2) is None and st.stats()["corrupt"] == 2
    # a payload that lost its sidecar is an orphan, reclaimed when aged
    st.put("k", 4, _arrays())
    os.unlink(st._paths("k", 4)[1])
    os.utime(st._paths("k", 4)[0], (1, 1))
    assert st.latest("k")[0] == 0
    assert not os.path.exists(st._paths("k", 4)[0])


def test_checkpoint_eio_is_a_plain_miss(tmp_path):
    st = CheckpointStore(str(tmp_path))
    st.put("k", 0, _arrays())
    faults.install("eio@checkpoint:once")
    assert st.get("k", 0) is None
    assert st.stats()["read_errors"] == 1 and st.stats()["corrupt"] == 0
    assert st.get("k", 0) is not None               # not deleted


def test_checkpoint_enospc_and_budget_raise_typed(tmp_path, monkeypatch):
    st = CheckpointStore(str(tmp_path))
    faults.install("enospc@checkpoint")
    with pytest.raises(errors.StorageExhausted):
        st.put("k", 0, _arrays())
    faults.clear()
    assert st.steps("k") == [] and st.stats()["enospc"] == 1

    # only a proven ENOSPC from the file system is exhaustion; any other
    # write failure is a counted gap
    def fails_with(code):
        def write(path, data):
            raise OSError(code, os.strerror(code))
        return write

    monkeypatch.setattr(journalio, "fsync_write", fails_with(errno.ENOSPC))
    with pytest.raises(errors.StorageExhausted):
        st.put("k", 0, _arrays())
    monkeypatch.setattr(journalio, "fsync_write", fails_with(errno.EACCES))
    assert st.put("k", 0, _arrays()) is None
    assert st.stats()["enospc"] == 2 and st.stats()["write_errors"] == 1


def test_model_digest_is_by_value():
    from raft_tpu_torch.parallel.sweep import design_fowt

    a = design_fowt("Vertical_cylinder", "cpu")
    b = design_fowt("Vertical_cylinder", "cpu")
    assert model_digest(a) == model_digest(b)
    b.nodes.dls[0] += 1e-9
    assert model_digest(a) != model_digest(b)
    z = {"q": torch.tensor([1 + 2j, 3 - 1j], dtype=torch.complex128)}
    assert model_digest(z) != model_digest(
        {"q": torch.tensor([1 + 2j, 3 + 1j], dtype=torch.complex128)})


# ---------------------------------------------------------------------------
# a kernel that fails for real is fatal
# ---------------------------------------------------------------------------

def _launch_failure(*a, **k):
    raise errors.KernelFailure("kernel launch failed (test)",
                               kernel="impedance_gj")


def test_real_kernel_failure_propagates_from_analyze_cases(monkeypatch,
                                                           tmp_path):
    from raft_tpu_torch.model import Model

    monkeypatch.setenv("RAFT_TPU_JOURNAL_DIR", str(tmp_path))
    monkeypatch.setattr(linalg, "impedance_gj_solve", _launch_failure)
    m = Model(RC.cyl_design(ncases=2), device="cpu")
    with pytest.raises(errors.KernelFailure) as exc:
        m.analyzeCases()
    assert not exc.value.injected
    assert m.recovery_attempts == [] and m.failed_cases == []
    assert recovery.CaseJournal.for_model(m).completed() == []


def test_real_kernel_failure_propagates_from_sweep_cases(monkeypatch):
    from raft_tpu_torch.models.fowt import build_fowt
    from raft_tpu_torch.parallel.sweep import sweep_cases

    d, w, depth = RC.sweep_fowt_args()
    fowt = build_fowt(d, w, depth=depth, device="cpu")
    monkeypatch.setattr(linalg, "impedance_gj_solve", _launch_failure)
    with pytest.raises(errors.KernelFailure) as exc:
        sweep_cases(fowt, *RC.sweep_inputs(), nIter=RC.SWEEP_NITER,
                    device="cpu")
    assert not exc.value.injected
