"""The port's sweep service against the JAX package's, on stub engines.

No solves: a deterministic instant batch engine (``stub_factory``, the
``std`` row is Hs replicated, as in ``tests/test_serve.py``) behind both
packages' ``SweepService``.  Config validation and the retry matrix with
``backoff_s`` bitwise equal to the JAX ``RetryPolicy``; the watchdog's
arm/disarm contract; admission with its Retry-After hint; the
degradation ladder; the watchdog abandoning a hung batch; and one
scenario (a journal, a result store, duplicates, a poisoned lane, a
transient kernel failure) run through both packages, whose counts,
outcomes, result digests and request digests must be equal.  Every wait
takes an explicit timeout.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from raft_tpu import errors as j_errors
from raft_tpu import serve as j_serve
from raft_tpu.testing import faults as j_faults

from raft_tpu_torch import errors, obs
from raft_tpu_torch import serve
from raft_tpu_torch.serve import (DEFAULT_BUDGETS, TERMINAL, RetryPolicy,
                                  ServeConfig, SweepService, Watchdog)
from raft_tpu_torch.testing import faults

WAIT = 20.0


@pytest.fixture(autouse=True)
def _port_isolation():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    j_faults.clear()
    obs.reset_all()


def stub_factory(mode, fowt, ncases, **kw):
    """Deterministic instant batch engine: std row = Hs replicated."""
    def run(Hs, Tp, beta):
        Hs = np.asarray(Hs)
        return {"std": np.stack([np.full(6, float(h)) for h in Hs]),
                "iters": np.full(len(Hs), 3),
                "converged": np.ones(len(Hs), bool)}
    run.ncases = ncases
    run.cache_state = "stub"
    return run


def _cfg(pkg=serve, **kw):
    base = dict(queue_max=8, batch_cases=2, window_s=0.02,
                batch_deadline_s=5.0, retry_base_s=0.01, degrade_after=99)
    base.update(kw)
    return pkg.ServeConfig(**base)


def _service(pkg=serve, factory=stub_factory, **kw):
    cfg = kw.pop("config", None) or _cfg(pkg)
    extra = {"device": "cpu"} if pkg is serve else {}
    return pkg.SweepService(runner_factory=factory, config=cfg, **kw,
                            **extra)


# -- config, retry, watchdog --------------------------------------------

def test_config_validation_is_typed():
    with pytest.raises(errors.ModelConfigError) as exc:
        ServeConfig(queue_max=0, window_s=-1.0)
    assert "queue_max" in str(exc.value) and "window_s" in str(exc.value)
    with pytest.raises(errors.ModelConfigError, match="A10"):
        ServeConfig(surrogate_dir="bundles", store_dir="store")
    with pytest.raises(errors.ModelConfigError, match="warm_start"):
        ServeConfig(warm_start=True)


# the learned read tier's tuning knobs come with serve/surrogate.py
_UNPORTED = {"surrogate_tol", "surrogate_audit_every",
             "surrogate_refresh_writes", "surrogate_drill"}


def test_config_fields_and_defaults_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    jax = {f.name: f.default for f in dataclasses.fields(j_serve.ServeConfig)}
    assert set(jax) - set(port) == _UNPORTED
    assert port == {k: v for k, v in jax.items() if k not in _UNPORTED}
    assert serve.MODES == j_serve.MODES
    assert ServeConfig().solver_kw() == j_serve.ServeConfig().solver_kw()
    j_scalars = j_serve.ServeConfig(batch_cases=4).scalars()
    assert ServeConfig(batch_cases=4).scalars() == \
        {k: v for k, v in j_scalars.items() if k not in _UNPORTED}


_TAXONOMY = ("KernelFailure", "CacheCorruption", "JournalCorrupt",
             "ResultStoreCorrupt", "DynamicsSingular", "StaticsDivergence",
             "NonFiniteResult", "FaultInjected", "EigenFailure",
             "DeadlineExceeded", "ModelConfigError", "AdmissionRejected",
             "PartitionRuleError", "StorageExhausted", "WarmStartRejected",
             "ReplicaLagExceeded", "MooringSingular")


@pytest.mark.parametrize("name", _TAXONOMY)
def test_retry_matrix_equals_jax(name):
    p, j = RetryPolicy(seed=7), j_serve.RetryPolicy(seed=7)
    e, je = getattr(errors, name)("x"), getattr(j_errors, name)("x")
    assert p.classify(e) == j.classify(je)
    assert p.budget(e) == j.budget(je)
    for attempt in range(4):
        assert p.should_retry(e, attempt) == j.should_retry(je, attempt)
    assert [c.__name__ for c in type(e).__mro__] == \
        [c.__name__ for c in type(je).__mro__]


def test_retry_matrix_table_and_terminal():
    assert RetryPolicy().matrix() == j_serve.RetryPolicy().matrix()
    assert DEFAULT_BUDGETS == j_serve.DEFAULT_BUDGETS
    assert TERMINAL == j_serve.TERMINAL
    assert RetryPolicy().budget(RuntimeError("a bug")) == 0
    assert RetryPolicy().budget(
        errors.AdmissionRejected("x", retry_after_s=1.0)) == 0


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_bitwise_equals_jax(seed):
    kw = dict(base_s=0.05, cap_s=2.0, jitter=0.5, seed=seed)
    p, j = RetryPolicy(**kw), j_serve.RetryPolicy(**kw)
    for key in ("req0", "req17", "opt3", "farm9"):
        seq = [p.backoff_s(key, i) for i in range(10)]
        assert seq == [j.backoff_s(key, i) for i in range(10)]
        for i, d in enumerate(seq):
            raw = min(2.0, 0.05 * 2 ** i)
            assert raw * 0.5 <= d <= raw


def test_watchdog_arm_disarm_race_contract():
    fired = []
    wd = Watchdog(tick_s=0.01)
    wd.start()
    try:
        wid = wd.arm(time.monotonic() + 10.0, lambda: fired.append("no"))
        assert wd.disarm(wid) is True          # not expired: caller owns
        wid = wd.arm(time.monotonic() + 0.03, lambda: fired.append("yes"))
        deadline = time.monotonic() + 2.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fired == ["yes"]
        assert wd.disarm(wid) is False         # expired: caller lost
        assert wd.armed_count() == 0
    finally:
        wd.stop()


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SweepService(runner_factory=stub_factory, config=_cfg())


# -- admission, Retry-After, the ladder, the watchdog ---------------------

@pytest.mark.parametrize("pkg", [serve, j_serve], ids=["port", "jax"])
def test_admission_queue_full_and_retry_after(pkg):
    svc = _service(pkg, config=_cfg(pkg, queue_max=3))
    for i in range(3):                         # pre-start: the worker idles
        svc.submit(1.0 + i, 8.0, 0.0)
    err = getattr(j_errors if pkg is j_serve else errors,
                  "AdmissionRejected")
    with pytest.raises(err) as exc:
        svc.submit(9.0, 8.0, 0.0)
    e = exc.value
    assert e.ctx["reason"] == "queue_full"
    # 3 queued at batch 2 = 2 batches ahead x the 1 s default cadence,
    # plus the window
    assert e.retry_after_s == pytest.approx(2.02)
    assert e.context()["retry_after_s"] == e.retry_after_s
    with pytest.raises(err) as exc:
        svc.submit(1.0, 8.0, 0.0, deadline_s=1e-4)
    assert exc.value.ctx["reason"] == "queue_full"
    svc.start()
    assert svc.stop(timeout=WAIT)["completed"] == 3


def test_admission_deadline_pressure_rejects():
    svc = _service()
    with pytest.raises(errors.AdmissionRejected) as exc:
        svc.submit(1.0, 8.0, 0.0, deadline_s=1e-4)
    assert exc.value.ctx["reason"] == "deadline_pressure"
    snap = obs.snapshot()
    series = snap["raft_tpu_serve_admission_rejects_total"]["series"]
    assert any(s["labels"] == {"reason": "deadline_pressure"}
               for s in series)
    svc.start()
    assert svc.stop(timeout=WAIT)["rejected"] == 1


def test_ladder_degrades_on_sustained_violation_and_recovers():
    calls = {"n": 0}

    def paced(mode, fowt, ncases, **kw):
        inner = stub_factory(mode, fowt, ncases, **kw)

        def run(Hs, Tp, beta):
            calls["n"] += 1
            if calls["n"] <= 2:
                time.sleep(0.08)               # the two violating batches
            return inner(Hs, Tp, beta)
        run.ncases = ncases
        return run

    cfg = _cfg(batch_cases=1, window_s=0.0, latency_slo_s=0.05,
               degrade_after=2, upgrade_after=2)
    svc = _service(factory=paced, config=cfg,
                   degraded_fowts={"no_qtf": object()})
    assert svc.ladder == ("full", "no_qtf", "reject")
    svc.start()
    results = [svc.submit(1.0 + i, 8.0, 0.0).result(WAIT)
               for i in range(6)]
    summary = svc.stop(timeout=WAIT)
    assert all(r.ok for r in results)
    trans = [(t["from"], t["to"], t["reason"])
             for t in summary["mode_transitions"]]
    assert ("full", "no_qtf", "slo_violation") in trans
    assert ("no_qtf", "full", "healthy") in trans
    assert results[-1].mode == "full"


def test_reject_mode_sheds_then_exits_after_hold():
    cfg = _cfg(batch_cases=1, window_s=0.0, latency_slo_s=0.0,
               degrade_after=1, upgrade_after=99, reject_hold_s=0.2)
    svc = _service(config=cfg)
    assert svc.ladder == ("full", "reject")
    svc.start()
    assert svc.submit(1.0, 8.0, 0.0).result(WAIT).ok
    deadline = time.monotonic() + 5.0
    while svc.mode != "reject" and time.monotonic() < deadline:
        time.sleep(0.01)
    assert svc.mode == "reject"
    with pytest.raises(errors.AdmissionRejected) as exc:
        svc.submit(2.0, 8.0, 0.0)
    assert exc.value.ctx["reason"] == "degraded"
    deadline = time.monotonic() + 5.0
    while svc.mode == "reject" and time.monotonic() < deadline:
        time.sleep(0.02)
    assert svc.mode == "full"
    assert svc.submit(3.0, 8.0, 0.0).result(WAIT).ok
    svc.stop(timeout=WAIT)


def test_watchdog_abandons_hang_quarantines_offender_readmits_rest():
    faults.install("hang@serve:req=1:ms=600")
    cfg = _cfg(batch_deadline_s=0.25, watchdog_tick_s=0.02,
               hang_quarantine_after=2)
    svc = _service(config=cfg)
    svc.start()
    t0 = svc.submit(1.0, 8.0, 0.0)
    t1 = svc.submit(2.0, 8.0, 0.0)             # seq 1 carries the hang
    r0, r1 = t0.result(WAIT), t1.result(WAIT)
    faults.clear()
    assert r0.ok and np.allclose(r0.std, 1.0)
    assert not r1.ok and r1.quarantined
    assert r1.error["error"] == "DeadlineExceeded"
    summary = svc.stop(timeout=WAIT)
    assert summary["abandoned_batches"] == 2   # the batch, then solo
    assert summary["deadline_misses"] == 3
    assert summary["quarantined"] == 1 and summary["unhandled"] == 0


def test_transient_failure_retried_and_bug_is_typed():
    calls = {"n": 0}

    def flaky(mode, fowt, ncases, **kw):
        inner = stub_factory(mode, fowt, ncases, **kw)

        def run(Hs, Tp, beta):
            calls["n"] += 1
            if calls["n"] == 1:
                raise errors.KernelFailure("transient", injected=True)
            if calls["n"] == 2:
                raise ZeroDivisionError("a bug, not a transient")
            return inner(Hs, Tp, beta)
        run.ncases = ncases
        return run

    svc = _service(factory=flaky, config=_cfg(batch_cases=1))
    svc.start()
    r1 = svc.submit(1.0, 8.0, 0.0).result(WAIT)
    r2 = svc.submit(2.0, 8.0, 0.0).result(WAIT)
    summary = svc.stop(timeout=WAIT)
    # the transient retried, then hit the bug: a typed unhandled failure
    assert not r1.ok and r1.error["error"] == "KernelFailure"
    assert r2.ok
    assert summary["retries"] == 1 and summary["unhandled"] == 1


# -- one scenario through both packages ------------------------------------

def _scenario(pkg, tmp_path):
    """Journal + result store; 6 requests and 2 duplicates submitted
    before start (batches form deterministically), a lane poisoned on
    every pass, one transient batch failure; then a repeat answered from
    the store.  Returns the comparable facts."""
    f = faults if pkg is serve else j_faults
    f.install("nan@dynamics:case=3")
    calls = {"n": 0}

    def flaky(mode, fowt, ncases, **kw):
        inner = stub_factory(mode, fowt, ncases, **kw)

        def run(Hs, Tp, beta):
            calls["n"] += 1
            if calls["n"] == 2:
                raise (errors if pkg is serve else j_errors).KernelFailure(
                    "transient", injected=True)
            return inner(Hs, Tp, beta)
        run.ncases = ncases
        return run

    cfg = _cfg(pkg, journal_dir=str(tmp_path / "wal"),
               store_dir=str(tmp_path / "store"))
    svc = _service(pkg, factory=flaky, config=cfg)
    reqs = [(1.0 + i, 8.0 + 0.5 * i, 0.1 * i) for i in range(6)]
    tickets = [svc.submit(*r) for r in reqs + [reqs[0], reqs[4]]]
    svc.start()
    results = [t.result(WAIT) for t in tickets]
    repeat = svc.submit(*reqs[1]).result(WAIT)
    summary = svc.stop(timeout=WAIT)
    f.clear()
    rdig = [pkg.request_digest(*r, "default") for r in reqs]
    out = {"results": [(r.ok, r.digest, r.iters, r.attempts, r.seq,
                        (r.error or {}).get("error"), r.source)
                       for r in results],
           "repeat": (repeat.ok, repeat.digest, repeat.source),
           "rdigests": rdig,
           "fetched": [getattr(svc.fetch_rdigest(d), "digest", None)
                       for d in rdig],
           "counts": {k: summary[k] for k in (
               "admitted", "rejected", "completed", "failed", "retries",
               "retried_recovered", "batches", "store_hits", "coalesced",
               "unhandled", "quarantined", "requests")}}
    return out


def test_stub_scenario_matches_jax(tmp_path):
    port = _scenario(serve, tmp_path / "port")
    jax = _scenario(j_serve, tmp_path / "jax")
    assert port == jax
    oks = [r[0] for r in port["results"]]
    assert oks == [True, True, True, False, True, True, True, True]
    assert port["results"][3][5] == "NonFiniteResult"
    assert port["counts"]["coalesced"] == 2
    assert port["repeat"][2] == "cached"
    assert port["fetched"][3] is None and all(port["fetched"][:3])
