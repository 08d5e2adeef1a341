"""The port's write-ahead request journal against the JAX package's.

The record format is shared: a journal (or a ``WalMirror`` directory)
written by either package's service replays in the other's with equal
recovered / replayed / deduped counts and equal digests.  The port's
journal on its own: the torn tail, rotation with the open admissions
re-appended, seq preservation across recovery, drain with its handoff
manifest, and recovery from a mirror alone.  ``request_digest``,
``optimize_digest`` and ``farm_digest`` give the JAX package's hex.
Stub engines (no solves); every wait takes an explicit timeout.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

from raft_tpu import serve as j_serve
from raft_tpu.serve import journal as j_wal

from raft_tpu_torch import errors, obs
from raft_tpu_torch import serve
from raft_tpu_torch.obs import journalio
from raft_tpu_torch.parallel.optimize import normalize_request
from raft_tpu_torch.parallel.sweep import normalize_farm_request
from raft_tpu_torch.serve import journal as wal
from raft_tpu_torch.testing import faults

WAIT = 20.0


@pytest.fixture(autouse=True)
def _port_isolation():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


def stub_factory(mode, fowt, ncases, **kw):
    def run(Hs, Tp, beta):
        Hs = np.asarray(Hs)
        return {"std": np.stack([np.full(6, float(h)) for h in Hs]),
                "iters": np.full(len(Hs), 3),
                "converged": np.ones(len(Hs), bool)}
    run.ncases = ncases
    return run


def _service(pkg, journal_dir=None, mirror_dirs=None, factory=stub_factory,
             **kw):
    base = dict(queue_max=16, batch_cases=2, window_s=0.02,
                batch_deadline_s=5.0, retry_base_s=0.01, degrade_after=99)
    if journal_dir is not None:
        base["journal_dir"] = str(journal_dir)
    if mirror_dirs is not None:
        base["mirror_dirs"] = tuple(str(d) for d in mirror_dirs)
    base.update(kw)
    extra = {"device": "cpu"} if pkg is serve else {}
    return pkg.SweepService(runner_factory=factory,
                            config=pkg.ServeConfig(**base), **extra)


# -- digests ----------------------------------------------------------------

@pytest.mark.parametrize("case", [(1.0, 8.0, 0.0, "default"),
                                  (6.25, 11.5, 3.14159, "default"),
                                  (2.0, 9.0, -0.5, "tenantB"),
                                  (1e-3, 20.0, 1e-12, "x")])
def test_request_digest_bitwise_jax(case):
    assert wal.request_digest(*case) == j_wal.request_digest(*case)


def test_optimize_and_farm_digests_bitwise_jax():
    from raft_tpu.parallel.optimize import normalize_request as j_norm
    from raft_tpu.parallel.sweep import normalize_farm_request as j_farm

    spec = {"bounds": {"d_scale": [0.9, 1.1], "moor_L": [0.95, 1.05]},
            "objective": {"metric": "std", "dof": 0},
            "nlanes": 4, "steps": 3, "seed": 1}
    p, j = normalize_request(spec), j_norm(spec)
    assert wal.optimize_digest(p, "default") == j_wal.optimize_digest(j)
    assert wal.optimize_digest(p, "t2") == j_wal.optimize_digest(j, "t2")
    farm = {"layout": [[0.0, 0.0], [800.0, 0.0]], "Hs": [2.0, 3.0],
            "Tp": [8.0, 9.0], "beta": [0.0, 0.3], "U_inf": [10.0, 11.0],
            "k_w": 0.06}
    pf, jf = normalize_farm_request(farm), j_farm(farm)
    assert wal.farm_digest(pf) == j_wal.farm_digest(jf)
    assert wal.farm_result_digest(1.5, 2, 2, 7) == \
        j_wal.farm_result_digest(1.5, 2, 2, 7)
    design = {"d_scale": 1.01, "moor_L": 0.99}
    assert wal.optimize_result_digest(design, 0.125, 3) == \
        j_wal.optimize_result_digest(design, 0.125, 3)


# -- cross-package replay ---------------------------------------------------

def _crashed_life(pkg, journal_dir, mirror=None):
    """A service that completes two requests, then 'dies' with two more
    admitted and unfinished (never started again) and a duplicate of a
    completed one admitted after it."""
    a = _service(pkg, journal_dir, mirror, batch_cases=1)
    a.start()
    done = [a.submit(1.0 + i, 8.0, 0.0).result(WAIT) for i in range(2)]
    a.stop(timeout=WAIT)
    # the second life admits and dies before its worker runs
    b = _service(pkg, journal_dir, mirror, batch_cases=1)
    b.recover()
    b.submit(5.0, 8.0, 0.0)
    b.submit(6.0, 8.0, 0.1)
    b.submit(1.0, 8.0, 0.0)            # a duplicate of a completed one
    b._journal.close()
    return [r.digest for r in done]


def _recover_in(pkg, src, journal_dir):
    svc = _service(pkg, journal_dir, batch_cases=1)
    info = svc.recover(src)
    svc.start()
    got = {seq: t.result(WAIT) for seq, t in info["tickets"].items()}
    summary = svc.stop(timeout=WAIT)
    return ({k: info[k] for k in ("recovered", "replayed", "deduped",
                                  "corrupt")},
            {seq: (r.ok, r.digest, r.source, r.request_id)
             for seq, r in sorted(got.items())},
            summary["replayed_lost_count"])


@pytest.mark.parametrize("writer,reader", [(serve, j_serve), (j_serve, serve)],
                         ids=["port_to_jax", "jax_to_port"])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    src = tmp_path / "wal"
    digests = _crashed_life(writer, src)
    other = _recover_in(reader, str(src), tmp_path / "other")
    same = _recover_in(writer, str(src), tmp_path / "same")
    assert other == same
    counts, results, lost = other
    assert counts == {"recovered": 2, "replayed": 2, "deduped": 1,
                      "corrupt": 0}
    assert lost == 0
    assert sorted(r[1] for r in results.values() if r[2] == "deduped") \
        == [digests[0]]
    # the replay state itself is equal field for field
    ps, js = wal.replay(str(src)), j_wal.replay(str(src))
    for key in ("completed", "failed", "max_seq", "corrupt", "records"):
        assert ps[key] == js[key], key
    assert [r["seq"] for r in ps["pending"]] == \
        [r["seq"] for r in js["pending"]]


@pytest.mark.parametrize("writer,reader", [(serve, j_serve), (j_serve, serve)],
                         ids=["port_to_jax", "jax_to_port"])
def test_mirror_replays_across_packages(tmp_path, writer, reader):
    primary, mirror = tmp_path / "primary", tmp_path / "mirror"
    _crashed_life(writer, primary, [mirror])
    a = _recover_in(reader, str(mirror), tmp_path / "B")
    b = _recover_in(reader, str(primary), tmp_path / "C")
    assert a[0] == b[0] and a[2] == b[2] == 0
    assert {s: r[:3] for s, r in a[1].items()} == \
        {s: r[:3] for s, r in b[1].items()}


# -- the port's journal on its own --------------------------------------------

def test_journalio_torn_tail_and_rotation(tmp_path):
    path = str(tmp_path / "j.jsonl")
    w = journalio.JsonlWriter(path, header=lambda p: {"type": "begin",
                                                      "part": p})
    w.write({"type": "rec", "n": 1})
    assert [d["type"] for d in journalio.read(path)] == ["begin", "rec"]
    w.write({"type": "rec", "n": 2})
    w.tear_tail()
    w.close()
    docs, bad = journalio.read_counted(path, kind="unittest")
    assert [d.get("n") for d in docs] == [None, 1] and bad == 1
    path = str(tmp_path / "r.jsonl")
    seen = {"flush": 0, "rotate": []}
    w = journalio.JsonlWriter(
        path, max_bytes=120, keep=2,
        header=lambda p: {"type": "begin", "part": p},
        post_flush=lambda wr: seen.__setitem__("flush", seen["flush"] + 1),
        post_rotate=lambda wr, part: seen["rotate"].append(part))
    for i in range(12):
        w.write({"type": "rec", "n": i, "pad": "x" * 20})
    w.close()
    assert os.path.exists(path + ".1")
    assert journalio.read(path)[0]["part"] == w.part
    assert seen["rotate"] == list(range(w.part))
    assert seen["flush"] == 12 + w.part + 1      # records + part headers


def test_torn_fault_and_strict_replay(tmp_path):
    faults.install("torn@journal:record=complete:once")
    j = wal.RequestJournal(str(tmp_path), run_id="t")
    j.record_admit(0, "req0", "sha256:r0", 1.0, 8.0, 0.0, 60.0, "default")
    j.record_complete(0, "sha256:r0", "sha256:d0", "full", 0, [1.0] * 6,
                      3, True)
    j.close()
    faults.clear()
    state = wal.replay(str(tmp_path))
    assert state["corrupt"] == 1 and state["completed"] == {}
    assert [r["seq"] for r in state["pending"]] == [0]
    with pytest.raises(errors.JournalCorrupt) as exc:
        wal.replay(str(tmp_path), strict=True)
    assert isinstance(exc.value, errors.CacheCorruption)
    assert j_wal.replay(str(tmp_path))["corrupt"] == 1


def test_rotation_checkpoints_open_admits(tmp_path, monkeypatch):
    monkeypatch.setenv("RAFT_TPU_SERVE_JOURNAL_MAX_BYTES", "500")
    svc = _service(serve, tmp_path)
    t = svc.submit(2.0, 9.0, 0.0)      # stays open: not started
    j = svc._journal
    part0 = j._writer.part
    for _ in range(40):
        j.record_tenant("evict", "default", "full")
    assert j._writer.part > part0 + 1
    for state in (wal.replay(str(tmp_path)), j_wal.replay(str(tmp_path))):
        assert [r["seq"] for r in state["pending"]] == [t.seq]
        assert state["admitted"][t.seq]["checkpoint"] is True
    svc.start()
    assert t.result(WAIT).ok
    svc.stop(timeout=WAIT)
    assert svc._journal_snapshot() == []


def test_recover_preserves_seqs_and_continues_seq_space(tmp_path):
    j = wal.RequestJournal(str(tmp_path), run_id="dead")
    j.record_admit(5, "req5-orig", wal.request_digest(2.0, 8.0, 0.0),
                   2.0, 8.0, 0.0, 60.0, "default")
    j.close()
    svc = _service(serve, tmp_path)
    info = svc.recover()
    svc.start()
    r5 = info["tickets"][5].result(WAIT)
    assert r5.seq == 5 and r5.request_id == "req5-orig"
    t = svc.submit(3.0, 8.0, 0.0)
    assert t.seq == 6 and t.result(WAIT).ok
    summary = svc.stop(timeout=WAIT)
    assert summary["replayed"] == 1 and summary["replayed_lost_count"] == 0


def test_drain_flushes_work_and_writes_handoff_manifest(tmp_path):
    svc = _service(serve, tmp_path)
    svc.start()
    tickets = [svc.submit(1.0 + i, 8.0, 0.0) for i in range(3)]
    doc = svc.drain(successor="http://replacement:8765", timeout=WAIT)
    assert all(t.result(1.0).ok for t in tickets)
    assert doc["pending"] == [] and doc["next_seq"] == 3
    with open(wal.handoff_path(str(tmp_path))) as f:
        assert json.load(f)["schema"] == "raft_tpu.serve.handoff/v1"
    assert j_wal.read_handoff_manifest(str(tmp_path))["next_seq"] == 3
    with pytest.raises(errors.AdmissionRejected) as exc:
        svc.submit(9.0, 8.0, 0.0)
    assert exc.value.ctx["reason"] == "stopped"
    assert exc.value.ctx["successor"] == "http://replacement:8765"


def test_drain_journals_unflushable_work_as_pending(tmp_path):
    def slow_factory(mode, fowt, ncases, **kw):
        inner = stub_factory(mode, fowt, ncases, **kw)

        def run(Hs, Tp, beta):
            time.sleep(0.5)
            return inner(Hs, Tp, beta)
        run.ncases = ncases
        return run

    svc = _service(serve, tmp_path, factory=slow_factory, batch_cases=1)
    svc.start()
    [svc.submit(1.0 + i, 8.0, 0.0) for i in range(3)]
    doc = svc.drain(timeout=0.2)
    assert doc["pending"]
    time.sleep(0.6)                    # the in-flight batch lands
    state = wal.replay(str(tmp_path))
    pending = {r["seq"] for r in state["pending"]}
    assert pending | set(state["completed"]) == {0, 1, 2}
    assert pending and pending <= set(doc["pending"])
    assert state["handoff"]["pending"] == doc["pending"]


def test_recover_from_mirror_only_in_fresh_tree(tmp_path):
    gate = threading.Event()

    def gated_factory(mode, fowt, ncases, **kw):
        inner = stub_factory(mode, fowt, ncases, **kw)

        def run(Hs, Tp, beta):
            if float(np.asarray(Hs)[0]) == 5.0:
                gate.wait(WAIT)        # the doomed batch hangs here
            return inner(Hs, Tp, beta)
        run.ncases = ncases
        return run

    a = _service(serve, tmp_path / "A", [tmp_path / "shared"],
                 factory=gated_factory, batch_cases=1,
                 batch_deadline_s=60.0)
    done = a.submit(2.0, 9.0, 0.0)
    pend = a.submit(5.0, 9.0, 0.0)
    a.start()
    d0 = done.result(WAIT).digest
    time.sleep(0.2)
    a._journal._writer.close()         # host A dies mid-batch
    with open(os.path.join(str(tmp_path / "shared"), wal.FILENAME),
              "ab") as f:
        f.write(b'{"type":"admit","seq":9')      # torn mirror tail
    b = _service(serve, tmp_path / "B", [tmp_path / "B-mirror"])
    info = b.recover(str(tmp_path / "shared"))
    assert info["mirror"] is True
    assert (info["recovered"], info["replayed"], info["corrupt"]) == \
        (1, 1, 1)
    assert b.fetch(d0).source == "recovered"
    b.start()
    r = info["tickets"][pend.seq].result(WAIT)
    assert r.ok and r.source == "replayed" and r.seq == pend.seq
    summary = b.stop(timeout=WAIT)
    assert summary["failover"] == 1 and summary["failover_lost_count"] == 0
    assert pend.seq in wal.replay(str(tmp_path / "B-mirror"))["completed"]
    gate.set()
    a.stop(timeout=5.0)


def test_mirror_lag_is_a_typed_signal(tmp_path):
    faults.install("lag@replica:s=30")
    j = wal.RequestJournal(str(tmp_path / "p"), run_id="r",
                           mirror_dirs=[str(tmp_path / "m")],
                           mirror_max_lag=2, mirror_sync=True)
    for i in range(5):
        j.record_admit(i, f"req{i}", "sha256:x", 1.0, 8.0, 0.0, 60.0,
                       "default")
    with pytest.raises(errors.ReplicaLagExceeded):
        j.mirror.check()
    faults.clear()
    j.close()
