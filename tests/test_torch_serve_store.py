"""The port's content-addressed result store against the JAX package's.

A ``ResultStore`` directory written by one package is read by the other
(payloads, warm-start seeds, the neighbour index, quarantine); integrity
failures are delete-and-miss and, read strictly, the typed
``ResultStoreCorrupt``; a storm of duplicate submissions over D distinct
requests solves exactly D times (single-flight), and a service over a
JAX-written store answers repeats without solving.  Stub engines; every
wait takes an explicit timeout.
"""
import threading

import numpy as np
import pytest

from raft_tpu.serve.resultstore import ResultStore as JStore

from raft_tpu_torch import errors, obs
from raft_tpu_torch.ledger import digest_metrics
from raft_tpu_torch.serve import ServeConfig, SweepService
from raft_tpu_torch.serve import journal as wal
from raft_tpu_torch.serve.resultstore import ResultStore
from raft_tpu_torch.testing import faults

WAIT = 20.0


@pytest.fixture(autouse=True)
def _port_isolation():
    faults.clear()
    obs.reset_all()
    yield
    faults.clear()
    obs.reset_all()


def _payload(Hs=2.0, Tp=8.0, beta=0.0, tenant="default", seed=1.0):
    std = [float(seed) * (i + 1) for i in range(6)]
    return {"rdigest": wal.request_digest(Hs, Tp, beta, tenant),
            "digest": digest_metrics({"std": std, "iters": 3,
                                      "converged": True}),
            "std": std, "iters": 3, "converged": True, "tenant": tenant,
            "Hs": float(Hs), "Tp": float(Tp), "beta": float(beta)}


def _fill(store_cls, path, n=4):
    s = store_cls(str(path), keep_xi=True)
    out = []
    for i in range(n):
        p = _payload(Hs=1.0 + i, Tp=8.0 + 0.5 * i, seed=1.0 + i)
        xi = (np.arange(12.0) + 1j * i).reshape(6, 2)
        assert s.put(p, xi=xi)
        out.append((p, xi))
    return s, out


@pytest.mark.parametrize("writer,reader", [(ResultStore, JStore),
                                           (JStore, ResultStore)],
                         ids=["port_to_jax", "jax_to_port"])
def test_store_directory_read_across_packages(tmp_path, writer, reader):
    _, entries = _fill(writer, tmp_path)
    r = reader(str(tmp_path), keep_xi=True)
    assert len(r) == len(entries)
    for p, xi in entries:
        doc = r.get(p["rdigest"])
        assert doc["std"] == p["std"] and doc["digest"] == p["digest"]
        assert np.array_equal(r.get_xi(p["rdigest"]), xi)
        assert r.get_by_digest(p["digest"])["rdigest"] == p["rdigest"]
    near = r.nearest(2.1, 8.6, 0.0, "default", radius=1.0)
    assert near[0] == entries[1][0]["rdigest"]
    assert r.stats()["corrupt"] == 0
    # a quarantine written by the reader is seen by a fresh writer handle
    r.quarantine(entries[1][0]["rdigest"])
    assert writer(str(tmp_path), keep_xi=True).get_xi(
        entries[1][0]["rdigest"]) is None


def test_corrupt_entry_is_delete_and_miss_and_typed_when_strict(tmp_path):
    s, entries = _fill(ResultStore, tmp_path, n=2)
    p = entries[0][0]
    stem = p["rdigest"].rsplit(":", 1)[-1]
    path = tmp_path / f"{stem}.json"
    raw = bytearray(path.read_bytes())
    raw[0] ^= 0xFF
    path.write_bytes(bytes(raw))
    assert s.get(p["rdigest"]) is None and not path.exists()
    assert s.stats()["corrupt"] == 1
    s.put(p)
    path.write_bytes(b"garbage")
    with pytest.raises(errors.ResultStoreCorrupt) as exc:
        s.get(p["rdigest"], strict=True)
    assert isinstance(exc.value, errors.CacheCorruption)
    # the JAX package's reader agrees: the entry is unusable
    assert JStore(str(tmp_path)).get(p["rdigest"]) is None


def test_fault_corrupt_and_stale_rejected(tmp_path):
    s, entries = _fill(ResultStore, tmp_path, n=2)
    p, q = entries[0][0], entries[1][0]
    faults.install(f"corrupt@resultstore:entry={p['rdigest'][7:]}")
    assert s.get(q["rdigest"]) is not None
    assert s.get(p["rdigest"]) is None
    faults.install("stale@resultstore")
    assert s.get(q["rdigest"]) is None
    faults.clear()
    assert s.stats()["corrupt"] == 2 and len(s) == 0


def test_enospc_sheds_typed(tmp_path):
    s = ResultStore(str(tmp_path))
    faults.install("enospc@resultstore")
    with pytest.raises(errors.StorageExhausted):
        s.put(_payload())
    faults.clear()
    assert s.put(_payload())


def _stub(calls, gate=None):
    def factory(mode, fowt, ncases, **kw):
        def run(Hs, Tp, beta):
            if gate is not None:
                gate.wait(WAIT)
            Hs = np.asarray(Hs)
            calls.append(Hs.tolist())
            return {"std": np.stack([np.full(6, float(h)) for h in Hs]),
                    "iters": np.full(len(Hs), 3),
                    "converged": np.ones(len(Hs), bool)}
        run.ncases = ncases
        return run
    return factory


def _cfg(tmp_path, **kw):
    base = dict(queue_max=16, batch_cases=4, window_s=0.02,
                batch_deadline_s=10.0, retry_base_s=0.01, degrade_after=99,
                store_dir=str(tmp_path / "store"))
    base.update(kw)
    return ServeConfig(**base)


def test_single_flight_storm_solves_each_digest_once(tmp_path):
    calls, gate = [], threading.Event()
    svc = SweepService(runner_factory=_stub(calls, gate),
                       config=_cfg(tmp_path), device="cpu")
    n, d = 24, 3
    tickets = [None] * n
    barrier = threading.Barrier(8)

    def storm(k):
        barrier.wait(5.0)
        for i in range(k, n, 8):
            tickets[i] = svc.submit(1.0 + (i % d), 8.0, 0.0)
    threads = [threading.Thread(target=storm, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    svc.start()
    gate.set()
    results = [t.result(WAIT) for t in tickets]
    summary = svc.stop(timeout=WAIT)
    assert all(r.ok for r in results)
    by_hs = {}
    for r in results:
        by_hs.setdefault(r.std[0], set()).add(r.digest)
    assert all(len(v) == 1 for v in by_hs.values())
    assert len({h for lanes in calls for h in lanes}) == d
    assert summary["coalesced"] == n - d and summary["completed"] == n


def test_service_answers_from_a_jax_written_store(tmp_path):
    js = JStore(str(tmp_path / "store"))
    p = _payload(Hs=3.0, Tp=9.0, beta=0.2)
    js.put(p)
    calls = []
    svc = SweepService(runner_factory=_stub(calls), config=_cfg(tmp_path),
                       device="cpu")
    svc.start()
    hit = svc.submit(3.0, 9.0, 0.2).result(WAIT)
    miss = svc.submit(4.0, 9.0, 0.2).result(WAIT)
    summary = svc.stop(timeout=WAIT)
    assert hit.ok and hit.digest == p["digest"] and hit.std == p["std"]
    assert miss.ok and calls == [[4.0, 4.0, 4.0, 4.0]]
    assert summary["store_hits"] == 1
    # the port's put is read back by the JAX package
    assert JStore(str(tmp_path / "store")).get(
        wal.request_digest(4.0, 9.0, 0.2))["digest"] == miss.digest
