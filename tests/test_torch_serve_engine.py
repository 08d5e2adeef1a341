"""The port's serving engine against the JAX package's, with real solves.

On the vendored OC3spar at 10 frequency bins (0.03-0.3 Hz), 4 cases a
batch from a seeded draw:

- ``make_batch_runner(device="cpu")`` against the JAX
  ``make_batch_runner`` (its executable cache in the test's directory):
  ``std`` / ``Xi`` at rtol 1e-9 / atol 1e-12 (``tests/test_torch_sweep.py``'s
  bar: the port solves by Gauss-Jordan, JAX on the CPU by LU), ``iters``,
  ``converged`` and ``fp_chunks`` exactly; bitwise the port's own
  ``make_case_solver(...).batched`` on the same lanes; a seeded ``Xi0``
  likewise against the JAX runner's warm-start shape;
- ``device=None`` raises where there is no card;
- ``Model.make_service`` builds the coarse rung on ``w[::2]`` and refuses
  a farm model with a typed error;
- 8 real requests at batch 4 through both packages' services, held to
  the same bar, each port result bitwise its batch's solve; resubmitted,
  answered from the store with no solve; recovered from the journal.
"""
import numpy as np
import pytest
import torch
import yaml

from raft_tpu.models.fowt import build_fowt as j_build_fowt
from raft_tpu.parallel.sweep import make_batch_runner as j_make_batch_runner
from raft_tpu import serve as j_serve

from raft_tpu_torch import errors, obs
from raft_tpu_torch import serve as t_serve
from raft_tpu_torch.io.designs import design_path, load_design
from raft_tpu_torch.ledger import digest_metrics
from raft_tpu_torch.models.fowt import build_fowt
from raft_tpu_torch.parallel.sweep import make_batch_runner, make_case_solver
from raft_tpu_torch.serve import ServeConfig, SweepService

W = np.arange(0.03, 0.33, 0.03) * 2 * np.pi        # 10 bins
NC = 4
WAIT = 120.0


@pytest.fixture(autouse=True)
def _port_isolation():
    obs.reset_all()
    yield
    obs.reset_all()


@pytest.fixture(scope="module")
def design():
    with open(design_path("OC3spar")) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def depth(design):
    return float(design["site"]["water_depth"])


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    n = 2 * NC
    return (1.0 + 11.0 * rng.random(n), 4.0 + 14.0 * rng.random(n),
            np.deg2rad(360.0 * rng.random(n)))


@pytest.fixture(scope="module")
def exec_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("exec_cache"))


@pytest.fixture(scope="module")
def jax_fowt(design, depth):
    return j_build_fowt(design, W, depth=depth)


@pytest.fixture(scope="module")
def port_runner(design, depth):
    return make_batch_runner(build_fowt(design, W, depth=depth), NC,
                             device="cpu")


def _close(a, b, rtol=1e-9, atol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _jax_runner(monkeypatch, exec_dir, jax_fowt, **kw):
    monkeypatch.setenv("RAFT_TPU_EXEC_CACHE_DIR", exec_dir)
    return j_make_batch_runner(jax_fowt, NC, **kw)


def test_runner_matches_jax_and_its_own_solver(port_runner, cases, design,
                                               depth, jax_fowt, exec_dir,
                                               monkeypatch):
    lanes = tuple(c[:NC] for c in cases)
    out = port_runner(*lanes)
    assert port_runner.ncases == NC and port_runner.nw == len(W)
    assert port_runner.cache_state == "disabled" and port_runner.key is None
    assert port_runner.devprof is None and port_runner.mesh is None
    assert port_runner.warm_start is True and port_runner.xistart == 0.1
    assert port_runner.build_s > 0.0 and port_runner.health is False
    jr = _jax_runner(monkeypatch, exec_dir, jax_fowt)
    j = jr(*lanes)
    for k in ("std", "Xi"):
        _close(out[k].numpy(), j[k])
    np.testing.assert_array_equal(out["iters"].numpy(), np.asarray(j["iters"]))
    np.testing.assert_array_equal(out["converged"].numpy(),
                                  np.asarray(j["converged"]))
    assert out["fp_chunks"] == int(j["fp_chunks"])
    ref = make_case_solver(build_fowt(design, W, depth=depth,
                                      device="cpu")).batched(*lanes)
    for k in ("std", "Xi", "iters", "converged"):
        assert torch.equal(out[k], ref[k]), k


def test_seeded_runner_matches_jax_warm_shape(port_runner, cases, jax_fowt,
                                              exec_dir, monkeypatch, design,
                                              depth):
    lanes = tuple(c[NC:] for c in cases)
    cold = port_runner(*lanes)
    seed = cold["Xi"].numpy() * (1.0 + 0.01j)
    warm = port_runner(*lanes, Xi0=seed)
    ref = make_case_solver(build_fowt(design, W, depth=depth,
                                      device="cpu")).batched(
        *lanes, Xi0=torch.as_tensor(seed))
    assert torch.equal(warm["std"], ref["std"])
    assert int(warm["iters"].max()) <= int(cold["iters"].max())
    jr = _jax_runner(monkeypatch, exec_dir, jax_fowt, warm_start=True)
    j = jr(*lanes, seed)
    _close(warm["std"].numpy(), j["std"])
    np.testing.assert_array_equal(warm["iters"].numpy(),
                                  np.asarray(j["iters"]))
    # no seed: the seeded shape is the cold program
    _close(port_runner(*lanes)["std"].numpy(), jr(*lanes)["std"])


def test_runner_without_card_raises(monkeypatch, design, depth):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batch_runner(build_fowt(design, W, depth=depth), NC,
                          warmup=False)


def test_model_make_service_builds_the_coarse_rung():
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import farm_cases as FC

    d = load_design("OC3spar")
    d["settings"] = dict(d.get("settings") or {}, min_freq=0.03,
                         max_freq=0.3)
    m = Model(d, device="cpu")
    svc = m.make_service(batch_cases=4)
    assert svc.ladder == ("full", "coarse", "reject")
    assert svc.cfg.batch_cases == 4 and svc.device == torch.device("cpu")
    coarse = svc._fowts["coarse"]
    assert coarse.nw == 5
    np.testing.assert_array_equal(coarse.w.numpy(), m.w[::2])
    assert svc._fowts["full"] is m.fowtList[0]
    assert m.make_service(coarse_stride=1).ladder == ("full", "reject")
    farm = Model(FC.f2_design(FC.GRID), device="cpu")
    with pytest.raises(errors.ModelConfigError, match="single-FOWT"):
        farm.make_service()


def _serve(pkg, fowt, cases, tmp_path, **extra):
    cfg = pkg.ServeConfig(batch_cases=NC, window_s=0.05, queue_max=64,
                          journal_dir=str(tmp_path / "wal"),
                          store_dir=str(tmp_path / "store"))
    svc = pkg.SweepService(fowt, cfg, **extra)
    tickets = [svc.submit(float(h), float(t), float(b))
               for h, t, b in zip(*cases)]     # before start: 2 batches
    svc.start()
    results = [t.result(WAIT) for t in tickets]
    repeat = [svc.submit(float(cases[0][i]), float(cases[1][i]),
                         float(cases[2][i])).result(WAIT) for i in (0, 5)]
    summary = svc.stop(timeout=WAIT)
    return results, repeat, summary


def test_service_matches_jax_service(design, depth, jax_fowt, cases,
                                     exec_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("RAFT_TPU_EXEC_CACHE_DIR", exec_dir)
    fowt = build_fowt(design, W, depth=depth, device="cpu")
    port, prep, psum = _serve(t_serve, fowt, cases, tmp_path / "port",
                              device="cpu")
    jax, jrep, jsum = _serve(j_serve, jax_fowt, cases, tmp_path / "jax")
    assert all(r.ok for r in port) and all(r.ok for r in jax)
    for p, j in zip(port, jax):
        _close(p.std, j.std)
        assert (p.iters, p.converged, p.seq, p.mode) == \
            (j.iters, j.converged, j.seq, j.mode)
    for k in ("admitted", "completed", "batches", "store_hits", "failed",
              "retries", "unhandled"):
        assert psum[k] == jsum[k], k
    assert psum["batches"] == 2 and psum["store_hits"] == 2
    # each served std is its batch's solve, bit for bit
    solver = make_case_solver(fowt)
    for b in range(2):
        sl = slice(b * NC, (b + 1) * NC)
        ref = solver.batched(*(c[sl] for c in cases))
        for i, r in enumerate(port[sl]):
            row = ref["std"][i].numpy()
            assert np.array_equal(np.asarray(r.std), row)
            assert r.digest == digest_metrics(
                {"std": row, "iters": int(ref["iters"][i]),
                 "converged": bool(ref["converged"][i])})
    # repeats come from the store, with the first answer's digest
    assert [r.source for r in prep] == ["cached", "cached"]
    assert [r.digest for r in prep] == [port[0].digest, port[5].digest]
    # a fresh service recovers every result from the journal, no solve
    calls = []

    def never(mode, fowt_, ncases, **kw):
        def run(*a):
            calls.append(a)
            raise AssertionError("recovery must not solve")
        run.ncases = ncases
        return run

    svc = SweepService(None, ServeConfig(
        batch_cases=NC, journal_dir=str(tmp_path / "port" / "wal")),
        runner_factory=never, device="cpu")
    info = svc.recover()
    assert info["recovered"] == 2 * NC and info["replayed"] == 0
    assert all(svc.fetch(r.digest).std == r.std for r in port)
    svc.stop(timeout=WAIT)
    assert calls == []
