"""The port's HTTP front door (``raft_tpu_torch.serve.http``).

A ``ThreadingHTTPServer`` on ``127.0.0.1:0`` over a stub-engine service
(no solves): ``/submit`` (202, then ``/result``), waiting submissions,
a 429 with ``Retry-After`` on admission rejection, 400 on a bad body,
``/result`` by id, digest and request digest, ``/stats``, ``/healthz``,
the Prometheus text page on ``/metrics``, ``/drain``, and the
``X-Raft-Trace`` context continued from the caller's header.  The
command line parses its ``serve`` arguments.  Every wait takes an
explicit timeout; the server threads are daemons.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu_torch import obs
from raft_tpu_torch.obs.tracing import TRACE_HEADER, TraceContext
from raft_tpu_torch.serve import ServeConfig, SweepService
from raft_tpu_torch.serve import journal as wal
from raft_tpu_torch.serve.http import make_serve_server

WAIT = 20.0


@pytest.fixture(autouse=True)
def _port_isolation():
    obs.reset_all()
    yield
    obs.reset_all()


def stub_factory(mode, fowt, ncases, **kw):
    def run(Hs, Tp, beta):
        Hs = np.asarray(Hs)
        return {"std": np.stack([np.full(6, float(h)) for h in Hs]),
                "iters": np.full(len(Hs), 3),
                "converged": np.ones(len(Hs), bool)}
    run.ncases = ncases
    return run


@pytest.fixture
def server(tmp_path):
    cfg = ServeConfig(queue_max=4, batch_cases=2, window_s=0.02,
                      batch_deadline_s=5.0, retry_base_s=0.01,
                      degrade_after=99, journal_dir=str(tmp_path / "wal"))
    svc = SweepService(runner_factory=stub_factory, config=cfg,
                       device="cpu")
    srv = make_serve_server(svc, "127.0.0.1", 0,
                            successor="http://next:1", deadline_s=10.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    host, port = srv.server_address[:2]
    yield svc, f"http://{host}:{port}"
    srv.shutdown()
    srv.server_close()
    svc.stop(timeout=WAIT)


def _call(url, doc=None, headers=None):
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if doc is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_submit_result_stats_healthz_metrics(server):
    svc, base = server
    svc.start()
    code, hdr, body = _call(base + "/submit", {"hs": 2.0, "tp": 9.0,
                                               "heading_deg": 30.0})
    assert code == 202
    doc = json.loads(body)
    assert TraceContext.parse(hdr[TRACE_HEADER]).trace_id == \
        doc["trace"]["trace_id"]
    code, _, body = _call(base + "/submit", {"hs": 3.0, "tp": 9.0,
                                             "wait": True})
    assert code == 200
    waited = json.loads(body)
    assert waited["ok"] and waited["std"] == [3.0] * 6
    for _ in range(200):
        code, _, body = _call(base + f"/result?id={doc['request_id']}")
        if code == 200:
            break
        assert code == 202
        threading.Event().wait(0.02)
    res = json.loads(body)
    assert res["ok"] and res["std"] == [2.0] * 6
    code, _, body = _call(base + f"/result?digest={res['digest']}")
    assert code == 200 and json.loads(body)["request_id"] == \
        doc["request_id"]
    rd = wal.request_digest(2.0, 9.0, np.radians(30.0))
    code, _, body = _call(base + f"/result?rdigest={rd}")
    assert code == 200 and json.loads(body)["digest"] == res["digest"]
    assert _call(base + "/result?id=nope")[0] == 404
    assert _call(base + "/result?digest=sha256:00")[0] == 404
    code, _, body = _call(base + "/stats")
    stats = json.loads(body)
    assert code == 200 and stats["completed"] == 2
    assert stats["journal_errors"] == 0
    code, _, body = _call(base + "/healthz")
    assert code == 200 and json.loads(body)["ok"] is True
    code, hdr, body = _call(base + "/metrics")
    text = body.decode()
    assert code == 200 and hdr["Content-Type"].startswith("text/plain")
    assert text.startswith("# raft_tpu exposition pid=")
    assert "# TYPE raft_tpu_serve_requests_total counter" in text
    assert 'raft_tpu_serve_requests_total{outcome="ok"} 2' in text
    assert _call(base + "/nowhere")[0] == 404


def test_trace_header_is_continued(server):
    svc, base = server
    svc.start()
    parent = TraceContext.mint()
    code, hdr, body = _call(base + "/submit",
                            {"hs": 1.5, "tp": 8.0, "wait": True},
                            headers={TRACE_HEADER: parent.to_header()})
    assert code == 200
    child = TraceContext.parse(hdr[TRACE_HEADER])
    assert child.trace_id == parent.trace_id
    assert child.span_id != parent.span_id
    trace = json.loads(body)["extra"]["provenance"]["trace"]
    assert trace["trace_id"] == parent.trace_id
    assert trace["span_id"] == child.span_id
    assert trace["parent_id"] == parent.span_id


def test_bad_body_rejection_and_drain(server):
    svc, base = server
    assert _call(base + "/submit", {"tp": 8.0})[0] == 400
    assert _call(base + "/submit", {"hs": 1.0, "tp": 8.0,
                                    "deadline_s": -1})[0] == 400
    assert _call(base + "/submit", {"hs": 1.0, "tp": 8.0,
                                    "tenant": "nobody"})[0] == 400
    assert _call(base + "/farm", {"layout": [[0, 0, 0]]})[0] == 400
    for i in range(4):                          # fill the queue pre-start
        assert _call(base + "/submit", {"hs": 1.0 + i, "tp": 8.0})[0] \
            == 202
    code, hdr, body = _call(base + "/submit", {"hs": 9.0, "tp": 8.0})
    assert code == 429 and int(hdr["Retry-After"]) >= 1
    assert json.loads(body)["reason"] == "queue_full"
    svc.start()
    code, _, body = _call(base + "/drain", {})
    doc = json.loads(body)
    assert code == 200 and doc["pending"] == [] and doc["next_seq"] == 4
    assert doc["successor"] == "http://next:1"


def test_command_line_parses_serve():
    from raft_tpu_torch.serve import __main__ as cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--help"])
    assert exc.value.code == 0
    with pytest.raises(SystemExit):
        cli.main(["soak"])
