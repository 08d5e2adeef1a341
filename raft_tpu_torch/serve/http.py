"""The HTTP front door of the sweep service.

The port of ``tools/raftserve.py:make_serve_server``: a
``ThreadingHTTPServer`` over a :class:`~raft_tpu_torch.serve.SweepService`
with the JAX package's routes, bodies and status codes:

==============  =====================================================
route           answer
==============  =====================================================
POST /submit    ``{"hs", "tp", "heading_deg" | "heading_rad",
                "tenant", "deadline_s", "wait"}`` -> 202 ``{request_id,
                seq, trace}`` (200 and the result with ``"wait": true``);
                admission rejection -> 429 with ``Retry-After``
POST /optimize  a design-optimization spec (``submit_optimize``)
POST /farm      a farm spec (``submit_farm``)
POST /drain     graceful handoff, then the server shuts down
POST /recover   ``{"journal_dir"}``: fold a peer's WAL into this service
GET  /result    ``?id=`` (404 unknown, 202 pending), ``?digest=``,
                ``?rdigest=``
GET  /stats     the service summary
GET  /healthz   liveness and the service counters
GET  /metrics   the Prometheus text page of this process
==============  =====================================================

Every answer to a submission carries the ``X-Raft-Trace`` header of the
request's trace context, continued from the caller's header when it sent
one.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from raft_tpu_torch import errors
from raft_tpu_torch.obs.tracing import TRACE_HEADER


def make_serve_server(service, host: str = "127.0.0.1", port: int = 0, *,
                      successor: str = None, deadline_s: float = 60.0,
                      tickets_max: int = 1024) -> ThreadingHTTPServer:
    """The ``ThreadingHTTPServer`` over ``service`` (see the module
    docstring; not started).  ``port=0`` binds a free port
    (``server.server_address``).  The server carries ``track_ticket``
    (bounded-FIFO ticket registration, used after journal recovery) as
    an attribute."""
    # bounded FIFO, like SweepService._delivered: an always-on process
    # must not keep one ticket per request forever
    tickets: collections.OrderedDict[str, object] = \
        collections.OrderedDict()

    def _track(t):
        tickets[t.id] = t
        while len(tickets) > tickets_max:
            tickets.popitem(last=False)

    def _read_json(handler) -> dict:
        n = int(handler.headers.get("Content-Length") or 0)
        doc = json.loads(handler.rfile.read(n) or b"{}")
        if not isinstance(doc, dict):
            raise ValueError("body must be a JSON object")
        return doc

    def _deadline(value):
        if value is None:
            return None
        value = float(value)
        if not (value > 0.0):
            raise ValueError("deadline_s must be > 0")
        return value

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                     # pragma: no cover
            pass

        def _send(self, code: int, doc: dict, headers: dict = None):
            data = json.dumps(doc, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _reject(self, e: errors.AdmissionRejected):
            self._send(429, e.context(), headers={
                "Retry-After": f"{max(1, round(e.retry_after_s))}"})

        def _answer(self, t, wait: bool, deadline_req):
            """202 with the ticket, or 200 with the result when the
            caller waits (504 past the deadline)."""
            _track(t)
            thdr = {TRACE_HEADER: t.trace.to_header()} if t.trace else {}
            if wait:
                try:
                    res = t.result((deadline_req or deadline_s) + 5.0)
                except errors.DeadlineExceeded as e:
                    self._send(504, e.context())
                    return
                self._send(200, res.to_dict(), headers=thdr)
            else:
                self._send(202, {"request_id": t.id, "seq": t.seq,
                                 "trace": (t.trace.as_dict()
                                           if t.trace else None)},
                           headers=thdr)

        def do_GET(self):                              # noqa: N802
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/healthz":
                self._send(200, {"ok": True, "pid": os.getpid(),
                                 **service.stats()})
            elif url.path == "/stats":
                self._send(200, service.summary())
            elif url.path == "/metrics":
                from raft_tpu_torch.obs import metrics as M
                data = M.exposition().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif url.path == "/result":
                digest = q.get("digest", [None])[0]
                rdigest = q.get("rdigest", [None])[0]
                rid = q.get("id", [None])[0]
                if digest or rdigest:
                    res = (service.fetch(digest) if digest
                           else service.fetch_rdigest(rdigest))
                    if res is None:
                        self._send(404, {"error": "unknown digest"})
                    else:
                        self._send(200, res.to_dict())
                    return
                t = tickets.get(rid)
                if t is None:
                    self._send(404, {"error": "unknown request id"})
                elif not t.done():
                    self._send(202, {"request_id": rid,
                                     "status": "pending"})
                else:
                    self._send(200, t.result(0.0).to_dict())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):                             # noqa: N802
            if self.path == "/drain":
                # graceful handoff: flush or journal everything, answer
                # with the handoff manifest, then shut down
                self._send(200, service.drain(successor=successor))
                threading.Thread(target=srv.shutdown, daemon=True).start()
                return
            if self.path == "/recover":
                try:
                    src = str(_read_json(self)["journal_dir"])
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    info = service.recover(src)
                except errors.ModelConfigError as e:
                    self._send(400, e.context())
                    return
                for t in info["tickets"].values():
                    _track(t)
                self._send(200, {k: info.get(k) for k in
                                 ("recovered", "replayed", "deduped",
                                  "corrupt", "ckpt_records", "mirror")})
                return
            if self.path in ("/optimize", "/farm"):
                try:
                    doc = _read_json(self)
                    tenant = str(doc.pop("tenant", "default"))
                    wait = doc.pop("wait", False)
                    deadline_req = _deadline(doc.pop("deadline_s", None))
                except (KeyError, TypeError, ValueError,
                        json.JSONDecodeError) as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                submit = (service.submit_farm if self.path == "/farm"
                          else service.submit_optimize)
                try:
                    t = submit(doc, deadline_s=deadline_req, tenant=tenant,
                               trace=self.headers.get(TRACE_HEADER))
                except errors.AdmissionRejected as e:
                    self._reject(e)
                    return
                except errors.ModelConfigError as e:
                    self._send(400, e.context())
                    return
                self._answer(t, wait, deadline_req)
                return
            if self.path != "/submit":
                self._send(404, {"error": "not found"})
                return
            try:
                doc = _read_json(self)
                hs = float(doc["hs"])
                tp = float(doc["tp"])
                beta = (math.radians(float(doc["heading_deg"]))
                        if "heading_deg" in doc
                        else float(doc.get("heading_rad", 0.0)))
                tenant = str(doc.get("tenant", "default"))
                deadline_req = _deadline(doc.get("deadline_s"))
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                # the tenant rides the submission: the journaled rdigest
                # is tenant-salted
                t = service.submit(hs, tp, beta, deadline_s=deadline_req,
                                   tenant=tenant,
                                   trace=self.headers.get(TRACE_HEADER))
            except errors.AdmissionRejected as e:
                self._reject(e)
                return
            except errors.ModelConfigError as e:
                # unknown tenant: this process does not carry the model
                self._send(400, e.context())
                return
            self._answer(t, bool(doc.get("wait")), deadline_req)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.daemon_threads = True
    srv.track_ticket = _track
    return srv
