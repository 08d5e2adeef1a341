"""Command line of the port's sweep service.

    python -m raft_tpu_torch.serve serve --design VolturnUS-S \\
        [--device cpu] [--port 8765] [--journal-dir DIR] [--store-dir DIR]

The port of ``tools/raftserve.py serve``: builds the design's FOWT on the
device (the card unless ``--device cpu``; no card raises), its
decimated-grid sibling for the ``coarse`` rung, a
:class:`~raft_tpu_torch.serve.SweepService` and its HTTP front door
(:mod:`raft_tpu_torch.serve.http`).  A journal left in ``--journal-dir``
by a predecessor (killed or drained) is recovered before the worker
starts, then ``--recover-from`` (a peer's WAL mirror).  SIGTERM drains
(handoff manifest, pending WAL records); Ctrl-C stops and prints the
serve summary.  The soak, router, fleet and distill subcommands are not
ported yet (ROADMAP A10).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

import numpy as np


def build_fowt(design: str, min_freq: float = 0.05, max_freq: float = 0.5,
               dfreq: float = 0.05, device=None):
    """The served model: ``design`` (a vendored name) on the grid
    ``arange(min_freq, max_freq, dfreq)`` [Hz], on ``device`` (the JAX
    package's ``serve.soak.build_fowt`` recipe)."""
    from raft_tpu_torch._config import resolve_device
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.models.fowt import build_fowt as _build

    d = load_design(design)
    w = np.arange(min_freq, max_freq, dfreq) * 2.0 * np.pi
    return _build(d, w, depth=float(d["site"]["water_depth"]),
                  device=resolve_device(device))


def _add_model_args(p):
    p.add_argument("--design", default="Vertical_cylinder",
                   help="vendored design name")
    p.add_argument("--min-freq", type=float, default=0.05)
    p.add_argument("--max-freq", type=float, default=0.5)
    p.add_argument("--dfreq", type=float, default=0.05)
    p.add_argument("--batch", type=int, default=4,
                   help="fixed case-batch size of the warm runner")
    p.add_argument("--queue-max", type=int, default=None,
                   help="admission queue watermark")
    p.add_argument("--coarse", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="build the decimated-grid model for the "
                        "'coarse' degradation rung")
    p.add_argument("--device", default=None,
                   help="device to solve on (default: the card; 'cpu' "
                        "for the plain versions)")


def cmd_serve(args) -> int:
    from raft_tpu_torch.serve import ServeConfig, SweepService
    from raft_tpu_torch.serve import journal as wal
    from raft_tpu_torch.serve.http import make_serve_server

    fowt = build_fowt(args.design, args.min_freq, args.max_freq,
                      args.dfreq, args.device)
    coarse = (build_fowt(args.design, args.min_freq, args.max_freq,
                         args.dfreq * 2.0, args.device)
              if args.coarse else None)
    cfg_kw = dict(nIter=args.niter, tol=args.tol, fp_chunk=args.fp_chunk,
                  batch_cases=args.batch, deadline_s=args.deadline,
                  batch_deadline_s=args.batch_deadline,
                  journal_dir=args.journal_dir,
                  mirror_dirs=tuple(args.mirror_dir or ()),
                  ckpt_dir=args.ckpt_dir,
                  checkpoint_every=args.checkpoint_every,
                  store_dir=args.store_dir,
                  warm_start=bool(args.warm_start))
    if args.queue_max is not None:
        cfg_kw["queue_max"] = args.queue_max
    cfg = ServeConfig(**cfg_kw)
    service = SweepService(
        fowt, cfg, degraded_fowts={"coarse": coarse} if coarse else None,
        device=args.device)
    srv = make_serve_server(service, args.host, args.port,
                            successor=args.successor,
                            deadline_s=cfg.deadline_s)
    # the own journal first (its pending requests keep their seqs), then
    # a foreign mirror
    sources = []
    if args.journal_dir and \
            os.path.exists(wal.journal_path(args.journal_dir)):
        sources.append(args.journal_dir)
    if args.recover_from:
        sources.append(args.recover_from)
    for src in sources:
        info = service.recover(src)
        for t in info["tickets"].values():
            srv.track_ticket(t)
        print(f"raft_tpu_torch.serve: journal recovery from {src}"
              f"{' (mirror/failover)' if info['mirror'] else ''}: "
              f"{info['recovered']} result(s) restored, "
              f"{info['replayed']} request(s) replayed, "
              f"{info['deduped']} deduped, "
              f"{info['corrupt']} corrupt line(s) skipped", flush=True)
    service.start()
    host, port = srv.server_address[:2]

    def _on_sigterm(signum, frame):                    # pragma: no cover
        # drain on a side thread (a signal handler must not block), then
        # stop accepting connections
        def _drain():
            service.drain(successor=args.successor)
            srv.shutdown()
        threading.Thread(target=_drain, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    print(f"raft_tpu_torch.serve: http://{host}:{port}/ (submit, optimize, "
          f"farm, result, drain, recover, stats, healthz, metrics; "
          f"design={args.design}, device={service.device}, "
          f"batch={cfg.batch_cases}, ladder={'->'.join(service.ladder)}, "
          f"journal={args.journal_dir or 'off'})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:                          # pragma: no cover
        pass
    finally:
        srv.server_close()
        summary = service.stop()
        print(json.dumps(summary, indent=1, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.serve",
        description="the sweep service's command line (port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("serve", help="HTTP endpoint over SweepService")
    _add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--deadline", type=float, default=120.0,
                   help="default per-request deadline (s)")
    p.add_argument("--batch-deadline", type=float, default=60.0,
                   help="watchdog deadline per in-flight batch (s)")
    p.add_argument("--niter", type=int, default=10,
                   help="drag fixed-point iterations")
    p.add_argument("--tol", type=float, default=0.01,
                   help="fixed-point convergence tolerance")
    p.add_argument("--fp-chunk", type=int, default=2,
                   help="fixed-point passes between convergence checks")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint-store directory for descents")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="descent steps per checkpointed segment "
                        "(0 = off; needs --ckpt-dir)")
    p.add_argument("--journal-dir", default=None,
                   help="write-ahead request journal directory; a "
                        "journal left by a predecessor is recovered "
                        "on boot")
    p.add_argument("--mirror-dir", action="append", default=None,
                   help="peer directory the WAL mirrors to (repeat "
                        "for several peers)")
    p.add_argument("--recover-from", default=None,
                   help="replay a foreign journal or mirror directory "
                        "at boot while journaling into --journal-dir")
    p.add_argument("--successor", default=None,
                   help="where a drain points rejected callers")
    p.add_argument("--store-dir", default=None,
                   help="persistent content-addressed result store")
    p.add_argument("--warm-start", action="store_true",
                   help="seed cache-miss solves from the nearest "
                        "cold-solved store neighbour (needs "
                        "--store-dir)")
    p.set_defaults(fn=cmd_serve)
    args = ap.parse_args(argv)
    return int(args.fn(args))


if __name__ == "__main__":
    sys.exit(main())
