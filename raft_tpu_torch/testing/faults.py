"""Deterministic fault injection at the solver's seams.

A copy of ``raft_tpu/testing/faults.py`` (the port never imports the JAX
package): the ``RAFT_TPU_FAULTS`` environment variable, or a programmatic
:func:`install`, turns into deterministic failures at the seams the port's
code exposes, so every path of the recovery layer can be driven on the
CPU and on the card.  The grammar is the JAX package's, sites and
actions included; the port fires these sites:

==========  ===========================================================
site        seam
==========  ===========================================================
statics     ``Model.solveStatics`` after the Newton solve
dynamics    ``Model._fowt_linearize`` after the drag fixed point
kernel      ``ops.linalg.impedance_solve``, before any launch
sweep       ``parallel.sweep.sweep_cases`` after the batched solve
checkpoint  ``serve.checkpoint.CheckpointStore`` reads and writes
optimize    ``parallel.optimize`` segmented descent, at each segment
            boundary (``kill``: ``os._exit(137)``; ``hang``: park)
serve       ``serve.service`` batch worker, per request before the solve
            (``raise``, ``hang``, ``kill``)
journal     ``serve.journal`` WAL writes (``torn``, ``enospc``)
replica     ``serve.replica`` WAL mirroring (``drop``, ``lag``)
resultstore ``serve.resultstore`` reads and writes (``corrupt``,
            ``stale``, ``enospc``, ``eio``)
==========  ===========================================================

The other sites of the grammar (``exec_cache``, ``fleet``) parse as they
do in the JAX package; nothing in the port fires them yet.

Spec grammar (comma-separated specs)::

    RAFT_TPU_FAULTS="<action>@<site>[:qualifier]*[,...]"

    action     nan | raise | corrupt | hang | kill | torn | drop | lag
               | stale | enospc | eio
    qualifier  case=N | lane=N | fowt=N | req=N | part=N | entry=HEX
               | step=N | replica=N | once | times=K | s=SECONDS
               | ms=MILLIS

``nan@dynamics:case=2`` poisons case 2's converged impedance with NaN;
``raise@kernel:case=0:once`` makes case 0's first impedance solve raise
an injected ``KernelFailure`` before it launches anything;
``nan@sweep:lane=K`` poisons lane K of a sweep; ``corrupt@checkpoint``
damages every checkpoint read.  Malformed specs and action/site pairs no
seam implements are dropped at parse time.  Matching facts come from the
seam's keyword arguments plus the ambient :func:`context` stack
(``Model.analyzeCases`` pushes ``case=...`` around each case, so the
kernel seam matches per-case specs).  A ``once`` / ``times=K`` budget is
spent once per matching seam call, whichever ladder rung makes it.
"""
from __future__ import annotations

import contextlib
import os
import threading

from raft_tpu_torch import errors

_LOCK = threading.Lock()
#: programmatic override (None -> parse the env var per call)
_OVERRIDE: list | None = None
#: fire counts keyed by spec identity, shared env/override
_FIRED: dict[tuple, int] = {}
#: ambient matching context (case/fowt/lane), host-single-threaded
_CONTEXT: list[dict] = []

_ACTIONS = ("nan", "raise", "corrupt", "hang", "kill", "torn", "drop",
            "lag", "stale", "enospc", "eio")
_SITES = ("statics", "dynamics", "kernel", "sweep", "exec_cache",
          "serve", "journal", "replica", "resultstore", "optimize",
          "checkpoint", "fleet")

#: exception class raised per site for ``raise@<site>`` specs
_RAISES = {
    "statics": errors.StaticsDivergence,
    "dynamics": errors.DynamicsSingular,
    "kernel": errors.KernelFailure,
    "sweep": errors.KernelFailure,
    "serve": errors.KernelFailure,
}

#: (action, site) pairs with no seam behaviour, dropped at parse time so a
#: spec never silently no-ops while spending its fire budget (the JAX
#: package's table, rule for rule)
_UNSUPPORTED = {("raise", "exec_cache"), ("corrupt", "statics"),
                ("corrupt", "dynamics"), ("corrupt", "kernel"),
                ("corrupt", "sweep"), ("corrupt", "serve"),
                ("nan", "exec_cache"), ("nan", "kernel"),
                ("nan", "serve"),
                ("hang", "statics"), ("hang", "dynamics"),
                ("hang", "kernel"), ("hang", "sweep"),
                ("hang", "exec_cache")}
_UNSUPPORTED |= {("kill", s) for s in _SITES
                 if s not in ("serve", "optimize", "fleet")}
_UNSUPPORTED |= {(a, "fleet") for a in _ACTIONS if a != "kill"}
_UNSUPPORTED |= {("torn", s) for s in _SITES if s != "journal"}
_UNSUPPORTED |= {(a, "journal") for a in _ACTIONS
                 if a not in ("torn", "enospc")}
_UNSUPPORTED |= {("drop", s) for s in _SITES if s != "replica"}
_UNSUPPORTED |= {("lag", s) for s in _SITES if s != "replica"}
_UNSUPPORTED |= {(a, "replica") for a in _ACTIONS
                 if a not in ("drop", "lag")}
_UNSUPPORTED |= {("stale", s) for s in _SITES if s != "resultstore"}
_UNSUPPORTED |= {(a, "resultstore") for a in _ACTIONS
                 if a not in ("corrupt", "stale", "enospc", "eio")}
_UNSUPPORTED |= {("enospc", s) for s in _SITES
                 if s not in ("journal", "resultstore", "exec_cache",
                              "checkpoint")}
_UNSUPPORTED |= {("eio", s) for s in _SITES
                 if s not in ("resultstore", "checkpoint")}
_UNSUPPORTED |= {(a, "optimize") for a in _ACTIONS
                 if a not in ("kill", "hang")}
_UNSUPPORTED |= {(a, "checkpoint") for a in _ACTIONS
                 if a not in ("corrupt", "enospc", "eio")}

#: default stall of a ``hang`` spec without an ``s=`` / ``ms=`` qualifier
_DEFAULT_HANG_S = 30.0
#: default deferral of a ``lag`` spec without an ``s=`` / ``ms=`` qualifier
_DEFAULT_LAG_S = 2.0


def _parse_one(spec: str) -> dict | None:
    head, _, quals = spec.strip().partition(":")
    action, _, site = head.partition("@")
    action = action.strip().lower()
    site = site.strip().lower()
    if action not in _ACTIONS or site not in _SITES \
            or (action, site) in _UNSUPPORTED:
        return None
    fault = {"action": action, "site": site, "match": {}, "times": None,
             "spec": spec.strip()}
    if action == "hang":
        fault["hang_s"] = _DEFAULT_HANG_S
    elif action == "lag":
        fault["lag_s"] = _DEFAULT_LAG_S
    for q in filter(None, (s.strip() for s in quals.split(":"))):
        if q == "once":
            fault["times"] = 1
        elif q.startswith("times="):
            try:
                fault["times"] = int(q[6:])
            except ValueError:
                return None          # malformed spec: drop, never crash
        elif q.startswith("s=") or q.startswith("ms="):
            try:
                val = float(q.split("=", 1)[1])
            except ValueError:
                return None
            dur = val / 1000.0 if q.startswith("ms=") else val
            fault["lag_s" if action == "lag" else "hang_s"] = dur
        elif "=" in q:
            k, v = q.split("=", 1)
            try:
                fault["match"][k.strip()] = int(v)
            except ValueError:
                fault["match"][k.strip()] = v.strip()
    return fault


def parse(spec: str) -> list[dict]:
    """Parse a ``RAFT_TPU_FAULTS`` value; malformed specs are dropped."""
    return [f for f in (_parse_one(s) for s in spec.split(",") if s.strip())
            if f is not None]


def install(spec: str | None):
    """Set the active fault specs programmatically (None returns control
    to the environment variable) and reset the fire counts."""
    global _OVERRIDE
    with _LOCK:
        _OVERRIDE = None if spec is None else parse(spec)
        _FIRED.clear()


def clear():
    """Remove all programmatic faults and forget the fire counts."""
    install(None)


#: parse cache of the environment path, keyed by the raw spec string
_ENV_CACHE: tuple[str, list] = ("", [])


def _active() -> list[dict]:
    global _ENV_CACHE
    with _LOCK:
        if _OVERRIDE is not None:
            return list(_OVERRIDE)
        env = os.environ.get("RAFT_TPU_FAULTS", "").strip()
        if env != _ENV_CACHE[0]:
            _ENV_CACHE = (env, parse(env) if env else [])
        return list(_ENV_CACHE[1])


def any_active() -> bool:
    """Cheap guard for seams that would otherwise call :func:`fire` in a
    loop."""
    return bool(_active())


@contextlib.contextmanager
def context(**ctx):
    """Push ambient matching facts (``case=...``) for seams that cannot
    receive them as arguments."""
    _CONTEXT.append({k: v for k, v in ctx.items() if v is not None})
    try:
        yield
    finally:
        _CONTEXT.pop()


def _ambient() -> dict:
    out = {}
    for frame in _CONTEXT:
        out.update(frame)
    return out


def fire_info(site: str, action: str = None, **ctx) -> dict | None:
    """The first active fault matching ``site`` and the (explicit +
    ambient) context, honouring ``once`` / ``times=``; None when nothing
    matches.  ``action`` restricts matching to specs of that action, so
    a seam that implements one action spends no other spec's budget."""
    faults = _active()
    if not faults:
        return None
    facts = _ambient()
    facts.update({k: v for k, v in ctx.items() if v is not None})
    for f in faults:
        if f["site"] != site:
            continue
        if action is not None and f["action"] != action:
            continue
        if any(facts.get(k) != v for k, v in f["match"].items()):
            continue
        key = (f["spec"],)
        with _LOCK:
            n = _FIRED.get(key, 0)
            if f["times"] is not None and n >= f["times"]:
                continue
            _FIRED[key] = n + 1
        return dict(f)
    return None


def fire(site: str, **ctx) -> str | None:
    """The action of :func:`fire_info`'s match, or None."""
    f = fire_info(site, **ctx)
    return None if f is None else f["action"]


def maybe_raise(site: str, **ctx):
    """Raise the site's mapped typed exception (``injected=True``) when a
    ``raise@<site>`` fault matches; return the action of any other match
    (``nan``) for the seam to apply, else None."""
    action = fire(site, **ctx)
    if action == "raise":
        cls = _RAISES.get(site, errors.FaultInjected)
        merged = _ambient()
        merged.update({k: v for k, v in ctx.items() if v is not None})
        raise cls(f"injected fault at {site}", injected=True, **merged)
    return action


def corrupt_bytes(site: str, data: bytes, **ctx) -> bytes:
    """Deterministically damage ``data`` when a ``corrupt@<site>`` fault
    matches (first byte flipped, the last 16 bytes cut); unchanged
    otherwise."""
    if fire(site, **ctx) == "corrupt":
        if not data:
            return b"\x00"
        head = bytes([data[0] ^ 0xFF])
        return head + data[1: max(1, len(data) - 16)]
    return data
