"""Probes: live solver-health samples on their own counted budget.

The port's counterpart of ``raft_tpu/obs/probes.py``.  The JAX package
plants a ``jax.debug.callback`` inside jitted code; eager PyTorch has no
such channel, and a read of a card tensor is a host pull.  So a probe
here records host values that a sanctioned pull (``obs.transfers.
device_get``) already brought back — the statics Newton's iteration count
and residual, each drag pass's convergence, a sweep batch's lane flags —
and never reads a tensor itself: a tensor handed to :func:`probe` is
recorded by its shape alone.  The host-transfer count is therefore the
same under every probe mode.

Knob (``_config.probes_mode``): ``RAFT_TPU_PROBES`` =

- ``off`` — :func:`probe` records nothing;
- ``sampled`` (default) — the sites the JAX package samples:
  ``statics_newton`` (one sample a Newton solve), ``drag_fixed_point``
  (one a drag pass), ``sweep_lanes`` (one a sweep batch);
- ``full`` — also the sites tagged ``level="full"``.

Each sample counts in ``raft_tpu_probe_events_total{probe}`` (the probes'
own budget, apart from ``raft_tpu_host_transfers_total``), sets
``raft_tpu_probe_value{probe,field}`` for its scalar fields and goes to
the flight recorder as a ``probe`` event.  Probes never alter numerics.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from raft_tpu_torch import _config

_LEVELS = {"off": 0, "sampled": 1, "full": 2}

_LOCAL = threading.local()


def mode() -> str:
    """Active probe mode ("off" | "sampled" | "full")."""
    return _config.probes_mode()


def enabled(level: str = "sampled") -> bool:
    """Would a probe at ``level`` record right now?  False inside
    :func:`suppress` blocks regardless of mode."""
    if getattr(_LOCAL, "suppressed", 0) > 0:
        return False
    return _LEVELS.get(mode(), 0) >= _LEVELS.get(str(level), 1)


class suppress:
    """Context manager that turns probes off for the code inside it."""

    def __init__(self, why: str = ""):
        self.why = str(why)

    def __enter__(self):
        _LOCAL.suppressed = getattr(_LOCAL, "suppressed", 0) + 1
        return self

    def __exit__(self, *exc):
        _LOCAL.suppressed = max(0, getattr(_LOCAL, "suppressed", 1) - 1)
        return False


def probe(name: str, level: str = "sampled", **values):
    """Record one sample of host ``values`` (numbers or numpy arrays)
    under probe ``name`` when the mode admits ``level``.  Never pulls
    from the card, never raises, never changes a value."""
    if not enabled(level):
        return
    _record(name, values)


def _summarize(v):
    """Payload shaping: scalars pass through, small arrays become lists,
    large ones {n, finite, min, max}; a tensor is recorded by its shape
    (reading it would be a host pull)."""
    if isinstance(v, torch.Tensor):
        return {"tensor": list(v.shape)}
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    if arr.size <= 32:
        return arr.tolist()
    if np.issubdtype(arr.dtype, np.floating):
        finite_mask = np.isfinite(arr)
        finite = arr[finite_mask]
        return {"n": int(arr.size), "finite": int(finite_mask.sum()),
                "min": float(finite.min()) if finite.size else None,
                "max": float(finite.max()) if finite.size else None}
    return {"n": int(arr.size), "finite": int(arr.size),
            "min": float(arr.min()) if arr.size else None,
            "max": float(arr.max()) if arr.size else None}


def _record(name: str, host_values: dict):
    try:
        from raft_tpu_torch.obs import events as _events
        from raft_tpu_torch.obs import metrics as _metrics

        _metrics.counter(
            "raft_tpu_probe_events_total",
            "probe samples recorded from values a sanctioned pull "
            "brought back, by probe name (the probes' own budget, apart "
            "from raft_tpu_host_transfers_total)").inc(1.0,
                                                      probe=str(name))
        fields = {}
        for k, v in host_values.items():
            s = _summarize(v)
            fields[k] = s
            if isinstance(s, (int, float)) and not isinstance(s, bool):
                _metrics.gauge(
                    "raft_tpu_probe_value",
                    "most recent scalar value per probe field"
                    ).set(float(s), probe=str(name), field=str(k))
        _events.emit("probe", probe=str(name), values=fields)
    # a probe is telemetry: it never fails the solve it watches
    except Exception:                                # pragma: no cover
        pass
