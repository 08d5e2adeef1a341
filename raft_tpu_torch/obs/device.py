"""Device telemetry: what the card's allocator and the kernel build cache
did during a run.

The port's counterpart of ``raft_tpu/obs/device.py``.  Three probes, each
cheap and each degrading to an empty field where the API is missing (the
CPU has no device allocator):

- :func:`device_memory` — per CUDA device ``torch.cuda.mem_get_info``
  (free, total) and the caching allocator's ``memory_stats`` (bytes in
  use, peak, reserved), as ``raft_device_memory_bytes{device,stat}``;
- :func:`live_arrays_summary` — ``torch.cuda.memory_allocated`` /
  ``max_memory_allocated``: what Python still holds on the card (the
  JAX package counts ``jax.live_arrays()``; the allocator does not count
  tensors, so ``count`` is None);
- :func:`jit_cache_delta` — the kernel build cache's hits (loads of an
  already built library) and misses (nvcc builds) since the previous
  sample of the same scope.

:func:`collect` runs all three and puts them in
``manifest.extra["device_telemetry"]``.  The JAX package's
``cost_analysis`` (XLA's static HLO cost model) has no counterpart here.
"""
from __future__ import annotations

import threading

import torch

_LOCK = threading.Lock()
_LAST_CACHE: dict = {}     # previous build-cache sample, per scope


def _gauge(name, help):
    from raft_tpu_torch.obs import metrics as _metrics
    return _metrics.gauge(name, help)


def device_memory() -> list[dict]:
    """Per CUDA device: ``[{device, platform, stats}]`` where ``stats``
    holds ``free_bytes``, ``total_bytes`` (``mem_get_info``) and the
    allocator's ``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``; [] without CUDA."""
    if not torch.cuda.is_available():
        return []
    out = []
    g = _gauge("raft_device_memory_bytes",
               "per-device allocator stats (bytes_in_use, "
               "peak_bytes_in_use, bytes_limit) from memory_stats()")
    for i in range(torch.cuda.device_count()):
        name = f"cuda:{i}"
        try:
            free, total = torch.cuda.mem_get_info(i)
            ms = torch.cuda.memory_stats(i)
            stats = {"free_bytes": int(free), "total_bytes": int(total),
                     "bytes_limit": int(total),
                     "bytes_in_use": int(ms.get(
                         "allocated_bytes.all.current", 0)),
                     "peak_bytes_in_use": int(ms.get(
                         "allocated_bytes.all.peak", 0)),
                     "bytes_reserved": int(ms.get(
                         "reserved_bytes.all.current", 0))}
        except (RuntimeError, AssertionError):
            stats = None
        if stats:
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                      "bytes_reserved"):
                g.set(float(stats[k]), device=name, stat=k)
        out.append({"device": name, "platform": "gpu", "stats": stats})
    return out


def live_arrays_summary() -> dict | None:
    """``{count, total_bytes, peak_bytes}`` of the tensors the caching
    allocator holds on the current card (``count`` None: the allocator
    does not count tensors), or None without CUDA."""
    if not torch.cuda.is_available():
        return None
    total = int(torch.cuda.memory_allocated())
    summary = {"count": None, "total_bytes": total,
               "peak_bytes": int(torch.cuda.max_memory_allocated())}
    _gauge("raft_live_arrays_bytes",
           "bytes of the tensors the caching allocator holds on the "
           "card").set(total)
    return summary


def jit_cache_delta(scope: str = "run") -> dict:
    """Kernel build-cache hits and misses since the previous sample for
    ``scope`` (``first_sample`` True and None deltas on the first); a
    steady-state run has ``misses == 0``."""
    from raft_tpu_torch.obs import metrics as _metrics

    stats = _metrics.sample_jit_cache()
    with _LOCK:
        prev = _LAST_CACHE.get(scope)
        _LAST_CACHE[scope] = dict(stats)
    if prev is None:
        return {"hits": None, "misses": None, "first_sample": True,
                **{f"total_{k}": v for k, v in stats.items()}}
    delta = {"hits": stats["hits"] - prev["hits"],
             "misses": stats["misses"] - prev["misses"],
             **{f"total_{k}": v for k, v in stats.items()}}
    g = _gauge("raft_jit_cache_delta",
               "jit cache hit/miss delta since the previous sample "
               "(misses > 0 at steady state = recompile storm)")
    g.set(delta["hits"], kind="hits", scope=scope)
    g.set(delta["misses"], kind="misses", scope=scope)
    return delta


def reset_jit_cache_baseline():
    """Forget previous build-cache samples (test isolation)."""
    with _LOCK:
        _LAST_CACHE.clear()


def collect(manifest=None, scope: str = "run") -> dict:
    """One telemetry sample (device memory, live bytes, build-cache
    delta), folded into the registry and, when given,
    ``manifest.extra["device_telemetry"]``."""
    telemetry = {
        "devices": device_memory(),
        "live_arrays": live_arrays_summary(),
        "jit_cache": jit_cache_delta(scope=scope),
    }
    if manifest is not None:
        manifest.extra["device_telemetry"] = telemetry
    return telemetry
