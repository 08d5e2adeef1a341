"""Content digests of models.

Of ``raft_tpu/parallel/exec_cache.py`` only `model_digest` for now: the
content address that keys the case journal (``recovery.CaseJournal``) and
guards the chunks of ``sweep.sweep_cases_chunked``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch.ledger import digest_metrics


def _leaf(arr) -> np.ndarray:
    """A host array; complex values as their (real, imaginary) pairs,
    which the ledger's digest can take."""
    a = np.asarray(arr)
    if np.iscomplexobj(a):
        a = np.stack([a.real, a.imag], axis=-1)
    return a


def _flatten(obj, path: str, out: dict, tensors: dict):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        out[path] = "None" if obj is None else obj
    elif isinstance(obj, complex):
        out[path] = [obj.real, obj.imag]
    elif isinstance(obj, torch.Tensor):
        # read later, every tensor of the tree in one host pull
        t = obj.detach()
        if t.is_complex():
            t = torch.view_as_real(t.resolve_conj())
        tensors[path] = t
        out[path] = None
        out[path + ".meta"] = None
    elif hasattr(obj, "__array__") and not isinstance(obj, type):
        arr = _leaf(obj)
        out[path] = arr.ravel()
        out[path + ".meta"] = f"{tuple(arr.shape)}:{arr.dtype}"
    elif callable(obj):
        out[path] = ("callable:"
                     + getattr(obj, "__qualname__", type(obj).__name__))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _flatten(getattr(obj, f.name), f"{path}.{f.name}", out, tensors)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _flatten(obj[k], f"{path}[{k}]", out, tensors)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(v, f"{path}[{i}]", out, tensors)
    else:
        out[path] = f"{type(obj).__module__}.{type(obj).__qualname__}"


def model_digest(obj) -> str:
    """``sha256:<hex>`` of a model pytree (a FOWTModel, a dict of them and
    of settings, ...) by value: every tensor or array leaf read to the
    host (the tensors in one counted pull, ``obs.transfers.device_get``)
    and digested at full precision through ``ledger.digest_metrics``,
    with its shape and dtype.  Complex leaves digest as (real, imaginary)
    pairs."""
    from raft_tpu_torch.obs import transfers

    flat: dict = {}
    tensors: dict = {}
    _flatten(obj, "", flat, tensors)
    if tensors:
        host = transfers.device_get(tensors, what="model_digest")
        for path, arr in host.items():
            flat[path] = arr.ravel()
            flat[path + ".meta"] = f"{tuple(arr.shape)}:{arr.dtype}"
    return digest_metrics(flat)
