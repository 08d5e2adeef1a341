"""Typed/shaped/defaulted access into nested design dictionaries.

Equivalent in behavior to the reference's getFromDict (reference:
raft/helpers.py:697-775) and a copy of ``raft_tpu/utils/dicttools.py``:
scalar tiling, 1-D length checking, 2-D row-broadcast, per-member
``index`` extraction, and required-key errors.  Pure host-side NumPy,
model build time only.
"""
from __future__ import annotations

import numpy as np

_MISSING = object()


def get_from_dict(d, key, shape=0, dtype=float, default=_MISSING, index=None):
    if key in d:
        val = d[key]
        if shape == 0:
            if np.isscalar(val):
                return dtype(val)
            raise ValueError(f"Value for key '{key}' must be scalar, got: {val}")
        if shape == -1:
            if np.isscalar(val):
                return dtype(val)
            return np.array(val, dtype=dtype)
        if np.isscalar(val):
            return np.tile(dtype(val), shape)
        if np.isscalar(shape):  # expecting 1-D of length `shape`
            if len(val) != shape:
                raise ValueError(
                    f"Value for key '{key}' is not the expected size {shape}: {val}")
            if index is not None:
                arr = np.array(val)
                if arr.ndim == 1:
                    if index not in range(arr.shape[0]):
                        raise ValueError(
                            f"Index '{index}' out of range for {val} (len={arr.shape[0]})")
                    return np.tile(dtype(val[index]), shape)
                if index not in range(arr.shape[1]):
                    raise ValueError(
                        f"Index '{index}' out of range for {val}")
                return np.array([dtype(v[index]) for v in val])
            return np.array([dtype(v) for v in val])
        # multi-dimensional target
        arr = np.array(val, dtype=dtype)
        if list(arr.shape) == list(shape):
            return arr
        if len(shape) > 2:
            raise ValueError("get_from_dict supports at most 2-D shapes")
        if arr.ndim == 1 and len(arr) == shape[1]:
            return np.tile(arr, [shape[0], 1])
        raise ValueError(
            f"Value for key '{key}' incompatible with target shape {shape}: {val}")
    # defaults
    if default is _MISSING or default is None:
        raise ValueError(f"Key '{key}' not found in input design...")
    if shape in (0, -1):
        return default
    if np.isscalar(default):
        return np.tile(default, shape)
    return np.tile(default, [shape, 1])
