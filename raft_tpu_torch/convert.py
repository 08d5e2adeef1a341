"""Carry built state across: numpy trees -> the port's dataclasses on a
device.

RAFT has no weights; its state is the built design (member geometry, the
stacked strip-node set, rotor tables, the mooring system) and the
per-case constants computed from it.  :func:`state_from_numpy` turns a
nested dict / list / dataclass of numpy arrays — the port's own build
output, or the JAX package's objects (matched by class and field name,
arrays taken through ``np.asarray``) — into the port's dataclasses with
tensors on ``device``, so two implementations can compute from identical
state.  The port never imports the JAX package to do this.

A few small rotor fields are read on the host by numpy code (the
operating schedule and control gains through ``np.interp``, the RNA
offset in the output statistics) and stay numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raft_tpu_torch._config import COMPLEX, REAL

#: fields kept as host numpy arrays, by class name
HOST_FIELDS = {
    "RotorModel": {"r_rel", "azimuths", "Uhub_ops", "Omega_rpm_ops",
                   "pitch_deg_ops", "kp_0", "ki_0", "q_rel0", "Ca_interp",
                   "r_thick_interp", "aoa_grid"},
    # a QTF read from a .12d file: host numpy, interpolated per case
    "QTFData": {"heads_rad", "w", "qtf"},
    # the BEM headings are searched on the host (io/wamit.bem_excitation)
    "BEMData": {"headings"},
    # the topology of a free-point mooring indexes on the host
    "ArrayMooring": {"attach", "free_idx", "iA", "iB", "contact_ok"},
}


def _port_classes():
    from raft_tpu_torch.io.wamit import BEMData
    from raft_tpu_torch.models.fowt import FOWTModel, NodeSet
    from raft_tpu_torch.models.member import MemberGeometry
    from raft_tpu_torch.models.mooring import MooringSystem
    from raft_tpu_torch.models.mooring_array import ArrayMooring
    from raft_tpu_torch.models.qtf import QTFData
    from raft_tpu_torch.models.rotor import RotorModel
    return {c.__name__: c for c in (ArrayMooring, BEMData, FOWTModel,
                                    NodeSet, MemberGeometry, MooringSystem,
                                    QTFData, RotorModel)}


def _array(x, device):
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    if np.iscomplexobj(a):
        return torch.as_tensor(a, dtype=COMPLEX, device=device)
    return torch.as_tensor(a, dtype=REAL, device=device)


def state_from_numpy(tree, device="cpu", _host=False):
    """Convert ``tree`` (dict / list / tuple / dataclass of numpy arrays
    and python scalars) to the port's dataclasses with float64 /
    complex128 / bool / int64 tensors on ``device``."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        classes = _port_classes()
        name = type(tree).__name__
        cls = classes.get(name)
        if cls is None:
            raise TypeError(f"no port dataclass for {name}")
        host = HOST_FIELDS.get(name, set())
        kw = {}
        for f in dataclasses.fields(cls):
            if hasattr(tree, f.name):
                kw[f.name] = state_from_numpy(getattr(tree, f.name), device,
                                              _host=f.name in host)
        return cls(**kw)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device, _host) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, complex, str)):
        return tree
    if isinstance(tree, np.generic):
        return tree.item()
    if isinstance(tree, np.ndarray) or hasattr(tree, "__array__"):
        if _host:
            return np.asarray(tree)
        a = np.asarray(tree)
        if a.dtype == object:
            return state_from_numpy(a.tolist(), device)
        return _array(a, device)
    return tree
