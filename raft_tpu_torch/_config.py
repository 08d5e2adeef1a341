"""Dtypes and device resolution for the PyTorch port.

Everything the port computes is float64 / complex128 (the H100 has native
FP64).  ``torch.get_default_dtype()`` stays float32 and is never changed:
every tensor the package creates names its dtype through these helpers.
"""
from __future__ import annotations

import numpy as np
import torch

REAL = torch.float64
COMPLEX = torch.complex128


def real_dtype():
    return REAL


def complex_dtype():
    return COMPLEX


def as_real(x, device=None):
    """``x`` as a float64 tensor (on ``device`` when given; a tensor
    already there is returned as is)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=REAL) if device is not None \
            else x.to(dtype=REAL)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=REAL, device=device)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card (``cuda``).  With no CUDA device present that
    raises instead of quietly running on the CPU; pass ``device="cpu"``
    to run the plain PyTorch versions on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "by default — pass device='cpu' to run on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    return dev
