"""Potential-flow coefficients: the zero branch strip-theory runs take.

Port of the part of ``raft_tpu/io/wamit.py`` that strip-only designs
(``potModMaster: 1``) still call: with no BEM data loaded the added mass
and radiation damping that enter the linear system are zero.  Reading
WAMIT files waits for a later slice.
"""
from __future__ import annotations

import torch

from raft_tpu_torch import errors


def bem_coeffs(bem, nw: int, device=None):
    """(A_BEM, B_BEM) (6, 6, nw); zeros when no potential-flow data is
    loaded."""
    if bem is not None:
        raise errors.ModelConfigError(
            "potential-flow (BEM) coefficients are not part of the PyTorch "
            "port yet; strip-theory designs (potModMaster: 1) only")
    z = torch.zeros((6, 6, nw), dtype=torch.float64, device=device)
    return z, z
