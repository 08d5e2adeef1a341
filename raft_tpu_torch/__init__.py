"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu.

The frequency-domain floating-wind-turbine framework on PyTorch, with
the TPU's Pallas kernels replaced by CUDA kernels written for the H100
(``csrc/``).  The JAX package ``raft_tpu`` stays beside it as the
reference; this package imports nothing of it (nor of JAX).

Quick start::

    from raft_tpu_torch import run_raft
    model = run_raft("OC3spar")                    # on the card
    model = run_raft("OC3spar", device="cpu")      # on the host

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""
from raft_tpu_torch.model import Model, run_raft  # noqa: F401

__all__ = ["Model", "run_raft"]
