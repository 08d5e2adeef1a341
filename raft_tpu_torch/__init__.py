"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu.

The frequency-domain floating-wind-turbine framework on PyTorch, with
the TPU's Pallas kernels replaced by CUDA kernels written for the H100
(``csrc/``).  The JAX package ``raft_tpu`` stays beside it as the
reference; this package imports nothing of it (nor of JAX).

Quick start::

    from raft_tpu_torch import run_raft, sweep_cases, sweep_variants
    model = run_raft("OC3spar")                    # on the card
    model = run_raft("OC3spar", device="cpu")      # on the host
    out = sweep_cases("OC3spar", Hs, Tp, beta)     # batched load cases
    out = sweep_variants("VolturnUS-S", thetas)    # batched design variants

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""
from raft_tpu_torch.model import Model, run_raft  # noqa: F401
from raft_tpu_torch.parallel.sweep import sweep_cases  # noqa: F401
from raft_tpu_torch.parallel.variants import sweep_variants  # noqa: F401

__all__ = ["Model", "run_raft", "sweep_cases", "sweep_variants"]
