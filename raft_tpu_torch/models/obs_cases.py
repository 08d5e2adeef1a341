"""The observability facts shared by the tests and ``chip_smoke.py``.

- `pulls_per_case`: the port's pinned count of host pulls of one clean
  case of ``Model.analyzeCases``, by phase, as a formula of its Newton
  iterations and drag passes (``tests/test_torch_obs_model.py`` holds it
  on the CPU, ``chip_smoke.py`` phase 15 on the card, where the case
  also runs under ``obs.transfers.guard("disallow")``);
- `JAX_PULLS_PER_CASE`: the JAX package's budget for the same case
  (``docs/performance.md``, ``tests/test_device_resident.py``);
- `SPAN_TREE`: the span tree of one single-FOWT case, (name, depth,
  parent) in finishing order, as ``tests/golden/obs/model.json`` records
  the JAX package's.

Nothing here runs on import.
"""
from __future__ import annotations

#: the reads of device values in one single-FOWT case's outputs on
#: OC3spar: its mooring's tensions and their Jacobian, and the tower's
#: mass, centre, base height and inertia, the rotor's A and B at the hub
#: and its mean base moment
OC3SPAR_OUTPUT_PULLS = 9

#: the JAX package's pinned pulls per case: its statics Newton and drag
#: fixed point loop on the device
JAX_PULLS_PER_CASE = {"statics": 1, "dynamics": 4}

SPAN_TREE = [["solveStatics", 1, "analyzeCases"],
             ["fowt_linearize", 2, "solveDynamics"],
             ["solveDynamics", 1, "analyzeCases"],
             ["saveTurbineOutputs", 1, "analyzeCases"],
             ["analyzeCases", 0, None]]


def pulls_per_case(statics_iters: int, drag_passes: int,
                   outputs: int = OC3SPAR_OUTPUT_PULLS) -> dict:
    """The port's counted host pulls of one clean single-FOWT case (one
    heading, no second-order loads), by phase:

    - ``statics``: one a Newton iteration (its convergence flag and the
      solve's info), the final pose with its residual, and the
      MacCamy-Fuchs flag check of the hydro constants;
    - ``dynamics``: one a drag pass (its largest relative update), the
      frequency grid of the sea state, the final two iterates, the
      conditioning (the SVD's error check, then its flag, max and
      median), the system solve's residual and the response;
    - ``outputs``: the outputs' reads of device values (``outputs``).

    The case journal adds one pull a run (the model digest) in phase
    ``journal``, and one a case for each carried tensor (the mean drift,
    an array's free points)."""
    return {"statics": int(statics_iters) + 2,
            "dynamics": int(drag_passes) + 6, "outputs": int(outputs)}
