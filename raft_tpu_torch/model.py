"""System-level model: statics equilibrium, eigen, dynamic RAO solve, cases.

Port of ``raft_tpu/model.py`` (reference: raft/raft_model.py) on PyTorch,
for one FOWT or an array of N (``array`` in the design: the per-row
``x_location``, ``y_location``, ``heading_adjust`` and turbine / platform
/ mooring IDs, and an ``array_mooring`` MoorDyn file whose lines may be
shared between FOWTs):

- `solveStatics` (reference :479-849): damped Newton on the 6N-DOF pose
  with the 5 line-search alphas evaluated as one batch
  (``torch.func.vmap``), first-sufficient selection, full clipped step
  when none improves, and the |dX| < tol stop on the undamped step; a
  Python loop with one host check per iteration.  The array mooring's
  free points are re-solved at every evaluation (warm-started from the
  accepted ones) and its coupled stiffness couples the FOWT blocks.
- `solveDynamics` (reference :852-1146): each FOWT's drag-linearization
  fixed point around the fused impedance solve (kernel K1 on the card)
  in a Python loop with the same iteration rule, then the factor-once
  system solve ``inv_complex`` applied to every heading: kernel K2 for
  one FOWT, LU for an array's (nw, 6N, 6N) system plus the array
  mooring's stiffness (the ladder around LU under
  ``RAFT_TPU_PRECISION=mixed``).
- Second-order loads (reference :901-904, :966-989, :1066-1083):
  ``potSecOrder: 2`` adds the difference-frequency force of a ``.12d``
  QTF; ``potSecOrder: 1`` computes the slender-body QTF (kernel K5 on the
  card) from the drag-converged RAOs of each heading, re-converges the
  fixed point warm-started from them (heading 0) or re-solves through the
  factored impedance (the other headings), and re-solves the statics with
  the mean drift included.  ``outFolderQTF`` drops ``.4`` / ``.12d``
  snapshots and reloads a content-keyed QTF.
- First-order potential flow: the BEM added mass A(w) and damping B(w)
  enter the impedance (so K1 sees an M and a B that vary from bin to
  bin) and the BEM excitation the right-hand side; `preprocess_BEM`
  re-solves the native BEM on a custom grid and writes WAMIT files.
- `solveEigen` (reference :391-476), host NumPy, at 6N DOFs.
- `analyzeCases` / `saveTurbineOutputs` (per FOWT; an array's shared-line
  tension statistics under ``case_metrics[i]["array_mooring"]``) /
  `calcOutputs` / `run_raft`; `sweep_farm`, `powerThrustCurve`,
  `findWakeEquilibrium` and `calcAEP` (``models/wake.py``).

Everything runs on ``Model.device`` (the card unless ``device="cpu"``);
the native BEM solve and the WAMIT parsing are host work at build time.
Submerged (MHK) rotors carry blade members and a per-case cavitation
check (``results["cavitation"]``); a mooring with free points or
multi-segment lines solves its free points once per statics pose.
MacCamy-Fuchs members take a frequency-dependent inertia coefficient and,
under ``potSecOrder: 1``, the Kim & Yue correction of the QTF.

Fault tolerance (``recovery.py``, as the JAX package's ``analyzeCases``
with ``RAFT_TPU_RECOVERY`` on, its default): a case whose statics or
dynamics fail recoverably walks the degradation ladder; a case the
ladder cannot save is quarantined (`failed_cases`, a ``case{N}/failed``
ledger entry) while the other cases run; each completed case is
journaled and ``analyzeCases(resume=True)`` re-runs only the cases
missing from the journal.  A kernel that fails to build, load or launch
is fatal: it propagates, no rung is tried and nothing is quarantined.
The ``statics`` and ``dynamics`` fault seams (``testing/faults.py``) sit
after the Newton and after each drag fixed point.

Observability (``obs/``, as the JAX package's ``analyzeCases``): nested
spans (``analyzeCases`` > ``solveStatics`` / ``solveDynamics`` >
``fowt_linearize`` / ``saveTurbineOutputs``), solver-health metrics, the
flight recorder's ``case_start`` / ``case_end`` / ``quarantine`` events,
probes, and one ``RunManifest`` per ``analyzeCases`` (``last_manifest``,
written with the trace, the ledger and the events under
``RAFT_TPU_OBS_DIR``).  Every host pull of the case path goes through
``obs.transfers.device_get`` (phases ``journal``, ``statics``,
``dynamics``, ``outputs``): one a Newton iteration and one a drag pass,
as the port's loops decide on the host.

Ballast trim (``analyzeUnloaded(ballast=1|2)``, ``run_raft(ballast=True)``):
the fill-level walk runs on the host from one counted pull of the
platform's geometry; the density shift is one tensor function shared
with the variant sweep (``models.fowt.ballast_density_trim``).

Not part of the port yet: the FLORIS coupling.
"""
from __future__ import annotations

import contextlib
import copy
import logging
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from raft_tpu_torch import _config, errors, ledger as _ledger, obs, recovery
from raft_tpu_torch._config import (COMPLEX, REAL, as_real, resolve_device,
                                    to_device)
from raft_tpu_torch.io.bem_native import solve_bem_fowt
from raft_tpu_torch.io.wamit import bem_coeffs
from raft_tpu_torch.models import mooring as mr
from raft_tpu_torch.models import mooring_array as ma
from raft_tpu_torch.models.fowt import (
    FOWTModel, ballast_density_trim, build_fowt, build_seastate, fowt_pose,
    fowt_statics, fowt_hydro_constants, fowt_hydro_excitation,
    fowt_drag_precompute, fowt_hydro_linearization_pre, fowt_drag_excitation,
    fowt_current_loads, fowt_turbine_constants, fowt_bem_excitation,
)
from raft_tpu_torch.models import qtf as qt
from raft_tpu_torch.models.member import member_inertia
from raft_tpu_torch.models.rotor import calc_aero, calc_cavitation
from raft_tpu_torch.ops.linalg import impedance_solve, inv_complex, last_dispatch
from raft_tpu_torch.ops.spectra import get_psd, get_rao, get_rms
from raft_tpu_torch.ops.transforms import transform_force, translate_matrix_6to6
from raft_tpu_torch.obs import transfers
from raft_tpu_torch.testing import faults
from raft_tpu_torch.utils.dicttools import get_from_dict
from raft_tpu_torch.utils.profiling import temp_verbosity

_LOG = logging.getLogger("raft_tpu_torch.model")

RAD2DEG = 180.0 / np.pi


def _np(x, what: str = "host_value"):
    """Host numpy copy of a tensor, through the counted
    ``obs.transfers.device_get`` (numpy/python pass through)."""
    if isinstance(x, torch.Tensor):
        return transfers.device_get(x, what=what)
    return np.asarray(x)


def _f(x, what: str = "host_value") -> float:
    return float(_np(x, what))


def _hnp(x):
    """Numpy view of a result computed on the host from host values (a
    CPU tensor; no transfer, nothing counted).  A card tensor raises."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _dyn_solve_core(Zinv, Z_sys, F_all):
    """Apply the factored inverse impedance to every heading's excitation
    ((nw,6N,6N) x (nH,6N,nw) -> (nH,6N,nw)) and the per-heading relative
    residual |Z Xi - F| / |F| of that reuse."""
    Xi = torch.einsum("wij,hjw->hiw", Zinv, F_all)
    R = torch.einsum("wij,hjw->hiw", Z_sys, Xi) - F_all
    num = torch.sqrt(torch.sum(torch.abs(R) ** 2, dim=(1, 2)))
    den = torch.sqrt(torch.sum(torch.abs(F_all) ** 2, dim=(1, 2)))
    return Xi, num / (den + 1e-300)


def _block_diag(blocks):
    """(..., 6N, 6N) from N (..., 6, 6) blocks (written for
    ``torch.func.vmap``); one block is returned as it is."""
    N = len(blocks)
    if N == 1:
        return blocks[0]
    z = torch.zeros_like(blocks[0])
    return torch.cat([torch.cat([blocks[i] if j == i else z
                                 for j in range(N)], dim=-1)
                      for i in range(N)], dim=-2)


class Model:
    """Single-FOWT or array frequency-domain model: Model(design) ->
    analyzeUnloaded() (one FOWT only) -> analyzeCases() with results in
    `model.results`.

    ``device`` defaults to the card (``cuda``) and raises when there is
    none; pass ``device="cpu"`` to run on the host."""

    #: line-search candidates of the damped statics Newton
    _NEWTON_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)
    _NEWTON_MAX_ITERS = 50

    def __init__(self, design: dict, device=None):
        self.device = resolve_device(device)
        design = copy.deepcopy(design)
        design.setdefault("settings", {})
        s = design["settings"]
        min_freq = float(get_from_dict(s, "min_freq", default=0.01, dtype=float))
        max_freq = float(get_from_dict(s, "max_freq", default=1.00, dtype=float))
        self.XiStart = float(get_from_dict(s, "XiStart", default=0.1, dtype=float))
        self.nIter = int(get_from_dict(s, "nIter", default=15, dtype=int))
        self.w = np.arange(min_freq, max_freq + 0.5 * min_freq, min_freq) * 2 * np.pi
        self.nw = len(self.w)
        self.depth = float(get_from_dict(design["site"], "water_depth", dtype=float))

        #: the array mooring (``array_mooring``), its free points at the
        #: last statics pose and its coupled (6N, 6N) stiffness there
        self.arr_ms = None
        self._arr_xf = None
        self._K_array = None
        if "array" in design:
            # ----- array/farm mode (reference: raft_model.py:67-141) -----
            if "turbine" in design and "turbines" not in design:
                design["turbines"] = [design["turbine"]]
            if "platform" in design and "platforms" not in design:
                design["platforms"] = [design["platform"]]
            if "mooring" in design and "moorings" not in design:
                design["moorings"] = [design["mooring"]]
            fowtInfo = [dict(zip(design["array"]["keys"], row))
                        for row in design["array"]["data"]]
            self.nFOWT = len(fowtInfo)
            if "array_mooring" in design:
                if not design["array_mooring"].get("file"):
                    raise errors.ModelConfigError(
                        "'array_mooring' requires a MoorDyn-style input "
                        "file as 'file'")
                from raft_tpu_torch.convert import state_from_numpy
                self.arr_ms = state_from_numpy(ma.parse_moordyn(
                    design["array_mooring"]["file"], nbodies=self.nFOWT,
                    depth=self.depth), self.device)
            self.fowtList = []
            for info in fowtInfo:
                design_i = {"site": design["site"]}
                if info["turbineID"] != 0:
                    design_i["turbine"] = design["turbines"][info["turbineID"] - 1]
                design_i["platform"] = design["platforms"][info["platformID"] - 1]
                if info["mooringID"] != 0:
                    design_i["mooring"] = design["moorings"][info["mooringID"] - 1]
                self.fowtList.append(build_fowt(
                    design_i, self.w, depth=self.depth,
                    x_ref=float(info["x_location"]),
                    y_ref=float(info["y_location"]),
                    heading_adjust=float(info["heading_adjust"]),
                    device=self.device))
        else:
            self.fowtList = [build_fowt(design, self.w, depth=self.depth,
                                        device=self.device)]
            self.nFOWT = 1
        self.nDOF = 6 * self.nFOWT
        self.mooring_currentMod = int(get_from_dict(
            design.get("mooring") or {}, "currentMod", dtype=int, default=0))
        # QTF output folder: internal-QTF runs drop .12d/.4 snapshots here
        # and reload them as a checkpoint cache (reference:
        # raft_fowt.py:255-257, 1420-1433, 1642-1648)
        plat = design.get("platform") or (design.get("platforms") or [{}])[0]
        self.outFolderQTF = plat.get("outFolderQTF")
        self._iCase = None
        #: result ledger (raft_tpu.ledger/v1) of the most recent
        #: analyzeCases invocation
        self.last_ledger = None
        self._case_records = {}
        #: the last ballast trim: a fill-level walk's (`adjustBallast`)
        #: initial heave imbalance and visited sections, one record each,
        #: or a density shift (`adjustBallastDensity`)
        self.ballast_trim = dict(heave0=None, walk=[], delta_rho=None)
        #: wall seconds per phase of the most recent analyzeCases
        #: (statics, dynamics, outputs; with second-order loads also
        #: first_order_fp, qtf, second_order_fp inside dynamics and the
        #: drift_statics re-solve), each ending in a device sync
        self.timings = {}
        self.design = design
        self.results = {}
        self._state = [dict() for _ in self.fowtList]

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _t(self, x):
        return as_real(x, self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lap(self, key, t0) -> float:
        """Add the wall since ``t0`` (after a device sync) to
        ``timings[key]``; returns the new time stamp."""
        self._sync()
        t = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + t - t0
        return t

    def _case_label(self) -> str:
        return "unloaded" if self._iCase is None else str(self._iCase)

    @staticmethod
    def _case_for_fowt(case, i):
        """Per-FOWT view of a case row: farm cases may give per-turbine
        lists for the wind parameters (reference: raft_model.py:515-519,
        536-547)."""
        if not case:
            return case
        case_i = dict(case)
        for key in ("wind_speed", "wind_heading", "turbulence"):
            v = case.get(key)
            if isinstance(v, (list, tuple, np.ndarray)):
                if i >= len(v):
                    raise errors.ModelConfigError(
                        f"case list for '{key}' has {len(v)} entries but "
                        f"FOWT {i+1} exists — per-turbine lists must match "
                        "the number of turbines (reference: "
                        "raft_model.py:517-519)", key=key, fowt=i)
                case_i[key] = v[i]
        return case_i

    def _refs(self):
        """(6N,) reference poses [x_ref, y_ref, 0, 0, 0, 0] per FOWT."""
        return np.concatenate([[f.x_ref, f.y_ref, 0, 0, 0, 0]
                               for f in self.fowtList]).astype(float)

    # ------------------------------------------------------------------
    # statics
    # ------------------------------------------------------------------

    def _case_constants(self, fowt: FOWTModel, case, state):
        """Statics + constant forcing at the zero-offset pose (reference:
        raft_model.py:521-556)."""
        X0 = np.array([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0], float)
        pose0 = fowt_pose(fowt, X0)
        stat = fowt_statics(fowt, pose0)
        state["pose0"] = pose0
        state["statics"] = stat
        state["K_hydrostatic"] = stat["C_struc"] + stat["C_hydro"]
        state["F_undisplaced"] = stat["W_struc"] + stat["W_hydro"]

        F_env = torch.zeros(6, dtype=REAL, device=self.device)
        if case:
            # statics-time constants use the PREVIOUS case's inflow
            # heading for the hub->PRP transfer offset (reference
            # statefulness; see fowt_turbine_constants)
            stale = state.get("_stored_heading", [0.0] * len(fowt.rotors))
            tc = fowt_turbine_constants(fowt, case, X0,
                                        transfer_heading=stale)
            status = str(get_from_dict(case, "turbine_status", shape=0,
                                       dtype=str, default="operating"))
            new_heads = list(stale)
            for k, rot in enumerate(fowt.rotors):
                spd = float(get_from_dict(
                    case, "current_speed" if rot.hubHt < 0 else "wind_speed",
                    shape=0, default=1.0 if rot.hubHt < 0 else 10.0))
                if status == "operating" and rot.aeroServoMod > 0 and spd > 0:
                    new_heads[k] = np.radians(float(get_from_dict(
                        case, "current_heading" if rot.hubHt < 0
                        else "wind_heading", shape=0, default=0.0)))
            state["_stored_heading"] = new_heads
            state["turbine"] = tc
            # cavitation check of operating submerged rotors at a current
            # (reference: raft_fowt.py:826-827 -> raft_rotor.py:639-696);
            # host numpy, one transfer per rotor and case
            cav = [calc_cavitation(rot, case) for rot in fowt.rotors
                   if rot.hubHt < 0 and status == "operating"
                   and float(get_from_dict(case, "current_speed", shape=0,
                                           default=0.0)) > 0]
            if cav:
                state["cavitation"] = cav
            else:
                state.pop("cavitation", None)
            hc = fowt_hydro_constants(fowt, pose0)
            state["hydro0"] = hc
            cur_speed = float(get_from_dict(case, "current_speed", shape=0, default=0.0))
            cur_head = float(get_from_dict(case, "current_heading", shape=0, default=0))
            D_hydro = fowt_current_loads(fowt, pose0, cur_speed, cur_head)
            state["D_hydro"] = D_hydro
            F_env = torch.sum(tc["f_aero0"], dim=1) + D_hydro
            # current on the mooring lines (reference raft_model.py:
            # 559-578): the simple topology takes the current-loaded line
            # profiles; a general (free-point) topology keeps the lumped
            # chord drag on F_env, as the JAX Model does
            state["moor_current"] = None
            if (self.mooring_currentMod > 0 and cur_speed > 0
                    and fowt.mooring is not None):
                U = cur_speed * np.array([np.cos(np.deg2rad(cur_head)),
                                          np.sin(np.deg2rad(cur_head)), 0.0])
                if mr._is_general(fowt.mooring):
                    F_env = F_env + mr.current_wrench(
                        fowt.mooring, self._t(X0), self._t(U))
                else:
                    state["moor_current"] = U
            # the mean wave drift of this case's dynamics, for the statics
            # re-solve (reference raft_model.py:548-554)
            if "F_meandrift" in state:
                F_env = F_env + state["F_meandrift"]
        else:
            state["turbine"] = None
            state["hydro0"] = fowt_hydro_constants(fowt, pose0)
            state["D_hydro"] = torch.zeros(6, dtype=REAL, device=self.device)
            state["moor_current"] = None
        state["F_env_constant"] = F_env

    def _statics_eval(self, F0s, K_hss, Ucur):
        """(net force (6N,), tangent stiffness (6N, 6N), array free
        points) at one pose X (6N,) from the array free points' start
        ``xf``, written for ``torch.func.vmap`` over the line-search
        alphas.  As in the JAX Model, a simple mooring takes the
        current-loaded line profiles with the case current (zero without
        one); a general topology solves its free points once per pose and
        shares them between the wrench and the stiffness; the array
        mooring re-solves its free points from ``xf`` and adds its body
        wrenches and coupled stiffness."""
        N = self.nFOWT
        refs = self._t(self._refs())
        moors = [f.mooring for f in self.fowtList]
        general = [m is not None and mr._is_general(m) for m in moors]
        arr = self.arr_ms

        def eval_FK(X, xf):
            Fs, Ks = [], []
            for i in range(N):
                s = slice(6 * i, 6 * i + 6)
                F = F0s[i] - K_hss[i] @ (X[s] - refs[s])
                K = K_hss[i]
                if moors[i] is not None:
                    xf_i = mr.free_points(moors[i], X[s]) if general[i] \
                        else None
                    cur = None if general[i] else Ucur[i]
                    F = F + mr.body_wrench(moors[i], X[s], xf=xf_i,
                                           current=cur)
                    K = K + mr.coupled_stiffness(moors[i], X[s], xf=xf_i,
                                                 current=cur)
                Fs.append(F)
                Ks.append(K)
            F = torch.cat(Fs) if N > 1 else Fs[0]
            K = _block_diag(Ks)
            if arr is not None:
                Xb = X.reshape(N, 6)
                xf = ma.solve_free_points(arr, Xb, xf0=xf)
                F = F + ma.body_wrenches(arr, Xb, xf).reshape(-1)
                K = K + ma.coupled_stiffness(arr, Xb, xf)
            return F, K, xf

        return eval_FK

    def solveStatics(self, case, display=0):
        """Mean-offset equilibrium over all 6N DOFs (reference:
        raft_model.py:479-849): span ``solveStatics``, its host pulls in
        the ``statics`` phase (one a Newton iteration, one at the end)."""
        with obs.span("solveStatics", case=self._case_label()) as sp, \
                transfers.phase("statics"):
            return self._solve_statics_impl(case, sp)

    def _solve_statics_impl(self, case, sp):
        N = self.nFOWT
        for i, fowt in enumerate(self.fowtList):
            self._case_constants(fowt, self._case_for_fowt(case, i),
                                 self._state[i])
        refs = self._refs()
        F0s = [st["F_undisplaced"] + st["F_env_constant"]
               for st in self._state]
        K_hss = [st["K_hydrostatic"] for st in self._state]
        # the ladder's damped rung shrinks the Newton step clip
        # (recovery.override("clip_scale")); 1.0 outside it
        db = self._t(np.tile([30, 30, 5, 0.1, 0.1, 0.1], N)
                     * float(recovery.current("clip_scale", 1.0)))
        tol = self._t(np.tile(np.array([0.05, 0.05, 0.05, 5e-3, 5e-3, 5e-3])
                              * 1e-3, N))
        Ucur = [self._t(st["moor_current"] if st.get("moor_current")
                        is not None else np.zeros(3)) for st in self._state]
        arr = self.arr_ms
        if arr is None:
            xf = torch.zeros((0, 3), dtype=REAL, device=self.device)
        elif self._arr_xf is not None:
            # the previous statics solve's free points (as the JAX Model)
            xf = self._arr_xf
        else:
            xf = self._t(arr.r0)[to_device(
                np.flatnonzero(np.asarray(arr.attach) == ma.ATTACH_FREE),
                self.device)]
        eval_FK = self._statics_eval(F0s, K_hss, Ucur)
        eval_batch = torch.func.vmap(eval_FK, in_dims=(0, None))
        alphas = self._t(self._NEWTON_ALPHAS)

        X = self._t(refs)
        F, K, xf = eval_FK(X, xf)
        n_iters = 0
        while n_iters < self._NEWTON_MAX_ITERS:
            # guard zero-stiffness diagonals like the reference (:713-715)
            kdiag = torch.diagonal(K)
            kfix = torch.where(kdiag == 0.0, torch.mean(kdiag), kdiag)
            Kg = K + torch.diag(kfix - kdiag)
            # solve_ex: torch.linalg.solve's error check would read the
            # card; its info comes back with this iteration's one pull
            step, info = torch.linalg.solve_ex(Kg, F)
            dX = torch.clamp(step, -db, db)
            merit0 = torch.sum(F ** 2)
            Fa, Ka, xfa = eval_batch(X + alphas[:, None] * dX, xf)
            merits = torch.sum(Fa ** 2, dim=1)
            # first sufficient candidate wins; none improving -> the full
            # clipped step (candidate 0, a = 1); the candidate is gathered
            # by index_select (x[i] with a 0-d tensor i reads i on the host)
            suff = torch.isfinite(merits) & (merits < merit0)
            anys = torch.any(suff)
            idx = torch.where(anys, torch.argmax(suff.to(torch.int32)),
                              0).reshape(1)
            X = X + torch.where(anys, alphas.index_select(0, idx)[0],
                                1.0) * dX
            F, K, xf = (Fa.index_select(0, idx)[0],
                        Ka.index_select(0, idx)[0],
                        xfa.index_select(0, idx)[0])
            n_iters += 1
            # convergence on the UNDAMPED Newton step of this iteration,
            # pulled beside the solve's info
            conv, info = _np(torch.stack([
                torch.all(torch.abs(dX) < tol).to(torch.int32),
                info.to(torch.int32)]), "statics_newton_step")
            if info > 0:
                raise torch.linalg.LinAlgError(
                    "torch.linalg.solve: The solver failed because the "
                    f"input matrix is singular (info {int(info)}).")
            if conv:
                break
        res_h, Xh = transfers.device_get(
            (torch.sqrt(torch.sum(F ** 2)), X), what="statics_newton")
        residual = float(res_h)
        obs.probes.probe("statics_newton", iters=n_iters, residual=residual)
        # fault seam: nan@statics poisons the pose, raise@statics raises
        if faults.maybe_raise("statics", case=self._iCase) == "nan":
            Xh = np.full_like(Xh, np.nan)
        if not np.all(np.isfinite(Xh)) or not np.isfinite(residual):
            raise errors.StaticsDivergence(
                "statics Newton produced a non-finite pose",
                case=self._iCase, iters=n_iters, residual=residual)
        case_lbl = self._case_label()
        sp.set(newton_iters=n_iters, residual_norm=residual)
        obs.histogram(
            "raft_statics_newton_iterations",
            "damped-Newton iterations to mean-offset equilibrium",
            buckets=obs.ITER_BUCKETS).observe(n_iters, case=case_lbl)
        obs.gauge(
            "raft_statics_residual_norm",
            "|F| at the accepted statics equilibrium [N]",
            ).set(residual, case=case_lbl)
        rec = self._case_records.setdefault(case_lbl, {})
        rec["statics_iters"] = n_iters
        rec["statics_residual"] = residual

        if arr is not None:
            # the array mooring at the FINAL pose: one more free-point
            # solve, and the MoorPy-parity rotation-vector stiffness
            Xb = X.reshape(N, 6)
            self._arr_xf = ma.solve_free_points(arr, Xb, xf0=xf)
            self._K_array = ma.coupled_stiffness_rotvec(arr, Xb,
                                                        self._arr_xf)
        for i, fowt in enumerate(self.fowtList):
            s = slice(6 * i, 6 * i + 6)
            state = self._state[i]
            state["r6"] = Xh[s]
            state["Xi0"] = Xh[s] - refs[s]
            if fowt.mooring is not None:
                # MoorPy-parity ROTATION-VECTOR stiffness at the
                # equilibrium pose for dynamics/eigen (see the JAX Model)
                cur = state.get("moor_current")
                cur_t = None if cur is None else self._t(cur)
                xf_i = mr.free_points(fowt.mooring, X[s])
                state["C_moor"] = mr.coupled_stiffness_rotvec(
                    fowt.mooring, X[s], xf=xf_i, current=cur_t)
                state["F_moor0"] = mr.body_wrench(fowt.mooring, X[s],
                                                  xf=xf_i, current=cur_t)
            else:
                state["C_moor"] = torch.zeros((6, 6), dtype=REAL,
                                              device=self.device)
                state["F_moor0"] = torch.zeros(6, dtype=REAL,
                                               device=self.device)
        if case and "iCase" in case:
            self.results.setdefault("mean_offsets", []).append(Xh.copy())
        return Xh

    # ------------------------------------------------------------------
    # eigen
    # ------------------------------------------------------------------

    def solveEigen(self, display=0):
        """Undamped natural frequencies and modes (reference:
        raft_model.py:391-476), host NumPy with the DOF-claiming sort;
        span ``solveEigen``, the frequencies in ``raft_eigen_fn_hz``."""
        with obs.span("solveEigen", case=self._case_label()) as sp, \
                transfers.phase("eigen"):
            fns, modes = self._solve_eigen_impl()
            sp.set(fn_min_hz=float(np.min(fns)), fn_max_hz=float(np.max(fns)))
            g = obs.gauge("raft_eigen_fn_hz",
                          "undamped natural frequency per system DOF [Hz]")
            for idof, fn in enumerate(np.asarray(fns)):
                g.set(float(fn), dof=str(idof))
        return fns, modes

    def _solve_eigen_impl(self):
        nDOF = self.nDOF
        M_tot = np.zeros((nDOF, nDOF))
        C_tot = np.zeros((nDOF, nDOF))
        for i, fowt in enumerate(self.fowtList):
            s = slice(6 * i, 6 * i + 6)
            state = self._state[i]
            stat = state["statics"]
            hc = state.get("hydro0") or fowt_hydro_constants(fowt,
                                                             state["pose0"])
            M_tot[s, s] = _np(stat["M_struc"]) + _np(hc["A_hydro_morison"])
            C_tot[s, s] = (_np(stat["C_struc"]) + _np(stat["C_hydro"])
                           + _np(state["C_moor"]))
            C_tot[6 * i + 5, 6 * i + 5] += fowt.yawstiff
        if self._K_array is not None:
            C_tot += _np(self._K_array)

        for i in range(nDOF):
            if M_tot[i, i] < 1.0 or C_tot[i, i] < 1.0:
                raise errors.EigenFailure(
                    "small/negative diagonal in system matrices",
                    dof=i, M_ii=float(M_tot[i, i]), C_ii=float(C_tot[i, i]))

        eigenvals, eigenvectors = np.linalg.eig(np.linalg.solve(M_tot, C_tot))
        if any(eigenvals <= 0.0):
            raise errors.EigenFailure(
                "zero or negative system eigenvalues detected",
                n_nonpositive=int(np.sum(eigenvals <= 0.0)))

        ind_list = []
        for i in range(nDOF - 1, -1, -1):
            vec = np.abs(eigenvectors[i, :]).copy()
            for _ in range(nDOF):
                ind = int(np.argmax(vec))
                if ind in ind_list:
                    vec[ind] = 0.0
                else:
                    ind_list.append(ind)
                    break
        ind_list.reverse()
        fns = np.sqrt(eigenvals[ind_list]) / 2.0 / np.pi
        modes = eigenvectors[:, ind_list]
        self.results["eigen"] = {"frequencies": fns, "modes": modes}
        return fns, modes

    # ------------------------------------------------------------------
    # dynamics
    # ------------------------------------------------------------------

    def solveDynamics(self, case, tol=0.01, display=0):
        """Drag-linearization fixed point per FOWT + system RAO solve
        (reference: raft_model.py:852-1146).  Each FOWT converges on its
        own 6x6 impedance (the reference leaves the array mooring out of
        the linearization); the block-diagonal (nw, 6N, 6N) system plus
        the array mooring's stiffness then gives the coupled response of
        every heading.  Span ``solveDynamics`` (one ``fowt_linearize`` per
        FOWT), its host pulls in the ``dynamics`` phase."""
        with obs.span("solveDynamics", case=self._case_label()) as sp, \
                transfers.phase("dynamics"):
            return self._solve_dynamics_impl(case, tol, sp)

    def _record_dyn_residual(self, ih, rel):
        """Record one heading's system-solve relative residual."""
        obs.gauge(
            "raft_dynamics_solve_residual",
            "relative residual |Z Xi - F|/|F| of the system RAO solve",
            ).set(rel, case=self._case_label(), heading=str(ih))
        return rel

    def _solve_dynamics_impl(self, case, tol, sp):
        N = self.nFOWT
        nw = self.nw
        for i in range(N):
            with obs.span("fowt_linearize", fowt=i, case=self._case_label()):
                self._fowt_linearize(i, self._case_for_fowt(case, i),
                                     tol=tol)

        Z_sys = _block_diag([st["Z"].movedim(-1, 0)          # (nw,6N,6N)
                             for st in self._state])
        if self._K_array is not None:
            Z_sys = Z_sys + self._K_array[None, :, :]
        # factor once, reuse across headings (the reference's Zinv,
        # raft_model.py:1038-1040) — kernel K2 on the card for one FOWT,
        # LU for an array
        Zinv = inv_complex(Z_sys)
        #: the system solve's dispatch facts (under the mixed ladder its
        #: promoted lanes), for the last case
        self.last_system_dispatch = last_dispatch()

        # conditioning telemetry of the impedance stack, on the card by
        # default (the SVD's error check is one counted read; an
        # identity stands in for a non-finite stack, which records
        # nothing), on the host under RAFT_TPU_TELEMETRY=full
        if _config.telemetry_mode() == "full":
            Z_host = _np(Z_sys, "impedance_stack")
            finite = bool(np.all(np.isfinite(Z_host)))
            if finite:
                cond = np.linalg.cond(Z_host)
                cond_max, cond_med = float(cond.max()), float(np.median(cond))
        else:
            fin_t = torch.all(torch.isfinite(Z_sys.real)
                              & torch.isfinite(Z_sys.imag))
            eye = torch.eye(Z_sys.shape[-1], dtype=Z_sys.dtype,
                            device=Z_sys.device)
            cond = transfers.sync_point(
                torch.linalg.cond, torch.where(fin_t, Z_sys, eye),
                what="cond_check")
            finite, cond_max, cond_med = _np(
                torch.stack([fin_t.to(cond.dtype), torch.max(cond),
                             torch.median(cond)]), "cond_estimate")
            finite = bool(finite)
        if finite:
            cond_max, cond_med = float(cond_max), float(cond_med)
            sp.set(cond_max=cond_max, cond_median=cond_med)
            obs.gauge(
                "raft_dynamics_condition_number",
                "max condition number of the 6Nx6N impedance over "
                "frequencies").set(cond_max, case=self._case_label())
            self._case_records.setdefault(self._case_label(), {})[
                "cond_max"] = cond_max

        nWaves = self._state[0]["seastate"]["nWaves"]
        for fowt, st in zip(self.fowtList, self._state):
            seastate = st["seastate"]
            st["F_drag"] = fowt_drag_excitation(
                fowt, st["pose_eq"], st["Bmat"],
                st["excitation"]["u"][:nWaves])
            if fowt.potSecOrder == 2:
                qd = fowt.qtf_data
                for ih in range(1, nWaves):
                    st["Fhydro_2nd_mean"][ih], st["Fhydro_2nd"][ih] = \
                        qt.hydro_force_2nd(qd.qtf, qd.heads_rad, qd.w,
                                           seastate["beta"][ih],
                                           seastate["S"][ih], self.w,
                                           device=self.device)

        def assemble_F():
            """(nWaves, 6N, nw) excitation stack."""
            return torch.cat([
                (st["F_BEM"][:nWaves] + st["excitation"]["F_hydro_iner"][:nWaves]
                 + st["F_drag"] + st["Fhydro_2nd"]).to(COMPLEX)
                for st in self._state], dim=1)

        Xi_d, rel_d = _dyn_solve_core(Zinv, Z_sys, assemble_F())
        rel2 = None
        if nWaves > 1 and any(f.potSecOrder == 1 for f in self.fowtList):
            # internal QTF of each secondary heading from its first-order
            # RAOs (one K5 launch each), then ONE re-solve of the headings
            # through the factored Zinv (reference: raft_model.py:1066-1083)
            t0 = time.perf_counter()
            for ih in range(1, nWaves):
                for i, (fowt, st) in enumerate(zip(self.fowtList,
                                                   self._state)):
                    if fowt.potSecOrder != 1:
                        continue
                    seastate = st["seastate"]
                    beta = float(seastate["beta"][ih])
                    RAO_h = get_rao(Xi_d[ih, 6 * i:6 * i + 6],
                                    seastate["zeta"][ih])
                    with obs.span("calcQTF_slenderBody", fowt=i,
                                  case=self._case_label()):
                        qtf_h = qt.calc_qtf_slender_body(
                            fowt, st["pose_eq"], beta, Xi0=RAO_h,
                            M_struc=st["statics"]["M_struc"])[:, :, None, :]
                    st["Fhydro_2nd_mean"][ih], st["Fhydro_2nd"][ih] = \
                        qt.hydro_force_2nd(qtf_h, [beta], fowt.w1_2nd, beta,
                                           seastate["S"][ih], self.w)
            t0 = self._lap("qtf", t0)
            Xi2_d, rel2 = _dyn_solve_core(Zinv, Z_sys, assemble_F())
            # heading 0 keeps its converged solution; the secondary
            # headings take the re-solved response
            Xi_d = torch.cat([Xi_d[:1], Xi2_d[1:]])
            self._lap("second_order_fp", t0)
        rec = self._case_records.setdefault(self._case_label(), {})
        rel_h = [float(r) for r in _np(rel_d, "solve_residual")]
        rel2_h = None if rel2 is None else [
            float(r) for r in _np(rel2, "solve_residual")]
        # per heading: the first solve, then (when present) its re-solve
        rec["dyn_solve_residual"] = [
            self._record_dyn_residual(ih, r) for ih in range(nWaves)
            for r in ([rel_h[ih]] + ([rel2_h[ih]] if rel2_h and ih else []))]

        Xi_sys = np.zeros((nWaves + 1, 6 * N, nw), dtype=complex)
        Xi_sys[:nWaves] = _np(Xi_d, "response")
        bad = ~np.isfinite(Xi_sys)
        if bad.any():
            raise errors.NonFiniteResult(
                f"solveDynamics produced {int(bad.sum())} non-finite "
                "response value(s); check drag-linearization convergence",
                case=self._iCase, n_bad=int(bad.sum()), nWaves=int(nWaves))
        for i, (fowt, st) in enumerate(zip(self.fowtList, self._state)):
            st["Xi"] = Xi_sys[:, 6 * i:6 * i + 6, :]
            if fowt.potSecOrder > 0:
                # mean drift feeds the statics re-solve (reference :548-554)
                st["F_meandrift"] = torch.sum(st["Fhydro_2nd_mean"], dim=0)
        self.Xi = Xi_sys
        self.results["response"] = {}
        return Xi_sys

    def _fowt_linearize(self, ifowt, case, tol=0.01):
        """FOWT ``ifowt``'s drag-linearization fixed point producing its
        converged 6x6 impedance (reference: raft_model.py:877-1013)."""
        fowt = self.fowtList[ifowt]
        state = self._state[ifowt]
        dev = self.device
        # the ladder's damped restart doubles the iteration budget and
        # strengthens the under-relaxation (recovery.override)
        nIter = self.nIter * int(recovery.current("fp_iter_mult", 1)) + 1
        keep, relax = recovery.relax_weights(
            recovery.current("fp_relax", 0.8))
        w = self._t(self.w)
        nw = self.nw

        seastate = build_seastate(fowt, case)
        pose_eq = fowt_pose(fowt, state["r6"])
        state["pose_eq"] = pose_eq
        state["seastate"] = seastate
        hc0 = state["hydro0"]

        exc = fowt_hydro_excitation(fowt, pose_eq, seastate, hc0)
        state["excitation"] = exc

        tc = state["turbine"]
        stat = state["statics"]
        if fowt.nrotors > 0 and tc is not None:
            M_turb = torch.sum(tc["A_aero"], dim=3)
            B_turb = torch.sum(tc["B_aero"], dim=3)
            B_gyro = torch.sum(tc["B_gyro"], dim=2)
        else:
            M_turb = torch.zeros((6, 6, nw), dtype=REAL, device=dev)
            B_turb = torch.zeros((6, 6, nw), dtype=REAL, device=dev)
            B_gyro = torch.zeros((6, 6), dtype=REAL, device=dev)

        A_BEM, B_BEM = bem_coeffs(fowt.bem, nw, device=dev)
        F_BEM = fowt_bem_excitation(fowt, seastate)            # (nH,6,nw)
        state["F_BEM"] = F_BEM

        M_lin = M_turb + stat["M_struc"][:, :, None] \
            + hc0["A_hydro_morison"][:, :, None] + A_BEM
        B_lin = B_turb + B_gyro[:, :, None] + B_BEM
        C_lin = stat["C_struc"] + state["C_moor"] + stat["C_hydro"]
        # the platform yaw stiffness does NOT enter the dynamics impedance
        # (reference C_lin, raft_model.py:913)

        u0 = exc["u"][0]
        nWaves = seastate["nWaves"]
        # ----- second-order forces (reference: raft_model.py:901-904) -----
        F2 = torch.zeros((nWaves, 6, nw), dtype=REAL, device=dev)
        F2_mean = torch.zeros((nWaves, 6), dtype=REAL, device=dev)
        if fowt.potSecOrder == 2:
            qd = fowt.qtf_data
            F2_mean[0], F2[0] = qt.hydro_force_2nd(
                qd.qtf, qd.heads_rad, qd.w, seastate["beta"][0],
                seastate["S"][0], self.w, device=dev)
        F_lin = F_BEM[0] + exc["F_hydro_iner"][0] + F2[0]         # (6, nw)
        drag_pre = fowt_drag_precompute(fowt, pose_eq, u0)

        def run_fixed_point(F_lin, Xi_init=None):
            """The drag-linearization fixed point around one batched solve
            over all frequencies (K1 on the card).  ``Xi_init`` warm-starts
            it (the potSecOrder 1 re-solve: the reference resets only the
            counter, raft_model.py:966-989).  Returns (XiLast, Xi, Z,
            Bmat, iterations, converged)."""
            XiLast = torch.zeros((6, nw), dtype=COMPLEX, device=dev) \
                + self.XiStart if Xi_init is None else Xi_init
            Xi = XiLast
            Z = torch.zeros((6, 6, nw), dtype=COMPLEX, device=dev)
            Bmat = torch.zeros((fowt.nodes.n, 3, 3), dtype=REAL, device=dev)
            ii = 0
            converged = False
            while ii < nIter and not converged:
                B_drag, Bmat = fowt_hydro_linearization_pre(
                    fowt, pose_eq, drag_pre, XiLast)
                F_drag = fowt_drag_excitation(fowt, pose_eq, Bmat, u0)
                B_tot = B_lin + B_drag[:, :, None]
                Z = (-w[None, None, :] ** 2 * M_lin
                     + 1j * w[None, None, :] * B_tot
                     + C_lin[:, :, None]).to(COMPLEX)
                Xi = impedance_solve(w, M_lin, B_tot, C_lin, F_lin + F_drag)
                tolCheck = torch.abs(Xi - XiLast) / (torch.abs(Xi) + tol)
                # one pull a pass: the largest relative update (all below
                # tol <=> its max below tol; a NaN fails both)
                res = float(_np(torch.max(tolCheck), "drag_fixed_point_step"))
                conv = bool(res < tol)
                obs.probes.probe("drag_fixed_point", it=ii, residual=res)
                if not conv:
                    XiLast = keep * XiLast + relax * Xi
                ii += 1
                converged = conv
            return XiLast, Xi, Z, Bmat, ii, converged

        t0 = time.perf_counter()
        XiLast, Xi, Z, Bmat, ii, converged = run_fixed_point(F_lin)
        if fowt.potSecOrder == 1:
            # internal QTF from the drag-converged first-order RAOs, then
            # re-converge with the 2nd-order forces included (reference:
            # raft_model.py:966-989)
            t0 = self._lap("first_order_fp", t0)
            beta0 = float(seastate["beta"][0])
            RAO = get_rao(Xi, seastate["zeta"][0])
            qtf4 = self._internal_qtf(ifowt, state, pose_eq, beta0, RAO)
            F2_mean[0], F2[0] = qt.hydro_force_2nd(
                qtf4, [beta0], fowt.w1_2nd, beta0, seastate["S"][0], self.w,
                device=dev)
            F_lin = F_lin + F2[0]
            t0 = self._lap("qtf", t0)
            XiLast, Xi, Z, Bmat, ii, converged = run_fixed_point(
                F_lin, Xi_init=Xi)
            self._lap("second_order_fp", t0)
            state["qtf"] = qtf4

        Xi_np, XiLast_np = transfers.device_get((Xi, XiLast),
                                                what="drag_fixed_point")
        residual = float(np.max(np.abs(Xi_np - XiLast_np)
                                / (np.abs(Xi_np) + tol)))
        lbl = dict(fowt=ifowt, case=self._case_label())
        obs.histogram(
            "raft_fixed_point_iterations",
            "drag-linearization fixed-point iterations per load case",
            buckets=obs.ITER_BUCKETS).observe(ii, **lbl)
        obs.gauge(
            "raft_fixed_point_last_iterations",
            "iterations of the most recent drag fixed point",
            ).set(ii, **lbl)
        obs.gauge(
            "raft_fixed_point_residual",
            "final relative update of the drag fixed point "
            "(|Xi_n - Xi_{n-1}| / (|Xi_n| + tol), max over DOF x freq)",
            ).set(residual, **lbl)
        if not converged:
            obs.counter(
                "raft_fixed_point_nonconverged_total",
                "drag fixed points that hit nIter without converging",
                ).inc(1, **lbl)
        cur = obs.current_span()
        if cur is not None:
            cur.set(iterations=ii, residual=residual, converged=converged)
        rec = self._case_records.setdefault(self._case_label(), {})
        rec[f"fowt{ifowt}"] = {"drag_iters": ii, "drag_residual": residual,
                               "drag_converged": converged}
        # fault seam: nan@dynamics poisons the converged impedance, so the
        # non-finite screen of solveDynamics sees a corrupt solve
        if faults.maybe_raise("dynamics", case=self._iCase,
                              fowt=ifowt) == "nan":
            Z = Z * float("nan")
        state["Z"] = Z
        state["Bmat"] = Bmat
        state["Fhydro_2nd"] = F2
        state["Fhydro_2nd_mean"] = F2_mean

    def _internal_qtf(self, ifowt, state, pose_eq, beta0, RAO):
        """The heading-0 QTF (nw2, nw2, 1, 6) from the RAOs ``RAO``: K5
        through ``calc_qtf_slender_body``, or with ``outFolderQTF`` the
        content-keyed .12d written by an earlier run (either package's),
        beside a .4 snapshot of the RAOs (reference: raft_fowt.py:
        1420-1433, 1642-1648)."""
        fowt = self.fowtList[ifowt]
        M_struc = state["statics"]["M_struc"]
        cache_path = key = None
        if self.outFolderQTF is not None:
            os.makedirs(self.outFolderQTF, exist_ok=True)
            tag = f"Head{int(round(np.rad2deg(beta0)))}"
            if self._iCase is not None:
                tag += f"_Case{self._iCase + 1}"
            tag += f"_WT{ifowt}"
            RAO_np = _np(RAO, "first_order_rao")
            qt.write_rao_4(os.path.join(self.outFolderQTF,
                                        f"raos-slender_body_{tag}.4"),
                           self.w, beta0, RAO_np)
            key = qt.cache_key(fowt, state["r6"], beta0, RAO_np, M_struc)
            cache_path = os.path.join(self.outFolderQTF,
                                      f"qtf-slender_body-total_{tag}.12d")
            key_path = cache_path + ".key"
            if os.path.isfile(cache_path) and os.path.isfile(key_path):
                with open(key_path) as f:
                    hit = f.read().strip() == key
                if hit:
                    qd = qt.read_qtf_12d(cache_path, rho=fowt.rho_water,
                                         g=fowt.g)
                    w2 = _np(fowt.w1_2nd, "qtf_grid")
                    if len(qd.w) == len(w2) and np.allclose(qd.w, w2,
                                                            rtol=1e-6):
                        return torch.as_tensor(qd.qtf, dtype=COMPLEX,
                                               device=self.device)
        with obs.span("calcQTF_slenderBody", fowt=ifowt,
                      case=self._case_label()):
            qtf4 = qt.calc_qtf_slender_body(fowt, pose_eq, beta0, Xi0=RAO,
                                            M_struc=M_struc)[:, :, None, :]
        if cache_path is not None:
            qt.write_qtf_12d(cache_path, _np(qtf4), _np(fowt.w1_2nd),
                             [beta0], rho=fowt.rho_water, g=fowt.g)
            with open(cache_path + ".key", "w") as f:
                f.write(key)
        return qtf4

    # ------------------------------------------------------------------
    # case loop
    # ------------------------------------------------------------------

    def analyzeUnloaded(self, ballast=0, heave_tol=1.0):
        """Unloaded equilibrium (reference: raft_model.py:184-241), one FOWT
        only, as in the reference, optionally preceded by the ballast
        trim: ``ballast=1`` walks fill levels until the linearized heave
        is within ``heave_tol`` (`adjustBallast`), ``ballast=2`` shifts
        the fill densities uniformly (`adjustBallastDensity`)."""
        if self.nFOWT > 1:
            raise errors.ModelConfigError(
                "analyzeUnloaded only works for a single FOWT (reference: "
                "raft_model.py:191-192)", nFOWT=self.nFOWT)
        fowt = self.fowtList[0]
        if ballast == 1:
            self.adjustBallast(fowt, heave_tol=heave_tol)
        elif ballast == 2:
            self.adjustBallastDensity(fowt)
        self.results.setdefault("properties", {})
        self.solveStatics(None)
        self.results["properties"]["offset_unloaded"] = self._state[0]["Xi0"]
        with transfers.phase("statics"):
            C, F = transfers.device_get(
                (self._state[0]["C_moor"], self._state[0]["F_moor0"]),
                what="unloaded_mooring")
        self.C_moor0 = np.array(C)
        self.F_moor0 = np.array(F)

    # ------------------------------------------------------------------
    # ballast trim
    # ------------------------------------------------------------------

    def _heave_imbalance(self, fowt):
        """(sumFz, heave, stat): net vertical force at the undisplaced pose
        and the linearized heave offset (reference: raft_model.py:
        1448-1453).  The mass, displacement, waterplane area and mooring
        heave force come to the host in one counted pull."""
        ref = np.array([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0], float)
        pose0 = fowt_pose(fowt, ref)
        stat = fowt_statics(fowt, pose0)
        Fz_moor = 0.0
        if fowt.mooring is not None:
            Fz_moor = mr.body_wrench(fowt.mooring, pose0["r6"])[2]
        with transfers.phase("statics"):
            m, V, AWP, Fz_moor = (float(x) for x in transfers.device_get(
                (stat["M_struc"][0, 0], stat["V"], stat["AWP"], Fz_moor),
                what="ballast_imbalance"))
        sumFz = -m * fowt.g + V * fowt.rho_water * fowt.g + Fz_moor
        heave = sumFz / (fowt.rho_water * fowt.g * AWP)
        return sumFz, heave, stat

    @staticmethod
    def _section_fill_volume(geom, j, l_fill):
        """Ballast volume of member section j filled to ``l_fill``, using
        the reference's convention of interpolating the inner frustum over
        the FULL member length (raft_model.py:1484-1492).  ``geom``
        holds host numpy ``d`` and ``t``, the float ``l`` and
        ``circular``."""
        l = geom.l
        if geom.circular:
            dAi = float(geom.d[j] - 2 * geom.t[j])
            dBi = float(geom.d[j + 1] - 2 * geom.t[j + 1])
            dBf = (dBi - dAi) * (l_fill / l) + dAi
            return np.pi / 12.0 * l_fill * (dAi**2 + dAi * dBf + dBf**2)
        slAi = np.asarray(geom.d[j]) - 2 * geom.t[j]
        slBi = np.asarray(geom.d[j + 1]) - 2 * geom.t[j + 1]
        slBf = (slBi - slAi) * (l_fill / l) + slAi
        A1 = slAi[0] * slAi[1]
        A2 = slBf[0] * slBf[1]
        return l_fill / 3.0 * (A1 + A2 + np.sqrt(max(A1 * A2, 0.0)))

    @staticmethod
    def _member_groups(fowt):
        """Platform members grouped by repeated-heading pattern (one yaml
        member entry per group, recorded at build time), mirroring the
        reference's one-member-per-heading-group adjustment
        (raft_model.py:1464-1467 keyed off member.headings)."""
        if fowt.platmem_groups is not None:
            return fowt.platmem_groups
        return [[i] for i in range(fowt.nplatmems)]

    def adjustBallast(self, fowt, heave_tol=1.0, display=0):
        """Walk ballast fill levels member-by-member until the linearized
        unloaded heave is within ``heave_tol`` (reference:
        raft_model.py:1434-1566).  The reference's 1 cm stepping loop is
        replaced by an exact bisection to the same rounded (2-decimal)
        fill level, on the host: the platform members' geometry comes
        over in one counted pull, each changed fill level goes back as a
        new tensor, and each section visited costs one imbalance pull.
        The initial heave is ``self.ballast_trim["heave0"]``, each visited
        section's record (group, section, start and unrounded new fill
        level, the branch taken, the heave after) in its ``"walk"``.
        Returns the final heave."""
        with temp_verbosity(int(display)), transfers.phase("statics"):
            return self._adjust_ballast_impl(fowt, heave_tol)

    def _adjust_ballast_impl(self, fowt, heave_tol):
        groups = self._member_groups(fowt)
        plat = sorted({i for group in groups for i in group})
        pulled = transfers.device_get(
            [(fowt.members[i].d, fowt.members[i].t,
              fowt.members[i].l_fill, fowt.members[i].rho_fill)
             for i in plat], what="ballast_geometry")
        host = {}
        for i, (d, t, lf, rf) in zip(plat, pulled):
            m = fowt.members[i]
            host[i] = SimpleNamespace(
                circular=m.circular, l=m.l, d=d, t=t,
                l_fill=np.array(np.atleast_1d(lf), float),
                rho_fill=np.atleast_1d(np.asarray(rf, float)))
        walk = []
        sumFz, heave, _ = self._heave_imbalance(fowt)
        self.ballast_trim = dict(heave0=heave, walk=walk, delta_rho=None)
        dmass = sumFz / fowt.g
        _LOG.info(" initial heave imbalance %.3f m", heave)
        for ig, group in enumerate(groups):
            geom0 = host[group[0]]
            for j, rho_b in enumerate(geom0.rho_fill):
                if rho_b <= 0:
                    continue
                dvol = dmass / rho_b
                mdvol = dvol / len(group)
                l = geom0.l
                l_fill0 = float(geom0.l_fill[j])
                V0 = self._section_fill_volume(geom0, j, l_fill0)
                Vtarget = V0 + mdvol
                Vmax = self._section_fill_volume(geom0, j, l)
                if Vtarget >= Vmax:
                    l_new, branch = l, "full"
                elif Vtarget <= 0.0:
                    l_new, branch = 0.0, "empty"
                else:
                    lo, hi = 0.0, l
                    for _ in range(60):
                        mid = 0.5 * (lo + hi)
                        if self._section_fill_volume(geom0, j, mid) < Vtarget:
                            lo = mid
                        else:
                            hi = mid
                    l_new, branch = 0.5 * (lo + hi), "bisect"
                unrounded = l_new
                l_new = round(l_new, 2)
                for imem in group:
                    lf = host[imem].l_fill
                    lf[j] = l_new
                    fowt.members[imem].l_fill = to_device(
                        np.array(lf), self.device, dtype=REAL)
                sumFz, heave, _ = self._heave_imbalance(fowt)
                walk.append(dict(
                    group=ig, member=group[0], section=j, l_fill0=l_fill0,
                    l_new_unrounded=unrounded, l_new=l_new, branch=branch,
                    heave=heave))
                _LOG.info(" member %s section %d: l_fill -> %.2f m, "
                          "heave %.3f m", fowt.members[group[0]].name, j,
                          l_new, heave)
                if abs(heave) < heave_tol:
                    return heave
                dmass = sumFz / fowt.g
        return heave

    def adjustBallastDensity(self, fowt, display=0):
        """Uniform ballast-density shift to zero the unloaded heave —
        closed form (reference: raft_model.py:1569-1624;
        ``models.fowt.ballast_density_trim``, which the variant sweep
        shares).  Fill levels are zeroed where the fill density is zero;
        the shift and the ballast volume come to the host in one counted
        pull; the new fill levels and densities replace the members'
        tensors.  Returns the density shift [kg/m^3] (also in
        ``self.ballast_trim["delta_rho"]``)."""
        ref = self._t([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0])
        pose0 = fowt_pose(fowt, ref)
        with transfers.phase("statics"):
            l_fill, rho_fill, delta, _, vb = ballast_density_trim(
                fowt, pose0, ref)
            delta, ballast_volume = (float(x) for x in transfers.device_get(
                (delta, vb), what="ballast_density"))
            for m, lf in zip(fowt.members, l_fill):
                m.l_fill = lf
            if ballast_volume <= 0:
                raise errors.ModelConfigError(
                    "adjustBallastDensity needs a platform with ballast "
                    "volume")
            heave = self._heave_imbalance(fowt)[1] if display else None
            for m, rf in zip(fowt.members, rho_fill):
                m.rho_fill = rf
        self.ballast_trim = dict(heave0=None, walk=[], delta_rho=delta)
        if display:
            with temp_verbosity(max(int(display), 1)):
                _, heave_new, _ = self._heave_imbalance(fowt)
                _LOG.info(" ballast density shifted %+.3f kg/m3; "
                          "heave %.3f -> %.3f m", delta, heave, heave_new)
        return delta

    def analyzeCases(self, display=0, resume=False):
        """Statics + dynamics + output statistics per load case; the
        result ledger lands on ``self.last_ledger`` and the wall seconds
        per phase (every ladder rung included) on ``self.timings``, the
        case journal's (its key digest, reads and writes) as
        ``timings["journal"]``.

        Fault tolerance: a recoverable failure of a case's statics or
        dynamics walks the degradation ladder (``recovery.py``), every
        transition recorded in ``self.recovery_attempts``; a case the
        ladder cannot save is quarantined — a structured record in
        ``self.failed_cases``, a ``case{N}/failed`` ledger entry and
        ``last_ledger["extra"]["failed_cases"]`` — while the other cases
        run, and when no case survives the last failure is raised.  Each
        completed case is journaled; ``resume=True`` restores the cases
        this model's journal holds (``self.resumed_cases``) and re-runs
        the others.  A kernel that fails to build, load or launch raises
        at once; ``RAFT_TPU_RECOVERY=0`` turns ladder and quarantine
        off.

        Observability: span ``analyzeCases`` around the case loop, the
        ``case_start`` / ``case_end`` / ``quarantine`` events, and a
        ``RunManifest`` (``self.last_manifest``: the config, the phase
        walls, the metrics, the host transfers of this run per phase and
        per case, the failed cases, the ladder's attempts, the resumed
        cases, ``timings``) finished at the end and written, with the
        Chrome trace, the ledger and the event stream, under
        ``obs.out_dir()`` when one is set."""
        nCases = len(self.design["cases"]["data"])
        obs.device.jit_cache_delta(scope="analyzeCases")   # baseline
        manifest = obs.RunManifest.begin(kind="analyzeCases", config={
            "nCases": nCases, "nFOWT": self.nFOWT, "nw": self.nw,
            "nDOF": self.nDOF, "nIter": self.nIter, "depth": self.depth,
            "device": str(self.device)})
        obs.record_build_info(run_id=manifest.run_id)
        #: the run manifest of the most recent analyzeCases
        self.last_manifest = manifest
        transfers0 = transfers.snapshot()
        self._case_records = {}
        self.timings = {"statics": 0.0, "dynamics": 0.0, "outputs": 0.0,
                        "journal": 0.0}
        self.results["properties"] = self.results.get("properties", {})
        self.results["case_metrics"] = {}
        self.results["mean_offsets"] = []
        #: structured records of this run's quarantined cases
        self.failed_cases = []
        #: the ladder transitions of this run (recovery.RecoveryAttempt)
        self.recovery_attempts = []
        #: the cases this run restored from the journal
        self.resumed_cases = []
        status = "failed"
        ledger = None
        try:
            with obs.span("analyzeCases", nCases=nCases, nFOWT=self.nFOWT):
                self._analyze_cases_impl(nCases, display, resume)
            status = "ok"
            ledger = self.last_ledger = _ledger.ledger_from_model(
                self, run_id=manifest.run_id)
        finally:
            self._iCase = None
            self._finish_manifest(manifest, status, ledger, transfers0,
                                  nCases)
        return self.results

    def _finish_manifest(self, manifest, status, ledger, transfers0,
                         nCases):
        """Fold this run's facts into ``manifest`` and finish it (written
        under ``obs.out_dir()`` with the trace, ``ledger`` and events)."""
        xfers = transfers.delta(transfers0, transfers.snapshot())
        xfers["per_case"] = {ph: round(rec["events"] / max(nCases, 1), 3)
                             for ph, rec in xfers["phases"].items()}
        manifest.extra["host_transfers"] = xfers
        manifest.extra["failed_cases"] = list(self.failed_cases)
        # the dispatch facts without their tensors (a read would sync)
        manifest.extra["solver"] = {
            k: v for k, v in last_dispatch().items()
            if not isinstance(v, torch.Tensor)}
        if self.recovery_attempts:
            manifest.extra["recovery"] = {
                "attempts": [a.to_dict() for a in self.recovery_attempts]}
        if self.resumed_cases:
            manifest.extra["resumed_cases"] = list(self.resumed_cases)
        manifest.extra["timings"] = dict(self.timings)
        if status == "ok":
            obs.device.collect(manifest, scope="analyzeCases")
        paths = obs.finish_run(manifest, status=status, ledger=ledger)
        if paths["manifest"]:
            _LOG.info("run manifest: %s  trace: %s  ledger: %s",
                      paths["manifest"], paths["trace"], paths["ledger"])

    # ---- cross-case carry state (retry and resume bookkeeping) ----------

    def _snapshot_carry(self) -> dict:
        """Host copy of the state one case hands the next: the
        stale-heading hub-transfer quirk, a pending mean-drift forcing and
        an array's free points.  Restored before each statics attempt (a
        retry sees the heading the first attempt did) and journaled after
        each case (a resumed run reproduces a continuous one)."""
        return {
            "stored_heading": [
                None if st.get("_stored_heading") is None
                else list(st["_stored_heading"]) for st in self._state],
            "F_meandrift": [
                None if "F_meandrift" not in st
                else np.array(_np(st["F_meandrift"], "carry"))
                for st in self._state],
            "arr_xf": (None if self._arr_xf is None
                       else np.array(_np(self._arr_xf, "carry"))),
        }

    def _restore_carry(self, carry: dict):
        """Put a `_snapshot_carry` back, its tensors on ``self.device``."""
        for st, heads, fmd in zip(self._state, carry["stored_heading"],
                                  carry["F_meandrift"]):
            if heads is None:
                st.pop("_stored_heading", None)
            else:
                st["_stored_heading"] = list(heads)
            if fmd is None:
                st.pop("F_meandrift", None)
            else:
                st["F_meandrift"] = self._t(fmd)
        self._arr_xf = (None if carry["arr_xf"] is None
                        else self._t(carry["arr_xf"]))

    def _case_journal(self):
        """This model's case journal, or None when journaling is off
        (``RAFT_TPU_JOURNAL=0``) or its directory is unusable."""
        if not recovery.journal_enabled():
            return None
        try:
            return recovery.CaseJournal.for_model(self)
        # journaling is optional resilience: an unusable journal directory
        # must never take analyzeCases down
        except Exception as e:
            _LOG.warning("case journal unavailable: %s", e)
            return None

    @contextlib.contextmanager
    def _timed(self, key):
        """Add the wall of the block (after a device sync) to
        ``timings[key]``, also when it raises."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._lap(key, t0)

    def _analyze_cases_impl(self, nCases, display, resume):
        with self._timed("journal"), transfers.phase("journal"):
            journal = self._case_journal()
        quarantine = recovery.enabled()
        last_err = None
        for iCase in range(nCases):
            case = dict(zip(self.design["cases"]["keys"],
                            self.design["cases"]["data"][iCase]))
            case["iCase"] = iCase
            self._iCase = iCase
            if resume and journal is not None:
                with self._timed("journal"):
                    entry = journal.load_case(iCase)
                if entry is not None:
                    self._resume_case(iCase, entry)
                    continue
            self.results["case_metrics"][iCase] = {}
            with transfers.phase("journal"):
                carry0 = self._snapshot_carry()
            # per-case progress on the flight recorder, as it happens
            obs.events.emit("case_start", case=iCase, n_cases=nCases)
            t_case = time.perf_counter()
            ok = False
            try:
                with faults.context(case=iCase):
                    self._run_one_case(iCase, case, display, carry0)
                ok = True
            except errors.RECOVERABLE as e:
                if not quarantine or not errors.recoverable(e):
                    raise
                last_err = e
                self._quarantine_case(iCase, e)
            finally:
                obs.events.emit(
                    "case_end", case=iCase, n_cases=nCases, ok=ok,
                    s=round(time.perf_counter() - t_case, 3))
                # keep the mean-offset list aligned with the case index (a
                # failed case may have appended 0 or 1 entries)
                offs = self.results["mean_offsets"]
                del offs[iCase + 1:]
                while len(offs) < iCase + 1:
                    offs.append(np.full(self.nDOF, np.nan))
            if ok and journal is not None:
                # host values only: the outputs are numpy, the carry is
                # pulled to the host
                with self._timed("journal"), transfers.phase("journal"):
                    journal.store_case(iCase, {
                        "case_metrics": self.results["case_metrics"][iCase],
                        "mean_offset": np.array(
                            self.results["mean_offsets"][iCase], float),
                        "case_record": self._case_records.get(
                            str(iCase), {}),
                        "carry": self._snapshot_carry()})
        if self.failed_cases and len(self.failed_cases) == nCases:
            # nothing survived: raise instead of an all-quarantined result
            raise last_err
        return self.results

    def _run_one_case(self, iCase, case, display, carry0):
        """One load case: statics and dynamics through the degradation
        ladder, the mean-drift statics re-solve under second-order loads,
        the output statistics and an array's tension statistics."""

        def statics_fn():
            # every attempt starts from the carry the first one saw (the
            # stale heading advances inside _case_constants)
            self._restore_carry(carry0)
            return self.solveStatics(case, display=display)

        def ladder(phase, fn, steps):
            return recovery.run_ladder(phase, str(iCase), fn, steps,
                                       recorder=self.recovery_attempts.append)

        with self._timed("statics"):
            ladder("statics", statics_fn, recovery.statics_ladder())
        with self._timed("dynamics"):
            ladder("dynamics",
                   lambda: self.solveDynamics(case, display=display),
                   recovery.dynamics_ladder())
        if any(f.potSecOrder > 0 for f in self.fowtList):
            # re-solve the operating point with the mean wave drift
            # included, then clear it so it cannot leak into the next case
            # (reference: raft_model.py:296-303)
            self.results["mean_offsets"].pop()   # superseded
            with self._timed("drift_statics"):
                ladder("statics",
                       lambda: self.solveStatics(case, display=display),
                       recovery.statics_ladder())
            for st in self._state:
                st.pop("F_meandrift", None)
        with self._timed("outputs"), transfers.phase("outputs"):
            for i in range(self.nFOWT):
                self.results["case_metrics"][iCase][i] = {}
                with obs.span("saveTurbineOutputs", fowt=i,
                              case=str(iCase)):
                    self.saveTurbineOutputs(
                        self.results["case_metrics"][iCase][i], i, case)
            if self.arr_ms is not None:
                self.results["case_metrics"][iCase]["array_mooring"] = \
                    self._array_tension_stats(iCase)

    def _quarantine_case(self, iCase, err: errors.RaftError):
        """Record a case the ladder could not save and keep the run going:
        a structured failure record replaces its metrics."""
        rec = {"case": int(iCase), **err.context()}
        self.failed_cases.append(rec)
        self.results["case_metrics"][iCase] = {"failed": rec}
        self._case_records.pop(str(iCase), None)
        # a failed case's mean offset is always the NaN marker, also when
        # its statics passed and its dynamics failed
        offs = self.results["mean_offsets"]
        if len(offs) > iCase:
            offs[iCase] = np.full(self.nDOF, np.nan)
        # a completed case never hands F_meandrift on (the clean flow pops
        # it after the drift re-solve); a quarantined one must not either.
        # The advanced _stored_heading stays, as in the clean flow.
        for state in self._state:
            state.pop("F_meandrift", None)
        obs.counter(
            "raft_tpu_cases_failed_total",
            "load cases quarantined by analyzeCases after the "
            "degradation ladder was exhausted, by phase").inc(
            1.0, phase=rec.get("phase", "unknown"))
        obs.events.emit(
            "quarantine", case=int(iCase),
            phase=rec.get("phase", "unknown"),
            error=rec.get("error", type(err).__name__))
        cur = obs.current_span()
        if cur is not None:
            cur.set(failed_cases=len(self.failed_cases))
        _LOG.error("case %d quarantined: %s", iCase, err)

    def _resume_case(self, iCase, entry):
        """Restore one journaled case: its metrics, ledger record and the
        carry it handed on; its solves do not run (span
        ``case_resumed``)."""
        with obs.span("case_resumed", case=str(iCase)):
            self.results["case_metrics"][iCase] = entry["case_metrics"]
            offs = self.results["mean_offsets"]
            del offs[iCase:]
            while len(offs) < iCase:
                offs.append(np.full(self.nDOF, np.nan))
            offs.append(np.array(entry["mean_offset"], float))
            if entry.get("case_record"):
                self._case_records[str(iCase)] = entry["case_record"]
            self._restore_carry(entry["carry"])
        self.resumed_cases.append(int(iCase))
        obs.events.emit("case_end", case=int(iCase), ok=True,
                        resumed=True, s=0.0,
                        n_cases=len(self.design["cases"]["data"]))
        obs.counter(
            "raft_tpu_cases_resumed_total",
            "load cases restored from the per-case journal instead of "
            "re-solved").inc(1.0)
        _LOG.info("case %d restored from the journal", iCase)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    def _array_tension_stats(self, iCase) -> dict:
        """Tension statistics of every line of the array mooring through
        its coupled tension Jacobian (reference: raft_model.py:345-388),
        NaN channels when the Jacobian or the tensions are not finite, as
        in the JAX Model."""
        dw = self.w[1] - self.w[0]
        Xb = self._t(np.stack([st["r6"] for st in self._state]))
        J = _np(ma.tension_jacobian(self.arr_ms, Xb, self._arr_xf))
        T0 = _np(ma.tensions(self.arr_ms, Xb, self._arr_xf))
        nT = len(T0)
        if not (np.all(np.isfinite(J)) and np.all(np.isfinite(T0))):
            nan_t = np.full(nT, np.nan)
            return {"Tmoor_avg": nan_t, "Tmoor_std": nan_t.copy(),
                    "Tmoor_max": nan_t.copy(), "Tmoor_min": nan_t.copy(),
                    "Tmoor_PSD": np.full((nT, self.nw), np.nan)}
        T_amps = np.einsum("tj,hjw->htw", J, self.Xi)
        TRMS = np.array([float(get_rms(T_amps[:, iT, :]))
                         for iT in range(nT)])
        return {"Tmoor_avg": T0, "Tmoor_std": TRMS,
                "Tmoor_max": T0 + 3 * TRMS, "Tmoor_min": T0 - 3 * TRMS,
                "Tmoor_PSD": np.stack([
                    _hnp(get_psd(T_amps[:, iT, :], dw, source_axis=0))
                    for iT in range(nT)])}

    def saveTurbineOutputs(self, results, ifowt, case):
        """Per-case response statistics (reference: raft_fowt.py:
        1821-2109), host NumPy on the pulled response."""
        fowt = self.fowtList[ifowt]
        state = self._state[ifowt]
        Xi = state["Xi"]          # (nWaves+1, 6, nw)
        Xi0 = state["Xi0"]
        dw = self.w[1] - self.w[0]
        rms = lambda x: float(get_rms(x))                       # noqa: E731
        psd = lambda x, ax=0: _hnp(get_psd(x, dw, source_axis=ax))  # noqa: E731

        chans = ["surge", "sway", "heave", "roll", "pitch", "yaw"]
        for idof, ch in enumerate(chans):
            sig = Xi[:, idof, :]
            mean = Xi0[idof]
            if idof >= 3:
                sig = sig * RAD2DEG
                mean = mean * RAD2DEG
            std = rms(sig)
            results[f"{ch}_avg"] = mean
            results[f"{ch}_std"] = std
            results[f"{ch}_max"] = mean + 3 * std
            results[f"{ch}_min"] = mean - 3 * std
            results[f"{ch}_PSD"] = psd(sig)
            results[f"{ch}_RA"] = np.asarray(sig)

        # first-heading RAO magnitude/phase summaries per DOF
        RAO0 = _hnp(get_rao(Xi[0], state["seastate"]["zeta"][0]))
        mag = np.abs(RAO0)
        for idof, ch in enumerate(chans):
            ipk = int(np.argmax(mag[idof]))
            results[f"{ch}_RAO_mag_max"] = float(mag[idof, ipk])
            results[f"{ch}_RAO_mag_mean"] = float(mag[idof].mean())
            results[f"{ch}_RAO_phase_peak"] = (
                float(np.angle(RAO0[idof, ipk]))
                if mag[idof, ipk] > 1e-12 else 0.0)
            results[f"{ch}_RAO_w_peak"] = float(self.w[ipk])

        # mooring tensions through the MoorPy-parity FD tension Jacobian
        moor = fowt.mooring
        if moor is not None:
            r6 = self._t(state["r6"])
            cur = state.get("moor_current")
            cur_t = None if cur is None else self._t(cur)
            # (a general topology re-solves its free points at each of
            # the 12 perturbed poses; Tmoor then covers every segment end)
            J = _np(mr.tension_jacobian_fd(moor, r6, current=cur_t))
            T0 = _np(mr.tensions(moor, r6, current=cur_t))
            nT = len(T0)
            T_amps = np.einsum("tj,hjw->htw", J, Xi)
            results["Tmoor_avg"] = T0
            TRMS = np.array([rms(T_amps[:, iT, :]) for iT in range(nT)])
            results["Tmoor_std"] = TRMS
            results["Tmoor_max"] = T0 + 3 * TRMS
            results["Tmoor_min"] = T0 - 3 * TRMS
            results["Tmoor_PSD"] = np.stack([psd(T_amps[:, iT, :])
                                             for iT in range(nT)])

        # nacelle acceleration + tower base bending (reference :1900-1971)
        nrot = fowt.nrotors
        XiHub = np.zeros((Xi.shape[0], nrot, self.nw), dtype=complex)
        for key in ("AxRNA", "Mbase"):
            results[f"{key}_avg"] = np.zeros(nrot)
            results[f"{key}_std"] = np.zeros(nrot)
            results[f"{key}_max"] = np.zeros(nrot)
            results[f"{key}_min"] = np.zeros(nrot)
            results[f"{key}_PSD"] = np.zeros((self.nw, nrot))

        stat = state["statics"]
        tc = state.get("turbine")
        for ir, rot in enumerate(fowt.rotors):
            r_rel = np.asarray(rot.r_rel, float)
            XiHub[:, ir, :] = Xi[:, 0, :] + r_rel[2] * Xi[:, 4, :]
            a_std = rms(XiHub[:, ir, :] * self.w**2)
            results["AxRNA_std"][ir] = a_std
            results["AxRNA_PSD"][:, ir] = psd(XiHub[:, ir, :] * self.w**2)
            results["AxRNA_avg"][ir] = abs(np.sin(Xi0[4]) * 9.81)
            results["AxRNA_max"][ir] = results["AxRNA_avg"][ir] + 3 * a_std
            results["AxRNA_min"][ir] = results["AxRNA_avg"][ir] - 3 * a_std

            mtow = _f(stat["mtower"][ir]) if stat["mtower"] else 0.0
            if mtow > 0:
                rCGt = _np(stat["rCG_tow"][ir])
                m_turb = mtow + rot.mRNA
                zCGt = (rCGt[2] * mtow + r_rel[2] * rot.mRNA) / m_turb
                tower_geom = fowt.members[fowt.nplatmems + ir]
                tower_pose = state["pose_eq"]["members"][fowt.nplatmems + ir]
                zBase = _f(tower_pose["rA"][2])
                hArm = zCGt - zBase
                aCG = -self.w**2 * (Xi[:, 0, :] + zCGt * Xi[:, 4, :])
                tower_M = member_inertia(tower_geom, tower_pose,
                                         rPRP=self._t(state["r6"][:3]))["M_struc"]
                ICGt = (_f(translate_matrix_6to6(
                    tower_M, self._t([0, 0, -zCGt]))[4, 4])
                    + rot.mRNA * (r_rel[2] - zCGt) ** 2 + rot.IrRNA)
                M_I = -m_turb * aCG * hArm - ICGt * (-self.w**2 * Xi[:, 4, :])
                M_w = m_turb * fowt.g * hArm * Xi[:, 4, :]
                if tc is not None:
                    A00 = _np(tc["A_aero"][0, 0, :, ir])
                    B00 = _np(tc["B_aero"][0, 0, :, ir])
                else:
                    A00 = B00 = np.zeros(self.nw)
                M_X = -(-self.w**2 * A00 + 1j * self.w * B00) \
                    * (r_rel[2] - zBase) ** 2 * Xi[:, 4, :]
                dyn = M_I + M_w + M_X
                f_aero0_ir = tc["f_aero0"][:, ir] if tc is not None \
                    else torch.zeros(6, dtype=REAL, device=self.device)
                results["Mbase_avg"][ir] = (
                    m_turb * fowt.g * hArm * np.sin(Xi0[4])
                    + _f(transform_force(f_aero0_ir,
                                         offset=self._t([0, 0, -hArm]))[4]))
                results["Mbase_std"][ir] = rms(dyn)
                results["Mbase_PSD"][:, ir] = psd(dyn)
                results["Mbase_max"][ir] = results["Mbase_avg"][ir] + 3 * results["Mbase_std"][ir]
                results["Mbase_min"][ir] = results["Mbase_avg"][ir] - 3 * results["Mbase_std"][ir]

        results["wave_PSD"] = psd(state["seastate"]["zeta"])

        # cavitation check of submerged rotors (reference:
        # raft_fowt.py:2047-2049)
        if "cavitation" in state:
            results["cavitation"] = state["cavitation"]

        # rotor control channels (reference :1976-2045)
        for key in ("omega", "torque", "power", "bPitch"):
            results[f"{key}_avg"] = np.zeros(nrot)
            results[f"{key}_std"] = np.zeros(nrot)
            if key != "power":
                results[f"{key}_PSD"] = np.zeros((self.nw, nrot))
        results["omega_max"] = np.zeros(nrot)
        results["omega_min"] = np.zeros(nrot)

        for ir, rot in enumerate(fowt.rotors):
            current = rot.hubHt < 0
            speed = float(get_from_dict(case, "current_speed", shape=0, default=1.0)) \
                if current else float(get_from_dict(case, "wind_speed", shape=0, default=10.0))
            if rot.aeroServoMod > 1 and speed > 0.0:
                # the control transfer function of the STATICS-TIME calcAero
                # (zero pose), as in the reference
                X0r = self._t([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0])
                aero = calc_aero(rot, self._t(self.w), case, r6=X0r,
                                 current=current)
                C = _np(aero["C"])
                V_w = _np(aero["V_w"])
                kp_beta = -np.interp(speed, rot.Uhub_ops, rot.kp_0)
                ki_beta = -np.interp(speed, rot.Uhub_ops, rot.ki_0)
                kp_tau = rot.kp_tau * (kp_beta == 0)
                ki_tau = rot.ki_tau * (ki_beta == 0)
                nh = Xi.shape[0]
                phi_w = np.zeros((nh, self.nw), dtype=complex)
                for ih in range(nh - 1):
                    phi_w[ih] = C * XiHub[ih, ir, :]
                phi_w[-1] = C * (XiHub[-1, ir, :] - V_w / (1j * self.w))
                omega_w = 1j * self.w * phi_w
                torque_w = (1j * self.w * kp_tau + ki_tau) * phi_w
                bPitch_w = (1j * self.w * kp_beta + ki_beta) * phi_w

                results["omega_avg"][ir] = float(aero["op"]["Omega_rpm"])
                results["omega_std"][ir] = rms(omega_w) / 0.1047
                results["omega_max"][ir] = results["omega_avg"][ir] + 2 * results["omega_std"][ir]
                results["omega_min"][ir] = results["omega_avg"][ir] - 2 * results["omega_std"][ir]
                results["omega_PSD"][:, ir] = (1 / 0.1047) ** 2 * psd(omega_w)
                results["torque_avg"][ir] = _f(aero["loads"]["Q"]) / rot.Ng
                results["torque_std"][ir] = rms(torque_w)
                results["torque_PSD"][:, ir] = psd(torque_w)
                results["power_avg"][ir] = _f(aero["loads"]["P"])
                results["bPitch_avg"][ir] = float(aero["op"]["pitch_deg"])
                results["bPitch_std"][ir] = rms(bPitch_w) * RAD2DEG
                results["bPitch_PSD"][:, ir] = RAD2DEG**2 * psd(bPitch_w)
                results["wind_PSD"] = psd(V_w, None)

    def calcOutputs(self):
        """Fill results['properties'] (reference: raft_model.py:1150-1189);
        an array's are left empty, as the reference fills them for one
        FOWT only (raft_model.py:1153)."""
        if self.nFOWT > 1:
            return self.results
        fowt = self.fowtList[0]
        state = self._state[0]
        stat = state["statics"]
        props = self.results.setdefault("properties", {})
        props["tower mass"] = np.asarray([_np(m) for m in stat["mtower"]])
        props["tower CG"] = np.asarray([_np(c) for c in stat["rCG_tow"]])
        props["substructure mass"] = _f(stat["m_sub"])
        props["substructure CG"] = _np(stat["rCG_sub"])
        props["shell mass"] = _f(stat["m_shell"])
        props["total mass"] = _f(stat["m"])
        props["total CG"] = _np(stat["rCG"])
        # ballast masses grouped by unique fill density (reference:
        # raft_fowt.py:505-516)
        mball = np.concatenate([np.atleast_1d(_np(m)) for m in stat["mballast"]]) \
            if stat["mballast"] else np.zeros(0)
        pball = np.concatenate([np.atleast_1d(_np(p)) for p in stat["pballast"]]) \
            if stat["pballast"] else np.zeros(0)
        pb = []
        for p in pball:
            if p != 0 and p not in pb:
                pb.append(p)
        props["ballast densities"] = np.asarray(pb)
        props["ballast mass"] = np.asarray([mball[pball == p].sum() for p in pb])
        props["roll inertia at subCG"] = _f(stat["Ixx_sub"])
        props["pitch inertia at subCG"] = _f(stat["Iyy_sub"])
        props["yaw inertia at subCG"] = _f(stat["Izz_sub"])
        props["buoyancy (pgV)"] = fowt.rho_water * fowt.g * _f(stat["V"])
        props["center of buoyancy"] = _np(stat["rCB"])
        props["C hydrostatic"] = _np(stat["C_hydro"])
        C_moor0 = getattr(self, "C_moor0", _np(state["C_moor"]))
        props["C system"] = _np(stat["C_struc"] + stat["C_hydro"]) + C_moor0
        props["F_lines0"] = getattr(self, "F_moor0", _np(state["F_moor0"]))
        props["C_lines0"] = C_moor0
        hc = state.get("hydro0")
        A_morison = _np(hc["A_hydro_morison"]) if hc is not None \
            else np.zeros((6, 6))
        props["A matrix"] = A_morison
        A_BEM, _ = bem_coeffs(fowt.bem, self.nw)
        props["M support structure"] = _np(stat["M_struc_sub"])
        props["A support structure"] = A_morison + _np(A_BEM[:, :, -1])
        props["C support structure"] = _np(stat["C_struc_sub"] + stat["C_hydro"]) \
            + C_moor0
        return self.results

    # ------------------------------------------------------------------
    # farms: the batched farm sweep and the wake module
    # ------------------------------------------------------------------

    def sweep_farm(self, cases=None, **kw):
        """The batched farm sweep (``parallel/sweep.py:sweep_farm``): every
        turbine x every case of this array in one batch on the model's
        device, wake-coupled through the batched wake equilibrium.

        ``cases``: optional dict of per-case arrays (``Hs``, ``Tp``,
        ``beta`` [rad], ``U_inf``, ``wind_dir`` [deg]); by default this
        design's ``cases`` table.  ``kw`` goes to the farm solver
        (``k_w``, ``aero``, ``nIter``, ...).  The batch replicates
        ``fowtList[0]`` at every layout position (a homogeneous farm; a
        warning says when the array mixes designs or headings).  When
        `solveStatics` has solved the array mooring, the 6x6 diagonal
        blocks of its stiffness are added to the base platform's own
        mooring stiffness (the lanes are independent solves, so the
        off-diagonal coupling blocks are dropped), as the JAX Model does.
        Returns the farm outputs, (n_turbines, ncases, ...) tensors, also
        kept in ``results["farm"]`` as NumPy."""
        import warnings

        from raft_tpu_torch.parallel import sweep as _sweep

        fowt = self.fowtList[0]
        n = self.nFOWT
        arr = self.design.get("array")
        if arr:
            rows = [dict(zip(arr["keys"], r)) for r in arr["data"]]
            hetero = {(r.get("turbineID", 1), r.get("platformID", 1),
                       r.get("mooringID", 1),
                       float(r.get("heading_adjust", 0.0))) for r in rows}
            if len(hetero) > 1:
                warnings.warn(
                    "sweep_farm replicates the first FOWT at every layout "
                    "position — this array mixes platform/turbine/mooring "
                    "IDs or heading adjustments, which only the serial "
                    "analyzeCases path preserves", stacklevel=2)
        xy = np.array([[f.x_ref, f.y_ref] for f in self.fowtList])
        # own mooring at the BASE reference position (translation
        # invariant) plus the array mooring's diagonal block
        r6_ref = self._t([fowt.x_ref, fowt.y_ref, 0, 0, 0, 0])
        C_base = (mr.coupled_stiffness_rotvec(fowt.mooring, r6_ref)
                  if fowt.mooring is not None
                  else torch.zeros((6, 6), dtype=REAL, device=self.device))
        C_moor_t = C_base.expand(n, 6, 6).clone()
        if self._K_array is not None:
            Kb = self._K_array.reshape(n, 6, n, 6)
            C_moor_t = C_moor_t + torch.stack([Kb[i, :, i, :]
                                               for i in range(n)])
        elif self.arr_ms is not None:
            warnings.warn(
                "array_mooring present but statics not solved — run "
                "solveStatics first so sweep_farm can include the "
                "shared-line stiffness blocks", stacklevel=2)
        if cases is None:
            ctab = self.design.get("cases")
            if not ctab:
                raise errors.ModelConfigError(
                    "sweep_farm needs a cases= dict or a design 'cases' "
                    "table")
            rows = [dict(zip(ctab["keys"], r)) for r in ctab["data"]]

            def _ws(r):
                v = r.get("wind_speed", 10.0)
                return float(np.max(v)) if np.ndim(v) > 0 else float(v)

            def _wd(r):
                v = r.get("wind_heading", 0.0)
                return float(np.mean(v)) if np.ndim(v) > 0 else float(v)

            cases = {
                "Hs": [float(r.get("wave_height", 0.0)) for r in rows],
                "Tp": [float(r.get("wave_period", 10.0)) for r in rows],
                "beta": [np.deg2rad(float(r.get("wave_heading", 0.0)))
                         for r in rows],
                "U_inf": [_ws(r) for r in rows],
                "wind_dir": [_wd(r) for r in rows]}
        kw.setdefault("nIter", self.nIter)
        kw.setdefault("XiStart", self.XiStart)
        out = _sweep.sweep_farm(
            fowt, xy, cases["Hs"], cases["Tp"], cases["beta"],
            cases["U_inf"], cases.get("wind_dir"), C_moor_t=C_moor_t,
            device=self.device, **kw)
        with transfers.phase("farm"):
            host = transfers.device_get(
                {k: out[k] for k in ("std", "U_wake", "aero_power",
                                     "wake_iters")}, what="farm_results")
        self.results["farm"] = {
            "n_turbines": n, "ncases": int(np.asarray(cases["Hs"]).size),
            **host}
        return out

    def powerThrustCurve(self, speeds=None, ifowt=0):
        """Cp / Ct / power / pitch tables against wind speed from the BEM
        rotor (reference: raft_model.py:1674-1750)."""
        from raft_tpu_torch.models.wake import power_thrust_curve
        return power_thrust_curve(self, speeds=speeds, ifowt=ifowt)

    def findWakeEquilibrium(self, case, k_w=0.05, **kw):
        """Farm wake fixed point with the Gaussian-deficit model
        (reference: raft_model.py:1852-1994 florisFindEquilibrium); the
        returned case carries per-turbine wind speeds for analyzeCases."""
        from raft_tpu_torch.models.wake import find_wake_equilibrium
        return find_wake_equilibrium(self, case, k_w=k_w, **kw)

    def calcAEP(self, wind_rose, **kw):
        """Wind-rose AEP with wake losses (reference: raft_model.py:
        1996-2022 florisCalcAEP)."""
        from raft_tpu_torch.models.wake import calc_aep
        return calc_aep(self, wind_rose, **kw)

    def preprocess_BEM(self, dw=0.05, wMax=3.0, mesh_dir=None,
                       headings=None, dz=None, da=None):
        """Re-run the native BEM core on the grid ``dw`` to ``wMax``
        [rad/s] and write WAMIT-format .1/.3 coefficient files plus the
        panel mesh (reference: raft_model.py:1310-1330 preprocess_HAMS).
        One output directory per FOWT (``mesh_dir`` gets a ``_WT{i}``
        suffix for i > 0).  The solve runs on the host; a library that
        fails to build or load raises ``KernelFailure``.  Returns the
        per-FOWT `BEMData` (numpy)."""
        w_bem = np.arange(dw, wMax + 0.5 * dw, dw)
        out = []
        for i, fowt in enumerate(self.fowtList):
            d = mesh_dir if (mesh_dir is None or i == 0) \
                else f"{mesh_dir}_WT{i}"
            out.append(solve_bem_fowt(fowt, headings=headings, dz=dz, da=da,
                                      w_bem=w_bem, mesh_dir=d,
                                      max_freqs=len(w_bem)))
        return out


def run_raft(design_or_path, ballast=False, device=None):
    """Convenience entry point (reference: raft_model.py:2024-2061):
    Model -> analyzeUnloaded -> analyzeCases -> calcOutputs, with
    ``ballast=True`` the unloaded statics preceded by the fill-level walk
    (``analyzeUnloaded(ballast=1)``, as the JAX package's run_raft); a farm
    (nFOWT > 1) runs Model -> analyzeCases, as the reference's
    runRAFTFarm (raft_model.py:2065-2095).  A design dict, a path to a
    YAML file, or the name of a vendored design."""
    if isinstance(design_or_path, str):
        from raft_tpu_torch.io.designs import load_design
        design = load_design(design_or_path)
    else:
        design = design_or_path
    model = Model(design, device=device)
    if model.nFOWT > 1:
        model.analyzeCases()
        return model
    model.analyzeUnloaded(ballast=1 if ballast else 0)
    model.analyzeCases()
    model.calcOutputs()
    return model
