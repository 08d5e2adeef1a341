"""Batch invariance and cost of the drag linearization's forms on the card.

A lane of ``sweep_cases`` must not depend on the lanes solved beside it:
``sweep_cases_chunked`` promises chunks bitwise equal to one sweep over
the whole table, and the lane quarantine splices re-solved lanes back.
A batched GEMM (``torch.einsum`` with a lane axis) on the card rounds by
batch size, so ``models/fowt.fowt_hydro_linearization_pre`` writes its
contractions as element-wise products and sums.  This script holds four
forms of that function against each other on the card:

- ``einsum``: every contraction a batched GEMM (the port through PR 12);
- ``partial``: the motion-spectrum form and the quadratic forms
  element-wise, ``b`` and ``D`` by einsum;
- ``loop``: every contraction element-wise, ``b`` and ``D`` one DOF at
  a time as two products of real and imaginary parts, a sum and a sum
  over frequency;
- ``elementwise``: ``models/fowt.py`` as it is (``b``, ``D`` and the
  motion-spectrum form one product of the interleaved real views and
  one sum).

For each of three sweep shapes (phase 5's OC3spar, 1024 cases x 80 bins;
phase 10's RM1, 256 x 400; phase 12's OC4semi with MCF columns, 1024 x
80, the most nodes) it prints one JSON line: the time of one call of
each form at the full batch (CUDA events, the median of 20 after 3 warm
calls), each form's largest deviation from ``einsum``, and, for lane
slices of 3, 24 and 100 cases and the first 256, the largest deviation of
each stage of a drag pass (the setup, each form, the drag excitation,
the impedance solve on K1) and of a whole ``sweep_cases`` over the slice
from the same lanes of the full batch.  Run on a machine with a CUDA
card, from the repository root::

    python3 probe_drag_forms.py

It exits 1 without a card.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SLICES = ((0, 3), (0, 24), (0, 100), (100, 200), (0, 256))
REPS = 20


def linearization(fowt, pose, pre, Xi, form):
    """The drag linearization in one of the forms (module doc)."""
    from raft_tpu_torch.models import fowt as F

    if form == "elementwise":
        return F.fowt_hydro_linearization_pre(fowt, pose, pre, Xi)
    r = pose["r"]
    w = F.as_real(fowt.w, r.device)
    offsets = r - pose["r6"][..., None, :3]
    submerged = r[..., 2] < 0.0
    iwXi = (1j * w) * Xi
    re, im = iwXi.real, iwXi.imag
    if form == "einsum":
        M_re = torch.real(torch.einsum("...jw,...kw->...jk", iwXi,
                                       torch.conj(iwXi)))
    else:
        M_re = torch.sum(re[..., :, None, :] * re[..., None, :, :]
                         + im[..., :, None, :] * im[..., None, :, :], dim=-1)

    def quad_form(v, extra):
        if form == "einsum":
            sub = "nc"[:extra]
            return torch.einsum(f"...{sub}j,...jk,...{sub}k->...n", v, M_re, v)
        Mb = M_re[(...,) + (None,) * extra + (slice(None), slice(None))]
        return torch.sum(v[..., :, None] * Mb * v[..., None, :],
                         dim=tuple(range(-extra - 1, 0)))

    def re_dot(a, extra):
        if form != "loop":
            sub = "nc"[:extra]
            return torch.real(torch.einsum(f"...jw,...{sub}w->...{sub}j",
                                           iwXi, torch.conj(a)))
        pick = (None,) * extra + (slice(None),)
        return torch.stack([torch.sum(re[(..., j) + pick] * a.real
                                      + im[(..., j) + pick] * a.imag,
                                      dim=-1) for j in range(6)], dim=-1)

    def rms_scalar(s, g, A):
        b = re_dot(s, 1)
        cross = torch.sum(g * b, dim=-1)
        return torch.sqrt(torch.clamp(0.5 * (A - 2.0 * cross
                                             + quad_form(g, 1)), min=0.0))

    vRMS_q = rms_scalar(pre["s_q"], pre["g_q"], pre["A_q"])
    vRMS_p1c = rms_scalar(pre["s_p1"], pre["g_p1"], pre["A_p1"])
    vRMS_p2c = rms_scalar(pre["s_p2"], pre["g_p2"], pre["A_p2"])
    K = pre["K"]
    D = re_dot(pre["u_P"], 2)
    cross_P = torch.sum(K * D, dim=(-2, -1))
    vRMS_p = torch.sqrt(torch.clamp(
        0.5 * (pre["A_P"] - 2.0 * cross_P + quad_form(K, 2)), min=0.0))
    circ = pre["circ"]
    vRMS_p1 = torch.where(circ, vRMS_p, vRMS_p1c)
    vRMS_p2 = torch.where(circ, vRMS_p, vRMS_p2c)
    c = math.sqrt(8.0 / math.pi) * 0.5 * fowt.rho_water
    Bmat = (c * vRMS_q * pre["a_q_eff"])[..., None, None] * pose["qMat"] \
        + (c * vRMS_p1 * pre["a_p1_eff"])[..., None, None] * pose["p1Mat"] \
        + (c * vRMS_p2 * pre["a_p2_eff"])[..., None, None] * pose["p2Mat"]
    Bmat = Bmat * submerged[..., None, None].to(F.REAL)
    return torch.sum(F.translate_matrix_3to6(Bmat, offsets), dim=-3), Bmat


FORMS = ("einsum", "partial", "loop", "elementwise")


def _dev(a, b) -> float:
    """Largest absolute difference of two tensors or dicts of tensors."""
    if isinstance(a, dict):
        return max((_dev(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (tuple, list)):
        return max(_dev(x, y) for x, y in zip(a, b))
    if not isinstance(a, torch.Tensor) or a.dtype == torch.bool:
        return 0.0
    return float(torch.max(torch.abs(a - b))) if a.numel() else 0.0


def _lanes(st, a, b, nc):
    """The lanes a:b of a case state whose lane-bearing tensors lead with
    the case axis (the pose and the node constants carry none)."""
    from raft_tpu_torch.parallel.sweep import _NODE_CONSTANTS

    out = {}
    for k, v in st.items():
        if isinstance(v, dict):
            out[k] = {kk: (vv[a:b] if kk not in _NODE_CONSTANTS
                           and k == "drag_pre" and vv.shape[:1] == (nc,)
                           else vv) for kk, vv in v.items()}
        elif k in ("F_lin", "u0"):
            out[k] = v[a:b]
        else:
            out[k] = v
    return out


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(REPS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def probe(label, fowt, Hs, Tp, beta, dev):
    from raft_tpu_torch._config import as_real
    from raft_tpu_torch.models.fowt import fowt_drag_excitation
    from raft_tpu_torch.ops.linalg import impedance_solve
    from raft_tpu_torch.parallel.sweep import make_case_solver, sweep_cases

    nc = len(Hs)
    kw = dict(nIter=10, tol=0.01)
    t0 = time.perf_counter()
    full = sweep_cases(fowt, Hs, Tp, beta, device=dev, **kw)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    solver = make_case_solver(fowt, **kw)
    st = solver.setup(Hs, Tp, beta)
    Xi = full["Xi"]
    w = as_real(fowt.w, dev)
    res = {"shape": label, "cases": nc, "nw": fowt.nw,
           "nodes": int(st["drag_pre"]["u_P"].shape[-3]),
           "sweep_s": sweep_s, "ms": {}, "dev_from_einsum": {}, "slices": {}}
    outs = {}
    for form in FORMS:
        outs[form] = linearization(fowt, st["pose"], st["drag_pre"], Xi, form)
        res["ms"][form] = time_ms(lambda: linearization(
            fowt, st["pose"], st["drag_pre"], Xi, form))
        res["dev_from_einsum"][form] = _dev(outs[form], outs["einsum"])
    B6, Bmat = outs["elementwise"]
    F_drag = fowt_drag_excitation(fowt, st["pose"], Bmat, st["u0"])
    Z = impedance_solve(w, st["M_lin"], B6[..., None] + st["B_BEM"],
                        st["C_lin"], st["F_lin"] + F_drag)
    for a, b in SLICES:
        if b > nc:
            continue
        stL = solver.setup(Hs[a:b], Tp[a:b], beta[a:b])
        row = {"setup": _dev(stL, _lanes(st, a, b, nc))}
        for form in FORMS:
            row[form] = _dev(linearization(fowt, stL["pose"],
                                           stL["drag_pre"], Xi[a:b], form),
                             tuple(x[a:b] for x in outs[form]))
        B6L, BmatL = linearization(fowt, stL["pose"], stL["drag_pre"],
                                   Xi[a:b], "elementwise")
        FdL = fowt_drag_excitation(fowt, stL["pose"], Bmat[a:b],
                                   stL["u0"])
        row["drag_excitation"] = _dev(FdL, F_drag[a:b])
        row["impedance_solve"] = _dev(
            impedance_solve(w, st["M_lin"], B6[a:b, ..., None] + st["B_BEM"],
                            st["C_lin"], (st["F_lin"] + F_drag)[a:b]),
            Z[a:b])
        sub = sweep_cases(fowt, Hs[a:b], Tp[a:b], beta[a:b], device=dev,
                          **kw)
        row["sweep_Xi_std"] = max(_dev(sub["Xi"], full["Xi"][a:b]),
                                  _dev(sub["std"], full["std"][a:b]))
        res["slices"][f"{a}:{b}"] = row
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_drag_forms: no CUDA card", file=sys.stderr)
        return 1
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import mcf_cases, mhk_cases, recovery_cases
    from raft_tpu_torch.ops.kernels import _build
    from raft_tpu_torch.parallel.sweep import design_fowt

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _build.load()

    rng = np.random.default_rng(2026)        # chip_smoke.sweep_inputs
    oc3 = (1.0 + 11.0 * rng.random(1024), 4.0 + 14.0 * rng.random(1024),
           np.deg2rad(360.0 * rng.random(1024)))
    rng = np.random.default_rng(2027)        # chip_smoke's m1 sweep
    rm1 = (0.5 + 3.5 * rng.random(256), 4.0 + 10.0 * rng.random(256),
           np.deg2rad(360.0 * rng.random(256)))
    shapes = (
        ("oc3spar_1024x80", lambda: design_fowt(
            recovery_cases.oc3spar_design(), dev), oc3),
        ("rm1_256x400", lambda: Model(mhk_cases.rm1_design(),
                                      device=dev).fowtList[0], rm1),
        ("oc4semi_mcf_1024x80", lambda: design_fowt(
            mcf_cases.mcf_design(), dev), mcf_cases.sweep_inputs()),
    )
    for label, build, (Hs, Tp, beta) in shapes:
        res = probe(label, build(), np.asarray(Hs), np.asarray(Tp),
                    np.asarray(beta), dev)
        res["card"] = card
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
