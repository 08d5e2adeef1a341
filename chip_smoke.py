#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repo root:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is turned into a
0 exit):
 1. device  — requires CUDA; prints the card's name and power limit;
 2. build   — compiles the hand-written kernels (nvcc, sm_90a) from the
              sources in raft_tpu_torch/csrc and prints the build time and
              the -Xptxas -v register/spill lines;
 3. kernels — holds each kernel against its plain PyTorch version on the
              card (random well-conditioned systems, systems that need
              pivoting, the mixed row-scale stressor) at the main path's
              shapes and at the 5120-lane batched-sweep shape, and times
              kernel, plain version and the torch.linalg.solve yardstick;
 4. main    — run_raft on OC3spar (its own 80-bin grid, 3 cases) and
              VolturnUS-S (80 bins, 1 case) with the launch counters set to
              0 just before and read just after; both kernels must launch;
 5. golden  — reruns both designs on the golden grid (0.02-0.2 Hz, first
              case) and diffs the ledgers against tests/golden at 1e-6
              (solver residuals at 0.5; a residual below the golden one at
              the machine floor is an improvement, see
              ledger.blocking_regressions), no added or removed metrics;
 6. prints the kernels JSON line, the card line, and the final JSON line.

Options: --only-kernels stops after phase 3; --out DIR sets where the full
record (ptxas.log, chip_smoke.json) is written (default build/chip_smoke).

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 at
#: 3.35 TB/s; FP64 on the tensor cores at 67 TFLOP/s, the highest FP64
#: rate the card has (the least time the work could take)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 67e12

X_TOL = 1e-10         # kernel vs plain version, max-abs relative
RESID_TOL = 1e-13     # normwise relative residual of the kernel's answer
GOLDEN_TOL = 1e-6
GOLDEN_RESID_TOL = 0.5

ROOT = os.path.dirname(os.path.abspath(__file__))
#: where the full record (ptxas report, per-shape kernel rows, main-path
#: and golden facts) is written: ``--out DIR``, default build/chip_smoke
OUT = os.path.join(ROOT, "build", "chip_smoke")
FAILURES: list[str] = []


def log(*a):
    print(*a, flush=True)


def fail(msg):
    FAILURES.append(msg)
    log(f"FAIL: {msg}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps=30, warmup=3) -> float:
    """Mean device time of ``fn`` per call, by CUDA events over ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel_substr, reps=20):
    """Device time per launch of the CUDA kernel whose name contains
    ``kernel_substr``, from torch.profiler's CUDA activity (None when the
    profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except (RuntimeError, AttributeError):
        return None
    tot, n = 0.0, 0
    for ev in prof.key_averages():
        if kernel_substr in ev.key:
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            tot += t
            n += ev.count
    return tot / n / 1e3 if n and tot > 0 else None


def launch_floor_ms() -> float:
    """Time of one trivial CUDA launch from PyTorch (a 1-element add),
    back to back: the floor under any single-kernel call on this card."""
    x = torch.zeros(1, dtype=torch.float64, device="cuda")
    return time_ms(lambda: x.add_(1.0), reps=200)


def gj_flops(S, K, refine=1):
    """FP64 operations of equilibrated Gauss-Jordan with ``refine``
    residual re-solves on one S x S system with K right-hand sides."""
    W = S + K
    scale = S * W + S
    elim = sum((W - kk - 1) * (1 + 2 * (S - 1)) for kk in range(S))
    resid = 2 * S * S * K + 2 * S * K
    return scale + elim * (1 + refine) + refine * resid


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_, flops):
    tb = bytes_ / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FP64_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernel parity and times
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _normwise_residual(A, x, b) -> float:
    """max over systems of |b - A x|_inf / (|A|_inf |x|_inf + |b|_inf)."""
    r = b - A @ x
    inf = lambda t: torch.amax(torch.abs(t), dim=(-2, -1))  # noqa: E731
    nA = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    return float(torch.max(inf(r) / (nA * inf(x) + inf(b))))


def _pivot_stack(g, lanes, n, dev):
    """Systems with a permutation-pattern dominant part (zero leading
    entries), so every lane needs row exchanges."""
    perms = torch.stack([torch.randperm(n, generator=g) for _ in range(lanes)])
    P = torch.nn.functional.one_hot(perms, n).to(torch.float64)
    scale = 1.0 + 2.0 * torch.rand((lanes, n, 1), generator=g,
                                   dtype=torch.float64)
    noise = 0.05 * torch.randn((lanes, n, n), generator=g,
                               dtype=torch.float64) * (P == 0)
    return (P * scale + noise).to(dev)


def impedance_inputs(g, nb, nw, n, kind, dev):
    f64 = dict(dtype=torch.float64, generator=g)
    w = torch.linspace(0.005, 0.4, nw, dtype=torch.float64) * 2 * math.pi
    shape_b = (nb,) if nb > 1 else ()
    M = torch.randn(shape_b + (n, n, nw), **f64) \
        + 5.0 * torch.eye(n, dtype=torch.float64)[:, :, None]
    B = 0.1 * torch.randn(shape_b + (n, n, nw), **f64)
    C = torch.randn(shape_b + (n, n), **f64) + 10.0 * torch.eye(n, dtype=torch.float64)
    F = torch.complex(torch.randn(shape_b + (n, nw), **f64),
                      torch.randn(shape_b + (n, nw), **f64))
    if kind == "pivoting":
        P = _pivot_stack(g, max(nb, 1), n, "cpu").reshape(shape_b + (n, n))
        C = 10.0 * P
        M = 0.01 * M
        B = 0.01 * B
    elif kind == "row_scales":
        s = 10.0 ** (3.0 + 7.0 * torch.rand(shape_b + (n, 1), **f64))
        M = M * s[..., None]
        B = B * s[..., None]
        C = C * s
        F = F * 1e6
    return [t.to(dev) for t in (w, M, B, C, F)]


def gj_inputs(g, lanes, n, k, kind, dev):
    f64 = dict(dtype=torch.float64, generator=g)
    if kind == "inv_complex":
        # the main path's use: the real embedding of inv(Z), Z (lanes,6,6)
        m = n // 2
        Z = torch.complex(torch.randn((lanes, m, m), **f64),
                          torch.randn((lanes, m, m), **f64)) \
            + 8.0 * torch.eye(m, dtype=torch.complex128)
        A = torch.cat([torch.cat([Z.real, -Z.imag], -1),
                       torch.cat([Z.imag, Z.real], -1)], -2)
        b = torch.cat([torch.eye(m, dtype=torch.float64).expand(lanes, m, m),
                       torch.zeros((lanes, m, m), dtype=torch.float64)], -2)
        return A.to(dev), b.contiguous().to(dev), Z.to(dev)
    if kind == "pivoting":
        A = _pivot_stack(g, lanes, n, "cpu")
    elif kind == "row_scales":
        A = (0.1 * torch.randn((lanes, n, n), **f64) + torch.eye(n, dtype=torch.float64)) \
            * 10.0 ** (3.0 + 7.0 * torch.rand((lanes, n, 1), **f64))
    else:
        A = torch.randn((lanes, n, n), **f64) + 5.0 * torch.eye(n, dtype=torch.float64)
    b = torch.randn((lanes, n, k), **f64) * 1e3
    return A.to(dev), b.to(dev), None


def check_kernels(dev):
    from raft_tpu_torch.ops.kernels import gj_solve as G

    g = torch.Generator().manual_seed(1234)
    rows = {"impedance_gj": [], "gj_solve": []}
    n = 6
    for nb, nw in ((1, 80), (3, 80), (64, 80)):
        lanes = nb * nw
        for kind in ("random", "pivoting", "row_scales"):
            w, M, B, C, F = impedance_inputs(g, nb, nw, n, kind, dev)
            X = G.impedance_gj_solve(w, M, B, C, F)
            Xp = G.impedance_gj_solve_plain(w, M, B, C, F)
            torch.cuda.synchronize()
            Z = (-(w ** 2) * M + 1j * w * B + C[..., None]).movedim(-1, -3)
            Fz = F.movedim(-1, -2)[..., None]
            rel = _rel(X, Xp)
            res = _normwise_residual(Z, X.movedim(-1, -2)[..., None], Fz)
            err = float(torch.max(torch.abs(X - Xp)))
            ok = rel <= X_TOL and res <= RESID_TOL and bool(torch.all(torch.isfinite(X)))
            if not ok:
                fail(f"impedance_gj {kind} lanes={lanes}: rel={rel:.3e} "
                     f"resid={res:.3e}")
            row = dict(lanes=lanes, case=kind, rel_vs_plain=rel,
                       normwise_residual=res, max_abs_err=err)
            if kind == "random":
                row["ms"] = time_ms(lambda: G.impedance_gj_solve(w, M, B, C, F))
                row["device_ms"] = device_ms(
                    lambda: G.impedance_gj_solve(w, M, B, C, F),
                    "impedance_gj_kernel")
                row["plain_ms"] = time_ms(
                    lambda: G.impedance_gj_solve_plain(w, M, B, C, F), reps=5)
                row["library_ms"] = time_ms(lambda: torch.linalg.solve(Z, Fz))
                flops = lanes * (gj_flops(2 * n, 1) + 2 * 4 * n * n)
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes(w, M, B, C, F, X), flops)
            rows["impedance_gj"].append(row)
            log(f"  impedance_gj {kind:10s} lanes={lanes:5d} rel={rel:.2e} "
                f"resid={res:.2e}"
                + (f" kernel {row['ms']:.4f} ms (device {row['device_ms']})"
                   f"  plain {row['plain_ms']:.3f} ms"
                   f"  torch.linalg.solve {row['library_ms']:.4f} ms"
                   f"  bound {row['bound_ms']:.2e} ms ({row['bound_by']})"
                   if "ms" in row else ""))

    for lanes in (80, 5120):
        for kind in ("inv_complex", "random", "pivoting", "row_scales"):
            A, b, Z = gj_inputs(g, lanes, 12, 6, kind, dev)
            x = G.gj_solve(A, b)
            xp = G.gj_solve_plain(A, b)
            torch.cuda.synchronize()
            rel = _rel(x, xp)
            res = _normwise_residual(A, x, b)
            err = float(torch.max(torch.abs(x - xp)))
            ok = rel <= X_TOL and res <= RESID_TOL and bool(torch.all(torch.isfinite(x)))
            if not ok:
                fail(f"gj_solve {kind} lanes={lanes}: rel={rel:.3e} resid={res:.3e}")
            row = dict(lanes=lanes, case=kind, rel_vs_plain=rel,
                       normwise_residual=res, max_abs_err=err)
            if kind == "inv_complex":
                eye = torch.eye(6, dtype=torch.complex128, device=dev).expand(lanes, 6, 6)
                row["ms"] = time_ms(lambda: G.gj_solve(A, b))
                row["device_ms"] = device_ms(lambda: G.gj_solve(A, b),
                                             "gj_kernel")
                row["plain_ms"] = time_ms(lambda: G.gj_solve_plain(A, b), reps=5)
                row["library_ms"] = time_ms(lambda: torch.linalg.solve(Z, eye))
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes(A, b, x), lanes * gj_flops(12, 6))
            rows["gj_solve"].append(row)
            log(f"  gj_solve     {kind:11s} lanes={lanes:5d} rel={rel:.2e} "
                f"resid={res:.2e}"
                + (f" kernel {row['ms']:.4f} ms (device {row['device_ms']})"
                   f"  plain {row['plain_ms']:.3f} ms"
                   f"  torch.linalg.solve {row['library_ms']:.4f} ms"
                   f"  bound {row['bound_ms']:.2e} ms ({row['bound_by']})"
                   if "ms" in row else ""))
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the main path and the goldens
# ---------------------------------------------------------------------------

def run_main(dev):
    from raft_tpu_torch import run_raft
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.ops import linalg
    from raft_tpu_torch.ops.kernels import gj_solve as G

    per_design = {}
    G.reset_launches()
    for name in ("OC3spar", "VolturnUS-S"):
        before = dict(G.LAUNCHES)
        t0 = time.perf_counter()
        model = run_raft(load_design(name), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: G.LAUNCHES[k] - before[k] for k in G.LAUNCHES}
        disp = linalg.last_dispatch()
        cm = model.results["case_metrics"]
        finite = bool(np.all(np.isfinite(model.Xi))) and all(
            np.isfinite(c[0][f"{ch}_std"]) for c in cm.values()
            for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"))
        log(f"  {name}: {len(cm)} case(s) x {model.nw} bins in {wall:.2f} s "
            f"(statics {model.timings['statics']:.2f} s, dynamics "
            f"{model.timings['dynamics']:.2f} s, outputs "
            f"{model.timings['outputs']:.2f} s); launches {launches}; "
            f"last dispatch {disp}")
        log(f"    surge std per case: "
            f"{[round(float(c[0]['surge_std']), 6) for c in cm.values()]}, "
            f"statics iters {[model._case_records[str(i)]['statics_iters'] for i in cm]}, "
            f"drag iters {[model._case_records[str(i)]['fowt0']['drag_iters'] for i in cm]}")
        if not finite:
            fail(f"{name}: non-finite outputs")
        if disp.get("backend") != "cuda_gj" or disp.get("kernel") != "gj_solve":
            fail(f"{name}: last dispatch {disp} does not name the CUDA kernel")
        per_design[name] = dict(wall_s=wall, timings=dict(model.timings),
                                launches=launches, ncases=len(cm), nw=model.nw)
    total = dict(G.LAUNCHES)
    for k, v in total.items():
        if v <= 0:
            fail(f"kernel {k} was never launched on the main path")
    return per_design, total


def run_goldens(dev):
    from raft_tpu_torch import Model, ledger
    from raft_tpu_torch.io.designs import load_design

    out = {}
    for name, fname in (("OC3spar", "oc3spar_coarse.ledger.json"),
                        ("VolturnUS-S", "volturnus_coarse.ledger.json")):
        d = load_design(name)
        d["settings"].update(min_freq=0.02, max_freq=0.2)
        d["cases"]["data"] = d["cases"]["data"][:1]
        m = Model(d, device=dev)
        m.analyzeCases()
        gold = ledger.load_ledger(os.path.join(ROOT, "tests", "golden", fname))
        rep = ledger.diff(gold, m.last_ledger, tol_rel=GOLDEN_TOL,
                          per_metric={"*_residual*": GOLDEN_RESID_TOL})
        worst = max((r["rel"] for r in rep["regressions"]), default=0.0)
        log(ledger.format_diff(rep))
        blocking = ledger.blocking_regressions(rep)
        if blocking or rep["added"] or rep["removed"]:
            fail(f"golden {name} regressed: {blocking}")
        out[name] = dict(ok=not blocking, n_compared=rep["n_compared"],
                         worst_rel=worst)
    return out


def main() -> int:
    global OUT
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if "--out" in sys.argv[1:]:
        OUT = os.path.abspath(sys.argv[sys.argv.index("--out") + 1])
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    from raft_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {_build.BUILD_INFO})")
    for sym, lines in _build.ptxas_report().items():
        if "impedance_gj_kernelILi6E" in sym or "gj_kernelILi12ELi6E" in sym:
            log(f"  ptxas {sym}: {' | '.join(lines)}")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ptxas.log"), "w") as f:
        f.write(_build.ptxas_log())

    floor = launch_floor_ms()
    log(f"launch floor: {floor:.4f} ms per trivial PyTorch CUDA launch")
    log("kernels: parity against the plain versions and times")
    rows = check_kernels(dev)
    if "--only-kernels" in sys.argv[1:]:
        log(f"chip_smoke: kernels only, {len(FAILURES)} failure(s)")
        return 1 if FAILURES else 0

    log("main path: run_raft on the card")
    t0 = time.perf_counter()
    per_design, launches = run_main(dev)
    log(f"main path: {time.perf_counter() - t0:.1f} s, launches {launches}")

    log("golden ledgers on the card")
    goldens = run_goldens(dev)

    def summary(name, replaces):
        # ms is the wall time of one wrapper call on the stream (CUDA
        # events around back-to-back calls, host launch cost included);
        # device_ms is the kernel alone, from the profiler
        main = next(r for r in rows[name] if "ms" in r)
        return {"name": name, "route": "cuda",
                "source": "raft_tpu_torch/csrc/gj_solve.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                                   if r["lanes"] == main["lanes"]),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "lanes": main["lanes"],
                "device_ms": main["device_ms"], "launch_floor_ms": floor,
                "parity": rows[name]}

    kernels = [summary("impedance_gj", "raft_tpu/ops/pallas/gj_solve.py:402"),
               summary("gj_solve", "raft_tpu/ops/pallas/gj_solve.py:216")]
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "main": per_design,
                   "goldens": goldens}, f, indent=1)
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} failure(s)")
        for m in FAILURES:
            log(f"  - {m}")
        return 1
    print(json.dumps({"kernels": [{k: v for k, v in kr.items()
                                   if k != "parity"} for kr in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
