#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

Run from the repo root:  python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is turned into a
0 exit):
 1. device  — requires CUDA; prints the card's name and power limit;
 2. build   — compiles the hand-written kernels (nvcc, sm_90a; one nvcc
              per translation unit, all started together) from the sources
              in raft_tpu_torch/csrc and prints the build time, the
              -Xptxas -v register/spill lines (every K1-K4 instantiation
              and the three K5 kernels: a stack frame or spill fails the
              run, and so do more than 128 registers in a K5 kernel) and
              the static SASS counts of the main paths' K1/K3 (n = 6) and
              K2 f64 / K4 f32 (n = 12, k = 6) kernels (cuobjdump);
 3. kernels — holds each kernel against its plain PyTorch version on the
              card: K1/K2 at float64 and float32, K3/K4 (the mixed ladder)
              at the f32 and bf16 elimination widths with promoted counts
              compared; random systems, systems that need pivoting, the
              mixed row-scale stressor and SVD-conditioned (cond 1e9)
              lanes mixed into well-conditioned ones; at 80, 5120 and
              81,920 lanes (K2/K4: 80 and 5120, n = 12, k in {1, 6}), and
              K1 at the f64 sweep's own operand shapes (M and C shared by
              1024 cases); times kernel, plain version and the
              torch.linalg.solve yardstick at the main paths' shapes;
              gj_solve at the shapes the K2/K4 kernels do not instantiate
              (odd n = 1..15 in f64, f32 and mixed f32; the ladder with
              k > n/2), x and promoted counts against the plain version;
              K5 (the QTF pair grid: a record pass, a tiled pair pass, a
              finishing pass) on the spar of tests/test_qtf_kernel.py at
              nw2 = 5 (one and no waterline member, with and without
              motion, heading 0.35) and on the OC4semi example's fields
              at nw2 = 30 and 80 (N = 177, nm = 7), relative error <=
              1e-12 of max|Q| and a second call bitwise equal, timed at
              each (device time: the three kernels summed per call);
              K1 with its operands on cuda:0 inside and outside a
              torch.cuda.device(0) guard, bitwise equal (the wrappers
              make the operands' device current for each launch), and
              with two cards K1 on cuda:1 with cuda:0 current against
              its plain version;
 4. main    — run_raft on OC3spar (its own 80-bin grid, 3 cases) and
              VolturnUS-S (80 bins, 1 case);
 5. sweep   — sweep_cases on OC3spar at its 80-bin grid, 1024 seeded cases
              (Hs 1-12 m, Tp 4-18 s, heading 0-360 deg), nIter 10, tol 0.01,
              in f64 and under RAFT_TPU_PRECISION=mixed; 8 lanes against
              the serial solve (rtol 1e-9), mixed against f64 (std 1e-6,
              iters and converged equal);
 6. variants — sweep_variants on VolturnUS-S over volturn_grid's 243
              variants with the ballast trim (Hs 6, Tp 12, nIter 10,
              newton_iters 20); 2 variants (the first and the last)
              against the serial solve (rtol
              1e-9), all finite, |heave of Xeq| < 0.05;
 7. golden  — reruns both designs on the golden grid (0.02-0.2 Hz, first
              case) and diffs the ledgers against tests/golden at 1e-6
              (solver residuals at 0.5; a residual below the golden one at
              the machine floor is an improvement, see
              ledger.blocking_regressions), no added or removed metrics,
              iteration counts exact; then again under mixed;
 8. qtf     — run_raft on the examples/example_qtf.py configuration
              (OC4semi, potSecOrder 1, 80 first-order and 30 second-order
              bins) diffed against tests/golden/oc4semi_qtf.ledger.json as
              in phase 7, with exactly 1 K5 launch; then Vertical_cylinder
              with two JONSWAP headings (0 and 30 deg) on the coarse grid,
              exactly 2 K5 launches; K1 and K2 launch in both;
 9. potflow — first-order potential flow on OC4semi at full width (the
              YAML's dz_BEM 3.0, da_BEM 2.0, min_freq_BEM 0.03 Hz, 80 bins,
              its first case), its coefficients from the committed WAMIT
              cache of the JAX package's native-BEM solve
              (tests/golden/oc4semi_bem/, read from a copy; a cache miss
              fails instead of solving): (e) Model.preprocess_BEM on the
              spar of tests/test_bem_native.py at that file's custom grid,
              solved on the host through the port's own BEM build, its
              files against the JAX package's (1e-9, equal cache key);
              (a) potModMaster 2 against tests/golden/
              oc4semi_bem.ledger.json as in phase 7; (b) potModMaster 3
              from the cache's files, equal to (a) at 1e-12; (c) (a) plus
              potSecOrder 1 on examples/example_qtf.py's second-order
              grid against tests/golden/oc4semi_bem_qtf.metrics.json
              (1e-6, iteration counts exact; its statics_residual, at the
              rounding floor, printed beside the JAX package's two), with
              exactly 1 K5 launch; (d) sweep_cases on (a)'s FOWT, 1024
              seeded cases in f64 and mixed, 4 lanes against the serial
              solve, mixed against f64 as in phase 5; then K1 against its
              plain version at the BEM sweep's operands (M(w) and B(w)
              shared by the cases, the variation in w asserted), timed
              like the phase 3 rows;
10. mhk    — submerged rotors and the general single-body mooring
              (models/mhk_cases.py, goldens of tests/golden/mhk_golden.py):
              run_raft on RM1_Floating at its own 400 bins (its shipped
              still-water case and a JONSWAP case) and on FOCTT_example's
              converging case (m2b), each against its full-width physics
              record (every case's metrics at 1e-6, iteration counts
              exact; the statics residual, at the rounding floor, at most
              4x the larger JAX backend's, its 0.5 band printed) and RM1
              against its ledger golden (every other metric at the golden
              bars), the per-case cavitation arrays at 1e-9; FOCTT's
              build and shipped-case constants on the card against
              foctt_build.json at 1e-9 (m2a); FOCTT's shipped case (Model ->
              analyzeCases: its unloaded statics are m2b's) run to
              its end (statics at the iteration cap, ROADMAP C8: printed,
              compared with nothing); OC3spar with a clump weight on each
              line (m3, free points) against its record and its ledger
              golden, as RM1; K1 exactly once
              per drag pass and K2 once per case on every path; then
              sweep_cases on RM1's FOWT, 256 seeded cases x 400 bins
              (102,400 lanes per K1 launch), 4 lanes against the serial
              solve (rtol 1e-9);
11. farm    — arrays and farms (models/farm_cases.py, goldens of
              tests/golden/farm_golden.py in tests/golden/farm/):
              run_raft on VolturnUS-S_farm's four-turbine layout with
              individual moorings (f1, 24 DOFs, its own 100 bins) against
              its physics record and ledger golden (as phase 10), again
              under RAFT_TPU_PRECISION=mixed (against the goldens and
              f64 at 1e-6; the ladder around LU's promoted count equal to
              the JAX ladder's); the shipped two-turbine rows on the
              stand-in shared mooring (f2) against its record, its free
              points and _K_array at 1e-9, and its Model.sweep_farm;
              K1 (K3) exactly once per drag pass of each FOWT and no K2;
              then sweep_farm of f1's first FOWT on four turbines in a
              row x 256 seeded cases (102,400 lanes per K1 launch, at
              most nIter launches), 4 lanes against single-lane solves
              (rtol 1e-9), the wake outputs against the host fixed point
              and against the JAX package's wake_equilibria_jnp (1e-12,
              iterations exact); K1 at the farm sweep's operands, timed
              like the phase 3 rows;
12. mcf     — MacCamy-Fuchs members (models/mcf_cases.py, goldens of
              tests/golden/mcf_golden.py): OC4semi with MCF on its
              circular columns, at its own 80 bins: (c1) run_raft, its one
              case, against its physics record (1e-6, iteration counts
              exact, the statics residual at most 4x the larger JAX
              backend's) and no ledger golden (its dyn_solve_residual at
              the machine floor, ROADMAP C3: printed beside the JAX
              package's two); the inertia coefficient (N, 3, 3, nw)
              complex; (c2) (c1) under potSecOrder 1 on
              examples/example_qtf.py's second-order grid (30 x 30 pairs,
              the Kim & Yue correction of the four columns) against its
              record and its ledger golden, as phase 10; K1 exactly once
              per drag pass (every impedance_solve call of the Model,
              counted), K2 once per case, K5 exactly once in (c2); (c3)
              sweep_cases on (c1)'s FOWT, 1024 seeded cases x 80 bins
              (81,920 lanes per K1 launch, at most nIter launches) in f64
              and under RAFT_TPU_PRECISION=mixed, 4 lanes against the
              serial solve (rtol 1e-9), mixed against f64 as in phase 5;
              (c4) five diameter variants of (c1) at 10 bins through
              sweep_variants, on one device and on phase 18's mesh of
              two shards, against the JAX package's sweep_variants
              (tests/golden/variants/oc4semi_mcf_coarse.json) at 1e-9;
13. ballast  — the ballast trim (models/ballast_cases.py, goldens of
              tests/golden/ballast_golden.py in tests/golden/ballast/), at
              each design's own grid: (b1) VolturnUS-S, OC3spar and OC4semi
              through Model.analyzeUnloaded(ballast=1) at heave_tol 1.0 and
              analyzeUnloaded(ballast=2), (b2) the walk at heave_tol 1e-5 on
              OC4semi and VolturnUS-S: every fill level equal to the JAX
              package's, the unrounded fill levels at 1e-9 (each margin to
              its rounding boundary printed), the density shift and the
              densities at 1e-12, the unloaded offset at 1e-6, the outputs
              the density shift drives to zero by their floor bar
              (ballast_cases.floor_bar, printed), the trim's counted pulls
              pinned (ballast_cases.trim_pulls) and no kernel launched;
              (b3) run_raft(ballast=True) on VolturnUS-S (80 bins, its one
              case) and OC3spar (80 bins, its first case, as Model ->
              analyzeUnloaded(ballast=1) -> analyzeCases -> calcOutputs
              inside obs.transfers.guard("disallow")) against their
              physics records and ledger goldens (as phase 10), the trim
              and calcOutputs' ballast densities and masses; K1 exactly
              once per drag pass and K2 once per case; the (b1) walks of
              these two designs are the ones inside their (b3) runs,
              held against the (b1) goldens too;
14. recovery — fault tolerance (raft_tpu_torch/recovery.py), every launch
              of every kernel counted and printed against its expected
              value: (r1) OC3spar's three shipped cases at its 80 bins,
              clean, then under nan@dynamics:case=1 (case 1 walks
              configured -> re_solve -> damped_restart and is quarantined,
              its sequence and failure record those of the JAX package on
              tests/golden/recovery/oc3spar.json mapped through
              recovery.JAX_STEP; cases 0 and 2 at 1e-12 of the clean run),
              then analyzeCases(resume=True) (cases 0 and 2 restored, one
              statics and one dynamics solve, the ledger at 1e-12 of the
              clean one); (r2) case 0 alone under raise@kernel:case=0:once
              (one attempt, recovered at 1e-12, K1 launches equal to a
              clean run's); (r3) case 0 under nan@dynamics:case=0:times=2
              under RAFT_TPU_PRECISION=mixed (K3 on every rung, no K1) and
              in f64, mixed against f64 as in phase 5; (r4) phase 5's 1024
              cases with lanes 0, 512 and 1023 poisoned by the sweep seam:
              re-solved on K1 at 3 x 80 lanes and spliced back at 1e-12,
              the other lanes bitwise equal, NaN with quarantine="off";
              (r5) sweep_cases_chunked on the same table in 4 chunks of
              256 with a CheckpointStore under --out: bitwise equal to one
              sweep, a pure read, a deleted tail, an edited row and a
              corrupt chunk each re-solving only what they must;
15. obs     — observability (raft_tpu_torch/obs): (o1) OC3spar's case 0 at
              its 80 bins with observability off (no directory, probes
              off) and on (a directory under --out, probes sampled,
              inside obs.transfers.guard("disallow"): any unsanctioned
              synchronizing call raises): ledgers bitwise equal, K1/K2
              launches equal, the span tree models/obs_cases.SPAN_TREE
              (the JAX package's), manifest, trace, ledger and events
              valid, the events replaying the trace, the host pulls per
              phase models/obs_cases.pulls_per_case (the same with probes
              off), both walls printed; (o2) phase 5's table with
              health=True in f64 and mixed: Xi / std / iters / converged
              bitwise phase 5's, one more K1 (K3) launch of 81,920 lanes
              (11 against 10), health_residual at most 1e-12 (f64) /
              1e-9 (mixed), the torch.linalg.cond time, _health_summary
              in each sweep's manifest;
16. codesign — co-design gradients (parallel/optimize.py,
              models/codesign_cases.py, goldens of
              tests/golden/codesign_golden.py): make_design_objective on
              VolturnUS-S at its 80 bins over {d_scale, moor_L, moor_EA,
              moor_anchor}, the golden's 4 lanes, metric std, in f64:
              obj.batched, then the backward inside
              obs.transfers.guard("disallow"); values and gradients
              against codesign/volturn80.json at 1e-6, K1 launches of the
              forward (its fixed-point passes) and the backward (one
              re-linearization, the adjoint passes, one pullback) pinned;
              the gradients in the fixed point's state leaves (M_lin,
              C_lin, F_lin) from one setup in f64 and under
              RAFT_TPU_PRECISION=mixed (K3 in the backward), mixed
              against f64 at 1e-6; K1 at the adjoint solve's operands
              (M^T, -B^T, C^T per lane, 4 x 80 lanes), timed like the
              phase 3 rows; walls and peak memory printed;
17. descent — the batched design descent (parallel/optimize.py
              optimize_designs -> make_descent, parallel/optimizers.py,
              models/descent_cases.py, goldens of
              tests/golden/descent_golden.py) on VolturnUS-S over
              {d_scale, moor_L, moor_EA, moor_anchor}, std, newton_iters
              20: (d1) Adam at its 80 bins over the codesign lanes and a
              NaN lane, 2 steps; (d2) L-BFGS with the zoom linesearch at
              10 bins (0.02-0.2 Hz) over 2 of those lanes, 1 step; each
              optimize_designs call whole inside
              obs.transfers.guard("disallow"): x, objective and its
              trace at 1e-8 relative, the gradient norm at 1e-6, steps
              counted, masks and the best lane exactly against
              descent/volturn80.json and volturn10.json; K1 launches
              pinned per gradient (its forward passes, one
              re-linearization, its adjoint passes, one pullback), and
              each step's gradients and linesearch trials, from the
              descent's spans; per step its wall; host pulls by what,
              peak memory and descents per minute printed; then the
              descent once more through make_descent's segment, one
              step at a time: per-step x and step size at 1e-8, gradient
              norms at 1e-6, masks and linesearch steps exactly; (d3)
              d1's call with checkpoint_every=1 into a CheckpointStore
              under --out, bitwise equal to d1's result in this process;
              then a child process (descent_cases.child_command) runs it
              under RAFT_TPU_FAULTS=kill@optimize:step=1 and must exit
              137, and this process resumes from the child's checkpoint
              (resumed_from_step 1), bitwise equal to d1 again; then
              under corrupt@checkpoint:once (the segmented run's
              checkpoint dropped and counted, the resume falls back to
              step 0) and under enospc@checkpoint (checkpointing shed,
              nothing written), each bitwise equal to d1; every call
              inside obs.transfers.guard("disallow");
18. partition — the partition layer (parallel/partition.py,
              models/partition_cases.py) on a mesh of two shards: two
              cards when there are, else cuda:0 twice (said on its own
              line): phase 5's 1024-case OC3spar sweep_cases in f64 and
              mixed, a sweep_variants of the first 16 volturn_grid
              VolturnUS-S variants, (f3)'s sweep_farm (4 turbines x 256
              cases) and a 1-step optimize_designs of d1's lanes (5,
              padded to 6), each against its unsharded call (floats
              within 1e-12, variants 1e-12 relative on top; iters,
              converged, fp_chunks exact; the descent against d1's
              golden step 0 at 1e-8) with the counted pulls the
              unsharded call's, the K1 / K3 launches per shard printed;
19. serve   — the serving path (raft_tpu_torch/serve,
              models/serve_cases.py, golden of tests/golden/serve_golden.py)
              on VolturnUS-S at its 80 bins, each service's runner built
              before its counted path: (s1) Model.make_service(batch_cases
              8) with a journal and a result store, 24 seeded requests
              submitted before start() (3 batches of 8), served under
              obs.transfers.guard("disallow"): each std bitwise the
              batched solver's on the same 8 lanes and its digest
              digest_metrics of those, against the JAX golden at 1e-9
              (iters, converged, seq exact); K1 launches (2 a fixed-point
              chunk) and counted pulls (1 serve_batch and 5 fixed-point
              checks) a batch; (s2) 8 resubmissions answered from the
              store, 0 launches, equal digests; (s3) a new service on the
              journal recovers the 24 with 0 launches; (s4) a warm-start
              service (s1's first batch cold, 8 near requests seeded, 8
              seeded and audited) against the golden's rows and warm
              facts (audit mismatches 0), iterations warm against cold;
              (s5) the HTTP front door on 127.0.0.1:0: two /submit (one an
              s1 request: s1's digest), /result, /stats, /healthz,
              /metrics; (s6) a batch_cases 64 service on 64 requests, in
              f64 (K1) and under RAFT_TPU_PRECISION=mixed (K3), bitwise
              the batched solver; (s7) one /farm request, (f3)'s layout x
              8 cases, on the runner a first request with other cases
              built: bitwise sweep_farm, K1 launches 2 a fixed-point
              chunk; (s8) one submit_optimize with
              d1's space and objective, 2 lanes, steps 1, bitwise
              optimize_designs called directly (both guarded);
20. prints the kernels JSON line, the card line, and the final JSON line.
Phases 7-13 and 16-19 run in four worker processes on the same card
(mhk and serve; farm, mcf and partition; golden, golden_mixed, qtf,
potflow, ballast and codesign; descent: ``--worker NAMES``,
WORKER_GROUPS), started after phase 3 and running
beside phases 4-6, 14 and 15 of this process; it then joins them, replays
their output and merges their launches, rows, walls and failures.  The
walls and the timed rows of phases 4-19 are taken with the card and the
host shared.
Each path of phases 4-19 runs with the launch counters set to 0 just
before it and read just after; every kernel of a path must launch in it.
Every Model run of phases 4-13 must end with no recovery attempt and no
quarantined case, and every sweep_cases with no quarantined lane;
raft_tpu_recovery_attempts_total reads 0 after them and, after phase 14,
the rungs phase 14 recorded; the case journal of every run goes under
--out (RAFT_TPU_JOURNAL_DIR).

Options: --only-kernels stops after phase 3 (the short call after a
kernel edit); --out DIR sets where the full
record (ptxas.log, chip_smoke.json, each worker's output and record) is
written (default build/chip_smoke); --worker NAMES runs only those phases
of 7-13 and 16-19 (comma-separated) and writes their record, as the
workers do.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

#: the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM3
#: at 3.35 TB/s; FP64 on the tensor cores at 67 TFLOP/s, the highest FP64
#: rate the card has; FP32 outside the tensor cores at 67 TFLOP/s; bf16 on
#: the tensor cores at 989 TFLOP/s (the least time the work could take)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 67e12
PEAK_LOW_PER_S = {"f32": 67e12, "bf16": 989e12}

X_TOL = 1e-10         # kernel vs plain version, max-abs relative
X_TOL_F32 = 5e-3      # the float32 instantiations: f32 eps x cond of
                      # the random draw (7.5e-4 seen at 81,920 lanes)
RESID_TOL_F32 = 1e-5  # their normwise relative residual, at f32
ILL_TOL = 1e9 * 2.2e-16 * 10   # promoted cond-1e9 lanes: cond * eps * 10
RESID_TOL = 1e-13     # normwise relative residual of the kernel's answer
GOLDEN_TOL = 1e-6
GOLDEN_RESID_TOL = 0.5
SWEEP_CASES = 1024
SWEEP_SERIAL_LANES = 8
SWEEP_RTOL = 1e-9
MIXED_STD_RTOL = 1e-6
VARIANT_SERIAL = 2   # serial variants held against the batch (the first, the last)
QTF_TOL = 1e-12       # K5 vs plain, relative to max|Q| (node-sum order)
BEM_FILES_TOL = 1e-9  # the port's preprocess_BEM files vs the JAX package's
WAMIT_RERUN_TOL = 1e-12   # (b) from the cache's files vs (a)
BEM_SERIAL_LANES = 4  # BEM sweep lanes held against the serial solve

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


#: what each device_ms call saw, in call order: the kernel names asked
#: for, and whether its profiler session raised (and what), how many
#: device events it held and how many matched
DEVICE_MS_LOG: list = []


def device_ms(fn, kernel_substr, reps=20, by_kernel=None):
    """Device time per call of ``fn``: the summed device time of every
    CUDA kernel whose name contains ``kernel_substr`` (or any of a tuple
    of substrings: the demangled and the mangled spelling) over ``reps``
    calls, from torch.profiler's CUDA activity, divided by ``reps`` (so a
    call that launches several kernels counts them all); None when the
    profiler sees no device time.  Each call's session is logged in
    DEVICE_MS_LOG.  ``by_kernel``, a dict, gets each matching kernel's ms
    per call by name."""
    subs = (kernel_substr,) if isinstance(kernel_substr, str) \
        else tuple(kernel_substr)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    note = dict(kernels=subs[0])
    DEVICE_MS_LOG.append(note)
    # a session that sees no kernel is retried once with CPU activity
    # too (the farm operands' row saw none in two runs); the keys it saw
    # are logged
    for attempt, acts in enumerate(([ProfilerActivity.CUDA],
                                    [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])):
        try:
            with profile(activities=acts) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
        except (RuntimeError, AttributeError) as e:
            note["error"] = f"{type(e).__name__}: {e}"
            log(f"  device_ms: no device time for {subs[0]}: {note}")
            return None
        tot, hits, found = 0.0, 0, {}
        for ev in events:
            if any(sub in ev.key for sub in subs):
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = getattr(ev, "cuda_time_total", 0.0)
                tot += t
                hits += 1
                words = ev.key.replace("(", " ").split()
                name = next((w.split("::")[-1] for w in words
                             if any(sub in w for sub in subs)), ev.key[:60])
                found[name] = found.get(name, 0.0) + t / reps / 1e3
        note.update(events=len(events), matched=hits, device_us=tot,
                    attempt=attempt)
        if tot > 0:
            if by_kernel is not None:
                for name, ms in found.items():
                    by_kernel[name] = by_kernel.get(name, 0.0) + ms
            return tot / reps / 1e3
        note.setdefault("unmatched_keys", []).append(
            [ev.key[:60] for ev in events][:8])
        log(f"  device_ms: no device time for {subs[0]} (session "
            f"{attempt}): {note}")
    return None


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


def ladder_flops(S, K, lanes, promoted, refine=2):
    """(FP64, low-width) operations of the mixed ladder over ``lanes``
    systems of size S with K right-hand sides: equilibration, the
    residuals and corrections at FP64, 1 + refine eliminations at the low
    width, and a full FP64 solve (refine passes) for each of this run's
    ``promoted`` lanes."""
    W = S + K
    elim = sum((W - kk - 1) * (1 + 2 * (S - 1)) for kk in range(S))
    resid = 2 * S * S * K + 2 * S * K
    f64 = lanes * (S * W + S + (refine + 1) * resid) \
        + promoted * gj_flops(S, K, refine)
    return f64, lanes * (1 + refine) * elim


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_, flops, low_flops=0, low="f32"):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type
    (FP64, plus the low-width elimination at PEAK_LOW_PER_S[low])."""
    tb = bytes_ / PEAK_BYTES_PER_S * 1e3
    tf = (flops / PEAK_FP64_PER_S + low_flops / PEAK_LOW_PER_S[low]) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernel parity and times
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _normwise_residual(A, x, b) -> float:
    """max over systems of |b - A x|_inf / (|A|_inf |x|_inf + |b|_inf); a
    system with b = 0 and x = 0 (a frequency a sea state leaves empty)
    has r = 0 and counts 0."""
    r = b - A @ x
    inf = lambda t: torch.amax(torch.abs(t), dim=(-2, -1))  # noqa: E731
    nA = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1)
    den = nA * inf(x) + inf(b)
    return float(torch.max(torch.where(den > 0, inf(r) / den, inf(r))))


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


def _svd_ill(A, every, g, cond=1e9):
    """Rewrite systems 0, every, 2*every, ... of A (lanes, n, n) to
    condition number ``cond`` through their SVD: the f32 rung cannot
    refine those below the promotion tolerance, so they must promote."""
    A = A.clone()
    n = A.shape[-1]
    idx = torch.arange(0, A.shape[0], every)
    U, _, Vh = torch.linalg.svd(A[idx])
    sv = torch.logspace(0.0, -math.log10(cond), n, dtype=torch.float64)
    A[idx] = (U * sv) @ Vh
    return A, idx


def impedance_inputs(g, nb, nw, n, kind, dev):
    """K1/K3 operands: w (nw,), M, B (nb, n, n, nw), C (nb, n, n),
    F (nb, n, nw), and the case indices made ill ("svd_ill": Z = C with
    cond 1e9 at every bin of every 16th case)."""
    f64 = dict(dtype=torch.float64, generator=g)
    w = torch.linspace(0.005, 0.4, nw, dtype=torch.float64) * 2 * math.pi
    M = torch.randn((nb, n, n, nw), **f64) \
        + 5.0 * torch.eye(n, dtype=torch.float64)[:, :, None]
    B = 0.1 * torch.randn((nb, n, n, nw), **f64)
    C = torch.randn((nb, n, n), **f64) + 10.0 * torch.eye(n, dtype=torch.float64)
    F = torch.complex(torch.randn((nb, n, nw), **f64),
                      torch.randn((nb, n, nw), **f64))
    ill = torch.zeros(0, dtype=torch.long)
    if kind == "pivoting":
        C = 10.0 * _pivot_stack(g, nb, n, "cpu")
        M = 0.01 * M
        B = 0.01 * B
    elif kind == "row_scales":
        s = 10.0 ** (3.0 + 7.0 * torch.rand((nb, n, 1), **f64))
        M = M * s[..., None]
        B = B * s[..., None]
        C = C * s
        F = F * 1e6
    elif kind == "svd_ill":
        C, ill = _svd_ill(C, 16, g)
        M[ill] = 0.0
        B[ill] = 0.0
    return [t.to(dev) for t in (w, M, B, C, F)], ill


def gj_inputs(g, lanes, n, k, kind, dev):
    """K2/K4 operands A (lanes, n, n), b (lanes, n, k), the complex Z of
    the main path's inv_complex ("inv_complex") and the ill lane
    indices ("svd_ill": every 16th lane at cond 1e9)."""
    f64 = dict(dtype=torch.float64, generator=g)
    ill = torch.zeros(0, dtype=torch.long)
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
        return A.to(dev), b[..., :k].contiguous().to(dev), Z.to(dev), ill
    if kind == "pivoting":
        A = _pivot_stack(g, lanes, n, "cpu")
    elif kind == "row_scales":
        A = (0.1 * torch.randn((lanes, n, n), **f64) + torch.eye(n, dtype=torch.float64)) \
            * 10.0 ** (3.0 + 7.0 * torch.rand((lanes, n, 1), **f64))
    else:
        A = torch.randn((lanes, n, n), **f64) + 5.0 * torch.eye(n, dtype=torch.float64)
        if kind == "svd_ill":
            A, ill = _svd_ill(A, 16, g)
    b = torch.randn((lanes, n, k), **f64) * 1e3
    return A.to(dev), b.to(dev), None, ill


#: rows of the kernel phase, per kernel key of the launch counters
ROWS: dict = {}

#: per kernel key: the profiler's names for it (demangled, mangled)
KERNEL_NAMES = {
    "impedance_gj": ("impedance_group_kernel<double, double",
                     "impedance_group_kernelIddLi"),
    "impedance_gj_f32": ("impedance_group_kernel<float, float",
                         "impedance_group_kernelIffLi"),
    "impedance_gj_mixed": ("impedance_group_kernel<double, float",
                           "impedance_group_kernelIdfLi"),
    "impedance_gj_mixed_bf16": ("impedance_group_kernel<double, gjl::bf16r",
                                "impedance_group_kernelIdN3gjl5bf16rE"),
    "gj_solve": ("gj_group_kernel<double, double", "gj_group_kernelIddLi"),
    "gj_solve_f32": ("gj_group_kernel<float, float", "gj_group_kernelIffLi"),
    "gj_solve_mixed": ("gj_group_kernel<double, float",
                       "gj_group_kernelIdfLi"),
    "gj_solve_mixed_bf16": ("gj_group_kernel<double, gjl::bf16r",
                            "gj_group_kernelIdN3gjl5bf16rE"),
}


def _split_rel(X, Xp, ill, case_axis=0):
    """(rel of the well lanes, rel of the ill lanes; None where the
    inputs have no ill lanes)."""
    if len(ill) == 0:
        return _rel(X, Xp), None
    keep = torch.ones(X.shape[case_axis], dtype=torch.bool)
    keep[ill] = False
    keep = keep.to(X.device)
    return _rel(X[keep], Xp[keep]), _rel(X[ill.to(X.device)],
                                         Xp[ill.to(X.device)])


def _time_row(row, call, plain, library, names):
    row["ms"] = time_ms(call)
    row["device_ms"] = device_ms(call, names)
    row["plain_ms"] = time_ms(plain, reps=3, warmup=1)
    row["library_ms"] = time_ms(library)


def _log_row(key, row):
    extra = ""
    if "ms" in row:
        extra = (f" | kernel {row['ms']:.4f} ms (device {row['device_ms']})"
                 f"  plain {row['plain_ms']:.3f} ms"
                 f"  torch.linalg.solve {row['library_ms']:.4f} ms"
                 f"  bound {row['bound_ms']:.2e} ms ({row['bound_by']})")
    prom = (f" promoted {row['promoted']}/{row['promoted_plain']}"
            if "promoted" in row else "")
    log(f"  {key:24s} {row['case']:11s} lanes={row['lanes']:6d}"
        f" k={row.get('k', 1)} rel={row['rel_vs_plain']:.2e}"
        + (f" ill_rel={row['rel_ill']:.2e}" if row.get("rel_ill") else "")
        + prom + extra)


def check_impedance(G, g, dev, width):
    """K1 (width "f64" / "f32") or K3 ("mixed_f32" / "mixed_bf16")."""
    n = 6
    fd = {"mixed_f32": torch.float32, "mixed_bf16": torch.bfloat16}.get(width)
    key = {"f64": "impedance_gj", "f32": "impedance_gj_f32",
           "mixed_f32": "impedance_gj_mixed",
           "mixed_bf16": "impedance_gj_mixed_bf16"}[width]
    kinds = ["random", "pivoting", "row_scales"] + (["svd_ill"] if fd else [])
    shapes = ((1, 80), (64, 80), (1024, 80)) if width != "f64" \
        else ((1, 80), (3, 80), (64, 80), (1024, 80))
    rows = ROWS.setdefault(key, [])
    for nb, nw in shapes:
        for kind in kinds:
            if kind == "svd_ill" and nb == 1:
                nb_, nw_ = 8, 10       # 80 lanes with one ill case
            else:
                nb_, nw_ = nb, nw
            (w, M, B, C, F), ill = impedance_inputs(g, nb_, nw_, n, kind, dev)
            if width == "f32":
                w, M, B, C = (t.float() for t in (w, M, B, C))
                F = F.to(torch.complex64)
            kw = dict(refine=2, precision="mixed", factor_dtype=fd,
                      return_stats=True) if fd else {}
            out = G.impedance_gj_solve(w, M, B, C, F, **kw)
            outp = G.impedance_gj_solve_plain(w, M, B, C, F, **kw)
            torch.cuda.synchronize()
            (X, st), (Xp, stp) = (out, outp) if fd else ((out, None),
                                                         (outp, None))
            rel, rel_ill = _split_rel(X, Xp, ill)
            lanes = nb_ * nw_
            row = dict(lanes=lanes, case=kind, rel_vs_plain=rel,
                       rel_ill=rel_ill,
                       max_abs_err=float(torch.max(torch.abs(X - Xp))))
            tol = X_TOL_F32 if width == "f32" else X_TOL
            ok = rel <= tol and (rel_ill is None or rel_ill <= ILL_TOL) \
                and bool(torch.all(torch.isfinite(X)))
            if width in ("f64", "f32"):
                Z = (-(w ** 2) * M + 1j * w * B + C[..., None]).movedim(-1, -3)
                row["normwise_residual"] = _normwise_residual(
                    Z, X.movedim(-1, -2)[..., None], F.movedim(-1, -2)[..., None])
                ok = ok and row["normwise_residual"] <= (
                    RESID_TOL if width == "f64" else RESID_TOL_F32)
            if fd:
                row["promoted"] = int(st["promoted"])
                row["promoted_plain"] = int(stp["promoted"])
                row["resid_max"] = float(st["resid_max"])
                ok = ok and row["promoted"] == row["promoted_plain"] \
                    and row["promoted"] >= len(ill) * nw_
            if not ok:
                fail(f"{key} {kind} lanes={lanes}: rel={rel:.3e} "
                     f"ill={rel_ill} {row.get('promoted')}/"
                     f"{row.get('promoted_plain')}")
            if kind == "random" and nb in (1, 1024):
                Z = (-(w ** 2) * M + 1j * w * B + C[..., None]).movedim(-1, -3)
                Z = Z.to(torch.complex128)
                Fz = F.movedim(-1, -2)[..., None].to(torch.complex128)
                kwt = {k: v for k, v in kw.items() if k != "return_stats"}
                _time_row(row, lambda: G.impedance_gj_solve(w, M, B, C, F, **kwt),
                          lambda: G.impedance_gj_solve_plain(w, M, B, C, F, **kwt),
                          lambda: torch.linalg.solve(Z, Fz), KERNEL_NAMES[key])
                byts = nbytes(w, M, B, C, F, X)
                if fd:
                    f64_ops, low_ops = ladder_flops(2 * n, 1, lanes,
                                                    row["promoted"])
                    row["bound_ms"], row["bound_by"] = bound(
                        byts + 8 * lanes, f64_ops + lanes * 8 * n * n,
                        low_ops, width.split("_")[1])
                    row["peak_rates"] = dict(
                        fp64=PEAK_FP64_PER_S,
                        low=PEAK_LOW_PER_S[width.split("_")[1]])
                else:
                    flops = lanes * (gj_flops(2 * n, 1) + 8 * n * n)
                    if width == "f32":
                        row["bound_ms"], row["bound_by"] = bound(
                            byts, 0, flops, "f32")
                    else:
                        row["bound_ms"], row["bound_by"] = bound(byts, flops)
            rows.append(row)
            _log_row(key, row)


def check_impedance_sweep_shapes(G, g, dev):
    """K1 at the f64 sweep's own operand shapes: M (6, 6, 80) and C (6, 6)
    shared by 1024 cases, B (1024, 6, 6, 80) and F (1024, 6, 80) per case.
    The wrapper materialises the broadcast M (23.6 MB) at every call, so
    this row's call ms against its device ms is what that costs."""
    n, nb, nw = 6, SWEEP_CASES, 80
    key = "impedance_gj"
    (w, M, B, C, F), _ = impedance_inputs(g, nb, nw, n, "random", dev)
    M, C = M[0].contiguous(), C[0].contiguous()
    X = G.impedance_gj_solve(w, M, B, C, F)
    Xp = G.impedance_gj_solve_plain(w, M, B, C, F)
    torch.cuda.synchronize()
    rel = _rel(X, Xp)
    lanes = nb * nw
    row = dict(lanes=lanes, case="sweep_shapes", rel_vs_plain=rel,
               rel_ill=None, max_abs_err=float(torch.max(torch.abs(X - Xp))))
    Z = (-(w ** 2) * M + 1j * w * B + C[..., None]).movedim(-1, -3)
    Fz = F.movedim(-1, -2)[..., None]
    row["normwise_residual"] = _normwise_residual(Z, X.movedim(-1, -2)[..., None],
                                                  Fz)
    if not (rel <= X_TOL and row["normwise_residual"] <= RESID_TOL
            and bool(torch.all(torch.isfinite(X)))):
        fail(f"{key} sweep_shapes lanes={lanes}: rel={rel:.3e}")
    _time_row(row, lambda: G.impedance_gj_solve(w, M, B, C, F),
              lambda: G.impedance_gj_solve_plain(w, M, B, C, F),
              lambda: torch.linalg.solve(Z, Fz), KERNEL_NAMES[key])
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(w, M, B, C, F, X), lanes * (gj_flops(2 * n, 1) + 8 * n * n))
    ROWS.setdefault(key, []).append(row)
    _log_row(key, row)


#: the mangled symbols' tags of the four widths
WIDTH_TAGS = (("IddLi", "f64"), ("IffLi", "f32"), ("IdfLi", "mixed_f32"),
              ("IdN3gjl5bf16rELi", "mixed_bf16"))
#: the kernel families the ptxas gate holds to no stack frame and no
#: spill: (name, symbol stem, kernels: K1/K3 n = 1..8, K2/K4 even n <= 16
#: with k = 1 and n/2, at 4 widths; K5's record, pair and finish passes)
GROUP_FAMILIES = (("K1/K3", "impedance_group_kernel", 32),
                  ("K2/K4", "gj_group_kernel", 60),
                  ("K5", "qtf_k5_", 3))
#: K5's register ceiling: 2 blocks of 256 threads (16 warps) an SM
K5_MAX_REGISTERS = 128


def _family(sym):
    return next((f for f, stem, _ in GROUP_FAMILIES if stem in sym), None)


def _width(sym):
    return next((w for tag, w in WIDTH_TAGS if tag in sym), "?")


def _nk(sym):
    """(n, k) of a K1-K4 symbol (k = 1 for K1/K3)."""
    import re

    m = re.search(r"Li(\d+)E(?:Li(\d+)E)?", sym)
    if not m:
        return None, None
    return int(m.group(1)), int(m.group(2) or 1)


def group_ptxas(report) -> list:
    """Registers, stack frame and spills of every K1-K5 kernel from
    the -Xptxas -v report: [{family, symbol, width, n, k, registers,
    stack, spill_stores, spill_loads}]."""
    import re

    out = []
    for sym, lines in report.items():
        family = _family(sym)
        if family is None:
            continue
        text = " | ".join(lines)
        nums = {}
        for name, pat in (("registers", r"Used (\d+) registers"),
                          ("stack", r"(\d+) bytes stack frame"),
                          ("spill_stores", r"(\d+) bytes spill stores"),
                          ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, text)
            nums[name] = int(m.group(1)) if m else None
        n, k = _nk(sym)
        out.append(dict(family=family, symbol=sym, width=_width(sym), n=n,
                        k=k, **nums))
    out.sort(key=lambda d: (d["family"], d["width"], d["n"] or 0, d["k"] or 0))
    return out


def group_sass(lib_path) -> dict:
    """Static SASS facts of the main paths' K1/K3 instantiations (n = 6,
    every width), of K2 f64 and K4 f32 at n = 12, k = 6 and of the three
    K5 kernels, from ``cuobjdump -sass`` of the built library: total
    instructions, FP64 and FP32 arithmetic, shuffles, shared-memory loads
    and stores, calls, local loads and stores.  The K5 kernels' SASS is
    also written to OUT/qtf_k5.sass.  {} where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return {}
    try:
        out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                             text=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    classes = {"fp64": ("DFMA", "DMUL", "DADD"),
               "fp32": ("FFMA", "FMUL", "FADD"), "shfl": ("SHFL",),
               "lds": ("LDS",), "sts": ("STS",), "call": ("CALL",),
               "local": ("LDL", "STL")}
    facts = {}
    k5 = []
    for block in re.split(r"\n\s*Function : ", out):
        name = block.split("\n", 1)[0].strip()
        family, width, (n, k) = _family(name), _width(name), _nk(name)
        if family == "K5":
            k5.append(block)
            width = re.search(r"qtf_k5_(records|pairs|finish)", name).group(0)
        elif not ((family == "K1/K3" and n == 6) or (
                family == "K2/K4" and (n, k) == (12, 6)
                and width in ("f64", "mixed_f32"))):
            continue
        ops = [m.group(2).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)]
        facts.setdefault(family, {})[width] = dict(total=len(ops), **{
            kk: sum(op in v for op in ops) for kk, v in classes.items()})
    if k5:
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "qtf_k5.sass"), "w") as f:
            f.write("\n\n".join(k5))
    return facts


def check_gj(G, g, dev, width):
    """K2 (width "f64" / "f32") or K4 ("mixed_f32" / "mixed_bf16")."""
    n = 12
    fd = {"mixed_f32": torch.float32, "mixed_bf16": torch.bfloat16}.get(width)
    key = {"f64": "gj_solve", "f32": "gj_solve_f32",
           "mixed_f32": "gj_solve_mixed",
           "mixed_bf16": "gj_solve_mixed_bf16"}[width]
    kinds = ["inv_complex", "random", "pivoting", "row_scales"] \
        + (["svd_ill"] if fd else [])
    rows = ROWS.setdefault(key, [])
    for lanes in (80, 5120):
        for k in (6, 1):
            for kind in kinds:
                if kind == "inv_complex" and k != 6:
                    continue
                A, b, Z, ill = gj_inputs(g, lanes, n, k, kind, dev)
                if width == "f32":
                    A, b = A.float(), b.float()
                kw = dict(refine=2, precision="mixed", factor_dtype=fd,
                          return_stats=True) if fd else {}
                out = G.gj_solve(A, b, **kw)
                outp = G.gj_solve_plain(A, b, **kw)
                torch.cuda.synchronize()
                (x, st), (xp, stp) = (out, outp) if fd else ((out, None),
                                                             (outp, None))
                rel, rel_ill = _split_rel(x, xp, ill)
                row = dict(lanes=lanes, k=k, case=kind, rel_vs_plain=rel,
                           rel_ill=rel_ill,
                           max_abs_err=float(torch.max(torch.abs(x - xp))))
                tol = X_TOL_F32 if width == "f32" else X_TOL
                ok = rel <= tol and (rel_ill is None or rel_ill <= ILL_TOL) \
                    and bool(torch.all(torch.isfinite(x)))
                if width in ("f64", "f32"):
                    row["normwise_residual"] = _normwise_residual(A, x, b)
                    ok = ok and row["normwise_residual"] <= (
                        RESID_TOL if width == "f64" else RESID_TOL_F32)
                if fd:
                    row["promoted"] = int(st["promoted"])
                    row["promoted_plain"] = int(stp["promoted"])
                    row["resid_max"] = float(st["resid_max"])
                    ok = ok and row["promoted"] == row["promoted_plain"] \
                        and row["promoted"] >= len(ill)
                if not ok:
                    fail(f"{key} {kind} lanes={lanes} k={k}: rel={rel:.3e} "
                         f"ill={rel_ill} {row.get('promoted')}/"
                         f"{row.get('promoted_plain')}")
                if kind == "inv_complex":
                    eye = torch.eye(6, dtype=torch.complex128,
                                    device=dev).expand(lanes, 6, 6)
                    kwt = {kk: v for kk, v in kw.items() if kk != "return_stats"}
                    _time_row(row, lambda: G.gj_solve(A, b, **kwt),
                              lambda: G.gj_solve_plain(A, b, **kwt),
                              lambda: torch.linalg.solve(Z, eye),
                              KERNEL_NAMES[key])
                    byts = nbytes(A, b, x)
                    if fd:
                        f64_ops, low_ops = ladder_flops(n, k, lanes,
                                                        row["promoted"])
                        row["bound_ms"], row["bound_by"] = bound(
                            byts + 8 * lanes, f64_ops, low_ops,
                            width.split("_")[1])
                        row["peak_rates"] = dict(
                            fp64=PEAK_FP64_PER_S,
                            low=PEAK_LOW_PER_S[width.split("_")[1]])
                    elif width == "f32":
                        row["bound_ms"], row["bound_by"] = bound(
                            byts, 0, lanes * gj_flops(n, k), "f32")
                    else:
                        row["bound_ms"], row["bound_by"] = bound(
                            byts, lanes * gj_flops(n, k))
                rows.append(row)
                _log_row(key, row)


#: the gj_solve shapes the K2/K4 kernels do not instantiate, which the
#: wrapper runs on the card all the same (ROADMAP C6): odd n, padded
#: exactly to n + 1, at k = 1 and 3; and the ladder with k > n/2, in
#: column chunks with one promotion decision per lane
C6_ODD_N = tuple(range(1, 16, 2))
C6_LADDER_NK = ((2, 3), (6, 7), (12, 12), (16, 13))
C6_WIDTH_FD = {"f64": None, "f32": None, "mixed_f32": torch.float32,
               "mixed_bf16": torch.bfloat16}


def _c6_row(G, A, b, ill, width, n, k, case):
    fd = C6_WIDTH_FD[width]
    if width == "f32":
        A, b = A.float(), b.float()
    kw = dict(refine=2, precision="mixed", factor_dtype=fd,
              promote_tol=1e-9, return_stats=True) if fd else {}
    from raft_tpu_torch import errors

    try:
        out = G.gj_solve(A, b, **kw)
    except errors.KernelFailure as e:
        fail(f"gj_solve C6 {width} n={n} k={k} {case}: {e}")
        return None
    outp = G.gj_solve_plain(A, b, **kw)
    torch.cuda.synchronize()
    (x, st), (xp, stp) = (out, outp) if fd else ((out, None), (outp, None))
    rel, rel_ill = _split_rel(x, xp, ill)
    row = dict(width=width, n=n, k=k, case=case, lanes=int(A.shape[0]),
               rel_vs_plain=rel, rel_ill=rel_ill,
               max_abs_err=float(torch.max(torch.abs(x - xp))))
    tol = X_TOL_F32 if width == "f32" else X_TOL
    ok = x.shape == xp.shape and rel <= tol and (
        rel_ill is None or rel_ill <= ILL_TOL)
    if fd:
        row["promoted"] = int(st["promoted"])
        row["promoted_plain"] = int(stp["promoted"])
        ok = ok and row["promoted"] == row["promoted_plain"] \
            and row["promoted"] >= len(ill)
    if not ok:
        fail(f"gj_solve C6 {width} n={n} k={k} {case}: rel={rel:.3e} "
             f"ill={rel_ill} {row.get('promoted')}/"
             f"{row.get('promoted_plain')}")
    return row


def check_gj_every_shape(G, g, dev):
    """ROADMAP C6: gj_solve on the card at the shapes the kernels do not
    instantiate, against the plain version (x, and the promoted count
    under the ladder): odd n = 1..15 in f64, f32 and mixed f32, and the
    ladder (f32 and bf16 elimination) with k > n/2; 80 systems, every
    16th conditioned to 1e9 under the ladder (n > 1).  The launches of
    this phase are comparisons: the path counters are reset before each
    path."""
    rows = ROWS.setdefault("gj_solve_c6", [])
    for n in C6_ODD_N:
        for k in (1, 3):
            for width in ("f64", "f32", "mixed_f32"):
                # a 1 x 1 system has cond 1: nothing to condition
                kind = "svd_ill" if width.startswith("mixed") and n > 1 \
                    else "random"
                A, b, _, ill = gj_inputs(g, 80, n, k, kind, dev)
                row = _c6_row(G, A, b, ill, width, n, k, f"odd_n_{kind}")
                if row:
                    rows.append(row)
    for n, k in C6_LADDER_NK:
        for width in ("mixed_f32", "mixed_bf16"):
            A, b, _, ill = gj_inputs(g, 80, n, k, "svd_ill", dev)
            # one lane's last column 1e6x the rest: a chunk's own residual
            # would judge that lane otherwise than the lane's
            b[3, :, -1] *= 1e6
            row = _c6_row(G, A, b, ill, width, n, k, "ladder_k_gt_n_half")
            if row:
                rows.append(row)
    worst = max((r["rel_vs_plain"] for r in rows), default=0.0)
    log(f"  gj_solve C6: {len(rows)} shapes (odd n {C6_ODD_N[0]}-"
        f"{C6_ODD_N[-1]}; ladder (n, k) {list(C6_LADDER_NK)}) on the card; "
        f"worst rel {worst:.2e}; promoted equal on every ladder row "
        + str(all(r.get("promoted") == r.get("promoted_plain")
                  for r in rows)))
    return rows


def check_device_guard(dev):
    """K1 at 80 lanes with its operands on cuda:0 outside and inside a
    torch.cuda.device(0) guard: bitwise equal (on one card the wrapper's
    own device guard changes nothing); with two cards, K1 on cuda:1 with
    cuda:0 current against its plain version (X_TOL)."""
    from raft_tpu_torch.ops.kernels import gj_solve as G

    g = torch.Generator().manual_seed(77)
    d0 = torch.device("cuda", 0)
    (w, M, B, C, F), _ = impedance_inputs(g, 1, 80, 6, "random", d0)
    out = G.impedance_gj_solve(w, M, B, C, F)
    with torch.cuda.device(0):
        inside = G.impedance_gj_solve(w, M, B, C, F)
    same = bool(torch.equal(out, inside))
    log(f"  device guard: K1 on cuda:0 outside and inside "
        f"torch.cuda.device(0) bitwise equal: {same}")
    if not same:
        fail("K1 differs inside a torch.cuda.device(0) guard")
    if torch.cuda.device_count() >= 2:
        d1 = torch.device("cuda", 1)
        ops = [t.to(d1) for t in (w, M, B, C, F)]
        with torch.cuda.device(0):
            X = G.impedance_gj_solve(*ops)
            torch.cuda.synchronize(d1)
        rel = _rel(X, G.impedance_gj_solve_plain(*ops))
        log(f"  device guard: K1 on cuda:1 with cuda:0 current vs plain "
            f"rel {rel:.2e}")
        if not rel <= X_TOL:
            fail(f"K1 on cuda:1 with cuda:0 current: rel {rel:.2e}")
    else:
        log("  device guard: one card, the cuda:1 launch not run")
    return same


def check_kernels(dev):
    from raft_tpu_torch.ops.kernels import gj_solve as G

    g = torch.Generator().manual_seed(1234)
    for width in ("f64", "f32", "mixed_f32", "mixed_bf16"):
        check_impedance(G, g, dev, width)
        if width == "f64":
            check_impedance_sweep_shapes(G, g, dev)
        check_gj(G, g, dev, width)
    check_gj_every_shape(G, g, dev)
    return ROWS


# ---- K5: the QTF pair grid ----

#: FP64 operations the pair grid needs, which is fewer than K5's body does
#: (about 2,100 per pair and submerged node).  A complex multiply is 6, a
#: complex add 2, a real-by-complex multiply 2, a real operation 1; tanh,
#: cosh, sinh, sin, cos and sqrt one each, so the bound is a lower bound.
#: Work on one frequency's fields is counted once per (frequency,
#: submerged node), not per pair; constant factors fold into per-node
#: matrices (rho v_i Minert + rho v_end Ca_End qMat as one, rho v_i CaMat,
#: I - qMat); a matrix applied to several vectors that are then summed is
#: applied once to their sum; o x v is the skew of o added to grad u (V).
#: Names follow qtf_pair.cuh (1 = the w1 side, 2 = the w2 side, ua = u -
#: nv, cu = CaMat ua, uat = (I - qMat) ua, oq = o x q).
QTF_FREQ_NODE_OPS = sum((
    6,     # ua
    30,    # cu: real 3x3 by complex 3-vector
    30,    # ptMat ua
    30,    # uat
    40,    # dw/dz = q . (grad u q)
    22,    # t = ua - (q . ua) q, transverse to the axis
    18,    # oq
    12,    # V = grad u + skew(o): six off-diagonal adds
))
QTF_PAIR_NODE_OPS = sum((
    162,   # grad u1 (conj u2 + i w1 conj dr2) + conj(grad u2) (u1 + conj(i w2) dr1)
    30,    # the combined Minert/qMat matrix on that sum
    22,    # ptMat ua1 . conj(cu2)
    46,    # gp1 . conj(dr2) + conj(gp2) . dr1
    4,     # the pressure sum
    8,     # a_i p q
    42,    # dw/dz1 conj(t2) + conj(dw/dz2) t1
    22,    # its transverse part
    42,    # conj(nax2) oq1 + nax1 conj(oq2)
    138,   # V1 conj(cu2) + conj(V2) cu1
    138,   # V1 conj(uat2) + conj(V2) uat1
    12,    # the CaMat bracket
    30,    # rho v_i CaMat on it
    30,    # (I - qMat) on the cu products
    18,    # the node force: four vectors summed
    18,    # the moment, offset x f
    12,    # into the node sum
))
#: the second-order potential, per off-diagonal pair and submerged node
#: (the active mask zeroes the diagonal)
QTF_POT_OPS = sum((
    2,     # |dk| (z + h), clamped
    4,     # cosh, sinh, over cosh(|dk| h)
    5,     # phase exp(-i (dkx x + dky y))
    11,    # the acceleration (the pair's factor is imaginary)
    2,     # the pressure
    8,     # into the Minert/qMat vector and the pressure sum
))
QTF_NODE_OPS = 50      # the per-node matrices and factors, once a node
QTF_FREQ_OPS = 6       # o = i w Xi[3:], once a frequency
#: per pair: the potential's pair factors (47), Pinkster IV (180), adding
#: the node sum and the waterline sum (24)
QTF_PAIR_OPS = 251
#: per pair and waterline member: three two-sided products (126), two
#: real 3x3 products (60), their sums (18), the moment and its sum (24)
QTF_MEMBER_OPS = 228


def qtf_ops(fields) -> int:
    """FP64 operations the pair grid needs on these fields (this data:
    every pair, the submerged nodes only); see QTF_PAIR_NODE_OPS."""
    nw2 = int(fields["w2"].shape[0])
    sub = int(torch.count_nonzero(fields["nodescal"][:, 3]))
    nm = 0 if fields.get("wl") is None else int(fields["wl"]["geo"].shape[0])
    return (nw2 * nw2 * sub * QTF_PAIR_NODE_OPS
            + nw2 * (nw2 - 1) * sub * QTF_POT_OPS
            + nw2 * sub * QTF_FREQ_NODE_OPS + sub * QTF_NODE_OPS
            + nw2 * QTF_FREQ_OPS
            + nw2 * nw2 * (QTF_PAIR_OPS + QTF_MEMBER_OPS * nm))


def qtf_cases(dev):
    """(label, fowt, fields, beta) of K5's rows: the spar at nw2 = 5 in
    four variants, and the OC4semi example at nw2 = 30 (its 0.005-0.15 Hz
    grid) and 80 (0.005-0.40 Hz, the design's own resolution), with
    seeded random RAOs."""
    from raft_tpu_torch.models import qtf_cases as QC

    out = []
    for label, design, w, beta, motion, pose in (
            ("spar_nm1", QC.spar_design(10.0), QC.SPAR_W, 0.0, True, None),
            ("spar_nm0", QC.spar_design(-5.0), QC.SPAR_W, 0.0, True, None),
            ("spar_fixed", QC.spar_design(10.0), QC.SPAR_W, 0.0, False, None),
            ("spar_b035", QC.spar_design(10.0), QC.SPAR_W, 0.35, True, None),
            ("oc4semi_30", QC.oc4semi_design(0.15), QC.OC4SEMI_W, 0.0, True,
             None),
            ("oc4semi_80", QC.oc4semi_design(0.40), QC.OC4SEMI_W, 0.0, True,
             QC.OFFSET_POSE)):
        f, _, _, fields = QC.case_fields(design, w, beta, motion=motion,
                                         pose=pose, device=dev)
        out.append((label, f, fields, beta))
    return out


def check_qtf(dev):
    """K5 against its plain version on every row, each row timed (no
    PyTorch call computes this function: library "none")."""
    from raft_tpu_torch.ops.kernels import qtf_pair as K

    rows = ROWS.setdefault("qtf_pair", [])
    for label, f, fields, beta in qtf_cases(dev):
        args = (fields, beta, f.depth, f.rho_water, f.g)
        Q = K.qtf_pair_grid(*args)
        Qp = K.qtf_pair_grid_plain(*args)
        torch.cuda.synchronize()
        nw2 = int(fields["w2"].shape[0])
        nm = 0 if fields["wl"] is None else int(fields["wl"]["geo"].shape[0])
        rel = _rel(Q, Qp)
        row = dict(case=label, lanes=nw2 * nw2, nw2=nw2,
                   N=int(fields["q"].shape[0]), nm=nm,
                   submerged=int(torch.count_nonzero(fields["nodescal"][:, 3])),
                   rel_vs_plain=rel,
                   max_abs_err=float(torch.max(torch.abs(Q - Qp))),
                   max_abs_Q=float(torch.max(torch.abs(Qp))))
        row["bitwise_repeat"] = bool(torch.equal(K.qtf_pair_grid(*args), Q))
        if not (rel <= QTF_TOL and bool(torch.all(torch.isfinite(Q)))
                and row["bitwise_repeat"]):
            fail(f"qtf_pair {label}: rel={rel:.3e} vs plain, second call "
                 f"bitwise equal {row['bitwise_repeat']}")
        ops, _ = K.kernel_operands(fields)
        row["node_split"] = K.node_split(nw2, row["submerged"])
        row["ms"] = time_ms(lambda: K.qtf_pair_grid(*args))
        # the three K5 kernels of a call, summed (and each apart)
        row["device_by_kernel"] = {}
        row["device_ms"] = device_ms(lambda: K.qtf_pair_grid(*args),
                                     "qtf_k5_",
                                     by_kernel=row["device_by_kernel"])
        row["plain_ms"] = time_ms(lambda: K.qtf_pair_grid_plain(*args),
                                  reps=3, warmup=1)
        row["library_ms"] = None
        row["ops"] = qtf_ops(fields)
        row["bytes"] = nbytes(*ops.values(), Q)
        row["bound_ms"], row["bound_by"] = bound(row["bytes"],
                                                 row["ops"])
        rows.append(row)
        log(f"  qtf_pair {label:11s} nw2={nw2:3d} N={row['N']:3d} nm={nm}"
            f" submerged={row['submerged']} rel={rel:.2e} bitwise repeat "
            f"{row['bitwise_repeat']} nodes a block {row['node_split']} | "
            "kernels "
            f"{row['ms']:.4f} ms (device {row['device_ms']})  plain "
            f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.2e} ms "
            f"({row['bound_by']}: {row['ops']:.3e} FP64 ops, "
            f"{row['bytes']} bytes); device by kernel "
            + ", ".join(f"{k} {v:.4f}"
                        for k, v in row["device_by_kernel"].items()))
    return rows


# ---------------------------------------------------------------------------
# phases 4-13: the paths, each with its own launch counts
# ---------------------------------------------------------------------------

#: launches per path, read just after it ran (counters set to 0 just
#: before it)
PATH_LAUNCHES: dict = {}
#: phase 5's sweep outputs by mode, which phase 15's health sweeps must
#: reproduce bitwise
SWEEP_OUTS: dict = {}
#: wall seconds of each phase (build, kernels, 4-14), for chip_smoke.json
PHASE_WALLS: dict = {}


def counted(path, expect):
    """Context: set every launch counter to 0, run the path, read the
    counts into PATH_LAUNCHES[path]; fail if a kernel in ``expect`` did
    not launch."""
    import contextlib

    from raft_tpu_torch.ops.kernels import gj_solve as G
    from raft_tpu_torch.ops.kernels import qtf_pair as K

    @contextlib.contextmanager
    def cm():
        G.reset_launches()
        K.reset_launches()
        yield
        torch.cuda.synchronize()
        got = {k: v for k, v in {**G.LAUNCHES, **K.LAUNCHES}.items() if v}
        PATH_LAUNCHES[path] = got
        log(f"  [{path}] launches {got}")
        for k in expect:
            if got.get(k, 0) <= 0:
                fail(f"kernel {k} was never launched on the {path} path")
    return cm()


def run_main(dev):
    from raft_tpu_torch import run_raft
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.ops import linalg

    per_design = {}
    with counted("run_raft", ("impedance_gj", "gj_solve")):
        for name in ("OC3spar", "VolturnUS-S"):
            t0 = time.perf_counter()
            model = run_raft(load_design(name), device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            disp = linalg.last_dispatch()
            cm = model.results["case_metrics"]
            finite = bool(np.all(np.isfinite(model.Xi))) and all(
                np.isfinite(c[0][f"{ch}_std"]) for c in cm.values()
                for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"))
            log(f"  {name}: {len(cm)} case(s) x {model.nw} bins in "
                f"{wall:.2f} s (statics {model.timings['statics']:.2f} s, "
                f"dynamics {model.timings['dynamics']:.2f} s, outputs "
                f"{model.timings['outputs']:.2f} s, journal "
                f"{model.timings['journal']:.3f} s); last dispatch {disp}")
            log(f"    surge std per case: "
                f"{[round(float(c[0]['surge_std']), 6) for c in cm.values()]}, "
                f"statics iters {[model._case_records[str(i)]['statics_iters'] for i in cm]}, "
                f"drag iters {[model._case_records[str(i)]['fowt0']['drag_iters'] for i in cm]}")
            if not finite:
                fail(f"{name}: non-finite outputs")
            if disp.get("backend") != "cuda_gj" or disp.get("kernel") != "gj_solve":
                fail(f"{name}: last dispatch {disp} does not name the CUDA kernel")
            per_design[name] = dict(wall_s=wall, timings=dict(model.timings),
                                    ncases=len(cm), nw=model.nw)
    return per_design


def _allclose(a, b, rtol, atol=1e-12) -> bool:
    return bool(torch.all(torch.abs(a - b) <= atol + rtol * torch.abs(b)))


def device_busy(fn):
    """Run ``fn`` once under torch.profiler (CPU + CUDA activity) and
    return its wall (sync, profiler on), the summed self device time of
    every kernel, the busy share (device / wall), the six kernels with
    the most device time and the device time and launches of each of the
    port's kernels (KERNEL_NAMES) that ran; None where the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    except (RuntimeError, AttributeError):
        return None
    dev_us, top, ours = 0.0, [], {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            dev_us += t
            top.append((t / 1e3, ev.count, ev.key[:70]))
            for key, names in KERNEL_NAMES.items():
                if any(sub in ev.key for sub in names):
                    ms, n = ours.get(key, (0.0, 0))
                    ours[key] = (ms + t / 1e3, n + ev.count)
    if dev_us <= 0:
        return None
    top.sort(reverse=True)
    return dict(wall_s=wall, device_s=dev_us / 1e6,
                busy_share=dev_us / 1e6 / wall,
                top=[dict(ms=t, count=c, kernel=k) for t, c, k in top[:6]],
                ours={k: dict(ms=ms, count=n) for k, (ms, n) in ours.items()})


def sweep_inputs(nc=SWEEP_CASES):
    """Phase 5's seeded sea states (Hs 1-12 m, Tp 4-18 s, 0-360 deg)."""
    rng = np.random.default_rng(2026)
    Hs = 1.0 + 11.0 * rng.random(nc)
    Tp = 4.0 + 14.0 * rng.random(nc)
    beta = np.deg2rad(360.0 * rng.random(nc))
    return Hs, Tp, beta


def run_sweeps(dev):
    """sweep_cases on OC3spar, 1024 seeded cases, in f64 and mixed."""
    from raft_tpu_torch import _config
    from raft_tpu_torch.parallel.sweep import (
        design_fowt, make_case_solver, sweep_cases)

    nc = SWEEP_CASES
    Hs, Tp, beta = sweep_inputs(nc)
    t0 = time.perf_counter()
    fowt = design_fowt("OC3spar", dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # a small sweep first: the one-time CUDA library and allocator set-up
    # of the sweep's operators is not the sweep's wall
    t0 = time.perf_counter()
    sweep_cases(fowt, Hs[:8], Tp[:8], beta[:8], nIter=10, tol=0.01)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    res = {"ncases": nc, "nw": fowt.nw, "build_s": build_s,
           "warmup_8_cases_s": warm_s}
    log(f"  sweep set-up: OC3spar build {build_s:.2f} s, 8-case warm-up "
        f"{warm_s:.2f} s")
    outs = {}
    for mode, expect in (("f64", "impedance_gj"),
                         ("mixed", "impedance_gj_mixed")):
        _config.set_precision_mode(mode)
        try:
            torch.cuda.reset_peak_memory_stats()
            with counted(f"sweep_{mode}", (expect,)):
                t0 = time.perf_counter()
                out = sweep_cases(fowt, Hs, Tp, beta, nIter=10, tol=0.01)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            _config.set_precision_mode(None)
        iters = out["iters"].cpu().numpy()
        hist = np.bincount(iters, minlength=11).tolist()
        conv = int(out["converged"].sum())
        finite = bool(torch.all(torch.isfinite(out["std"])))
        res[mode] = dict(wall_s=wall, fp_chunks=out["fp_chunks"],
                         iters_hist=hist, converged=conv,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=PATH_LAUNCHES[f"sweep_{mode}"])
        log(f"  sweep {mode}: {nc} cases x {fowt.nw} bins in {wall:.3f} s "
            f"(sync); fp_chunks {out['fp_chunks']}; iters histogram "
            f"{hist}; converged {conv}/{nc}; peak "
            f"{res[mode]['peak_gib']:.2f} GiB")
        if not finite or out["std"].shape != (nc, 6):
            fail(f"sweep {mode}: non-finite or misshapen std")
        outs[mode] = out
        SWEEP_OUTS[mode] = {k: out[k] for k in ("Xi", "std", "iters",
                                                  "converged")}
    # 8 lanes against the serial per-case solve
    solver = make_case_solver(fowt, nIter=10, tol=0.01)
    worst = 0.0
    for i in range(SWEEP_SERIAL_LANES):
        ref = solver(float(Hs[i]), float(Tp[i]), float(beta[i]))
        for key in ("Xi", "std"):
            a, b = outs["f64"][key][i], ref[key]
            worst = max(worst, float(torch.max(torch.abs(a - b)
                                               / (torch.abs(b) + 1e-12))))
            if not _allclose(a, b, SWEEP_RTOL):
                fail(f"sweep lane {i} {key} differs from the serial solve")
    # mixed against f64
    f, m = outs["f64"], outs["mixed"]
    std_rel = float(torch.max(torch.abs(m["std"] - f["std"])
                              / torch.abs(f["std"]).clamp(min=1e-300)))
    same_iters = bool(torch.equal(m["iters"], f["iters"]))
    same_conv = bool(torch.equal(m["converged"], f["converged"]))
    log(f"  sweep checks: serial vs batched worst rel {worst:.2e} over "
        f"{SWEEP_SERIAL_LANES} lanes; mixed vs f64 std rel {std_rel:.2e}, "
        f"iters equal {same_iters}, converged equal {same_conv}")
    if std_rel > MIXED_STD_RTOL or not same_iters or not same_conv:
        fail(f"sweep mixed vs f64: std rel {std_rel:.2e}, iters equal "
             f"{same_iters}, converged equal {same_conv}")
    res.update(serial_worst_rel=worst, mixed_std_rel=std_rel,
               mixed_iters_equal=same_iters, mixed_converged_equal=same_conv)
    # where the f64 sweep's time goes: one more run under the profiler
    prof = device_busy(lambda: sweep_cases(fowt, Hs, Tp, beta, nIter=10,
                                           tol=0.01))
    res["f64_profile"] = prof
    if prof is None:
        log("  sweep profile: the profiler saw no device time")
    else:
        log(f"  sweep profile (f64, profiler on): wall {prof['wall_s']:.3f} s, "
            f"kernels {prof['device_s']:.3f} s, device busy share "
            f"{prof['busy_share']:.3f}; top: "
            + "; ".join(f"{t['kernel']} {t['ms']:.2f} ms x{t['count']}"
                        for t in prof["top"])
            + "; the port's kernels: "
            + "; ".join(f"{k} {v['ms']:.3f} ms x{v['count']}"
                        for k, v in prof["ours"].items()))
    return res


def run_variants(dev):
    """sweep_variants on VolturnUS-S over volturn_grid's 243 variants."""
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.parallel import variants as vr
    from raft_tpu_torch.parallel.sweep import design_fowt

    design = load_design("VolturnUS-S")
    thetas, meta = vr.volturn_grid(design)
    nv = len(meta["grid"])
    base = design_fowt(design, dev)
    kw = dict(Hs=6.0, Tp=12.0, ballast=True, nIter=10, newton_iters=20)
    torch.cuda.reset_peak_memory_stats()
    with counted("variants", ("impedance_gj",)):
        t0 = time.perf_counter()
        out = vr.sweep_variants(base, thetas, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finite = all(bool(torch.all(torch.isfinite(out[k]))) for k in
                 ("mass", "displacement", "GMT", "offset", "pitch_deg",
                  "Xeq", "std"))
    heave = float(torch.max(torch.abs(out["Xeq"][:, 2])))
    res = dict(nvariants=nv, nw=base.nw, wall_s=wall,
               timings=out["timings"], fp_chunks=out["fp_chunks"],
               iters_hist=np.bincount(out["iters"].cpu().numpy(),
                                      minlength=12).tolist(),
               converged=int(out["converged"].sum()), heave_max=heave,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=PATH_LAUNCHES["variants"])
    log(f"  variants: {nv} x {base.nw} bins in {wall:.2f} s (setup "
        f"{out['timings']['setup']:.2f} s, fixed point "
        f"{out['timings']['fixed_point']:.3f} s); fp_chunks "
        f"{out['fp_chunks']}; converged {res['converged']}/{nv}; max "
        f"|heave| {heave:.2e} m; peak {res['peak_gib']:.2f} GiB")
    if not finite:
        fail("variants: non-finite outputs")
    if heave >= 0.05:
        fail(f"variants: max |heave of Xeq| {heave:.3e} >= 0.05 after the trim")
    solver = vr.make_variant_solver(base, **kw)
    worst = 0.0
    idx = np.linspace(0, nv - 1, VARIANT_SERIAL).astype(int)
    for i in idx:
        ref = solver({k: v[i] for k, v in thetas.items()})
        for key in ("mass", "offset", "pitch_deg", "Xeq", "std", "Xi"):
            a, b = out[key][i], ref[key]
            worst = max(worst, float(torch.max(torch.abs(a - b)
                                               / (torch.abs(b) + 1e-12))))
            if not _allclose(a, b, SWEEP_RTOL):
                fail(f"variant {i} {key} differs from the serial solve")
    log(f"  variants check: {VARIANT_SERIAL} variants vs serial, worst rel "
        f"{worst:.2e}")
    res["serial_worst_rel"] = worst
    return res


def _golden_check(name, live, fname, mode="f64"):
    """Diff a ledger against tests/golden/<fname> as phase 7 does; fail on
    a blocking regression, an added or removed metric or an iteration
    count that differs.  Returns the record."""
    from raft_tpu_torch import ledger

    gold = ledger.load_ledger(os.path.join(ROOT, "tests", "golden", fname))
    rep = ledger.diff(gold, live, tol_rel=GOLDEN_TOL,
                      per_metric={"*_residual*": GOLDEN_RESID_TOL})
    worst = max((r["rel"] for r in rep["regressions"]), default=0.0)
    log(f"  [{mode}] " + ledger.format_diff(rep))
    blocking = ledger.blocking_regressions(rep)
    gm = {e["key"]: e["metrics"] for e in gold["entries"]}
    lm = {e["key"]: e["metrics"] for e in live["entries"]}
    iters_ok = all(
        lm[key][it] == gm[key][it] for key in gm
        for it in ("statics_iters", "drag_iters", "drag_converged")
        if it in gm[key])
    if blocking or rep["added"] or rep["removed"] or not iters_ok:
        fail(f"golden {name} ({mode}) regressed: {blocking}, "
             f"iteration counts equal {iters_ok}")
    return dict(ok=not blocking and iters_ok, n_compared=rep["n_compared"],
                worst_rel=worst)


def run_goldens(dev, mode="f64"):
    from raft_tpu_torch import Model, _config
    from raft_tpu_torch.io.designs import load_design

    out = {}
    expect = ("impedance_gj_mixed", "gj_solve_mixed") if mode == "mixed" \
        else ("impedance_gj", "gj_solve")
    _config.set_precision_mode(mode)
    try:
        with counted(f"golden_{mode}", expect):
            for name, fname in (("OC3spar", "oc3spar_coarse.ledger.json"),
                                ("VolturnUS-S", "volturnus_coarse.ledger.json")):
                d = load_design(name)
                d["settings"].update(min_freq=0.02, max_freq=0.2)
                d["cases"]["data"] = d["cases"]["data"][:1]
                m = Model(d, device=dev)
                m.analyzeCases()
                out[name] = _golden_check(name, m.last_ledger, fname, mode)
    finally:
        _config.set_precision_mode(None)
    return out


def run_qtf(dev):
    """The second-order path: run_raft on examples/example_qtf.py's
    configuration against its golden (1 K5 launch), then Vertical_cylinder
    with two headings (2 K5 launches)."""
    from raft_tpu_torch import Model, run_raft
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.models import qtf_cases as QC

    out = {}
    expect = ("impedance_gj", "gj_solve", "qtf_pair")
    with counted("qtf", expect):
        t0 = time.perf_counter()
        model = run_raft(QC.oc4semi_design(), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c0 = model.results["case_metrics"][0][0]
    out["oc4semi"] = dict(
        wall_s=wall, timings=dict(model.timings), nw=model.nw,
        nw2=len(model.fowtList[0].w1_2nd), surge_std=c0["surge_std"],
        surge_avg=c0["surge_avg"], launches=PATH_LAUNCHES["qtf"],
        golden=_golden_check("OC4semi qtf", model.last_ledger,
                             "oc4semi_qtf.ledger.json"))
    log(f"  OC4semi potSecOrder 1: {model.nw} x {out['oc4semi']['nw2']} bins"
        f" in {wall:.2f} s; split " + ", ".join(
            f"{k} {v:.3f} s" for k, v in model.timings.items())
        + f"; surge std {c0['surge_std']:.6f} m, mean {c0['surge_avg']:.6f} m")
    if PATH_LAUNCHES["qtf"].get("qtf_pair") != 1:
        fail(f"qtf: K5 launched {PATH_LAUNCHES['qtf'].get('qtf_pair')} "
             "times on the OC4semi example, not 1")

    d = QC.cylinder_two_headings(load_design("Vertical_cylinder"))
    with counted("qtf_2heading", expect):
        t0 = time.perf_counter()
        m = Model(d, device=dev)
        m.analyzeCases()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finite = bool(np.all(np.isfinite(m.Xi))) and all(
        np.isfinite(m.results["case_metrics"][0][0][f"{ch}_std"])
        for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"))
    out["two_headings"] = dict(wall_s=wall, timings=dict(m.timings),
                               launches=PATH_LAUNCHES["qtf_2heading"],
                               finite=finite)
    log(f"  Vertical_cylinder, 2 headings: {wall:.2f} s, finite {finite}")
    if not finite:
        fail("qtf 2 headings: non-finite outputs")
    if PATH_LAUNCHES["qtf_2heading"].get("qtf_pair") != 2:
        fail(f"qtf 2 headings: K5 launched "
             f"{PATH_LAUNCHES['qtf_2heading'].get('qtf_pair')} times, not 2")
    return out


def sweep_pair(label, path, fowt, Hs, Tp, beta, nIter, serial_lanes, dev):
    """sweep_cases on ``fowt`` in f64 and under RAFT_TPU_PRECISION=mixed,
    each between the launch counters (paths ``<path>_f64`` and
    ``<path>_mixed``), every std finite; ``serial_lanes`` lanes of the
    f64 sweep against the serial solve (rtol 1e-9); mixed against f64 as
    in phase 5 (std 1e-6, iterations and convergence equal).  Returns
    ({mode: wall, converged, fp_chunks, launches}, the checks)."""
    from raft_tpu_torch import _config
    from raft_tpu_torch.parallel.sweep import make_case_solver, sweep_cases

    nc = len(Hs)
    sweeps, recs = {}, {}
    for mode, kind in (("f64", "impedance_gj"),
                       ("mixed", "impedance_gj_mixed")):
        _config.set_precision_mode(mode)
        try:
            with counted(f"{path}_{mode}", (kind,)):
                t0 = time.perf_counter()
                sw = sweep_cases(fowt, Hs, Tp, beta, nIter=nIter, tol=0.01,
                                 device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            _config.set_precision_mode(None)
        sweeps[mode] = sw
        conv = int(sw["converged"].sum())
        finite = bool(torch.all(torch.isfinite(sw["std"])))
        recs[mode] = dict(wall_s=wall, converged=conv,
                          fp_chunks=sw["fp_chunks"],
                          launches=PATH_LAUNCHES[f"{path}_{mode}"])
        log(f"  {label} {mode}: {nc} cases x {fowt.nw} bins in "
            f"{wall:.3f} s; converged {conv}/{nc}; launches "
            f"{recs[mode]['launches']}")
        if not finite or sw["std"].shape != (nc, 6):
            fail(f"{label} {mode}: non-finite or misshapen std")
    solver = make_case_solver(fowt, nIter=nIter, tol=0.01)
    worst = 0.0
    for i in range(serial_lanes):
        ref_i = solver(float(Hs[i]), float(Tp[i]), float(beta[i]))
        a, b = sweeps["f64"]["Xi"][i], ref_i["Xi"]
        worst = max(worst, float(torch.max(torch.abs(a - b))
                                 / torch.max(torch.abs(b))))
        if not _allclose(a, b, SWEEP_RTOL,
                         atol=1e-12 * float(torch.max(torch.abs(b)))):
            fail(f"{label} lane {i} differs from the serial solve")
    f, mx = sweeps["f64"], sweeps["mixed"]
    std_rel = float(torch.max(torch.abs(mx["std"] - f["std"])
                              / torch.abs(f["std"]).clamp(min=1e-300)))
    same_iters = bool(torch.equal(mx["iters"], f["iters"]))
    same_conv = bool(torch.equal(mx["converged"], f["converged"]))
    log(f"  {label} checks: {serial_lanes} lanes vs serial worst rel "
        f"{worst:.2e}; mixed vs f64 std rel {std_rel:.2e}, iters equal "
        f"{same_iters}, converged equal {same_conv}")
    if std_rel > MIXED_STD_RTOL or not same_iters or not same_conv:
        fail(f"{label} mixed vs f64: std rel {std_rel:.2e}, iters "
             f"equal {same_iters}, converged equal {same_conv}")
    return recs, dict(serial_worst_rel=worst, mixed_std_rel=std_rel,
                      mixed_iters_equal=same_iters,
                      mixed_converged_equal=same_conv)


# ---------------------------------------------------------------------------
# phase 9: first-order potential flow
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_bem_solve(what):
    """Inside: a native BEM solve fails the run instead of running (a
    build that should hit the committed cache, where a miss would mean
    minutes of host solve)."""
    from raft_tpu_torch import errors
    from raft_tpu_torch.io import bem_native

    real = bem_native.solve_radiation_diffraction

    def refuse(*a, **k):
        raise errors.KernelFailure(f"{what}: the committed WAMIT cache "
                                   "missed (mesher or cache key drift)",
                                   kernel="bem_native")
    bem_native.solve_radiation_diffraction = refuse
    try:
        yield
    finally:
        bem_native.solve_radiation_diffraction = real


def _iters(led):
    return {(e["key"], it): e["metrics"][it] for e in led["entries"]
            for it in ("statics_iters", "drag_iters", "drag_converged")
            if it in e["metrics"]}


def _operand_row(G, w, M, B, C, F, case, key, **extra):
    """K1 at one path's own operands: the kernel against its plain
    version on the same systems and the normwise residual, held at
    X_TOL / RESID_TOL, then timed like the phase 3 rows (the library's
    torch.linalg.solve on the systems broadcast to every lane) with its
    bound; stored as ROWS[key] and logged.  ``extra`` goes into the
    row."""
    n = 6
    X = G.impedance_gj_solve(w, M, B, C, F)
    Xp = G.impedance_gj_solve_plain(w, M, B, C, F)
    torch.cuda.synchronize()
    rel = _rel(X, Xp)
    lanes = F.shape[0] * F.shape[-1]
    row = dict(lanes=lanes, case=case, rel_vs_plain=rel, rel_ill=None,
               max_abs_err=float(torch.max(torch.abs(X - Xp))), **extra,
               shapes=dict(M=list(M.shape), B=list(B.shape),
                           C=list(C.shape), F=list(F.shape)))
    Z = (-(w ** 2) * M + 1j * w * B + C[..., None]).movedim(-1, -3)
    Fz = F.movedim(-1, -2)[..., None]
    row["normwise_residual"] = _normwise_residual(
        Z, X.movedim(-1, -2)[..., None], Fz)
    if not (rel <= X_TOL and row["normwise_residual"] <= RESID_TOL
            and bool(torch.all(torch.isfinite(X)))):
        fail(f"impedance_gj {case} lanes={lanes}: rel={rel:.3e}, "
             f"residual {row['normwise_residual']:.2e}")
    Zb = torch.broadcast_to(Z, tuple(Fz.shape[:-2]) + (n, n))
    _time_row(row, lambda: G.impedance_gj_solve(w, M, B, C, F),
              lambda: G.impedance_gj_solve_plain(w, M, B, C, F),
              lambda: torch.linalg.solve(Zb, Fz), KERNEL_NAMES["impedance_gj"])
    row["bound_ms"], row["bound_by"] = bound(
        nbytes(w, M, B, C, F, X), lanes * (gj_flops(2 * n, 1) + 8 * n * n))
    ROWS[key] = [row]
    _log_row("impedance_gj", row)
    return row


def check_impedance_bem(G, fowt):
    """K1 at the BEM sweep's operands: M(w) = M_struc + A_morison +
    A_BEM(w) and B(w) = B_BEM(w), both (6, 6, 80) and shared by 1024
    cases, C shared, F (1024, 6, 80) the cases' wave excitation, from the
    sweep's own set-up."""
    from raft_tpu_torch._config import as_real
    from raft_tpu_torch.parallel.sweep import make_case_solver

    rng = np.random.default_rng(7)
    nc = SWEEP_CASES
    w = as_real(fowt.w)
    st = make_case_solver(fowt).setup(
        as_real(1.0 + 11.0 * rng.random(nc), w.device),
        as_real(4.0 + 14.0 * rng.random(nc), w.device),
        as_real(np.deg2rad(360.0 * rng.random(nc)), w.device))
    M, B, C, F = st["M_lin"], st["B_BEM"], st["C_lin"], st["F_lin"]
    varies = float(torch.max(torch.abs(M - M[..., :1])))
    if not varies > 0:
        fail(f"impedance_gj bem_operands: M does not vary with the "
             f"frequency (max|M - M[..., :1]| {varies})")
    row = _operand_row(G, w, M, B, C, F, "bem_operands", "impedance_gj_bem",
                       M_variation=varies)
    # the same systems with M and B materialised once, outside the call:
    # the kernel's device time without the wrapper's fresh 47 MB copy of
    # them just ahead of it (ROADMAP B2)
    Mc, Bc = (torch.broadcast_to(t, (nc,) + tuple(t.shape)).contiguous()
              for t in (M, B))
    row["device_ms_materialised"] = device_ms(
        lambda: G.impedance_gj_solve(w, Mc, Bc, C, F),
        KERNEL_NAMES["impedance_gj"])
    log(f"  impedance_gj             bem_operands, M and B materialised "
        f"outside the call: device {row['device_ms_materialised']} ms")
    return row


def run_potflow(dev):
    """The potential-flow phase: (e) the spar's preprocess_BEM solved on
    the host, then OC4semi at full width from the committed cache: (a)
    the native-BEM model, (b) from its files, (c) with the QTF, (d) the
    BEM sweep in f64 and mixed, and K1 at the sweep's operands."""
    from raft_tpu_torch import Model, ledger
    from raft_tpu_torch.io import bem_native
    from raft_tpu_torch.models import potflow_cases as PC
    from raft_tpu_torch.ops.kernels import gj_solve as G

    golden = os.path.join(ROOT, "tests", "golden")
    work = os.path.join(OUT, "potflow")
    shutil.rmtree(work, ignore_errors=True)
    cache = os.path.join(work, "oc4semi")
    shutil.copytree(os.path.join(golden, "oc4semi_bem"), cache)
    spar_ref = os.path.join(golden, "bem_spar_preprocess")
    out = {}
    expect = ("impedance_gj", "gj_solve")

    # (e) the spar's custom-grid export, solved on the host; its build
    # reads the JAX package's files for this call (potModMaster 3), so
    # the only solve is the export's
    shutil.copytree(spar_ref, os.path.join(work, "spar_in"))
    export = os.path.join(work, "spar_export")
    t0 = time.perf_counter()
    bem_native.load()           # g++ builds the library here, not in the solve
    out["bem_build"] = dict(seconds=time.perf_counter() - t0,
                            **bem_native.BUILD_INFO)
    log(f"  native BEM library: {out['bem_build']}")
    with counted("potflow_preprocess", ()):
        m = Model(PC.spar_design(hydro_path=os.path.join(work, "spar_in",
                                                         "Output")),
                  device=dev)
        bem_native.LAST_SOLVE.clear()
        t0 = time.perf_counter()
        m.preprocess_BEM(mesh_dir=export, **PC.PREPROCESS)
        wall = time.perf_counter() - t0
    rel, key_ok = PC.wamit_deviation(spar_ref, export)
    solve = dict(bem_native.LAST_SOLVE)
    out["preprocess"] = dict(wall_s=wall, solve=solve, rel_vs_jax=rel,
                             key_equal=key_ok)
    log(f"  (e) spar preprocess_BEM: {wall:.2f} s ({solve}); files vs the "
        f"JAX package's: worst rel {rel:.2e}, cache key equal {key_ok}")
    if not solve or rel > BEM_FILES_TOL or not key_ok:
        fail(f"(e) preprocess_BEM: rel {rel:.2e} vs the JAX package's "
             f"files, key equal {key_ok}, solve {solve}")

    def analyzed(path, design, kinds=expect):
        with counted(path, kinds):
            t0 = time.perf_counter()
            with no_bem_solve(path):
                m = Model(design, device=dev)
            m.analyzeUnloaded()
            m.analyzeCases()
            torch.cuda.synchronize()
        return m, time.perf_counter() - t0

    def case_line(m):
        c = m.results["case_metrics"][0][0]
        return ", ".join(f"{ch} std {float(c[f'{ch}_std']):.6f}"
                         for ch in ("surge", "heave", "pitch"))

    # (a) the native-BEM model on the cache
    ma, wall = analyzed("potflow_bem", PC.oc4semi_bem_design(cache))
    out["oc4semi_bem"] = dict(
        wall_s=wall, timings=dict(ma.timings),
        launches=PATH_LAUNCHES["potflow_bem"],
        golden=_golden_check("OC4semi BEM", ma.last_ledger,
                             "oc4semi_bem.ledger.json"))
    log(f"  (a) OC4semi native BEM, {ma.nw} bins: {wall:.2f} s; split "
        + ", ".join(f"{k} {v:.3f} s" for k, v in ma.timings.items())
        + f"; {case_line(ma)}")

    # (b) the same from the cache's files
    mb, wall = analyzed("potflow_wamit",
                        PC.oc4semi_wamit_design(os.path.join(cache,
                                                             "Output")))
    rep = ledger.diff(ma.last_ledger, mb.last_ledger,
                      tol_rel=WAMIT_RERUN_TOL, per_metric={"*": WAMIT_RERUN_TOL})
    same_iters = _iters(ma.last_ledger) == _iters(mb.last_ledger)
    out["oc4semi_wamit"] = dict(wall_s=wall, timings=dict(mb.timings),
                                launches=PATH_LAUNCHES["potflow_wamit"],
                                identical=rep["identical"],
                                n_compared=rep["n_compared"],
                                regressions=len(rep["regressions"]),
                                iters_equal=same_iters)
    log(f"  (b) OC4semi from its WAMIT files (potModMaster 3): {wall:.2f} s; "
        + ledger.format_diff(rep).replace("\n", ";")
        + f"; iteration counts equal {same_iters}")
    if not rep["ok"] or not same_iters:
        fail("(b) OC4semi from its WAMIT files differs from (a)")

    # (c) with the second-order QTF: held by its physics record
    mc, wall = analyzed("potflow_qtf", PC.oc4semi_bem_qtf_design(cache),
                        kinds=expect + ("qtf_pair",))
    with open(os.path.join(golden, "oc4semi_bem_qtf.metrics.json")) as f:
        ref = json.load(f)
    live = PC.metrics_record(mc.results, mc.last_ledger)
    rel, iters_ok = PC.metrics_deviation(ref, live)
    res = dict(port=live["statics_residual"], jax_host=ref["statics_residual"],
               jax_default=ref["statics_residual_default"])
    # where the port's residual falls in the ledger's 0.5 residual band
    # against each JAX backend's (reported, not held: ROADMAP C7)
    for b in ("jax_host", "jax_default"):
        res[f"band_rel_{b}"] = abs(res["port"] - res[b]) / max(res["port"],
                                                               res[b])
    out["oc4semi_bem_qtf"] = dict(
        wall_s=wall, timings=dict(mc.timings), nw2=len(mc.fowtList[0].w1_2nd),
        launches=PATH_LAUNCHES["potflow_qtf"], metrics_max_rel=rel,
        iters=live["iters"], iters_equal=iters_ok, statics_residual=res)
    log(f"  (c) OC4semi native BEM + potSecOrder 1: {wall:.2f} s; split "
        + ", ".join(f"{k} {v:.3f} s" for k, v in mc.timings.items())
        + f"; {case_line(mc)}; metrics vs the JAX package worst rel "
        f"{rel:.2e}, iters {live['iters']} equal {iters_ok}; "
        f"statics_residual {res}")
    if rel > PC.METRICS_TOL or not iters_ok:
        fail(f"(c) OC4semi BEM + QTF: metrics rel {rel:.2e}, iteration "
             f"counts equal {iters_ok}")
    if PATH_LAUNCHES["potflow_qtf"].get("qtf_pair") != 1:
        fail(f"(c): K5 launched {PATH_LAUNCHES['potflow_qtf'].get('qtf_pair')}"
             " times, not 1")

    # (d) the BEM sweep: A(w) and B(w) shared by the cases
    fowt = ma.fowtList[0]
    rng = np.random.default_rng(2026)
    nc = SWEEP_CASES
    Hs = 1.0 + 11.0 * rng.random(nc)
    Tp = 4.0 + 14.0 * rng.random(nc)
    beta = np.deg2rad(360.0 * rng.random(nc))
    recs, out["sweep_checks"] = sweep_pair(
        "(d) BEM sweep", "potflow_sweep", fowt, Hs, Tp, beta, 10,
        BEM_SERIAL_LANES, dev)
    for mode, rec in recs.items():
        out[f"sweep_{mode}"] = rec

    out["k1_bem_row"] = check_impedance_bem(G, fowt)
    return out


# ---------------------------------------------------------------------------
# phase 10: submerged rotors (MHK) and the general single-body mooring
# ---------------------------------------------------------------------------

MHK_SWEEP_CASES = 256   # x 400 bins = 102,400 lanes per K1 launch
MHK_SERIAL_LANES = 4


def _held_golden(name, m, stem, ledger_stems=None, gdir=None):
    """A phase 10, 12 or 13 model against its full-width goldens (in
    ``gdir``, by default tests/golden): the physics
    record (every case's metrics at 1e-6, the iteration counts exact),
    the statics residual one-sided (at most ``mhk_cases.RESIDUAL_FACTOR``
    times the larger JAX backend's), and where the model has one
    (``ledger_stems``, by default ``mhk_cases.LEDGER_STEMS``) the ledger
    golden at the golden bars.  The residual sits at the rounding floor,
    where the ledger's 0.5 band decides by rounding (ROADMAP C7): its
    band verdict is printed."""
    from raft_tpu_torch import ledger
    from raft_tpu_torch.models import mhk_cases as MC

    if ledger_stems is None:
        ledger_stems = MC.LEDGER_STEMS
    gdir = gdir or os.path.join(ROOT, "tests", "golden")
    with open(MC.golden_file(gdir, stem, coarse=False)) as f:
        ref = json.load(f)
    live = MC.case_records(m.results, m.last_ledger)
    rel, same = MC.case_records_deviation(ref, live)
    ratio, held = MC.residual_held(ref, live)
    res = dict(port=[c["statics_residual"] for c in live["cases"]],
               jax_host=[c["statics_residual"] for c in ref["cases"]],
               jax_default=ref["statics_residual_default"],
               ratio_to_larger_jax=ratio)
    log(f"  [{name}] physics record vs the JAX package: worst rel "
        f"{rel:.2e}, iteration counts equal {same}; statics_residual {res}")
    rec = dict(worst_rel=rel, iters_equal=same, statics_residual=res)
    if rel > GOLDEN_TOL or not same:
        fail(f"{name}: physics record rel {rel:.2e}, iteration counts "
             f"equal {same}")
    if not held:
        fail(f"{name}: statics_residual {ratio:.3g} x the JAX package's, "
             f"above {MC.RESIDUAL_FACTOR}")
    if stem in ledger_stems:
        chk = MC.ledger_golden_check(
            ledger.load_ledger(MC.ledger_golden_file(gdir, stem, False)),
            m.last_ledger, tol=GOLDEN_TOL, resid_tol=GOLDEN_RESID_TOL)
        log(f"  [{name}] ledger golden: "
            + ledger.format_diff(chk["report"]))
        rec["ledger"] = dict(
            n_compared=chk["report"]["n_compared"],
            iters_equal=chk["iters_ok"],
            statics_residual_band=[dict(entry=r["entry"], rel=r["rel"])
                                   for r in chk["floor"]])
        if chk["blocking"] or not chk["iters_ok"]:
            fail(f"{name}: ledger golden regressed: {chk['blocking']}, "
                 f"iteration counts equal {chk['iters_ok']}")
    return rec


def _within(name, live, ref):
    """max|live - ref| within the build record's 1e-9 of max|ref|
    (arrays)."""
    from raft_tpu_torch.models.mhk_cases import RECORD_TOL as tol

    live, ref = np.asarray(live, float), np.asarray(ref, float)
    rel = float(np.max(np.abs(live - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))
    if live.shape != ref.shape or not rel <= tol:
        fail(f"{name}: rel {rel:.2e} (shapes {live.shape} {ref.shape})")
    return rel


def run_mhk(dev):
    """Phase 10: RM1_Floating (m1) and FOCTT_example's converging case
    (m2b) through run_raft at full width, FOCTT's build and shipped-case
    constants (m2a), its shipped case's analyzeCases run to the end,
    OC3spar with clump weights on its lines (m3), and a 256-case sweep on
    RM1's FOWT."""
    import warnings

    from raft_tpu_torch import Model, run_raft
    from raft_tpu_torch.models import fowt as TF
    from raft_tpu_torch.models import mhk_cases as MC
    from raft_tpu_torch.models import rotor as TR
    from raft_tpu_torch.parallel.sweep import make_case_solver, sweep_cases

    warnings.filterwarnings("ignore", message="Cavitation")
    golden = os.path.join(ROOT, "tests", "golden")

    def gold(name):
        with open(os.path.join(golden, name)) as f:
            return json.load(f)

    out = {}
    expect = ("impedance_gj", "gj_solve")

    def raft(path, design, unloaded=True):
        """run_raft on the card (``unloaded=False``: Model ->
        analyzeCases, no unloaded statics), its K1/K2 launches exact: K1
        once per drag pass of every case, K2 once per case."""
        with counted(path, expect):
            t0 = time.perf_counter()
            if unloaded:
                m = run_raft(design, device=dev)
            else:
                m = Model(design, device=dev)
                m.analyzeCases()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        recs = m._case_records
        ncases = len(m.results["case_metrics"])
        k1 = sum(recs[str(i)]["fowt0"]["drag_iters"] for i in range(ncases))
        got = PATH_LAUNCHES[path]
        if got.get("impedance_gj") != k1 or got.get("gj_solve") != ncases:
            fail(f"{path}: launches {got}, expected K1 {k1} (one per drag "
                 f"pass), K2 {ncases} (one per case)")
        stats = [dict(statics_iters=recs[str(i)]["statics_iters"],
                      statics_residual=recs[str(i)]["statics_residual"],
                      drag_iters=recs[str(i)]["fowt0"]["drag_iters"])
                 for i in range(ncases)]
        finite = all(np.isfinite(c[0][f"{ch}_std"])
                     for c in m.results["case_metrics"].values()
                     for ch in ("surge", "sway", "heave", "roll", "pitch",
                                "yaw")) and bool(np.all(np.isfinite(m.Xi)))
        if not finite:
            fail(f"{path}: non-finite outputs")
        # the rest of the wall: the build, analyzeUnloaded and
        # calcOutputs (Model.timings covers analyzeCases)
        rest = wall - sum(m.timings.values())
        log(f"  {path}: {ncases} case(s) x {m.nw} bins in {wall:.2f} s; "
            "split " + ", ".join(f"{k} {v:.3f} s"
                                 for k, v in m.timings.items())
            + f", build + unloaded statics + calcOutputs {rest:.3f} s; "
            f"per case {stats}")
        out[path] = dict(wall_s=wall, timings=dict(m.timings), nw=m.nw,
                         build_unloaded_outputs_s=rest, ncases=ncases,
                         launches=got, cases=stats)
        return m

    # (m1) RM1 as shipped plus its JONSWAP case
    m1 = raft("mhk_rm1", MC.rm1_design())
    out["mhk_rm1"]["golden"] = _held_golden("RM1_Floating", m1,
                                            "rm1_floating")
    cav_ref = gold("rm1_cavitation.json")["default"]
    for ic in range(2):
        out["mhk_rm1"][f"cavitation_rel_case{ic}"] = _within(
            f"m1 cavitation case {ic}",
            m1.results["case_metrics"][ic][0]["cavitation"][0], cav_ref)
    wave = m1.results["case_metrics"][1][0]
    stds = {ch: float(wave[f"{ch}_std"]) for ch in ("surge", "heave",
                                                     "pitch")}
    out["mhk_rm1"]["wave_case_std"] = stds
    log(f"  m1 wave case std {stds}; cavitation vs the JAX package "
        f"{out['mhk_rm1']['cavitation_rel_case0']:.2e}")
    if not all(v > 0 for v in stds.values()):
        fail(f"m1: the wave case has a zero std: {stds}")

    # (m2a) FOCTT's build and its shipped case's constants, on the card
    d = MC.foctt_design()
    s = d["settings"]
    w = np.arange(s["min_freq"], s["max_freq"] + 0.5 * s["min_freq"],
                  s["min_freq"]) * 2 * np.pi
    t0 = time.perf_counter()
    fowt = TF.build_fowt(d, w, depth=float(d["site"]["water_depth"]),
                         device=dev)
    case = dict(zip(d["cases"]["keys"], d["cases"]["data"][0]))
    cav = TR.calc_cavitation(fowt.rotors[0], case)
    rec = MC.build_record(fowt, TF, TR, case, cav)
    rel, bad = MC.record_deviation(gold("foctt_build.json"), rec)
    out["mhk_foctt_build"] = dict(wall_s=time.perf_counter() - t0,
                                  worst_rel=rel, differing=bad,
                                  members=len(rec["member_names"]),
                                  blades=rec["member_names"].count("blade"))
    log(f"  m2a FOCTT build + shipped-case constants ({len(w)} bins): "
        f"worst rel {rel:.2e} vs the JAX package, differing {bad}")
    if bad or not rel <= MC.RECORD_TOL:
        fail(f"m2a: build record rel {rel:.2e}, differing {bad}")
    cav_gold = gold("foctt_cavitation.json")
    for which, c in (("shipped", case), ("m2b", dict(
            case, **MC.M2B_CASE))):
        for key, kw in (("default", {}), ("Pvap_3e5", {"Pvap": 3e5})):
            out["mhk_foctt_build"][f"cavitation_{which}_{key}"] = _within(
                f"FOCTT cavitation {which} {key}",
                TR.calc_cavitation(fowt.rotors[0], c, **kw),
                cav_gold[which][key])

    # (m2b) FOCTT's converging case at full width
    m2 = raft("mhk_foctt", MC.foctt_design(**MC.M2B_CASE))
    out["mhk_foctt"]["golden"] = _held_golden("FOCTT m2b", m2,
                                              "foctt_current")
    c0 = m2.results["case_metrics"][0][0]
    out["mhk_foctt"]["omega_avg"] = float(c0["omega_avg"][0])
    if not c0["omega_avg"][0] > 0:
        fail("m2b: the current-driven rotor reports no speed")

    # FOCTT's shipped case: to the end, compared with nothing (C8).  Its
    # unloaded statics, the same 50 capped iterations as m2b's, ran there
    ms = raft("mhk_foctt_shipped", MC.foctt_design(), unloaded=False)
    log(f"  FOCTT shipped case (ROADMAP C8): statics_iters "
        f"{out['mhk_foctt_shipped']['cases'][0]['statics_iters']}, "
        f"statics_residual "
        f"{out['mhk_foctt_shipped']['cases'][0]['statics_residual']:.4e} N, "
        f"mean offsets {np.round(ms.results['mean_offsets'][0], 4).tolist()}")

    # (m3) OC3spar with clump weights on its lines
    m3 = raft("mhk_clump", MC.clump_design(ncases=1))
    out["mhk_clump"]["golden"] = _held_golden("OC3spar clump", m3,
                                              "oc3spar_clump")

    # the 256-case sweep on RM1's FOWT: 102,400 lanes per K1 launch
    fowt1 = m1.fowtList[0]
    rng = np.random.default_rng(2027)
    nc = MHK_SWEEP_CASES
    Hs = 0.5 + 3.5 * rng.random(nc)
    Tp = 4.0 + 10.0 * rng.random(nc)
    beta = np.deg2rad(360.0 * rng.random(nc))
    with counted("mhk_sweep", ("impedance_gj",)):
        t0 = time.perf_counter()
        sw = sweep_cases(fowt1, Hs, Tp, beta, nIter=10, tol=0.01, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    solver = make_case_solver(fowt1, nIter=10, tol=0.01)
    worst = 0.0
    for i in range(MHK_SERIAL_LANES):
        ref_i = solver(float(Hs[i]), float(Tp[i]), float(beta[i]))
        a, b = sw["Xi"][i], ref_i["Xi"]
        worst = max(worst, float(torch.max(torch.abs(a - b))
                                 / torch.max(torch.abs(b))))
        if not _allclose(a, b, SWEEP_RTOL,
                         atol=1e-12 * float(torch.max(torch.abs(b)))):
            fail(f"m1 sweep lane {i} differs from the serial solve")
    conv = int(sw["converged"].sum())
    out["mhk_sweep"] = dict(wall_s=wall, cases=nc, nw=fowt1.nw,
                            lanes=nc * fowt1.nw, converged=conv,
                            fp_chunks=sw["fp_chunks"], serial_worst_rel=worst,
                            launches=PATH_LAUNCHES["mhk_sweep"])
    log(f"  m1 sweep: {nc} cases x {fowt1.nw} bins ({nc * fowt1.nw} lanes "
        f"per K1 launch) in {wall:.3f} s; converged {conv}/{nc}; "
        f"{MHK_SERIAL_LANES} lanes vs serial worst rel {worst:.2e}")
    if not bool(torch.all(torch.isfinite(sw["std"]))):
        fail("m1 sweep: non-finite std")
    return out


# ---------------------------------------------------------------------------
# phase 11: arrays and farms
# ---------------------------------------------------------------------------

FARM_SERIAL_LANES = 4
WAKE_TOL = 1e-12
ARRAY_TOL = 1e-9


def _farm_golden(name, m, stem):
    """A farm run against its full-width goldens (tests/golden/farm/,
    written by tests/golden/farm_golden.py): the physics record (every
    FOWT's metrics, the mean offsets, the array lines' tensions at 1e-6,
    the counts exact), the statics residual one-sided as phase 10 holds
    it, and the ledger golden where the JAX backends agree on one."""
    from raft_tpu_torch import ledger
    from raft_tpu_torch.models import farm_cases as FC
    from raft_tpu_torch.models import mhk_cases as MC

    gdir = os.path.join(ROOT, "tests", "golden", "farm")
    with open(os.path.join(gdir, f"{stem}.metrics.json")) as f:
        ref = json.load(f)
    live = FC.farm_records(m.results, m.last_ledger)
    rel, same = MC.case_records_deviation(ref, live)
    ratio, held = MC.residual_held(ref, live)
    res = dict(port=[c["statics_residual"] for c in live["cases"]],
               jax_host=[c["statics_residual"] for c in ref["cases"]],
               jax_default=ref["statics_residual_default"],
               ratio_to_larger_jax=ratio)
    log(f"  [{name}] physics record vs the JAX package: worst rel "
        f"{rel:.2e}, counts equal {same}; statics_residual {res}")
    rec = dict(worst_rel=rel, iters_equal=same, statics_residual=res,
               record=live)
    if rel > GOLDEN_TOL or not same:
        fail(f"{name}: physics record rel {rel:.2e}, counts equal {same}")
    if not held:
        fail(f"{name}: statics_residual {ratio:.3g} x the JAX package's, "
             f"above {MC.RESIDUAL_FACTOR}")
    if ref["ledger_golden"]:
        chk = MC.ledger_golden_check(
            ledger.load_ledger(os.path.join(gdir, f"{stem}.ledger.json")),
            m.last_ledger, tol=GOLDEN_TOL, resid_tol=GOLDEN_RESID_TOL)
        log(f"  [{name}] ledger golden: " + ledger.format_diff(chk["report"]))
        rec["ledger"] = dict(
            n_compared=chk["report"]["n_compared"],
            iters_equal=chk["iters_ok"],
            statics_residual_band=[dict(entry=r["entry"], rel=r["rel"])
                                   for r in chk["floor"]])
        if chk["blocking"] or not chk["iters_ok"]:
            fail(f"{name}: ledger golden regressed: {chk['blocking']}, "
                 f"iteration counts equal {chk['iters_ok']}")
    return rec


def check_impedance_farm(G, solver, lanes_in, xi_start):
    """K1 at the farm sweep's first drag pass (from Xi = ``xi_start``):
    every operand per lane (M, the radiation plus aero damping and the
    first drag term, C with each turbine's mooring stiffness, F), from
    the sweep's own set-up."""
    from raft_tpu_torch.models.fowt import (
        fowt_drag_excitation, fowt_hydro_linearization_pre)
    from raft_tpu_torch._config import COMPLEX

    case = solver.case
    fowt = solver.fowt
    dev = fowt.device
    w = torch.as_tensor(fowt.w, dtype=torch.float64, device=dev)
    st = case.setup_lanes(*lanes_in["sea"], lanes_in["r6"], lanes_in["C"])
    Xi0 = torch.zeros((st["F_lin"].shape[0], 6, fowt.nw), dtype=COMPLEX,
                      device=dev) + xi_start
    B6, Bmat = fowt_hydro_linearization_pre(fowt, st["pose"],
                                            st["drag_pre"], Xi0)
    M = st["M_lin"].contiguous()
    B = (B6[..., None] + st["B_BEM"] + lanes_in["B_add"][..., None]
         ).contiguous()
    C = st["C_lin"].contiguous()
    F = (st["F_lin"] + fowt_drag_excitation(fowt, st["pose"], Bmat,
                                            st["u0"])).contiguous()
    return _operand_row(G, w, M, B, C, F, "farm_operands",
                        "impedance_gj_farm")


def run_farm(dev):
    """Phase 11: (f1) VolturnUS-S_farm's four-turbine layout at full width
    in f64 and under the mixed ladder, (f2) the shipped two-turbine rows
    on the stand-in shared mooring with Model.sweep_farm, and (f3) the
    farm sweep of (f1)'s first FOWT, 4 turbines x 256 cases x 100 bins
    (102,400 lanes per K1 launch), against the JAX package's goldens."""
    import warnings

    from raft_tpu_torch import _config, run_raft
    from raft_tpu_torch.models import farm_cases as FC
    from raft_tpu_torch.models import wake as TW
    from raft_tpu_torch.ops.kernels import gj_solve as G
    from raft_tpu_torch.parallel import sweep as TS

    warnings.filterwarnings("ignore", message="sweep_farm replicates")
    gdir = os.path.join(ROOT, "tests", "golden", "farm")

    def gold(name):
        with open(os.path.join(gdir, name)) as f:
            return json.load(f)

    out = {}

    def raft(path, design, k1):
        """run_raft on the card: K1 (K3 under mixed) once per drag pass of
        every FOWT, no K2 (the (nw, 6N, 6N) system goes to LU)."""
        with counted(path, (k1,)):
            t0 = time.perf_counter()
            m = run_raft(design, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got = PATH_LAUNCHES[path]
        recs = m._case_records["0"]
        passes = sum(recs[f"fowt{i}"]["drag_iters"] for i in range(m.nFOWT))
        if got.get(k1) != passes or set(got) != {k1}:
            fail(f"{path}: launches {got}, expected {k1} {passes} (one per "
                 "drag pass of each FOWT) and nothing else")
        finite = bool(np.all(np.isfinite(m.Xi))) and all(
            np.isfinite(c[f"{ch}_std"])
            for i, c in m.results["case_metrics"][0].items()
            if isinstance(i, int) for ch in ("surge", "heave", "pitch"))
        if not finite:
            fail(f"{path}: non-finite outputs")
        rest = wall - sum(m.timings.values())
        log(f"  {path}: {m.nFOWT} FOWTs, {m.nDOF} DOFs x {m.nw} bins in "
            f"{wall:.2f} s; split " + ", ".join(
                f"{k} {v:.3f} s" for k, v in m.timings.items())
            + f", build {rest:.3f} s; statics iters "
            f"{recs['statics_iters']}, drag iters "
            f"{[recs[f'fowt{i}']['drag_iters'] for i in range(m.nFOWT)]}; "
            f"system solve {m.last_system_dispatch}")
        out[path] = dict(wall_s=wall, timings=dict(m.timings),
                         build_s=rest, launches=got, nw=m.nw,
                         statics_iters=recs["statics_iters"])
        return m

    # (f1) four turbines on individual moorings, f64 then mixed
    m1 = raft("farm_f1", FC.f1_design(), "impedance_gj")
    out["farm_f1"]["golden"] = _farm_golden("f1", m1, "f1")
    _config.set_precision_mode("mixed")
    try:
        m1x = raft("farm_f1_mixed", FC.f1_design(), "impedance_gj_mixed")
    finally:
        _config.set_precision_mode(None)
    out["farm_f1_mixed"]["golden"] = _farm_golden("f1 mixed", m1x, "f1")
    from raft_tpu_torch.models import mhk_cases as MC
    rel, same = MC.case_records_deviation(
        out["farm_f1"]["golden"]["record"],
        out["farm_f1_mixed"]["golden"]["record"])
    sysd = m1x.last_system_dispatch
    ladder = gold("f1.ladder.json")
    promoted = int(sysd.get("promoted", -1))
    out["farm_f1_mixed"].update(
        vs_f64_rel=rel, vs_f64_counts_equal=same, promoted=promoted,
        lanes=sysd.get("lanes"), jax_promoted=ladder["f32"]["promoted"])
    log(f"  f1 mixed vs f64: worst rel {rel:.2e}, counts equal {same}; the "
        f"ladder around LU promoted {promoted}/{sysd.get('lanes')} lanes "
        f"(the JAX package's ladder on its f64 run's systems: "
        f"{ladder['f32']['promoted']})")
    if rel > GOLDEN_TOL or not same:
        fail(f"f1 mixed vs f64: rel {rel:.2e}, counts equal {same}")
    if sysd.get("backend") != "lu" or sysd.get("precision") != "mixed" \
            or promoted != ladder["f32"]["promoted"]:
        fail(f"f1 mixed: system solve {sysd}, the JAX ladder promoted "
             f"{ladder['f32']['promoted']}")

    # (f2) two turbines on the stand-in shared mooring
    m2 = raft("farm_f2", FC.f2_design(), "impedance_gj")
    out["farm_f2"]["golden"] = _farm_golden("f2", m2, "f2")
    arel = FC.array_deviation(gold("f2.array.json"), FC.array_record(m2))
    out["farm_f2"]["array_rel"] = arel
    log(f"  f2 free points and _K_array vs the JAX package: worst rel "
        f"{arel:.2e}; free points {np.round(FC.array_record(m2)['xf'], 3)}")
    if not arel <= ARRAY_TOL:
        fail(f"f2: free points / _K_array rel {arel:.2e}")
    with counted("farm_f2_sweep", ("impedance_gj",)):
        t0 = time.perf_counter()
        sw2 = m2.sweep_farm(cases=FC.f3_cases(8, seed=1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    srel, ssame = FC.sweep_deviation(gold("f2.sweep.json"),
                                     FC.sweep_record(sw2))
    out["farm_f2_sweep"] = dict(wall_s=wall, worst_rel=srel,
                                counts_equal=ssame,
                                launches=PATH_LAUNCHES["farm_f2_sweep"])
    log(f"  f2 Model.sweep_farm, 2 x 8 cases: {wall:.2f} s, vs the JAX "
        f"package worst rel {srel:.2e}, counts equal {ssame}")
    if srel > GOLDEN_TOL or not ssame:
        fail(f"f2 sweep_farm: rel {srel:.2e}, counts equal {ssame}")

    # (f3) the farm sweep: 4 turbines x 256 cases x 100 bins
    fowt = m1.fowtList[0]
    f3 = gold("f3.json")
    t0 = time.perf_counter()
    curve = TW.power_thrust_curve(fowt)
    t_curve = time.perf_counter() - t0
    crel = max(_rel(torch.as_tensor(curve[k]),
                    torch.as_tensor(np.asarray(f3["curve"][k])))
               for k in ("power", "thrust", "Ct"))
    log(f"  f3 power/thrust curve ({len(curve['wind_speed'])} BEM points) "
        f"in {t_curve:.2f} s, vs the JAX package worst rel {crel:.2e}")
    if not crel <= ARRAY_TOL:
        fail(f"f3 curve: rel {crel:.2e}")
    c = FC.f3_cases()
    nt, nc = len(FC.F3_LAYOUT), FC.F3_NCASES
    F3_INPUTS.update(fowt=fowt, curve=curve, cases=c, nIter=m1.nIter,
                     XiStart=m1.XiStart)
    solver = TS.make_farm_solver(fowt, FC.F3_LAYOUT, curve=curve,
                                 nIter=m1.nIter, XiStart=m1.XiStart)
    lane = lambda x: TS._farm_lane_tile(  # noqa: E731
        torch.as_tensor(x, device=dev), nt)
    args = (lane(c["Hs"]), lane(c["Tp"]), lane(c["beta"]), c["U_inf"],
            c["wind_dir"])
    with counted("farm_sweep", ("impedance_gj",)):
        t0 = time.perf_counter()
        sw = solver(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k1 = PATH_LAUNCHES["farm_sweep"].get("impedance_gj", 0)
    if not 0 < k1 <= m1.nIter:
        fail(f"f3: {k1} K1 launches, expected 1..{m1.nIter}")
    busy = device_busy(lambda: solver(*args))
    # lanes against single-lane solves of the same lane
    worst = 0.0
    for lane_i in (0, nc + 17, 2 * nc + 101, 4 * nc - 1):
        t, k = divmod(lane_i, nc)
        B = TS._interp_along0(solver.curve_speed, solver.B_tab,
                              sw["U_wake"][t, k:k + 1])
        r6 = torch.zeros((1, 6), dtype=torch.float64, device=dev)
        r6[0, :2] = torch.as_tensor(FC.F3_LAYOUT[t])
        one = solver.case.batched(
            args[0][lane_i:lane_i + 1], args[1][lane_i:lane_i + 1],
            args[2][lane_i:lane_i + 1], r6_b=r6,
            C_moor_b=solver.C_moor_t[t][None], B_add=B)
        a, b = sw["Xi"][lane_i], one["Xi"][0]
        worst = max(worst, _rel(a, b))
        if not _allclose(a, b, SWEEP_RTOL,
                         atol=1e-12 * float(torch.max(torch.abs(b)))):
            fail(f"f3 lane {lane_i} differs from its single-lane solve")
    # the wake outputs: the host fixed point on the same curve, and the
    # batched equilibrium on the JAX package's curve against its own
    U_w = sw["U_wake"].cpu().numpy()
    host_worst, host_iters = 0.0, True
    D = 2.0 * fowt.rotors[0].R_rot
    its = sw["wake_iters"].cpu().numpy()
    for k in range(nc):
        U = np.full(nt, c["U_inf"][k])
        Ct = TW._curve_interp(U, curve, "Ct")
        for it in range(100):
            U_new = TW.wake_velocities(FC.F3_LAYOUT, D, Ct, c["U_inf"][k],
                                       c["wind_dir"][k])
            if np.max(np.abs(U_new - U)) < 1e-4:
                U = U_new
                break
            U = 0.5 * U + 0.5 * U_new
            Ct = TW._curve_interp(U, curve, "Ct")
        host_worst = max(host_worst, float(np.max(np.abs(U_w[:, k] - U))
                                           / np.max(np.abs(U))))
        host_iters = host_iters and int(its[k]) == it + 1
    cs, cCt, cP = TW.curve_tensors(f3["curve"], dev)
    eq = TW.wake_equilibria_torch(
        torch.as_tensor(FC.F3_LAYOUT, device=dev),
        torch.full((nt,), f3["D"], dtype=torch.float64, device=dev),
        cs, cCt, cP, c["U_inf"], c["wind_dir"])
    jrel = max(_rel(eq[k].cpu(), torch.as_tensor(np.asarray(f3["wake"][k])))
               for k in ("U", "Ct", "power"))
    jits = bool(np.array_equal(eq["iterations"].cpu().numpy(),
                               np.asarray(f3["wake"]["iterations"])))
    conv = int(sw["converged"].sum())
    out["farm_sweep"] = dict(
        wall_s=wall, turbines=nt, cases=nc, nw=fowt.nw,
        lanes=nt * nc * fowt.nw, converged=conv, fp_chunks=sw["fp_chunks"],
        serial_worst_rel=worst, wake_vs_host_rel=host_worst,
        wake_vs_host_iters_equal=host_iters, wake_vs_jax_rel=jrel,
        wake_vs_jax_iters_equal=jits, curve_vs_jax_rel=crel,
        curve_s=t_curve, wake_iters=[int(its.min()), int(its.max())],
        launches=PATH_LAUNCHES["farm_sweep"], device_busy=busy)
    log(f"  f3 sweep: {nt} turbines x {nc} cases x {fowt.nw} bins "
        f"({nt * nc * fowt.nw} lanes per K1 launch, {k1} launches) in "
        f"{wall:.3f} s; converged {conv}/{nt * nc}; {FARM_SERIAL_LANES} "
        f"lanes vs single-lane solves worst rel {worst:.2e}; wake vs host "
        f"{host_worst:.2e} (iterations equal {host_iters}), vs the JAX "
        f"package {jrel:.2e} (iterations equal {jits}), wake iterations "
        f"{int(its.min())}-{int(its.max())}; device busy "
        f"{None if busy is None else round(busy['busy_share'], 4)}")
    if not (host_worst <= WAKE_TOL and host_iters and jrel <= WAKE_TOL
            and jits):
        fail(f"f3 wake outputs: vs host {host_worst:.2e} ({host_iters}), "
             f"vs JAX {jrel:.2e} ({jits})")
    if not bool(torch.all(torch.isfinite(sw["std"]))):
        fail("f3 sweep: non-finite std")
    lanes_in = dict(sea=tuple(a.clone() for a in args[:3]),
                    r6=torch.repeat_interleave(
                        torch.as_tensor(np.c_[FC.F3_LAYOUT, np.zeros((nt, 4))],
                                        device=dev), nc, dim=0),
                    C=torch.repeat_interleave(solver.C_moor_t, nc, dim=0),
                    B_add=TS._interp_along0(solver.curve_speed, solver.B_tab,
                                            sw["U_wake"].reshape(-1)))
    out["farm_sweep"]["k1_row"] = check_impedance_farm(G, solver, lanes_in,
                                                       m1.XiStart)
    return out


# ---------------------------------------------------------------------------
# phase 12: MacCamy-Fuchs members
# ---------------------------------------------------------------------------

MCF_SERIAL_LANES = 4


def run_mcf(dev):
    """Phase 12: MacCamy-Fuchs members (models/mcf_cases.py): (c1) OC4semi
    with MCF columns through run_raft, (c2) the same under potSecOrder 1
    with the Kim & Yue correction, each at full width against the JAX
    package's goldens, and (c3) 1024 seeded cases on (c1)'s FOWT in f64
    and mixed."""
    from raft_tpu_torch import run_raft
    from raft_tpu_torch.models import mcf_cases as FC
    from raft_tpu_torch.models import mhk_cases as MC

    gdir = os.path.join(ROOT, "tests", "golden")
    out = {}

    def model_path(path, design, k5):
        """run_raft on the card: K1 exactly once per drag pass (every
        impedance_solve call, counted; under potSecOrder 1 the passes of
        both fixed points), K2 once per case, K5 ``k5`` times."""
        expect = ("impedance_gj", "gj_solve") + (("qtf_pair",) if k5 else ())
        with counted(path, expect), solve_counts() as seen:
            t0 = time.perf_counter()
            m = run_raft(design, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        recs = m._case_records
        ncases = len(m.results["case_metrics"])
        drag = sum(recs[str(i)]["fowt0"]["drag_iters"] for i in range(ncases))
        got = PATH_LAUNCHES[path]
        passes = seen["passes"]
        # the record's drag_iters is the last fixed point's: under
        # potSecOrder 1 the first one's passes come on top
        passes_ok = passes > drag if k5 else passes == drag
        if not passes_ok or got.get("impedance_gj") != passes \
                or got.get("gj_solve") != ncases \
                or got.get("qtf_pair", 0) != k5:
            fail(f"{path}: launches {got}, expected K1 {passes} (one per "
                 f"drag pass; the record's last fixed point took {drag}), "
                 f"K2 {ncases} (one per case), K5 {k5}")
        finite = all(np.isfinite(c[0][f"{ch}_std"])
                     for c in m.results["case_metrics"].values()
                     for ch in ("surge", "sway", "heave", "roll", "pitch",
                                "yaw")) and bool(np.all(np.isfinite(m.Xi)))
        if not finite:
            fail(f"{path}: non-finite outputs")
        if m._state[0]["hydro0"]["Imat"].dim() != 4:
            fail(f"{path}: the inertia coefficient is not frequency "
                 "dependent")
        rest = wall - sum(m.timings.values())
        stats = [dict(statics_iters=recs[str(i)]["statics_iters"],
                      drag_iters=recs[str(i)]["fowt0"]["drag_iters"])
                 for i in range(ncases)]
        log(f"  {path}: {ncases} case(s) x {m.nw} bins in {wall:.2f} s; "
            "split " + ", ".join(f"{k} {v:.3f} s"
                                 for k, v in m.timings.items())
            + f", build + unloaded statics + calcOutputs {rest:.3f} s; "
            f"drag passes {passes}; per case {stats}")
        out[path] = dict(wall_s=wall, timings=dict(m.timings), nw=m.nw,
                         build_unloaded_outputs_s=rest, ncases=ncases,
                         drag_passes=passes, launches=got, cases=stats)
        return m

    # (c1) strip theory with MCF columns: its record, no ledger golden
    c1 = model_path("mcf", FC.mcf_design(), 0)
    out["mcf"]["golden"] = _held_golden("mcf c1", c1, "oc4semi_mcf",
                                        FC.LEDGER_STEMS)
    with open(MC.golden_file(gdir, "oc4semi_mcf", coarse=False)) as f:
        ref = json.load(f)
    dres = dict(port=c1._case_records["0"]["dyn_solve_residual"],
                jax_host=ref["dyn_solve_residual_host"],
                jax_default=ref["dyn_solve_residual_default"])
    out["mcf"]["dyn_solve_residual"] = dres
    log(f"  [mcf c1] dyn_solve_residual {dres} (no ledger golden: "
        f"{FC.NO_LEDGER['oc4semi_mcf']})")

    # (c2) under the QTF, the Kim & Yue correction in its pair grid
    c2 = model_path("mcf_qtf", FC.mcf_qtf_design(), 1)
    out["mcf_qtf"]["nw2"] = len(c2.fowtList[0].w1_2nd)
    out["mcf_qtf"]["golden"] = _held_golden("mcf c2", c2, "oc4semi_mcf_qtf",
                                            FC.LEDGER_STEMS)

    # (c3) 1024 seeded cases on (c1)'s FOWT, f64 then mixed: at most
    # nIter launches of cases x bins lanes each
    fowt = c1.fowtList[0]
    Hs, Tp, beta = FC.sweep_inputs()
    recs, out["mcf_sweep_checks"] = sweep_pair(
        "(c3) MCF sweep", "mcf_sweep", fowt, Hs, Tp, beta, FC.SWEEP_NITER,
        MCF_SERIAL_LANES, dev)
    for mode, kind in (("f64", "impedance_gj"),
                       ("mixed", "impedance_gj_mixed")):
        n = recs[mode]["launches"].get(kind, 0)
        out[f"mcf_sweep_{mode}"] = dict(recs[mode], lanes=len(Hs) * fowt.nw)
        if not 0 < n <= FC.SWEEP_NITER:
            fail(f"(c3) MCF sweep {mode}: {n} {kind} launches of "
                 f"{len(Hs) * fowt.nw} lanes, not 1..{FC.SWEEP_NITER}")
    out["mcf_variants"] = run_mcf_variants(dev)
    return out


def run_mcf_variants(dev):
    """(c4): five diameter variants of (c1) on the coarse grid through
    sweep_variants on the card, on one device and on phase 18's mesh of
    two shards, against the JAX package's golden
    (tests/golden/variants/oc4semi_mcf_coarse.json) at
    mcf_cases.VARIANT_CARD_RTOL."""
    from raft_tpu_torch.models import mcf_cases as FC
    from raft_tpu_torch.parallel import partition
    from raft_tpu_torch.parallel.sweep import design_fowt
    from raft_tpu_torch.parallel.variants import sweep_variants

    with open(os.path.join(ROOT, "tests", "golden", "variants",
                           "oc4semi_mcf_coarse.json")) as f:
        gold = json.load(f)
    devs = _shard_devices()
    fowt = design_fowt(FC.mcf_design(coarse=True), devs[0])
    th = FC.variant_thetas(len(fowt.members))
    out = {}
    for tag, kw in (("", dict(device=devs[0])),
                    ("_mesh", dict(mesh=partition.make_mesh(
                        (2,), ("variants",), devs)))):
        with counted(f"mcf_variants{tag}", ("impedance_gj",)):
            t0 = time.perf_counter()
            res = sweep_variants(fowt, th, **kw, **FC.VARIANT_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_ = FC.variant_deviation(res, gold)
        worst = max(dev_.values())
        out[f"deviation{tag}"] = dev_
        out[f"wall{tag}_s"] = wall
        log(f"  (c4) MCF variants{' on the mesh' if tag else ''}: "
            f"{len(FC.VARIANT_SCALES)} x {fowt.nw} bins in {wall:.2f} s; vs "
            f"the JAX package worst rel {worst:.2e} (bar "
            f"{FC.VARIANT_CARD_RTOL:g}): "
            + ", ".join(f"{k} {v:.1e}" for k, v in dev_.items()))
        if not worst <= FC.VARIANT_CARD_RTOL:
            fail(f"(c4) MCF variants{tag}: worst rel {worst:.2e}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the ballast trim (Model.analyzeUnloaded(ballast=1|2), run_raft)
# ---------------------------------------------------------------------------

def _ballast_pulls():
    """The trim's counted host pulls so far (ballast_cases.PULLS)."""
    from raft_tpu_torch import obs
    from raft_tpu_torch.models.ballast_cases import PULLS

    series = obs.snapshot().get("raft_tpu_host_transfers_total",
                                {}).get("series", [])
    return int(sum(x["value"] for x in series
                   if x["labels"].get("what") in PULLS))


def _trim_held(label, gold, live):
    """A trim record against its golden (ballast_cases.trim_deviation):
    every fill level equal, the unrounded fill levels (their margins
    printed), the density shift, the downstream outputs and the near-zero
    ones by their floor bar."""
    from raft_tpu_torch.models import ballast_cases as BC

    dev = BC.trim_deviation(gold, live)
    walk = [(w["group"], w["section"], w["branch"], w["l_new"],
             f"{w['margin']:.2e}") for w in live["walk"]]
    log(f"  [{label}] fills equal {dev['fills_equal']}, walk equal "
        f"{dev['walk_equal']} (group, section, branch, l_fill, margin: "
        f"{walk}); unrounded rel {dev['unrounded']['rel']:.2e}; imbalance "
        f"rel {dev['imbalance']:.2e}; density rel {dev['density']:.2e}; "
        f"downstream rel {dev['downstream']:.2e}; near zero "
        + ", ".join(f"{k} |port - JAX| {z['dev']:.3e} (bar {z['bar']:.3e})"
                    for k, z in dev["near_zero"].items())
        + f"; unloaded iterations equal {dev['iters_equal']}")
    if not dev["ok"]:
        fail(f"{label}: the trim does not meet its golden: {dev}")
    return dev


@contextlib.contextmanager
def trim_probe():
    """Inside: the wall of every ``Model.adjustBallast`` /
    ``adjustBallastDensity`` call (ending in a device sync) and the
    Newton iterations of every ``analyzeUnloaded``'s statics (which
    ``analyzeCases`` forgets), in order."""
    from raft_tpu_torch.model import Model

    seen = {"walls": [], "unloaded_iters": []}
    saved = (Model.adjustBallast, Model.adjustBallastDensity,
             Model.analyzeUnloaded)

    def timed(fn):
        def call(self, *a, **k):
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            seen["walls"].append(time.perf_counter() - t0)
            return out
        return call

    def unloaded(self, *a, **k):
        out = saved[2](self, *a, **k)
        seen["unloaded_iters"].append(
            self._case_records["unloaded"]["statics_iters"])
        return out

    (Model.adjustBallast, Model.adjustBallastDensity,
     Model.analyzeUnloaded) = (timed(saved[0]), timed(saved[1]), unloaded)
    try:
        yield seen
    finally:
        (Model.adjustBallast, Model.adjustBallastDensity,
         Model.analyzeUnloaded) = saved


def run_ballast(dev):
    """Phase 13: the ballast trim (models/ballast_cases.py, goldens of
    tests/golden/ballast_golden.py) at each design's own grid: (b1) and
    (b2) through Model.analyzeUnloaded, (b3) run_raft(ballast=True) on
    VolturnUS-S and OC3spar's first case, the latter's Model ->
    analyzeUnloaded(ballast=1) -> analyzeCases -> calcOutputs inside
    transfers.guard("disallow").  The (b1) walks of those two designs
    are the walks inside their (b3) runs, held against both goldens."""
    from raft_tpu_torch import run_raft
    from raft_tpu_torch.ledger import _compare_values
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import ballast_cases as BC
    from raft_tpu_torch.models import mhk_cases as MC
    from raft_tpu_torch.obs import transfers

    gdir = os.path.join(ROOT, "tests", "golden", "ballast")
    with open(os.path.join(gdir, "trims.json")) as f:
        gold = json.load(f)
    out = {}

    # (b1), (b2): statics only, no kernel.  The walks at heave_tol 1.0 of
    # the (b3) designs run inside (b3)'s run_raft, held there
    in_b3 = {f"b1_{key}_walk": stem for stem, (key, _) in BC.RUNS.items()}
    for tid, (key, ballast, tol) in BC.TRIMS.items():
        if tid in in_b3:
            continue
        m = Model(BC.design(key), device=dev)
        fowt = m.fowtList[0]
        before = m._heave_imbalance(fowt)[1] if ballast == 2 else None
        p0 = _ballast_pulls()
        with counted(f"ballast_{tid}", ()), trim_probe() as probe:
            t0 = time.perf_counter()
            m.analyzeUnloaded(ballast=ballast, heave_tol=tol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        pulls = _ballast_pulls() - p0
        live = BC.run_trim_record(m, before)
        sections = len(live["walk"])
        log(f"  ({tid[:2]}) {tid}: analyzeUnloaded(ballast={ballast}, "
            f"heave_tol={tol:g}) in {wall:.3f} s (trim "
            f"{probe['walls'][0]:.3f} s, unloaded statics "
            f"{wall - probe['walls'][0]:.3f} s), {sections} "
            f"sections visited, trim pulls {pulls}")
        _expect(f"{tid}: trim pulls", pulls, BC.trim_pulls(ballast, sections))
        _expect(f"{tid}: kernel launches", PATH_LAUNCHES[f"ballast_{tid}"],
                {})
        out[tid] = dict(wall_s=wall, trim_s=probe["walls"][0],
                        sections=sections, pulls=pulls,
                        golden=_trim_held(tid, gold[tid], live))

    # (b3): the main path on the trimmed designs
    expect = ("impedance_gj", "gj_solve")
    for stem, (key, ncases) in BC.RUNS.items():
        design = BC.design(key, ncases=ncases)
        guarded = stem == "oc3spar_ballast"
        err = None
        p0 = _ballast_pulls()
        with counted(stem, expect), solve_counts() as seen, \
                trim_probe() as probe:
            t0 = time.perf_counter()
            if guarded:
                m = Model(design, device=dev)
                torch.cuda.synchronize()
                t_build = time.perf_counter() - t0
                try:
                    with transfers.guard("disallow"):
                        m.analyzeUnloaded(ballast=1)
                        m.analyzeCases()
                        m.calcOutputs()
                        torch.cuda.synchronize()
                except RuntimeError as e:
                    import traceback
                    err = f"{e}\n{traceback.format_exc()[-2500:]}"
            else:
                m = run_raft(design, ballast=True, device=dev)
                t_build = None
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if err:
            fail(f"(b3) {stem} under the sync guard: {err}")
            continue
        pulls = _ballast_pulls() - p0
        recs = m._case_records
        nc = len(m.results["case_metrics"])
        drag = sum(recs[str(i)]["fowt0"]["drag_iters"] for i in range(nc))
        got = PATH_LAUNCHES[stem]
        if seen["passes"] != drag or got.get("impedance_gj") != drag \
                or got.get("gj_solve") != nc:
            fail(f"(b3) {stem}: launches {got}, expected K1 {drag} (one per "
                 f"drag pass; {seen['passes']} impedance solves), K2 {nc}")
        sections = len(m.ballast_trim["walk"])
        rest = wall - sum(m.timings.values())
        log(f"  (b3) {stem}: run_raft(ballast=True)"
            + (" as Model -> (guard disallow) analyzeUnloaded(ballast=1) -> "
               "analyzeCases -> calcOutputs" if guarded else "")
            + f": {nc} case(s) x {m.nw} bins in {wall:.2f} s; split "
            + ", ".join(f"{k} {v:.3f} s" for k, v in m.timings.items())
            + f", build + trim + unloaded statics + calcOutputs {rest:.3f} s"
            + f" (trim {probe['walls'][0]:.3f} s"
            + ("" if t_build is None else f", build {t_build:.3f} s") + ")"
            + f"; {sections} sections visited, trim pulls {pulls}; "
            f"launches {got}")
        _expect(f"{stem}: trim pulls", pulls, BC.trim_pulls(1, sections))
        rec = _held_golden(f"b3 {stem}", m, stem, BC.LEDGER_STEMS, gdir)
        with open(MC.golden_file(gdir, stem, coarse=False)) as f:
            ref = json.load(f)
        trim = BC.run_trim_record(m)
        trim["unloaded_iters"] = probe["unloaded_iters"][0]
        rec["trim"] = _trim_held(f"b3 {stem}", ref["trim"], trim)
        tid = next(t for t, st in in_b3.items() if st == stem)
        out[tid] = dict(in_b3=stem, sections=sections, pulls=pulls,
                        trim_s=probe["walls"][0],
                        golden=_trim_held(f"{tid} (in b3)", gold[tid], trim))
        props = m.results["properties"]
        prel = max(_compare_values(np.asarray(props[k], float).tolist(),
                                   v)[0]
                   for k, v in ref["properties"].items())
        log(f"  (b3) {stem}: calcOutputs' ballast densities "
            f"{np.asarray(props['ballast densities']).tolist()} and masses, "
            f"rel {prel:.2e} against the JAX package's")
        if not prel <= GOLDEN_TOL:
            fail(f"(b3) {stem}: ballast densities / masses rel {prel:.2e}")
        out[stem] = dict(wall_s=wall, timings=dict(m.timings),
                         build_trim_unloaded_outputs_s=rest,
                         trim_s=probe["walls"][0], ncases=nc, nw=m.nw,
                         drag_passes=drag, launches=got, sections=sections,
                         pulls=pulls, guarded=guarded, golden=rec)
    return out


# ---------------------------------------------------------------------------
# phase 14: fault tolerance (recovery.py, analyzeCases, sweep_cases)
# ---------------------------------------------------------------------------

RECOVERY_TOL = 1e-12
RECOVERY_CHUNKS = 4
#: the chunk size of (r5)'s last call (its others take 1024 / 4)
RECOVERY_ODD_CHUNK = 100


@contextlib.contextmanager
def clean_path_checks():
    """Inside: every ``Model.analyzeCases`` must end with no recovery
    attempt and no quarantined case, every ``sweep_cases`` with
    ``out["quarantine"] is None``; the yielded dict counts both and holds
    each Model run's case-journal seconds (``timings["journal"]``)."""
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.parallel import sweep as SW

    seen = {"models": 0, "sweeps": 0, "journal_s": []}
    analyze, sweep = Model.analyzeCases, SW.sweep_cases

    def checked_analyze(self, *a, **k):
        out = analyze(self, *a, **k)
        seen["models"] += 1
        seen["journal_s"].append(self.timings["journal"])
        if self.failed_cases or self.recovery_attempts:
            fail(f"a clean Model run recorded {self.recovery_attempts} / "
                 f"quarantined {self.failed_cases}")
        return out

    def checked_sweep(*a, **k):
        out = sweep(*a, **k)
        seen["sweeps"] += 1
        if out["quarantine"] is not None:
            fail(f"a clean sweep quarantined lanes: {out['quarantine']}")
        return out

    Model.analyzeCases, SW.sweep_cases = checked_analyze, checked_sweep
    try:
        yield seen
    finally:
        Model.analyzeCases, SW.sweep_cases = analyze, sweep


@contextlib.contextmanager
def solve_counts():
    """Inside: the Model's statics and dynamics solves, its drag passes
    (``impedance_solve`` calls; those of the damped restart apart) and
    system solves (``inv_complex`` calls), and the lanes of every
    ``impedance_solve`` call of the sweep module, counted."""
    import raft_tpu_torch.model as TM
    import raft_tpu_torch.parallel.sweep as SW
    from raft_tpu_torch import recovery

    seen = {"statics": 0, "dynamics": 0, "passes": 0, "damped_passes": 0,
            "system": 0, "sweep_lanes": []}
    saved = (TM.Model.solveStatics, TM.Model.solveDynamics,
             TM.impedance_solve, TM.inv_complex, SW.impedance_solve)
    statics, dynamics, imp, inv, sw_imp = saved

    def c_statics(self, *a, **k):
        seen["statics"] += 1
        return statics(self, *a, **k)

    def c_dynamics(self, *a, **k):
        seen["dynamics"] += 1
        return dynamics(self, *a, **k)

    def c_imp(*a, **k):
        seen["passes"] += 1
        seen["damped_passes"] += recovery.current("fp_relax", 0.8) != 0.8
        return imp(*a, **k)

    def c_inv(*a, **k):
        seen["system"] += 1
        return inv(*a, **k)

    def c_sw_imp(w, M, B, C, F):
        seen["sweep_lanes"].append(int(F.shape[0]) * int(F.shape[-1]))
        return sw_imp(w, M, B, C, F)

    (TM.Model.solveStatics, TM.Model.solveDynamics, TM.impedance_solve,
     TM.inv_complex, SW.impedance_solve) = (c_statics, c_dynamics, c_imp,
                                            c_inv, c_sw_imp)
    try:
        yield seen
    finally:
        (TM.Model.solveStatics, TM.Model.solveDynamics, TM.impedance_solve,
         TM.inv_complex, SW.impedance_solve) = saved


def _expect(label, got, want):
    """Log one count against its expected value; fail when they differ."""
    log(f"    {label}: {got} (expected {want})")
    if got != want:
        fail(f"{label}: {got}, expected {want}")


def _attempts(m):
    return [(a.phase, a.case, a.step_from, a.step_to, a.outcome, a.error)
            for a in m.recovery_attempts]


def run_recovery(dev, coarse=False, ncases=SWEEP_CASES):
    """Phase 14: the degradation ladder, per-case quarantine and
    journal/resume of ``Model.analyzeCases`` on OC3spar's three shipped
    cases, and lane quarantine and the checkpointed chunked sweep on
    phase 5's sweep (``coarse``/``ncases`` cut both for a rehearsal on
    the CPU)."""
    from raft_tpu_torch import _config, ledger, recovery
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import recovery_cases as RC
    from raft_tpu_torch.parallel.sweep import (design_fowt, sweep_cases,
                                               sweep_cases_chunked)
    from raft_tpu_torch.serve.checkpoint import CheckpointStore
    from raft_tpu_torch.testing import faults

    with open(os.path.join(ROOT, "tests", "golden", "recovery",
                           "oc3spar.json")) as f:
        gold = json.load(f)
    out = {}
    K1, K2, K3, K4 = ("impedance_gj", "gj_solve", "impedance_gj_mixed",
                      "gj_solve_mixed")

    def model_run(path, design, spec=None, resume=False, mode=None,
                  expect=(K1, K2)):
        faults.install(spec)
        _config.set_precision_mode(mode)
        try:
            with counted(path, expect), solve_counts() as seen:
                t0 = time.perf_counter()
                m = Model(design, device=dev)
                m.analyzeCases(resume=resume)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            faults.clear()
            _config.set_precision_mode(None)
        got = PATH_LAUNCHES[path]
        log(f"  {path}: {len(m.results['case_metrics'])} case(s) x {m.nw} "
            f"bins in {wall:.2f} s (statics {m.timings['statics']:.2f} s, "
            f"dynamics {m.timings['dynamics']:.2f} s, journal "
            f"{m.timings['journal']:.3f} s); attempts "
            f"{_attempts(m)}; failed {[(c['case'], c['phase'], c['error']) for c in m.failed_cases]}; "
            f"resumed {m.resumed_cases}; solves {seen}; launches {got}")
        out[path] = dict(wall_s=wall, timings=dict(m.timings),
                         attempts=[a.to_dict() for a in m.recovery_attempts],
                         failed_cases=m.failed_cases,
                         resumed_cases=m.resumed_cases, launches=got,
                         solves={k: v for k, v in seen.items()
                                 if k != "sweep_lanes"})
        return m, seen, got

    def drag(m, i):
        return m._case_records[str(i)]["fowt0"]["drag_iters"]

    def mapped(rec):
        return [(a["phase"], a["case"], recovery.JAX_STEP[a["step_from"]],
                 recovery.JAX_STEP[a["step_to"]], a["outcome"], a["error"])
                for a in rec["attempts"]]

    # (r1) OC3spar's three shipped cases: clean, case 1 quarantined, resume
    design = RC.oc3spar_design(coarse=coarse)
    m0, s0, l0 = model_run("recovery_clean", design)
    recovery.CaseJournal.for_model(m0).clear()
    m1, s1, l1 = model_run("recovery_faulted", design, "nan@dynamics:case=1")
    log("  (r1) against the JAX package's ladder on OC3spar "
        "(tests/golden/recovery/oc3spar.json):")
    _expect("attempts", _attempts(m1), mapped(gold["faulted"]))
    _expect("failed cases", [(c["case"], c["phase"], c["error"])
                             for c in m1.failed_cases],
            [(c["case"], c["phase"], c["error"])
             for c in gold["faulted"]["failed_cases"]])
    _expect("statics / dynamics solves",
            (s1["statics"], s1["dynamics"]),
            (gold["faulted"]["solves"]["statics"],
             gold["faulted"]["solves"]["dynamics"]))
    rep = ledger.diff(m0.last_ledger, m1.last_ledger, tol_rel=RECOVERY_TOL)
    _expect("ledger diff against the clean run: added / removed / moved",
            (rep["added"], rep["removed"], len(rep["regressions"])),
            (["case1/failed"], ["case1/fowt0", "case1/system"], 0))
    undamped = drag(m0, 0) + drag(m0, 2) + 2 * drag(m0, 1)
    _expect("K1 launches = drag passes", l1.get(K1), s1["passes"])
    _expect("undamped drag passes (cases 0, 2 and case 1's two rungs, "
            "from the clean run's records)",
            s1["passes"] - s1["damped_passes"], undamped)
    log(f"    damped-restart drag passes: {s1['damped_passes']} (at most "
        f"{2 * m1.nIter + 1})")
    if not 0 < s1["damped_passes"] <= 2 * m1.nIter + 1:
        fail(f"(r1) damped restart ran {s1['damped_passes']} passes")
    _expect("K2 launches = dynamics attempts", l1.get(K2), s1["dynamics"])
    m2, s2, l2 = model_run("recovery_resumed", design, resume=True)
    _expect("resumed cases", m2.resumed_cases, [0, 2])
    _expect("statics / dynamics solves on resume",
            (s2["statics"], s2["dynamics"]), (1, 1))
    _expect("K1 / K2 launches on resume", (l2.get(K1), l2.get(K2)),
            (drag(m0, 1), 1))
    rep = ledger.diff(m0.last_ledger, m2.last_ledger, tol_rel=RECOVERY_TOL)
    _expect("resumed ledger equals the clean run's at 1e-12", rep["ok"],
            True)

    # (r2) case 0 alone, one injected kernel failure before any launch;
    # held against case 0 of (r1)'s clean run, which starts from the same
    # state
    design1 = RC.oc3spar_design(coarse=coarse, ncases=1)
    m4, s4, l4 = model_run("recovery_kernel_once", design1,
                           "raise@kernel:case=0:once")
    log("  (r2) raise@kernel:case=0:once:")
    _expect("attempts", _attempts(m4), [("dynamics", "0", "configured",
                                         "re_solve", "recovered",
                                         "KernelFailure")])
    rep = ledger.diff(m0.last_ledger, m4.last_ledger, tol_rel=RECOVERY_TOL)
    _expect("ledger against case 0 of the clean run at 1e-12: added / "
            "removed / moved", (rep["added"], rep["removed"],
                                len(rep["regressions"])),
            ([], [f"case{i}/{e}" for i in (1, 2)
                  for e in ("fowt0", "system")], 0))
    _expect("K1 / K2 launches equal the clean run's for case 0 (drag "
            "passes, one system solve)", (l4.get(K1), l4.get(K2)),
            (drag(m0, 0), 1))
    _expect("impedance_solve calls (the faulted one launched nothing)",
            s4["passes"], drag(m0, 0) + 1)

    # (r3) mixed: two failing rungs, the damped restart recovers
    spec = "nan@dynamics:case=0:times=2"
    m5, s5, l5 = model_run("recovery_mixed", design1, spec, mode="mixed",
                           expect=(K3, K4))
    m6, s6, l6 = model_run("recovery_f64_times2", design1, spec)
    log("  (r3) nan@dynamics:case=0:times=2, mixed against f64:")
    want = [("dynamics", "0", "configured", "re_solve", "failed",
             "NonFiniteResult"),
            ("dynamics", "0", "re_solve", "damped_restart", "recovered",
             "NonFiniteResult")]
    _expect("attempts (mixed)", _attempts(m5), want)
    _expect("attempts (f64)", _attempts(m6), want)
    _expect("mixed launches: K3 = drag passes, K4 = system solves, no K1 "
            "or K2", (l5.get(K3), l5.get(K4), l5.get(K1, 0), l5.get(K2, 0)),
            (s5["passes"], s5["dynamics"], 0, 0))
    _expect("f64 launches: K1 = drag passes, K2 = system solves",
            (l6.get(K1), l6.get(K2)), (s6["passes"], s6["dynamics"]))
    _expect("drag passes, mixed = f64", s5["passes"], s6["passes"])
    rep = ledger.diff(m6.last_ledger, m5.last_ledger, tol_rel=MIXED_STD_RTOL,
                      per_metric={"*_residual*": GOLDEN_RESID_TOL})
    _expect("mixed ledger against f64 (1e-6, residuals 0.5): blocking "
            "regressions", len(ledger.blocking_regressions(rep)), 0)

    # (r4) phase 5's sweep with its first, middle and last lanes poisoned
    fowt = design_fowt(RC.oc3spar_design(coarse=coarse), dev)
    Hs, Tp, beta = sweep_inputs(ncases)
    poison = (0, ncases // 2, ncases - 1)
    spec = ",".join(f"nan@sweep:lane={i}" for i in poison)
    kw = dict(nIter=10, tol=0.01, device=dev)
    with counted("recovery_sweep_clean", (K1,)):
        clean = sweep_cases(fowt, Hs, Tp, beta, **kw)
    if not all(bool(clean["converged"][i]) for i in poison):
        fail(f"(r4) a poisoned lane {poison} did not converge in the clean "
             "sweep: it would walk on to the damped restart")
    faults.install(spec)
    try:
        with counted("recovery_sweep", (K1,)), solve_counts() as ss:
            t0 = time.perf_counter()
            sw = sweep_cases(fowt, Hs, Tp, beta, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with counted("recovery_sweep_off", (K1,)):
            off = sweep_cases(fowt, Hs, Tp, beta, quarantine="off", **kw)
    finally:
        faults.clear()
    q = sw["quarantine"]
    lanes = list(poison)
    nw = fowt.nw
    log(f"  (r4) {ncases} cases x {nw} bins, lanes {lanes} poisoned: "
        f"{wall:.3f} s; quarantine {q}")
    _expect("quarantine lanes / recovered / quarantined / rungs",
            (q["lanes"], q["recovered"], q["quarantined"],
             [(a["step_from"], a["step_to"], a["outcome"])
              for a in q["ladder"]]),
            (lanes, lanes, [], [("batched", "re_solve", "recovered")]))
    rel = max(_rel(sw[k][lanes], clean[k][lanes]) for k in ("Xi", "std"))
    log(f"    spliced lanes against the clean sweep: rel {rel:.2e}")
    if not rel <= RECOVERY_TOL:
        fail(f"(r4) spliced lanes differ from the clean sweep by {rel:.2e}")
    rest = torch.ones(ncases, dtype=torch.bool, device=clean["Xi"].device)
    rest[lanes] = False
    _expect("other lanes bitwise equal (Xi, std)",
            (bool(torch.equal(sw["Xi"][rest], clean["Xi"][rest])),
             bool(torch.equal(sw["std"][rest], clean["std"][rest]))),
            (True, True))
    _expect("iters / converged equal the clean sweep's",
            (bool(torch.equal(sw["iters"], clean["iters"])),
             bool(torch.equal(sw["converged"], clean["converged"]))),
            (True, True))
    batch = [n for n in ss["sweep_lanes"] if n == ncases * nw]
    resolve = [n for n in ss["sweep_lanes"] if n != ncases * nw]
    _expect("K1 launches: batch + re-solve", PATH_LAUNCHES[
        "recovery_sweep"].get(K1), len(ss["sweep_lanes"]))
    _expect("batch launches equal the clean sweep's", len(batch),
            PATH_LAUNCHES["recovery_sweep_clean"].get(K1))
    _expect("re-solve launch lanes", sorted(set(resolve)),
            [len(lanes) * nw])
    _expect("quarantine off: poisoned lanes NaN, the rest finite, no record",
            (bool(torch.all(torch.isnan(off["std"][lanes]))),
             bool(torch.all(torch.isfinite(off["std"][rest]))),
             off["quarantine"]), (True, True, None))
    out["recovery_sweep"] = dict(wall_s=wall, quarantine=q, spliced_rel=rel,
                                 resolve_launches=len(resolve),
                                 resolve_lanes=len(lanes) * nw,
                                 launches=PATH_LAUNCHES["recovery_sweep"])

    # (r5) the same table in 4 checkpointed chunks
    store = CheckpointStore(os.path.join(OUT, "recovery_checkpoints"))
    key = "oc3spar-sweep"
    store.delete(key)
    chunk = -(-ncases // RECOVERY_CHUNKS)
    ref = {k: clean[k].cpu().numpy() for k in ("Xi", "std", "iters",
                                                "converged")}
    chunks = list(range(RECOVERY_CHUNKS))
    log(f"  (r5) sweep_cases_chunked, {RECOVERY_CHUNKS} chunks of {chunk}:")

    def chunked(label, table, want, key=key, chunk=chunk):
        with counted(f"recovery_chunked_{label}", ()):
            t0 = time.perf_counter()
            res, info = sweep_cases_chunked(fowt, *table, store=store,
                                            key=key, chunk=chunk, **kw)
            wall = time.perf_counter() - t0
        _expect(f"{label}: resumed / solved ({wall:.2f} s, launches "
                f"{PATH_LAUNCHES[f'recovery_chunked_{label}']})",
                (info["resumed"], info["solved"]), want)
        out[f"recovery_chunked_{label}"] = dict(
            wall_s=wall, info=info,
            launches=PATH_LAUNCHES[f"recovery_chunked_{label}"])
        return res

    first = chunked("first", (Hs, Tp, beta), ([], chunks))
    _expect("first call bitwise equal to one sweep_cases over the table",
            {k: bool(np.array_equal(first[k], ref[k])) for k in ref},
            {k: True for k in ref})
    again = chunked("second", (Hs, Tp, beta), (chunks, []))
    _expect("second call: nothing launched, output unchanged",
            (PATH_LAUNCHES["recovery_chunked_second"].get(K1, 0),
             all(np.array_equal(again[k], first[k]) for k in ref)),
            (0, True))
    store.delete(key, 2)
    store.delete(key, 3)
    killed = chunked("killed", (Hs, Tp, beta), ([0, 1], [2, 3]))
    _expect("after the kill, output unchanged",
            all(np.array_equal(killed[k], first[k]) for k in ref), True)
    Hs2 = Hs.copy()
    Hs2[3 * chunk + min(17, chunk - 1)] += 0.25
    chunked("edited", (Hs2, Tp, beta), ([0, 1, 2], [3]))
    corrupt0 = store.stats()["corrupt"]
    faults.install("corrupt@checkpoint:step=1")
    try:
        chunked("corrupt", (Hs2, Tp, beta), ([0, 2, 3], [1]))
    finally:
        faults.clear()
    _expect("corrupt checkpoints deleted", store.stats()["corrupt"]
            - corrupt0, 1)
    # another chunk size: chunks of 100 cases and a tail of 24 give the
    # lanes of the whole-table sweep bitwise (no lane depends on the
    # lanes solved beside it)
    rows = min(ncases, 3 * RECOVERY_ODD_CHUNK + 24)
    nodd = -(-rows // RECOVERY_ODD_CHUNK)
    key_odd = f"{key}-{RECOVERY_ODD_CHUNK}"
    store.delete(key_odd)
    odd = chunked(f"chunk{RECOVERY_ODD_CHUNK}",
                  (Hs[:rows], Tp[:rows], beta[:rows]),
                  ([], list(range(nodd))), key=key_odd,
                  chunk=RECOVERY_ODD_CHUNK)
    _expect(f"chunks of {RECOVERY_ODD_CHUNK} over the first {rows} cases "
            "bitwise equal to the whole-table sweep's lanes",
            {k: bool(np.array_equal(odd[k], ref[k][:rows])) for k in ref},
            {k: True for k in ref})
    out["checkpoint_store"] = store.stats()
    return out


OBS_RESID_TOL = {"f64": 1e-12, "mixed": 1e-9}


def _counter(snap, name):
    return sum(s["value"] for s in snap.get(name, {}).get("series", []))


def run_obs(dev, coarse=False, ncases=SWEEP_CASES):
    """Phase 15: observability on the main path.  (o1) OC3spar's case 0
    with observability off and on (an output directory under --out,
    probes sampled, inside transfers.guard("disallow")); (o2) phase 5's
    table with health=True in f64 and mixed.  ``coarse``/``ncases`` cut
    both for a rehearsal on the CPU."""
    from raft_tpu_torch import _config, ledger, obs
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import recovery_cases as RC
    from raft_tpu_torch.models.obs_cases import (
        JAX_PULLS_PER_CASE, SPAN_TREE, pulls_per_case)
    from raft_tpu_torch.obs import events, transfers
    from raft_tpu_torch.parallel.sweep import design_fowt, sweep_cases

    out = {}
    K1, K2, K3 = "impedance_gj", "gj_solve", "impedance_gj_mixed"
    design = RC.oc3spar_design(coarse=coarse, ncases=1)
    obs_dir = os.path.join(OUT, "obs")
    shutil.rmtree(obs_dir, ignore_errors=True)
    runs = {}
    for label, on in (("off", False), ("on", True)):
        obs.reset_all()
        obs.configure(obs_dir if on else None)
        _config.set_probes_mode("sampled" if on else "off")
        m = Model(design, device=dev)
        torch.cuda.synchronize()
        guard = transfers.guard("disallow") if on \
            else contextlib.nullcontext()
        err = None
        try:
            with counted(f"obs_{label}", (K1, K2)), guard:
                t0 = time.perf_counter()
                m.analyzeCases()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        except RuntimeError as e:
            import traceback
            err = f"{e}\n{traceback.format_exc()[-2500:]}"
            wall = float("nan")
        finally:
            _config.set_probes_mode(None)
        runs[label] = dict(model=m, wall=wall, err=err, spans=obs.spans(),
                           chrome=obs.chrome_trace(), snap=obs.snapshot())
        if err:
            fail(f"(o1) obs {label}: {err}")
    obs.configure(None)
    if any(r["err"] for r in runs.values()):
        return out
    off, on = runs["off"]["model"], runs["on"]["model"]
    rec = on._case_records["0"]
    log(f"  (o1) OC3spar case 0 x {on.nw} bins: wall obs off "
        f"{runs['off']['wall']:.3f} s, obs on (directory, probes sampled, "
        f"guard disallow) {runs['on']['wall']:.3f} s, difference "
        f"{runs['on']['wall'] - runs['off']['wall']:+.3f} s; statics "
        f"iters {rec['statics_iters']}, drag passes "
        f"{rec['fowt0']['drag_iters']}")
    _expect("ledgers bitwise equal (digest)", off.last_ledger["digest"]
            == on.last_ledger["digest"] and bool(np.array_equal(off.Xi,
                                                               on.Xi)),
            True)
    _expect("K1 / K2 launches equal", (PATH_LAUNCHES["obs_off"].get(K1),
                                        PATH_LAUNCHES["obs_off"].get(K2)),
            (PATH_LAUNCHES["obs_on"].get(K1), PATH_LAUNCHES["obs_on"].get(K2)))
    for label in ("off", "on"):
        _expect(f"span tree ({label})",
                [[sp["name"], sp["depth"], sp["parent"]]
                 for sp in runs[label]["spans"]], SPAN_TREE)
    names = os.listdir(obs_dir)

    def one(suffix):
        hits = [n for n in names if n.endswith(suffix)]
        if len(hits) != 1:
            fail(f"(o1) expected one *{suffix}, found {hits}")
            return None
        return os.path.join(obs_dir, hits[0])

    man = json.load(open(one(".manifest.json")))
    trace = json.load(open(one(".trace.json")))
    evs = events.read(one(".events.jsonl"))
    led = json.load(open(one(".ledger.json")))
    _expect("manifest / events / ledger problems",
            (obs.validate_manifest(man), events.validate(evs),
             ledger.validate_ledger(led)), ([], [], []))
    _expect("the events replay the trace, the ledger file is the run's",
            (events.to_chrome_trace(evs)["traceEvents"]
             == runs["on"]["chrome"]["traceEvents"]
             == trace["traceEvents"], led["digest"]
             == on.last_ledger["digest"]), (True, True))
    phases = {ph: r["events"]
              for ph, r in man["extra"]["host_transfers"]["phases"].items()}
    want = {**pulls_per_case(rec["statics_iters"],
                             rec["fowt0"]["drag_iters"]), "journal": 1}
    _expect("host pulls per phase (the pinned formula; the JAX package's "
            f"{JAX_PULLS_PER_CASE})", phases, want)
    off_phases = {ph: r["events"] for ph, r in
                  off.last_manifest.extra["host_transfers"]["phases"].items()}
    _expect("host pulls with probes off equal those with probes on",
            off_phases, phases)
    probes = _counter(runs["on"]["snap"], "raft_tpu_probe_events_total")
    _expect("probe samples (statics + drag passes)", probes,
            1 + rec["fowt0"]["drag_iters"])
    out["o1"] = dict(wall_off_s=runs["off"]["wall"],
                     wall_on_s=runs["on"]["wall"], pulls=phases,
                     launches={k: PATH_LAUNCHES[f"obs_{k}"]
                               for k in ("off", "on")},
                     card=man["environment"].get("card"))

    # (o2) phase 5's table with the health mode
    fowt = design_fowt(RC.oc3spar_design(coarse=coarse), dev)
    Hs, Tp, beta = sweep_inputs(ncases)
    nw = fowt.nw
    cond_ms = []
    sync_point = transfers.sync_point

    def timed_sync_point(fn, *a, what="", **k):
        if what != "health_cond_check":
            return sync_point(fn, *a, what=what, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sync_point(fn, *a, what=what, **k)
        torch.cuda.synchronize()
        cond_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    obs.reset_all()
    obs.configure(os.path.join(obs_dir, "health"))
    transfers.sync_point = timed_sync_point
    try:
        for mode, key in (("f64", K1), ("mixed", K3)):
            _config.set_precision_mode(mode)
            try:
                with counted(f"obs_health_{mode}", (key,)), \
                        solve_counts() as seen:
                    t0 = time.perf_counter()
                    h = sweep_cases(fowt, Hs, Tp, beta, nIter=10, tol=0.01,
                                    health=True, device=dev)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                _config.set_precision_mode(None)
            got = PATH_LAUNCHES[f"obs_health_{mode}"].get(key, 0)
            base = (PATH_LAUNCHES.get(f"sweep_{mode}", {}).get(key)
                    if not coarse else None)
            res = h["health_residual"].cpu().numpy()
            cond = h["health_cond"].cpu().numpy()
            log(f"  (o2) {mode}: {ncases} cases x {nw} bins with health in "
                f"{wall:.3f} s; launches {got} (phase 5: {base}); lanes "
                f"per launch {sorted(set(seen['sweep_lanes']))}; "
                f"health_residual max {float(np.max(res)):.3e}, health_cond "
                f"max {float(np.max(cond)):.6e}; torch.linalg.cond "
                f"{cond_ms[-1]:.2f} ms")
            if base is not None:
                _expect(f"{mode}: launches = phase 5's + 1", got, base + 1)
                ref = SWEEP_OUTS[mode]
                _expect(f"{mode}: Xi / std / iters / converged bitwise "
                        "equal to phase 5's",
                        [bool(torch.equal(h[k], ref[k]))
                         for k in ("Xi", "std", "iters", "converged")],
                        [True] * 4)
            _expect(f"{mode}: every launch at {ncases * nw} lanes",
                    sorted(set(seen["sweep_lanes"])), [ncases * nw])
            if not float(np.max(res)) <= OBS_RESID_TOL[mode]:
                fail(f"(o2) {mode}: health_residual max {np.max(res):.3e} "
                     f"above {OBS_RESID_TOL[mode]:g}")
            out[f"o2_{mode}"] = dict(
                wall_s=wall, launches=got, phase5_launches=base,
                health_residual_max=float(np.max(res)),
                health_cond_max=float(np.max(cond)),
                cond_ms=cond_ms[-1])
    finally:
        transfers.sync_point = sync_point
        obs.configure(None)
    mans = [json.load(open(os.path.join(obs_dir, "health", n)))
            for n in sorted(os.listdir(os.path.join(obs_dir, "health")))
            if n.endswith(".manifest.json")]
    _expect("(o2) sweep manifests with _health_summary",
            sorted(len(mm["extra"].get("solve_health", {})) for mm in mans),
            [7, 7])
    return out


# ---------------------------------------------------------------------------
# phase 16: co-design gradients (parallel/optimize.py)
# ---------------------------------------------------------------------------

CODESIGN_TOL = 1e-6   # the card's values and gradients against the JAX golden


def check_impedance_adjoint(G, w, M, B, C, Xbar):
    """K1 at an adjoint solve's operands: Z^H lam = Xbar is the impedance
    solve of (w, M^T, -B^T, C^T), materialized before the launch, with
    the phase's own state (every operand per lane) and right-hand side."""
    M, B, C = (M.transpose(-3, -2).contiguous(),
               (-B).transpose(-3, -2).contiguous(),
               C.transpose(-2, -1).contiguous())
    return _operand_row(G, w, M, B, C, Xbar.resolve_conj().contiguous(),
                        "adjoint_operands", "impedance_gj_adjoint")


def run_codesign(dev):
    """The co-design gradient path (models/codesign_cases.py, golden of
    tests/golden/codesign_golden.py): VolturnUS-S at its 80 bins, the
    golden's 4 lanes, metric std, through make_design_objective's
    obj.batched and the backward grad_guarded takes (inside
    obs.transfers.guard("disallow")); values and gradients against
    codesign/volturn80.json at CODESIGN_TOL, K1 launches of the forward
    (its fixed-point passes) and of the backward (one re-linearization,
    the adjoint passes, one pullback to the state); then, from one
    setup, the gradients of the objective in the fixed point's state
    leaves (M_lin, C_lin, F_lin) in f64 and under mixed (K3 in the
    backward), mixed against f64 at MIXED_STD_RTOL; then K1 at the
    adjoint solve's operands, timed like the phase 3 rows."""
    from raft_tpu_torch import _config
    from raft_tpu_torch._config import COMPLEX
    from raft_tpu_torch.models import codesign_cases as CC
    from raft_tpu_torch.models.fowt import fowt_hydro_linearization_pre
    from raft_tpu_torch.obs import transfers
    from raft_tpu_torch.ops.kernels import gj_solve as G
    from raft_tpu_torch.parallel import optimize as opt
    from raft_tpu_torch.parallel.variants import _STEP_STATE

    K1, K3 = "impedance_gj", "impedance_gj_mixed"
    rec = CC.load("volturn80")["std"]
    t0 = time.perf_counter()
    base, space = CC.build(rec, dev)
    obj = CC.objective(rec, base, space)
    solver = obj.solver
    torch.cuda.synchronize()
    res = dict(build_s=time.perf_counter() - t0, nw=base.nw,
               lanes=len(rec["lanes"]), space=rec["space"]["names"],
               solver=rec["solver"])
    X = torch.tensor(CC.lanes_x(rec), dtype=torch.float64, device=dev,
                     requires_grad=True)
    torch.cuda.reset_peak_memory_stats()
    with counted("codesign", (K1,)):
        t0 = time.perf_counter()
        v = obj.batched(X)
        torch.cuda.synchronize()
        res["forward_s"] = time.perf_counter() - t0
        fwd = G.LAUNCHES[K1]
        res["timings"] = dict(solver.timings)
        t0 = time.perf_counter()
        with transfers.guard("disallow"):
            g, = torch.autograd.grad(torch.sum(v), X)
            torch.cuda.synchronize()
        res["backward_s"] = time.perf_counter() - t0
        bwd = G.LAUNCHES[K1] - fwd
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    fp = dict(solver.fixed_point)
    res.update(fixed_point=fp, k1_forward=fwd, k1_backward=bwd)
    log(f"  codesign: {res['lanes']} lanes x {base.nw} bins on {card_line()}: "
        f"setup {res['timings']['setup']:.2f} s, fixed point "
        f"{res['timings']['fixed_point']:.3f} s (forward {res['forward_s']:.2f}"
        f" s), backward {res['backward_s']:.2f} s (guarded), build "
        f"{res['build_s']:.2f} s, peak {res['peak_gib']:.2f} GiB; passes "
        f"{fp['passes']} forward, {fp['adjoint_passes']} adjoint")
    _expect("K1 launches in the forward (its fixed-point passes)", fwd,
            fp["passes"])
    _expect("K1 launches in the backward (1 re-linearization + the adjoint "
            "passes + 1 pullback to the state)", bwd,
            fp["adjoint_passes"] + 2)
    vh, gh = v.detach().cpu().numpy(), g.cpu().numpy()
    devs = [CC.deviation(vh[i], gh[i], lane)
            for i, lane in enumerate(rec["lanes"])]
    res["value_rel_max"] = max(d[0] for d in devs)
    res["grad_rel_max"] = max(d[1] for d in devs)
    log(f"  codesign vs the JAX golden: values {vh.tolist()}, worst value "
        f"rel {res['value_rel_max']:.2e}, worst gradient component rel "
        f"{res['grad_rel_max']:.2e} (bar {CODESIGN_TOL:g})")
    if not (res["value_rel_max"] <= CODESIGN_TOL
            and res["grad_rel_max"] <= CODESIGN_TOL):
        fail(f"codesign: values / gradients off the golden "
             f"({res['value_rel_max']:.2e}, {res['grad_rel_max']:.2e})")

    # the fixed point's state leaves, f64 and mixed, from one setup
    with torch.no_grad():
        st = torch.func.vmap(solver.setup)(
            torch.func.vmap(space.to_theta)(X.detach()))
    fn, _ = opt.make_objective(rec["objective"])
    w = torch.as_tensor(base.w, dtype=torch.float64, device=dev)
    Xi0 = torch.zeros((X.shape[0], 6, base.nw), dtype=COMPLEX,
                      device=dev) + 0.1
    names = ("M_lin", "C_lin", "F_lin")
    grads, Xis = {}, {}
    for mode, key in (("f64", K1), ("mixed", K3)):
        leaves = {k: st[k].detach().clone().requires_grad_(True)
                  for k in names}
        state = {**{k: st[k] for k in _STEP_STATE}, **leaves}
        record = {}
        _config.set_precision_mode(mode)
        try:
            with counted(f"codesign_state_{mode}", (key,)):
                Xi = opt.fixed_point_implicit(
                    solver.drag_step, Xi0, state, nIter=rec["solver"]["nIter"],
                    tol=rec["solver"]["tol"], record=record)
                nf = G.LAUNCHES[key]
                loss = torch.sum(fn({"Xi": Xi}, w))
                with transfers.guard("disallow"):
                    grads[mode] = torch.autograd.grad(
                        loss, [leaves[k] for k in names])
                    torch.cuda.synchronize()
                nb = G.LAUNCHES[key] - nf
        finally:
            _config.set_precision_mode(None)
        Xis[mode] = Xi.detach()
        _expect(f"{mode}: {key} launches in the backward", nb,
                record["adjoint_passes"] + 2)
        res[f"state_{mode}"] = dict(record, forward=nf, backward=nb)
    rels = {k: float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
            for k, a, b in zip(names, grads["mixed"], grads["f64"])}
    res["state_mixed_rel"] = rels
    log(f"  codesign state gradients, mixed vs f64 (max-abs relative): "
        + ", ".join(f"{k} {r:.2e}" for k, r in rels.items()))
    if not all(r <= MIXED_STD_RTOL for r in rels.values()):
        fail(f"codesign: mixed state gradients off f64: {rels}")

    # K1 at the adjoint solve's operands: the drag linearization at the
    # f64 fixed point, the objective's gradient in Xi as right-hand side
    Xi = Xis["f64"].clone().requires_grad_(True)
    Xbar, = torch.autograd.grad(torch.sum(fn({"Xi": Xi}, w)), Xi)
    with torch.no_grad():
        B6, _ = fowt_hydro_linearization_pre(base, st["pose_eq"],
                                             st["drag_pre"], Xis["f64"])
        res["adjoint_row"] = check_impedance_adjoint(
            G, w, st["M_lin"], B6[..., None].expand_as(st["M_lin"]),
            st["C_lin"], Xbar)
    return res


def run_descent(dev):
    """The batched design descent (models/descent_cases.py, goldens of
    tests/golden/descent_golden.py): optimize_designs on VolturnUS-S, (d1)
    Adam at its 80 bins over descent/volturn80.json's lanes (the codesign
    lanes and a NaN lane), (d2) L-BFGS at 10 bins over volturn10.json's 2
    lanes (the JAX package's 80-bin L-BFGS program did not compile in one
    CPU process: LLVM ran out of memory maps after 40 minutes); each
    optimize_designs call whole inside obs.transfers.guard("disallow");
    its result held against the golden at descent_cases.CARD_BARS; K1
    launches pinned to the fixed points' passes (forward passes, and per
    gradient one re-linearization, the adjoint passes and one pullback)
    and the gradients and linesearch trials of each step to the record,
    all read from the descent's spans; per step its wall; pulls by what,
    peak memory, descents per minute.  Then the same descent once more
    through make_descent's own segment, one step at a time
    (descent_cases.stepped), for the per-step iterates, gradient norms,
    masks and linesearch steps at the card bars."""
    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.obs import tracing, transfers
    from raft_tpu_torch.ops.kernels import gj_solve as G
    from raft_tpu_torch.parallel import optimize as opt

    K1 = "impedance_gj"
    card = card_line()
    out = {}
    for tag, fname, name in (("d1", "volturn80", "adam"),
                             ("d2", "volturn10", "lbfgs")):
        rec = DC.load(fname)[name]
        t0 = time.perf_counter()
        base, space = DC.build(rec, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        pulls0 = DC.pulls_by_what()
        n0 = len(tracing.spans())
        with counted(f"descent_{tag}", (K1,)):
            with transfers.guard("disallow"):
                result = opt.optimize_designs(base, space,
                                              **DC.call_kwargs(rec))
            launches = G.LAUNCHES[K1]
        pulls = DC.pulls_between(pulls0, DC.pulls_by_what())
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, tot = DC.spans_since(n0)     # the final gradient in tot
        t1 = time.perf_counter()
        facts = DC.stepped(base, space, rec)
        stepped_s = time.perf_counter() - t1
        dev_ = DC.deviations(rec, result, facts)
        bad = DC.failures(dev_, DC.CARD_BARS)
        prov = result["provenance"]
        nl = len(rec["x0"])
        grads = tot["gradients"]
        r = dict(method=rec["method"], lanes=nl, steps=rec["steps"],
                 nw=base.nw, build_s=build_s, wall_s=prov["wall_s"],
                 totals=tot, stepped_s=stepped_s,
                 descents_per_min=60.0 * nl / prov["wall_s"],
                 peak_gib=peak, k1=launches, gradients=grads,
                 linesearch_trials=tot["linesearch_trials"], pulls=pulls,
                 value_rel_max=max(dev_["value"].values()),
                 grad_rel_max=max(dev_["grad"].values()),
                 exact_differs=dev_["exact"], per_step=steps,
                 iters=result["iters"].tolist(),
                 nonfinite=result["nonfinite"].tolist(),
                 lane_best=int(result["lane_best"]),
                 f_best=result["f_best"])
        for i, st in enumerate(steps):
            log(f"  descent {tag} ({rec['method']}) step {i}: wall "
                f"{st['wall_s']:.2f} s, gradients {st['gradients']}, "
                f"linesearch trials {st['linesearch_trials']}, setup "
                f"{st['setup_s']:.2f} s, fixed point "
                f"{st['fixed_point_s']:.3f} s, backward "
                f"{st['backward_s']:.2f} s; passes {st['passes']} "
                f"forward, {st['adjoint_passes']} adjoint; {card}")
        log(f"  descent {tag}: {nl} lanes x {base.nw} bins, {rec['steps']} "
            f"step(s) of {rec['method']} on {card}: wall {prov['wall_s']:.2f}"
            f" s ({r['descents_per_min']:.3f} descents/min), {grads} "
            f"gradients ({tot['linesearch_trials']} linesearch trials, 1 "
            f"final), setup {tot['setup_s']:.2f} s, backward "
            f"{tot['backward_s']:.2f} s, build {build_s:.2f} s, peak "
            f"{peak:.2f} GiB; pulls {pulls}; the stepped rerun "
            f"{stepped_s:.2f} s")
        log(f"  descent {tag} vs the JAX golden: worst value rel "
            f"{r['value_rel_max']:.2e}, worst gradient-norm rel "
            f"{r['grad_rel_max']:.2e} (bars {DC.CARD_BARS}); iters "
            f"{r['iters']}, nonfinite {r['nonfinite']}, best lane "
            f"{r['lane_best']}; linesearch steps "
            f"{[f['ls_steps'].tolist() for f in facts if 'ls_steps' in f]}")
        if bad:
            fail(f"descent {tag}: off the golden: {bad}")
        _expect(f"descent {tag}: K1 launches (forward passes + per gradient"
                " 1 re-linearization + the adjoint passes + 1 pullback)",
                launches, tot["passes"] + tot["adjoint_passes"] + 2 * grads)
        trials = (DC.expected_trials(rec) if rec["method"] == "lbfgs"
                  else [0] * rec["steps"])
        _expect(f"descent {tag}: linesearch trials a step (the slowest "
                "live lane's steps)",
                [st["linesearch_trials"] for st in steps], trials)
        _expect(f"descent {tag}: gradients a step (1, and 1 a linesearch "
                "trial)", [st["gradients"] for st in steps],
                [1 + t for t in trials])
        _expect(f"descent {tag}: gradients (1 a step, 1 a linesearch trial,"
                " 1 final)", grads, rec["steps"] + sum(trials) + 1)
        _expect(f"descent {tag}: host pulls by what", pulls,
                DC.expected_pulls(rec, grads, ls_tests=(
                    sum(trials) + rec["steps"]
                    if rec["method"] == "lbfgs" else 0)))
        out[tag] = r
        RESULTS[tag] = result
    out["d3"] = run_descent_ckpt(dev, RESULTS["d1"])
    return out


#: optimize_designs results of phase 17 by tag (d3 holds d1's)
RESULTS: dict = {}


def run_descent_ckpt(dev, mono):
    """(d3): d1's call with checkpoint_every=1 into a CheckpointStore
    under --out, bitwise equal to d1's monolithic result ``mono``; a child
    process killed by kill@optimize:step=1 (exit 137) after its step-1
    checkpoint; this process's resume from it, bitwise equal to d1; the
    segmented run's checkpoint read corrupt (the resume falls back to
    step 0) and an ENOSPC shed (no checkpoint written), each bitwise equal
    to d1.  Every call of this process whole inside
    obs.transfers.guard("disallow")."""
    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.obs import transfers
    from raft_tpu_torch.parallel import optimize as opt
    from raft_tpu_torch.serve.checkpoint import CheckpointStore
    from raft_tpu_torch.testing import faults

    K1 = "impedance_gj"
    card = card_line()
    rec = DC.load("volturn80")["adam"]
    base, space = DC.build(rec, dev)
    store_dir = os.path.join(OUT, "descent_d3_ckpt")
    shutil.rmtree(store_dir, ignore_errors=True)
    r = {}
    # the segmented run keeps its step-1 checkpoint for the corrupt
    # fallback below (a finished descent deletes its checkpoints)
    keep = CheckpointStore(store_dir)
    keep.delete = lambda key, step=None: None
    pulls0 = DC.pulls_by_what()
    with counted("descent_d3", (K1,)):
        t0 = time.perf_counter()
        with transfers.guard("disallow"):
            seg = opt.optimize_designs(
                base, space, checkpoint_every=1, ckpt_store=keep,
                ckpt_key="sha256:d3segmented", **DC.call_kwargs(rec))
        r["segmented_wall_s"] = time.perf_counter() - t0
    r["segmented_pulls"] = DC.pulls_between(pulls0, DC.pulls_by_what())
    r["segmented_differs"] = DC.bitwise_differs(seg, mono)
    prov = seg["provenance"]
    log(f"  descent d3: segmented (1 step a segment, {prov['segments']} "
        f"segments, {prov['ckpt_writes']} checkpoint(s)) in "
        f"{r['segmented_wall_s']:.2f} s on {card}; bitwise d1 except "
        f"{r['segmented_differs']}; pulls {r['segmented_pulls']}")
    if r["segmented_differs"]:
        fail(f"descent d3: segmented differs from d1 in "
             f"{r['segmented_differs']}")
    _expect("descent d3: checkpoint pulls (one a segment before the last)",
            r["segmented_pulls"].get("optimize_checkpoint", 0),
            rec["steps"] - 1)
    spec = {"golden": "volturn80", "name": "adam", "device": "cuda",
            "store": store_dir, "key": "sha256:d3killed", "every": 1}
    env = dict(os.environ, RAFT_TPU_FAULTS="kill@optimize:step=1")
    t0 = time.perf_counter()
    child = subprocess.run(DC.child_command(spec), env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
    r["child_exit"] = child.returncode
    r["child_wall_s"] = time.perf_counter() - t0
    steps = CheckpointStore(store_dir).steps(spec["key"])
    log(f"  descent d3: child under kill@optimize:step=1 exited "
        f"{child.returncode} after {r['child_wall_s']:.2f} s; its "
        f"checkpoints {steps}")
    if child.returncode != 137 or steps != [1]:
        fail(f"descent d3: the killed child exited {child.returncode} with "
             f"checkpoints {steps}: {child.stderr[-1500:]}")
        return r
    with counted("descent_d3_resume", (K1,)):
        t0 = time.perf_counter()
        with transfers.guard("disallow"):
            res = opt.optimize_designs(
                base, space, checkpoint_every=1,
                ckpt_store=CheckpointStore(store_dir), ckpt_key=spec["key"],
                **DC.call_kwargs(rec))
        r["resumed_wall_s"] = time.perf_counter() - t0
    r["resumed_from_step"] = res["resumed_from_step"]
    r["resumed_differs"] = DC.bitwise_differs(res, mono)
    log(f"  descent d3: resumed from step {res['resumed_from_step']} in "
        f"{r['resumed_wall_s']:.2f} s; bitwise d1 except "
        f"{r['resumed_differs']}")
    _expect("descent d3: resumed_from_step", res["resumed_from_step"], 1)
    if r["resumed_differs"]:
        fail(f"descent d3: the resumed descent differs from d1 in "
             f"{r['resumed_differs']}")
    # the segmented run's checkpoint read corrupt: dropped, counted, the
    # resume falls back one segment (to step 0); then an ENOSPC shed
    for tag, spec_, key in (("corrupt", "corrupt@checkpoint:once",
                             "sha256:d3segmented"),
                            ("shed", "enospc@checkpoint", "sha256:d3shed")):
        store = CheckpointStore(store_dir)
        faults.install(spec_)
        try:
            with counted(f"descent_d3_{tag}", (K1,)):
                t0 = time.perf_counter()
                with transfers.guard("disallow"):
                    got = opt.optimize_designs(
                        base, space, checkpoint_every=1, ckpt_store=store,
                        ckpt_key=key, **DC.call_kwargs(rec))
                r[f"{tag}_wall_s"] = time.perf_counter() - t0
        finally:
            faults.clear()
        r[f"{tag}_differs"] = DC.bitwise_differs(got, mono)
        st = store.stats()
        prov = got["provenance"]
        log(f"  descent d3: under {spec_} in {r[f'{tag}_wall_s']:.2f} s: "
            f"resumed from step {got['resumed_from_step']}, corrupt "
            f"{st['corrupt']}, enospc {st['enospc']}, checkpoint writes "
            f"{prov['ckpt_writes']}, shed {prov['ckpt_shed']}; bitwise d1 "
            f"except {r[f'{tag}_differs']}")
        if tag == "corrupt":
            ok = got["resumed_from_step"] == 0 and st["corrupt"] == 1
        else:
            ok = prov["ckpt_shed"] is True and prov["ckpt_writes"] == 0 \
                and st["enospc"] == 1
        if not ok or r[f"{tag}_differs"]:
            fail(f"descent d3 {tag}: {st}, provenance {prov}, differs "
                 f"{r[f'{tag}_differs']}")
    return r


# ---------------------------------------------------------------------------
# phase 18: the partition layer
# ---------------------------------------------------------------------------

#: (f3)'s inputs, kept by phase 11 for phase 18 (the same worker)
F3_INPUTS: dict = {}


def _shard_devices():
    """Two shards: two cards when there are, else cuda:0 twice."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(2)]


def _p1_pair(label, keys, plain, sharded, rtol=0.0, expect=()):
    """Run ``plain`` and ``sharded`` (each counted as its own path), hold
    the sharded result to the plain one (partition_cases.parity) and its
    counted pulls to the plain one's; returns the record."""
    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.models import partition_cases as PC

    rec = {}
    outs = {}
    for tag, fn in (("", plain), ("_mesh", sharded)):
        p0 = DC.pulls_by_what()
        with counted(f"partition_{label}{tag}", expect):
            t0 = time.perf_counter()
            outs[tag] = fn()
            torch.cuda.synchronize()
            rec[f"wall{tag or '_plain'}_s"] = time.perf_counter() - t0
        rec[f"pulls{tag or '_plain'}"] = DC.pulls_between(p0,
                                                          DC.pulls_by_what())
    par = PC.parity(outs["_mesh"], outs[""], keys, rtol=rtol)
    bad = PC.failures(par)
    launches = PATH_LAUNCHES[f"partition_{label}_mesh"]
    rec.update(dev=par["dev"], bitwise=par["bitwise"], exact=par["exact"],
               launches_plain=PATH_LAUNCHES[f"partition_{label}"],
               launches_mesh=launches,
               launches_per_shard={k: v / 2 for k, v in launches.items()})
    same_pulls = rec["pulls_mesh"] == rec["pulls_plain"]
    log(f"  p1 {label}: plain {rec['wall_plain_s']:.3f} s, sharded "
        f"{rec['wall_mesh_s']:.3f} s; worst |dev| "
        + ", ".join(f"{k} {v:.2e}" for k, v in par["dev"].items())
        + f"; bitwise {par['bitwise']}; exact facts differ {par['exact']}; "
        f"K1/K3 launches per shard {rec['launches_per_shard']} (plain "
        f"{rec['launches_plain']}); pulls equal {same_pulls} "
        f"({rec['pulls_mesh']})")
    if bad:
        fail(f"p1 {label}: sharded vs unsharded: {bad}")
    if not same_pulls:
        fail(f"p1 {label}: pulls {rec['pulls_mesh']} against the "
             f"unsharded {rec['pulls_plain']}")
    return rec, outs


def run_partition(dev):
    """Phase 18 (p1): the batched entry points on a mesh of two shards
    against their unsharded calls (see the module docstring)."""
    from raft_tpu_torch import _config
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.models import farm_cases as FC
    from raft_tpu_torch.models import partition_cases as PC
    from raft_tpu_torch.obs import transfers
    from raft_tpu_torch.parallel import optimize as opt
    from raft_tpu_torch.parallel import partition
    from raft_tpu_torch.parallel import variants as vr
    from raft_tpu_torch.parallel.sweep import (
        design_fowt, sweep_cases, sweep_farm)

    card = card_line()
    devs = _shard_devices()
    two = devs[0] != devs[1]
    log(f"  p1: a mesh of two shards on {'two cards' if two else 'one card: cuda:0 twice'} "
        f"({', '.join(map(str, devs))}); {card}")
    mesh = partition.make_mesh((2,), ("cases",), devs)
    out = {"two_cards": two, "devices": [str(d) for d in devs]}
    # phase 5's table, f64 and mixed
    fowt = design_fowt("OC3spar", devs[0])
    Hs, Tp, beta = sweep_inputs(SWEEP_CASES)
    for mode, k in (("f64", "impedance_gj"), ("mixed", "impedance_gj_mixed")):
        _config.set_precision_mode(mode)
        try:
            out[f"sweep_{mode}"], _ = _p1_pair(
                f"sweep_{mode}", PC.SWEEP_KEYS,
                lambda: sweep_cases(fowt, Hs, Tp, beta, nIter=10, tol=0.01,
                                    device=devs[0]),
                lambda: sweep_cases(fowt, Hs, Tp, beta, nIter=10, tol=0.01,
                                    mesh=mesh), expect=(k,))
        finally:
            _config.set_precision_mode(None)
    # 16 VolturnUS-S variants
    design = load_design("VolturnUS-S")
    thetas, _ = vr.volturn_grid(design)
    thetas = {k: v[:16] for k, v in thetas.items()}
    base = design_fowt(design, devs[0])
    kw = dict(Hs=6.0, Tp=12.0, ballast=True, nIter=10, newton_iters=20)
    out["variants"], _ = _p1_pair(
        "variants", PC.VARIANT_KEYS,
        lambda: vr.sweep_variants(base, thetas, device=devs[0], **kw),
        lambda: vr.sweep_variants(base, thetas, mesh=mesh, **kw),
        rtol=PC.VARIANT_RTOL, expect=("impedance_gj",))
    # (f3): 4 turbines x 256 cases
    if not F3_INPUTS:
        fail("p1 farm: phase 11's (f3) inputs are missing")
    else:
        f3 = F3_INPUTS
        c = f3["cases"]
        args = (FC.F3_LAYOUT, c["Hs"], c["Tp"], c["beta"], c["U_inf"],
                c["wind_dir"])
        fkw = dict(curve=f3["curve"], nIter=f3["nIter"],
                   XiStart=f3["XiStart"])
        out["farm"], _ = _p1_pair(
            "farm", PC.FARM_KEYS,
            lambda: sweep_farm(f3["fowt"], *args, device=devs[0], **fkw),
            lambda: sweep_farm(f3["fowt"], *args, mesh=mesh, **fkw),
            expect=("impedance_gj",))
    # one Adam step of d1's lanes (5, padded to 6), guarded
    rec = DC.record("volturn80", "adam", steps=1)
    dbase, space = DC.build(rec, devs[0])
    p0 = DC.pulls_by_what()
    with counted("partition_descent_mesh", ("impedance_gj",)):
        t0 = time.perf_counter()
        with transfers.guard("disallow"):
            res = opt.optimize_designs(dbase, space, mesh=mesh,
                                       **DC.call_kwargs(rec))
        wall = time.perf_counter() - t0
    pulls = DC.pulls_between(p0, DC.pulls_by_what())
    want = DC.expected_pulls(rec, gradients=2)
    step0 = DC.load("volturn80")["adam"]["trace"][0]
    xrel = DC._rel(res["x"], step0["x_next"])
    orel = DC._rel(res["obj_trace"][0], step0["obj_trace"])
    launches = PATH_LAUNCHES["partition_descent_mesh"]
    out["descent"] = dict(wall_s=wall, pulls=pulls, x_rel=xrel,
                          obj_rel=orel, launches=launches,
                          mesh=res["provenance"]["mesh"])
    log(f"  p1 descent: 1 Adam step of d1's 5 lanes on the mesh in "
        f"{wall:.2f} s; vs d1's golden step 0: x rel {xrel:.2e}, "
        f"objective rel {orel:.2e} (bar {DC.CARD_BARS['value']:g}); K1 per "
        f"shard {launches.get('impedance_gj', 0) / 2}; pulls {pulls}")
    if not (xrel <= DC.CARD_BARS["value"] and orel <= DC.CARD_BARS["value"]):
        fail(f"p1 descent: x rel {xrel:.2e}, objective rel {orel:.2e}")
    _expect("p1 descent: pulls (the unsharded descent's)", pulls, want)
    return out


# ---------------------------------------------------------------------------
# phase 19: the serving path
# ---------------------------------------------------------------------------

SERVE_WAIT = 900.0    # a ticket's wait (s); every wait has one


def _serve_dir(name):
    d = os.path.join(OUT, "serve", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def _served_rows(results, label):
    """The held rows of served results; fail on a failed request."""
    from raft_tpu_torch.models import serve_cases as SC

    bad = [r.error for r in results if not r.ok]
    if bad:
        fail(f"{label}: {len(bad)} request(s) failed: {bad[:3]}")
    return [SC.row(r) for r in results if r.ok]


def _bitwise_batches(label, results, solver, Hs, Tp, beta, batch):
    """Each served std against ``solver.batched`` on its batch's lanes,
    bit for bit, and its digest against digest_metrics of those; returns
    the reference batches' fp_chunks."""
    from raft_tpu_torch.ledger import digest_metrics

    chunks, off = [], 0
    for b in range(0, len(results), batch):
        sl = slice(b, b + batch)
        ref = solver.batched(Hs[sl], Tp[sl], beta[sl])
        std, it, cv = (ref[k].cpu().numpy()
                       for k in ("std", "iters", "converged"))
        chunks.append(int(ref["fp_chunks"]))
        for i, r in enumerate(results[sl]):
            want = digest_metrics({"std": std[i], "iters": int(it[i]),
                                   "converged": bool(cv[i])})
            if not (np.array_equal(np.asarray(r.std), std[i])
                    and r.iters == int(it[i]) and r.digest == want):
                off += 1
    log(f"  {label}: {len(results)} results bitwise the batched solver "
        f"(std, iters, digest): {len(results) - off}/{len(results)}")
    if off:
        fail(f"{label}: {off} result(s) differ from the batched solver")
    return chunks


def run_serve(dev):
    """Phase 19 (see the module docstring): (s1)-(s8) on VolturnUS-S at
    its 80 bins."""
    import threading
    import urllib.request

    from raft_tpu_torch import _config
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.models import farm_cases as FC
    from raft_tpu_torch.models import serve_cases as SC
    from raft_tpu_torch.obs import transfers
    from raft_tpu_torch.ops.kernels import gj_solve as G
    from raft_tpu_torch.parallel import optimize as opt
    from raft_tpu_torch.parallel.sweep import make_case_solver, sweep_farm
    from raft_tpu_torch.serve import ServeConfig, SweepService
    from raft_tpu_torch.serve.http import make_serve_server

    K1, K3 = "impedance_gj", "impedance_gj_mixed"
    card = card_line()
    gold = SC.load()
    out = {"card": card}
    design = load_design(SC.DESIGN)
    t0 = time.perf_counter()
    model = Model(design, device=dev)
    if not np.array_equal(model.w, np.asarray(gold["w"])):
        fail("serve: the model's grid is not the golden's")
    svc = model.make_service(batch_cases=SC.BATCH,
                             journal_dir=_serve_dir("wal"),
                             store_dir=_serve_dir("store"))
    fowt = svc.fowt
    solver = make_case_solver(fowt)
    runner = svc._ensure_runner("full")
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["runner_build_s"] = runner.build_s
    log(f"  serve: Model, coarse rung and runner built in "
        f"{out['build_s']:.2f} s (runner {runner.build_s:.2f} s, warm-up "
        f"batch included); ladder {'->'.join(svc.ladder)}; {card}")

    # (s1) 24 requests before start(): 3 batches of 8
    Hs, Tp, beta = SC.s1_requests()
    tickets = [svc.submit(float(h), float(t), float(b))
               for h, t, b in zip(Hs, Tp, beta)]
    p0 = DC.pulls_by_what()
    with counted("serve_s1", (K1,)):
        with transfers.guard("disallow"):
            t1 = time.perf_counter()
            svc.start()
            s1 = [t.result(SERVE_WAIT) for t in tickets]
            wall = time.perf_counter() - t1
        k1 = G.LAUNCHES[K1]
    pulls = DC.pulls_between(p0, DC.pulls_by_what())
    rows = _served_rows(s1, "s1")
    chunks = _bitwise_batches("s1", s1, solver, Hs, Tp, beta, SC.BATCH)
    worst, differ = SC.deviation(rows, gold["s1"])
    summ = svc.summary()
    out["s1"] = dict(
        wall_s=wall, batch_wall_s=wall / SC.NBATCH, k1=k1, pulls=pulls,
        fp_chunks=chunks, golden_rel=worst, golden_differ=differ,
        batches=summ["batches"], phase_solve_p50_s=summ.get(
            "phase_solve_p50_s"), ema_batch_s=summ["ema_batch_s"],
        iters=[r["iters"] for r in rows])
    log(f"  s1: {len(s1)} requests, {summ['batches']} batches of "
        f"{SC.BATCH} in {wall:.3f} s ({wall / SC.NBATCH:.3f} s a batch, "
        f"solve phase p50 {summ.get('phase_solve_p50_s')}); K1 launches "
        f"{k1} ({k1 / SC.NBATCH:.1f} a batch), pulls {pulls} "
        f"({pulls.get('serve_batch', 0) / SC.NBATCH:.1f} serve_batch a "
        f"batch); vs the JAX golden worst std rel {worst:.2e} (bar "
        f"{SC.GOLDEN_RTOL:g}), iters/converged/seq differ at {differ}; "
        f"{card}")
    _expect("s1 batches", summ["batches"], SC.NBATCH)
    _expect("s1 K1 launches (2 a fixed-point chunk)", k1, 2 * sum(chunks))
    _expect("s1 counted pulls", pulls,
            {"serve_batch": SC.NBATCH, "sweep_fp_chunk": 5 * SC.NBATCH})
    if worst > SC.GOLDEN_RTOL or differ:
        fail(f"s1 off the JAX golden: worst std rel {worst:.2e}, "
             f"differ {differ}")

    # (s2) resubmissions: the store answers, nothing launches
    lat = []
    with counted("serve_s2", ()):
        s2 = []
        for i in range(0, 24, 3):
            t2 = time.perf_counter()
            s2.append(svc.submit(float(Hs[i]), float(Tp[i]),
                                 float(beta[i])).result(SERVE_WAIT))
            lat.append(1e3 * (time.perf_counter() - t2))
        k1 = sum(G.LAUNCHES.values())
    same = [r.digest == s1[i].digest and r.source == "cached"
            for r, i in zip(s2, range(0, 24, 3))]
    out["s2"] = dict(latency_ms=lat, launches=k1, equal=sum(same))
    log(f"  s2: 8 resubmissions from the store, {sum(same)}/8 with s1's "
        f"digest, launches {k1}; latency ms min {min(lat):.3f} median "
        f"{float(np.median(lat)):.3f} max {max(lat):.3f}; {card}")
    _expect("s2 launches", k1, 0)
    _expect("s2 results equal to s1's, from the store", sum(same), 8)

    # (s3) a new service on the same journal: recovered, no solve
    with counted("serve_s3", ()):
        svc3 = SweepService(fowt, ServeConfig(
            batch_cases=SC.BATCH, journal_dir=svc.cfg.journal_dir),
            device=dev)
        info = svc3.recover()
        got = [svc3.fetch(r.digest) for r in s1]
        svc3.stop(timeout=SERVE_WAIT)
        k1 = sum(G.LAUNCHES.values())
    ok3 = sum(g is not None and g.std == r.std and g.source == "recovered"
              for g, r in zip(got, s1))
    out["s3"] = dict(recovered=info["recovered"], replayed=info["replayed"],
                     equal=ok3, launches=k1)
    log(f"  s3: recovered {info['recovered']}, replayed "
        f"{info['replayed']}, {ok3}/24 equal to s1's; launches {k1}")
    _expect("s3 recovered results", info["recovered"], 24)
    _expect("s3 equal to s1", ok3, 24)
    _expect("s3 launches", k1, 0)

    # (s4) warm starts over a fresh store
    svc4 = SweepService(fowt, ServeConfig(store_dir=_serve_dir("warm"),
                                          **SC.WARM_CONFIG), device=dev)
    svc4._ensure_runner("full")
    wH, wT, wb = SC.warm_requests()
    tickets = [svc4.submit(float(h), float(t), float(b))
               for h, t, b in zip(wH, wT, wb)]
    with counted("serve_s4", (K1,)):
        with transfers.guard("disallow"):
            t4 = time.perf_counter()
            svc4.start()
            s4 = [t.result(SERVE_WAIT) for t in tickets]
            wall = time.perf_counter() - t4
        k1 = G.LAUNCHES[K1]
    summ4 = svc4.stop(timeout=SERVE_WAIT)
    rows4 = _served_rows(s4, "s4")
    worst4, differ4 = SC.deviation(rows4, gold["warm"])
    facts = {k: summ4[k] for k in SC.WARM_FACTS}
    cold = solver.batched(wH[8:16], wT[8:16], wb[8:16])["iters"]
    warm_it = [r["iters"] for r in rows4[8:16]]
    out["s4"] = dict(wall_s=wall, k1=k1, facts=facts, golden_rel=worst4,
                     golden_differ=differ4, warm_iters=warm_it,
                     cold_iters=cold.cpu().tolist(),
                     iter_savings=summ4["warm_start_iter_savings"])
    log(f"  s4: {len(s4)} requests (batch 0 cold, 1 seeded, 2 seeded and "
        f"audited) in {wall:.3f} s, K1 {k1}; facts {facts} (golden "
        f"{gold['warm_facts']}); batch 1 iterations warm {warm_it} vs "
        f"cold {cold.cpu().tolist()}, savings "
        f"{summ4['warm_start_iter_savings']}; vs the JAX golden worst std "
        f"rel {worst4:.2e} (bar {SC.GOLDEN_RTOL:g}), differ at {differ4}")
    _expect("s4 warm facts", facts, gold["warm_facts"])
    _expect("s4 audit mismatches", facts["warm_start_digest_mismatch"], 0)
    if worst4 > SC.GOLDEN_RTOL or differ4:
        fail(f"s4 off the JAX golden: {worst4:.2e}, differ {differ4}")

    # (s5) the HTTP front door on the s1 service
    srv = make_serve_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = "http://%s:%d" % srv.server_address[:2]

    def call(path, doc=None):
        data = None if doc is None else json.dumps(doc).encode()
        req = urllib.request.Request(base + path, data=data,
                                     method="GET" if doc is None else "POST")
        with urllib.request.urlopen(req, timeout=SERVE_WAIT) as r:
            return r.status, r.read()

    try:
        with counted("serve_s5", (K1,)):
            code_a, body = call("/submit", {"hs": float(Hs[4]),
                                            "tp": float(Tp[4]),
                                            "heading_rad": float(beta[4])})
            rid = json.loads(body)["request_id"]
            code_b, body = call("/submit", {"hs": 3.3, "tp": 11.1,
                                            "heading_deg": 20.0,
                                            "wait": True})
            new = json.loads(body)
            k1 = G.LAUNCHES[K1]
        code_r, body = call(f"/result?id={rid}")
        rep = json.loads(body)
        code_s, body = call("/stats")
        stats = json.loads(body)
        code_h, _ = call("/healthz")
        code_m, body = call("/metrics")
        metrics = body.decode()
        out["s5"] = dict(codes=[code_a, code_b, code_r, code_s, code_h,
                                code_m], repeat_digest_equal=(
                                    rep.get("digest") == s1[4].digest),
                         new_ok=bool(new.get("ok")), k1=k1,
                         completed=stats.get("completed"))
        log(f"  s5: HTTP {base}: codes {out['s5']['codes']}; the repeated "
            f"s1 request's digest equal {out['s5']['repeat_digest_equal']}"
            f" (source {rep.get('source')}); the new one ok "
            f"{out['s5']['new_ok']} (K1 {k1}); /stats completed "
            f"{stats.get('completed')}; /metrics "
            f"{len(metrics.splitlines())} lines")
        if out["s5"]["codes"] != [202, 200, 200, 200, 200, 200] or not (
                out["s5"]["repeat_digest_equal"] and out["s5"]["new_ok"]
                and "raft_tpu_serve_requests_total" in metrics):
            fail(f"s5: the front door answered {out['s5']}")

        # (s7) one /farm request: (f3)'s layout x 8 cases.  A first
        # request on the same layout, case count and k_w (other cases,
        # so that it is not deduped) builds the farm runner and its
        # warm-up batch outside the counted request.
        def farm_spec(c):
            return {"layout": FC.F3_LAYOUT.tolist(), "wait": True,
                    **{k: c[k].tolist() for k in ("Hs", "Tp", "beta",
                                                  "U_inf", "wind_dir")}}

        t7 = time.perf_counter()
        code_w, body = call("/farm", farm_spec(FC.f3_cases(8, seed=1)))
        first_wall = time.perf_counter() - t7
        if code_w != 200 or not json.loads(body).get("ok"):
            fail(f"s7: the runner-building /farm request failed ({code_w})")
        c = FC.f3_cases(8)
        with counted("serve_s7", (K1,)):
            t7 = time.perf_counter()
            code_f, body = call("/farm", farm_spec(c))
            wall = time.perf_counter() - t7
            k1 = G.LAUNCHES[K1]
        farm = json.loads(body)
    finally:
        srv.shutdown()
        srv.server_close()
    ref = sweep_farm(fowt, FC.F3_LAYOUT, c["Hs"], c["Tp"], c["beta"],
                     c["U_inf"], c["wind_dir"], device=dev, k_w=0.05)
    ex = farm.get("extra") or {}
    eq = (code_f == 200 and farm.get("ok") and farm.get("source") == "solved"
          and np.array_equal(np.asarray(ex.get("std")),
                             ref["std"].cpu().numpy())
          and np.array_equal(np.asarray(ex.get("U_wake")),
                             ref["U_wake"].cpu().numpy()))
    out["s7"] = dict(wall_s=wall, first_wall_s=first_wall, k1=k1,
                     fp_chunks=int(ref["fp_chunks"]), bitwise=bool(eq),
                     turbines=len(FC.F3_LAYOUT), cases=8,
                     build_s=(ex.get("provenance") or {}).get("build_s"))
    log(f"  s7: /farm {len(FC.F3_LAYOUT)} turbines x 8 cases in "
        f"{wall:.3f} s on the warm runner (the first request, which built "
        f"it in {out['s7']['build_s']} s: {first_wall:.2f} s), K1 {k1}; "
        f"bitwise sweep_farm (std, U_wake): {bool(eq)}; {card}")
    if not eq:
        fail(f"s7: the farm answer differs from sweep_farm ({code_f})")
    _expect("s7 K1 launches (2 a fixed-point chunk)", k1,
            2 * int(ref["fp_chunks"]))

    # (s8) one optimize request: d1's space and objective, 2 lanes, 1 step
    rec = DC.load("volturn80")["adam"]
    sp = rec["space"]
    spec = {"bounds": {n: [lo, hi] for n, lo, hi in
                       zip(sp["names"], sp["lower"], sp["upper"])},
            "objective": rec["objective"], "nlanes": 2, "steps": 1,
            "method": rec["method"], "lr": rec["lr"], "gtol": rec["gtol"],
            "seed": 0, "nIter": rec["solver"]["nIter"],
            "tol": rec["solver"]["tol"]}
    with counted("serve_s8", (K1,)):
        with transfers.guard("disallow"):
            t8 = time.perf_counter()
            res = svc.submit_optimize(dict(spec)).result(SERVE_WAIT)
            wall = time.perf_counter() - t8
        k1 = G.LAUNCHES[K1]
    norm = opt.normalize_request(spec)
    with transfers.guard("disallow"):
        direct = opt.optimize_designs(
            fowt, opt.DesignSpace(fowt, {k: tuple(v) for k, v in
                                         norm["bounds"].items()}),
            objective=norm["objective"], nlanes=norm["nlanes"],
            steps=norm["steps"], method=norm["method"], lr=norm["lr"],
            gtol=norm["gtol"], seed=norm["seed"], nIter=norm["nIter"],
            tol=norm["tol"])
    ex = res.extra or {}
    eq = (res.ok and ex.get("design") == direct["design"]
          and ex.get("f_best") == direct["f_best"]
          and (ex.get("provenance") or {}).get("objective_trace") == [
              float(v) for v in direct["obj_trace"][:, direct["lane_best"]]])
    out["s8"] = dict(wall_s=wall, k1=k1, bitwise=bool(eq),
                     f_best=ex.get("f_best"), design=ex.get("design"))
    log(f"  s8: submit_optimize (2 lanes, 1 Adam step) in {wall:.2f} s, "
        f"K1 {k1}; bitwise optimize_designs (design, f_best, trace): "
        f"{bool(eq)}; {card}")
    if not eq:
        fail(f"s8: the optimize answer differs from optimize_designs: "
             f"{ex.get('design')} vs {direct['design']}")
    summ = svc.stop(timeout=SERVE_WAIT)
    out["summary"] = {k: summ[k] for k in (
        "admitted", "completed", "failed", "batches", "store_hits",
        "unhandled", "retries", "p50_latency_s", "p99_latency_s")}
    if summ["failed"] or summ["unhandled"]:
        fail(f"serve: failed {summ['failed']}, unhandled "
             f"{summ['unhandled']}")

    # (s6) batch 64 (5,120 K1 lanes a batch), f64 then mixed (K3)
    H6, T6, b6 = SC.s1_requests(64, seed=SC.SEED + 1)
    for mode, key in (("f64", K1), ("mixed", K3)):
        _config.set_precision_mode(None if mode == "f64" else "mixed")
        try:
            svc6 = SweepService(fowt, ServeConfig(batch_cases=64),
                                device=dev)
            svc6._ensure_runner("full")
            tickets = [svc6.submit(float(h), float(t), float(b))
                       for h, t, b in zip(H6, T6, b6)]
            with counted(f"serve_s6_{mode}", (key,)):
                with transfers.guard("disallow"):
                    t6 = time.perf_counter()
                    svc6.start()
                    s6 = [t.result(SERVE_WAIT) for t in tickets]
                    wall = time.perf_counter() - t6
                k = G.LAUNCHES[key]
            svc6.stop(timeout=SERVE_WAIT)
            _served_rows(s6, f"s6 {mode}")
            chunks = _bitwise_batches(f"s6 {mode}", s6,
                                      make_case_solver(fowt), H6, T6, b6,
                                      64)
        finally:
            _config.set_precision_mode(None)
        out[f"s6_{mode}"] = dict(wall_s=wall, launches=k, fp_chunks=chunks,
                                 lanes=64 * fowt.nw)
        log(f"  s6 {mode}: 64 requests, one batch of {64 * fowt.nw} "
            f"lanes, in {wall:.3f} s; {key} launches {k}; {card}")
        _expect(f"s6 {mode} {key} launches", k, 2 * sum(chunks))
    return out


# kernel line: (JSON name, launch key, TPU kernel it replaces, CUDA source,
# the main-path shape its times are taken at)
KERNELS = (
    ("K1 impedance_gj", "impedance_gj", "raft_tpu/ops/pallas/gj_solve.py:402",
     "raft_tpu_torch/csrc/gj_k1_f64.cu", 81920),
    ("K2 gj_solve", "gj_solve", "raft_tpu/ops/pallas/gj_solve.py:216",
     "raft_tpu_torch/csrc/gj_k2_f64.cu", 80),
    ("K3 impedance_gj_mixed", "impedance_gj_mixed",
     "raft_tpu/ops/pallas/gj_solve.py:424",
     "raft_tpu_torch/csrc/gj_k3_mixed_f32.cu", 81920),
    ("K4 gj_solve_mixed", "gj_solve_mixed",
     "raft_tpu/ops/pallas/gj_solve.py:233",
     "raft_tpu_torch/csrc/gj_k4_mixed_f32.cu", 80),
    # lanes = pairs: the OC4semi example's 30 x 30 grid
    ("K5 qtf_pair_grid", "qtf_pair", "raft_tpu/ops/pallas/qtf_pair.py:381",
     "raft_tpu_torch/csrc/qtf_k5_f64.cu", 900),
)

#: the drivers of phases 4-13 and 16-19, by name
PHASE_RUNS = {
    "main": run_main, "sweep": run_sweeps, "variants": run_variants,
    "golden": lambda dev: run_goldens(dev, "f64"),
    "golden_mixed": lambda dev: run_goldens(dev, "mixed"),
    "qtf": run_qtf, "potflow": run_potflow, "mhk": run_mhk,
    "farm": run_farm, "mcf": run_mcf, "ballast": run_ballast,
    "codesign": run_codesign, "descent": run_descent,
    "partition": run_partition, "serve": run_serve}
#: phases 4-6 (then 14 and 15) run in this process; phases 7-13 and
#: 16-19 run in these groups, one worker process each (``--worker``), on the
#: same card at the same time, started after phase 3 and joined after
#: phase 15.  Each phase is host-bound (the card is idle most of a Model
#: run), so the groups overlap instead of queueing.
PARENT_PHASES = ("main", "sweep", "variants")
WORKER_GROUPS = (("mhk", "serve"), ("farm", "mcf", "partition"),
                 ("golden", "golden_mixed", "qtf", "potflow", "ballast",
                  "codesign"), ("descent",))
WORKER_TIMEOUT_S = 900   # from their start; the script's own limit is 1200


def run_phase(name, dev):
    log(f"{name}: on the card")
    t0 = time.perf_counter()
    out = PHASE_RUNS[name](dev)
    PHASE_WALLS[name] = time.perf_counter() - t0
    log(f"{name}: {PHASE_WALLS[name]:.1f} s")
    return out


def _worker_tag(names) -> str:
    return "worker_" + "_".join(names)


def run_worker(names, dev) -> int:
    """``--worker NAMES``: run the named phases of 7-13, 16-19 here (each
    Model run and sweep checked as a clean path) and write their record
    (results, launches by path, rows, walls, failures, clean-path counts)
    to OUT/<tag>.json."""
    from raft_tpu_torch import obs

    os.makedirs(OUT, exist_ok=True)
    phases = {}
    with clean_path_checks() as clean_runs:
        for name in names:
            phases[name] = run_phase(name, dev)
    _expect(f"raft_tpu_recovery_attempts_total after {', '.join(names)}",
            _counter(obs.snapshot(), "raft_tpu_recovery_attempts_total"), 0)
    with open(os.path.join(OUT, _worker_tag(names) + ".json"), "w") as f:
        json.dump({"phases": phases, "paths": PATH_LAUNCHES, "rows": ROWS,
                   "walls": PHASE_WALLS, "failures": FAILURES,
                   "device_ms_log": DEVICE_MS_LOG,
                   "clean_runs": clean_runs}, f)
    return 1 if FAILURES else 0


def _die_with_parent():
    """In a worker, before exec: SIGKILL it when its parent dies
    (prctl PR_SET_PDEATHSIG), so no worker outlives a killed run."""
    import ctypes
    import signal
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)


def start_workers() -> list:
    """One ``chip_smoke.py --worker`` process per group of WORKER_GROUPS,
    its stdout and stderr to files under OUT."""
    procs = []
    for names in WORKER_GROUPS:
        tag = _worker_tag(names)
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(OUT, tag + ".json"))
        out = open(os.path.join(OUT, tag + ".out"), "w")
        err = open(os.path.join(OUT, tag + ".err"), "w")
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             ",".join(names), "--out", OUT], stdout=out, stderr=err,
            cwd=ROOT, preexec_fn=_die_with_parent)
        out.close()
        err.close()
        log(f"{', '.join(names)}: in worker process {p.pid}")
        procs.append((names, p, time.perf_counter()))
    return procs


def stop_workers(procs):
    for _, p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def join_workers(procs, phases, clean_runs):
    """Wait for every worker (killing one past WORKER_TIMEOUT_S), replay
    its output and merge its record into this process's."""
    for names, p, t0 in procs:
        tag = _worker_tag(names)
        try:
            rc = p.wait(timeout=max(1.0, WORKER_TIMEOUT_S
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop_workers(procs)
            rc = None
        PHASE_WALLS[tag] = time.perf_counter() - t0
        log(f"{tag}: exit {rc} after {PHASE_WALLS[tag]:.1f} s; its output:")
        with open(os.path.join(OUT, tag + ".out")) as f:
            sys.stdout.write(f.read())
        with open(os.path.join(OUT, tag + ".err")) as f:
            sys.stderr.write(f.read())
        sys.stdout.flush()
        path = os.path.join(OUT, tag + ".json")
        if rc is None or not os.path.isfile(path):
            fail(f"{tag} " + ("ran past its time limit" if rc is None else
                              f"exited {rc} without its record"))
            continue
        with open(path) as f:
            rec = json.load(f)
        twice = set(rec["paths"]) & set(PATH_LAUNCHES)
        if twice:
            fail(f"{tag}: launch paths recorded twice: {sorted(twice)}")
        PATH_LAUNCHES.update(rec["paths"])
        for key, rows in rec["rows"].items():
            ROWS.setdefault(key, []).extend(rows)
        PHASE_WALLS.update(rec["walls"])
        DEVICE_MS_LOG.extend(rec["device_ms_log"])
        FAILURES.extend(rec["failures"])
        phases.update(rec["phases"])
        for k in ("models", "sweeps"):
            clean_runs[k] += rec["clean_runs"][k]
        clean_runs["journal_s"].extend(rec["clean_runs"]["journal_s"])
        if rc != 0 and not rec["failures"]:
            fail(f"{tag} exited {rc}")


def main() -> int:
    global OUT
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if "--out" in sys.argv[1:]:
        OUT = os.path.abspath(sys.argv[sys.argv.index("--out") + 1])
    dev = torch.device("cuda")
    # every Model run's case journal goes under --out, never ~/.cache
    os.environ["RAFT_TPU_JOURNAL_DIR"] = os.path.join(OUT, "journal")
    if "--worker" in sys.argv[1:]:
        return run_worker(
            sys.argv[sys.argv.index("--worker") + 1].split(","), dev)
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    from raft_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    PHASE_WALLS["build"] = time.perf_counter() - t0
    log(f"build: {PHASE_WALLS['build']:.1f} s (nvcc {_build.BUILD_INFO})")
    report = _build.ptxas_report()
    for sym, lines in report.items():
        if "Li12ELi6E" in sym or "qtf_k5_" in sym:
            log(f"  ptxas {sym}: {' | '.join(lines)}")
    ptx = group_ptxas(report)
    for d in ptx:
        what = d["symbol"] if d["n"] is None else \
            f"{d['width']:10s} n={d['n']:2d} k={d['k']}"
        log(f"  ptxas {d['family']} {what}: {d['registers']} registers, "
            f"{d['stack']} bytes stack frame, {d['spill_stores']}/"
            f"{d['spill_loads']} bytes spill stores/loads")
    for family, _, want in GROUP_FAMILIES:
        got = [d for d in ptx if d["family"] == family]
        no_local = len(got) == want and all(
            d["stack"] == 0 and d["spill_stores"] == 0
            and d["spill_loads"] == 0 for d in got)
        log(f"  ptxas {family}: {len(got)} kernels, no stack frame "
            f"and no spill in any: {no_local}")
        if not no_local:
            fail(f"the {family} kernels use local memory (stack frame or "
                 f"spill) or not all {want} kernels were reported")
        if family == "K5" and not all(
                (d["registers"] or 0) <= K5_MAX_REGISTERS for d in got):
            fail(f"a K5 kernel uses more than {K5_MAX_REGISTERS} registers: "
                 + ", ".join(f"{d['symbol']} {d['registers']}" for d in got))
    sass = group_sass(_build.BUILD_INFO["path"])
    for family, by_width in sass.items():
        for width, d in by_width.items():
            shape = {"K1/K3": "n=6", "K2/K4": "n=12 k=6"}.get(family, "")
            log(f"  SASS {family} {width:10s} {shape} (static): " + ", ".join(
                f"{k} {v}" for k, v in d.items()))
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "ptxas.log"), "w") as f:
        f.write(_build.ptxas_log())

    floor = launch_floor_ms()
    log(f"launch floor: {floor:.4f} ms per trivial PyTorch CUDA launch")
    log("kernels: parity against the plain versions and times")
    t0 = time.perf_counter()
    rows = check_kernels(dev)
    check_qtf(dev)
    check_device_guard(dev)
    PHASE_WALLS["kernels"] = time.perf_counter() - t0
    log(f"kernels: {PHASE_WALLS['kernels']:.1f} s")
    if "--only-kernels" in sys.argv[1:]:
        log(f"chip_smoke: kernels only, {len(FAILURES)} failure(s)")
        return 1 if FAILURES else 0

    phases = {}
    workers = start_workers()
    try:
        with clean_path_checks() as clean_runs:
            for name in PARENT_PHASES:
                phases[name] = run_phase(name, dev)
        from raft_tpu_torch import obs
        attempts = _counter(obs.snapshot(),
                            "raft_tpu_recovery_attempts_total")
        _expect("raft_tpu_recovery_attempts_total after phases 4-6",
                attempts, 0)
        log("recovery: on the card")
        t0 = time.perf_counter()
        phases["recovery"] = run_recovery(dev)
        phases["recovery"]["wall_s"] = PHASE_WALLS["recovery"] = \
            time.perf_counter() - t0
        log(f"recovery: {phases['recovery']['wall_s']:.1f} s")
        rungs = sum(len(r.get("attempts", [])) for r in
                    phases["recovery"].values() if isinstance(r, dict)) + len(
            phases["recovery"]["recovery_sweep"]["quarantine"]["ladder"])
        _expect("raft_tpu_recovery_attempts_total after phase 14 = its "
                "rungs", _counter(obs.snapshot(),
                                  "raft_tpu_recovery_attempts_total"), rungs)
        log("obs: on the card")
        t0 = time.perf_counter()
        phases["obs"] = run_obs(dev)
        phases["obs"]["wall_s"] = PHASE_WALLS["obs"] = \
            time.perf_counter() - t0
        log(f"obs: {phases['obs']['wall_s']:.1f} s")
    except BaseException:
        stop_workers(workers)
        raise
    join_workers(workers, phases, clean_runs)
    log(f"clean paths: {clean_runs['models']} Model runs and "
        f"{clean_runs['sweeps']} sweeps of phases 4-13 checked for no "
        "recovery attempt and nothing quarantined")
    js = clean_runs["journal_s"]
    log(f"case journal (key digest, pulls, fsync'd writes) over those "
        f"Model runs: {sum(js):.3f} s in all, {max(js, default=0.0):.3f} s "
        f"the most in one run")
    phases["clean_path_runs"] = clean_runs

    def summary(label, key, replaces, source, lanes):
        # ms is the wall time of one wrapper call on the stream (CUDA
        # events around back-to-back calls, host launch cost included);
        # device_ms is the call's kernels alone (K5: its three summed),
        # from the profiler
        timed = [r for r in rows[key] if "ms" in r]
        main = next(r for r in timed if r["lanes"] == lanes)
        by_path = {p: c[key] for p, c in PATH_LAUNCHES.items() if key in c}
        return {"name": label, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "max_abs_err": max(r["max_abs_err"] for r in rows[key]
                                   if r["lanes"] == lanes),
                # relative to the plain version's peak: the well-conditioned
                # lanes, and the promoted cond-1e9 lanes (solutions ~1e11,
                # which set max_abs_err for K3/K4; null for a kernel whose
                # rows hold no such lanes)
                "max_rel_err": max(r["rel_vs_plain"] for r in rows[key]
                                   if r["lanes"] == lanes),
                "max_rel_err_ill": max(
                    (r["rel_ill"] for r in rows[key]
                     if r["lanes"] == lanes and r.get("rel_ill") is not None),
                    default=None),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "lanes": lanes,
                "device_ms": main["device_ms"], "launches_by_path": by_path,
                # phase 14: the launches of the ladder's runs (faulted,
                # resumed, recovered, re-solved lanes, chunks), by path
                "recovery_launches": {p: n for p, n in by_path.items()
                                      if p.startswith("recovery_")},
                # phase 15: the observed runs and the health sweeps
                "obs_launches": {p: n for p, n in by_path.items()
                                 if p.startswith("obs_")},
                # phase 16: the gradient path, forward and backward
                "codesign_launches": {p: n for p, n in by_path.items()
                                      if p.startswith("codesign")},
                # phase 17: the descents, every gradient and trial
                "descent_launches": {p: n for p, n in by_path.items()
                                     if p.startswith("descent")},
                # phase 18: the partition paths, plain and on the mesh
                "partition_launches": {p: n for p, n in by_path.items()
                                       if p.startswith("partition")},
                # phase 19: the served batches, the farm and optimize
                # tenants
                "serve_launches": {p: n for p, n in by_path.items()
                                   if p.startswith("serve")},
                "launch_floor_ms": floor}

    kernels = [summary(*k) for k in KERNELS]
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "rows": rows,
                   "ptxas": ptx, "sass": sass,
                   "paths": PATH_LAUNCHES, "phases": phases,
                   "device_ms_log": DEVICE_MS_LOG,
                   "phase_walls": PHASE_WALLS,
                   "wall_s": time.perf_counter() - t_start}, f, indent=1)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
        "device check")
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} failure(s)")
        for m in FAILURES:
            log(f"  - {m}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
