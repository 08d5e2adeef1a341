"""The CUDA kernels on the card, against their plain PyTorch versions.

These need an NVIDIA card: they carry the ``cuda`` marker and skip (from
inside the fixture) where there is none.  They import neither JAX nor the
JAX package, so on a machine with a card and without JAX they run as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX).
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch.ops.kernels import gj_solve as G


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _systems(rng, kind, B, n):
    if kind == "random":
        return rng.standard_normal((B, n, n)) + 5.0 * np.eye(n)
    if kind == "pivoting":
        P = np.stack([np.eye(n)[rng.permutation(n)] for _ in range(B)])
        return P * rng.uniform(1.0, 3.0, (B, n, 1)) \
            + 0.05 * rng.standard_normal((B, n, n)) * (P == 0)
    return (0.1 * rng.standard_normal((B, n, n)) + np.eye(n)) \
        * 10.0 ** rng.uniform(3, 10, (B, n, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "pivoting", "row_scales"])
def test_kernels_match_plain_on_the_card(card, kind):
    rng = np.random.default_rng(21)
    G.reset_launches()
    nb, n, nw = 3, 6, 80
    w = torch.tensor(np.linspace(0.03, 2.5, nw), device=card)
    M = torch.tensor(rng.standard_normal((nb, n, n, nw))
                     + 5.0 * np.eye(n)[None, :, :, None], device=card)
    B = torch.tensor(0.1 * rng.standard_normal((nb, n, n, nw)), device=card)
    C = torch.tensor(_systems(rng, kind, nb, n) * 10.0, device=card)
    F = torch.tensor(rng.standard_normal((nb, n, nw))
                     + 1j * rng.standard_normal((nb, n, nw)), device=card)
    X = G.impedance_gj_solve(w, M, B, C, F)
    assert _rel(X, G.impedance_gj_solve_plain(w, M, B, C, F)) < 1e-10
    A = torch.tensor(_systems(rng, kind, 80, 12), device=card)
    b = torch.tensor(rng.standard_normal((80, 12, 6)), device=card)
    x = G.gj_solve(A, b)
    assert _rel(x, G.gj_solve_plain(A, b)) < 1e-10
    # k not instantiated (3): solved as column chunks, same answer
    x3 = G.gj_solve(A, b[..., :3])
    assert _rel(x3, G.gj_solve_plain(A, b[..., :3])) < 1e-10
    assert {k: v for k, v in G.LAUNCHES.items() if v} == {
        "impedance_gj": 1, "gj_solve": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("fd", [torch.float32, torch.bfloat16])
def test_mixed_kernels_match_plain_on_the_card(card, fd):
    """K3/K4 against their plain versions: X and the promoted count, with
    cond-1e9 lanes mixed into well-conditioned ones."""
    rng = np.random.default_rng(22)
    G.reset_launches()
    A = rng.standard_normal((80, 12, 12)) + 5.0 * np.eye(12)
    for i in range(7):
        U, _, Vt = np.linalg.svd(A[i])
        A[i] = (U * np.geomspace(1.0, 1e-9, 12)) @ Vt
    A = torch.tensor(A, device=card)
    b = torch.tensor(rng.standard_normal((80, 12, 6)), device=card)
    kw = dict(refine=2, precision="mixed", factor_dtype=fd,
              promote_tol=1e-9, return_stats=True)
    x, st = G.gj_solve(A, b, **kw)
    xp, stp = G.gj_solve_plain(A, b, **kw)
    assert int(st["promoted"]) == int(stp["promoted"]) >= 7
    # promoted cond-1e9 lanes agree to cond * eps; the rest at 1e-10
    assert _rel(x[:7], xp[:7]) < 1e9 * 2.2e-16 * 10
    assert _rel(x[7:], xp[7:]) < 1e-10
    nb, n, nw = 3, 6, 80
    w = torch.tensor(np.linspace(0.03, 2.5, nw), device=card)
    M = torch.tensor(rng.standard_normal((nb, n, n, nw))
                     + 5.0 * np.eye(n)[None, :, :, None], device=card)
    B = torch.tensor(0.1 * rng.standard_normal((nb, n, n, nw)), device=card)
    C = torch.tensor(rng.standard_normal((nb, n, n)) + 10 * np.eye(n),
                     device=card)
    F = torch.tensor(rng.standard_normal((nb, n, nw))
                     + 1j * rng.standard_normal((nb, n, nw)), device=card)
    X, st = G.impedance_gj_solve(w, M, B, C, F, **kw)
    Xp, stp = G.impedance_gj_solve_plain(w, M, B, C, F, **kw)
    assert int(st["promoted"]) == int(stp["promoted"])
    assert _rel(X, Xp) < 1e-10
    key = "mixed" if fd == torch.float32 else "mixed_bf16"
    assert G.LAUNCHES[f"gj_solve_{key}"] == 1
    assert G.LAUNCHES[f"impedance_gj_{key}"] == 1


@pytest.mark.cuda
def test_model_on_the_card_raises_nothing_and_launches(card):
    from raft_tpu_torch import Model
    from raft_tpu_torch.io.designs import load_design
    from raft_tpu_torch.ops import linalg

    d = load_design("OC3spar")
    d["settings"].update(min_freq=0.02, max_freq=0.2)
    d["cases"]["data"] = d["cases"]["data"][:1]
    G.reset_launches()
    m = Model(d)
    m.analyzeCases()
    assert m.device.type == "cuda"
    assert G.LAUNCHES["impedance_gj"] > 0 and G.LAUNCHES["gj_solve"] > 0
    assert linalg.last_dispatch()["backend"] == "cuda_gj"
    assert np.all(np.isfinite(m.Xi))


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.0, 0.35])
def test_qtf_kernel_matches_plain_on_the_card(card, beta):
    """K5 against its plain version on the OC4semi example's fields (nw2 =
    30, N = 177, nm = 7) and through calc_qtf_slender_body, 1e-12 of
    max|Q| (the node sum runs in another order)."""
    from raft_tpu_torch.models import qtf as TQ
    from raft_tpu_torch.models import qtf_cases as QC
    from raft_tpu_torch.ops.kernels import qtf_pair as K

    f, pose, kw, fields = QC.case_fields(QC.oc4semi_design(), QC.OC4SEMI_W,
                                         beta, pose=QC.OFFSET_POSE, seed=7,
                                         device=card)
    K.reset_launches()
    Q = K.qtf_pair_grid(fields, beta, f.depth, f.rho_water, f.g)
    torch.cuda.synchronize()
    assert K.LAUNCHES["qtf_pair"] == 1
    ref = K.qtf_pair_grid_plain(fields, beta, f.depth, f.rho_water, f.g)
    assert Q.shape == (30, 30, 6) and _rel(Q, ref) <= 1e-12
    full = TQ.calc_qtf_slender_body(f, pose, beta, **kw)
    assert K.LAUNCHES["qtf_pair"] == 2
    assert _rel(full, TQ.complete_hermitian(ref, fields["w2"])) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8])
def test_impedance_kernels_every_n_on_the_card(card, n):
    """K1 (f64) and K3 (f32 and bf16 elimination) at every instantiated n
    against their plain versions, nw = 21 (a ragged last tile of 8
    frequencies), with one cond-1e9 case whose lanes promote and one case
    undamped at a resonance, where one frequency promotes and its
    neighbours, in the same warp, do not (n >= 2: the embedding of a 1 x 1
    complex Z has cond 1)."""
    rng = np.random.default_rng(40 + n)
    nb, nw = 3, 21
    w = torch.tensor(np.linspace(0.03, 2.5, nw), device=card)
    M = rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[None, :, :, None]
    B = 0.1 * rng.standard_normal((nb, n, n, nw))
    C = rng.standard_normal((nb, n, n)) + 10.0 * np.eye(n)
    M[1] = 0.0
    B[1] = 0.0
    U, _, Vt = np.linalg.svd(C[1])
    C[1] = (U * np.geomspace(1.0, 1e-9, n)) @ Vt
    # case 2: Z = Q diag(c - w^2) Q^T, c_0 within 1e-9 of w[5]^2
    wn = np.linspace(0.03, 2.5, nw)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    c = 10.0 + rng.uniform(0.0, 5.0, n)
    c[0] = wn[5] ** 2 * (1.0 + 1e-9)
    M[2] = np.eye(n)[:, :, None]
    B[2] = 0.0
    C[2] = (Q * c) @ Q.T
    F = rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal((nb, n, nw))
    M, B, C, F = (torch.tensor(a, device=card) for a in (M, B, C, F))
    G.reset_launches()
    ill = 1e9 * 2.2e-16 * 10
    X = G.impedance_gj_solve(w, M, B, C, F)
    Xp = G.impedance_gj_solve_plain(w, M, B, C, F)
    assert _rel(X[0], Xp[0]) < 1e-10
    assert _rel(X[1], Xp[1]) < ill and _rel(X[2], Xp[2]) < ill
    for fd, tol in ((torch.float32, 1e-10), (torch.bfloat16, 1e-7)):
        kw = dict(refine=2, precision="mixed", factor_dtype=fd,
                  promote_tol=1e-9, return_stats=True)
        X, st = G.impedance_gj_solve(w, M, B, C, F, **kw)
        Xp, stp = G.impedance_gj_solve_plain(w, M, B, C, F, **kw)
        assert int(st["promoted"]) == int(stp["promoted"])
        assert torch.equal(~(st["rn"] <= 1e-9), ~(stp["rn"] <= 1e-9))
        if n > 1:
            assert int(st["promoted"]) >= nw + 1
            assert not bool(st["rn"][2 * nw + 4] > 1e-9) or fd == torch.bfloat16
        assert _rel(X[0], Xp[0]) < tol
        assert _rel(X[1], Xp[1]) < ill and _rel(X[2], Xp[2]) < ill
    assert {k: v for k, v in G.LAUNCHES.items() if v} == {
        "impedance_gj": 1, "impedance_gj_mixed": 1,
        "impedance_gj_mixed_bf16": 1}


#: every (n, k) the K2/K4 kernels instantiate: even n <= 16, k = 1 and n/2
GJ_NK = sorted({(n, k) for n in range(2, 17, 2) for k in (1, n // 2)})


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", GJ_NK)
def test_gj_kernels_every_n_on_the_card(card, n, k):
    """K2 (f64, f32) and K4 (f32 and bf16 elimination) at every
    instantiated (n, k) against their plain versions: 21 systems (a ragged
    last block of 8), every fourth conditioned to 1e9, so that in the
    warps of the ladder one group promotes and its neighbour does not."""
    rng = np.random.default_rng(80 + n + k)
    lanes = 21
    A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
    ill = np.arange(0, lanes, 4)
    for i in ill:
        U, _, Vt = np.linalg.svd(A[i])
        A[i] = (U * np.geomspace(1.0, 1e-9, n)) @ Vt
    well = np.setdiff1d(np.arange(lanes), ill)
    A = torch.tensor(A, device=card)
    b = torch.tensor(rng.standard_normal((lanes, n, k)), device=card)
    G.reset_launches()
    ill_tol = 1e9 * 2.2e-16 * 10
    x = G.gj_solve(A, b)
    xp = G.gj_solve_plain(A, b)
    assert _rel(x[well], xp[well]) < 1e-10 and _rel(x[ill], xp[ill]) < ill_tol
    # f32: the well-conditioned systems, at f32 rounding
    x32 = G.gj_solve(A.float(), b.float())
    xp32 = G.gj_solve_plain(A.float(), b.float())
    assert x32.dtype == torch.float32 and _rel(x32[well], xp32[well]) < 1e-4
    for fd, tol in ((torch.float32, 1e-10), (torch.bfloat16, 1e-7)):
        kw = dict(refine=2, precision="mixed", factor_dtype=fd,
                  promote_tol=1e-9, return_stats=True)
        x, st = G.gj_solve(A, b, **kw)
        xp, stp = G.gj_solve_plain(A, b, **kw)
        assert int(st["promoted"]) == int(stp["promoted"]) >= len(ill)
        assert torch.equal(~(st["rn"] <= 1e-9), ~(stp["rn"] <= 1e-9))
        assert _rel(x[well], xp[well]) < tol
        assert _rel(x[ill], xp[ill]) < ill_tol
    assert {kk: v for kk, v in G.LAUNCHES.items() if v} == {
        "gj_solve": 1, "gj_solve_f32": 1, "gj_solve_mixed": 1,
        "gj_solve_mixed_bf16": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("max_freq2nd,nw2", [(0.15, 30), (0.40, 80)])
def test_qtf_kernels_oc4semi_grids_repeat_bitwise(card, max_freq2nd, nw2):
    """K5's three kernels on the OC4semi fields at nw2 = 30 (the example's
    grid: ragged 16 x 16 tiles) and 80 (the design's own resolution)
    against the plain version at 1e-12 of max|Q|; a second call gives a
    bitwise equal Q (fixed summation order, no atomics)."""
    from raft_tpu_torch.models import qtf_cases as QC
    from raft_tpu_torch.ops.kernels import qtf_pair as K

    f, _, _, fields = QC.case_fields(QC.oc4semi_design(max_freq2nd),
                                     QC.OC4SEMI_W, 0.0, pose=QC.OFFSET_POSE,
                                     device=card)
    assert fields["w2"].shape[0] == nw2
    args = (fields, 0.0, f.depth, f.rho_water, f.g)
    K.reset_launches()
    Q = K.qtf_pair_grid(*args)
    Q2 = K.qtf_pair_grid(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["qtf_pair"] == 2
    assert torch.equal(Q, Q2)
    ref = K.qtf_pair_grid_plain(*args)
    assert Q.shape == (nw2, nw2, 6) and _rel(Q, ref) <= 1e-12


def _odd_systems(rng, lanes, n, ill_every=0):
    A = rng.standard_normal((lanes, n, n)) + 5.0 * np.eye(n)
    ill = np.arange(0, lanes, ill_every) if ill_every and n > 1 \
        else np.zeros(0, dtype=int)
    for i in ill:
        U, _, Vt = np.linalg.svd(A[i])
        A[i] = (U * np.geomspace(1.0, 1e-9, n)) @ Vt
    return A, ill


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(1, 16, 2)))
def test_gj_odd_n_on_the_card(card, n):
    """gj_solve at an odd n, which the kernels (even n only) take padded
    to n + 1 with a decoupled identity row and column: f64, f32 and the
    ladder with f32 elimination against the plain version, k = 1 and 3,
    with promoted counts equal and no KernelFailure."""
    rng = np.random.default_rng(100 + n)
    lanes = 21
    A, ill = _odd_systems(rng, lanes, n, ill_every=4)
    well = np.setdiff1d(np.arange(lanes), ill)
    A = torch.tensor(A, device=card)
    ill_tol = 1e9 * 2.2e-16 * 10
    G.reset_launches()
    for k in (1, 3):
        b = torch.tensor(rng.standard_normal((lanes, n, k)), device=card)
        x, xp = G.gj_solve(A, b), G.gj_solve_plain(A, b)
        assert x.shape == (lanes, n, k)
        assert _rel(x[well], xp[well]) < 1e-10
        if len(ill):
            assert _rel(x[ill], xp[ill]) < ill_tol
        x32 = G.gj_solve(A.float(), b.float())
        xp32 = G.gj_solve_plain(A.float(), b.float())
        assert _rel(x32[well], xp32[well]) < 1e-4
        kw = dict(refine=2, precision="mixed", factor_dtype=torch.float32,
                  promote_tol=1e-9, return_stats=True)
        x, st = G.gj_solve(A, b, **kw)
        xp, stp = G.gj_solve_plain(A, b, **kw)
        assert int(st["promoted"]) == int(stp["promoted"]) >= len(ill)
        assert _rel(x[well], xp[well]) < 1e-10
        if len(ill):
            assert _rel(x[ill], xp[ill]) < ill_tol
    # (k = 3 runs as column chunks where the padded n + 1 < 6)
    assert {kk for kk, v in G.LAUNCHES.items() if v} == {
        "gj_solve", "gj_solve_f32", "gj_solve_mixed"}


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(2, 3), (5, 4), (6, 7), (12, 12),
                                 (16, 13)])
def test_gj_ladder_k_above_half_n_on_the_card(card, n, k):
    """The ladder with k > n/2 right-hand sides (the kernels take n/2 at
    most): column chunks with one promotion decision per lane over all
    its columns, then a float64 re-solve of the promoted lanes on all k.
    x and the promoted count against the plain (unchunked) ladder, at the
    f32 and bf16 elimination widths; one lane's last column is 1e6x the
    rest."""
    rng = np.random.default_rng(120 + n + k)
    lanes = 21
    A, ill = _odd_systems(rng, lanes, n, ill_every=4)
    well = np.setdiff1d(np.arange(lanes), ill)
    b = rng.standard_normal((lanes, n, k))
    b[3, :, -1] *= 1e6
    A, b = torch.tensor(A, device=card), torch.tensor(b, device=card)
    ill_tol = 1e9 * 2.2e-16 * 10
    for fd, tol in ((torch.float32, 1e-10), (torch.bfloat16, 1e-7)):
        kw = dict(refine=2, precision="mixed", factor_dtype=fd,
                  promote_tol=1e-9, return_stats=True)
        x, st = G.gj_solve(A, b, **kw)
        xp, stp = G.gj_solve_plain(A, b, **kw)
        assert x.shape == (lanes, n, k)
        assert int(st["promoted"]) == int(stp["promoted"]) >= len(ill)
        assert torch.equal(~(st["rn"] <= 1e-9), ~(stp["rn"] <= 1e-9))
        assert _rel(x[well], xp[well]) < tol
        assert _rel(x[ill], xp[ill]) < ill_tol


# ---------------------------------------------------------------------------
# first-order potential flow
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_impedance_kernel_with_m_and_b_varying_in_w_on_the_card(card):
    """K1 where M(w) and B(w) vary from bin to bin and are shared by a
    case axis (the BEM sweep's operands), C shared, F per case: the
    8-frequency tile staging and the broadcast path against the plain
    version, on a bin count that leaves a ragged tile."""
    rng = np.random.default_rng(31)
    nb, n, nw = 37, 6, 83
    w = torch.tensor(np.linspace(0.03, 2.5, nw), device=card)
    M = torch.tensor(rng.standard_normal((n, n, nw))
                     + 5.0 * np.eye(n)[:, :, None], device=card)
    B = torch.tensor(0.1 * rng.standard_normal((n, n, nw)), device=card)
    C = torch.tensor(_systems(rng, "random", 1, n)[0] * 10.0, device=card)
    F = torch.tensor(rng.standard_normal((nb, n, nw))
                     + 1j * rng.standard_normal((nb, n, nw)), device=card)
    assert float(torch.max(torch.abs(M - M[..., :1]))) > 0
    G.reset_launches()
    X = G.impedance_gj_solve(w, M, B, C, F)
    assert X.shape == (nb, n, nw) and G.LAUNCHES["impedance_gj"] == 1
    assert _rel(X, G.impedance_gj_solve_plain(w, M, B, C, F)) < 1e-10


@pytest.mark.cuda
def test_bem_library_builds_and_loads_on_the_card_host(card):
    """The port's own build of the native BEM core on the card's host:
    every library it needs is found, and none is a system LAPACK."""
    import subprocess

    from raft_tpu_torch.io import bem_native as TB

    lib = TB.build()
    out = subprocess.run(["ldd", lib], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "not found" not in out.stdout, out.stdout
    assert "liblapack" not in out.stdout and "libblas" not in out.stdout
    assert TB.load() is TB.load()


@pytest.mark.cuda
def test_oc4semi_bem_model_on_the_card_matches_cpu(card, tmp_path):
    """OC4semi on the native BEM from the committed cache: the card's
    run against the port's CPU run at 1e-9."""
    import os
    import shutil

    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import potflow_cases as PC

    cache = tmp_path / "cache"
    shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "golden", "oc4semi_bem"), cache)
    runs = {}
    for dev in ("cpu", card):
        m = Model(PC.oc4semi_bem_design(cache), device=dev)
        m.analyzeUnloaded()
        m.analyzeCases()
        runs[str(dev)] = m
    a, b = runs["cpu"], runs[str(card)]
    assert np.max(np.abs(b.Xi - a.Xi)) <= 1e-9 * np.max(np.abs(a.Xi))
    ca, cb = a.results["case_metrics"][0][0], b.results["case_metrics"][0][0]
    for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"):
        for stat in ("avg", "std"):
            key = f"{ch}_{stat}"
            assert abs(cb[key] - ca[key]) <= 1e-9 * abs(ca[key]) + 1e-15, key


@pytest.mark.cuda
def test_foctt_current_case_on_the_card_matches_cpu(card):
    """FOCTT's converging case (m2b: the rotor on the current under
    aeroServoMod 2, blade members, cavitation) on the coarse grid: the
    card's run against the port's CPU run at 1e-9, K1 once per drag pass
    and K2 once per case."""
    import warnings

    from raft_tpu_torch.model import Model
    from raft_tpu_torch.models import mhk_cases as MC

    runs = {}
    for dev in ("cpu", card):
        G.reset_launches()
        m = Model(MC.foctt_design(MC.GRID, **MC.M2B_CASE), device=dev)
        m.analyzeUnloaded()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.analyzeCases()
        runs[str(dev)] = (m, {k: v for k, v in G.LAUNCHES.items() if v})
    (a, _), (b, launches) = runs["cpu"], runs[str(card)]
    rec = b._case_records["0"]
    assert launches == {"impedance_gj": rec["fowt0"]["drag_iters"],
                        "gj_solve": 1}
    assert rec["statics_iters"] == a._case_records["0"]["statics_iters"]
    assert np.max(np.abs(b.Xi - a.Xi)) <= 1e-9 * np.max(np.abs(a.Xi))
    ca, cb = a.results["case_metrics"][0][0], b.results["case_metrics"][0][0]
    for ch in ("surge", "sway", "heave", "roll", "pitch", "yaw"):
        for stat in ("avg", "std"):
            key = f"{ch}_{stat}"
            assert abs(cb[key] - ca[key]) <= 1e-9 * abs(ca[key]) + 1e-15, key
    cav_a, cav_b = (np.asarray(c["cavitation"][0]) for c in (ca, cb))
    assert np.max(np.abs(cav_b - cav_a)) <= 1e-9 * np.max(np.abs(cav_a))


@pytest.mark.cuda
def test_farm_sweep_on_the_card_matches_cpu(card):
    """A small farm sweep (the coarse VolturnUS-S farm design's FOWT, its
    BEM power/thrust curve, three turbines in a row x four cases, aero
    damping at the waked speeds): the card's K1 lanes and wake outputs
    against the same sweep on the CPU's plain versions."""
    from raft_tpu_torch.models import farm_cases as FC
    from raft_tpu_torch.ops.kernels import gj_solve as Gk
    from raft_tpu_torch.parallel.sweep import design_fowt, sweep_farm

    d = FC.f1_design(FC.GRID)
    d.pop("array")
    c = FC.f3_cases(4, seed=3)
    args = (FC.F3_LAYOUT[:3], c["Hs"], c["Tp"], c["beta"], c["U_inf"],
            c["wind_dir"])
    cpu = sweep_farm(design_fowt(d, "cpu"), *args, nIter=6)
    Gk.reset_launches()
    gpu = sweep_farm(design_fowt(d, card), *args, nIter=6)
    assert 0 < Gk.LAUNCHES["impedance_gj"] <= 6
    for k in ("Xi", "std"):
        assert _rel(gpu[k].cpu(), cpu[k]) < 1e-9, k
    for k in ("U_wake", "Ct_wake", "aero_power"):
        assert _rel(gpu[k].cpu(), cpu[k]) < 1e-12, k
    for k in ("iters", "converged", "wake_iters"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


@pytest.mark.cuda
def test_impedance_adjoint_on_the_card_matches_cpu(card):
    """The backward of ops.linalg.impedance_solve on the card (one adjoint
    K1 launch) against the CPU's (the plain version): the gradients in w,
    M, B, C (shared by the cases) and F."""
    from raft_tpu_torch.ops import linalg

    rng = np.random.default_rng(31)
    nb, n, nw = 3, 6, 80
    args = (np.linspace(0.03, 2.5, nw),
            rng.standard_normal((nb, n, n, nw)) + 5.0 * np.eye(n)[:, :, None],
            0.1 * rng.standard_normal((nb, n, n, nw)),
            10.0 * (rng.standard_normal((n, n)) + 5.0 * np.eye(n)),
            rng.standard_normal((nb, n, nw)) + 1j * rng.standard_normal(
                (nb, n, nw)))
    c = torch.tensor(rng.standard_normal((n, nw))
                     + 1j * rng.standard_normal((n, nw)))
    grads = {}
    for dev in ("cpu", card):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in args]
        G.reset_launches()
        X = linalg.impedance_solve(*ts)
        torch.sum(torch.real(c.to(dev) * X) + torch.abs(X) ** 2).backward()
        grads[str(dev)] = [t.grad.cpu() for t in ts]
        launches = {k: v for k, v in G.LAUNCHES.items() if v}
    assert launches == {"impedance_gj": 2}
    d = linalg.last_dispatch()
    assert (d["backend"], d.get("adjoint")) == ("cuda_fused", True)
    for name, a, b in zip("wMBCF", grads[str(card)], grads["cpu"]):
        assert _rel(a, b) < 1e-10, name


@pytest.mark.cuda
def test_codesign_gradients_on_the_card(card):
    """make_design_objective / grad_guarded on the card: the small
    cylinder's std golden (tests/golden/codesign/cylinder.json) at the CPU
    tests' bars, with K1 launched in the forward and the backward."""
    from raft_tpu_torch.models import codesign_cases as CC
    from raft_tpu_torch.parallel import optimize as opt

    rec = CC.load("cylinder")["std"]
    base, space = CC.build(rec, card)
    obj = CC.objective(rec, base, space)
    G.reset_launches()
    v, g, fin = opt.grad_guarded(obj)(CC.lanes_x(rec))
    fp = obj.solver.fixed_point
    assert G.LAUNCHES["impedance_gj"] == fp["passes"] \
        + fp["adjoint_passes"] + 2
    assert fin.all()
    for i, lane in enumerate(rec["lanes"]):
        v_rel, g_rel = CC.deviation(float(v[i]), g[i].cpu().numpy(), lane)
        assert v_rel <= 1e-9 and g_rel <= 1e-7, (i, v_rel, g_rel)


@pytest.mark.cuda
def test_descent_on_the_card(card):
    """optimize_designs on the card: the small cylinder's Adam descent
    (tests/golden/descent/cylinder.json, a NaN lane among three) at the
    CPU tests' bars, the whole call under the sync guard, K1 launched
    once per fixed-point pass and twice more per gradient (the counts
    from its descent spans)."""
    from raft_tpu_torch.models import descent_cases as DC
    from raft_tpu_torch.obs import tracing, transfers
    from raft_tpu_torch.parallel import optimize as opt

    rec = DC.load("cylinder")["adam"]
    base, space = DC.build(rec, card)
    G.reset_launches()
    n0 = len(tracing.spans())
    with transfers.guard("disallow"):
        res = opt.optimize_designs(base, space, **DC.call_kwargs(rec))
    _, tot = DC.spans_since(n0)
    assert G.LAUNCHES["impedance_gj"] == tot["passes"] \
        + tot["adjoint_passes"] + 2 * tot["gradients"]
    dev = DC.deviations(rec, res)
    assert not DC.failures(dev, DC.CPU_BARS), dev
