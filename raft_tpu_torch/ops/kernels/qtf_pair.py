"""The QTF pair-grid kernel (K5), its wrapper and its plain PyTorch version.

``qtf_pair_grid`` replaces the Pallas kernel
``raft_tpu/ops/pallas/qtf_pair.py:qtf_pair_grid``: the raw slender-body
difference-frequency wrench of every (w1, w2) pair of the second-order
grid, summed over the strip nodes, plus Pinkster IV and the waterline
relative-elevation term of each crossing member — no Kim & Yue
correction and no Hermitian completion (the caller applies the
completion).  ``fields`` is the dict ``models.qtf.qtf_fields`` builds:
the per-frequency node fields lane-last ((N, 3, nw2) etc.), as the TPU
kernel takes them.

Dispatch: a CUDA tensor launches the hand-written kernels of
``csrc/qtf_k5_f64.cu`` (built at first use, see ``_build.py``) or raises
:class:`~raft_tpu_torch.errors.KernelFailure`; a CPU tensor runs the
plain version below.  There is no other route.  One call launches three
kernels: a record pass over (frequency, submerged node), the pair pass
over tiles of pairs and shares of the nodes, and a finishing pass that
adds the shares in a fixed order with the per-pair terms.  What bounds
them on the card and what the design does about it is written in
``csrc/qtf_pair.cuh``.

The plain version is the JAX package's doubly-vmapped pair closure
(``raft_tpu/models/qtf.py:456-577``) written with explicit (w1 row, w2)
batch axes and chunked over w1 rows, so its largest intermediate (rows,
nw2, N, 3, 3) complex stays near ``_PLAIN_CHUNK_BYTES``.  It is the CPU
path, the tests' reference and the yardstick the card's kernel is held
against.
"""
from __future__ import annotations

import functools

import torch

from raft_tpu_torch import errors
from raft_tpu_torch.ops.transforms import _cross, skew
from raft_tpu_torch.ops.waves import wave_pot_2nd_order

#: kernel launches, incremented only where the kernel launches
LAUNCHES = {"qtf_pair": 0}

COMPLEX_FIELDS = ("Xi", "F1st", "u", "dr", "nv", "nax", "gu", "gp")

#: budget of one (rows, nw2, N, 3, 3) complex intermediate of the plain
#: version
_PLAIN_CHUNK_BYTES = 32 * 2**20

#: the fields with one row per strip node
NODE_FIELDS = ("u", "dr", "nv", "nax", "gu", "gp", "q", "offsets", "pos",
               "Minert", "CaMat", "ptMat", "qMat", "nodescal")


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mv(M, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3), broadcasting the batch axes."""
    return torch.sum(M * v[..., None, :], dim=-1)


def _rows_plain(f, rows, beta, h, rho, g):
    """Raw pair wrench for w1 rows ``rows`` and every w2: (nr, nw2, 6)."""
    cdt = f["u"].dtype
    w2, k2 = f["w2"], f["k2"]
    I = rows
    # frequency-first fields: (nw2, N, ...)
    fr = {k: f[k].movedim(-1, 0) for k in ("u", "dr", "nv", "nax", "gu",
                                             "gp")}
    Xi = f["Xi"].movedim(-1, 0)                       # (nw2, 6)
    F1 = f["F1st"].movedim(-1, 0)
    q = f["q"].to(cdt)                                # (N, 3)
    Minert, CaMat = f["Minert"].to(cdt), f["CaMat"].to(cdt)
    ptMat, qMat = f["ptMat"].to(cdt), f["qMat"].to(cdt)
    nsc = f["nodescal"]
    v_i, v_end_ca, a_i, submerged = nsc[:, 0], nsc[:, 1], nsc[:, 2], nsc[:, 3]

    def one(x):                                       # the w1 side
        return x[I][:, None]                          # (nr, 1, ...)

    def two(x):                                       # the w2 side
        return x[None]                                # (1, nw2, ...)

    w1s, w2s = w2[I][:, None], w2[None, :]            # (nr, 1), (1, nw2)
    u1, u2 = one(fr["u"]), two(fr["u"])               # (., ., N, 3)
    dr1, dr2 = one(fr["dr"]), two(fr["dr"])
    nv1, nv2 = one(fr["nv"]), two(fr["nv"])
    nax1, nax2 = one(fr["nax"]), two(fr["nax"])       # (., ., N)
    gu1, gu2 = one(fr["gu"]), two(fr["gu"])           # (., ., N, 3, 3)
    gp1, gp2 = one(fr["gp"]), two(fr["gp"])
    gdu1 = 1j * w1s[..., None, None, None] * gu1
    gdu2 = 1j * w2s[..., None, None, None] * gu2
    Xi1, Xi2 = one(Xi), two(Xi)                       # (., ., 6)
    F11, F12 = one(F1), two(F1)

    # Pinkster IV (reference :1449-1456)
    F_rotN = torch.cat([
        0.25 * (_cross(Xi1[..., 3:], torch.conj(F12[..., 0:3]))
                + _cross(torch.conj(Xi2[..., 3:]), F11[..., 0:3])),
        0.25 * (_cross(Xi1[..., 3:], torch.conj(F12[..., 3:]))
                + _cross(torch.conj(Xi2[..., 3:]), F11[..., 3:])),
    ], dim=-1)                                        # (nr, nw2, 6)

    rv = (rho * v_i)[:, None]                         # (N, 1)
    re = (rho * v_end_ca)[:, None]

    # 2nd-order potential (reference :1541-1544)
    acc_2p, p_2nd = wave_pot_2nd_order(
        w1s[..., None], w2s[..., None], k2[I][:, None, None],
        k2[None, :, None], beta, beta, h, f["pos"], g=g, rho=rho)
    f_2ndPot = rv * _mv(Minert, acc_2p)

    # convective acceleration (reference :1546-1548)
    conv_acc = 0.25 * (_mv(gu1, torch.conj(u2)) + _mv(torch.conj(gu2), u1))
    f_conv = rv * _mv(Minert, conv_acc)

    # Rainey axial divergence (reference :1550-1551)
    dwdz1 = torch.sum(_mv(gu1, q) * q, dim=-1)        # (nr, 1, N)
    dwdz2 = torch.sum(_mv(gu2, q) * q, dim=-1)        # (1, nw2, N)

    def transverse(vec):
        return vec - torch.sum(vec * q, dim=-1, keepdim=True) * q

    u1t, u2t = transverse(u1), transverse(u2)
    nv1t, nv2t = transverse(nv1), transverse(nv2)
    axdv = 0.25 * (dwdz1[..., None] * torch.conj(u2t - nv2t)
                   + torch.conj(dwdz2)[..., None] * (u1t - nv1t))
    axdv = transverse(axdv)
    f_axdv = rv * _mv(CaMat, axdv)

    # body motion in the 1st-order field (reference :1553-1555)
    acc_nabla = 0.25 * (_mv(gdu1, torch.conj(dr2))
                        + _mv(torch.conj(gdu2), dr1))
    f_nabla = rv * _mv(Minert, acc_nabla)

    # Rainey body-rotation terms (reference :1557-1576); skew is the
    # reference's H matrix (H(r) x = x cross r), so OM @ x = o cross x
    OM1 = -skew(1j * w1s[..., None] * Xi1[..., 3:])[:, :, None]
    OM2 = -skew(1j * w2s[..., None] * Xi2[..., 3:])[:, :, None]
    f_rslb = -0.25 * 2.0 * _mv(
        CaMat, _mv(OM1, torch.conj(nax2[..., None] * q))
        + _mv(torch.conj(OM2), nax1[..., None] * q))
    f_rslb = rv * f_rslb
    u1a = u1 - nv1
    u2a = u2 - nv2
    V1 = gu1 + OM1
    V2 = gu2 + OM2
    aux = 0.25 * (_mv(V1, torch.conj(_mv(CaMat, u2a)))
                  + _mv(torch.conj(V2), _mv(CaMat, u1a)))
    aux = aux - _mv(qMat, aux)
    f_rslb = f_rslb + rv * aux
    u1at = u1a - _mv(qMat, u1a)
    u2at = u2a - _mv(qMat, u2a)
    aux2 = 0.25 * (_mv(CaMat, _mv(V1, torch.conj(u2at)))
                   + _mv(CaMat, _mv(torch.conj(V2), u1at)))
    f_rslb = f_rslb - rv * aux2

    # axial/end effects (reference :1578-1601)
    f_2ndPot = f_2ndPot + a_i[:, None] * p_2nd[..., None] * q
    f_2ndPot = f_2ndPot + re * _mv(qMat, acc_2p)
    f_conv = f_conv + re * _mv(qMat, conv_acc)
    f_nabla = f_nabla + re * _mv(qMat, acc_nabla)
    p_nabla = 0.25 * (torch.sum(gp1 * torch.conj(dr2), dim=-1)
                      + torch.sum(torch.conj(gp2) * dr1, dim=-1))
    f_nabla = f_nabla + (a_i * p_nabla)[..., None] * q
    p_drop = -2.0 * 0.25 * 0.5 * rho * torch.sum(
        _mv(ptMat, u1 - nv1) * torch.conj(_mv(CaMat, u2 - nv2)), dim=-1)
    f_conv = f_conv + (a_i * p_drop)[..., None] * q

    # wrench about the PRP, masked to submerged nodes
    f_side = (f_2ndPot + f_conv + f_axdv + f_nabla + f_rslb) \
        * submerged[:, None]
    mom = _cross(f["offsets"].to(cdt), f_side)
    F_side = torch.cat([torch.sum(f_side, dim=-2), torch.sum(mom, dim=-2)],
                       dim=-1)                        # (nr, nw2, 6)

    # waterline relative-elevation term per crossing member
    # (reference :1603-1631)
    F_eta = torch.zeros_like(F_side)
    wl = f.get("wl")
    if wl is not None:
        c = wl["c"].movedim(-1, 0)                    # (nw2, nm, 3, 3)
        eta = wl["eta"].movedim(-1, 0)                # (nw2, nm)
        mats, geo = wl["mats"].to(cdt), wl["geo"]
        for im in range(int(geo.shape[0])):
            udw1, aw1, ge1 = (c[I, im, j][:, None] for j in range(3))
            udw2, aw2, ge2 = (c[None, :, im, j] for j in range(3))
            er1 = eta[I, im][:, None, None]
            er2 = eta[None, :, im, None]
            aA = geo[im, 0]
            f_eta = 0.25 * (udw1 * torch.conj(er2) + torch.conj(udw2) * er1)
            f_eta = rho * aA * _mv(mats[im, 0], f_eta)
            a_eta = 0.25 * (aw1 * torch.conj(er2) + torch.conj(aw2) * er1)
            f_eta = f_eta - rho * aA * _mv(mats[im, 1], a_eta)
            f_eta = f_eta - 0.25 * rho * aA * (ge1 * torch.conj(er2)
                                               + torch.conj(ge2) * er1)
            off = geo[im, 1:4].to(cdt)
            F_eta = F_eta + torch.cat([f_eta, _cross(off, f_eta)], dim=-1)

    return F_rotN + F_side + F_eta


def qtf_pair_grid_plain(fields: dict, beta, h, rho, g):
    """Plain version of K5: the raw (nw2, nw2, 6) complex pair grid."""
    w2 = fields["w2"]
    nw2 = int(w2.shape[0])
    N = int(fields["q"].shape[0])
    per_row = max(nw2 * N * 9 * 16, 1)
    step = max(1, _PLAIN_CHUNK_BYTES // per_row)
    beta, h, rho, g = float(beta), float(h), float(rho), float(g)
    out = []
    for s in range(0, nw2, step):
        rows = torch.arange(s, min(s + step, nw2), device=w2.device)
        out.append(_rows_plain(fields, rows, beta, h, rho, g))
    return torch.cat(out, dim=0)


def qtf_pair_grid(fields: dict, beta, h, rho, g):
    """K5: the raw slender-body QTF pair grid (nw2, nw2, 6) complex128.
    For CUDA tensors one call launches the three K5 kernels (records,
    pairs, finish) and counts 1 in ``LAUNCHES["qtf_pair"]``; CPU tensors
    run the plain version."""
    dev = fields["w2"].device
    if dev.type == "cpu":
        return qtf_pair_grid_plain(fields, beta, h, rho, g)
    if dev.type != "cuda":
        raise errors.KernelFailure(f"no kernel for device {dev}",
                                   kernel="qtf_pair")
    return _qtf_cuda(fields, float(beta), float(h), float(rho), float(g))


def check_dry_nodes(fields: dict) -> None:
    """Raise :class:`~raft_tpu_torch.errors.NonFiniteResult` if a field of
    a node above water (``nodescal[:, 3] == 0``) is not finite.  The plain
    version, like the JAX package, multiplies such a node's wrench by 0,
    so a NaN there would make its QTF NaN; the kernel skips the node and
    would return a finite QTF.  With finite fields the two agree.

    In the same host sync it records the kernel's compacted node list:
    ``fields["sub"]``, the submerged nodes' indices in order ((nsub,)
    int32 on the fields' device), and ``fields["nsub"]``."""
    dry = fields["nodescal"][:, 3] == 0.0
    bad = torch.stack([~torch.all(torch.isfinite(fields[k][dry]))
                       for k in NODE_FIELDS])
    *flags, nsub = torch.cat([bad.to(torch.int64),
                              torch.sum(~dry).reshape(1)]).tolist()
    if any(flags):
        names = [k for k, b in zip(NODE_FIELDS, flags) if b]
        raise errors.NonFiniteResult(
            "non-finite QTF fields at a node above water", fields=names)
    fields["sub"] = torch.argsort(dry.to(torch.int8), stable=True)[:nsub] \
        .to(torch.int32)
    fields["nsub"] = nsub


def _check(cond, msg, **ctx):
    if not cond:
        raise errors.KernelFailure(msg, kernel="qtf_pair", **ctx)


#: the pair pass's tile edge (csrc/qtf_pair.cuh kT) and the blocks its
#: node split aims at: one (16 warps) on each of the H100's 132 SMs
PAIR_TILE = 16
TARGET_BLOCKS = 132


@functools.lru_cache(maxsize=None)
def node_split(nw2: int, nsub: int) -> int:
    """Submerged nodes per pair-pass block: the share that makes the
    waves of blocks times (the nodes a block walks + 2, a block's own
    start and end) least; ties: the fewest blocks.  It depends on the
    shapes only, so the summation order, and Q, are the same on every
    call."""
    tiles = (-(-nw2 // PAIR_TILE)) ** 2
    best = None
    for per in range(1, max(nsub, 1) + 1):
        splits = -(-nsub // per)
        key = (-(-tiles * splits // TARGET_BLOCKS) * (per + 2), splits)
        if best is None or key < best[0]:
            best = (key, per)
    return best[1]


def _operand(t, name, shape, dtype, dev):
    """``t`` contiguous (copied only if it is not), after the checks; the
    message is built only for a failure."""
    if t.shape != shape or t.dtype != dtype or t.device != dev:
        raise errors.KernelFailure(
            f"{name} must be {shape} {dtype} on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} {t.device}", kernel="qtf_pair")
    return t if t.is_contiguous() else t.contiguous()


def kernel_operands(fields: dict):
    """The kernel's operands, lane-last as ``qtf_fields`` builds them and
    contiguous (a field that is not is copied), with the shapes checked:
    a dict of tensors plus (nw2, N, nm)."""
    w2 = fields["w2"]
    dev = w2.device
    nw2 = int(w2.shape[0])
    N = int(fields["q"].shape[0])
    wl = fields.get("wl")
    nm = 0 if wl is None else int(wl["geo"].shape[0])
    shapes = {"w2": (nw2,), "k2": (nw2,), "Xi": (6, nw2), "F1st": (6, nw2),
              "u": (N, 3, nw2), "dr": (N, 3, nw2), "nv": (N, 3, nw2),
              "nax": (N, nw2), "gu": (N, 3, 3, nw2), "gp": (N, 3, nw2),
              "q": (N, 3), "offsets": (N, 3), "pos": (N, 3),
              "Minert": (N, 3, 3), "CaMat": (N, 3, 3), "ptMat": (N, 3, 3),
              "qMat": (N, 3, 3), "nodescal": (N, 4)}
    ops = {name: _operand(fields[name], name, shape, torch.complex128
                          if name in COMPLEX_FIELDS else torch.float64, dev)
           for name, shape in shapes.items()}
    if nm:
        for name, shape, dtype in (("c", (nm, 3, 3, nw2), torch.complex128),
                                   ("eta", (nm, nw2), torch.complex128),
                                   ("mats", (nm, 2, 3, 3), torch.float64),
                                   ("geo", (nm, 4), torch.float64)):
            ops["wl" + name] = _operand(wl[name], f"wl[{name!r}]", shape,
                                        dtype, dev)
    return ops, (nw2, N, nm)


def submerged(fields: dict):
    """(sub, nsub): the compacted node list ``check_dry_nodes`` recorded
    in ``fields``, or built here (one host sync) for fields made
    otherwise."""
    if "sub" not in fields:
        check_dry_nodes(fields)
    sub, nsub = fields["sub"], int(fields["nsub"])
    return _operand(sub, "fields['sub']", (nsub,), torch.int32,
                    fields["w2"].device), nsub


def _ptr(t):
    return None if t is None else t.data_ptr()


#: the operands in the C entry point's order
OPERAND_ORDER = ("w2", "k2", "Xi", "F1st", "u", "dr", "nv", "nax", "gu",
                 "gp", "q", "offsets", "pos", "Minert", "CaMat", "ptMat",
                 "qMat", "nodescal", "wlc", "wleta", "wlmats", "wlgeo")


def _qtf_cuda(fields, beta, h, rho, g):
    from raft_tpu_torch.ops.kernels import _build

    ops, (nw2, N, nm) = kernel_operands(fields)
    dev = ops["w2"].device
    _check(0 < nw2 <= 32768, f"nw2 = {nw2} outside the kernel's grid",
           nw2=nw2)
    sub, nsub = submerged(fields)
    per = node_split(nw2, nsub)
    lib = _build.load()
    nscr = int(lib.raft_qtf_k5_scratch(nw2, nsub, per))
    scratch = torch.empty(2 * nscr, dtype=torch.float64, device=dev)
    Q = torch.empty((nw2, nw2, 6), dtype=torch.complex128, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.raft_qtf_k5_f64(*(_ptr(ops.get(k)) for k in OPERAND_ORDER),
                             sub.data_ptr(), scratch.data_ptr(), nscr,
                             _ptr(Q), nw2, N, nm, nsub, per, beta, h, rho, g,
                             stream)
    _build.check(rc, "qtf_pair", nw2=nw2, N=N, nm=nm, nsub=nsub)
    LAUNCHES["qtf_pair"] += 1
    return Q
