"""Rigid-body frame transforms as batched tensor ops.

Port of ``raft_tpu/ops/transforms.py`` (reference: raft/helpers.py:314-579
— SmallRotate, VecVecTrans, getH, rotationMatrix, translateForce3to6DOF,
transformForce, translateMatrix3to6DOF, translateMatrix6to6DOF,
rotateMatrix3, rotateMatrix6, RotFrm2Vect).  Shape-polymorphic over
leading batch axes.  Matrix layouts use the Sadeghi & Incecik 6-DOF block
convention  [[m, J], [J^T, I]].
"""
from __future__ import annotations

import torch

from raft_tpu_torch._config import as_real


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def small_rotate(r, th):
    """First-order displacement of point ``r`` under rotation ``th``
    (cross(th, r) elementwise; th may be complex)."""
    return torch.stack(
        [
            -th[..., 2] * r[..., 1] + th[..., 1] * r[..., 2],
            th[..., 2] * r[..., 0] - th[..., 0] * r[..., 2],
            -th[..., 1] * r[..., 0] + th[..., 0] * r[..., 1],
        ],
        dim=-1,
    )


def vec_vec_trans(v):
    """Outer product v v^T for (...,3) vectors -> (...,3,3)."""
    return v[..., :, None] * v[..., None, :]


def skew(r):
    """Alternator ("H") matrix: H(r) @ x == cross(x, r) in the reference's
    sign convention.  r: (...,3)."""
    z = torch.zeros_like(r[..., 0])
    return torch.stack(
        [
            torch.stack([z, r[..., 2], -r[..., 1]], dim=-1),
            torch.stack([-r[..., 2], z, r[..., 0]], dim=-1),
            torch.stack([r[..., 1], -r[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def rotation_matrix(x3, x2, x1):
    """Intrinsic z-y-x rotation matrix from roll (x3), pitch (x2) and yaw
    (x1) in radians, in the reference's argument order.  Scalar or
    batched tensors (python floats are accepted and give CPU tensors)."""
    dev = next((a.device for a in (x3, x2, x1)
                if isinstance(a, torch.Tensor)), None)
    x3, x2, x1 = (a if isinstance(a, torch.Tensor) else as_real(a, dev)
                  for a in (x3, x2, x1))
    x3, x2, x1 = torch.broadcast_tensors(x3, x2, x1)
    s1, c1 = torch.sin(x1), torch.cos(x1)
    s2, c2 = torch.sin(x2), torch.cos(x2)
    s3, c3 = torch.sin(x3), torch.cos(x3)
    row0 = torch.stack([c1 * c2, c1 * s2 * s3 - c3 * s1, s1 * s3 + c1 * c3 * s2], dim=-1)
    row1 = torch.stack([c2 * s1, c1 * c3 + s1 * s2 * s3, c3 * s1 * s2 - c1 * s3], dim=-1)
    row2 = torch.stack([-s2, c2 * s3, c2 * c3], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def translate_force_3to6(F, r):
    """Force (...,3) acting at point r (...,3) -> 6-DOF wrench (...,6)
    about the origin."""
    m = _cross(r.to(F.dtype), F)
    F = torch.broadcast_to(F, m.shape)
    return torch.cat([F, m], dim=-1)


def transform_force(f, offset=None, rotmat=None):
    """Rotate a 3- or 6-wrench by ``rotmat`` then shift its point of
    action by ``offset``."""
    if f.shape[-1] == 3:
        f = torch.cat([f, torch.zeros_like(f)], dim=-1)
    F, M = f[..., :3], f[..., 3:]
    if rotmat is not None:
        F = torch.einsum("...ij,...j->...i", rotmat, F)
        M = torch.einsum("...ij,...j->...i", rotmat, M)
    if offset is not None:
        M = M + _cross(offset.to(F.dtype), F)
    return torch.cat([F, M], dim=-1)


def translate_matrix_3to6(M, r):
    """3x3 mass matrix about its CG -> 6x6 about a point offset by r
    (parallel axis).  M: (...,3,3), r: (...,3) -> (...,6,6)."""
    H = skew(r).to(M.dtype)
    MH = M @ H
    top = torch.cat([M, MH], dim=-1)
    bot = torch.cat([MH.transpose(-1, -2), H @ M @ H.transpose(-1, -2)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def translate_matrix_6to6(M, r):
    """6x6 mass/inertia matrix translated to a new reference point; r
    points from the new reference to the current one."""
    H = skew(r).to(M.dtype)
    Ht = H.transpose(-1, -2)
    m = M[..., :3, :3]
    J = M[..., :3, 3:]
    I = M[..., 3:, 3:]
    Jp = m @ H + J
    Ip = H @ m @ Ht + J.transpose(-1, -2) @ H + Ht @ J + I
    top = torch.cat([torch.broadcast_to(m, Jp.shape), Jp], dim=-1)
    bot = torch.cat([Jp.transpose(-1, -2), Ip], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rotate_matrix_3(M, R):
    """Congruence rotation R M R^T."""
    return R @ M @ R.transpose(-1, -2)


def rotate_matrix_6(M, R):
    """Blockwise rotation of a 6x6 tensor; the off-diagonal lower block is
    the transpose of the rotated upper one, as in the reference.
    M: (...,6,6), R: (...,3,3)."""
    Rt = R.transpose(-1, -2)
    m = R @ M[..., :3, :3] @ Rt
    J = R @ M[..., :3, 3:] @ Rt
    I = R @ M[..., 3:, 3:] @ Rt
    top = torch.cat([m, J], dim=-1)
    bot = torch.cat([J.transpose(-1, -2), I], dim=-1)
    return torch.cat([top, bot], dim=-2)


def rot_frm_2_vect(A, B):
    """Rodrigues rotation matrix taking direction A to direction B;
    identity when they are (anti)parallel."""
    A = as_real(A)
    B = as_real(B, A.device)
    A = A / torch.linalg.norm(A, dim=-1, keepdim=True)
    B = B / torch.linalg.norm(B, dim=-1, keepdim=True)
    v = _cross(A, B)
    v2 = torch.sum(v * v, dim=-1)
    ssc = -skew(v)
    dotAB = torch.sum(A * B, dim=-1)
    safe_v2 = torch.where(v2 == 0.0, 1.0, v2)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    R = eye + ssc + (ssc @ ssc) * ((1.0 - dotAB) / safe_v2)[..., None, None]
    return torch.where((v2 == 0.0)[..., None, None], eye, R)
