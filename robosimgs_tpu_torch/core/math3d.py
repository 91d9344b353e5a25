"""Quaternion / rotation / covariance math (batched, autograd-friendly).

A port of robosimgs_tpu/core/math3d.py: every function broadcasts over
leading dimensions as the JAX one does. Matrix products run in f32 (the
package turns TF32 off at import), the counterpart of the JAX package's
precision="highest".
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) (w,x,y,z) unit quaternions -> (..., 3, 3) rotation matrices."""
    rows = rotmat_components(q)
    return torch.stack([torch.stack(list(r), -1) for r in rows], -2)


def rotmat_components(q: torch.Tensor):
    """Unit quats (...,4) -> rotation matrix as a 3x3 nested tuple of
    (...,) tensors, so batched 3x3 algebra stays elementwise f32."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )


def camera_covariance_components(quats: torch.Tensor, scales: torch.Tensor,
                                 R_cw: torch.Tensor):
    """Upper-triangular entries of Rcw (R S S^T R^T) Rcw^T, elementwise.

    quats (...,4) unit, scales (...,3), R_cw (3,3). Returns
    (c00, c01, c02, c11, c12, c22), each (...,). Every contraction is
    unrolled to elementwise f32 math (no matmul precision mode applies).
    """
    R = rotmat_components(quats)
    M = [[sum(R_cw[i, k] * R[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    s0, s1, s2 = scales[..., 0], scales[..., 1], scales[..., 2]
    sq = (s0 * s0, s1 * s1, s2 * s2)

    def cov(i, j):
        return (M[i][0] * M[j][0] * sq[0] + M[i][1] * M[j][1] * sq[1]
                + M[i][2] * M[j][2] * sq[2])

    return cov(0, 0), cov(0, 1), cov(0, 2), cov(1, 1), cov(1, 2), cov(2, 2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def axis_angle_to_quat(axis: torch.Tensor, angle) -> torch.Tensor:
    """(...,3) unit axis + (...) angle -> (w,x,y,z) quaternion."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    s = torch.sin(half)[..., None]
    xyz = axis * s
    w = torch.cos(half)[..., None].expand(*xyz.shape[:-1], 1)
    return torch.cat([w, xyz], dim=-1)


def build_covariance(quats: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T from unit quats (...,4) and scales (...,3).

    Returns (..., 3, 3) symmetric PSD covariance, the 3DGS
    parameterization, contracted in f32."""
    R = quat_to_rotmat(quats)
    RS = R * scales[..., None, :]         # R @ diag(s)
    return torch.einsum("...ij,...kj->...ik", RS, RS)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) rigid transform to (...,N,3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def inverse_2x2_sym(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    eps: float = 0.0):
    """Inverse of the symmetric 2x2 [[a,b],[b,c]]; returns (ia, ib, ic,
    det). A zero determinant divides by 1 instead (det itself is
    returned as 0). eps is unused, as in the JAX function."""
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    return c * inv_det, -b * inv_det, a * inv_det, det
