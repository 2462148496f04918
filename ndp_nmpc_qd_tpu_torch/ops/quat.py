"""Quaternion algebra (wxyz convention, batched over leading axes).

Port of `ndp_nmpc_qd_tpu/ops/quat.py`. Convention: q = [qw, qx, qy, qz],
Hamilton product, world<-body rotation.
"""

from __future__ import annotations

import torch


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2 on the last axis."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v (world <- body) by unit quaternion q."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (world <- body)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def from_rotation_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion with qw >= 0.

    Branch-free Shepperd-style reconstruction: all four candidates are
    computed and the one keyed to the largest diagonal combination is
    selected, as in the JAX package.
    """
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    m01, m02, m10, m12, m20, m21 = (
        R[..., 0, 1], R[..., 0, 2], R[..., 1, 0], R[..., 1, 2], R[..., 2, 0], R[..., 2, 1],
    )
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(a):
        return torch.sqrt(a.clamp_min(1e-24))

    sw = safe_sqrt(qw2) * 2.0
    cand_w = torch.stack([sw / 4.0, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = torch.stack([(m21 - m12) / sx, sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy], dim=-1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0], dim=-1)

    best = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(dim=-1)[..., None]
    q = torch.where(
        best == 0, cand_w,
        torch.where(best == 1, cand_x, torch.where(best == 2, cand_y, cand_z)),
    )
    q = torch.where(q[..., :1] < 0, -q, q)
    return normalize(q)


def from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw-only quaternion (roll = pitch = 0)."""
    half = yaw * 0.5
    z = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def yaw(q: torch.Tensor) -> torch.Tensor:
    """ZYX-euler yaw angle of a quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def error_vector(q: torch.Tensor, q_ref: torch.Tensor) -> torch.Tensor:
    """The reference's nonlinear quaternion tracking error [qe_x, qe_y, qe_z]
    (`nmpc_ctl/nmpc_body_rate_ctl.py:164-166`): the vector part of
    q ⊗ q_ref^{-1} for unit quaternions."""
    qw, qx, qy, qz = q.unbind(-1)
    qwr, qxr, qyr, qzr = q_ref.unbind(-1)
    return torch.stack(
        [
            qwr * qx - qw * qxr + qyr * qz - qy * qzr,
            qwr * qy - qw * qyr - qxr * qz + qx * qzr,
            qxr * qy - qx * qyr + qwr * qz - qw * qzr,
        ],
        dim=-1,
    )
