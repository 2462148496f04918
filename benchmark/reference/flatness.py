"""Frozen copy of `ndp_nmpc_qd_tpu_torch/traj/flatness.py` (the benchmark's plain
reference; it imports nothing of the port). Its original docstring:

Differential flatness: flat outputs -> full state + input.

Port of `ndp_nmpc_qd_tpu/traj/flatness.py` (the reference's
`diff_flatness`, `pt_pub/pt_publisher.py:188-248`): thrust direction from
the desired acceleration, body frame from the thrust direction and yaw,
body rates from the jerk projection, batched over any leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import quat
from .polyopt import FlatOutputs


class FullState(NamedTuple):
    """x (..., 10) and u (..., 4) for the body-rate model
    (`pt_publisher.py:126-149`)."""

    x: torch.Tensor
    u: torch.Tensor


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def diff_flatness(fo: FlatOutputs, *, mass: float, gravity: float) -> FullState:
    """[pos, vel, acc, jerk, yaw, yaw_dot] -> x = [p, v, q], u = [pqr, c];
    c is the collective acceleration u1 / mass (`pt_publisher.py:143`)."""
    acc = fo.acc
    e_z = torch.zeros_like(acc)
    e_z[..., 2] = gravity
    t_des = acc + e_z
    t_norm = _norm(t_des)
    z_b = t_des / t_norm
    u1 = t_norm[..., 0] * mass  # collective force

    x_c = torch.stack([torch.cos(fo.yaw), torch.sin(fo.yaw), torch.zeros_like(fo.yaw)], dim=-1)
    zx = torch.linalg.cross(z_b, x_c)
    y_b = zx / _norm(zx)
    x_b = torch.linalg.cross(y_b, z_b)
    R_wb = torch.stack([x_b, y_b, z_b], dim=-1)  # columns = body axes

    h_w = (mass / u1[..., None]) * (
        fo.jerk - torch.sum(z_b * fo.jerk, dim=-1, keepdim=True) * z_b
    )
    p = -torch.sum(h_w * y_b, dim=-1)
    q = torch.sum(h_w * x_b, dim=-1)
    r = fo.yaw_dot * z_b[..., 2]
    q_wb = quat.from_rotation_matrix(R_wb)  # w >= 0 (ROS convention)
    x = torch.cat([fo.pos, fo.vel, q_wb], dim=-1)
    u = torch.stack([p, q, r, u1 / mass], dim=-1)
    return FullState(x, u)
