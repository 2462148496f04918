"""Quadrotor body-rate dynamics: the 10-state model both OCPs share.

Port of `ndp_nmpc_qd_tpu/models/quadrotor.py`.

State  x = [px, py, pz, vx, vy, vz, qw, qx, qy, qz]
Input  u = [wx, wy, wz, c]   (body rates rad/s, collective acceleration m/s^2)

With `f_dist = None` it is the pure-NMPC model, with a disturbance force the
NDP model which adds `f_dist/mass` to the velocity derivatives. The
quaternion is deliberately not normalized inside the dynamics, as in the
reference's CasADi model.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..params import VehicleParams

NX = 10
NU = 4


def body_rate_dynamics(
    x: torch.Tensor,
    u: torch.Tensor,
    f_dist: torch.Tensor | None = None,
    *,
    mass: float = 1.4844,
    gravity: float = 9.81,
) -> torch.Tensor:
    """Continuous-time xdot; x (..., 10), u (..., 4), f_dist (..., 3) [N]."""
    vx, vy, vz = x[..., 3], x[..., 4], x[..., 5]
    qw, qx, qy, qz = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    wx, wy, wz, c = u[..., 0], u[..., 1], u[..., 2], u[..., 3]

    ax = 2.0 * (qx * qz + qw * qy) * c
    ay = 2.0 * (qy * qz - qw * qx) * c
    az = (1.0 - 2.0 * qx**2 - 2.0 * qy**2) * c - gravity

    if f_dist is not None:
        ax = ax + f_dist[..., 0] / mass
        ay = ay + f_dist[..., 1] / mass
        az = az + f_dist[..., 2] / mass

    dq_w = (-wx * qx - wy * qy - wz * qz) * 0.5
    dq_x = (wx * qw + wz * qy - wy * qz) * 0.5
    dq_y = (wy * qw - wz * qx + wx * qz) * 0.5
    dq_z = (wz * qw + wy * qx - wx * qy) * 0.5

    return torch.stack([vx, vy, vz, ax, ay, az, dq_w, dq_x, dq_y, dq_z], dim=-1)


def make_dynamics(vehicle: VehicleParams):
    """Bind vehicle constants; returns f(x, u, f_dist) -> xdot."""

    def f(x, u, f_dist=None):
        return body_rate_dynamics(
            x, u, f_dist, mass=vehicle.mass, gravity=vehicle.gravity
        )

    return f


def hover_state(pos: torch.Tensor, yaw_q: torch.Tensor | None = None) -> torch.Tensor:
    """Stationary state at `pos` with identity (or given) attitude."""
    pos = torch.as_tensor(pos)
    batch = pos.shape[:-1]
    zeros3 = pos.new_zeros(batch + (3,))
    if yaw_q is None:
        q = pos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(batch + (4,))
    else:
        q = yaw_q
    return torch.cat([pos, zeros3, q], dim=-1)


def hover_input(
    vehicle: VehicleParams, batch=(), dtype=torch.float32, device=None
) -> torch.Tensor:
    """u that holds hover: zero rates, c = g (collective acceleration), on
    `device` (by default the card)."""
    u = torch.zeros(tuple(batch) + (4,), dtype=dtype, device=resolve_device(device))
    u[..., 3] = vehicle.gravity
    return u
