"""Full-attitude quadrotor model with per-rotor thrust inputs.

Port of `ndp_nmpc_qd_tpu/models/quadrotor_thrust.py`: the 13-state model of
the motor-thrust controller, which the reference declares but leaves an
empty stub (`nmpc_ctl/nmpc_motor_thrust_ctl.py:11-13`), built on the vehicle
constants it ships (inertia, arm length, 45-degree X frame, rotor thrust and
torque coefficients, `params/fhnp_params.py:9-27`).

State  x = [p(3), v(3), q(4), omega(3)]   (body rates are states here)
Input  u = [f1, f2, f3, f4]               rotor thrusts [N]

Rotor layout (X configuration, 45-degree arms, z-up body frame):
  rotor 1: front-right (+x, -y), spins CCW   rotor 2: back-left  (-x, +y), CCW
  rotor 3: front-left  (+x, +y), spins CW    rotor 4: back-right (-x, -y), CW
Yaw drag torque per rotor is (c_q / c_t) * f with sign by spin direction.
"""

from __future__ import annotations

import math

import torch

from .. import const
from ..params import VehicleParams

NXT = 13
NUT = 4


def rotor_geometry(veh: VehicleParams):
    """(arm, kappa): the moment arm of each rotor about the body axes
    (l_frame * sin(alpha_frame)) and the yaw torque/thrust ratio c_q/c_t."""
    return veh.l_frame * math.sin(veh.alpha_frame), veh.c_q / veh.c_t


def allocation_rows(veh: VehicleParams) -> tuple:
    """The 4x4 map [f1..f4] -> [F_total, tau_x, tau_y, tau_z] as nested
    Python floats. tau = sum r_i x (0, 0, f_i): tau_x = sum y_i f_i,
    tau_y = -sum x_i f_i; CCW rotors drag the body clockwise (-z)."""
    arm, kappa = rotor_geometry(veh)
    # positions: 1 (+x,-y) CCW, 2 (-x,+y) CCW, 3 (+x,+y) CW, 4 (-x,-y) CW
    return (
        (1.0, 1.0, 1.0, 1.0),
        (-arm, arm, arm, -arm),  # tau_x = sum(y_i f_i)
        (-arm, arm, -arm, arm),  # tau_y = -sum(x_i f_i)
        (-kappa, -kappa, kappa, kappa),
    )


def thrust_allocation_matrix(veh: VehicleParams, dtype=torch.float64, device="cpu"):
    """`allocation_rows` as a (4, 4) tensor."""
    return torch.tensor(allocation_rows(veh), dtype=dtype, device=device)


def thrust_dynamics(x: torch.Tensor, u: torch.Tensor, f_dist: torch.Tensor | None = None, *,
                    veh: VehicleParams) -> torch.Tensor:
    """Continuous-time xdot of the 13-state model (..., 13): the wrench of
    the rotor thrusts, the body rates' quaternion kinematics and the rigid
    body's rate dynamics with its gyroscopic term; f_dist (..., 3) [N] is an
    external force."""
    dt, dev = x.dtype, x.device
    v = x[..., 3:6]
    qw, qx, qy, qz = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    wx, wy, wz = x[..., 10], x[..., 11], x[..., 12]

    wrench = u @ const(allocation_rows(veh), dt, dev).T
    F = wrench[..., 0]
    tau = wrench[..., 1:4]

    c = F / veh.mass  # collective acceleration
    ax = 2.0 * (qx * qz + qw * qy) * c
    ay = 2.0 * (qy * qz - qw * qx) * c
    az = (1.0 - 2.0 * qx**2 - 2.0 * qy**2) * c - veh.gravity
    if f_dist is not None:
        ax = ax + f_dist[..., 0] / veh.mass
        ay = ay + f_dist[..., 1] / veh.mass
        az = az + f_dist[..., 2] / veh.mass

    dq_w = (-wx * qx - wy * qy - wz * qz) * 0.5
    dq_x = (wx * qw + wz * qy - wy * qz) * 0.5
    dq_y = (wy * qw - wz * qx + wx * qz) * 0.5
    dq_z = (wz * qw + wy * qx - wx * qy) * 0.5

    J = const((veh.Jx, veh.Jy, veh.Jz), dt, dev)
    w = x[..., 10:13]
    gyro = torch.linalg.cross(w, J * w)
    dw = (tau - gyro) / J
    return torch.cat([v, torch.stack([ax, ay, az, dq_w, dq_x, dq_y, dq_z], dim=-1), dw], dim=-1)


def thrust_jacobian(x: torch.Tensor, u: torch.Tensor, veh: VehicleParams) -> torch.Tensor:
    """d xdot / d (x, u) of `thrust_dynamics` in closed form (..., 13, 17);
    the external force is a constant input."""
    dt, dev = x.dtype, x.device
    qw, qx, qy, qz = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    wx, wy, wz = x[..., 10], x[..., 11], x[..., 12]
    A = allocation_rows(veh)
    Jx, Jy, Jz = veh.Jx, veh.Jy, veh.Jz
    two_c = 2.0 * (u @ const(A[0], dt, dev)) / veh.mass
    z = torch.zeros_like(qw)
    Jac = x.new_zeros(x.shape[:-1] + (NXT, NXT + NUT))
    Jac[..., 0:3, 3:6] = torch.eye(3, dtype=dt, device=dev)
    # acceleration c R(q) e3: its quaternion columns, and c = sum(f) / m
    Jac[..., 3:6, 6:10] = torch.stack([
        torch.stack([two_c * qy, two_c * qz, two_c * qw, two_c * qx], dim=-1),
        torch.stack([-two_c * qx, -two_c * qw, two_c * qz, two_c * qy], dim=-1),
        torch.stack([z, -2.0 * two_c * qx, -2.0 * two_c * qy, z], dim=-1),
    ], dim=-2)
    zb = torch.stack([2.0 * (qx * qz + qw * qy), 2.0 * (qy * qz - qw * qx),
                      1.0 - 2.0 * qx * qx - 2.0 * qy * qy], dim=-1)
    Jac[..., 3:6, 13:17] = (zb / veh.mass)[..., None] * const(A[0], dt, dev)
    # quaternion: 0.5 * Omega(w) q, with the body rates states
    Jac[..., 6:10, 6:10] = 0.5 * torch.stack([
        torch.stack([z, -wx, -wy, -wz], dim=-1), torch.stack([wx, z, wz, -wy], dim=-1),
        torch.stack([wy, -wz, z, wx], dim=-1), torch.stack([wz, wy, -wx, z], dim=-1),
    ], dim=-2)
    Jac[..., 6:10, 10:13] = 0.5 * torch.stack([
        torch.stack([-qx, -qy, -qz], dim=-1), torch.stack([qw, -qz, qy], dim=-1),
        torch.stack([qz, qw, -qx], dim=-1), torch.stack([-qy, qx, qw], dim=-1),
    ], dim=-2)
    # body rates: (tau - w x (J w)) / J
    Jac[..., 10:13, 10:13] = -torch.stack([
        torch.stack([z, (Jz - Jy) * wz, (Jz - Jy) * wy], dim=-1) / Jx,
        torch.stack([(Jx - Jz) * wz, z, (Jx - Jz) * wx], dim=-1) / Jy,
        torch.stack([(Jy - Jx) * wy, (Jy - Jx) * wx, z], dim=-1) / Jz,
    ], dim=-2)
    Jac[..., 10:13, 13:17] = const(
        tuple(tuple(a / j for a in row) for row, j in zip(A[1:], (Jx, Jy, Jz))), dt, dev)
    return Jac


def hover_thrust(veh: VehicleParams) -> float:
    """Per-rotor thrust at hover: m g / 4."""
    return veh.mass * veh.gravity / 4.0


def rotor_thrust_bounds(veh: VehicleParams):
    """(f_min, f_max) per rotor from the propeller model f = c_t rpm^2
    (`fhnp_params.py:23-27`, o_min/o_max in kRPM)."""
    f_min = veh.c_t * (veh.o_min * 1000.0) ** 2
    f_max = veh.c_t * (veh.o_max * 1000.0) ** 2
    return float(f_min), float(f_max)
