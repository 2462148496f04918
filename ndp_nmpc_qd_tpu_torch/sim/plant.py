"""The quadrotor plant: the dop_sim role, in torch on the episode's device.

Port of `ndp_nmpc_qd_tpu/sim/plant.py`. The plant takes AttitudeTarget-shaped
commands (body rates + normalized throttle, `nmpc_node.py:273-283`),
converts the throttle back to collective force through its own gain
`k_throttle_true` (which the hover-throttle estimator has to discover),
optionally applies first-order actuator lags, adds external forces
(downwash coupling), integrates with RK4 substeps and renormalizes the
quaternion.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.quadrotor import body_rate_dynamics
from ..ops import quat
from ..ops.integrators import rk4_step
from ..params import SimParams, VehicleParams


class PlantState(NamedTuple):
    x: torch.Tensor  # (..., 10)
    w_act: torch.Tensor  # (..., 3) actual body rates (with a rate lag)
    c_act: torch.Tensor  # (...,) actual collective acceleration (with a thrust lag)


def plant_init(x0: torch.Tensor, vehicle: VehicleParams) -> PlantState:
    batch = tuple(x0.shape[:-1])
    return PlantState(
        x=x0,
        w_act=torch.zeros(batch + (3,), dtype=x0.dtype, device=x0.device),
        c_act=torch.full(batch, vehicle.gravity, dtype=x0.dtype, device=x0.device),
    )


def plant_step(
    state: PlantState, body_rate_cmd: torch.Tensor, throttle: torch.Tensor,
    f_ext: torch.Tensor, dt: float, vehicle: VehicleParams, sim: SimParams,
) -> PlantState:
    """Advance the plant by one control period dt (internally substepped);
    f_ext (..., 3) is a world-frame force [N]."""
    c_cmd = throttle * sim.k_throttle_true / vehicle.mass  # inverts nmpc_u_2_att_tgt
    if sim.rate_tau > 0:
        a = math.exp(-dt / sim.rate_tau)
        w = a * state.w_act + (1 - a) * body_rate_cmd
    else:
        w = body_rate_cmd
    if sim.thrust_tau > 0:
        a = math.exp(-dt / sim.thrust_tau)
        c = a * state.c_act + (1 - a) * c_cmd
    else:
        c = c_cmd
    u = torch.cat([w, c[..., None]], dim=-1)

    def f(x, u):
        return body_rate_dynamics(x, u, f_ext, mass=vehicle.mass, gravity=vehicle.gravity)

    substeps = max(1, int(round(dt / sim.ts_sim)))
    x = rk4_step(f, state.x, u, dt, substeps)
    x = torch.cat([x[..., 0:6], quat.normalize(x[..., 6:10])], dim=-1)
    return PlantState(x=x, w_act=w, c_act=c)
