"""Frozen copy of `ndp_nmpc_qd_tpu_torch/estimators/hover_throttle.py` (the benchmark's plain
reference; it imports nothing of the port). Its original docstring:

Hover-throttle Kalman filter: estimates the throttle -> collective-force
gain used to convert the NMPC's collective acceleration into a normalized
throttle command.

Port of `ndp_nmpc_qd_tpu/estimators/hover_throttle.py` (the reference's
`HoverThrottleEstimator`, `hv_throttle_est/hover_throttle_estimator.py`):

  state   x = [f_collect, k_throttle]
  predict Phi = [[0, throttle], [0, 1]]   (f = k * throttle)
  measure z = a_z + g,  H = [1/mass, 0]
  gating  update only while 0.1 < throttle < 1 (a select, not a branch)

a_z is the Tustin dirty derivative of v_z (`filters.differentiator_update`).
Every tensor carries a leading batch of drones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import const
from .params import EstimatorParams
from .filters import DifferentiatorState, differentiator_init, differentiator_update


class HoverThrottleState(NamedTuple):
    x: torch.Tensor  # (..., 2) [f_collect, k_throttle]
    P: torch.Tensor  # (..., 2, 2)
    diff: DifferentiatorState


def hover_throttle_init(
    ep: EstimatorParams, batch=(), dtype=torch.float32, device=None
) -> HoverThrottleState:
    x = torch.zeros(tuple(batch) + (2,), dtype=dtype, device=device)
    x[..., 1] = ep.k_throttle_init
    P = torch.eye(2, dtype=dtype, device=device).expand(tuple(batch) + (2, 2)).clone()
    return HoverThrottleState(x, P, differentiator_init(tuple(batch), dtype, device))


def hover_throttle_update(
    state: HoverThrottleState, vz: torch.Tensor, throttle: torch.Tensor, ep: EstimatorParams
):
    """One 50 Hz estimator tick. Returns (new_state, k_throttle)."""
    diff, az = differentiator_update(state.diff, vz, ep.ts_est, ep.diff_tau)

    dt, dev = state.x.dtype, state.x.device
    z = az + ep.gravity
    zero = torch.zeros_like(throttle)
    one = torch.ones_like(throttle)
    Phi = torch.stack(
        [torch.stack([zero, throttle], dim=-1), torch.stack([zero, one], dim=-1)], dim=-2
    )  # (..., 2, 2)
    H = const((1.0 / ep.mass, 0.0), dt, dev)
    Q = const(((float(ep.Q_diag[0]), 0.0), (0.0, float(ep.Q_diag[1]))), dt, dev)

    P_pred = Phi @ state.P @ Phi.transpose(-1, -2) + Q
    S = H @ P_pred @ H + ep.R  # scalar innovation covariance
    K = (P_pred @ H) / S[..., None]  # (..., 2)
    x_pred = (Phi @ state.x[..., None])[..., 0]
    innov = z - x_pred @ H
    x_new = x_pred + K * innov[..., None]
    P_new = (const(((1.0, 0.0), (0.0, 1.0)), dt, dev) - K[..., None] * H) @ P_pred

    gate = (throttle > 0.1) & (throttle < 1.0)
    x_out = torch.where(gate[..., None], x_new, state.x)
    P_out = torch.where(gate[..., None, None], P_new, state.P)
    return HoverThrottleState(x_out, P_out, diff), x_out[..., 1]


def throttle_from_collective(c: torch.Tensor, k_throttle: torch.Tensor, mass: float):
    """Collective acceleration -> normalized throttle (`nmpc_node.py:273-283`):
    thrust = c * mass / k_throttle."""
    zero = k_throttle == 0
    safe_k = torch.where(zero, torch.ones_like(k_throttle), k_throttle)
    return torch.where(zero, torch.zeros_like(c), c * mass / safe_k)
