"""Frozen copy of `ndp_nmpc_qd_tpu_torch/estimators/filters.py` (the benchmark's plain
reference; it imports nothing of the port). Its original docstring:

Small stateful filters as (state, u) -> (state, y) functions.

Port of `ndp_nmpc_qd_tpu/estimators/filters.py`:

- AlphaFilter: y[k] = a y[k-1] + (1 - a) u[k] (`hv_throttle_est/alpha_filter.py`)
- Differentiator: Tustin dirty derivative, tau = 0.05
  (`hv_throttle_est/differentiator.py`)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AlphaFilterState(NamedTuple):
    y: torch.Tensor


def alpha_filter_init(y0) -> AlphaFilterState:
    return AlphaFilterState(torch.as_tensor(y0))


def alpha_filter_update(state: AlphaFilterState, u, alpha: float):
    y = alpha * state.y + (1.0 - alpha) * u
    return AlphaFilterState(y), y


class DifferentiatorState(NamedTuple):
    x_prev: torch.Tensor
    xdot_prev: torch.Tensor


def differentiator_init(shape=(), dtype=torch.float32, device=None) -> DifferentiatorState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return DifferentiatorState(z, z)


def differentiator_update(state: DifferentiatorState, x, ts: float, tau: float = 0.05):
    """Tustin-discretized dirty derivative (`differentiator.py:14-23`)."""
    a1 = (2.0 * tau - ts) / (2.0 * tau + ts)
    a2 = 2.0 / (2.0 * tau + ts)
    xdot = a1 * state.xdot_prev + a2 * (x - state.x_prev)
    return DifferentiatorState(x, xdot), xdot
