"""Explicit Runge-Kutta integration matching acados' ERK discretization.

Port of `ndp_nmpc_qd_tpu/ops/integrators.py`: 4 Butcher stages, `substeps`
steps per shooting interval, control held constant (zero-order hold).
"""

from __future__ import annotations

from typing import Callable

import torch


def rk4_step(
    f: Callable, x: torch.Tensor, u: torch.Tensor, dt: float, substeps: int = 1
) -> torch.Tensor:
    """Classic RK4 over one interval of length dt, optionally in substeps."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def make_discrete_dynamics(f: Callable, dt: float, substeps: int = 1):
    """Bind (f, dt) -> Phi(x, u, *args)."""

    def phi(x, u, *args):
        return rk4_step(lambda xx, uu: f(xx, uu, *args), x, u, dt, substeps)

    return phi
