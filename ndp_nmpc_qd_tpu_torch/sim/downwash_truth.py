"""Ground-truth downwash coupling for the plant.

Port of `ndp_nmpc_qd_tpu/sim/downwash_truth.py`: an analytic axisymmetric
jet model, distinct from the learned MLP so that the forecast has something
to predict,

  f(rel) = -A exp(-r^2 / (2 sigma(z)^2)) clip(-z/z0, 0, 1) e_z-ish,

with the wake widening below the emitting drone and force magnitudes of the
trained networks' scale (1-4 N inside the r_horiz = 1 m cylinder).
"""

from __future__ import annotations

import torch


def analytic_downwash(rel: torch.Tensor) -> torch.Tensor:
    """Force [N] on the ego drone from one other drone; rel (..., 6) =
    other state - ego state (positions and velocities), the MLP's input
    convention. rel_z > 0: the other drone is above and pushes the ego
    down."""
    dx, dy, dz = rel[..., 0], rel[..., 1], rel[..., 2]
    r2 = dx * dx + dy * dy
    sigma = 0.25 + 0.1 * torch.clamp(dz, 0.0, 3.0)
    radial = torch.exp(-r2 / (2.0 * sigma * sigma))
    zprof = torch.clamp(dz / 0.8, 0.0, 1.0) * torch.exp(-torch.clamp(dz - 0.8, min=0.0) / 1.2)
    fz = -4.0 * radial * zprof
    fx = -0.4 * radial * zprof * dx / (sigma + 1e-6) * 0.25
    fy = -0.4 * radial * zprof * dy / (sigma + 1e-6) * 0.25
    return torch.stack([fx, fy, fz], dim=-1)


def pairwise_downwash(xs: torch.Tensor, model=analytic_downwash) -> torch.Tensor:
    """Total external force on every drone from every other drone:
    xs (..., D, 10) -> (..., D, 3)."""
    D = xs.shape[-2]
    return downwash_on_locals(xs, xs, torch.arange(D, device=xs.device), model=model)


def downwash_on_locals(x_local, x_all, local_gidx, model=analytic_downwash) -> torch.Tensor:
    """Total external force on the drones x_local (..., Dl, 10) from all
    drones x_all (..., D, 10); local_gidx (Dl,) are the local drones'
    indices into x_all (which masks each drone's force on itself)."""
    ego = x_local[..., :, None, 0:6]
    other = x_all[..., None, :, 0:6]
    f = model(other - ego)  # (..., Dl, D, 3) [i = ego, j = other]
    D = x_all.shape[-2]
    self_mask = local_gidx[:, None] == torch.arange(D, device=x_all.device)[None, :]
    f = torch.where(self_mask[..., None], torch.zeros((), dtype=f.dtype, device=f.device), f)
    return torch.sum(f, dim=-2)
