"""Dual warm-start state of the interior-point QP.

Port of `ndp_nmpc_qd_tpu/solver/qp_ipm_sparse.py:28-43`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IpmWarm(NamedTuple):
    """QP multipliers and barrier weight carried across control ticks
    (kernel layout, batch innermost).

    Slacks are not carried: they are re-derived from the current tick's
    bounds at the zero primal iterate, which is always feasible. `mu < 0` is
    the cold sentinel (fresh reset): that scenario falls back to the classic
    lambda = mu0 / s initialization.
    """

    lu_lo: torch.Tensor  # (N, nu, B)
    lu_up: torch.Tensor
    lx_lo: torch.Tensor  # (N+1, 3, B)
    lx_up: torch.Tensor
    mu: torch.Tensor  # (B,); < 0 => cold


def cold_warm(n_stages: int, B: int, dtype, device) -> IpmWarm:
    """Fresh duals with every scenario marked cold."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return IpmWarm(
        z(n_stages, 4, B), z(n_stages, 4, B),
        z(n_stages + 1, 3, B), z(n_stages + 1, 3, B),
        torch.full((B,), -1.0, dtype=dtype, device=device),
    )
