"""The dense OCP linearization in kernel layout, for the legacy packed path.

Port of `ndp_nmpc_qd_tpu/solver/ocp_packed.py` (`PackedQp`,
`make_ocp_functions_packed`). The JAX module re-derives the linearization
batch-last so that XLA lays the batch on the TPU's vector lanes; its terms
are those of `ocp.linearize_horizon` (the same residuals, RK4
sensitivities and acados cost scaling, the Gauss-Newton terms in the closed
form of this cost, with the 3x4 quaternion-error Jacobian `_gq`). Here the
packed payload is `ocp.linearize_horizon`'s, moved into the (stage,
element, B) layout K8/K9 read (`pack_qp`; no padding of B), so the two
linearizations are one code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.layout import pack
from ..params import OcpParams, VehicleParams
from .ocp import QpData, make_ocp_functions


class PackedQp(NamedTuple):
    """Dense QP data in kernel layout (stage, element, B)."""

    hxx: torch.Tensor  # (N+1, 100, B) row-major 10x10 blocks
    huu: torch.Tensor  # (N, 16, B)
    gx: torch.Tensor  # (N+1, 10, B)
    gu: torch.Tensor  # (N, 4, B)
    a: torch.Tensor  # (N, 100, B)
    b: torch.Tensor  # (N, 40, B) row-major 10x4 blocks
    r: torch.Tensor  # (N, 10, B)
    lu: torch.Tensor  # (N, 4, B)
    uu: torch.Tensor  # (N, 4, B)
    lx: torch.Tensor  # (N+1, 3, B)
    ux: torch.Tensor  # (N+1, 3, B)


def pack_qp(qp: QpData) -> PackedQp:
    """Batch-first QpData -> kernel layout (Hxu is dropped: it is zero)."""
    return PackedQp(
        hxx=pack(qp.Hxx), huu=pack(qp.Huu), gx=pack(qp.gx), gu=pack(qp.gu),
        a=pack(qp.A), b=pack(qp.B), r=pack(qp.r),
        lu=pack(qp.lu), uu=pack(qp.uu), lx=pack(qp.lx), ux=pack(qp.ux),
    )


def make_ocp_functions_packed(ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool):
    """Returns (linearize_packed, phi): linearize_packed(x_bar, u_bar, xr,
    ur, f_dist, x0) -> (PackedQp, dx0 (1, 10, B)), inputs batch-first
    (B, ...), f_dist (B, N+1, 3) or None, x0 (B, 10)."""
    linearize_horizon, phi = make_ocp_functions(ocp, vehicle, with_disturbance)

    def linearize_packed(x_bar, u_bar, xr, ur, f_dist, x0):
        qp = linearize_horizon(x_bar, u_bar, xr, ur, f_dist)
        return pack_qp(qp), pack((x0.to(x_bar.dtype) - x_bar[:, 0])[:, None])

    return linearize_packed, phi
