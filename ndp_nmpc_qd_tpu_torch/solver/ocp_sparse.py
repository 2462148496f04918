"""Structure-sparse OCP data: the stage payload, its linearizer, and the
one-kernel control step.

Port of `ndp_nmpc_qd_tpu/solver/ocp_sparse.py` (`SparseQp`, `SparseQpConsts`,
`make_linearizer_pallas`, `make_whole_step`). The payload's fields and
their structure are described in the JAX module's docstring.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels.linearize import linearize_stage_data
from ..ops.kernels.step_whole import control_step_whole
from ..ops.layout import pack
from ..params import OcpParams, VehicleParams
from .ocp import BIG


class SparseQp(NamedTuple):
    """Varying QP data in kernel layout (stage, element, B). hq, a and b are
    in the jac dtype (bf16 with `jac_bf16`); everything else in the compute
    dtype. The constant parts live in `SparseQpConsts`."""

    hq: torch.Tensor  # (N+1, 16) 4x4 quaternion Hessian block, row-major
    gx: torch.Tensor  # (N+1, 10)
    gu: torch.Tensor  # (N, 4)
    a: torch.Tensor  # (N, 40) [Apq(12), Avq(12), Aqq(16)] row-major blocks
    b: torch.Tensor  # (N, 30) omega columns [Bp(9), Bv(9), Bq(12)]
    bc: torch.Tensor  # (N, 6) collective columns [Bp[:,3], Bv[:,3]]
    r: torch.Tensor  # (N, 10) defects
    lu: torch.Tensor  # (N, 4) control box, relative to the iterate
    uu: torch.Tensor
    lx: torch.Tensor  # (N+1, 3) velocity box; rows 0 and N are -+BIG
    ux: torch.Tensor


class SparseQpConsts(NamedTuple):
    """Scalars the kernels take as constants (plain Python floats)."""

    h: float  # th_pred: the exact p <- v sensitivity
    diag6_stage: tuple  # stage_scale * q_diag[:6]
    diag6_term: tuple  # q_diag[:6] (terminal: cost scaling 1)
    rdiag_stage: tuple  # stage_scale * r_diag


def _floats(v):
    return tuple(float(t) for t in np.asarray(v))


def sparse_consts(ocp: OcpParams) -> SparseQpConsts:
    stage_scale = ocp.th_pred if ocp.scale_stage_cost_by_dt else 1.0
    q_diag = np.asarray(ocp.q_diag())
    return SparseQpConsts(
        h=float(ocp.th_pred),
        diag6_stage=tuple(float(v) * stage_scale for v in q_diag[:6]),
        diag6_term=_floats(q_diag[:6]),
        rdiag_stage=tuple(float(v) * stage_scale for v in np.asarray(ocp.r_diag())),
    )


def lin_consts(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False,
) -> dict:
    """Keyword constants of `linearize_stage_data`."""
    stage_scale = ocp.th_pred if ocp.scale_stage_cost_by_dt else 1.0
    return dict(
        h=float(ocp.th_pred), substeps=int(ocp.erk_substeps),
        mass=float(vehicle.mass), gravity=float(vehicle.gravity),
        stage_scale=float(stage_scale),
        q_diag=_floats(ocp.q_diag()), r_diag=_floats(ocp.r_diag()),
        u_lo=_floats(ocp.u_lower()), u_hi=_floats(ocp.u_upper()),
        v_lo=_floats(ocp.v_lower()), v_hi=_floats(ocp.v_upper()),
        with_dist=bool(with_disturbance), big=float(BIG), jac_bf16=bool(jac_bf16),
    )


def ipm_consts(
    ocp: OcpParams, *, num_iters: int = 4,
    tau: float = 0.95, sigma: float = 0.1, mu_init: float = 1.0,
    s_min: float = 1e-3, mu_min: float = 1e-12,
) -> dict:
    """Keyword constants of `riccati_ipm_whole` (IPM knob defaults as the
    JAX package's `qp_ipm_sparse.ipm_sparse`); `riccati_iter_fused` takes
    the SparseQpConsts fields and `tau` of it."""
    return dict(
        sparse_consts(ocp)._asdict(),
        tau=tau, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
        num_iters=int(num_iters),
    )


def whole_step_consts(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False, num_iters: int = 4, **ipm_knobs,
) -> dict:
    """Keyword constants of `control_step_whole`: those of the
    linearization and of the whole IPM."""
    return dict(
        lin_consts(ocp, vehicle, with_disturbance, jac_bf16=jac_bf16),
        **ipm_consts(ocp, num_iters=num_iters, **ipm_knobs),
    )


def make_linearizer(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False,
):
    """The stage linearization on the K3 kernel: the counterpart of the JAX
    package's `make_linearizer_pallas`.

    Returns (linearize_sparse, consts). linearize_sparse(x_bar, u_bar, xr,
    ur, f_dist, x0, packed_xu=False) -> (SparseQp, dx0_p (1, 10, B)) takes
    batch-first inputs x_bar (B, N+1, 10), u_bar (B, N, 4), xr, ur,
    f_dist (B, N+1, 3) or None, x0 (B, 10); with `packed_xu=True` x_bar and
    u_bar arrive already in kernel layout ((N+1, 10, B), (N, 4, B)).
    `jac_bf16` stores hq/a/b in bfloat16; bc, gx, gu and r stay full
    precision (the JAX module docstring says why)."""
    kconsts = lin_consts(ocp, vehicle, with_disturbance, jac_bf16=jac_bf16)
    N = ocp.N_node

    def linearize_sparse(x_bar, u_bar, xr, ur, f_dist, x0, packed_xu=False):
        dt = x_bar.dtype
        if not packed_xu:
            x_bar, u_bar = pack(x_bar), pack(u_bar.to(dt))
        fd = None
        if with_disturbance:
            B = x0.shape[0]
            fd = (torch.zeros((N + 1, 3, B), dtype=dt, device=x_bar.device)
                  if f_dist is None else pack(f_dist.to(dt)))
        *fields, dx0_p = linearize_stage_data(
            x_bar, u_bar, pack(xr.to(dt)), pack(ur.to(dt)), fd,
            pack(x0.to(dt)[:, None]), **kconsts,
        )
        return SparseQp(*fields), dx0_p

    return linearize_sparse, sparse_consts(ocp)


def make_whole_step(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False, num_iters: int = 4,
):
    """The one-kernel control step: linearization + whole IPM + SQP axpy.

    Returns step(xb, ub, xr_p, ur_p, fd_p, x0_p, warm: IpmWarm) -> eq_res
    (B,), with every tensor in kernel layout. The
    iterates and `warm` update in place (the JAX version returns them)."""
    consts = whole_step_consts(
        ocp, vehicle, with_disturbance, jac_bf16=jac_bf16, num_iters=num_iters,
    )

    def step(xb, ub, xr_p, ur_p, fd_p, x0_p, warm):
        return control_step_whole(
            xb, ub, xr_p, ur_p, fd_p, x0_p,
            warm.lu_lo, warm.lu_up, warm.lx_lo, warm.lx_up, warm.mu, **consts,
        )

    return step
