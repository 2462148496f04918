"""The one-kernel control step and its constant table.

Port of `ndp_nmpc_qd_tpu/solver/ocp.py:59` (`BIG`) and
`ndp_nmpc_qd_tpu/solver/ocp_sparse.py:202-246` (`make_whole_step`).
"""

from __future__ import annotations

import numpy as np

from ..ops.kernels.step_whole import control_step_whole
from ..params import OcpParams, VehicleParams

BIG = 1e9  # stands in for +-inf on masked bounds (state box at nodes 0 and N)


def whole_step_consts(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False, num_iters: int = 4,
    tau: float = 0.95, sigma: float = 0.1, mu_init: float = 1.0,
    s_min: float = 1e-3, mu_min: float = 1e-12,
) -> dict:
    """Keyword constants of `control_step_whole` (IPM knob defaults as the
    JAX package's `qp_ipm_sparse.ipm_sparse`)."""
    dt_h = ocp.th_pred
    stage_scale = dt_h if ocp.scale_stage_cost_by_dt else 1.0
    q_diag = np.asarray(ocp.q_diag())
    r_diag = np.asarray(ocp.r_diag())
    floats = lambda v: tuple(float(t) for t in np.asarray(v))
    return dict(
        h=float(dt_h), substeps=int(ocp.erk_substeps),
        mass=float(vehicle.mass), gravity=float(vehicle.gravity),
        stage_scale=float(stage_scale),
        q_diag=floats(q_diag), r_diag=floats(r_diag),
        u_lo=floats(ocp.u_lower()), u_hi=floats(ocp.u_upper()),
        v_lo=floats(ocp.v_lower()), v_hi=floats(ocp.v_upper()),
        with_dist=bool(with_disturbance), big=float(BIG),
        diag6_stage=tuple(float(v) * stage_scale for v in q_diag[:6]),
        diag6_term=floats(q_diag[:6]),
        rdiag_stage=tuple(float(v) * stage_scale for v in r_diag),
        tau=tau, sigma=sigma, mu_init=mu_init, s_min=s_min, mu_min=mu_min,
        num_iters=int(num_iters), jac_bf16=bool(jac_bf16),
    )


def make_whole_step(
    ocp: OcpParams, vehicle: VehicleParams, with_disturbance: bool,
    *, jac_bf16: bool = False, num_iters: int = 4, **ipm_knobs,
):
    """The one-kernel control step: linearization + whole IPM + SQP axpy.

    Returns step(xb, ub, xr_p, ur_p, fd_p, x0_p, warm: IpmWarm,
    workspace=None) -> eq_res (B,), with every tensor in kernel layout. The
    iterates and `warm` update in place (the JAX version returns them)."""
    consts = whole_step_consts(
        ocp, vehicle, with_disturbance, jac_bf16=jac_bf16,
        num_iters=num_iters, **ipm_knobs,
    )

    def step(xb, ub, xr_p, ur_p, fd_p, x0_p, warm, workspace=None):
        return control_step_whole(
            xb, ub, xr_p, ur_p, fd_p, x0_p,
            warm.lu_lo, warm.lu_up, warm.lx_lo, warm.lx_up, warm.mu,
            workspace=workspace, **consts,
        )

    return step
